"""MBRL helpers, the port's own copy of what it needs from
``ivideogpt_tpu/mbrl/utils.py`` (the schedule DSL and the truncated-normal
action sample) and of ``symlog`` / ``symexp`` from
``ivideogpt_tpu/mbrl/video_predictor.py``. Random draws come from an
explicit ``torch.Generator``."""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch


def schedule(schdl: str, step) -> float:
    """String schedule DSL: float | linear(a,b,dur) |
    step_linear(a,b1,dur1,b2,dur2)."""
    try:
        return float(schdl)
    except ValueError:
        pass
    m = re.match(r"linear\((.+),(.+),(.+)\)", schdl)
    if m:
        init, final, duration = (float(g) for g in m.groups())
        mix = float(np.clip(step / duration, 0.0, 1.0))
        return (1.0 - mix) * init + mix * final
    m = re.match(r"step_linear\((.+),(.+),(.+),(.+),(.+)\)", schdl)
    if m:
        init, final1, dur1, final2, dur2 = (float(g) for g in m.groups())
        if step <= dur1:
            mix = float(np.clip(step / dur1, 0.0, 1.0))
            return (1.0 - mix) * init + mix * final1
        mix = float(np.clip((step - dur1) / dur2, 0.0, 1.0))
        return (1.0 - mix) * final1 + mix * final2
    raise NotImplementedError(schdl)


def truncated_normal_sample(loc: torch.Tensor, scale: float,
                            generator: Optional[torch.Generator],
                            clip: Optional[float] = None, low: float = -1.0,
                            high: float = 1.0, eps: float = 1e-6
                            ) -> torch.Tensor:
    """loc + N(0, 1) * scale, the noise clamped to [-clip, clip] when clip
    is given, the sum clamped to [low + eps, high - eps]."""
    noise = torch.randn(loc.shape, generator=generator, device=loc.device,
                        dtype=loc.dtype) * scale
    if clip is not None:
        noise = noise.clamp(-clip, clip)
    return (loc + noise).clamp(low + eps, high - eps)


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log(x.abs() + 1.0)


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(x.abs()) - 1.0)
