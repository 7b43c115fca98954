"""MBRL helpers, the port's own copy of ``ivideogpt_tpu/mbrl/utils.py``
(the cadence predicates ``Until`` / ``Every``, ``Timer``, the schedule DSL,
the truncated-normal action sample and the Polyak ``soft_update``) and of
``symlog`` / ``symexp`` from ``ivideogpt_tpu/mbrl/video_predictor.py``.
Random draws come from an explicit ``torch.Generator``."""

from __future__ import annotations

import re
import time
from typing import Optional

import numpy as np
import torch
from torch import nn


class Until:
    """True while step < until // action_repeat (always with until None)."""

    def __init__(self, until, action_repeat: int = 1):
        self._until = until
        self._action_repeat = action_repeat

    def __call__(self, step) -> bool:
        if self._until is None:
            return True
        return step < self._until // self._action_repeat


class Every:
    """True every ``every // action_repeat`` steps (never with every None)."""

    def __init__(self, every, action_repeat: int = 1):
        self._every = every
        self._action_repeat = action_repeat

    def __call__(self, step) -> bool:
        if self._every is None:
            return False
        return step % (self._every // self._action_repeat) == 0


class Timer:
    """Wall seconds since the last ``reset`` and since construction."""

    def __init__(self):
        self._start = time.time()
        self._last = time.time()

    def reset(self):
        elapsed = time.time() - self._last
        self._last = time.time()
        return elapsed, time.time() - self._start

    def total_time(self):
        return time.time() - self._start


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
    normal = torch.randn(loc.shape, generator=generator, device=loc.device,
                         dtype=loc.dtype)
    return truncated_normal(loc, normal, scale, clip, low, high, eps)


def truncated_normal(loc: torch.Tensor, normal: torch.Tensor, scale: float,
                     clip: Optional[float] = None, low: float = -1.0,
                     high: float = 1.0, eps: float = 1e-6) -> torch.Tensor:
    """:func:`truncated_normal_sample` from given N(0, 1) draws."""
    noise = normal * scale
    if clip is not None:
        noise = noise.clamp(-clip, clip)
    return (loc + noise).clamp(low + eps, high - eps)


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log(x.abs() + 1.0)


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(x.abs()) - 1.0)


@torch.no_grad()
def soft_update(target: nn.Module, online: nn.Module, tau: float):
    """Polyak averaging in place: every parameter of ``target`` becomes
    (1 - tau) * target + tau * online."""
    for t, o in zip(target.parameters(), online.parameters()):
        t.copy_((1.0 - tau) * t + tau * o)
