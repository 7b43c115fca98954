"""LoRA adapters of the token transformer: the fold only.

The port of ``merge`` in ``ivideogpt_tpu/train/lora.py``: the JAX package
keeps an adapter as a separate tree, ``{"<Flax path of a kernel>": {"a":
[in, r], "b": [r, out]}}``, and folds base + (alpha/r) a @ b. Saved as
``lora.safetensors`` its names are the "/"-joined paths
(``params/llm/layers_0/self_attn/q_proj/kernel/a``). A Linear of the port
stores the transposed kernel, so there the fold is
W[out, in] += ((alpha/r) a @ b)^T; an embedding table is stored as in
Flax and takes the product as it is. Training LoRA is not ported.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ivideogpt_tpu_torch.utils.checkpoint import action_model_flax_path


def _pairs(flat: Dict[str, torch.Tensor]
           ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``lora.safetensors`` tensors by name -> {Flax path under ``params``:
    {"a", "b"}}; raises on a name that is not ``<path>/a`` or ``<path>/b``
    or a path that lacks one of the two."""
    pairs: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in flat.items():
        path, _, leaf = name.rpartition("/")
        if leaf not in ("a", "b") or not path:
            raise ValueError(f"not a LoRA factor: {name}")
        if path.startswith("params/"):
            path = path[len("params/"):]
        pairs.setdefault(path, {})[leaf] = t
    broken = sorted(p for p, ab in pairs.items() if set(ab) != {"a", "b"})
    if broken:
        raise ValueError(f"LoRA factors without their pair: {broken[:5]}")
    return pairs


@torch.no_grad()
def merge(model: nn.Module, flat: Dict[str, torch.Tensor],
          alpha: float = 16.0, rank: int = 8) -> nn.Module:
    """Fold the adapters of ``flat`` (a ``lora.safetensors`` file's tensors)
    into a HeadModelWithAction's parameters in place, at scale alpha/rank.
    Every adapter must name a parameter of the model, with factors of its
    shape and of rank ``rank``."""
    pairs = _pairs(flat)
    scale = alpha / rank
    params = dict(model.named_parameters())
    by_path = {action_model_flax_path(n): n for n in params}
    unknown = sorted(set(pairs) - set(by_path))
    if unknown:
        raise ValueError(f"LoRA adapters for no parameter: {unknown[:5]}")
    for path, ab in pairs.items():
        w = params[by_path[path]]
        a, b = ab["a"].float(), ab["b"].float()
        if a.shape[1] != rank or b.shape[0] != rank:
            raise ValueError(f"{path}: factors {tuple(a.shape)} and "
                             f"{tuple(b.shape)} are not of rank {rank}")
        delta = (a.to(w.device) @ b.to(w.device)) * scale
        if path.endswith("/kernel"):
            delta = delta.t()
        if delta.shape != w.shape:
            raise ValueError(f"{path}: the fold is {tuple(delta.shape)}, "
                             f"the parameter {tuple(w.shape)}")
        w.add_(delta.to(w.dtype))
    return model
