"""LoRA adapters of the token transformer, the port of
``ivideogpt_tpu/train/lora.py``: their init, the merged weights a LoRA step
trains through, their file and the fold.

An adapter pair belongs to every 2-D weight under a target module
(``DEFAULT_TARGETS``: the attention and MLP projections, ``embed_tokens``
and ``lm_head``) and is keyed by the weight's JAX flat name
(``params/llm/layers_0/self_attn/q_proj/kernel``): ``a`` [in, r] and ``b``
[r, out] over the Flax kernel's [in, out] (an embedding table's [vocab,
hidden]). The merged weight is W + (alpha/r) a @ b, transposed for a
Linear, which stores [out, in], and taken as it is for an embedding table.

    adapters = init_lora(model, torch.Generator().manual_seed(seed), rank=8,
                         alpha=16.0)        # a ~ N(0, 0.02), b = 0
    attach(model, adapters)   # the model now computes on the merged weights
    ...                       # train the adapters; the base stays frozen
    with torch.nn.utils.parametrize.cached():
        ...                   # evaluate or generate, each weight merged once
    save_lora(adapters, "transformer/lora.safetensors")
    base = base_state_dict(model)          # the base under its own names

``attach`` registers a ``torch.nn.utils.parametrize`` parametrization on
each adapted weight, so every read of the weight (the forward, a remat
recompute, generation) computes the merge in fp32 from the fp32 base, as
the JAX package's ``merge`` inside its step, before the model's compute
cast. The adapters stay outside the model's parameters. Torch cannot
replay threefry: ``lora_from_jax`` carries a JAX adapter tree over.
``lora.safetensors`` holds ``<flat name>/a`` and ``<flat name>/b``, the
names ``merge`` folds into a model and ``vp/interface`` reads.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from ivideogpt_tpu_torch.utils import safetensors
from ivideogpt_tpu_torch.utils.checkpoint import action_model_flax_path

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                   "gate_proj", "up_proj", "down_proj",
                   "embed_tokens", "lm_head")


def adapted_weights(model: nn.Module,
                    targets: Sequence[str] = DEFAULT_TARGETS
                    ) -> Dict[str, str]:
    """{JAX flat name: the model's parameter name} of every 2-D weight
    under a target module, as ``init_lora`` of the JAX package picks
    them."""
    out = {}
    for name, p in model.named_parameters():
        path = action_model_flax_path(name)
        if p.ndim == 2 and any(t in path.split("/") for t in targets):
            out[f"params/{path}"] = name
    return out


class LoraAdapters(nn.Module):
    """The adapter pairs of one model by JAX flat name, and their scale
    alpha / r. Its parameters (``a.<name>``, ``b.<name>``) are what a LoRA
    run trains and checkpoints."""

    def __init__(self, factors: Mapping[str, Tuple[torch.Tensor,
                                                   torch.Tensor]],
                 alpha: float = 16.0):
        super().__init__()
        ranks = {a.shape[1] for a, _ in factors.values()}
        if len(ranks) != 1:
            raise ValueError(f"adapters of ranks {sorted(ranks)}")
        self.rank = ranks.pop()
        self.alpha = float(alpha)
        self.a = nn.ParameterDict()
        self.b = nn.ParameterDict()
        for name in sorted(factors):
            a, b = factors[name]
            if a.ndim != 2 or b.shape != (self.rank, b.shape[-1]):
                raise ValueError(f"{name}: factors {tuple(a.shape)} and "
                                 f"{tuple(b.shape)}")
            self.a[name] = nn.Parameter(a.float())
            self.b[name] = nn.Parameter(b.float())

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    def names(self):
        return list(self.a.keys())

    def delta(self, name: str) -> torch.Tensor:
        """(alpha/r) a @ b in the Flax layout, [in, out]."""
        return (self.a[name] @ self.b[name]) * self.scale

    def flat(self) -> Dict[str, torch.Tensor]:
        """The tensors of ``lora.safetensors``: ``<name>/a``, ``<name>/b``."""
        out = {}
        for name in self.names():
            out[f"{name}/a"] = self.a[name].detach()
            out[f"{name}/b"] = self.b[name].detach()
        return out


def init_lora(model: nn.Module, generator: torch.Generator, rank: int = 8,
              targets: Sequence[str] = DEFAULT_TARGETS,
              alpha: float = 16.0) -> LoraAdapters:
    """Adapters for ``model``'s weights under ``targets``: ``a`` ~ N(0,
    0.02) drawn from ``generator`` in the order of the sorted names, ``b`` =
    0, on the device of the weight each adapts."""
    params = dict(model.named_parameters())
    factors = {}
    for path, name in sorted(adapted_weights(model, targets).items()):
        w = params[name]
        n_in, n_out = w.shape if path.endswith("/embedding") else w.shape[::-1]
        a = torch.randn((n_in, rank), generator=generator,
                        device=generator.device) * 0.02
        factors[path] = (a.to(w.device),
                         torch.zeros((rank, n_out), device=w.device))
    return LoraAdapters(factors, alpha)


def lora_from_jax(tree: Mapping[str, Mapping[str, object]],
                  alpha: float = 16.0) -> LoraAdapters:
    """A JAX adapter tree (``init_lora``'s {name: {"a", "b"}}, numpy or JAX
    arrays) as the port's adapters."""
    return LoraAdapters({name: (torch.from_numpy(np.array(ab["a"],
                                                          np.float32)),
                                torch.from_numpy(np.array(ab["b"],
                                                          np.float32)))
                         for name, ab in tree.items()}, alpha)


def save_lora(adapters: LoraAdapters, path: str):
    """Write ``lora.safetensors`` at ``path``: the inverse of
    :func:`lora_from_jax`, under the names :func:`merge` and
    ``vp/interface`` read."""
    safetensors.save_file(adapters.flat(), path)


class _Merged(nn.Module):
    """The parametrization W -> W + delta (delta transposed for a Linear).
    It holds its adapters in a tuple, so that they are not parameters of
    the model."""

    def __init__(self, adapters: LoraAdapters, name: str, transpose: bool):
        super().__init__()
        self.source = (adapters, name)
        self.transpose = transpose

    def forward(self, w):
        adapters, name = self.source
        d = adapters.delta(name)
        return w + (d.t() if self.transpose else d).to(w.dtype)


def attach(model: nn.Module, adapters: LoraAdapters) -> nn.Module:
    """Freeze ``model`` and make each weight that ``adapters`` adapts read
    as the merged weight. Every adapter must name a weight of the model,
    with factors of its shape."""
    if any(parametrize.is_parametrized(m) for m in model.modules()):
        raise ValueError("the model carries adapters already")
    by_path = {f"params/{action_model_flax_path(n)}": n
               for n, _ in model.named_parameters()}
    unknown = sorted(set(adapters.names()) - set(by_path))
    if unknown:
        raise ValueError(f"LoRA adapters for no parameter: {unknown[:5]}")
    model.requires_grad_(False)
    params = dict(model.named_parameters())
    for path in adapters.names():
        name = by_path[path]
        w = params[name]
        transpose = not path.endswith("/embedding")
        a, b = adapters.a[path], adapters.b[path]
        want = (b.shape[1], a.shape[0]) if transpose else (a.shape[0],
                                                           b.shape[1])
        if tuple(w.shape) != want:
            raise ValueError(f"{path}: the fold is {want}, the parameter "
                             f"{tuple(w.shape)}")
        module_name, _, attr = name.rpartition(".")
        parametrize.register_parametrization(
            model.get_submodule(module_name), attr,
            _Merged(adapters, path, transpose), unsafe=True)
    return model


def detach(model: nn.Module) -> nn.Module:
    """Undo :func:`attach`: every weight is its base Parameter again."""
    for module in list(model.modules()):
        if parametrize.is_parametrized(module):
            for attr in list(module.parametrizations):
                parametrize.remove_parametrizations(module, attr,
                                                    leave_parametrized=False)
    return model


def base_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with each attached weight under its own name,
    holding the base (unmerged) values."""
    suffix = ".parametrizations.weight.original"
    return {(k[:-len(suffix)] + ".weight" if k.endswith(suffix) else k): v
            for k, v in model.state_dict().items()}


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
    into a HeadModelWithAction's parameters in place, at scale alpha/rank:
    W[out, in] += ((alpha/r) a @ b)^T for a Linear, the product as it is
    for an embedding table. Every adapter must name a parameter of the
    model, with factors of its shape and of rank ``rank``."""
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
