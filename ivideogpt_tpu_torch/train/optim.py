"""Optimiser, LR schedules, train state and EMA, the port of
``ivideogpt_tpu/train/optim.py`` with optax's semantics:

- schedules: ``constant`` (with a linear warmup), ``cosine`` and ``linear``,
  computed in float32 with optax's formulas and read at the update count
  *before* it is incremented, so the first warmup step has lr 0; and
  ``fixed``, a plain float learning rate;
- AdamW with decoupled weight decay and no decay for parameters with
  ndim < 2 or whose name holds ``embed``, ``codebook`` or ``pos_emb``
  (``torch.optim.AdamW`` over two parameter groups is ``optax.adamw``);
- global-norm clipping as ``optax.clip_by_global_norm``: the gradients
  become g / norm * max_norm unless norm < max_norm (no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``);
- gradient accumulation as ``optax.MultiSteps``: the running mean of k
  micro-batch gradients, applied on every k-th call; the schedule counts
  applied updates only.

``TrainState.state_dict`` / ``load_state_dict`` carry everything a resumed
run needs to continue bit for bit: the model's parameters and buffers,
AdamW's moments and step counts, ``step``, ``updates``, the accumulation
buffer inside a window (optax's ``MultiSteps`` state) and the schedule's
settings; ``utils/checkpoint.save_train_state`` writes them to disk.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from ivideogpt_tpu_torch.utils import profiling

Schedule = Callable[[int], float]
_f32 = np.float32


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule in float32."""
    if steps <= 0:
        return lambda count: _f32(init)

    def schedule(count):
        frac = _f32(1) - _f32(min(max(count, 0), steps)) / _f32(steps)
        return _f32(init - end) * frac + _f32(end)
    return schedule


def _cosine(init: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule (alpha 0, exponent 1) in float32; the
    cosine itself is correctly rounded, where XLA's float32 cosine may be
    one ulp off."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay steps, got "
                         f"{decay_steps}")

    def schedule(count):
        x = _f32(np.pi) * _f32(min(count, decay_steps)) / _f32(decay_steps)
        return _f32(init) * (_f32(0.5) * (_f32(1) + _f32(math.cos(x))))
    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def make_lr_schedule(kind: str, base_lr: float, warmup_steps: int,
                     total_steps: int) -> Schedule:
    """update count -> learning rate (a float32 value). ``"fixed"`` is a
    plain float learning rate, as ``optax.adamw(lr)`` takes it: no warmup,
    so the first update moves too."""
    if kind == "fixed":
        return lambda count: _f32(base_lr)
    w = max(warmup_steps, 1)
    warmup = _linear(0.0, base_lr, w)
    if kind in ("constant", "constant_with_warmup"):
        return _join(warmup, lambda count: _f32(base_lr), w)
    if kind == "cosine":
        return _join(warmup, _cosine(base_lr,
                                     max(total_steps, warmup_steps + 1) - w),
                     w)
    if kind == "linear":
        return _join(warmup, _linear(base_lr, 0.0, total_steps - warmup_steps),
                     w)
    raise ValueError(kind)


def decays(name: str, p: torch.Tensor) -> bool:
    """The no-weight-decay rule of the JAX package's ``_no_wd_mask`` on the
    port's parameter names."""
    return p.ndim >= 2 and not any(s in name
                                   for s in ("embed", "codebook", "pos_emb"))


@torch.no_grad()
def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm_fn: Callable[[List[torch.Tensor]],
                                           torch.Tensor] = global_norm
                         ) -> torch.Tensor:
    """optax.clip_by_global_norm in place, the norm taken by ``norm_fn``;
    returns the norm before."""
    norm = norm_fn(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


class TrainState:
    """Model, AdamW, schedule and step counters of one training run.

    ``step`` counts :meth:`apply_gradients` calls (micro-batches);
    ``updates`` counts optimiser updates, which the schedule reads.
    Parameters named in ``frozen`` keep their gradients in the clip's global
    norm but are never updated. ``grad_norm`` takes the clip's norm (a
    tensor-parallel run's sums the shards' squares over its model group:
    ``parallel/mesh.place_state``)."""

    def __init__(self, model: nn.Module, *, learning_rate: float,
                 lr_scheduler: str = "cosine", warmup_steps: int = 0,
                 total_steps: int = 1_000_000, weight_decay: float = 0.0,
                 embed_no_wd: bool = True, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, max_grad_norm: Optional[float] = 1.0,
                 gradient_accumulation_steps: int = 1,
                 frozen: Iterable[str] = ()):
        self.model = model
        self.schedule_config = {"kind": lr_scheduler,
                                "learning_rate": learning_rate,
                                "warmup_steps": warmup_steps,
                                "total_steps": total_steps}
        self.schedule = make_lr_schedule(lr_scheduler, learning_rate,
                                         warmup_steps, total_steps)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.params = [p for _, p in named]
        frozen = set(frozen)
        self._trained = [n not in frozen for n, _ in named]
        named = [(n, p) for n, p in named if n not in frozen]
        decay = [p for n, p in named if not embed_no_wd or decays(n, p)]
        keep = [p for n, p in named if embed_no_wd and not decays(n, p)]
        groups = [{"params": decay, "weight_decay": weight_decay}]
        if keep:
            groups.append({"params": keep, "weight_decay": 0.0})
        self.optimizer = torch.optim.AdamW(groups, lr=0.0, betas=(b1, b2),
                                           eps=eps)
        self.max_grad_norm = max_grad_norm
        self.accumulation_steps = gradient_accumulation_steps
        self._acc: Optional[List[torch.Tensor]] = None
        self.step = 0
        self.updates = 0
        self.grad_norm: Callable[[List[torch.Tensor]],
                                 torch.Tensor] = global_norm

    @torch.no_grad()
    def apply_gradients(self):
        """Take the gradients in ``.grad`` (None counts as zero), clear
        them, and apply an update on every k-th call: the clip is the span
        (``utils.profiling``) ``train.clip``, the schedule and AdamW
        ``train.adamw``."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        for p in self.params:
            p.grad = None
        k = self.accumulation_steps
        if k > 1:
            n = self.step % k
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            for acc, g in zip(self._acc, grads):
                acc.add_((g - acc) / (n + 1))  # optax.MultiSteps' mean
            self.step += 1
            if n != k - 1:
                return
            grads, self._acc = self._acc, None
        else:
            self.step += 1
        if self.max_grad_norm is not None:
            with profiling.span("train.clip"):
                clip_by_global_norm_(grads, self.max_grad_norm,
                                     self.grad_norm)
        with profiling.span("train.adamw"):
            for p, g, trained in zip(self.params, grads, self._trained):
                if trained:
                    p.grad = g
            lr = float(self.schedule(self.updates))
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
        self.updates += 1

    def state_dict(self) -> Dict:
        """{"model": the model's state dict, "optimizer": AdamW's (moments
        and step counts), "step", "updates", "acc": the accumulation
        buffer or None, "schedule": its settings}. Tensors are the live
        ones, not copies."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "updates": self.updates,
                "acc": None if self._acc is None else list(self._acc),
                "schedule": dict(self.schedule_config)}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict):
        """Restore what :meth:`state_dict` returned (tensors are copied
        onto the model's devices). The schedule is this state's own: a
        resumed run takes its settings from its flags, as the JAX package's
        does."""
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step, self.updates = int(sd["step"]), int(sd["updates"])
        acc = sd["acc"]
        if acc is not None and len(acc) != len(self.params):
            raise ValueError(f"{len(acc)} accumulation buffers for "
                             f"{len(self.params)} parameters")
        self._acc = None if acc is None else [
            a.to(device=p.device, dtype=p.dtype).clone()
            for a, p in zip(acc, self.params)]


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float) -> Dict[str, torch.Tensor]:
    return {k: e * decay + params[k] * (1.0 - decay) for k, e in ema.items()}


@torch.no_grad()
def per_module_grad_norms(grads: Dict[str, torch.Tensor], depth: int = 2
                          ) -> Dict[str, torch.Tensor]:
    """Gradient norm of each group of gradients whose "/"-joined paths share
    their first ``depth`` parts, as ``grad_norm/<a>/<b>``: the JAX
    package's function on its flattened tree. Key the gradients by their
    Flax paths (``utils.checkpoint.action_model_flax_path``) to get the
    JAX package's groups and metric names."""
    groups: Dict[str, List[torch.Tensor]] = {}
    for path, g in grads.items():
        groups.setdefault("/".join(path.split("/")[:depth]), []).append(g)
    return {f"grad_norm/{k}": global_norm(v) for k, v in groups.items()}
