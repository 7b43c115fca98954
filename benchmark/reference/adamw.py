"""AdamW with decoupled weight decay (Loshchilov and Hutter, 2019) behind a
global-norm clip, and the learning-rate schedule of optax's warmup +
cosine, written plainly.

The recipe's rules: the clip scales every gradient by max_norm / norm when
norm >= max_norm; parameters with fewer than two dimensions, and those
whose name holds "embed", are not decayed; the schedule is read at the
count of updates made before this one, so the first update has lr 0.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def lr_at(count: int, recipe: dict) -> float:
    base, warm = recipe["learning_rate"], max(recipe["warmup_steps"], 1)
    if count < warm:
        return base * count / warm
    total = max(recipe["max_train_steps"], recipe["warmup_steps"] + 1) - warm
    x = min(count - warm, total) / total
    return base * 0.5 * (1 + math.cos(math.pi * x))


def decays(name: str, t: torch.Tensor, recipe: dict) -> bool:
    if not recipe["embed_no_wd"]:
        return True
    return t.ndim >= 2 and "embed" not in name


def clip(grads: Dict[str, torch.Tensor], max_norm: float):
    """(clipped grads, the norm before)."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    if norm < max_norm:
        return dict(grads), float(norm)
    return {n: g * float(max_norm / norm) for n, g in grads.items()}, \
        float(norm)


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], recipe: dict):
        self.recipe = recipe
        self.m = {n: torch.zeros_like(t) for n, t in params.items()}
        self.v = {n: torch.zeros_like(t) for n, t in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]):
        r = self.recipe
        b1, b2, eps = r["adam_beta1"], r["adam_beta2"], r["adam_epsilon"]
        lr = lr_at(self.count, r)
        self.count += 1
        t = self.count
        for n, p in params.items():
            g = grads[n]
            if decays(n, p, r):
                p.mul_(1 - lr * r["weight_decay"])
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            mh = self.m[n] / (1 - b1 ** t)
            vh = self.v[n] / (1 - b2 ** t)
            p.sub_(lr * mh / (vh.sqrt() + eps))
