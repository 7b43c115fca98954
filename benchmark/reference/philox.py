"""Philox4x32-10 (Salmon, Moraes, Dror and Shaw, SC 2011; the constants of
Random123) and the attention-dropout mask the port's training step is
keyed by, both in plain integer torch.

32-bit words live in int64 tensors. A product of a 32-bit constant and a
32-bit word is formed from the constant's two 16-bit halves, so no
intermediate leaves 49 bits.

The mask (the port's documented layout): element (b, h, i, j) of an
[B, H, S, S] attention's probabilities is kept iff word j % 4 of
philox(counter, key) is below floor((1 - p) 2^32), where the counter is
(lo, hi) of (b H + h) S ceil(S / 4) + i ceil(S / 4) + j // 4 and (lo, hi)
of the offset, the key (lo, hi) of the seed, and the offset of layer l at
training step t is t * 2^16 + l. A kept element is scaled by 1 / (1 - p).
"""

from __future__ import annotations

import torch

M32 = (1 << 32) - 1
MUL = (0xD2511F53, 0xCD9E8D57)
BUMP = (0x9E3779B9, 0xBB67AE85)


def _mul(m: int, c: torch.Tensor):
    """(hi, lo) of the 64-bit product m * c."""
    a = (m & 0xFFFF) * c           # < 2^48
    b = (m >> 16) * c              # < 2^48
    t = (b & 0xFFFF) * 65536 + a   # < 2^49
    return (b >> 16) + (t >> 32), t & M32


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """The four output words of Philox4x32-10."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + BUMP[0]) & M32, (k1 + BUMP[1]) & M32
        h0, l0 = _mul(MUL[0], c0)
        h1, l1 = _mul(MUL[1], c2)
        c0, c1, c2, c3 = h1 ^ c1 ^ k0, l1, h0 ^ c3 ^ k1, l0
    return c0, c1, c2, c3


def layer_offset(step: int, layer: int) -> int:
    return (int(step) << 16) | int(layer)


def keep_scale(p: float, seed: int, offset: int, b0: int, B: int, H: int,
               S: int, device=None) -> torch.Tensor:
    """Z / (1 - p) [B, H, S, S] fp32 for global rows b0 .. b0 + B - 1."""
    n4 = (S + 3) // 4
    rows = ((torch.arange(b0, b0 + B, device=device)[:, None] * H
             + torch.arange(H, device=device)) * S)[..., None] \
        + torch.arange(S, device=device)
    ctr = rows[..., None] * n4 + torch.arange(n4, device=device)
    zero = torch.zeros_like(ctr)
    words = philox(ctr & M32, ctr >> 32, zero + (offset & M32),
                   zero + (offset >> 32), seed & M32, (seed >> 32) & M32)
    w = torch.stack(words, -1).reshape(B, H, S, 4 * n4)[..., :S]
    keep = w < int((1.0 - p) * 2.0 ** 32)
    return keep.float() / (1.0 - p)
