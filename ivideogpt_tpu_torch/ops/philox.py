"""Philox4x32-10 in torch and the attention-dropout mask drawn from it: the
plain version of ``csrc/philox.cuh``, bit for bit.

The generator (Salmon et al., SC 2011; Random123's constants): a counter of
four 32-bit words and a key of two, ten rounds of

    (hi0, lo0) = 0xD2511F53 * c0,  (hi1, lo1) = 0xCD9E8D57 * c2   (64-bit)
    c = (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0)

with the key bumped by (0x9E3779B9, 0xBB67AE85) before every round but the
first. Words live in int64 tensors masked to 32 bits; a 32 x 32 -> 64-bit
product would overflow a signed int64, so :func:`_mulhilo` builds it from
16-bit halves.

The mask. Element (b, h, i, j) of the [B, H, S, S] attention probabilities
(query i, key j) is kept with probability keep = 1 - p:

    row = (b * H + h) * S + i
    ctr = row * ceil(S / 4) + (j >> 2)
    counter = (lo32(ctr), hi32(ctr), lo32(offset), hi32(offset))
    key = (lo32(seed), hi32(seed))
    keep iff philox(counter, key)[j & 3] < floor(keep * 2^32)

i.e. the linear index of the probabilities with each row padded to a
multiple of 4 keys, divided by 4, the remainder choosing the word. The bit
depends on (seed, offset, b, h, i, j, S) alone, so any chunk of rows and
keys can be drawn on its own (:func:`keep_mask`) and equals the same part of
the whole mask. A kept element is scaled by 1 / keep.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF
_U16 = 0xFFFF

# (p, seed, offset) of one attention call's dropout
Dropout = Tuple[float, int, int]


def _mulhilo(m: int, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of m * c for a 32-bit constant m and words c
    (int64 in [0, 2^32))."""
    mh, ml = m >> 16, m & _U16
    ch, cl = c >> 16, c & _U16
    mid = mh * cl + ml * ch          # < 2^33
    low = ml * cl + ((mid & _U16) << 16)   # < 2^33
    hi = mh * ch + (mid >> 16) + (low >> 32)
    return hi & _U32, low & _U32


def philox4x32_10(counter, key):
    """Philox4x32-10 of counter (c0, c1, c2, c3) and key (k0, k1), each word
    an int64 tensor (or int) in [0, 2^32), broadcast together; returns the
    four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (int(k) & _U32 for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & _U32, (k1 + W1) & _U32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def threshold(p: float) -> int:
    """floor((1 - p) * 2^32): a word below it keeps its element."""
    return int((1.0 - p) * 2.0 ** 32)


def check_dropout(dropout: Optional[Dropout]) -> Optional[Dropout]:
    """(p, seed, offset) with 0 <= p < 1 and seed, offset 64-bit unsigned,
    as ints; None for no dropout."""
    if dropout is None:
        return None
    p, seed, offset = dropout
    p, seed, offset = float(p), int(seed), int(offset)
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout probability {p} outside [0, 1)")
    for name, x in (("seed", seed), ("offset", offset)):
        if not 0 <= x < 2 ** 64:
            raise ValueError(f"dropout {name} {x} is not a 64-bit unsigned "
                             f"integer")
    return p, seed, offset


def keep_mask(dropout: Dropout, B: int, H: int, S: int, i0: int, ni: int,
              j0: int, nj: int, device=None) -> torch.Tensor:
    """The keep bits [B, H, ni, nj] of queries i0 .. i0+ni-1 and keys
    j0 .. j0+nj-1 of an S x S attention, bool. One Philox call per group
    of 4 keys, as the kernels make it."""
    p, seed, offset = check_dropout(dropout)
    n4 = (S + 3) // 4
    g0, g1 = j0 >> 2, (j0 + nj + 3) >> 2
    row = ((torch.arange(B, device=device)[:, None, None] * H
            + torch.arange(H, device=device)[None, :, None]) * S
           + torch.arange(i0, i0 + ni, device=device)[None, None, :])
    ctr = row[..., None] * n4 + torch.arange(g0, g1, device=device)
    words = philox4x32_10(
        (ctr & _U32, ctr >> 32, offset & _U32, offset >> 32),
        (seed & _U32, seed >> 32))
    w = torch.stack(words, dim=-1).flatten(-2)   # [B, H, ni, 4 (g1 - g0)]
    lo = j0 - 4 * g0
    return w[..., lo:lo + nj] < threshold(p)


def causal_groups(B: int, H: int, S: int) -> int:
    """The Philox calls a kernel needs at least to draw the causal part of
    the mask of a [B, H, S, S] attention: one per group of 4 keys that
    holds a key j <= i of its query i. Query i has i // 4 + 1 such groups;
    summed over S = 4 q + r queries, (q + 1) (2 q + r) a head."""
    q, r = divmod(S, 4)
    return B * H * (q + 1) * (2 * q + r)


def offset_of(step: int, layer: int) -> int:
    """The Philox offset of layer ``layer``'s attention at training step
    ``step``: a stream of its own for every (step, layer)."""
    if not 0 <= layer < 2 ** 16:
        raise ValueError(f"layer {layer} outside [0, 65536)")
    return (int(step) << 16) | layer
