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

A shard. A data- or tensor-parallel rank holds a block of the global
[B, H] batch of heads: its rows from global row b0 on and its heads from
global head h0 on, of Hg heads in all. Its local (b, h) draws the global
row ((b0 + b) * Hg + h0 + h) * S + i, so a rank's mask is the slice of the
mask a one-process run over the whole batch draws, whatever the layout. The
dropout tuple carries the shard as ``(p, seed, offset, b0, h0, Hg)``; the
three-element ``(p, seed, offset)`` is the shard (0, 0, H) of a call that
holds the whole batch.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF
_U16 = 0xFFFF

# (p, seed, offset) of one attention call's dropout, or (p, seed, offset, b0,
# h0, Hg) with the shard's place in the global batch of heads
Dropout = Union[Tuple[float, int, int], Tuple[float, int, int, int, int, int]]


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
    """(p, seed, offset[, b0, h0, Hg]) with 0 <= p < 1, seed and offset
    64-bit unsigned and the shard's indices non-negative, as numbers of
    their types; None for no dropout."""
    if dropout is None:
        return None
    if len(dropout) not in (3, 6):
        raise ValueError(f"dropout {dropout}: (p, seed, offset) or (p, seed, "
                         f"offset, b0, h0, Hg)")
    p, seed, offset = float(dropout[0]), int(dropout[1]), int(dropout[2])
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout probability {p} outside [0, 1)")
    for name, x in (("seed", seed), ("offset", offset)):
        if not 0 <= x < 2 ** 64:
            raise ValueError(f"dropout {name} {x} is not a 64-bit unsigned "
                             f"integer")
    shard = tuple(int(x) for x in dropout[3:])
    if shard and (min(shard) < 0 or shard[2] < 1 or shard[1] >= shard[2]):
        raise ValueError(f"dropout shard (b0, h0, Hg) = {shard}")
    return (p, seed, offset) + shard


def shard_of(dropout: Optional[Dropout], B: int, H: int
             ) -> Tuple[int, int, int]:
    """(b0, h0, Hg) of a call over B rows and H heads: the dropout's shard,
    (0, 0, H) for the three-element form or none. Raises where the call's
    heads do not fit the shard's Hg, or its head rows do not fit an int,
    as the kernels refuse them."""
    b0, h0, Hg = (0, 0, H) if dropout is None or len(dropout) == 3 \
        else dropout[3:]
    if h0 + H > Hg or (b0 + B) * Hg >= 2 ** 31:
        raise ValueError(f"dropout shard (b0, h0, Hg) = {(b0, h0, Hg)} does "
                         f"not hold {B} rows and {H} heads")
    return b0, h0, Hg


def keep_mask(dropout: Dropout, B: int, H: int, S: int, i0: int, ni: int,
              j0: int, nj: int, device=None) -> torch.Tensor:
    """The keep bits [B, H, ni, nj] of queries i0 .. i0+ni-1 and keys
    j0 .. j0+nj-1 of an S x S attention over B rows and H heads of the
    dropout's shard, bool. One Philox call per group of 4 keys, as the
    kernels make it."""
    dropout = check_dropout(dropout)
    p, seed, offset = dropout[:3]
    b0, h0, Hg = shard_of(dropout, B, H)
    n4 = (S + 3) // 4
    g0, g1 = j0 >> 2, (j0 + nj + 3) >> 2
    row = (((b0 + torch.arange(B, device=device))[:, None, None] * Hg
            + (h0 + torch.arange(H, device=device))[None, :, None]) * S
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
