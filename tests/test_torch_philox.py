"""The port's counter-based generator (``ops/philox.py``, the plain version
of ``csrc/philox.cuh``): Philox4x32-10's known answers, the 16-bit-halves
product against Python's integers, and the dropout mask: a pure function of
(seed, offset, b, h, i, j, S), so any chunk of it equals the same part of
the whole, with the kept share near 1 - p."""

import numpy as np
import pytest
import torch

from ivideogpt_tpu_torch.ops import philox

M = 0xFFFFFFFF


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((M, M, M, M), (M, M), (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's kat_vectors for philox4x32_10."""
    got = philox.philox4x32_10(counter, key)
    assert tuple(int(w) for w in got) == want


def test_mulhilo_matches_python_integers():
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.integers(0, 2 ** 32, 4096, dtype=np.int64))
    c[:3] = torch.tensor([0, 1, M])
    for m in (philox.M0, philox.M1, M):
        hi, lo = philox._mulhilo(m, c)
        want = [m * int(x) for x in c]
        assert [int(x) for x in hi] == [w >> 32 for w in want]
        assert [int(x) for x in lo] == [w & M for w in want]


def _reference_mask(drop, B, H, S):
    """The layout written out element by element with Python integers."""
    p, seed, offset = drop
    thr = int((1.0 - p) * 2 ** 32)
    n4 = (S + 3) // 4
    out = np.zeros((B, H, S, S), bool)
    for b in range(B):
        for h in range(H):
            for i in range(S):
                for j in range(S):
                    ctr = ((b * H + h) * S + i) * n4 + (j >> 2)
                    w = philox.philox4x32_10(
                        (ctr & M, ctr >> 32, offset & M, offset >> 32),
                        (seed & M, seed >> 32))
                    out[b, h, i, j] = int(w[j & 3]) < thr
    return out


def test_mask_layout_matches_its_definition():
    drop = (0.3, 2 ** 40 + 7, (9 << 16) | 1)
    got = philox.keep_mask(drop, 2, 2, 7, 0, 7, 0, 7)
    np.testing.assert_array_equal(got.numpy(),
                                  _reference_mask(drop, 2, 2, 7))


@pytest.mark.parametrize("i0,ni,j0,nj", [(0, 751, 0, 751), (128, 128, 0, 256),
                                          (700, 51, 3, 9), (5, 1, 750, 1),
                                          (1, 33, 2, 129)])
def test_any_chunk_of_the_mask_equals_the_same_part_of_the_whole(i0, ni, j0,
                                                                 nj):
    drop = (0.1, 42, philox.offset_of(1000, 11))
    B, H, S = 2, 3, 751
    whole = philox.keep_mask(drop, B, H, S, 0, S, 0, S)
    part = philox.keep_mask(drop, B, H, S, i0, ni, j0, nj)
    assert part.shape == (B, H, ni, nj)
    assert torch.equal(part, whole[:, :, i0:i0 + ni, j0:j0 + nj])


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_kept_share_is_within_5_sigma_of_keep(p):
    B, H, S = 2, 12, 751
    z = philox.keep_mask((p, 7, 3), B, H, S, 0, S, 0, S)
    sigma = (p * (1 - p) / z.numel()) ** 0.5
    assert abs(float(z.float().mean()) - (1 - p)) < 5 * sigma


def test_streams_differ_by_seed_offset_and_head():
    base = philox.keep_mask((0.5, 1, 0), 1, 2, 64, 0, 64, 0, 64)
    for other in ((0.5, 2, 0), (0.5, 1, 1)):
        assert not torch.equal(base, philox.keep_mask(other, 1, 2, 64, 0, 64,
                                                      0, 64))
    assert not torch.equal(base[0, 0], base[0, 1])


def test_offset_of_and_checks():
    offsets = {philox.offset_of(s, l) for s in range(50) for l in range(24)}
    assert len(offsets) == 50 * 24
    assert philox.offset_of(3, 2) == (3 << 16) | 2
    with pytest.raises(ValueError):
        philox.offset_of(0, 1 << 16)
    for bad in ((1.0, 0, 0), (-0.1, 0, 0), (0.1, -1, 0), (0.1, 0, 2 ** 64)):
        with pytest.raises(ValueError):
            philox.check_dropout(bad)
    assert philox.check_dropout(None) is None
    assert philox.threshold(0.1) == int(0.9 * 2 ** 32)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 6, 7, 8, 63, 64, 65, 130, 751])
@pytest.mark.parametrize("B,H", [(1, 1), (2, 3), (16, 12)])
def test_causal_groups_counts_the_groups_holding_a_causal_key(B, H, S):
    """Brute force over rows: the groups (i, j >> 2) of keys j < S with some
    key j <= i, as the mask's layout groups them."""
    per_head = sum(len({j >> 2 for j in range(min(i + 1, S))})
                   for i in range(S))
    assert philox.causal_groups(B, H, S) == B * H * per_head


def test_causal_groups_at_the_training_shapes():
    """LLAMA_BASE's 12 heads and LLAMA_MEDIUM's 16 at B=16, S=751."""
    assert philox.causal_groups(16, 12, 751) == 13_608_192
    assert philox.causal_groups(16, 16, 751) == 18_144_256


def _keep_tile(drop, S, bh, i0, j0):
    """The 128 words ``ivg::draw_keep_tile`` (csrc/philox.cuh) leaves for the
    (i0, j0) tile of head bh, in numpy: thread x draws word 2 (x & 63) +
    (x >> 6), query i0 + (x & 63), keys j0 + 32 (x >> 6) .. + 31, as 8
    Philox calls at consecutive group counters whose compares ``keep_word``
    shifts in from key 31 down (w >= threshold: dropped), so key n of the
    word ends at bit n once inverted. Returns (words, drawn): a query at or
    past S and 32 keys all past their query are not drawn."""
    p, seed, offset = drop
    x = np.arange(128)
    r, half = x & 63, x >> 6
    i, j = i0 + r, j0 + 32 * half
    ctr = (bh * S + i) * ((S + 3) // 4) + (j >> 2)
    ctrs = torch.from_numpy(ctr[:, None] + np.arange(8))
    w = [t.numpy() for t in philox.philox4x32_10(
        (ctrs & M, ctrs >> 32, offset & M, offset >> 32),
        (seed & M, seed >> 32))]
    dropped = np.zeros(128, np.int64)
    for u in range(7, -1, -1):
        for word in (w[3], w[2], w[1], w[0]):
            dropped = (dropped << 1) | (word[:, u] >= philox.threshold(p))
    words = np.zeros(128, np.int64)
    words[2 * r + half] = ~dropped & M
    drawn = np.zeros(128, bool)
    drawn[2 * r + half] = (i < S) & (j <= i)
    return words, drawn


@pytest.mark.parametrize("S,i0,j0", [(751, 0, 0), (751, 320, 128),
                                     (751, 704, 704), (751, 704, 448),
                                     (65, 64, 0), (65, 64, 64), (5, 0, 0)])
def test_keep_tile_layout_gives_each_accumulator_element_its_own_bit(S, i0,
                                                                     j0):
    """The words of draw_keep_tile, read as sm90.cuh reads them, give every
    accumulator element of the m64n64 tile (warp w, lane 4 g + t: x[4 jj +
    2 r + e] at row 16 w + g + 8 r, key 8 jj + 2 t + e) the keep bit of its
    own (query, key) from ``keep_mask``, wherever the element is causal
    and its query below S. drop_rows (both K4s' P, K6's dP) reads word
    2 row + 16 r + (jj >> 2), bit 8 (jj & 3) + 2 t + e; p_ds_transposed
    (K5's P^T and dS^T: rows keys, columns queries) reads word 2 c + w / 2,
    bit 16 (w & 1) + g + 8 r for query c."""
    B, H, bh = 2, 3, 4
    drop = (0.25, 2 ** 33 + 5, philox.offset_of(9, 2))
    b, h = divmod(bh, H)
    want = philox.keep_mask(drop, B, H, S, 0, S, 0, S)[b, h].numpy()
    words, drawn = _keep_tile(drop, S, bh, i0, j0)
    live = 0
    for x in range(128):
        w, g, t = x >> 5, (x & 31) >> 2, x & 3
        for idx in range(32):
            jj, r, e = idx >> 2, (idx >> 1) & 1, idx & 1
            # drop_rows: rows are queries, columns keys
            row, col = 16 * w + g + 8 * r, 8 * jj + 2 * t + e
            i, j = i0 + row, j0 + col
            if i < S and j <= i:
                word = 2 * row + (jj >> 2)
                assert drawn[word]
                bit = (words[word] >> (2 * t + 8 * (jj & 3) + e)) & 1
                assert bit == want[i, j], ("drop_rows", x, idx)
                live += 1
            # p_ds_transposed: rows are keys, columns queries
            key, c = row, col
            i, j = i0 + c, j0 + key
            if i < S and j <= i:
                word = 2 * c + (w >> 1)
                assert drawn[word]
                bit = (words[word] >> (16 * (w & 1) + g + 8 * r)) & 1
                assert bit == want[i, j], ("p_ds_transposed", x, idx)
    # every causal element of the tile below S was read
    assert live == sum(max(0, min(i, j0 + 63) - j0 + 1)
                       for i in range(i0, min(S, i0 + 64)))
