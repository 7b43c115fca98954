"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips when there is none. Imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_*.py

The checks at the main path's full shapes are ``chip_smoke.py``'s phases;
these cover the edges: ragged tiles, small D, K1 equal to K2 bit for bit,
ties across K1's and K2's codebook splits, fp32 queries, a single live
slot, K3's split edges, split counts, head groups, determinism, valid on
the card, its CUDA graph and its trap, K3's grouped-head and mixed-cache
variants, strided views, the bf16 K4, K5 and
K6 and the fp32 (three-term TF32) K4, K5 and K6 at their own interface (lse
in, lse out) and launch to launch, and the wrappers' refusals.
"""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("n,k,d", [(1, 1, 64), (1000, 333, 64), (4097, 64, 8),
                                   (300, 8192, 32)])
def test_vq_argmin_matches_plain(cuda, n, k, d):
    from ivideogpt_tpu_torch.ops import vq
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    g = torch.Generator(device=cuda).manual_seed(n + k)
    z = torch.randint(-3, 4, (n, d), device=cuda, generator=g).float()
    e = torch.randint(-3, 4, (k, d), device=cuda, generator=g).float()
    before = vq.vq_argmin.launches
    with full_fp32():
        ours = vq.vq_argmin(z, e)
        ref = vq.vq_lookup_plain(z, e)
    assert vq.vq_argmin.launches == before + 1
    # small integers: every distance is exact, ties included
    torch.testing.assert_close(ours, ref, rtol=0, atol=0)


@pytest.mark.parametrize("k", [1, 63, 64, 65, 8192])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 1536, 3584, 8192])
def test_vq_argmin_equals_k2_bit_for_bit(cuda, n, d, k):
    """K1 and K2 take the same fp32 arithmetic (one fmaf chain over d, the
    wrapper's ||E||^2, a strict < in k, ties to the smallest index), so on
    random inputs their ids are equal, not merely close. A duplicated code
    and a row equal to it plant an exact tie."""
    from ivideogpt_tpu_torch.ops import vq
    g = torch.Generator(device=cuda).manual_seed(n * 1000 + d * 10 + k)
    z = torch.randn(n, d, device=cuda, generator=g)
    e = torch.randn(k, d, device=cuda, generator=g)
    if k > 1:
        e[k - 1] = e[k // 2]
        z[0] = e[k // 2]
    before = vq.vq_argmin.launches
    ours = vq.vq_argmin(z, e)
    assert vq.vq_argmin.launches == before + 1
    assert ours.dtype == torch.int64 and ours.shape == (n,)
    assert torch.equal(ours, vq.vq_argmin_tiled(z, e))
    if k > 1:
        assert int(ours[0]) == k // 2


def test_vq_argmin_ties_across_every_split_go_to_the_smallest_index(cuda):
    from ivideogpt_tpu_torch.ops import vq
    n, k, d = 1536, 8192, 64
    g = torch.Generator(device=cuda).manual_seed(0)
    e = torch.randn(k, d, device=cuda, generator=g)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits, per = vq.vq_splits(n, k, sms, vq.K1_FIXED_TILES)
    assert splits > 1
    for s in range(1, splits):   # copies of codes 0..49 on every boundary
        e[s * per - 25:s * per + 25] = e[:50]
    z = torch.cat([e[:50], torch.randn(n - 50, d, device=cuda, generator=g)])
    ids = vq.vq_argmin(z, e)
    assert (ids[:50] == torch.arange(50, device=cuda)).all()
    for s in range(1, splits):
        assert not ((ids >= s * per - 25) & (ids < s * per + 25)).any()


def test_vq_argmin_refuses_unsupported_width(cuda):
    from ivideogpt_tpu_torch.ops import vq
    with pytest.raises(ValueError):
        vq.vq_argmin(torch.zeros(4, 12, device=cuda),
                     torch.zeros(8, 12, device=cuda))


@pytest.mark.parametrize("d", [1, 3, 5, 63, 65, 255, 256, 257, 320, 321,
                               511, 512])
@pytest.mark.parametrize("k", [1, 127, 128, 129, 16385])
@pytest.mark.parametrize("n", [1, 127, 129, 1536])
def test_vq_argmin_tiled_matches_plain(cuda, n, k, d):
    """Ragged N, K and D around K2's 128-row and 128-code tiles, its
    32-dimension stages and its two routes (z^T resident up to D=320,
    streamed beyond)."""
    from ivideogpt_tpu_torch.ops import vq
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    g = torch.Generator(device=cuda).manual_seed(n * k + d)
    z = torch.randint(-3, 4, (n, d), device=cuda, generator=g).float()
    e = torch.randint(-3, 4, (k, d), device=cuda, generator=g).float()
    before = vq.vq_argmin_tiled.launches
    with full_fp32():
        ours = vq.vq_argmin_tiled(z, e)
        ref = vq.vq_lookup_plain(z, e)
    assert vq.vq_argmin_tiled.launches == before + 1
    assert ours.dtype == torch.int64 and ours.shape == (n,)
    # small integers: every distance is exact, ties included
    torch.testing.assert_close(ours, ref, rtol=0, atol=0)


@pytest.mark.parametrize("n,k,d", [(1536, 16384, 256), (4097, 1000, 72),
                                   (300, 16385, 512)])
def test_vq_argmin_tiled_agrees_with_plain_but_for_near_ties(cuda, n, k, d):
    """Random normal inputs: ids may differ from the plain version's (fp32
    sums in another order) only where the two picks' float64 distances are
    within 1e-5 of the distances' scale, at most N/1000 rows; two launches
    give the same ids bit for bit."""
    from ivideogpt_tpu_torch.ops import vq
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    g = torch.Generator(device=cuda).manual_seed(n + k + d)
    z = torch.randn(n, d, device=cuda, generator=g)
    e = torch.randn(k, d, device=cuda, generator=g)
    with full_fp32():
        ours = vq.vq_argmin_tiled(z, e)
        ref = vq.vq_lookup_plain(z, e)
    assert torch.equal(ours, vq.vq_argmin_tiled(z, e))
    diff = (ours != ref).nonzero()[:, 0]
    z64, e64 = z[diff].double(), e.double()
    gap = (((z64 - e64[ours[diff]]) ** 2).sum(1)
           - ((z64 - e64[ref[diff]]) ** 2).sum(1)).abs()
    scale = (z64 ** 2).sum(1) + (e64[ours[diff]] ** 2).sum(1)
    assert bool((gap < 1e-5 * scale).all()) and len(diff) <= n // 1000


@pytest.mark.parametrize("d", [64, 256, 320, 321, 512])
def test_vq_argmin_tiled_route_follows_the_width(cuda, d):
    """K2 keeps z^T in shared memory up to D=320 and streams it beyond,
    within the shared memory a CTA may take; test_vq_argmin_tiled_matches_plain
    holds the ids of both routes (D up to 320 and past it)."""
    from ivideogpt_tpu_torch.ops import vq
    resident, smem = vq.k2_route(d)
    assert resident == (d <= 320) and 0 < smem <= 232448


def test_vq_argmin_tiled_ties_across_a_split_go_to_the_smallest_index(cuda):
    from ivideogpt_tpu_torch.ops import vq
    n, k, d = 100, 16384, 256
    g = torch.Generator(device=cuda).manual_seed(0)
    e = torch.randn(k, d, device=cuda, generator=g)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits, per = vq.vq_splits(n, k, sms, vq.k2_fixed(d))
    assert splits > 1
    for s in range(1, splits):   # copies of rows 0..49 on every boundary
        e[s * per - 25:s * per + 25] = e[:50]
    z = torch.cat([e[:50], torch.randn(n - 50, d, device=cuda, generator=g)])
    ids = vq.vq_argmin_tiled(z, e)
    assert (ids[:50] == torch.arange(50, device=cuda)).all()
    for s in range(1, splits):
        assert not ((ids >= s * per - 25) & (ids < s * per + 25)).any()


@pytest.mark.parametrize("n", [5, 1536])
def test_vq_argmin_tiled_rows_without_a_finite_distance_get_0(cuda, n):
    """NaN distances never win; a row whose every distance is NaN or inf
    gets 0, as K1 and the TPU kernels give; K1 agrees bit for bit."""
    from ivideogpt_tpu_torch.ops import vq
    g = torch.Generator(device=cuda).manual_seed(n)
    k, d = 16384, 64
    z = torch.randn(n, d, device=cuda, generator=g)
    e = torch.randn(k, d, device=cuda, generator=g)
    z[0] = float("nan")                 # every distance NaN
    z[1] = float("inf")                 # every distance NaN or inf
    z[2, 0] = float("nan")
    e[7, 3] = float("nan")              # code 7 never wins
    z[3] = e[7]
    z[3, 3] = 0.5
    ids = vq.vq_argmin_tiled(z, e)
    assert int(ids[0]) == 0 and int(ids[1]) == 0 and int(ids[2]) == 0
    assert int(ids[3]) != 7
    assert torch.equal(ids, vq.vq_argmin(z, e))


def test_vq_argmin_tiled_takes_views_and_other_dtypes(cuda):
    from ivideogpt_tpu_torch.ops import vq
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    g = torch.Generator(device=cuda).manual_seed(1)
    zt = torch.randint(-3, 4, (72, 300), device=cuda, generator=g).float()
    e2 = torch.randint(-3, 4, (900, 144), device=cuda, generator=g).float()
    z, e = zt.t(), e2[::3, ::2]          # (300, 72) and (300, 72) views
    assert not z.is_contiguous() and not e.is_contiguous()
    with full_fp32():
        ref = vq.vq_lookup_plain(z, e)
        torch.testing.assert_close(vq.vq_argmin_tiled(z, e), ref, rtol=0,
                                   atol=0)
        # rows through their stride, from no 16-byte boundary: no copy
        er = e2[::3, 10:82]
        assert er.stride(1) == 1 and er.data_ptr() % 16
        torch.testing.assert_close(vq.vq_argmin_tiled(z, er),
                                   vq.vq_lookup_plain(z, er), rtol=0, atol=0)
        # bf16 queries are upcast, as the plain version does
        zb = z.bfloat16()
        torch.testing.assert_close(vq.vq_argmin_tiled(zb, e),
                                   vq.vq_lookup_plain(zb, e), rtol=0, atol=0)


def test_vq_argmin_tiled_refuses_what_it_does_not_take(cuda):
    from ivideogpt_tpu_torch.ops import vq
    for z, e in ((torch.zeros(4, 16, device=cuda), torch.zeros(8, 16)),
                 (torch.zeros(4, 516, device=cuda),
                  torch.zeros(8, 516, device=cuda)),
                 (torch.zeros(4, 16, device=cuda),
                  torch.zeros(0, 16, device=cuda)),
                 (torch.zeros(4, 16, device=cuda),
                  torch.zeros(8, 12, device=cuda))):
        with pytest.raises(ValueError):
            vq.vq_argmin_tiled(z, e)


def test_vq_lookup_routes_to_k1_and_k2(cuda):
    from ivideogpt_tpu_torch.ops import vq
    counts = (vq.vq_argmin.launches, vq.vq_argmin_tiled.launches)
    vq.vq_lookup(torch.zeros(2, 3, 64, device=cuda),
                 torch.zeros(8192, 64, device=cuda))
    vq.vq_lookup(torch.zeros(2, 3, 256, device=cuda),
                 torch.zeros(16384, 256, device=cuda))
    vq.vq_lookup(torch.zeros(2, 3, 72, device=cuda),
                 torch.zeros(64, 72, device=cuda))
    assert (vq.vq_argmin.launches, vq.vq_argmin_tiled.launches) == (
        counts[0] + 1, counts[1] + 2)


@pytest.mark.parametrize("valid", [1, 127, 128, 129, 200])
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
def test_decode_attention_matches_plain(cuda, valid, qdtype):
    from ivideogpt_tpu_torch.ops import decode_attention as da
    B, M, H, hd = 3, 200, 5, 64   # M is no multiple of the 128-slot tile
    g = torch.Generator(device=cuda).manual_seed(valid)
    q = torch.randn(B, H, hd, device=cuda, generator=g).to(qdtype)
    k = torch.randint(-127, 128, (B, M, H, hd), device=cuda, generator=g,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (B, M, H, hd), device=cuda, generator=g,
                      dtype=torch.int8)
    ks = (torch.rand(B, M, H, device=cuda, generator=g) * 0.02).bfloat16()
    vs = (torch.rand(B, M, H, device=cuda, generator=g) * 0.02).bfloat16()
    before = da.decode_attention.launches
    ours = da.decode_attention(q, k, ks, v, vs, valid)
    assert da.decode_attention.launches == before + 1
    ref = da.decode_attention_plain(q, k, ks, v, vs, valid)
    assert ours.dtype == qdtype
    # fp32 sums in another order; a bf16 output may differ by one ulp
    tol = dict(rtol=2e-2, atol=2e-3) if qdtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ours, ref, **tol)


@pytest.mark.parametrize("valid", [514, 599, 683])
def test_decode_attention_at_the_mbrl_rollouts_shape(cuda, valid):
    """The MBRL imagination rollout's K3 calls: B=32, H=12, a cache of
    514 + 17 * 10 slots, valid from the first frame's sdf to the last
    token (384 (b, h) blocks, fewer than 3 an SM)."""
    from ivideogpt_tpu_torch.ops import decode_attention as da
    B, M, H, hd = 32, 684, 12, 64
    g = torch.Generator(device=cuda).manual_seed(valid)
    q = torch.randn(B, H, hd, device=cuda, generator=g).bfloat16()
    k, v = (torch.randint(-127, 128, (B, M, H, hd), device=cuda,
                          generator=g, dtype=torch.int8) for _ in range(2))
    ks, vs = ((torch.rand(B, M, H, device=cuda, generator=g) * 0.02
               + 0.001).bfloat16() for _ in range(2))
    ours = da.decode_attention(q, k, ks, v, vs, valid)
    ref = da.decode_attention_plain(q, k, ks, v, vs, valid)
    # fp32 sums in another order; a bf16 output may differ by one ulp
    torch.testing.assert_close(ours, ref, rtol=2e-2, atol=2e-3)


def test_decode_attention_refuses_bad_valid(cuda):
    from ivideogpt_tpu_torch.ops import decode_attention as da
    q = torch.zeros(1, 1, 64, device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros(1, 4, 1, 64, device=cuda, dtype=torch.int8)
    s = torch.zeros(1, 4, 1, device=cuda, dtype=torch.bfloat16)
    for valid in (0, 5):
        with pytest.raises(ValueError):
            da.decode_attention(q, kv, s, kv, s, valid)
    for bad in (torch.tensor([1], dtype=torch.int64, device=cuda),
                torch.tensor([1, 1], dtype=torch.int32, device=cuda),
                torch.tensor([1], dtype=torch.int32)):
        with pytest.raises(ValueError):
            da.decode_attention(q, kv, s, kv, s, bad)


def _k3_inputs(cuda, B, M, H, qdtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, H, 64, device=cuda, generator=g).to(qdtype)
    k, v = (torch.randint(-127, 128, (B, M, H, 64), device=cuda, generator=g,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = ((torch.rand(B, M, H, device=cuda, generator=g) * 0.02
               + 0.001).bfloat16() for _ in range(2))
    return q, k, ks, v, vs


def _k3_tol(qdtype):
    # fp32 sums in another order; a bf16 output may differ by one ulp
    return dict(rtol=2e-2, atol=2e-3) if qdtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,M", [(1, 684), (3, 684), (32, 684), (256, 100)])
def test_decode_attention_at_split_edges(cuda, B, M, qdtype):
    """K3 against the plain version and the plain split-then-merge at 1, M
    and the edges (+-1) of the plan's first two splits: 43 splits of one
    16-slot tile at B=1 and 3, 4 of 176 slots at B=32, one split (no
    merge) at B=256."""
    from ivideogpt_tpu_torch.ops import decode_attention as da
    H = 12
    splits = da.decode_splits(B, H, M, da._sms(cuda))
    per = da.split_len(M, splits)
    q, k, ks, v, vs = _k3_inputs(cuda, B, M, H, qdtype, B)
    edges = {1, 2, 15, 16, 17, per - 1, per, per + 1, 2 * per - 1, 2 * per,
             2 * per + 1, M - 1, M}
    for valid in sorted(x for x in edges if 1 <= x <= M):
        ours = da.decode_attention(q, k, ks, v, vs, valid)
        assert ours.dtype == qdtype
        tol = _k3_tol(qdtype)
        torch.testing.assert_close(
            ours, da.decode_attention_plain(q, k, ks, v, vs, valid), **tol)
        torch.testing.assert_close(
            ours, da.decode_attention_split_plain(q, k, ks, v, vs, valid,
                                                  splits), **tol)


@pytest.mark.parametrize("H", [1, 5, 12, 16])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 19])
def test_decode_attention_at_every_split_count(cuda, splits, H):
    """Any split count (runs of 16 slots up to 160, ragged last runs,
    trailing empty ones), through the launch the wrapper's plan feeds, with
    one head, an odd head count and two head groups, at a single slot,
    ragged tiles and a full cache; two launches the same bits. M=301: at
    H in {1, 5} the scale tensors end off a 16-byte boundary, where the
    last tile's scales are copied plainly."""
    from ivideogpt_tpu_torch.ops import decode_attention as da
    B, M = 2, 301
    q, k, ks, v, vs = _k3_inputs(cuda, B, M, H, torch.float32, splits)
    for valid in (1, 17, 97, 150, 300, 301):
        ours = da._launch(q, k, ks, v, vs, valid, splits)
        torch.testing.assert_close(
            ours, da.decode_attention_plain(q, k, ks, v, vs, valid),
            **_k3_tol(torch.float32))
        torch.testing.assert_close(
            ours, da.decode_attention_split_plain(q, k, ks, v, vs, valid,
                                                  splits),
            **_k3_tol(torch.float32))
        assert torch.equal(ours, da._launch(q, k, ks, v, vs, valid, splits))


@pytest.mark.parametrize("H", [16, 25])
def test_decode_attention_head_groups(cuda, H):
    """More heads than a block holds (12): 2 groups of 8 (one row a
    slot row copy each), 3 of 9 (the last one 7)."""
    from ivideogpt_tpu_torch.ops import decode_attention as da
    q, k, ks, v, vs = _k3_inputs(cuda, 3, 300, H, torch.bfloat16, H)
    for valid in (1, 150, 300):
        torch.testing.assert_close(
            da.decode_attention(q, k, ks, v, vs, valid),
            da.decode_attention_plain(q, k, ks, v, vs, valid),
            **_k3_tol(torch.bfloat16))


@pytest.mark.parametrize("B", [1, 32, 256])
def test_decode_attention_is_deterministic_and_reads_valid_on_the_card(
        cuda, B):
    """Two launches give the same bits (the splits merge in split order,
    whichever block finishes last), and an int32 valid on the card gives
    the bits the host int gives, one launch a call either way."""
    from ivideogpt_tpu_torch.ops import decode_attention as da
    M, H = (684, 12) if B < 256 else (100, 12)
    q, k, ks, v, vs = _k3_inputs(cuda, B, M, H, torch.bfloat16, 7)
    for valid in (1, 17, M // 2, M):
        before = da.decode_attention.launches
        a = da.decode_attention(q, k, ks, v, vs, valid)
        b = da.decode_attention(q, k, ks, v, vs, valid)
        dev = da.decode_attention(q, k, ks, v, vs, torch.tensor(
            [valid], dtype=torch.int32, device=cuda))
        assert da.decode_attention.launches == before + 3
        assert torch.equal(a, b) and torch.equal(a, dev)


def _k3_variant_inputs(cuda, B, M, H, kv, mixed, qdtype, seed):
    """A grouped (kv < H KV heads) and/or mixed (bf16 K, no ks) cache."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, H, 64, device=cuda, generator=g).to(qdtype)
    k = (torch.randn(B, M, kv, 64, device=cuda, generator=g).bfloat16()
         if mixed else torch.randint(-127, 128, (B, M, kv, 64), device=cuda,
                                     generator=g, dtype=torch.int8))
    v = torch.randint(-127, 128, (B, M, kv, 64), device=cuda, generator=g,
                      dtype=torch.int8)
    ks = None if mixed else (torch.rand(B, M, kv, device=cuda, generator=g)
                             * 0.02 + 0.001).bfloat16()
    vs = (torch.rand(B, M, kv, device=cuda, generator=g) * 0.02
          + 0.001).bfloat16()
    return q, k, ks, v, vs


@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,M,H,kv,mixed", [
    (256, 752, 12, 4, False), (256, 752, 12, 1, False),
    (256, 752, 12, 12, True), (256, 752, 12, 4, True),
    (32, 684, 12, 4, False), (32, 684, 12, 12, True), (3, 301, 16, 4, False),
    (3, 301, 16, 2, True), (2, 100, 24, 8, True), (2, 100, 25, 5, False),
    (1, 64, 6, 3, True)])
def test_decode_attention_variants_match_plain(cuda, B, M, H, kv, mixed,
                                               qdtype):
    """K3 over grouped KV heads and over the mixed cache against the plain
    version and the plain split-then-merge, at a single slot, ragged tiles,
    split edges and a full cache; head groups (H 16, 24, 25) whose blocks
    read part of the KV heads (one slot row a copy); two launches the same
    bits; the launch counted on its variant alone."""
    from ivideogpt_tpu_torch.ops import decode_attention as da
    q, k, ks, v, vs = _k3_variant_inputs(cuda, B, M, H, kv, mixed, qdtype,
                                         B + H + kv)
    splits = da.decode_splits(B, H, M, da._sms(cuda))
    per = da.split_len(M, splits)
    fn = da.decode_attention
    count = "mixed_launches" if mixed else "grouped_launches"
    for valid in sorted({1, 17, per, min(per + 1, M), M - 1, M}):
        before = (getattr(fn, count), fn.launches)
        ours = da.decode_attention(q, k, ks, v, vs, valid)
        assert (getattr(fn, count), fn.launches) == (before[0] + 1, before[1])
        tol = _k3_tol(qdtype)
        torch.testing.assert_close(
            ours, da.decode_attention_plain(q, k, ks, v, vs, valid), **tol)
        torch.testing.assert_close(
            ours, da.decode_attention_split_plain(q, k, ks, v, vs, valid,
                                                  splits), **tol)
        assert torch.equal(ours, da.decode_attention(q, k, ks, v, vs, valid))


@pytest.mark.parametrize("splits", [1, 3, 7])
def test_decode_attention_variants_at_every_split_count(cuda, splits):
    """The variants through the split launch, valid on the card too."""
    from ivideogpt_tpu_torch.ops import decode_attention as da
    for kv, mixed in ((4, False), (12, True), (3, True)):
        q, k, ks, v, vs = _k3_variant_inputs(cuda, 2, 301, 12, kv, mixed,
                                             torch.float32, splits)
        for valid in (1, 97, 301):
            ours = da._launch(q, k, ks, v, vs, valid, splits)
            torch.testing.assert_close(
                ours, da.decode_attention_split_plain(q, k, ks, v, vs, valid,
                                                      splits),
                **_k3_tol(torch.float32))
            dev = da._launch(q, k, ks, v, vs, torch.tensor(
                [valid], dtype=torch.int32, device=cuda), splits)
            assert torch.equal(ours, dev)


def test_decode_attention_variants_refuse(cuda):
    """What no instance launches raises: query heads that do not group over
    the KV heads, an int8 K without ks, a bf16 K with ks, fp32 K."""
    from ivideogpt_tpu_torch.ops import decode_attention as da
    q, k, ks, v, vs = _k3_variant_inputs(cuda, 2, 64, 12, 5, False,
                                         torch.bfloat16, 1)
    with pytest.raises(ValueError, match="shapes"):
        da.decode_attention(q, k, ks, v, vs, 10)
    q, k, ks, v, vs = _k3_variant_inputs(cuda, 2, 64, 12, 4, False,
                                         torch.bfloat16, 2)
    with pytest.raises(ValueError, match="takes int8 k"):
        da.decode_attention(q, k, None, v, vs, 10)
    with pytest.raises(ValueError, match="takes int8 k"):
        da.decode_attention(q, k.bfloat16(), ks, v, vs, 10)
    with pytest.raises(ValueError, match="takes int8 k"):
        da.decode_attention(q, k.float(), None, v, vs, 10)


def test_decode_attention_graph_replays_at_two_lengths(cuda):
    """One capture of K3 with valid on the card serves every length: fill
    valid, replay, and the output is the host-int path's, bit for bit."""
    from ivideogpt_tpu_torch.ops import decode_attention as da
    B, M, H = 32, 684, 12
    q, k, ks, v, vs = _k3_inputs(cuda, B, M, H, torch.bfloat16, 11)
    vt = torch.full((1,), M, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.decode_attention(q, k, ks, v, vs, vt)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, k, ks, v, vs, vt)
    for valid in (599, 514):
        vt.fill_(valid)
        before = da.decode_attention.launches
        graph.replay()
        assert da.decode_attention.launches == before
        want = da.decode_attention(q, k, ks, v, vs, valid)
        assert torch.equal(out, want), valid
        torch.testing.assert_close(
            out, da.decode_attention_plain(q, k, ks, v, vs, valid),
            **_k3_tol(torch.bfloat16))


def test_decode_attention_traps_on_a_bad_valid_on_the_card(cuda):
    """valid outside [1, M] on the card is never clamped: the kernel traps,
    which ends the process's CUDA context (so it runs in a child)."""
    import os
    import subprocess
    import sys
    code = ("import torch\n"
            "from ivideogpt_tpu_torch.ops import decode_attention as da\n"
            "q = torch.zeros(1, 1, 64, device='cuda', dtype=torch.bfloat16)\n"
            "kv = torch.zeros(1, 4, 1, 64, device='cuda', dtype=torch.int8)\n"
            "s = torch.zeros(1, 4, 1, device='cuda', dtype=torch.bfloat16)\n"
            "vt = torch.tensor([VALID], dtype=torch.int32, device='cuda')\n"
            "da.decode_attention(q, kv, s, kv, s, vt)\n"
            "torch.cuda.synchronize()\n"
            "print('no trap')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for valid in (0, 5):
        res = subprocess.run(
            [sys.executable, "-c", code.replace("VALID", str(valid))],
            cwd=root, capture_output=True, text=True, timeout=300)
        assert res.returncode != 0 and "no trap" not in res.stdout, \
            res.stdout + res.stderr


def test_decode_attention_head_limit_matches_the_library(cuda):
    from ivideogpt_tpu_torch.ops import decode_attention as da
    assert da.kernel_max_heads() == da.K3_MAX_HEADS


def _qkv(cuda, S, dtype, seed, strided=False):
    B, H, hd = 3, 5, 64   # B*H = 15: no multiple of anything
    g = torch.Generator(device=cuda).manual_seed(seed)
    shape = (B, H, S, hd) if strided else (B, S, H, hd)
    ts = [torch.randn(shape, device=cuda, generator=g).to(dtype)
          for _ in range(4)]
    if strided:  # bshd views of [B, H, S, hd] tensors
        ts = [t.transpose(1, 2) for t in ts]
    return [t.requires_grad_(i < 3) for i, t in enumerate(ts)]


@pytest.mark.parametrize("S", [1, 63, 64, 65, 513, 683, 751])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_matches_plain(cuda, S, dtype):
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    q, k, v, do = _qkv(cuda, S, dtype, S, strided=S == 65)
    counts = (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches,
              fa.flash_bwd_dq.launches)
    out = fa.causal_attention(q, k, v, dtype)
    grads = torch.autograd.grad(out, (q, k, v), do.flatten(2))
    assert (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches,
            fa.flash_bwd_dq.launches) == tuple(c + 1 for c in counts)
    assert out.dtype == dtype and all(g.dtype == dtype for g in grads)
    # the reference: the plain version in fp32 on the same (upcast) inputs,
    # TF32 off. The kernels keep fp32 scores and sums; in bf16 they round P
    # and dS to bf16 before their products (as the TPU kernel does), round
    # the result once at the end (2^-9 relative), and di reads the bf16 O.
    ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
    with full_fp32():
        ref = fa.causal_attention_plain(*ref_in, torch.float32)
        ref_grads = torch.autograd.grad(ref, ref_in, do.float().flatten(2))
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
           else dict(rtol=1e-4, atol=1e-5))
    torch.testing.assert_close(out.float(), ref, **tol)
    for ours, theirs in zip(grads, ref_grads):
        torch.testing.assert_close(ours.float(), theirs, **tol)


def _qkv_do(cuda, B, S, H, seed, fused, dtype=torch.bfloat16):
    """q, k, v, dO [B, S, H, 64] in dtype; fused: q/k/v are strided views of
    one [B, S, 3, H, 64] tensor, as a fused qkv projection gives them."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    if fused:
        x = torch.randn(B, S, 3, H, 64, device=cuda, generator=g).to(dtype)
        q, k, v = x.unbind(2)
        assert q.stride(1) == 3 * H * 64
    else:
        q, k, v = (torch.randn(B, S, H, 64, device=cuda, generator=g)
                   .to(dtype) for _ in range(3))
    return q, k, v, torch.randn(B, S, H, 64, device=cuda,
                                generator=g).to(dtype)


def _gate(got, want, what):
    """chip_smoke.py's bf16 flash gates: elementwise within 2e-2, and the
    relative L2 error within 3.8e-3 (1.5x the worst the mma.sync kernels
    read); the 1e-4 RMS floor covers outputs that are ~0 (dK at S=1)."""
    diff = (got.float() - want).norm()
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2,
                               msg=what)
    assert diff <= 3.8e-3 * want.norm() + 1e-4 * want.numel() ** 0.5, what


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,H", [(1, 1), (32, 12)])   # one head; ~6 waves
@pytest.mark.parametrize("S", [1, 2, 63, 64, 65, 127, 128, 129, 513, 514,
                               683, 751, 1024])
def test_flash_sm90_kernels_match_plain_at_their_interface(cuda, S, B, H,
                                                           fused):
    """The bf16 K4 (O, lse) and K5 (dK, dV) against flash_fwd_plain and
    flash_bwd_dkv_plain in fp32 on the same bf16 inputs; K5 is fed the
    plain lse and di, so it is tested apart from K4."""
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    q, k, v, do = _qkv_do(cuda, B, S, H, S * B, fused)
    counts = (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v)
    with full_fp32():
        ref_o, ref_lse = fa.flash_fwd_plain(q.float(), k.float(), v.float())
        di = (ref_o * do.float()).sum(-1).transpose(1, 2).contiguous()
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, di)
        again = fa.flash_bwd_dkv(q, k, v, do, ref_lse, di)
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q.float(), k.float(),
                                                v.float(), do.float(),
                                                ref_lse, di)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches) == (
        counts[0] + 1, counts[1] + 2)
    assert o.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    _gate(o, ref_o, "K4 O")
    # natural log, as K6 and the backward read it
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    _gate(dk, ref_dk, "K5 dK")
    _gate(dv, ref_dv, "K5 dV")
    # no atomics, no sums across blocks: bit-identical launch to launch
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,H", [(1, 1), (32, 12)])
@pytest.mark.parametrize("S", [1, 2, 63, 64, 65, 127, 128, 129, 513, 514,
                               683, 751, 1024])
def test_flash_sm90_dq_matches_plain_at_its_interface(cuda, S, B, H, fused):
    """The bf16 K6 (dQ) against flash_bwd_dq_plain in fp32 on the same bf16
    inputs, both fed the plain lse and di, so it is tested apart from K4;
    bit-identical launch to launch."""
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    q, k, v, do = _qkv_do(cuda, B, S, H, S * B + 1, fused)
    with full_fp32():
        ref_o, lse = fa.flash_fwd_plain(q.float(), k.float(), v.float())
        di = (ref_o * do.float()).sum(-1).transpose(1, 2).contiguous()
        ref = fa.flash_bwd_dq_plain(q.float(), k.float(), v.float(),
                                    do.float(), lse, di)
    before = fa.flash_bwd_dq.launches
    dq = fa.flash_bwd_dq(q, k, v, do, lse, di)
    again = fa.flash_bwd_dq(q, k, v, do, lse, di)
    assert fa.flash_bwd_dq.launches == before + 2
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    assert dq.is_contiguous()
    _gate(dq, ref, "K6 dQ")
    # no atomics, no sums across blocks: bit-identical launch to launch
    assert torch.equal(dq, again)


def test_flash_sm90_kernels_refuse_what_tma_cannot_read(cuda):
    """TMA needs a 16-byte aligned base and 16-byte strides, and the head
    dim contiguous; dO must be contiguous. The wrappers raise on the rest."""
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _qkv_do(cuda, 2, 70, 3, 0, fused=False)
    wide = torch.zeros(2, 70, 3, 72, device=cuda, dtype=torch.bfloat16)
    bad = {"misaligned": wide[..., 1:65],          # base 2 bytes off
           "sequence stride 220": torch.zeros(
               2, 70, 3 * 72 + 4, device=cuda, dtype=torch.bfloat16)
           [..., :3 * 72].view(2, 70, 3, 72)[..., :64],
           "head dim stride 2": torch.zeros(
               2, 70, 3, 128, device=cuda, dtype=torch.bfloat16)[..., ::2]}
    for name, t in bad.items():
        assert t.shape == q.shape, name
        for args in ((t, k, v), (q, t, v), (q, k, t)):
            with pytest.raises(ValueError):
                fa.flash_fwd(*args)
    o, lse = fa.flash_fwd(q, k, v)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    for args in ((bad["misaligned"], k, v, do, lse, di),
                 (q, k, bad["head dim stride 2"], do, lse, di),
                 (q, k, v, do.transpose(1, 2).contiguous().transpose(1, 2),
                  lse, di),
                 (q, k, v, do, lse.transpose(1, 2).contiguous(), di)):
        for bwd in (fa.flash_bwd_dkv, fa.flash_bwd_dq):
            with pytest.raises(ValueError):
                bwd(*args)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,H", [(1, 1), (32, 12)])
@pytest.mark.parametrize("S", [1, 2, 63, 64, 65, 127, 128, 129, 513, 514,
                               683, 751, 1024])
def test_flash_tf32_kernels_match_plain_at_their_interface(cuda, S, B, H,
                                                           fused):
    """The fp32 K5 (dK, dV) and K6 (dQ), three-term TF32 wgmma products,
    against flash_bwd_dkv_plain and flash_bwd_dq_plain in fp32 (TF32 off),
    all fed the plain lse and di, at the fp32 gates (rtol 1e-4, atol
    1e-5); bit-identical launch to launch."""
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    q, k, v, do = _qkv_do(cuda, B, S, H, S * B + 2, fused, torch.float32)
    with full_fp32():
        o, lse = fa.flash_fwd_plain(q, k, v)
        di = (o * do).sum(-1).transpose(1, 2).contiguous()
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, di)
        ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, di)
    before = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, di)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, di)
    again_dk, again_dv = fa.flash_bwd_dkv(q, k, v, do, lse, di)
    again_dq = fa.flash_bwd_dq(q, k, v, do, lse, di)
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == (
        before[0] + 2, before[1] + 2)
    for got, want, what in ((dk, ref_dk, "K5 dK"), (dv, ref_dv, "K5 dV"),
                            (dq, ref_dq, "K6 dQ")):
        assert got.dtype == torch.float32 and got.is_contiguous()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5,
                                   msg=what)
    # no atomics, no sums across blocks: bit-identical launch to launch
    assert torch.equal(dk, again_dk) and torch.equal(dv, again_dv)
    assert torch.equal(dq, again_dq)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,H", [(1, 1), (32, 12)])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 300, 514, 751, 1024])
def test_flash_tf32_fwd_matches_plain_at_its_interface(cuda, S, B, H, fused):
    """The fp32 K4 (O, lse), three-term TF32 wgmma products, against
    flash_fwd_plain in fp32 (TF32 off) at the fp32 gates (rtol 1e-4, atol
    1e-5; lse within 1e-4); bit-identical launch to launch. fused: q, k, v
    are strided views of one [B, S, 3, H, 64] tensor."""
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    q, k, v, _ = _qkv_do(cuda, B, S, H, S * B + 5, fused, torch.float32)
    with full_fp32():
        ref_o, ref_lse = fa.flash_fwd_plain(q, k, v)
    before = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v)
    again_o, again_lse = fa.flash_fwd(q, k, v)
    assert fa.flash_fwd.launches == before + 2
    assert o.dtype == torch.float32 and o.is_contiguous()
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    torch.testing.assert_close(o, ref_o, rtol=1e-4, atol=1e-5)
    assert float((lse - ref_lse).abs().max()) < 1e-4
    # no atomics, no sums across blocks: bit-identical launch to launch
    assert torch.equal(o, again_o) and torch.equal(lse, again_lse)


def test_flash_tf32_kernels_refuse_what_tma_cannot_read(cuda):
    """The fp32 K4, K5 and K6 read q, k, v (and dO) by TMA: a 16-byte
    aligned base and strides in multiples of 4 elements, the head dim
    contiguous. A view that breaks the rule is refused, not read, by the
    forward as by the backward."""
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _qkv_do(cuda, 2, 70, 3, 1, False, torch.float32)
    wide = torch.randn(2, 70, 3, 72, device=cuda)
    bad = {"misaligned": wide[..., 1:65],          # base 4 bytes off
           "sequence stride 218": torch.randn(
               2, 70, 3 * 72 + 2, device=cuda)[..., :3 * 72]
           .view(2, 70, 3, 72)[..., :64],
           "head dim stride 2": torch.randn(
               2, 70, 3, 128, device=cuda)[..., ::2]}
    o, lse = fa.flash_fwd(q, k, v)
    di = (o * do).sum(-1).transpose(1, 2).contiguous()
    before = fa.flash_fwd.launches
    for name, t in bad.items():
        assert t.shape == q.shape, name
        for args in ((t, k, v), (q, t, v), (q, k, t)):
            with pytest.raises(ValueError):
                fa.flash_fwd(*args)
            for bwd in (fa.flash_bwd_dkv, fa.flash_bwd_dq):
                with pytest.raises(ValueError):
                    bwd(*args, do, lse, di)
    assert fa.flash_fwd.launches == before
    misaligned_do = torch.randn(2 * 70 * 3 * 64 + 1, device=cuda)[1:] \
        .view(2, 70, 3, 64)
    for bwd in (fa.flash_bwd_dkv, fa.flash_bwd_dq):
        with pytest.raises(ValueError):
            bwd(q, k, v, misaligned_do, lse, di)


def test_causal_attention_refuses_a_misaligned_fp32_view_before_its_forward(
        cuda):
    """causal_attention accepts in its forward what its backward reads: a
    misaligned fp32 view is refused before K4 runs, with or without
    autograd, as in bf16 (K4 reads it by TMA too)."""
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    q, k, v, _ = _qkv_do(cuda, 2, 70, 3, 1, False, torch.float32)
    view = torch.randn(2, 70, 3, 72, device=cuda)[..., 1:65]
    assert not fa._aligned(view)
    for i in range(3):
        args = [q, k, v]
        args[i] = view.detach().requires_grad_()
        before = fa.flash_fwd.launches
        with pytest.raises(ValueError, match="16-byte"):
            fa.causal_attention(*args, torch.float32, (0.1, 3, 5))
        with pytest.raises(ValueError, match="16-byte"):
            fa.causal_attention(*(t.detach() for t in args), torch.float32)
        assert fa.flash_fwd.launches == before
    # the same inputs made aligned train through K4, K5 and K6
    ins = [t.detach().contiguous().requires_grad_() for t in (view, k, v)]
    grads = torch.autograd.grad(fa.causal_attention(*ins, torch.float32),
                                ins, torch.ones(2, 70, 3 * 64, device=cuda))
    assert all(torch.isfinite(g).all() for g in grads)


def test_flash_attention_refuses_what_it_does_not_take(cuda):
    from ivideogpt_tpu_torch.ops import flash_attention as fa

    def qkv(S, hd, k_device=cuda):
        q = torch.zeros(1, S, 2, hd, device=cuda, dtype=torch.bfloat16)
        return q, q.to(k_device), q.clone()

    # an odd element offset: the bf16 kernels read rows as 16-byte vectors
    unaligned = torch.zeros(1, 8, 2, 65, device=cuda,
                            dtype=torch.bfloat16)[..., 1:]
    for args in (qkv(8, 32), qkv(1025, 64), qkv(8, 64, k_device="cpu"),
                 (unaligned,) * 3):
        with pytest.raises(ValueError):
            fa.causal_attention(*args, torch.bfloat16)
