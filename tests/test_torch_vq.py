"""VQ of the PyTorch port: the plain version of kernels K1 and K2 against the
JAX package's Pallas kernel (interpret mode) and its XLA oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu.ops.vq import _vq_lookup_pallas_flash, _vq_lookup_xla
from ivideogpt_tpu_torch.ops import vq as tvq


def _jax_ids(z, e):
    zj, ej = jnp.asarray(z), jnp.asarray(e)
    return (np.asarray(_vq_lookup_pallas_flash(zj, ej, interpret=True)),
            np.asarray(_vq_lookup_xla(zj, ej)))


def _dist64(z, e, ids):
    z = z.astype(np.float64)
    e = e.astype(np.float64)
    return ((z - e[ids]) ** 2).sum(1)


@pytest.mark.parametrize("n,k,d", [(300, 64, 8), (257, 200, 64)])
def test_small_integer_inputs_exact_with_duplicate_rows(n, k, d):
    rng = np.random.default_rng(n)
    e = rng.integers(-3, 4, (k, d)).astype(np.float32)
    e[k // 2:k // 2 + 5] = e[3]          # duplicated rows: ties go to index 3
    z = rng.integers(-3, 4, (n, d)).astype(np.float32)
    z[:7] = e[3]
    ours = tvq.vq_argmin(torch.from_numpy(z), torch.from_numpy(e)).numpy()
    pallas, xla = _jax_ids(z, e)
    np.testing.assert_array_equal(ours, xla)
    np.testing.assert_array_equal(ours, pallas)
    assert (ours[:7] == 3).all()


def test_random_normal_inputs_agree_but_for_near_ties():
    rng = np.random.default_rng(7)
    n, k, d = 1024, 512, 64
    z = rng.normal(size=(n, d)).astype(np.float32)
    e = rng.normal(size=(k, d)).astype(np.float32)
    ours = tvq.vq_lookup_plain(torch.from_numpy(z), torch.from_numpy(e)).numpy()
    for ref in _jax_ids(z, e):
        diff = np.nonzero(ours != ref)[0]
        # a pick may differ only where the two candidates' exact distances
        # are within fp32 rounding of each other
        gap = np.abs(_dist64(z[diff], e, ours[diff])
                     - _dist64(z[diff], e, ref[diff]))
        scale = (z[diff].astype(np.float64) ** 2).sum(1) \
            + (e[ours[diff]].astype(np.float64) ** 2).sum(1)
        assert (gap < 1e-5 * scale).all(), (diff, gap, scale)
        assert len(diff) <= n // 100


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.normal(size=(2, 5, 16)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(40, 16)).astype(np.float32))
    before = tvq.vq_argmin.launches
    ids = tvq.vq_lookup(z, e)
    assert ids.shape == (2, 5) and ids.dtype == torch.int64
    np.testing.assert_array_equal(
        ids.reshape(-1).numpy(), tvq.vq_lookup_plain(z.reshape(-1, 16), e).numpy())
    assert tvq.vq_argmin.launches == before


# ----------------------------------------------------------------------
# K2's plain version against the tiled TPU kernel, the routing, quantize

def _tiled_ids(z, e):
    from ivideogpt_tpu.ops.vq import _vq_lookup_pallas
    return np.asarray(_vq_lookup_pallas(jnp.asarray(z), jnp.asarray(e),
                                        interpret=True))


def test_plain_version_matches_the_tiled_kernel_exactly_on_integers():
    """K=2500 spans two of the TPU kernel's 2048-code tiles; D=72 is none of
    K1's widths. Small integers make every distance exact, ties included."""
    rng = np.random.default_rng(11)
    n, k, d = 300, 2500, 72
    e = rng.integers(-3, 4, (k, d)).astype(np.float32)
    e[2047:2047 + 3] = e[5]        # copies on both sides of the tile edge
    z = rng.integers(-3, 4, (n, d)).astype(np.float32)
    z[:4] = e[5]
    ours = tvq.vq_argmin_tiled(torch.from_numpy(z), torch.from_numpy(e))
    np.testing.assert_array_equal(ours.numpy(), _tiled_ids(z, e))
    assert (ours[:4] == 5).all()


def test_plain_version_matches_the_tiled_kernel_but_for_near_ties():
    rng = np.random.default_rng(12)
    n, k, d = 300, 2500, 72
    z = rng.normal(size=(n, d)).astype(np.float32)
    e = rng.normal(size=(k, d)).astype(np.float32)
    ours = tvq.vq_lookup_plain(torch.from_numpy(z), torch.from_numpy(e)).numpy()
    ref = _tiled_ids(z, e)
    diff = np.nonzero(ours != ref)[0]
    # fp32 distances summed in another order: a pick may differ only where
    # the two candidates' exact distances are within rounding
    gap = np.abs(_dist64(z[diff], e, ours[diff]) - _dist64(z[diff], e,
                                                            ref[diff]))
    scale = (z[diff].astype(np.float64) ** 2).sum(1) \
        + (e[ours[diff]].astype(np.float64) ** 2).sum(1)
    assert (gap < 1e-5 * scale).all(), (diff, gap, scale)
    assert len(diff) <= n // 100


@pytest.mark.parametrize("d", [4, 8, 16, 32, 64, 72, 128, 129, 256])
def test_routing_follows_the_jax_packages_rule(monkeypatch, d):
    """The port's rule, measured on the card: K1 for D in {8, 16, 32, 64}
    whatever K, K2 for every other D. The JAX package routes by its VMEM
    limit instead (its flash kernel for padded codebooks of at most 6 MB,
    vq.py:274): wherever it takes its flash kernel at a width K1 takes, the
    published 8192 x 64 codebooks among them, the port takes K1, and
    wherever it takes its tiled kernel at a width K1 does not take, the
    port takes K2. K1 and K2 give the same ids wherever both run."""
    import ivideogpt_tpu.ops.vq as jvq
    taken = []
    monkeypatch.setattr(jvq, "_vq_lookup_pallas_flash",
                        lambda z, e: taken.append("flash") or z[:, 0])
    monkeypatch.setattr(jvq, "_vq_lookup_pallas",
                        lambda z, e: taken.append("tiled") or z[:, 0])
    routed = []
    monkeypatch.setattr(tvq, "vq_argmin",
                        lambda z, e: routed.append("k1") or z[:, 0].long())
    monkeypatch.setattr(tvq, "vq_argmin_tiled",
                        lambda z, e: routed.append("k2") or z[:, 0].long())
    k1_width = d in (8, 16, 32, 64)
    jax_flash = {}
    for k in (1, 7, 2048, 8192, 12288, 12289, 16384, 32768, 65536):
        taken.clear()
        routed.clear()
        jvq._vq_lookup_nondiff(jnp.zeros((3, d)), jnp.zeros((k, d)), True)
        jax_flash[k] = taken == ["flash"]
        tvq.vq_lookup(torch.zeros(1, 3, d), torch.zeros(k, d))
        assert routed == ["k1" if k1_width else "k2"], (k, d, routed)
        assert tvq.uses_k1(d) == k1_width
        if jax_flash[k] and k1_width:
            assert routed == ["k1"], (k, d, taken, routed)
        if taken == ["tiled"] and not k1_width:
            assert routed == ["k2"], (k, d, taken, routed)
    # the published tokenizers' 8192 x 64 codebooks: the JAX package's
    # flash kernel and K1; the wide 16384 x 256 ones go to K2
    if d == 64:
        assert jax_flash[8192] and tvq.uses_k1(64)
    assert not tvq.uses_k1(256)


@pytest.mark.parametrize("n,k,d", [(8192, 16384, 256), (1536, 16384, 256),
                                   (131072, 8192, 64), (1, 1, 1), (65, 7, 3),
                                   (1000, 300, 512)])
def test_k2_splits_cover_the_codebook_and_fill_the_card(n, k, d):
    """K2's plan: vq_splits at one CTA an SM with one stage of fixed cost."""
    splits, per = tvq.vq_splits(n, k, 132, tvq.k2_fixed(d))
    assert per % tvq.VQ_CODES == 0
    assert (splits - 1) * per < k <= splits * per     # none empty
    row_tiles = -(-n // tvq.VQ_ROWS)
    tiles = -(-k // tvq.VQ_CODES)
    # at least 2 CTAs an SM, unless every split is already one tile
    assert row_tiles * splits >= 2 * 132 or splits == tiles
    # the wide lookups: 8 and 22 splits, 4 and 2 waves of one CTA an SM
    want = {8192: 8, 1536: 22, 131072: 1}
    if n in want:
        assert splits == want[n]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("k", [1, 63, 64, 8192])
@pytest.mark.parametrize("n", [1, 127, 1536, 3584, 8192, 131072])
def test_k1_splits_cover_the_codebook_and_fill_the_card(n, k, sms):
    splits, per = tvq.vq_splits(n, k, sms, tvq.K1_FIXED_TILES)
    assert per % tvq.VQ_CODES == 0
    # every code in exactly one split, none empty
    assert (splits - 1) * per < k <= splits * per
    row_tiles = -(-n // tvq.VQ_ROWS)
    chunks = -(-k // tvq.VQ_CODES)
    # at least 2 CTAs an SM, unless every split is already one chunk
    assert tvq.VQ_MIN_CTAS_PER_SM == 2
    assert (row_tiles * splits >= tvq.VQ_MIN_CTAS_PER_SM * sms
            or splits == chunks)
    if n == 131072 and sms == 132:
        assert splits == 1          # the rollout's lookup needs no split


def _split_then_combine(z, e, splits, per):
    """K1's two passes in plain torch: each split's first-index argmin and
    its distance, then the lexicographic (dist, idx) minimum over splits."""
    zt, et = torch.from_numpy(z), torch.from_numpy(e)
    dist = (et * et).sum(1)[None, :] - 2.0 * (zt @ et.t())
    best_d = torch.full((z.shape[0],), float("inf"))
    best_i = torch.full((z.shape[0],), np.iinfo(np.int32).max)
    for s in range(splits):
        part = dist[:, s * per:(s + 1) * per]
        i = part.argmin(1)
        d = part.gather(1, i[:, None])[:, 0]
        i = i + s * per
        better = (d < best_d) | ((d == best_d) & (i < best_i))
        best_d = torch.where(better, d, best_d)
        best_i = torch.where(better, i, best_i)
    return best_i.numpy()


@pytest.mark.parametrize("n,k,d,sms", [(300, 2000, 8, 132),
                                       (1536, 8192, 16, 114)])
def test_k1_split_then_combine_is_the_lookup(n, k, d, sms):
    """At the split plan's boundaries, with exact ties planted across each,
    combining per-split argmins gives the plain lookup's ids and the TPU
    flash kernel's (interpret mode): ties go to the smallest index across
    splits too. Small integers make every distance exact."""
    splits, per = tvq.vq_splits(n, k, sms, tvq.K1_FIXED_TILES)
    assert splits > 1
    rng = np.random.default_rng(n + k)
    e = rng.integers(-3, 4, (k, d)).astype(np.float32)
    z = rng.integers(-3, 4, (n, d)).astype(np.float32)
    planted = {}
    for s in range(1, splits):
        c = s - 1                                  # a code of split 0
        e[s * per - 1] = e[s * per] = e[c]         # copies on both sides
        z[s] = e[c]
        planted[s] = np.flatnonzero((e == e[c]).all(1))[0]
    ours = _split_then_combine(z, e, splits, per)
    np.testing.assert_array_equal(
        ours, tvq.vq_lookup_plain(torch.from_numpy(z),
                                  torch.from_numpy(e)).numpy())
    np.testing.assert_array_equal(ours, _jax_ids(z, e)[0])
    for row, first in planted.items():
        assert ours[row] == first <= row - 1


@pytest.mark.parametrize("n,k,d,sms", [(300, 2500, 72, 132),
                                       (200, 1000, 5, 114)])
def test_k2_split_then_combine_is_the_lookup(n, k, d, sms):
    """K2's plan, split then combined as the combine kernel does, with exact
    ties planted across every boundary: the plain lookup's ids and the TPU
    tiled kernel's (interpret mode), ties to the smallest index."""
    splits, per = tvq.vq_splits(n, k, sms, tvq.k2_fixed(d))
    assert splits > 1
    rng = np.random.default_rng(n + k + d)
    e = rng.integers(-3, 4, (k, d)).astype(np.float32)
    z = rng.integers(-3, 4, (n, d)).astype(np.float32)
    planted = {}
    for s in range(1, splits):
        c = s - 1                                  # a code of split 0
        e[s * per - 1] = e[s * per] = e[c]         # copies on both sides
        z[s] = e[c]
        planted[s] = np.flatnonzero((e == e[c]).all(1))[0]
    ours = _split_then_combine(z, e, splits, per)
    np.testing.assert_array_equal(
        ours, tvq.vq_lookup_plain(torch.from_numpy(z),
                                  torch.from_numpy(e)).numpy())
    np.testing.assert_array_equal(ours, _tiled_ids(z, e))
    for row, first in planted.items():
        assert ours[row] == first <= row - 1


@pytest.mark.parametrize("shape,k", [((2, 5, 16), 40), ((37, 72), 300)])
def test_quantize_matches_jax(shape, k):
    """Ids, the straight-through output, the commit loss, and the gradients
    to z and to the codebook of a loss on the output plus the commit."""
    from ivideogpt_tpu.ops.vq import quantize as jquantize
    rng = np.random.default_rng(k)
    z = rng.normal(size=shape).astype(np.float32)
    e = rng.normal(size=(k, shape[-1])).astype(np.float32)
    w = rng.normal(size=shape).astype(np.float32)

    def jloss(z, e):
        q = jquantize(z, e, use_pallas=False)
        return jnp.sum(q.quantized * w) + 3.0 * q.commit_loss, q
    (jl, jq), (jgz, jge) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jnp.asarray(z), jnp.asarray(e))
    zt = torch.from_numpy(z).requires_grad_()
    et = torch.from_numpy(e).requires_grad_()
    q = tvq.quantize(zt, et)
    loss = (q.quantized * torch.from_numpy(w)).sum() + 3.0 * q.commit_loss
    loss.backward()
    np.testing.assert_array_equal(q.indices.numpy(), np.asarray(jq.indices))
    assert q.indices.shape == shape[:-1] and q.quantized.dtype == zt.dtype
    # fp32: the same elementwise ops, means summed in another order
    for ours, theirs in ((q.quantized, jq.quantized),
                         (q.commit_loss, jq.commit_loss), (loss, jl),
                         (zt.grad, jgz), (et.grad, jge)):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                                   rtol=1e-5, atol=1e-6)
    # the codebook gets its gradient through the gather only: unused rows 0
    unused = np.setdiff1d(np.arange(k), q.indices.numpy())
    assert (et.grad.numpy()[unused] == 0).all()
