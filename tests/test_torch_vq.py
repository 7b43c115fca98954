"""VQ lookup of the PyTorch port: the plain version of kernel K1 against the
JAX package's Pallas kernel (interpret mode) and its XLA oracle."""

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
