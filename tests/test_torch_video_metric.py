"""The port's video metrics (``ivideogpt_tpu_torch/utils/video_metric.py``)
against ``ivideogpt_tpu/utils/video_metric.py`` on the CPU, the same numpy
inputs through both:

- per-frame MSE, PSNR and SSIM;
- ``best_of_t_metrics``, the port's one-sample-set-at-a-time reduction
  against the JAX function's all-at-once tiling, with and without LPIPS
  (the JAX LPIPS' weights carried across by ``lpips_state_dict``);
- ``FeatureStats`` with ``max_items``;
- ``frechet_distance`` (eigenvalues in numpy) against the JAX one
  (``scipy.linalg.sqrtm``) at full and at deficient rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu.models.lpips import LPIPS as JaxLPIPS
from ivideogpt_tpu.utils import video_metric as jvm
from ivideogpt_tpu_torch.models.lpips import LPIPS
from ivideogpt_tpu_torch.utils import checkpoint as ckpt
from ivideogpt_tpu_torch.utils import video_metric as vm


def _clips(seed, b, t, h=32, reps=0):
    """gt [b, t, h, h, 3] in [0, 1] and, with reps, gen [reps*b, ...]: gt
    plus noise of a different size in every sample set."""
    rng = np.random.default_rng(seed)
    gt = rng.random((b, t, h, h, 3)).astype(np.float32)
    if not reps:
        return gt
    noise = rng.normal(size=(reps, b, t, h, h, 3)).astype(np.float32)
    scale = rng.uniform(0.02, 0.3, (reps, b, 1, 1, 1, 1)).astype(np.float32)
    gen = np.clip(gt[None] + scale * noise, 0, 1).reshape(reps * b, t, h, h, 3)
    return gt, gen


def test_frame_metrics_match_jax():
    gt, gen = _clips(0, 6, 1, h=40, reps=1)
    a, b = gt[:, 0], gen[:, 0]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    # float32 sums in another order: a few ulp of each per-frame value
    np.testing.assert_allclose(vm.mse(ta, tb).numpy(),
                               np.asarray(jvm.mse(ja, jb)), rtol=1e-5)
    np.testing.assert_allclose(vm.psnr(ta, tb).numpy(),
                               np.asarray(jvm.psnr(ja, jb)), atol=1e-4)
    np.testing.assert_allclose(vm.ssim(ta, tb).numpy(),
                               np.asarray(jvm.ssim(ja, jb)), atol=1e-5)
    # identical frames: SSIM 1, PSNR at the eps floor
    np.testing.assert_allclose(vm.ssim(ta, ta).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(vm.psnr(ta, ta).numpy(), 80.0, atol=1e-4)


@pytest.fixture(scope="module")
def lpips_pair():
    """(JAX LPIPS apply, the port's LPIPS) with the same random weights."""
    jl = JaxLPIPS()
    x = jnp.zeros((1, 32, 32, 3))
    params = jax.jit(jl.init)(jax.random.key(3), x, x)
    params = jax.tree_util.tree_map(np.asarray, params)
    # heads away from their init of ones, so that their mapping counts
    rng = np.random.default_rng(4)
    for name in [k for k in params["params"] if k.startswith("lin")]:
        params["params"][name] = rng.uniform(
            0.1, 1.0, params["params"][name].shape).astype(np.float32)
    port = LPIPS()
    port.load_state_dict(ckpt.lpips_state_dict(params), strict=True)
    return jax.jit(lambda a, b: jl.apply(params, a, b)), port.eval()


@pytest.mark.parametrize("with_lpips", [False, True])
def test_best_of_t_streamed_equals_jax_all_at_once(lpips_pair, with_lpips):
    B, T, reps = 3, 2, 4
    gt, gen = _clips(1, B, T, reps=reps)
    jfn, port = lpips_pair if with_lpips else (None, None)
    want = jvm.best_of_t_metrics(jnp.asarray(gt), jnp.asarray(gen), jfn)
    with torch.no_grad():
        got = vm.best_of_t_metrics(torch.from_numpy(gt),
                                   torch.from_numpy(gen), port)
    assert sorted(got) == sorted(want) == (
        ["lpips", "mse", "psnr", "ssim"] if with_lpips
        else ["mse", "psnr", "ssim"])
    # the same per-frame values reduced alike: each within the per-frame
    # tolerances of test_frame_metrics_match_jax; LPIPS sums five VGG
    # taps of float32 convs (1e-5 of its value)
    tol = {"mse": 1e-7, "psnr": 1e-4, "ssim": 1e-5, "lpips": 1e-5}
    for k, v in got.items():
        assert v.shape == () and v.dtype == torch.float32
        np.testing.assert_allclose(float(v), float(want[k]), atol=tol[k],
                                   err_msg=k)
    # the best sample is not always the first: the reduction is exercised
    per = np.stack([jvm.mse(jnp.asarray(gt.reshape(-1, 32, 32, 3)),
                            jnp.asarray(gen[r * B:(r + 1) * B]
                                        .reshape(-1, 32, 32, 3)))
                    for r in range(reps)]).reshape(reps, B, T).mean(-1)
    assert len(set(per.argmin(0))) > 1
    ev = vm.Evaluator(lpips_fn=port)
    with torch.no_grad():
        floats = ev.frame_metrics(torch.from_numpy(gt), torch.from_numpy(gen))
    assert floats == {k: float(v) for k, v in got.items()}


def test_feature_stats_with_max_items_match_jax():
    rng = np.random.default_rng(5)
    chunks = [rng.normal(size=(n, 16)).astype(np.float32)
              for n in (4, 7, 3, 5)]
    for max_items in (None, 9, 11, 100):
        j, t = jvm.FeatureStats(max_items=max_items), \
            vm.FeatureStats(max_items=max_items)
        for c in chunks:
            j.append(c)
            t.append(c)
        assert t.num_items == j.num_items == min(19, max_items or 19)
        for x, y in zip(t.get_mean_cov(), j.get_mean_cov()):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        vm.FeatureStats().append(np.zeros(3))


def _stats(x):
    s = vm.FeatureStats()
    s.append(x)
    j = jvm.FeatureStats()
    j.append(x)
    return s, j


@pytest.mark.parametrize("n_real,n_gen", [(1200, 900), (6, 14)],
                         ids=["full_rank", "deficient_rank"])
def test_frechet_distance_matches_scipy(n_real, n_gen):
    """400-d features, as I3D's: full rank with more clips than features,
    rank n - 1 with fewer (every smoke run, any small split). At full rank
    both square roots are accurate: 1e-9 of the distance. At deficient
    rank the product S_g S_r is singular and scipy's Schur ``sqrtm`` loses
    accuracy in the null space: 1e-6. The distance of a set to itself
    is 0 within the eigenvalue floor, 2 d sqrt(d eps) max eig(S)."""
    rng = np.random.default_rng(6)
    d = 400
    mix = rng.normal(size=(d, d)) / np.sqrt(d)
    real = (rng.normal(size=(n_real, d)) @ mix).astype(np.float32)
    gen = (rng.normal(size=(n_gen, d)) @ mix * 1.2 + 0.05).astype(np.float32)
    (tr, jr), (tg, jg) = _stats(real), _stats(gen)
    want = jvm.frechet_distance(jr, jg)
    got = vm.frechet_distance(tr, tg)
    rtol = 1e-9 if n_real > d else 1e-6
    np.testing.assert_allclose(got, want, rtol=rtol)
    floor = 2 * d * np.sqrt(d * np.finfo(np.float64).eps) * np.linalg.eigvalsh(
        tr.get_mean_cov()[1]).max()
    assert abs(vm.frechet_distance(tr, tr)) <= floor
    with pytest.raises(ValueError, match="No data"):
        vm.frechet_distance(vm.FeatureStats(), tg)
