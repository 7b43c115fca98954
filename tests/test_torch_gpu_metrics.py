"""The generation evaluation's metric models on the card against the CPU
port, float32 with TF32 off:

- I3D logits (random He-normal weights, BN statistics away from their
  init) on clips resized 64 -> 224 and 256 -> 224;
- ``best_of_t_metrics`` with LPIPS, the full result;
- I3D fed in chunks uses less peak memory than one call over the same
  clips, and gives the same features.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips when there is none. Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_metrics.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _i3d(seed=0):
    from ivideogpt_tpu_torch.models.i3d import I3D
    model = I3D()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("conv3d.weight"):
                v.copy_(torch.randn(v.shape, generator=g)
                        * (2 / v[0].numel()) ** 0.5)
            elif k.endswith(("running_var", "bn.weight")):
                v.copy_(torch.rand(v.shape, generator=g) + 0.5)
            elif v.is_floating_point():
                v.copy_(torch.randn(v.shape, generator=g) * 0.1)
    return model.eval()


@pytest.mark.parametrize("size", [64, 256])
def test_i3d_on_the_card_matches_the_cpu(cuda, size):
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    model = _i3d()
    x = torch.rand(2, 8, size, size, 3,
                   generator=torch.Generator().manual_seed(size))
    with torch.no_grad(), full_fp32():
        want = model(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
    # float32 convs summed in cuDNN's order through 20 layers
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


def test_best_of_t_on_the_card_matches_the_cpu(cuda):
    from ivideogpt_tpu_torch.models.lpips import LPIPS
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    from ivideogpt_tpu_torch.utils.video_metric import best_of_t_metrics
    torch.manual_seed(0)
    lpips = LPIPS().eval()
    g = torch.Generator().manual_seed(1)
    gt = torch.rand(4, 6, 64, 64, 3, generator=g)
    noise = torch.randn(3, 4, 6, 64, 64, 3, generator=g)
    scale = torch.rand(3, 4, 1, 1, 1, 1, generator=g) * 0.3
    gen = (gt[None] + scale * noise).clamp(0, 1).reshape(12, 6, 64, 64, 3)
    with torch.no_grad(), full_fp32():
        want = best_of_t_metrics(gt, gen, lpips)
        lp = lpips.to(cuda)
        got = best_of_t_metrics(gt.to(cuda), gen.to(cuda), lp)
    assert sorted(got) == ["lpips", "mse", "psnr", "ssim"]
    tol = {"mse": 1e-7, "psnr": 1e-4, "ssim": 1e-5, "lpips": 1e-5}
    for k, v in got.items():
        assert v.device.type == "cuda"
        assert abs(float(v) - float(want[k])) <= tol[k], (k, float(v),
                                                          float(want[k]))


def test_chunked_i3d_uses_less_memory_and_equals_one_call(cuda):
    from ivideogpt_tpu_torch.utils.video_metric import Evaluator
    model = _i3d().to(cuda)
    clips = torch.rand(16, 16, 64, 64, 3, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(2))
    peaks, feats = {}, {}
    with torch.no_grad():
        for n in (16, 4):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            feats[n] = Evaluator(i3d_fn=model,
                                 max_batchsize=n).i3d_features(clips)
            peaks[n] = torch.cuda.max_memory_allocated() - base
    assert peaks[4] < 0.5 * peaks[16], peaks
    np.testing.assert_allclose(feats[4], feats[16], rtol=1e-4,
                               atol=1e-5 * np.abs(feats[16]).max())
