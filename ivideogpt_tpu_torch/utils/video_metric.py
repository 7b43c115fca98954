"""Video evaluation metrics, the port of ``ivideogpt_tpu/utils/video_metric.py``:
MSE / PSNR / SSIM / LPIPS with best-of-t selection, streaming feature
statistics and the Frechet distance of FVD.

Inputs are NHWC videos in [0, 1]: video shape [B, T, H, W, C]. The frame
metrics run in float32 on the inputs' device, TF32 off.

Differences from the JAX module, each on purpose:

- ``best_of_t_metrics`` computes the [t, B] per-sample metrics one sample
  set at a time and reduces them, where the JAX function tiles the ground
  truth t times (6.3 GB at t=100, B=80, 16 frames of 64 px, and as much
  again for the generated clips). The result is the same.
- ``frechet_distance`` takes tr sqrt(S_g S_r) from the eigenvalues of
  S_r^1/2 S_g S_r^1/2 in float64 (numpy), clamped at 0, not from
  ``scipy.linalg.sqrtm`` (the card's machine has no scipy). The two agree
  to ~1e-12 of the distance on full-rank covariances; with fewer clips
  than features the covariances are singular, scipy's Schur root of the
  singular product loses digits, and they agree to ~1e-7.
- ``Evaluator.i3d_features`` feeds the I3D ``max_batchsize`` clips at a
  time (the JAX ``train_gpt.evaluate`` passes all t*B clips at once).
  A clip's features do not depend on the chunk.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ivideogpt_tpu_torch.utils.platform import full_fp32


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-frame MSE: [N, H, W, C] -> [N]."""
    return (a - b).square().mean(dim=(1, 2, 3))


def psnr(a: torch.Tensor, b: torch.Tensor, value_range: float = 1.0,
         eps: float = 1e-8) -> torch.Tensor:
    """Per-frame PSNR (piqa semantics)."""
    return 10.0 * torch.log10(value_range ** 2 / (mse(a, b) + eps))


def _gaussian_kernel(window: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(window, dtype=torch.float32, device=device) \
        - (window - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def ssim(a: torch.Tensor, b: torch.Tensor, window: int = 11,
         sigma: float = 1.5, value_range: float = 1.0) -> torch.Tensor:
    """Per-frame SSIM: [N, H, W, C] -> [N], a separable Gaussian window
    with VALID padding, averaged over channels (piqa SSIM(window_size=11,
    sigma=1.5))."""
    c1 = (0.01 * value_range) ** 2
    c2 = (0.03 * value_range) ** 2
    k = _gaussian_kernel(window, sigma, a.device)
    kh, kw = k.view(1, 1, window, 1), k.view(1, 1, 1, window)

    def blur(x):
        n, h, w, c = x.shape
        x = x.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
        x = F.conv2d(F.conv2d(x, kh), kw)
        return x.reshape(n, c, x.shape[-2], x.shape[-1])

    with full_fp32():
        mu_a, mu_b = blur(a), blur(b)
        saa = blur(a * a) - mu_a * mu_a
        sbb = blur(b * b) - mu_b * mu_b
        sab = blur(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * sab + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (saa + sbb + c2)
    return (num / den).mean(dim=(1, 2, 3))


def best_of_t_metrics(gt: torch.Tensor, gen: torch.Tensor,
                      lpips_fn: Optional[Callable] = None
                      ) -> Dict[str, torch.Tensor]:
    """Best-of-t frame metrics.

    gt: [B, T, H, W, C]; gen: [t*B, T, H, W, C], sample set r at rows
    r*B .. r*B + B - 1. Returns 0-d tensors: the best (min) MSE and LPIPS
    and the best (max) PSNR and SSIM over the t samples of a clip, each a
    mean over the clip's frames, averaged over clips. ``lpips_fn`` takes
    two NHWC frame batches in [-1, 1] and returns [N]."""
    B, T = gt.shape[:2]
    t = gen.shape[0] // B
    frames = gt.reshape(B * T, *gt.shape[2:])
    per = {"mse": [], "psnr": [], "ssim": []}
    if lpips_fn is not None:
        per["lpips"] = []
    for r in range(t):
        x = gen[r * B:(r + 1) * B].reshape(B * T, *gen.shape[2:])
        per["mse"].append(mse(frames, x))
        per["psnr"].append(psnr(frames, x))
        per["ssim"].append(ssim(frames, x))
        if lpips_fn is not None:
            per["lpips"].append(lpips_fn(frames * 2 - 1, x * 2 - 1))
    out = {}
    for k, v in per.items():
        v = torch.stack(v).reshape(t, B, T).mean(-1)
        best = v.min(0).values if k in ("mse", "lpips") else v.max(0).values
        out[k] = best.mean()
    return out


class FeatureStats:
    """Streaming mean / covariance accumulator in float64 on the host."""

    def __init__(self, max_items: Optional[int] = None):
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.raw_mean = None
        self.raw_cov = None

    def _init(self, n_features: int):
        self.num_features = n_features
        self.raw_mean = np.zeros(n_features, np.float64)
        self.raw_cov = np.zeros((n_features, n_features), np.float64)

    def append(self, x: np.ndarray):
        x = np.asarray(x, np.float32)
        if x.ndim != 2:
            raise ValueError(f"features must be [N, D], got {x.shape}")
        if self.max_items is not None:
            if self.num_items >= self.max_items:
                return
            x = x[: self.max_items - self.num_items]
        if self.num_features is None:
            self._init(x.shape[1])
        self.num_items += x.shape[0]
        x64 = x.astype(np.float64)
        self.raw_mean += x64.sum(axis=0)
        self.raw_cov += x64.T @ x64

    def get_mean_cov(self):
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov


def _psd_sqrt(sigma: np.ndarray) -> np.ndarray:
    w, v = np.linalg.eigh((sigma + sigma.T) / 2)
    return (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T


def frechet_distance(stats_real: FeatureStats,
                     stats_gen: FeatureStats) -> float:
    """||mu_g - mu_r||^2 + tr(S_g + S_r - 2 sqrt(S_g S_r)), the trace of the
    root from the eigenvalues of S_r^1/2 S_g S_r^1/2 (those of S_g S_r)."""
    if stats_real.num_items == 0 or stats_gen.num_items == 0:
        raise ValueError("No data to compute FVD")
    mu_r, sig_r = stats_real.get_mean_cov()
    mu_g, sig_g = stats_gen.get_mean_cov()
    root_r = _psd_sqrt(sig_r)
    m = root_r @ sig_g @ root_r
    eig = np.linalg.eigvalsh((m + m.T) / 2)
    tr_root = np.sqrt(np.clip(eig, 0.0, None)).sum()
    return float(np.square(mu_g - mu_r).sum()
                 + np.trace(sig_g) + np.trace(sig_r) - 2 * tr_root)


class Evaluator:
    """Frame metrics and I3D features for the generation evaluation.

    ``lpips_fn`` (two NHWC batches in [-1, 1] -> [N]) and ``i3d_fn`` (clips
    [N, T, H, W, 3] in [0, 1] -> [N, 400]) are device callables, either may
    be None; both run with TF32 off, ``max_batchsize`` clips through
    ``i3d_fn`` at a time."""

    def __init__(self, lpips_fn: Optional[Callable] = None,
                 i3d_fn: Optional[Callable] = None, max_batchsize: int = 64):
        self.lpips_fn = lpips_fn
        self.i3d_fn = i3d_fn
        self.max_batchsize = max_batchsize

    def frame_metrics(self, gt: torch.Tensor, gen: torch.Tensor
                      ) -> Dict[str, float]:
        with full_fp32():
            m = best_of_t_metrics(gt, gen, self.lpips_fn)
        return {k: float(v) for k, v in m.items()}

    def i3d_features(self, videos: torch.Tensor) -> np.ndarray:
        """videos [N, T, H, W, C] in [0, 1] -> [N, 400] float32 features,
        ``max_batchsize`` clips a call."""
        if self.i3d_fn is None:
            raise ValueError("no I3D model available")
        n = self.max_batchsize
        with full_fp32():
            feats = [self.i3d_fn(videos[i:i + n])
                     for i in range(0, videos.shape[0], n)]
        return torch.cat(feats).float().cpu().numpy()
