"""LPIPS perceptual distance on a VGG16 backbone, the port of
``ivideogpt_tpu/models/lpips.py``: five VGG16 taps (after relu1_2, relu2_2,
relu3_3, relu4_3, relu5_3, with 2x2 max-pools between the slices) ->
channel unit-normalisation (eps 1e-10) -> squared difference weighted by
``|lin{s}|`` -> spatial mean -> sum over the taps.

Inputs are NHWC images in [-1, 1], as in the JAX package; the convs run
NCHW inside. Weights are random (``lin{s}`` initialised to ones) until
:func:`load_torch_lpips` reads torchvision's VGG16 (and optionally the
LPIPS heads) from ``.pth`` files. Parameter names follow the Flax tree
(``vgg.conv0_0``, ``lin0``), see ``utils.checkpoint.lpips_state_dict``.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ivideogpt_tpu_torch.models.layers import Conv

VGG_SLICES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
IMAGENET_SHIFT = (-0.030, -0.088, -0.188)
IMAGENET_SCALE = (0.458, 0.448, 0.450)


class VGGFeatures(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        in_ch = 3
        for s, (ch, n_convs) in enumerate(VGG_SLICES):
            for i in range(n_convs):
                self.add_module(f"conv{s}_{i}",
                                Conv(in_ch, ch, 3, padding=1, dtype=dtype))
                in_ch = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for s, (_, n_convs) in enumerate(VGG_SLICES):
            for i in range(n_convs):
                x = F.relu(getattr(self, f"conv{s}_{i}")(x))
            taps.append(x)
            if s < len(VGG_SLICES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt((x * x).sum(1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """forward(a, b) -> [B] per-sample distance, in the compute dtype."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.vgg = VGGFeatures(dtype)
        for s, (ch, _) in enumerate(VGG_SLICES):
            self.register_parameter(f"lin{s}", nn.Parameter(torch.ones(ch)))
        # the constants in the compute dtype, as jnp.asarray(..., dtype)
        self.register_buffer("shift", torch.tensor(IMAGENET_SHIFT).to(dtype),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(IMAGENET_SCALE).to(dtype),
                             persistent=False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa, fb = (self.vgg(((x - self.shift) / self.scale).permute(0, 3, 1, 2))
                  for x in (a, b))
        total = 0.0
        for s, (xa, xb) in enumerate(zip(fa, fb)):
            d = (_unit_normalize(xa) - _unit_normalize(xb)) ** 2
            w = getattr(self, f"lin{s}").abs().to(d.dtype)
            d = (d * w[None, :, None, None]).sum(1)
            total = total + d.mean(dim=(1, 2))
        return total


# torchvision's vgg16().features indices of the 13 convs, in order
VGG_FEATURE_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _load_pth(path: str) -> dict:
    if not os.path.exists(path):
        raise FileNotFoundError(f"LPIPS weights: {path} does not exist")
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def load_torch_lpips(model: LPIPS, vgg_path: Optional[str],
                     lin_path: Optional[str] = None) -> bool:
    """Copy torchvision's VGG16 ``features.{0,2,5,...,28}`` from the state
    dict at ``vgg_path`` onto the five taps' convs, and the LPIPS heads'
    ``lin{s}.model.1.weight`` from ``lin_path`` where one is given, in
    place (``ivideogpt_tpu/models/lpips.py:75``). Returns False, changing
    nothing, when ``vgg_path`` is None; raises when a named file does not
    exist, where the JAX loader silently keeps the random weights."""
    if vgg_path is None:
        return False
    sd = _load_pth(vgg_path)
    names = [f"conv{s}_{i}" for s, (_, n) in enumerate(VGG_SLICES)
             for i in range(n)]
    for name, idx in zip(names, VGG_FEATURE_CONVS):
        conv = getattr(model.vgg, name)
        conv.weight.copy_(sd[f"features.{idx}.weight"])
        conv.bias.copy_(sd[f"features.{idx}.bias"])
    if lin_path is not None:
        lin = _load_pth(lin_path)
        for s in range(len(VGG_SLICES)):
            key = f"lin{s}.model.1.weight"
            if key in lin:
                getattr(model, f"lin{s}").copy_(lin[key][0, :, 0, 0])
    return True
