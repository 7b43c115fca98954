"""I3D (Inflated Inception-V1) feature extractor for FVD, the port of
``ivideogpt_tpu/models/i3d.py``.

    I3D()(videos)   # [B, T, H, W, 3] in [0, 1] -> [B, 400] logits

With ``resize`` the clips are resized to 224 x 224 (bilinear, half-pixel
centres, antialiased when shrinking, as ``jax.image.resize`` does), with
``rescale`` mapped to [-1, 1]; the output is the pre-softmax logits, the
FVD feature. Module names are those of the piergiaj/pytorch-i3d port
(``Conv3d_1a_7x7.conv3d.weight``, ``Mixed_3b.b1b.bn.running_var``,
``logits.conv3d.bias``), so a converted state dict loads strictly
(:func:`load_torch_i3d`).

The original is a TensorFlow model: every conv and max pool pads "SAME",
which at stride 2 is asymmetric (more after than before). The pads are
computed from each input's shape and applied with ``F.pad``: zeros before a
conv, -inf before a max pool. BatchNorm is inference-mode (eps 1e-3) in
train mode too. Convolutions run NCDHW in float32; call the model under
``utils.platform.full_fp32`` on the card, or cuDNN computes them in TF32.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_INCEPTION_SPEC = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}


def same_pads(shape: Sequence[int], kernel: Sequence[int],
              stride: Sequence[int]) -> Tuple[int, ...]:
    """TF "SAME" pads of the last len(kernel) dims, in ``F.pad``'s order
    (last dim first, (before, after) each)."""
    pads = []
    for n, k, s in zip(shape, kernel, stride):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(p for pair in reversed(pads) for p in pair)


def max_pool_same(x: torch.Tensor, kernel: Sequence[int],
                  stride: Sequence[int]) -> torch.Tensor:
    x = F.pad(x, same_pads(x.shape[2:], kernel, stride), value=-math.inf)
    return F.max_pool3d(x, kernel, stride)


def resize_224(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, T, 224, 224, C], ``jax.image.resize(...,
    "bilinear")``: half-pixel centres, a triangle kernel widened by the
    scale when shrinking."""
    B, T, H, W, C = x.shape
    y = F.interpolate(x.reshape(B * T, H, W, C).permute(0, 3, 1, 2),
                      size=(224, 224), mode="bilinear", align_corners=False,
                      antialias=H > 224 or W > 224)
    return y.permute(0, 2, 3, 1).reshape(B, T, 224, 224, C)


class _BN(nn.BatchNorm3d):
    """Inference-mode BatchNorm (eps 1e-3) whatever the module's mode."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class Unit3D(nn.Module):
    """SAME-padded Conv3d, then BN and ReLU (the I3D unit)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1), use_bn: bool = True,
                 activation: bool = True):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.activation = activation
        self.conv3d = nn.Conv3d(in_channels, out_channels, self.kernel,
                                self.stride, bias=not use_bn)
        # Flax's defaults: lecun_normal kernels, zero bias
        fan_in = in_channels * math.prod(self.kernel)
        std = fan_in ** -0.5 / .87962566103423978
        nn.init.trunc_normal_(self.conv3d.weight, std=std, a=-2 * std,
                              b=2 * std)
        if self.conv3d.bias is not None:
            nn.init.zeros_(self.conv3d.bias)
        self.bn = _BN(out_channels, eps=1e-3) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3d(F.pad(x, same_pads(x.shape[2:], self.kernel,
                                           self.stride)))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionBlock(nn.Module):
    """Four-branch 3D inception module; ``ch`` = (b0, b1a, b1b, b2a, b2b,
    b3b) output channels."""

    def __init__(self, in_channels: int, ch: Sequence[int]):
        super().__init__()
        self.b0 = Unit3D(in_channels, ch[0])
        self.b1a = Unit3D(in_channels, ch[1])
        self.b1b = Unit3D(ch[1], ch[2], (3, 3, 3))
        self.b2a = Unit3D(in_channels, ch[3])
        self.b2b = Unit3D(ch[3], ch[4], (3, 3, 3))
        self.b3b = Unit3D(in_channels, ch[5])
        self.out_channels = ch[0] + ch[2] + ch[4] + ch[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), b3], dim=1)


class I3D(nn.Module):
    """videos [B, T, H, W, 3] -> [B, num_classes] pre-softmax logits."""

    def __init__(self, num_classes: int = 400, rescale: bool = True,
                 resize: bool = True):
        super().__init__()
        self.rescale, self.resize = rescale, resize
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        c = 192
        for name, ch in _INCEPTION_SPEC.items():
            block = InceptionBlock(c, ch)
            self.add_module(name, block)
            c = block.out_channels
        self.logits = Unit3D(c, num_classes, use_bn=False, activation=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.resize and x.shape[2:4] != (224, 224):
            x = resize_224(x)
        if self.rescale:
            x = x * 2.0 - 1.0
        x = x.permute(0, 4, 1, 2, 3)  # NCDHW
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e",
                     "Mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        # global spatial mean, logits conv, temporal mean
        x = self.logits(x.mean(dim=(3, 4), keepdim=True))
        return x.mean(dim=(2, 3, 4))


def load_torch_i3d(model: I3D, path: Optional[str]) -> bool:
    """Load a converted I3D state dict (piergiaj names) at ``path`` into
    ``model``, strictly. Returns False, changing nothing, when ``path`` is
    None; raises when a named file does not exist, where the JAX loader
    silently keeps the random weights."""
    if path is None:
        return False
    if not os.path.exists(path):
        raise FileNotFoundError(f"I3D weights: {path} does not exist")
    model.load_state_dict(torch.load(path, map_location="cpu",
                                     weights_only=True))
    return True
