"""The reference's arithmetic: IEEE fp32 (TF32 off), or a lower precision
for the control that ``correct`` is shown to fail.

``Precision("fp32")`` computes every product in fp32 with TF32 off.
``Precision("tf32")`` lets cuBLAS and cuDNN round the operands of fp32
products to TF32 (the step below fp32). ``Precision("fp8")`` rounds both
operands of every product (linear layers, convolutions, the attention's
two products) to float8 e4m3 with one scale a tensor (its absmax over
448), in the forward and in the backward, and accumulates in fp32: the
step below bf16.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale (absmax / 448), in fp32."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    return (t.float() / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8MatMul(torch.autograd.Function):
    """a @ b with both operands, and the gradient in the backward, rounded
    to float8 e4m3."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = fp8_round(g)
        ga = gq @ bq.transpose(-1, -2)
        gb = aq.transpose(-1, -2) @ gq
        # broadcast batch dimensions back to the operands' shapes
        while ga.ndim > aq.ndim:
            ga = ga.sum(0)
        while gb.ndim > bq.ndim:
            gb = gb.sum(0)
        return ga, gb


class _Fp8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        xq, wq = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, padding)
        return F.conv2d(xq, wq, None, stride, padding)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        stride, padding = ctx.conf
        gq = fp8_round(g)
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride, padding)
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride, padding)
        return gx, gw, None, None


class Precision:
    """The arithmetic of one reference run: ``name`` is "fp32", "tf32" or
    "fp8" (the module docstring)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32, tf32 or fp8")
        self.name = name

    @contextlib.contextmanager
    def scope(self):
        """TF32 on for "tf32" and off otherwise, restored after."""
        tf32 = self.name == "tf32"
        prev = torch.backends.cuda.matmul.allow_tf32
        cudnn = torch.backends.cudnn
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            with cudnn.flags(enabled=cudnn.enabled, benchmark=False,
                             deterministic=cudnn.deterministic,
                             allow_tf32=tf32):
                yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def matmul(self, a, b):
        if self.name == "fp8":
            return _Fp8MatMul.apply(a, b)
        return a @ b

    def linear(self, x, w, b=None):
        y = self.matmul(x, w.t())
        return y if b is None else y + b

    def conv(self, x, w, b, stride=1, padding=0):
        if self.name == "fp8":
            y = _Fp8Conv.apply(x, w, stride, padding)
        else:
            y = F.conv2d(x, w, None, stride, padding)
        return y + b.view(1, -1, 1, 1)
