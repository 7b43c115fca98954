"""int8 convs for the detokenize: kernel Q1 (``csrc/qconv.cu``), its plain
PyTorch version, and the context managers that switch them on, the port of
``ivideogpt_tpu/ops/qconv.py``.

    with int8_convs():                      # dynamic per-tensor scales
        frames = tokenizer.detokenize(ids, ctx)
    with calibrate_convs() as rec:          # record each conv input's absmax
        tokenizer.detokenize(ids, ctx)
    with int8_convs(act_scales=rec.scales(), margin=1.1):   # static scales
        frames = tokenizer.detokenize(ids2, ctx)

Under :func:`int8_convs` every eligible ``models.layers.Conv`` (a 4-D
input, dilation 1) computes

    xq = clip(round(x / sx), +-127)           per tensor (round half to even)
    wq = clip(round(w / sw[o]), +-127)        per output channel
    out = float(sum xq * wq) * (sx * sw[o]) + bias[o]     in the input's dtype

with the int32 sum exact, sx = max|x| / 127 (dynamic) or amax * margin /
127 from ``act_scales`` (static; a conv missing there stays dynamic), and
both scales at least 1e-12. A conv's key is its module name in the
tokenizer (``decoder.up_blocks.0.resnets.1.conv1``, set by
:func:`name_convs`); :func:`port_key` maps the JAX package's key
(``decoder/up_blocks_0/resnets_1/conv1``) to it. The weights are quantized
once for each weight version and kept on the module.

Q1 is no TPU kernel's counterpart: it replaces XLA's int8 conv in
``ivideogpt_tpu/ops/qconv.py::_int8_conv_call``, for which PyTorch has no
CUDA operator. It is an implicit GEMM on Hopper's int8 ``wgmma``, fed by
one TMA box a tap, over a persistent grid whose NCHW stores (by TMA) overlap
the next tile, with the dequantize, bias and cast fused; a second kernel of
the same library (``quantize``) makes the channels-last int8 activation
from the NCHW input as a shared-memory transpose. :func:`q1_plan` is Q1's
tile plan. On a CPU tensor the wrappers run the plain versions; on a CUDA
tensor they launch the kernels or raise. See the source for the design.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import re
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ivideogpt_tpu_torch import _build

Q1_TILE_N = (16, 128, 256)   # a tile's output channels: the first >= O
Q1_TILE_K = 128   # bytes of the reduction a K step: one tap's channel block
Q1_CHANNEL_PAD = 16   # the channels-last activation's C, padded: 16 bytes
Q1_KERNELS = (1, 3)
Q1_STRIDES = (1, 2)
Q1_PADDINGS = (0, 1)
# frames a plain conv takes at once: its float64 copies stay a few GiB
PLAIN_FRAMES = 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class Plan(NamedTuple):
    """Q1's tiles for one conv: ``bn`` output channels by ``bm`` output
    pixels, a pixel tile ``br`` rows of ``bw`` pixels (whole rows where Wo
    <= bm, else a segment of bm pixels), and whether every tile is whole so
    that the epilogue stores by TMA."""
    bn: int
    bm: int
    bw: int
    br: int
    tma_store: bool


def q1_plan(ho: int, wo: int, o: int, out_bytes: int) -> Plan:
    """The tile plan Q1 runs an [N, O, ho, wo] output with (``out_bytes``
    a value): 128 pixels x 256 channels, or 256 x 128 where O <= 128, or
    256 x 16 where O <= 16. A tile stores by TMA where its pixels are
    contiguous in the NCHW output and no pixel of another tile follows them
    in its box: whole rows filling the tile (or the whole frame), or
    segments dividing the row; and the frame's bytes a 16-byte multiple."""
    bn = next((n for n in Q1_TILE_N if o <= n), Q1_TILE_N[-1])
    bm = 128 if bn == 256 else 256
    bw = min(wo, bm)
    br = max(1, min(bm // bw, ho))
    whole = (bw * br == bm or br >= ho) if bw == wo else wo % bw == 0
    return Plan(bn, bm, bw, br, whole and ho * wo * out_bytes % 16 == 0)


def quantize_per_tensor(x: torch.Tensor, scale=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes in x's layout, fp32 scale []): the dynamic scale is
    max|x| / 127; the scale is at least 1e-12; codes round(x / scale)
    (true division, half to even) clipped to +-127."""
    if scale is None:
        scale = amax(x) / 127.0
    scale = torch.as_tensor(scale, dtype=torch.float32,
                            device=x.device).clamp_min(1e-12)
    q = torch.round(x.float() / scale).clamp_(-127, 127)
    return q.to(torch.int8), scale


def quantize_weight_per_channel(w: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW kernel -> (int8 OIHW, fp32 [O] scales), as
    :func:`quantize_per_tensor` with one absmax an output channel."""
    wf = w.float()
    scale = (wf.abs().amax(dim=(1, 2, 3)) / 127.0).clamp_min(1e-12)
    q = torch.round(wf / scale[:, None, None, None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def amax(x: torch.Tensor) -> torch.Tensor:
    """max|x| as a fp32 scalar on x's device (one reduce, no temporary)."""
    return torch.linalg.vector_norm(x, float("inf")).float()


def qconv_plain(xq: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor,
                w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                stride: int, padding: int, out_dtype: torch.dtype,
                accumulator: bool = False) -> torch.Tensor:
    """Plain version of Q1 on NCHW int8 codes xq and OIHW wq: the int32
    accumulator in exact arithmetic (a float64 conv over int8 values: every
    product and partial sum is an integer below 2^53), then, unless
    ``accumulator``, the epilogue in Q1's order: float(acc) * (x_scale *
    w_scale[o]) (the scales' product first, fp32), + bias (fp32), cast to
    ``out_dtype``. Runs PLAIN_FRAMES frames at a time."""
    w64 = wq.double()
    parts = []
    for i in range(0, xq.shape[0], PLAIN_FRAMES):
        acc = F.conv2d(xq[i:i + PLAIN_FRAMES].double(), w64, None, stride,
                       padding).to(torch.int32)
        parts.append(acc if accumulator
                     else dequantize(acc, x_scale, w_scale, bias, out_dtype))
    return torch.cat(parts)


def dequantize(acc: torch.Tensor, x_scale: torch.Tensor,
               w_scale: torch.Tensor, bias: Optional[torch.Tensor],
               out_dtype: torch.dtype) -> torch.Tensor:
    """Q1's epilogue on an NCHW int32 accumulator: float(acc) * (x_scale *
    w_scale[o]), + bias[o], each step rounded in fp32, cast to
    ``out_dtype``."""
    out = acc.float() * (x_scale * w_scale)[None, :, None, None]
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return out.to(out_dtype)


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """NCHW x (bf16 or fp32) and a fp32 scale [] on its device -> int8
    codes channels-last [N, H, W, Cp], C padded with zeros to Cp, a
    multiple of ``Q1_CHANNEL_PAD``: Q1's input. On CUDA the library's
    quantize kernel; on the CPU :func:`quantize_per_tensor` and a copy."""
    N, C, H, W = x.shape
    cp = _round_up(C, Q1_CHANNEL_PAD)
    if x.device.type == "cpu":
        q = torch.zeros((N, H, W, cp), dtype=torch.int8)
        q[..., :C] = quantize_per_tensor(x, scale)[0].permute(0, 2, 3, 1)
        return q
    x = x.contiguous()
    _check_cuda("quantize", x, scale)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quantize: takes bf16 or fp32, got {x.dtype}")
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise ValueError("quantize: the scale must be one fp32 on x's device")
    out = torch.empty((N, H, W, cp), dtype=torch.int8, device=x.device)
    err = _entry("ivg_quantize_nhwc")(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), N, C, H * W, cp,
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"quantize kernel launch failed: cudaError {err}")
    quantize.launches += 1
    return out


quantize.launches = 0


class PackedWeight:
    """A conv's quantized weight: ``wq`` int8 OIHW and ``w_scale`` fp32
    [O] (the plain version's), and ``packed`` int8 [O, k * k * Cb], Q1's B
    operand: row o is output channel o's taps in (dy, dx, c) order, each
    tap's channels padded with zeros to Cb, a multiple of ``Q1_TILE_K``
    (one K step a channel block)."""

    def __init__(self, w: torch.Tensor):
        self.wq, self.w_scale = quantize_weight_per_channel(w)
        O, C, kh, kw = w.shape
        taps = torch.zeros((O, kh, kw, _round_up(C, Q1_TILE_K)),
                           dtype=torch.int8, device=w.device)
        taps[..., :C] = self.wq.permute(0, 2, 3, 1)
        self.packed = taps.reshape(O, -1)


def qconv(xq: torch.Tensor, x_scale: torch.Tensor, weight: PackedWeight,
          bias: Optional[torch.Tensor], stride: int, padding: int,
          out_dtype: torch.dtype, accumulator: bool = False) -> torch.Tensor:
    """Q1: channels-last int8 codes xq [N, H, W, Cp] (from :func:`quantize`)
    and a packed weight -> NCHW out in ``out_dtype`` (bf16 or fp32), or
    with ``accumulator`` the exact int32 sums. Kernel sizes 1 and 3, stride
    1 or 2, padding 0 or 1. On CPU tensors :func:`qconv_plain`; on CUDA
    tensors Q1 or an error."""
    O, C, kh, kw = weight.wq.shape
    N, H, W, cp = xq.shape
    if cp != _round_up(C, Q1_CHANNEL_PAD):
        raise ValueError(f"qconv: {cp} input channels for a {C}-channel "
                         f"kernel")
    if xq.device.type == "cpu":
        return qconv_plain(xq[..., :C].permute(0, 3, 1, 2), x_scale,
                           weight.wq, weight.w_scale, bias, stride, padding,
                           out_dtype, accumulator)
    if (kh != kw or kh not in Q1_KERNELS or stride not in Q1_STRIDES
            or padding not in Q1_PADDINGS):
        raise ValueError(f"qconv: Q1 takes {Q1_KERNELS} kernels, strides "
                         f"{Q1_STRIDES} and paddings {Q1_PADDINGS}; got "
                         f"{kh}x{kw}, stride {stride}, padding {padding}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"qconv: writes bf16 or fp32, not {out_dtype}")
    tensors = [xq, x_scale, weight.packed, weight.w_scale]
    if bias is not None:
        bias = bias.float().contiguous()
        tensors.append(bias)
    _check_cuda("qconv", *tensors)
    if xq.dtype != torch.int8 or not xq.is_contiguous():
        raise ValueError("qconv: xq must be contiguous int8")
    if weight.packed.dim() != 2 or weight.packed.shape[1] % 16:
        raise ValueError("qconv: the packed weight's rows must be a 16-byte "
                         "multiple (TMA's rule)")
    ho = (H + 2 * padding - kh) // stride + 1
    wo = (W + 2 * padding - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"qconv: no output for a {H}x{W} input")
    out = torch.empty((N, O, ho, wo), device=xq.device,
                      dtype=torch.int32 if accumulator else out_dtype)
    plan = q1_plan(ho, wo, O, out.element_size())
    err = _entry("ivg_qconv")(
        xq.data_ptr(), weight.packed.data_ptr(), weight.w_scale.data_ptr(),
        x_scale.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), N, H, W, cp, O, ho, wo, kh, stride, padding,
        weight.packed.shape[1], 2 if accumulator
        else int(out_dtype == torch.bfloat16), *plan,
        torch.cuda.current_stream(xq.device).cuda_stream)
    if err:
        raise RuntimeError(f"qconv kernel launch failed: cudaError {err}")
    qconv.launches += 1
    return out


qconv.launches = 0


def _check_cuda(what: str, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: all inputs must be on one CUDA device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous and 16-byte "
                         f"aligned")


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(_build.load("qconv"), name)
    if name == "ivg_qconv":
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 17
                       + [ctypes.c_void_p])
    else:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# the switches, read by models.layers.Conv.forward
# ---------------------------------------------------------------------------

# (act_scales or None, margin) under int8_convs; a _CalibRecord under
# calibrate_convs. ContextVars, as the JAX package's: a render on another
# thread never sees this one's state.
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "qconv_active", default=None)
_CALIBRATING: contextvars.ContextVar = contextvars.ContextVar(
    "qconv_calibrating", default=None)


@contextlib.contextmanager
def int8_convs(act_scales: Optional[Dict[str, float]] = None,
               margin: float = 1.0):
    """Run every eligible ``Conv`` under this context as an int8 conv.
    ``act_scales``: {conv key: activation absmax} from
    :func:`calibrate_convs`; a conv found there takes the static scale
    amax * margin / 127 (inputs beyond it saturate), any other the dynamic
    per-tensor absmax."""
    token = _ACTIVE.set((act_scales, float(margin)))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


class _CalibRecord:
    """Each eligible conv input's absmax, by conv key; a conv called more
    than once keeps the largest."""

    def __init__(self):
        self._amax: Dict[str, torch.Tensor] = {}

    def observe(self, key: str, x: torch.Tensor):
        a = amax(x)
        prev = self._amax.get(key)
        self._amax[key] = a if prev is None else torch.maximum(prev, a)

    def scales(self) -> Dict[str, torch.Tensor]:
        return dict(self._amax)


@contextlib.contextmanager
def calibrate_convs():
    """Record every eligible ``Conv`` input's absmax (the fp compute is
    unchanged): ``with calibrate_convs() as rec: ...; rec.scales()``."""
    rec = _CalibRecord()
    token = _CALIBRATING.set(rec)
    try:
        yield rec
    finally:
        _CALIBRATING.reset(token)


def eligible(conv, x: torch.Tensor) -> bool:
    """The convs the JAX package intercepts: a 4-D input, dilation 1."""
    return x.ndim == 4 and tuple(conv.dilation) == (1, 1)


def intercepted(conv, x: torch.Tensor) -> Optional[torch.Tensor]:
    """``Conv.forward``'s branch: the int8 conv under :func:`int8_convs`,
    the absmax recorded under :func:`calibrate_convs` (None returned: the
    caller computes the float conv), or None outside both."""
    if not eligible(conv, x):
        return None
    active = _ACTIVE.get()
    if active is not None:
        return int8_conv(conv, x, *active)
    rec = _CALIBRATING.get()
    if rec is not None:
        rec.observe(_key_of(conv), x)
    return None


def _key_of(conv) -> str:
    key = getattr(conv, "qconv_key", None)
    if key is None:
        raise ValueError("a conv without a key: name_convs(model) names a "
                         "model's convs")
    return key


def int8_conv(conv, x: torch.Tensor, act_scales=None,
              margin: float = 1.0) -> torch.Tensor:
    """One conv as int8: x quantized per tensor (the static scale where
    ``act_scales`` holds the conv's key), the weight per output channel
    (once for each weight version), Q1, out in x's dtype."""
    scale = None
    if act_scales is not None:
        a = act_scales.get(getattr(conv, "qconv_key", None))
        if a is not None:
            scale = torch.as_tensor(a, dtype=torch.float32,
                                    device=x.device) * margin / 127.0
    if scale is None:
        scale = amax(x) / 127.0
    scale = scale.clamp_min(1e-12).reshape(())
    stride, padding = conv.stride[0], conv.padding[0]
    if conv.stride[1] != stride or conv.padding[1] != padding:
        raise ValueError("int8 conv: the stride and padding must be "
                         "symmetric")
    return qconv(quantize(x, scale), scale, packed_weight(conv), conv.bias,
                 stride, padding, x.dtype)


def packed_weight(conv) -> PackedWeight:
    """The conv's :class:`PackedWeight`, remade when the weight changed
    (another tensor, an in-place update, a cast or a move)."""
    w = conv.weight
    version = (w.data_ptr(), w._version, w.dtype, w.device)
    cached = getattr(conv, "_qconv_weight", None)
    if cached is None or cached[0] != version:
        with torch.no_grad():
            cached = (version, PackedWeight(w.detach()))
        conv._qconv_weight = cached
    return cached[1]


def name_convs(model: torch.nn.Module, conv_type) -> None:
    """Give every ``conv_type`` module of ``model`` its name in it as its
    int8 key."""
    for name, m in model.named_modules():
        if isinstance(m, conv_type):
            m.qconv_key = name


def port_key(jax_key: str) -> str:
    """The JAX package's conv key ("/"-joined module path) -> the port's
    (the module name), by the tokenizer exporter's rule: ``name_3`` ->
    ``name.3``."""
    return re.sub(r"_(\d+)(\.|$)", r".\1\2", jax_key.replace("/", "."))
