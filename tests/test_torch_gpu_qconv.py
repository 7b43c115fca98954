"""Q1, the int8 implicit-GEMM conv (``csrc/qconv.cu``), and its quantize
kernel against their plain versions, on the card.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips when there is none. Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_qconv.py

The int32 accumulator is exact on both sides, so Q1's equals the plain
version's bit for bit; the epilogue takes the same fp32 steps in the same
order (no fused multiply-add), so the outputs are equal too. The
detokenize's full shapes are ``chip_smoke.py``'s ``qconv`` phase.
"""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("n,c,h,w,o,k,stride,pad", [
    (1, 16, 1, 1, 1, 1, 1, 0), (2, 64, 16, 16, 64, 3, 1, 1),
    (3, 128, 33, 31, 3, 3, 1, 1), (2, 64, 20, 20, 70, 3, 2, 1),
    (2, 48, 9, 9, 16, 3, 2, 0), (5, 3, 17, 13, 8, 3, 1, 1),
    (4, 256, 8, 8, 128, 1, 1, 0), (3, 100, 11, 7, 130, 1, 2, 0),
    (1, 512, 16, 16, 512, 3, 1, 1), (7, 32, 5, 5, 3, 3, 2, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q1_is_bit_equal_to_plain(cuda, n, c, h, w, o, k, stride, pad, dtype):
    """Random shapes: 1 and 3 kernels, strides 1 and 2, paddings 0 and 1,
    channels off the 16 and 64 multiples (3 and 130 outputs: guarded
    tiles), ragged pixel tiles."""
    from ivideogpt_tpu_torch.ops import qconv as q
    g = torch.Generator(device=cuda).manual_seed(n * 1000 + c + o)
    x = (torch.randn(n, c, h, w, device=cuda, generator=g) * 2).to(dtype)
    wt = torch.randn(o, c, k, k, device=cuda, generator=g) * 0.05
    bias = torch.randn(o, device=cuda, generator=g)
    packed = q.PackedWeight(wt)
    scale = (q.amax(x) / 127.0).clamp_min(1e-12)
    before = (q.quantize.launches, q.qconv.launches)
    xq = q.quantize(x, scale)
    acc = q.qconv(xq, scale, packed, bias, stride, pad, dtype,
                  accumulator=True)
    out = q.qconv(xq, scale, packed, bias, stride, pad, dtype)
    assert (q.quantize.launches, q.qconv.launches) == (before[0] + 1,
                                                       before[1] + 2)
    codes = q.quantize_per_tensor(x, scale)[0]
    assert torch.equal(xq[..., :c], codes.permute(0, 2, 3, 1))
    assert not xq[..., c:].any()
    ref_acc = q.qconv_plain(codes, scale, packed.wq, packed.w_scale, bias,
                            stride, pad, dtype, accumulator=True)
    assert acc.dtype == torch.int32 and torch.equal(acc, ref_acc)
    ref = q.qconv_plain(codes, scale, packed.wq, packed.w_scale, bias,
                        stride, pad, dtype)
    assert out.dtype == dtype and torch.equal(out, ref)
    # without a bias
    assert torch.equal(
        q.qconv(xq, scale, packed, None, stride, pad, dtype),
        q.qconv_plain(codes, scale, packed.wq, packed.w_scale, None, stride,
                      pad, dtype))


def test_conv_module_under_int8_convs_launches_q1(cuda):
    """A ``Conv`` under ``int8_convs`` on the card: the quantize kernel and
    Q1 once each, its output the plain int8 conv's, in the input's dtype;
    a static scale saturates."""
    from ivideogpt_tpu_torch.models.layers import Conv
    from ivideogpt_tpu_torch.ops import qconv as q
    conv = Conv(64, 32, 3, padding=1).to(cuda)
    conv.qconv_key = "c"
    x = torch.randn(4, 64, 16, 16, device=cuda).bfloat16()
    before = q.qconv.launches
    with torch.no_grad(), q.int8_convs():
        out = conv(x)
    assert q.qconv.launches == before + 1 and out.dtype == torch.bfloat16
    scale = (q.amax(x) / 127.0).clamp_min(1e-12)
    packed = q.packed_weight(conv)
    ref = q.qconv_plain(q.quantize_per_tensor(x, scale)[0], scale, packed.wq,
                        packed.w_scale, conv.bias, 1, 1, torch.bfloat16)
    assert torch.equal(out, ref)
    amax = 0.5 * float(q.amax(x))
    with torch.no_grad(), q.int8_convs({"c": amax}, margin=1.0):
        static = conv(x)
    clipped = x.float().clamp(-amax, amax)
    with torch.no_grad(), q.int8_convs({"c": amax}):
        assert torch.equal(conv(clipped.bfloat16()), static)


def test_q1_refuses_and_never_falls_back(cuda, monkeypatch):
    """A shape Q1 does not take raises; a launch the library refuses
    raises; a library that does not build raises."""
    from ivideogpt_tpu_torch.ops import qconv as q
    x = torch.randn(1, 16, 8, 8, device=cuda)
    scale = (q.amax(x) / 127.0).reshape(())
    xq = q.quantize(x, scale)
    with pytest.raises(ValueError, match="kernels"):
        q.qconv(xq, scale, q.PackedWeight(torch.randn(4, 16, 5, 5,
                                                      device=cuda)),
                None, 1, 2, torch.float32)
    with pytest.raises(ValueError, match="kernels"):
        q.qconv(xq, scale, q.PackedWeight(torch.randn(4, 16, 3, 3,
                                                      device=cuda)),
                None, 3, 1, torch.float32)
    bad = q.PackedWeight(torch.randn(4, 16, 3, 3, device=cuda))
    bad.packed = bad.packed[:, :144].contiguous()   # K not a multiple of 64
    with pytest.raises(RuntimeError, match="cudaError"):
        q.qconv(xq, scale, bad, None, 1, 1, torch.float32)
    q._entry.cache_clear()

    def broken(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")
    monkeypatch.setattr(q._build, "load", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        q.qconv(xq, scale, q.PackedWeight(torch.randn(4, 16, 3, 3,
                                                      device=cuda)),
                None, 1, 1, torch.float32)
    q._entry.cache_clear()
