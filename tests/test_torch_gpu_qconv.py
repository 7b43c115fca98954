"""Q1, the int8 implicit-GEMM conv (``csrc/qconv.cu``), and its quantize
kernel against their plain versions, on the card.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips when there is none. Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_qconv.py

The int32 accumulator is exact on both sides, so Q1's equals the plain
version's bit for bit; the epilogue takes the same fp32 steps in the same
order (no fused multiply-add), so the outputs are equal too. Beside random
shapes (ragged tiles stored with masks, stride 2 through the parity maps,
an input too narrow for one parity) they run the detokenize's 23 conv
shapes at two frames (whole tiles stored by TMA), a grid of more tiles than
twice the SMs whose last tile is ragged, and the wrappers' refusals. The
detokenize's full shapes are ``chip_smoke.py``'s ``qconv`` phase.
"""

import pytest
import torch

pytestmark = pytest.mark.gpu

# TOKENIZER_64's int8 detokenize: (C, H, W, O, k), stride 1, padding k // 2
DETOK_SHAPES = [
    (64, 16, 16, 64, 1), (64, 16, 16, 512, 3), (128, 64, 64, 3, 3),
    (128, 64, 64, 128, 3), (256, 32, 32, 256, 3), (256, 64, 64, 128, 1),
    (256, 64, 64, 128, 3), (256, 64, 64, 256, 3), (512, 16, 16, 512, 3),
    (512, 32, 32, 256, 1), (512, 32, 32, 256, 3), (512, 32, 32, 512, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _check(cuda, n, c, h, w, o, k, stride, pad, dtype, seed=None):
    """Q1 and the quantize kernel at one shape against the plain versions:
    codes, int32 accumulators, outputs with and without a bias."""
    from ivideogpt_tpu_torch.ops import qconv as q
    g = torch.Generator(device=cuda).manual_seed(
        n * 1000 + c + o if seed is None else seed)
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
    return q, xq, scale, packed, bias


@pytest.mark.parametrize("n,c,h,w,o,k,stride,pad", [
    (1, 16, 1, 1, 1, 1, 1, 0), (2, 64, 16, 16, 64, 3, 1, 1),
    (3, 128, 33, 31, 3, 3, 1, 1), (2, 64, 20, 20, 70, 3, 2, 1),
    (2, 48, 9, 9, 16, 3, 2, 0), (5, 3, 17, 13, 8, 3, 1, 1),
    (4, 256, 8, 8, 128, 1, 1, 0), (3, 100, 11, 7, 130, 1, 2, 0),
    (1, 512, 16, 16, 512, 3, 1, 1), (7, 32, 5, 5, 3, 3, 2, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q1_is_bit_equal_to_plain(cuda, n, c, h, w, o, k, stride, pad, dtype):
    """Random shapes: 1 and 3 kernels, strides 1 and 2, paddings 0 and 1,
    channels off the 16 and 128 multiples (3, 70 and 130 outputs: tiles
    past O), ragged pixel tiles."""
    _check(cuda, n, c, h, w, o, k, stride, pad, dtype)


@pytest.mark.parametrize("c,h,w,o,k", DETOK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q1_at_the_detokenize_shapes(cuda, c, h, w, o, k, dtype):
    """The 23 shapes of the int8 detokenize (12 distinct (C, H, W, O, k),
    the context and the conditional decoder's N) at N = 2: whole tiles,
    stored by TMA."""
    from ivideogpt_tpu_torch.ops import qconv as q
    plan = q.q1_plan(h, w, o, dtype.itemsize)
    assert plan.tma_store and plan.bw * plan.br == plan.bm
    _check(cuda, 2, c, h, w, o, k, 1, k // 2, dtype)


@pytest.mark.parametrize("n,c,h,w,o,k,pad", [
    (3, 64, 1, 1, 16, 3, 1), (2, 32, 2, 1, 5, 3, 1), (2, 16, 1, 6, 9, 1, 0),
    (4, 128, 64, 64, 256, 3, 1), (2, 200, 15, 300, 300, 3, 1)])
def test_q1_stride_2(cuda, n, c, h, w, o, k, pad):
    """Stride 2 through the four parity maps: an input of one pixel (three
    parities hold nothing and read as zeros), one column, a wide frame
    (row segments), a detokenize-sized frame."""
    _check(cuda, n, c, h, w, o, k, 2, pad, torch.bfloat16)


def test_q1_two_launches_are_bit_identical(cuda):
    """The same inputs twice: equal outputs, accumulators included (no
    atomics; every tile's K order fixed)."""
    q, xq, scale, packed, bias = _check(cuda, 6, 256, 32, 32, 256, 3, 1, 1,
                                        torch.bfloat16)
    for acc in (True, False):
        first = q.qconv(xq, scale, packed, bias, 1, 1, torch.bfloat16,
                        accumulator=acc)
        assert torch.equal(first, q.qconv(xq, scale, packed, bias, 1, 1,
                                          torch.bfloat16, accumulator=acc))


@pytest.mark.parametrize("n,h,w,o,dtype", [
    (40, 33, 31, 300, torch.bfloat16), (80, 16, 16, 300, torch.float32),
    (40, 64, 64, 100, torch.bfloat16), (200, 20, 20, 3, torch.float32),
    (40, 4, 512, 300, torch.bfloat16)])
def test_q1_persistent_grid_with_a_ragged_last_tile(cuda, n, h, w, o, dtype):
    """More tiles than twice the SMs, so every block walks several, and the
    last one ragged: in pixels (33 rows of 31 in tiles of 4 rows; 20 x 20
    in tiles of 12 rows) or in channels (300 in tiles of 256, 100 of 128,
    rows of 512 in segments of 128)."""
    from ivideogpt_tpu_torch.ops import qconv as q
    plan = q.q1_plan(h, w, o, dtype.itemsize)
    tiles = (n * -(-h // plan.br) * -(-w // plan.bw)
             * -(-o // plan.bn))
    assert tiles > 2 * torch.cuda.get_device_properties(
        cuda).multi_processor_count
    _check(cuda, n, 64, h, w, o, 3, 1, 1, dtype)


def test_q1_refuses_a_misaligned_view(cuda):
    """TMA's rule: every tensor a map describes starts on 16 bytes. A
    contiguous view one byte into its storage is refused with a ValueError
    before any launch, the quantize's input too."""
    from ivideogpt_tpu_torch.ops import qconv as q
    x = torch.randn(2, 16, 8, 8, device=cuda)
    scale = (q.amax(x) / 127.0).reshape(())
    xq = q.quantize(x, scale)
    buf = torch.zeros(xq.numel() + 16, dtype=torch.int8, device=cuda)
    moved = buf[1:1 + xq.numel()].view(xq.shape)
    moved.copy_(xq)
    packed = q.PackedWeight(torch.randn(4, 16, 3, 3, device=cuda))
    before = q.qconv.launches
    with pytest.raises(ValueError, match="16-byte"):
        q.qconv(moved, scale, packed, None, 1, 1, torch.float32)
    xf = torch.zeros(x.numel() + 4, device=cuda)[1:1 + x.numel()].view(
        x.shape)
    with pytest.raises(ValueError, match="16-byte"):
        q.quantize(xf, scale)
    assert q.qconv.launches == before


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
    bad.packed = bad.packed[:, :144].contiguous()   # K short of 9 blocks
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
