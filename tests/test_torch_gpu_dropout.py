"""Attention dropout inside K4, K5 and K6 against the plain versions, on the
card.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips when there is none. Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_dropout.py

- each kernel's mask read back exactly (q = 0 makes P uniform over a row,
  and one-hot V, dO or K blocks expose P Z / keep key by key) and equal to
  ``ops/philox.keep_mask``, in bf16 and fp32, at ragged S, and in bf16 at
  LLAMA_MEDIUM's 16 heads and at B * H = 256 heads (3072 CTAs a kernel,
  many resident on each SM);
- K5 and K6 with dropout bit-identical across two launches;
- the fp32 K4, K5 and K6 (three-term TF32) with dropout at their interface
  over ragged S, one head and B * H = 384, q/k/v apart and from a fused
  qkv, and the bf16 K4 with dropout at the same shapes, its mask read back;
- the kernels with dropout against the plain versions with the same
  (seed, offset), at their own interface and through ``causal_attention``
  and autograd;
- p = 0 bit-equal to the launch without dropout; a mask that follows seed
  and offset; the kept fraction; refusal of p outside [0, 1).
"""

import pytest
import torch

pytestmark = pytest.mark.gpu

DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _blocks(S):
    return range(0, S, 64)


def _onehot_block(B, S, H, c0, dtype, device):
    """[B, S, H, 64]: row c0 + m is e_m for m < 64, every other row 0."""
    x = torch.zeros(B, S, H, 64, device=device)
    n = min(64, S - c0)
    x[:, c0:c0 + n] = torch.eye(64, device=device)[:n, None, :]
    return x.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [1, 5, 64, 130, 751])
def test_each_kernels_mask_equals_the_plain_mask(cuda, S, dtype):
    _assert_masks_read_back(cuda, 2, 3, S, dtype)


@pytest.mark.parametrize("B,H,S", [(2, 16, 751), (16, 16, 751), (16, 16, 130)])
def test_each_kernels_mask_equals_the_plain_mask_at_many_heads(cuda, B, H, S):
    _assert_masks_read_back(cuda, B, H, S, torch.bfloat16)


def _assert_masks_read_back(cuda, B, H, S, dtype):
    """q = 0: P_ij = 1 / (i + 1) for j <= i. K4 with V one-hot on keys
    c0 .. c0+63 gives O[i, m] = P Z / keep at key c0 + m; K5 with dO
    one-hot on queries gives dV[j, m] the same at query c0 + m; K6 with
    dP = 1 (V and dO both e_0), di = 0 and K one-hot on keys gives
    dQ[i, m] = hd^-0.5 P Z / keep at key c0 + m. Nonzero where kept."""
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.ops import philox
    drop = (0.25, 77, philox.offset_of(5, 3))
    want = philox.keep_mask(drop, B, H, S, 0, S, 0, S, device=cuda)
    causal = torch.ones(S, S, device=cuda, dtype=torch.bool).tril()
    zero = torch.zeros(B, S, H, 64, device=cuda, dtype=dtype)
    e0 = zero.clone()
    e0[..., 0] = 1
    lse = torch.log(torch.arange(1, S + 1, device=cuda).float()) \
        .expand(B, H, S).contiguous()
    di = torch.zeros(B, H, S, device=cuda)
    got = {name: torch.zeros(B, H, S, S, device=cuda, dtype=torch.bool)
           for name in ("K4", "K5", "K6")}
    for c0 in _blocks(S):
        n = min(64, S - c0)
        hot = _onehot_block(B, S, H, c0, dtype, cuda)
        o, k4_lse = fa.flash_fwd(zero, zero, hot, drop)
        torch.testing.assert_close(k4_lse, lse, rtol=0, atol=1e-5)
        got["K4"][..., c0:c0 + n] = o[..., :n].permute(0, 2, 1, 3) != 0
        _, dv = fa.flash_bwd_dkv(zero, zero, zero, hot, lse, di, drop)
        got["K5"][:, :, c0:c0 + n, :] = dv[..., :n].permute(0, 2, 3, 1) != 0
        dq = fa.flash_bwd_dq(zero, hot, e0, e0, lse, di, drop)
        got["K6"][..., c0:c0 + n] = dq[..., :n].permute(0, 2, 1, 3) != 0
    for name, mask in got.items():
        assert torch.equal(mask, want & causal), name


def _inputs(cuda, B, S, H, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(B, S, H, 64, device=cuda, generator=g).to(dtype)
            for _ in range(4)]


def _tol(dtype):
    # the existing flash gates: bf16 P and dS rounded before their
    # products; fp32 kernels round nothing below fp32
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=1e-4, atol=1e-5))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [2, 65, 130, 751])
def test_kernels_with_dropout_match_plain_at_their_interface(cuda, S, dtype):
    """K4 (O, lse), K5 and K6 fed the plain lse and di, with dropout,
    against flash_*_plain in fp32 with the same (p, seed, offset)."""
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    B, H = 3, 5
    q, k, v, do = _inputs(cuda, B, S, H, dtype, S)
    drop = (0.1, 2024, 7 << 16)
    f = [t.float() for t in (q, k, v, do)]
    with full_fp32():
        o, lse = fa.flash_fwd(q, k, v, drop)
        ref_o, ref_lse = fa.flash_fwd_plain(*f[:3], drop)
        di = (ref_o * f[3]).sum(-1).transpose(1, 2).contiguous()
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, di, drop)
        dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, di, drop)
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(*f, ref_lse, di, drop)
        ref_dq = fa.flash_bwd_dq_plain(*f, ref_lse, di, drop)
    tol = _tol(dtype)
    # lse is of the undropped probabilities
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    for got, want, what in ((o, ref_o, "K4 O"), (dk, ref_dk, "K5 dK"),
                            (dv, ref_dv, "K5 dV"), (dq, ref_dq, "K6 dQ")):
        torch.testing.assert_close(got.float(), want, **tol, msg=what)
    # no atomics: bit-identical launch to launch, dropout included
    assert torch.equal(dq, fa.flash_bwd_dq(q, k, v, do, ref_lse, di, drop))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,H", [(1, 1), (32, 12)])
@pytest.mark.parametrize("S", [1, 2, 63, 64, 65, 127, 128, 129, 513, 514,
                               683, 751, 1024])
def test_tf32_kernels_with_dropout_match_plain_at_their_interface(
        cuda, S, B, H, fused):
    """The fp32 K5 and K6 with dropout 0.1, fed the plain lse and di,
    against flash_bwd_*_plain with the same (p, seed, offset) at the fp32
    gates (rtol 1e-4, atol 1e-5); bit-identical launch to launch. fused:
    q, k, v are strided views of one [B, S, 3, H, 64] tensor."""
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    g = torch.Generator(device=cuda).manual_seed(S * B + 3)
    if fused:
        q, k, v = torch.randn(B, S, 3, H, 64, device=cuda,
                              generator=g).unbind(2)
    else:
        q, k, v = (torch.randn(B, S, H, 64, device=cuda, generator=g)
                   for _ in range(3))
    do = torch.randn(B, S, H, 64, device=cuda, generator=g)
    drop = (0.1, 2024, 7 << 16)
    with full_fp32():
        o, lse = fa.flash_fwd_plain(q, k, v, drop)
        di = (o * do).sum(-1).transpose(1, 2).contiguous()
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, di, drop)
        ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, di, drop)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, di, drop)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, di, drop)
    for got, want, what in ((dk, ref_dk, "K5 dK"), (dv, ref_dv, "K5 dV"),
                            (dq, ref_dq, "K6 dQ")):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5,
                                   msg=what)
    again_dk, again_dv = fa.flash_bwd_dkv(q, k, v, do, lse, di, drop)
    assert torch.equal(dk, again_dk) and torch.equal(dv, again_dv)
    assert torch.equal(dq, fa.flash_bwd_dq(q, k, v, do, lse, di, drop))


K4_SHAPES = dict(argnames="S", argvalues=[1, 63, 64, 65, 300, 514, 751,
                                           1024])


def _k4_inputs(cuda, B, S, H, dtype, seed, fused):
    """q, k, v [B, S, H, 64] in dtype; fused: strided views of one
    [B, S, 3, H, 64] tensor, as a fused qkv projection gives them."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    if fused:
        return torch.randn(B, S, 3, H, 64, device=cuda,
                           generator=g).to(dtype).unbind(2)
    return [torch.randn(B, S, H, 64, device=cuda, generator=g).to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,H", [(1, 1), (32, 12)])
@pytest.mark.parametrize(**K4_SHAPES)
def test_tf32_k4_with_dropout_matches_plain_at_its_interface(cuda, S, B, H,
                                                             fused):
    """The fp32 K4 with dropout 0.1 against flash_fwd_plain with the same
    (p, seed, offset) at the fp32 gates (rtol 1e-4, atol 1e-5; lse, of the
    undropped P, within 1e-4); bit-identical launch to launch."""
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    q, k, v = _k4_inputs(cuda, B, S, H, torch.float32, S * B + 7, fused)
    drop = (0.1, 2024, 7 << 16)
    with full_fp32():
        ref_o, ref_lse = fa.flash_fwd_plain(q, k, v, drop)
    o, lse = fa.flash_fwd(q, k, v, drop)
    torch.testing.assert_close(o, ref_o, rtol=1e-4, atol=1e-5)
    assert float((lse - ref_lse).abs().max()) < 1e-4
    again_o, again_lse = fa.flash_fwd(q, k, v, drop)
    assert torch.equal(o, again_o) and torch.equal(lse, again_lse)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,H", [(1, 1), (32, 12)])
@pytest.mark.parametrize(**K4_SHAPES)
def test_bf16_k4_with_dropout_matches_plain_and_reads_back_its_mask(
        cuda, S, B, H, fused):
    """The bf16 K4 with dropout 0.1 against flash_fwd_plain in fp32 on the
    same bf16 inputs (the bf16 gates), bit-identical launch to launch; then
    its mask read back through one-hot V blocks at q = k = 0 (O[i, m] =
    P Z / keep at key c0 + m), equal to ``keep_mask`` on the causal part."""
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.ops import philox
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    q, k, v = _k4_inputs(cuda, B, S, H, torch.bfloat16, S * B + 8, fused)
    drop = (0.1, 2024, 7 << 16)
    with full_fp32():
        ref_o, ref_lse = fa.flash_fwd_plain(q.float(), k.float(), v.float(),
                                            drop)
    o, lse = fa.flash_fwd(q, k, v, drop)
    torch.testing.assert_close(o.float(), ref_o, **_tol(torch.bfloat16))
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    again_o, again_lse = fa.flash_fwd(q, k, v, drop)
    assert torch.equal(o, again_o) and torch.equal(lse, again_lse)
    del q, k, v, o, lse, ref_o, ref_lse, again_o, again_lse
    zero = torch.zeros(B, S, H, 64, device=cuda, dtype=torch.bfloat16)
    got = torch.zeros(B, H, S, S, device=cuda, dtype=torch.bool)
    for c0 in _blocks(S):
        n = min(64, S - c0)
        o, _ = fa.flash_fwd(zero, zero,
                            _onehot_block(B, S, H, c0, torch.bfloat16, cuda),
                            drop)
        got[..., c0:c0 + n] = o[..., :n].permute(0, 2, 1, 3) != 0
    causal = torch.ones(S, S, device=cuda, dtype=torch.bool).tril()
    want = philox.keep_mask(drop, B, H, S, 0, S, 0, S, device=cuda)
    assert torch.equal(got, want & causal)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [65, 130, 751])
def test_k5_and_k6_with_dropout_are_bit_identical_across_launches(cuda, S,
                                                                  dtype):
    """The keep tiles are drawn anew in every launch, from the arguments
    alone; no atomics. Queued between the two, a launch with another
    offset leaves its own bits in the CTAs' shared memory."""
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    B, H = 4, 12
    q, k, v, do = _inputs(cuda, B, S, H, dtype, S + 1)
    o, lse = fa.flash_fwd(q, k, v)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    drop, other = (0.1, 2024, 7 << 16), (0.1, 2024, 8 << 16)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, di, drop)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, di, drop)
    dk_o, _ = fa.flash_bwd_dkv(q, k, v, do, lse, di, other)
    dq_o = fa.flash_bwd_dq(q, k, v, do, lse, di, other)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, di, drop)
    dq2 = fa.flash_bwd_dq(q, k, v, do, lse, di, drop)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, dq2)
    assert not torch.equal(dk, dk_o) and not torch.equal(dq, dq_o)


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_attention_with_dropout_matches_autograd_of_plain(cuda, dtype):
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    B, S, H = 2, 200, 4
    q, k, v, do = _inputs(cuda, B, S, H, dtype, 9)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    drop = (0.1, 5, 3)
    before = fa.flash_fwd.launches
    out = fa.causal_attention(q, k, v, dtype, drop)
    grads = torch.autograd.grad(out, (q, k, v), do.flatten(2))
    assert fa.flash_fwd.launches == before + 1
    ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
    with full_fp32():
        ref = fa.causal_attention_plain(*ref_in, torch.float32, dropout=drop)
        ref_grads = torch.autograd.grad(ref, ref_in, do.float().flatten(2))
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref, **tol)
    for ours, theirs, what in zip(grads, ref_grads, "qkv"):
        torch.testing.assert_close(ours.float(), theirs, **tol,
                                   msg=f"d{what}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_p0_is_bit_equal_to_no_dropout(cuda, dtype):
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    B, S, H = 2, 751, 3
    q, k, v, do = _inputs(cuda, B, S, H, dtype, 4)
    o, lse = fa.flash_fwd(q, k, v)
    o0, lse0 = fa.flash_fwd(q, k, v, (0.0, 123, 456))
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, di)
    dk0, dv0 = fa.flash_bwd_dkv(q, k, v, do, lse, di, (0.0, 123, 456))
    assert torch.equal(dk, dk0) and torch.equal(dv, dv0)
    assert torch.equal(fa.flash_bwd_dq(q, k, v, do, lse, di),
                       fa.flash_bwd_dq(q, k, v, do, lse, di, (0.0, 1, 2)))


def test_mask_follows_seed_and_offset_and_keeps_its_share(cuda):
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    B, S, H = 4, 751, 12
    q, k, v, _ = _inputs(cuda, B, S, H, torch.bfloat16, 6)
    outs = {d: fa.flash_fwd(q, k, v, d)[0]
            for d in ((0.1, 1, 0), (0.1, 1, 1), (0.1, 2, 0))}
    again = fa.flash_fwd(q, k, v, (0.1, 1, 0))[0]
    assert torch.equal(outs[(0.1, 1, 0)], again)
    assert not torch.equal(outs[(0.1, 1, 0)], outs[(0.1, 1, 1)])
    assert not torch.equal(outs[(0.1, 1, 0)], outs[(0.1, 2, 0)])
    from ivideogpt_tpu_torch.ops import philox
    z = philox.keep_mask((0.1, 1, 0), B, H, S, 0, S, 0, S, device=cuda)
    n = z.numel()
    sigma = (0.9 * 0.1 / n) ** 0.5
    assert abs(float(z.float().mean()) - 0.9) < 5 * sigma


def test_dropout_outside_0_1_is_refused(cuda):
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    for p in (-0.1, 1.0, 1.5):
        with pytest.raises(ValueError):
            fa.flash_fwd(q, q, q, (p, 0, 0))
