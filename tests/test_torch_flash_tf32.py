"""The arithmetic of the fp32 K4, K5 and K6 (``csrc/flash_attention_tf32.cu``),
emulated on the CPU: every product as three TF32 products,
A B ~ A_h B_h + A_h B_l + A_l B_h, with A_h = A rounded to TF32 (round to
nearest, ties away from zero: ``cvt.rna.tf32.f32``) and A_l = A - A_h
rounded alike, summed in fp32.

The emulation lives here and not in the package: the kernels are the
package's, and the card's tests (tests/test_torch_gpu_kernels.py,
tests/test_torch_gpu_dropout.py) hold them against the plain versions.
The tensor cores sum the three terms and the k-steps in another order than
``torch.matmul`` on the CPU, so these tests check the error budget of the
split against the fp32 tolerances (rtol 1e-4, atol 1e-5), not bit equality
with the kernels. The forward is held against ``flash_fwd_plain`` (also
with the Philox mask) and against the stock JAX
``mha_reference_no_custom_vjp``, the backward against
``flash_bwd_dkv_plain`` / ``flash_bwd_dq_plain`` and the stock JAX
``mha_reference_bwd`` (jax/experimental/pallas/ops/tpu/flash_attention.py,
JAX 0.9.0), called as tests/test_torch_flash_interface.py calls it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (
    mha_reference_bwd, mha_reference_no_custom_vjp)

from ivideogpt_tpu_torch.ops import philox
from ivideogpt_tpu_torch.ops.flash_attention import (_aligned,
                                                     flash_bwd_dkv_plain,
                                                     flash_bwd_dq_plain,
                                                     flash_fwd_plain)

B, H, HD = 1, 2, 64
SCALE = HD ** -0.5
TOL = dict(rtol=1e-4, atol=1e-5)   # the fp32 kernels' gates on the card
LOW13 = 0x1FFF                     # the fp32 mantissa bits TF32 drops


def to_tf32(x):
    """fp32 -> the nearest TF32 value, ties away from zero: add half of the
    dropped part to the magnitude bits, then clear the 13 low bits (a carry
    into the exponent rounds up to the next binade, as it should)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~LOW13).view(torch.float32)


def split(x):
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


def mm3(a, b):
    """a @ b in three TF32 terms, the small ones first, summed in fp32.
    A product of two TF32 values (11-bit significands) is exact in fp32."""
    a_h, a_l = split(a)
    b_h, b_l = split(b)
    return (a_h @ b_l + a_l @ b_h) + a_h @ b_h


def forward_tf32(q, k, v, dropout=None):
    """(O [B, S, H, HD], lse [B, H, S]) of the causal forward with its two
    products (S = Q K^T, O = P V) as mm3, as K4 computes them: P = exp(s -
    m) unnormalised in [0, 1] (times Z / keep with dropout, after the row
    sums), split into TF32 hi and lo as the kernel splits its score
    accumulator, and O = (P V) / l."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    S = q.shape[1]
    s = mm3(qh, kh.transpose(-1, -2)) * SCALE
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                      float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if dropout is not None:
        z = philox.keep_mask(dropout, q.shape[0], q.shape[2], S, 0, S, 0, S)
        p = p * z / (1.0 - dropout[0])
    o = mm3(p, vh) / l
    return o.transpose(1, 2), (m + torch.log(l))[..., 0]


def backward_tf32(q, k, v, do, lse, di):
    """(dQ, dK, dV) [B, S, H, HD] of the causal backward with each of its
    five products (S, dP, dV, dK, dQ) as mm3, as K5 and K6 compute them."""
    qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, do))
    S = q.shape[1]
    s = mm3(qh, kh.transpose(-1, -2)) * SCALE
    live = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.exp(s - lse[..., None]) * live
    dp = mm3(doh, vh.transpose(-1, -2))
    ds = p * (dp - di[..., None])
    dv = mm3(p.transpose(-1, -2), doh)
    dk = mm3(ds.transpose(-1, -2), qh) * SCALE
    dq = mm3(ds, kh) * SCALE
    return tuple(t.transpose(1, 2) for t in (dq, dk, dv))


def _inputs(S, seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(B, S, H, HD)).astype(np.float32))
            for _ in range(4)]


@pytest.mark.parametrize("scale", [1e-20, 1.0, 3e5])
def test_split_gives_tf32_values_that_restore_x(scale):
    """hi and lo are exact TF32 values (the 13 low bits clear), and hi + lo
    restores x to 2^-22 of |x| (for |x| >= 2^-104, where lo is a normal
    fp32 number); ties go away from zero."""
    rng = np.random.default_rng(1)
    x = torch.tensor((rng.normal(size=100_000) * scale).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & LOW13).any())
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    # a tie: 1 + 2^-11 lies halfway between 1 and 1 + 2^-10
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11)], dtype=torch.float32)
    assert to_tf32(tie).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10)]


def test_three_terms_hold_fp32_where_one_does_not():
    """On a 64-deep dot (the kernels' k extent a tile) three terms stay
    within 1e-6 of the float64 product, one TF32 term is off by ~1e-3."""
    rng = np.random.default_rng(2)
    a, b = (torch.tensor(rng.normal(size=(256, 64)).astype(np.float32))
            for _ in range(2))
    exact = a.double() @ b.double().T
    scale = a.double().abs() @ b.double().abs().T
    three = (mm3(a, b.T).double() - exact).abs() / scale
    one = (to_tf32(a) @ to_tf32(b).T).double().sub(exact).abs() / scale
    assert float(three.max()) < 1e-6
    assert float(one.max()) > 1e-4


@pytest.mark.parametrize("S", [65, 300, 514, 751])
def test_three_term_forward_matches_plain(S):
    q, k, v, _ = _inputs(S, seed=S + 2)
    o, lse = forward_tf32(q, k, v)
    want_o, want_lse = flash_fwd_plain(q, k, v)
    torch.testing.assert_close(o, want_o, **TOL)
    assert float((lse - want_lse).abs().max()) < 1e-4


@pytest.mark.parametrize("S", [65, 300, 514, 751])
def test_three_term_forward_matches_stock_reference(S):
    q, k, v, _ = _inputs(S, seed=S + 3)
    jq, jk, jv = (jnp.asarray(t.transpose(1, 2).numpy()) for t in (q, k, v))
    out, l, m = mha_reference_no_custom_vjp(jq, jk, jv, causal=True,
                                            sm_scale=SCALE,
                                            save_residuals=True)
    o, lse = forward_tf32(q, k, v)
    np.testing.assert_allclose(
        o.numpy(), np.swapaxes(np.asarray(out, np.float32), 1, 2), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(m + jnp.log(l)),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("S", [65, 300, 514, 751])
def test_three_term_forward_with_dropout_matches_plain(S):
    """With the Philox mask: O = (P Z / keep) V, lse of the undropped P."""
    q, k, v, _ = _inputs(S, seed=S + 4)
    drop = (0.1, 2024, philox.offset_of(3, 1))
    o, lse = forward_tf32(q, k, v, drop)
    want_o, want_lse = flash_fwd_plain(q, k, v, drop)
    torch.testing.assert_close(o, want_o, **TOL)
    assert float((lse - want_lse).abs().max()) < 1e-4
    assert not torch.allclose(o, flash_fwd_plain(q, k, v)[0], **TOL)


@pytest.mark.parametrize("S", [65, 300, 751])
def test_three_term_backward_matches_plain(S):
    q, k, v, do = _inputs(S, seed=S)
    o, lse = flash_fwd_plain(q, k, v)
    di = (o * do).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = backward_tf32(q, k, v, do, lse, di)
    want_dk, want_dv = flash_bwd_dkv_plain(q, k, v, do, lse, di)
    want_dq = flash_bwd_dq_plain(q, k, v, do, lse, di)
    for got, want, what in ((dk, want_dk, "dK"), (dv, want_dv, "dV"),
                            (dq, want_dq, "dQ")):
        torch.testing.assert_close(got, want, **TOL, msg=what)


@pytest.mark.parametrize("S", [65, 300, 751])
def test_three_term_backward_matches_stock_reference(S):
    q, k, v, do = _inputs(S, seed=S + 1)
    jq, jk, jv, jdo = (jnp.asarray(t.transpose(1, 2).numpy())
                       for t in (q, k, v, do))
    out, l, m = mha_reference_no_custom_vjp(jq, jk, jv, causal=True,
                                            sm_scale=SCALE,
                                            save_residuals=True)
    # mha_reference_bwd takes sm_scale 1.0 only: it gets q * SCALE, so its
    # dQ is the gradient by the scaled q, SCALE^-1 times K6's
    jdq, jdk, jdv, _ = mha_reference_bwd(jq * SCALE, jk, jv, None, None, out,
                                         l, m, jdo, causal=True)
    lse = torch.tensor(np.asarray(m + jnp.log(l)))
    di = torch.tensor(np.asarray(jnp.sum(out * jdo, axis=-1)))
    dq, dk, dv = backward_tf32(q, k, v, do, lse, di)
    for got, want, what in ((dq, jdq * SCALE, "dQ"), (dk, jdk, "dK"),
                            (dv, jdv, "dV")):
        np.testing.assert_allclose(
            got.numpy(), np.swapaxes(np.asarray(want, np.float32), 1, 2),
            **TOL, err_msg=what)


def test_tma_alignment_rule():
    """What the TMA-fed kernels take (the wrappers refuse the rest): a
    16-byte aligned base and strides of whole 16 bytes, 4 fp32 or 8 bf16
    elements; the fp32 kernels, K4 among them, as the bf16 kernels."""
    x = torch.zeros(2, 70, 3, 80)
    assert _aligned(x[..., :64])
    assert not _aligned(x[..., 1:65])                       # base 4 B off
    assert _aligned(x[..., 4:68])                           # base 16 B off
    odd = torch.zeros(2, 70, 3 * 66)[..., :3 * 64].view(2, 70, 3, 64)
    assert not _aligned(odd)                                # stride 198
    bf = torch.zeros(2, 70, 3, 80, dtype=torch.bfloat16)
    assert _aligned(bf[..., 8:72]) and not _aligned(bf[..., 4:68])
