"""The plain versions of K4, K5 and K6 at the kernels' own interface
(``flash_fwd_plain``, ``flash_bwd_dkv_plain``, ``flash_bwd_dq_plain`` in
``ivideogpt_tpu_torch/ops/flash_attention.py``), against the stock JAX
flash attention's references on the CPU
(jax/experimental/pallas/ops/tpu/flash_attention.py, JAX 0.9.0):

- ``mha_reference_no_custom_vjp(..., causal=True, save_residuals=True)``
  (:1482): O, and lse = m + log l in natural log, as K4 writes it;
- ``mha_reference_bwd`` (:1615) fed that forward's (o, l, m) and dO: dK and
  dV as K5 computes them, dQ as K6 does, from the same lse and di.

``chip_smoke.py`` and tests/test_torch_gpu_kernels.py hold the CUDA kernels
against these plain versions on the card. S covers one row, one tile (64),
a tile edge (65, 129) and several query chunks (300); bf16 inputs go to
JAX as the fp32 values of the same bf16 numbers, since the plain versions
compute in fp32 and round only their outputs to the input type.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (
    mha_reference_bwd, mha_reference_no_custom_vjp)

from ivideogpt_tpu_torch import _build
from ivideogpt_tpu_torch.ops.flash_attention import (_library,
                                                     flash_bwd_dkv_plain,
                                                     flash_bwd_dq_plain,
                                                     flash_fwd_plain)

B, H, HD = 2, 3, 64
SCALE = HD ** -0.5   # a power of two: q * SCALE is exact in bf16 and fp32
DT = {"fp32": torch.float32, "bf16": torch.bfloat16}
# fp32: one algorithm, sums in another order. bf16: the same fp32 math on
# the same numbers, the output rounded once to bf16 (half an ulp is 2^-9 of
# the value); lse stays fp32.
TOL = {"fp32": dict(rtol=1e-5, atol=2e-5), "bf16": dict(rtol=4e-3, atol=2e-5)}
LSE_TOL = dict(rtol=0, atol=2e-5)


def _inputs(S, dt, seed):
    """q, k, v, dO [B, S, H, HD] as torch tensors in dt, and their values
    as fp32 [B, H, S, HD] arrays for JAX."""
    rng = np.random.default_rng(seed)
    ts = [torch.tensor(rng.normal(size=(B, S, H, HD)).astype(np.float32))
          .to(DT[dt]) for _ in range(4)]
    return ts, [jnp.asarray(t.float().transpose(1, 2).numpy()) for t in ts]


def _jax_forward(q, k, v):
    return mha_reference_no_custom_vjp(q, k, v, causal=True, sm_scale=SCALE,
                                       save_residuals=True)


def _bshd(x):
    return np.swapaxes(np.asarray(x, np.float32), 1, 2)


@pytest.mark.parametrize("S", [1, 64, 65, 129, 300])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_flash_fwd_plain_matches_stock_reference(S, dt):
    (q, k, v, _), (jq, jk, jv, _) = _inputs(S, dt, seed=S)
    out, l, m = _jax_forward(jq, jk, jv)
    o, lse = flash_fwd_plain(q, k, v)
    assert o.shape == q.shape and o.dtype == DT[dt]
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), _bshd(out), **TOL[dt])
    np.testing.assert_allclose(lse.numpy(), np.asarray(m + jnp.log(l)),
                               **LSE_TOL)


@pytest.mark.parametrize("S", [1, 64, 65, 129, 300])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("kernel", ["dkv", "dq"])
def test_flash_bwd_plain_matches_stock_reference(S, dt, kernel):
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(S, dt, seed=S + 1)
    out, l, m = _jax_forward(jq, jk, jv)
    # mha_reference_bwd takes sm_scale 1.0 only: it gets q * SCALE, so its
    # dQ is the gradient by the scaled q, SCALE^-1 times K6's
    jdq, jdk, jdv, _ = mha_reference_bwd(jq * SCALE, jk, jv, None, None, out,
                                         l, m, jdo, causal=True)
    lse = torch.tensor(np.asarray(m + jnp.log(l)))
    di = torch.tensor(np.asarray(jnp.sum(out * jdo, axis=-1)))   # [B, H, S]
    if kernel == "dkv":
        got = flash_bwd_dkv_plain(q, k, v, do, lse, di)
        want = (jdk, jdv)
    else:
        got = (flash_bwd_dq_plain(q, k, v, do, lse, di),)
        want = (jdq * SCALE,)
    for ours, theirs in zip(got, want):
        assert ours.shape == q.shape and ours.dtype == DT[dt]
        np.testing.assert_allclose(ours.float().numpy(), _bshd(theirs),
                                   **TOL[dt])


def test_plain_forward_and_backward_agree_with_autograd():
    """The three plain functions together are the gradient of the chunked
    causal_attention_plain, by autograd, on inputs longer than a chunk."""
    from ivideogpt_tpu_torch.ops.flash_attention import causal_attention_plain
    (q, k, v, do), _ = _inputs(200, "fp32", seed=7)
    o, lse = flash_fwd_plain(q, k, v)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = causal_attention_plain(*ins, torch.float32)
    torch.testing.assert_close(o.flatten(2), ref.detach(), rtol=1e-5,
                               atol=1e-5)
    grads = torch.autograd.grad(ref, ins, do.flatten(2))
    di = (o * do).sum(-1).transpose(1, 2).contiguous()
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, di)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, di)
    for ours, theirs in zip((dq, dk, dv), grads):
        torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("kernel", ["fwd", "bwd_dkv", "bwd_dq"])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_entry_points_by_dtype(kernel, dt):
    """bf16 K4, K5 and K6 are the TMA + wgmma kernels of
    flash_attention_sm90.cu; the fp32 K4, K5 and K6 the TMA + three-term
    TF32 wgmma kernels of flash_attention_tf32.cu. Decided without loading
    a library."""
    lib, sym = _library(kernel, DT[dt])
    if dt == "bf16":
        assert (lib, sym) == ("flash_attention_sm90",
                              f"ivg_flash_{kernel}_bf16")
    else:
        assert (lib, sym) == ("flash_attention_tf32",
                              f"ivg_flash_{kernel}_fp32")
    assert lib in _build.SOURCES
    # each symbol is defined by its library's source, and only there
    for name in ("flash_attention_sm90", "flash_attention_tf32"):
        with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
            defined = f'extern "C" int {sym}(' in f.read()
        assert defined == (name == lib), (name, sym)
