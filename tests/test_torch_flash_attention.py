"""``ops.flash_attention.causal_attention`` of the PyTorch port, on the CPU
(its plain version; the CUDA kernels K4/K5/K6 are held against the same
plain version on the card by tests/test_torch_gpu_kernels.py and
chip_smoke.py), against two JAX references, output and gradients:

- ``_prefill_causal_attention`` (``ivideogpt_tpu/models/llama.py:63``), the
  JAX package's default, differentiated by ``jax.grad``;
- the stock kernel's reference ``mha_reference`` with ``causal=True`` and its
  custom VJP ``mha_reference_bwd`` (jax/experimental/pallas/ops/tpu/
  flash_attention.py:1530, :1615), the math that K4/K5/K6 compute.

S covers one row, a tile edge (127, 128, 129) and several query chunks (300).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

from ivideogpt_tpu.models.llama import _prefill_causal_attention
from ivideogpt_tpu_torch.ops.flash_attention import (causal_attention,
                                                     causal_attention_plain)

B, H, HD = 2, 3, 64
DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(S, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, HD)).astype(np.float32)
            for _ in range(4)]  # q, k, v, dO


def _jax_prefill(q, k, v, do, jdt):
    def f(q, k, v):
        out = _prefill_causal_attention(q, k, v, jdt).astype(jnp.float32)
        return jnp.sum(out * do.reshape(B, -1, H * HD)), out
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return out, grads


def _jax_mha_reference(q, k, v, do, jdt):
    def to_bhsd(x):
        return jnp.moveaxis(x, 2, 1)

    def f(q, k, v):
        # its backward takes sm_scale 1.0 only: scale q before the call
        out = mha_reference(to_bhsd(q * jnp.asarray(HD ** -0.5, jdt)),
                            to_bhsd(k), to_bhsd(v), None, causal=True)
        out = jnp.moveaxis(out, 1, 2).reshape(B, -1, H * HD)
        out = out.astype(jnp.float32)
        return jnp.sum(out * do.reshape(B, -1, H * HD)), out
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return out, grads


REFS = {"prefill": _jax_prefill, "mha_reference": _jax_mha_reference}


@pytest.mark.parametrize("S", [1, 127, 128, 129, 300])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("ref", sorted(REFS))
def test_causal_attention_matches_jax(S, dt, ref):
    jdt, tdt = DT[dt]
    q, k, v, do = _inputs(S, seed=S)
    ref_out, ref_grads = REFS[ref](*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                   jnp.asarray(do, jdt), jdt)
    tq, tk, tv = (torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v))
    out = causal_attention(tq, tk, tv, tdt)
    assert out.shape == (B, S, H * HD) and out.dtype == tdt
    grads = torch.autograd.grad(out.float(), (tq, tk, tv),
                                torch.tensor(do).to(tdt).float()
                                .reshape(B, S, H * HD))
    if dt == "fp32":
        # one algorithm in fp32, sums in another order
        tol = dict(rtol=0, atol=1e-5)
    elif ref == "prefill":
        # the same bf16 rounding points (scores and P rounded to bf16); the
        # two frameworks round bf16 matmul sums at other places: a few bf16
        # ulps of O(1) values (measured up to 8.3e-3)
        tol = dict(rtol=1e-2, atol=1.6e-2)
    else:
        # mha_reference keeps bf16 logits and weights at other points than
        # the port's plain version: bf16 ulps of O(1) values, compounded
        # through the backward's products (measured up to 3.1e-2)
        tol = dict(rtol=2e-2, atol=4e-2)
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(ref_out, np.float32), **tol)
    for name, ours, theirs in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(theirs, np.float32),
                                   err_msg=f"d{name}", **tol)


def test_cpu_path_is_the_plain_version():
    q, k, v, _ = (torch.tensor(x) for x in _inputs(129, seed=0))
    torch.testing.assert_close(causal_attention(q, k, v, torch.float32),
                               causal_attention_plain(q, k, v, torch.float32),
                               rtol=0, atol=0)
