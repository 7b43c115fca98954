"""Token-stream contract of the PyTorch port: exact equality with the JAX
package's functions at ctx 1 and 2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu import tokens as jtok
from ivideogpt_tpu_torch import tokens as ttok

NV, ND = 8192, 8192


@pytest.mark.parametrize("ctx", [1, 2])
def test_lengths(ctx):
    for T in (ctx + 1, 8, 16):
        assert ttok.seq_len(ctx, T) == jtok.seq_len(ctx, T)
        assert ttok.max_new_tokens(ctx, T) == jtok.max_new_tokens(ctx, T)
        assert ttok.seq_len(ctx, T, 64, 4) == jtok.seq_len(ctx, T, 64, 4)
    assert ttok.prelude_len(ctx) == jtok.prelude_len(ctx)
    np.testing.assert_array_equal(
        ttok.sdf_positions(ctx, 16).numpy(), np.asarray(jtok.sdf_positions(ctx, 16)))
    np.testing.assert_array_equal(
        ttok.sdf_positions(ctx, 7, 64, 4).numpy(),
        np.asarray(jtok.sdf_positions(ctx, 7, 64, 4)))


@pytest.mark.parametrize("ctx", [1, 2])
def test_assemble_prelude_disassemble(ctx):
    rng = np.random.default_rng(ctx)
    B, T = 3, 16
    c = rng.integers(0, NV, (B, ctx, 256))
    d = rng.integers(0, ND, (B, T - ctx, 16))
    ti, tl = ttok.assemble(torch.from_numpy(c), torch.from_numpy(d), NV, ND)
    ji, jl = jtok.assemble(jnp.asarray(c, jnp.int32), jnp.asarray(d, jnp.int32),
                           NV, ND)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert ti.shape[1] == ttok.seq_len(ctx, T)

    tp = ttok.make_prelude(torch.from_numpy(c), NV, ND)
    jp = jtok.make_prelude(jnp.asarray(c, jnp.int32), NV, ND)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tp.numpy(), ti[:, :tp.shape[1]].numpy())

    tc, td = ttok.disassemble(ti, ctx, NV, ND)
    np.testing.assert_array_equal(tc.numpy(), c)
    np.testing.assert_array_equal(td.numpy(), d)

    # an LM-sampled stream may carry any vocab id in any slot: both clamp
    wild = rng.integers(0, NV + ND + 2, ti.shape)
    tc, td = ttok.disassemble(torch.from_numpy(wild), ctx, NV, ND)
    jc, jd = jtok.disassemble(jnp.asarray(wild, jnp.int32), ctx, NV, ND)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_disassemble_rejects_bad_length():
    with pytest.raises(ValueError):
        ttok.disassemble(torch.zeros((1, 750), dtype=torch.int64), 2, NV, ND)
