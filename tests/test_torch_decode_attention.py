"""Int8 decode attention of the PyTorch port: the plain version of kernel K3
against the JAX package's Pallas kernel (interpret mode) and its XLA oracle,
after moving the port's ``bshd`` cache into the TPU's [B*H, hd, M] layout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu.ops.decode_attention import (decode_attention,
                                                decode_attention_xla)
from ivideogpt_tpu_torch.ops import decode_attention as tda

B, H, HD, M = 2, 4, 64, 256


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, H, HD)).astype(np.float32))
    k = torch.from_numpy(rng.integers(-127, 128, (B, M, H, HD)).astype(np.int8))
    v = torch.from_numpy(rng.integers(-127, 128, (B, M, H, HD)).astype(np.int8))
    ks = torch.from_numpy(rng.uniform(0.001, 0.02, (B, M, H)).astype(np.float32))
    vs = torch.from_numpy(rng.uniform(0.001, 0.02, (B, M, H)).astype(np.float32))
    return q.bfloat16(), k, ks.bfloat16(), v, vs.bfloat16()


def _to_ghdm(q, k, ks, v, vs):
    """bshd -> the TPU kernel's layout: q [G, hd], K/V [G, hd, M], s [G, M]."""
    def bf16(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    kv = lambda t: jnp.asarray(t.numpy().transpose(0, 2, 3, 1).reshape(B * H, HD, M))
    sc = lambda t: bf16(t.transpose(1, 2).reshape(B * H, M))
    return bf16(q.reshape(B * H, HD)), kv(k), sc(ks), kv(v), sc(vs)


@pytest.mark.parametrize("valid", [1, 127, 129, M])
def test_plain_matches_pallas_and_xla(valid):
    q, k, ks, v, vs = _inputs(valid)
    ours = tda.decode_attention(q, k, ks, v, vs, valid)   # CPU: plain version
    assert ours.dtype == torch.bfloat16 and ours.shape == (B, H, HD)
    ours = ours.float().numpy().reshape(B * H, HD)
    g = _to_ghdm(q, k, ks, v, vs)
    for ref in (decode_attention(*g, valid, tg=8, tm=128, interpret=True),
                decode_attention_xla(*g, valid)):
        np.testing.assert_allclose(ours, np.asarray(ref, np.float32),
                                   rtol=2e-2, atol=2e-3)


def test_dead_slots_are_ignored():
    q, k, ks, v, vs = _inputs(0)
    a = tda.decode_attention_plain(q, k, ks, v, vs, 100)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] = 127
    v2[:, 100:] = -127
    b = tda.decode_attention_plain(q, k2, ks, v2, vs, 100)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _inputs_at(seed, b, dtype):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, H, HD)).astype(np.float32))
    k, v = (torch.from_numpy(rng.integers(-127, 128, (b, M, H, HD))
                             .astype(np.int8)) for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.001, 0.02, (b, M, H))
                               .astype(np.float32)).bfloat16()
              for _ in range(2))
    return q.to(dtype), k, ks, v, vs


def _jax_layout(q, k, ks, v, vs):
    """bshd -> the TPU kernel's layout, q keeping its dtype."""
    b = q.shape[0]
    kv = lambda t: jnp.asarray(
        t.numpy().transpose(0, 2, 3, 1).reshape(b * H, HD, M))
    sc = lambda t: jnp.asarray(
        t.float().transpose(1, 2).reshape(b * H, M).numpy(), jnp.bfloat16)
    qj = jnp.asarray(q.float().reshape(b * H, HD).numpy(),
                     jnp.bfloat16 if q.dtype == torch.bfloat16
                     else jnp.float32)
    return qj, kv(k), sc(ks), kv(v), sc(vs)


# valid at 1, at M, at the edges (+-1) of the 16-slot splits the plan makes
# at M=256 and of 3 splits of 96 slots and 8 of 32, and with trailing empty
# splits in every plan
@pytest.mark.parametrize("valid", [1, 15, 16, 17, 31, 33, 95, 97, M])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 3])
def test_split_plain_matches_plain_pallas_and_xla(b, dtype, valid):
    q, k, ks, v, vs = _inputs_at(100 + valid, b, dtype)
    plain = tda.decode_attention_plain(q, k, ks, v, vs, valid)
    g = _jax_layout(q, k, ks, v, vs)
    refs = (decode_attention(*g, valid, tg=b * H, tm=128, interpret=True),
            decode_attention_xla(*g, valid))
    # bf16: fp32 sums in another order, then a bf16 rounding (one ulp);
    # fp32: the sums' order alone
    tol = dict(rtol=2e-2, atol=2e-3) if dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-5)
    assert tda.split_len(M, tda.decode_splits(b, H, M)) == 16
    for splits in (None, 3, 8):
        ours = tda.decode_attention_split_plain(q, k, ks, v, vs, valid,
                                                splits=splits)
        assert ours.dtype == dtype and ours.shape == (b, H, HD)
        torch.testing.assert_close(ours, plain, **tol)
        for ref in refs:
            np.testing.assert_allclose(
                ours.float().numpy().reshape(b * H, HD),
                np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("valid", [1, 100, M])
def test_cpu_wrapper_takes_a_valid_tensor(valid):
    q, k, ks, v, vs = _inputs(valid)
    want = tda.decode_attention(q, k, ks, v, vs, valid)
    for fn in (tda.decode_attention, tda.decode_attention_split_plain):
        got = fn(q, k, ks, v, vs, torch.tensor([valid], dtype=torch.int32))
        torch.testing.assert_close(got, fn(q, k, ks, v, vs, valid),
                                   rtol=0, atol=0)
    torch.testing.assert_close(
        tda.decode_attention(q, k, ks, v, vs,
                             torch.tensor([valid], dtype=torch.int32)),
        want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tda.decode_attention(q, k, ks, v, vs,
                             torch.tensor([valid], dtype=torch.int64))


def test_a_graph_replay_counts_the_launches_its_capture_recorded():
    """capture_launches yields the Counter a capture records into and
    closes it after; count_replay adds a replay's launches to the wrapper's
    counters by name."""
    fn = tda.decode_attention
    names = ("launches", "grouped_launches", "mixed_launches")
    before = tuple(getattr(fn, n) for n in names)
    with tda.capture_launches() as rec:
        assert rec == {} and tda._capture.launches is rec
        rec["launches"] += 12
        rec["mixed_launches"] += 2
    assert tda._capture.launches is None
    tda.count_replay(rec)
    tda.count_replay(rec)
    assert tuple(getattr(fn, n) - b for n, b in zip(names, before)) == (
        24, 0, 4)
