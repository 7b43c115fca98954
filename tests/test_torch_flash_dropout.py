"""Attention dropout in the port's plain attention (the CPU path; K4, K5 and
K6 are held against these on the card), on the CPU:

- p = 0 is bit-equal to no dropout, in every plain version;
- the plain versions give the same result whatever their chunk size (the
  mask is drawn by index);
- ``flash_bwd_dkv_plain`` and ``flash_bwd_dq_plain`` with dropout against
  autograd through the explicit-mask formula softmax -> P Z / keep -> V;
- the tiny LM's loss and every gradient at p = 0.1 against the JAX model at
  ``deterministic=False``, whose ``nn.Dropout`` is handed the port's masks
  through a patched ``jax.random.bernoulli`` (flax draws its mask with it,
  ``flax/linen/stochastic.py``), one [B, H, S, S] mask per layer in call
  order;
- a remat recompute draws the same masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu_torch.models.action_model import \
    HeadModelWithAction as TorchHead
from ivideogpt_tpu_torch.ops import flash_attention as fa
from ivideogpt_tpu_torch.ops import philox
from ivideogpt_tpu_torch.utils import checkpoint as port_ckpt
from tests.test_torch_checkpoint import LM_TINY, make_lm
from tests.test_torch_train import _batch

DROP = (0.1, 1234, philox.offset_of(17, 1))


def _qkv(B=2, S=70, H=3, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, S, H, hd))
                             .astype(np.float32)) for _ in range(4)]


def test_p0_is_bit_equal_to_no_dropout():
    q, k, v, do = _qkv()
    zero = (0.0, 5, 6)
    assert torch.equal(fa.causal_attention_plain(q, k, v, torch.float32),
                       fa.causal_attention_plain(q, k, v, torch.float32,
                                                 dropout=zero))
    o, lse = fa.flash_fwd_plain(q, k, v)
    o0, lse0 = fa.flash_fwd_plain(q, k, v, zero)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    di = (o * do).sum(-1).transpose(1, 2).contiguous()
    for f in (fa.flash_bwd_dkv_plain, fa.flash_bwd_dq_plain):
        a, b = f(q, k, v, do, lse, di), f(q, k, v, do, lse, di, zero)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_plain_versions_do_not_depend_on_their_chunk(chunk):
    q, k, v, do = _qkv()
    ref_o, ref_lse = fa.flash_fwd_plain(q, k, v, DROP)
    o, lse = fa.flash_fwd_plain(q, k, v, DROP, chunk=chunk)
    # the same mask; fp32 sums over other key ranges
    torch.testing.assert_close(o, ref_o, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-6, atol=1e-6)
    di = (ref_o * do).sum(-1).transpose(1, 2).contiguous()
    for a, b in zip(fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, di, DROP),
                    fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, di, DROP,
                                           chunk=chunk)):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, di, DROP, chunk=chunk),
        fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, di, DROP),
        rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        fa.causal_attention_plain(q, k, v, torch.float32, chunk=chunk,
                                  dropout=DROP),
        fa.causal_attention_plain(q, k, v, torch.float32, dropout=DROP),
        rtol=1e-6, atol=1e-6)


def _explicit(q, k, v, drop):
    """softmax(q k^T / sqrt(hd), causal) * Z / keep, times V: [B, S, H, hd]."""
    B, S, H, hd = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    z = philox.keep_mask(drop, B, H, S, 0, S, 0, S)
    return torch.einsum("bhqk,bkhd->bqhd", p * z / (1 - drop[0]), v)


def test_plain_backward_matches_autograd_of_the_explicit_mask():
    q, k, v, do = _qkv(S=45, seed=1)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    o = _explicit(*ins, DROP)
    want = torch.autograd.grad(o, ins, do)
    fo, lse = fa.flash_fwd_plain(q, k, v, DROP)
    torch.testing.assert_close(fo, o.detach(), rtol=1e-5, atol=1e-6)
    di = (fo * do).sum(-1).transpose(1, 2).contiguous()
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, di, DROP)
    dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, di, DROP)
    for got, ref, what in zip((dq, dk, dv), want, "qkv"):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5,
                                   msg=f"d{what}")
    # and causal_attention's CPU path, whose gradient is autograd's
    ins2 = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.causal_attention(*ins2, torch.float32, DROP)
    torch.testing.assert_close(out, o.detach().flatten(2), rtol=1e-5,
                               atol=1e-6)
    for got, ref in zip(torch.autograd.grad(out, ins2, do.flatten(2)), want):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def dropout_lm():
    return make_lm(lm_cfg=LM_TINY.replace(attention_dropout=0.1), seed=4,
                   reward_prediction=True, action_recon=0.5)


def _port_masks(cfg, B, S, seed, step):
    H = cfg.num_attention_heads
    return [philox.keep_mask((cfg.attention_dropout, seed,
                              philox.offset_of(step, i)), B, H, S, 0, S, 0,
                             S).numpy()
            for i in range(cfg.num_hidden_layers)]


def _patched_bernoulli(monkeypatch, masks, calls):
    """flax's Dropout draws its mask with jax.random.bernoulli(rng, keep,
    shape): hand it the port's masks, layer by layer."""
    def bernoulli(key, p=0.5, shape=None):
        mask = masks[len(calls)]
        assert tuple(shape) == mask.shape and abs(float(p) - 0.9) < 1e-12
        calls.append(shape)
        return jnp.asarray(mask)
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)


def test_tiny_lm_with_dropout_matches_jax_fed_the_same_masks(dropout_lm,
                                                             monkeypatch):
    """Loss and every gradient at p = 0.1, the JAX model at
    deterministic=False with the port's masks. fp32 on both sides; sums in
    another order: the loss within 1e-5, a gradient within 1e-4 of its
    max."""
    model, params, port = dropout_lm
    cfg = port.llm_config
    ids, labels, act = _batch(5)
    B, S = ids.shape
    seed, step = 99, 12
    masks = _port_masks(cfg, B, S, seed, step)
    assert not all(m.all() for m in masks)
    calls = []
    _patched_bernoulli(monkeypatch, masks, calls)

    def jax_loss(p):
        return model.apply(p, jnp.asarray(ids.numpy(), jnp.int32),
                           jnp.asarray(labels.numpy(), jnp.int32),
                           jnp.asarray(act), deterministic=False,
                           rngs={"dropout": jax.random.key(0)})["loss"]
    loss, jgrads = jax.value_and_grad(jax_loss)(params)
    assert len(calls) == cfg.num_hidden_layers   # one mask a layer, in order
    ref = port_ckpt.action_model_state_dict(
        jax.tree_util.tree_map(np.asarray, jgrads))

    port.train()
    port.zero_grad(set_to_none=True)
    out = port(ids, labels, torch.from_numpy(act), dropout_key=(seed, step))
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(loss),
                               rtol=1e-5)
    # the masks matter: without dropout the loss is another
    port.eval()
    with torch.no_grad():
        assert abs(float(port(ids, labels, torch.from_numpy(act))["loss"])
                   - float(loss)) > 1e-4
    for name, p in port.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        want = ref[name].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * scale + 1e-12, err_msg=name)


def test_remat_recompute_draws_the_same_masks(dropout_lm):
    _, _, port = dropout_lm
    ids, labels, act = _batch(6)
    remat = TorchHead(port.llm_config.replace(remat=True), port.head_config)
    remat.load_state_dict(port.state_dict())
    grads = []
    for m in (remat, port):
        m.train()
        m.zero_grad(set_to_none=True)
        m(ids, labels, torch.from_numpy(act), dropout_key=(3, 4))["loss"] \
            .backward()
        grads.append({n: p.grad.clone() for n, p in m.named_parameters()
                      if p.grad is not None})
    for name, g in grads[0].items():
        torch.testing.assert_close(g, grads[1][name], rtol=1e-6, atol=1e-9,
                                   msg=name)


def test_dropout_follows_the_step_and_stops_in_eval(dropout_lm):
    _, _, port = dropout_lm
    ids, labels, act = _batch(7)
    a = torch.from_numpy(act)
    port.train()
    with torch.no_grad():
        l1 = port(ids, labels, a, dropout_key=(1, 1))["loss"]
        l1b = port(ids, labels, a, dropout_key=(1, 1))["loss"]
        l2 = port(ids, labels, a, dropout_key=(1, 2))["loss"]
        port.eval()
        e1 = port(ids, labels, a, dropout_key=(1, 1))["loss"]
        e2 = port(ids, labels, a)["loss"]
    assert torch.equal(l1, l1b) and not torch.equal(l1, l2)
    assert torch.equal(e1, e2)
