"""The LLaMA's KV-cache variants in the port against the JAX package, fp32
models at LM_TINY's widths (4 query heads, 2 layers):

- grouped KV heads (``num_key_value_heads`` 2 and 1): the training
  forward's logits and loss, and every gradient through the repeat of K
  and V across each head group (autograd sums each group, as ``jax.grad``
  through ``jnp.repeat`` does); fp32 in another summation order, 1e-5;
- ``generation.replay_logits`` (prefill + one-token decodes) over bf16,
  int8 and ``"mixed"`` caches, grouped and not: 1e-3 (as
  ``tests/test_torch_llama.py``: an int8 or bf16 rounding of k/v that
  differ in their last fp32 bits);
- a multi-token cached step at a nonzero index over each cache dtype,
  attending over the cache as written (quantized, the new tokens
  included), then a one-token step after it: 1e-3 on the hidden states;
- ``init_cache``: JAX's entries, shapes and dtypes;
- K3's plain versions (what the CPU runs) for both new variants: a
  grouped cache gives the multi-head answer over the cache repeated, bit
  for bit, and the split-then-merge plain version agrees with the plain
  one to fp32 rounding, mixed and grouped;
- a one-token step with its position on the device (the CUDA graph's
  form) leaves every cache tensor and the hidden output bit-identical to
  the host int's step, over each cache dtype at three positions;
- ``generation._graphed``, the rule that graphs generate's LM step: on a
  CUDA device over an int8 or mixed cache, without a tensor-parallel
  group, read from the device and the cache's entries alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu import generation as jgen
from ivideogpt_tpu.models.llama import LlamaForCausalLM as JaxLlama
from ivideogpt_tpu_torch import generation as tgen
from ivideogpt_tpu_torch import tokens as ttok
from ivideogpt_tpu_torch.models.llama import LlamaForCausalLM
from ivideogpt_tpu_torch.ops import decode_attention as da
from ivideogpt_tpu_torch.utils import checkpoint as port_ckpt
from tests.test_tokenizer_model import TINY
from tests.test_torch_checkpoint import (LM_TINY, jitter, make_lm,
                                         port_config, to_numpy_tree)

torch.set_num_threads(2)

CTX, T = 2, 5
NCTX, NDYN = TINY.ctx_tokens_per_frame, TINY.dyn_tokens_per_frame
CACHES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8),
          "mixed": ("mixed", "mixed")}


def _cfg(kv):
    return dataclasses.replace(LM_TINY, num_key_value_heads=kv)


def _llama(kv, seed=3):
    """(JAX model, numpy params, the port's model with the same weights)."""
    cfg = _cfg(kv)
    model = JaxLlama(cfg)
    params = jax.jit(model.init)(jax.random.key(seed),
                                 jnp.zeros((1, 8), jnp.int32))
    params = jitter(to_numpy_tree(params), seed)
    port = LlamaForCausalLM(port_config(cfg))
    port.load_state_dict(port_ckpt.llama_state_dict(params), strict=True)
    return model, params, port.eval()


@pytest.mark.parametrize("kv", [2, 1])
def test_grouped_forward_and_gradients_match_jax(kv):
    model, params, port = _llama(kv)
    assert port.model.layers[0].self_attn.k_proj.weight.shape == (16 * kv,
                                                                  64)
    ids = np.random.default_rng(kv).integers(0, LM_TINY.vocab_size, (2, 19))

    def loss_fn(p):
        out = model.apply(p, jnp.asarray(ids), labels=jnp.asarray(ids))
        return out["loss"], out["logits"]
    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    out = port(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    out["loss"].backward()
    np.testing.assert_allclose(out["logits"].detach().numpy(),
                               np.asarray(logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["loss"].item(), float(loss), rtol=1e-6)
    ref = port_ckpt.llama_state_dict(to_numpy_tree(grads))
    for name, p in port.named_parameters():
        g, r = p.grad.numpy(), ref[name].numpy()
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


def _stream(seed, B=2):
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(rng.integers(0, TINY.num_vq_embeddings,
                                      (B, CTX, NCTX)))
    d = torch.from_numpy(rng.integers(0, TINY.num_dyn_embeddings,
                                      (B, T - CTX, NDYN)))
    ids, _ = ttok.assemble(c, d, TINY.num_vq_embeddings,
                           TINY.num_dyn_embeddings)
    return ids, rng.normal(size=(B, T, 4)).astype(np.float32)


@pytest.mark.parametrize("kv,cache", [
    (2, "bf16"), (2, "int8"), (2, "mixed"), (1, "bf16"), (1, "int8"),
    (1, "mixed"), (4, "mixed")])
def test_replay_logits_match_jax(kv, cache):
    model, params, port = make_lm(lm_cfg=_cfg(kv), ctx=CTX, T=T, seed=1)
    ids, act = _stream(kv)
    jdt, tdt = CACHES[cache]
    ref = jgen.replay_logits(model, params, jnp.asarray(ids.numpy(),
                                                        jnp.int32),
                             segment_length=T, context_length=CTX,
                             action=jnp.asarray(act), tokens_per_dyna=NDYN,
                             cache_dtype=jdt)
    ours = tgen.replay_logits(port, ids, segment_length=T, context_length=CTX,
                              action=torch.from_numpy(act),
                              tokens_per_dyna=NDYN, cache_dtype=tdt)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("kv", [4, 2])
@pytest.mark.parametrize("cache", ["bf16", "int8", "mixed"])
def test_multi_token_step_at_nonzero_index_matches_jax(cache, kv):
    model, params, port = _llama(kv, seed=5)
    jdt, tdt = CACHES[cache]
    B, M = 2, 16
    rng = np.random.default_rng(7)
    emb = rng.normal(0, 1, (B, 13, LM_TINY.hidden_size)).astype(np.float32)
    jcache = model.apply(params, B, M, jdt, method=model.init_cache)
    tcache = port.init_cache(B, M, tdt, device="cpu")
    # prefill 7 at 0, 3 tokens at 7, 2 at 10, then one at 12
    for lo, hi in ((0, 7), (7, 10), (10, 12), (12, 13)):
        jh, jcache = model.apply(params, jnp.asarray(emb[:, lo:hi]), jcache,
                                 lo, method=model.forward_cached)
        with torch.no_grad():
            th, tcache = port.forward_cached(torch.from_numpy(emb[:, lo:hi]),
                                             tcache, lo)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-3,
                                   rtol=1e-3, err_msg=f"step at {lo}")


@pytest.mark.parametrize("kv", [4, 2, 1])
@pytest.mark.parametrize("cache", ["bf16", "int8", "mixed"])
def test_init_cache_matches_jax(cache, kv):
    model, params, port = _llama(kv)
    jdt, tdt = CACHES[cache]
    ours = port.init_cache(3, 9, tdt, device="cpu")
    theirs = model.apply(params, 3, 9, jdt, method=model.init_cache)
    assert len(ours) == len(theirs) == LM_TINY.num_hidden_layers
    for i, layer in enumerate(ours):
        ref = theirs[f"layers_{i}"]
        assert sorted(layer) == sorted(ref)
        for k, v in layer.items():
            assert tuple(v.shape) == ref[k].shape
            assert str(v.dtype).split(".")[-1] == str(ref[k].dtype)
            assert not v.any()


def _k3_inputs(B, H, kv, M, mixed, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, 64, generator=g)
    k = (torch.randn(B, M, kv, 64, generator=g).bfloat16() if mixed else
         torch.randint(-127, 128, (B, M, kv, 64), generator=g,
                       dtype=torch.int8))
    v = torch.randint(-127, 128, (B, M, kv, 64), generator=g,
                      dtype=torch.int8)
    ks = None if mixed else (torch.rand(B, M, kv, generator=g) * 0.02
                             + 0.001).bfloat16()
    vs = (torch.rand(B, M, kv, generator=g) * 0.02 + 0.001).bfloat16()
    return q, k, ks, v, vs


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("kv", [4, 1])
def test_k3_plain_versions_of_the_variants(mixed, kv):
    B, H, M, valid = 3, 12, 100, 77
    q, k, ks, v, vs = _k3_inputs(B, H, kv, M, mixed, seed=kv)
    out = da.decode_attention(q, k, ks, v, vs, valid)   # the CPU: plain
    rep = H // kv
    full = da.decode_attention_plain(
        q, k.repeat_interleave(rep, 2),
        None if mixed else ks.repeat_interleave(rep, 2),
        v.repeat_interleave(rep, 2), vs.repeat_interleave(rep, 2), valid)
    assert torch.equal(out, full)
    for splits in (1, 3, 7):
        split = da.decode_attention_split_plain(q, k, ks, v, vs, valid,
                                                splits)
        torch.testing.assert_close(split, out, rtol=1e-5, atol=1e-6)
    # the mixed scores: fp32 q . K without a K scale
    if mixed:
        s = torch.einsum("bhd,bmhd->bhm", q,
                         k[:, :valid].float().repeat_interleave(rep, 2))
        p = torch.softmax(s * 64 ** -0.5, -1) * vs[:, :valid].float(
            ).repeat_interleave(rep, 2).transpose(1, 2)
        ref = torch.einsum("bhm,bmhd->bhd", p, v[:, :valid].float(
            ).repeat_interleave(rep, 2))
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("at", [7, 9, 15])
@pytest.mark.parametrize("cache", ["bf16", "int8", "mixed"])
def test_step_at_a_device_position_equals_the_host_ints(cache, at):
    _, _, port = _llama(4, seed=6)
    B, M = 2, 16
    emb = torch.from_numpy(np.random.default_rng(at).normal(
        0, 1, (B, M, LM_TINY.hidden_size)).astype(np.float32))
    host = port.init_cache(B, M, CACHES[cache][1], device="cpu")
    with torch.no_grad():
        port.forward_cached(emb[:, :7], host, 0)
        for i in range(7, at):
            port.forward_cached(emb[:, i:i + 1], host, i)
        dev = [{k: v.clone() for k, v in layer.items()} for layer in host]
        want, _ = port.forward_cached(emb[:, at:at + 1], host, at)
        got, _ = port.forward_cached(emb[:, at:at + 1], dev,
                                     torch.tensor([at], dtype=torch.int32))
    assert torch.equal(got, want)
    for h, d in zip(host, dev):
        assert sorted(h) == sorted(d)
        for k in h:
            assert torch.equal(h[k], d[k]), k
    assert host[0]["k"][:, at].any()    # the step wrote its slot


@pytest.mark.parametrize("device,cache,tp,graphed", [
    ("cpu", "int8", False, False), ("cpu", "mixed", False, False),
    ("cuda", "bf16", False, False), ("cuda", "int8", True, False),
    ("cuda", "mixed", True, False), ("cuda", "int8", False, True),
    ("cuda:0", "mixed", False, True)])
def test_the_graph_rule(device, cache, tp, graphed):
    _, _, port = _llama(2)
    if tp:
        port.model.layers[1].mlp.tp_group = object()
    kv = port.init_cache(1, 4, CACHES[cache][1], device="cpu")
    assert tgen._graphed(port, kv, torch.device(device)) is graphed
