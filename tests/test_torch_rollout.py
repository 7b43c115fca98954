"""The port's main path, end to end on the CPU: context tokenize -> int8-KV
generate -> detokenize, held against the JAX package on the port's own
stream (never against a JAX stream drawn from the same seed):
- the stream has ``tokens.seq_len`` tokens and disassembles;
- JAX ``replay_logits`` on the stream matches the port's teacher-forced
  logits, and every sampled token lies in JAX's top-k set;
- JAX ``detokenize`` of the stream matches the port's frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu import generation as jgen
from ivideogpt_tpu_torch import generation as tgen
from ivideogpt_tpu_torch import rollout as trollout
from ivideogpt_tpu_torch import tokens as ttok
from tests.test_tokenizer_model import TINY
from tests.test_torch_checkpoint import make_lm, make_tokenizer

B, T, CTX, TOP_K = 3, 5, 2, 20
NCTX, NDYN = TINY.ctx_tokens_per_frame, TINY.dyn_tokens_per_frame


@pytest.fixture(scope="module")
def run():
    tok_model, tok_params, tok = make_tokenizer(TINY, seed=0, T=T)
    lm_model, lm_params, lm = make_lm(ctx=CTX, T=T, seed=1)
    rng = np.random.default_rng(5)
    px = rng.uniform(0, 1, (B, CTX, 32, 32, 3)).astype(np.float32)
    act = rng.normal(size=(B, T, 4)).astype(np.float32)
    res = trollout.rollout(tok, lm, torch.from_numpy(px),
                           torch.from_numpy(act), segment_length=T,
                           generator=torch.Generator().manual_seed(0),
                           cache_dtype=torch.int8, top_k=TOP_K, detok_chunk=2)
    return dict(tok_model=tok_model, tok_params=tok_params, tok=tok,
                lm_model=lm_model, lm_params=lm_params, lm=lm, px=px, act=act,
                res=res)


def test_stream_shape_and_ranges(run):
    res = run["res"]
    L = ttok.seq_len(CTX, T, NCTX, NDYN)
    assert res.tokens.shape == (B, L)
    assert res.frames.shape == (B, T, 32, 32, 3)
    assert torch.isfinite(res.frames).all()
    c, d = ttok.disassemble(res.tokens, CTX, TINY.num_vq_embeddings,
                            TINY.num_dyn_embeddings, NCTX, NDYN)
    assert c.shape == (B, CTX, NCTX) and d.shape == (B, T - CTX, NDYN)
    # the prelude is the context tokenization; sdf at every frame start
    with torch.no_grad():
        ctx_ids = run["tok"].encode_context(torch.from_numpy(run["px"]))
    np.testing.assert_array_equal(c.numpy(), ctx_ids.numpy())
    sdf = ttok.sdf_positions(CTX, T, NCTX, NDYN)
    assert (res.tokens[:, sdf] == TINY.sdf_token).all()


def test_jax_replay_matches_and_samples_lie_in_jax_top_k(run):
    res = run["res"]
    act = run["act"]
    ref = np.asarray(jgen.replay_logits(
        run["lm_model"], run["lm_params"],
        jnp.asarray(res.tokens.numpy(), jnp.int32), segment_length=T,
        context_length=CTX, action=jnp.asarray(act), tokens_per_dyna=NDYN,
        cache_dtype=jnp.int8))
    ours = tgen.replay_logits(run["lm"], res.tokens, segment_length=T,
                              context_length=CTX,
                              action=torch.from_numpy(act),
                              tokens_per_dyna=NDYN, cache_dtype=torch.int8)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-3, rtol=1e-3)

    P1 = (NCTX + 1) * CTX
    stream = res.tokens.numpy()
    for s in range(ref.shape[0]):
        if s % (NDYN + 1) == NDYN:
            continue  # a forced sdf, not sampled
        keys, kth = jgen.exact_kth_largest_key(jnp.asarray(ref[s]), TOP_K)
        keep = np.asarray(keys >= kth[:, None])
        assert keep[np.arange(B), stream[:, P1 + s]].all(), s


def test_jax_detokenize_matches_frames(run):
    m = run["tok_model"]
    ref = jax.jit(lambda p, i: m.apply(p, i, CTX, method=m.detokenize))(
        run["tok_params"], jnp.asarray(run["res"].tokens.numpy(), jnp.int32))
    np.testing.assert_allclose(run["res"].frames.numpy(), np.asarray(ref),
                               atol=1e-4, rtol=0)


def test_generate_rewards_and_actions_match_jax_forward():
    """Rewards are read after each frame's last dyn token, and each forced
    sdf carries its frame's action: with an fp32 cache, the port's
    generate must agree with the JAX training forward (uncached, actions
    added at every sdf slot) run on the port's own stream."""
    model, params, lm = make_lm(ctx=CTX, T=T, seed=2, reward_prediction=True)
    rng = np.random.default_rng(6)
    prelude = torch.from_numpy(rng.integers(0, TINY.num_vq_embeddings,
                                            (B, CTX, NCTX)))
    prelude = ttok.make_prelude(prelude, TINY.num_vq_embeddings,
                                TINY.num_dyn_embeddings)
    act = rng.normal(size=(B, T, 4)).astype(np.float32)
    res = tgen.generate(lm, prelude, segment_length=T, context_length=CTX,
                        generator=torch.Generator().manual_seed(2),
                        action=torch.from_numpy(act), tokens_per_dyna=NDYN,
                        top_k=TOP_K, reward_prediction=True,
                        cache_dtype=torch.float32)
    assert res.rewards.shape == (B, T - CTX)
    out = model.apply(params, jnp.asarray(res.tokens.numpy(), jnp.int32),
                      None, jnp.asarray(act))
    np.testing.assert_allclose(res.rewards.numpy(),
                               np.asarray(out["reward_pred"]), atol=1e-4,
                               rtol=1e-4)


def test_context_length_one_rollout():
    """The BAIR eval protocol's ctx=1 shape runs through the same path."""
    from ivideogpt_tpu_torch.configs import CompressiveVQConfig, TransformerConfig
    tok_cfg = CompressiveVQConfig.from_json(TINY.to_json())
    lm_cfg = TransformerConfig(vocab_size=tok_cfg.vocab_size, hidden_size=64,
                               intermediate_size=128, num_hidden_layers=2,
                               num_attention_heads=1, num_key_value_heads=1)
    tok, lm = trollout.build_models(tok_cfg, lm_cfg, context_length=1,
                                    segment_length=T, dtype=torch.float32,
                                    device="cpu")
    px = torch.rand(2, 1, 32, 32, 3)
    res = trollout.rollout(tok, lm, px, torch.randn(2, T, 4),
                           segment_length=T,
                           generator=torch.Generator().manual_seed(0))
    assert res.tokens.shape == (2, ttok.seq_len(1, T, NCTX, NDYN))
    assert res.frames.shape == (2, T, 32, 32, 3)
    assert torch.isfinite(res.frames).all()


def test_generate_counts_decode_steps(run, monkeypatch):
    """236 decodes at ctx=2, T=16 are 13 frames x 16 + 15 + 13 forced sdf;
    here at T=5 the same rule gives (T-ctx)*D - 1 + (T-ctx-1) decodes. On
    the CPU every one-token step runs eagerly: no graph is captured or
    replayed."""
    lm = run["lm"]
    calls = []
    orig = lm.decode_cached
    monkeypatch.setattr(lm, "decode_cached",
                        lambda e, c, i: calls.append(i) or orig(e, c, i))
    prelude = run["res"].tokens[:, :(NCTX + 1) * CTX]
    g = tgen.generate
    before = (g.graph_captures, g.graph_replays, g.eager_lm_steps)
    tgen.generate(lm, prelude, segment_length=T, context_length=CTX,
                  generator=torch.Generator().manual_seed(1),
                  tokens_per_dyna=NDYN, cache_dtype=torch.int8)
    F = T - CTX
    assert calls[0] == 0 and len(calls) - 1 == F * NDYN - 1 + (F - 1)
    assert (g.graph_captures, g.graph_replays, g.eager_lm_steps) == (
        before[0], before[1], before[2] + len(calls) - 1)
