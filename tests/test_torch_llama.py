"""LM and sampling of the PyTorch port against the JAX package: teacher-
forced logits under the bf16 and int8 caches match
``generation.replay_logits`` (fp32 models), and top-k keep-masks on
identical logits are identical, ties at the k-th value included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu import generation as jgen
from ivideogpt_tpu_torch import generation as tgen
from ivideogpt_tpu_torch import tokens as ttok
from tests.test_tokenizer_model import TINY
from tests.test_torch_checkpoint import make_lm

CTX, T = 2, 5
NCTX, NDYN = TINY.ctx_tokens_per_frame, TINY.dyn_tokens_per_frame


@pytest.fixture(scope="module")
def lm():
    return make_lm(ctx=CTX, T=T, seed=1)


def _stream(seed, B=2):
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(rng.integers(0, TINY.num_vq_embeddings, (B, CTX, NCTX)))
    d = torch.from_numpy(rng.integers(0, TINY.num_dyn_embeddings,
                                      (B, T - CTX, NDYN)))
    ids, _ = ttok.assemble(c, d, TINY.num_vq_embeddings, TINY.num_dyn_embeddings)
    act = rng.normal(size=(B, T, 4)).astype(np.float32)
    return ids, act


# bf16 cache: both packages round the same fp32 k/v to bf16, but those k/v
# differ in the last fp32 bits (matmul order), which can flip a bf16
# rounding; int8 cache: likewise an int8 rounding. Either moves a logit by
# far less than 1e-3 at these widths.
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_teacher_forced_logits_match_replay(lm, cache):
    model, params, port = lm
    ids, act = _stream(cache == "int8")
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "int8": (jnp.int8, torch.int8)}[cache]
    ref = jgen.replay_logits(model, params, jnp.asarray(ids.numpy(), jnp.int32),
                             segment_length=T, context_length=CTX,
                             action=jnp.asarray(act), tokens_per_dyna=NDYN,
                             cache_dtype=jdt)
    ours = tgen.replay_logits(port, ids, segment_length=T, context_length=CTX,
                              action=torch.from_numpy(act),
                              tokens_per_dyna=NDYN, cache_dtype=tdt)
    assert ours.shape == ref.shape == (ids.shape[1] - (NCTX + 1) * CTX + 1,
                                       ids.shape[0], TINY.vocab_size)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-3,
                               rtol=1e-3)


def _tied_logits(seed, B=4, V=300):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, V)).astype(np.float32)
    x[:, :40] = x[:, :1]          # a 40-way tie somewhere in each row
    x[0, 5:12] = 0.0
    x[1, 7:9] = -0.0
    return x


@pytest.mark.parametrize("k", [1, 10, 35, 100])
def test_top_k_keep_mask_matches_jax_with_ties(k):
    x = _tied_logits(k)
    keys, kth = jgen.exact_kth_largest_key(jnp.asarray(x), k)
    ref = np.asarray(keys >= kth[:, None])
    ours = tgen.top_k_keep_mask(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert (ours.sum(1) >= k).all()
    # bf16-exact logits, 16-bit search
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    keys, kth = jgen.exact_kth_largest_key_bf16(jnp.asarray(xb), k)
    ref = np.asarray(keys >= kth[:, None])
    ours = tgen.top_k_keep_mask(torch.from_numpy(xb), k, bf16_exact=True)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_sample_top_k_stays_in_the_set():
    x = torch.from_numpy(_tied_logits(0))
    g = torch.Generator().manual_seed(0)
    keep = tgen.top_k_keep_mask(x, 10)
    for _ in range(20):
        tok = tgen.sample_top_k(x, g, top_k=10)
        assert keep[torch.arange(x.shape[0]), tok].all()


def test_cast_matmul_params_rule(lm):
    _, _, port = lm
    from ivideogpt_tpu_torch.models.action_model import HeadModelWithAction
    bf = HeadModelWithAction(port.llm_config, port.head_config,
                             dtype=torch.bfloat16)
    bf.load_state_dict(port.state_dict())
    tgen.cast_matmul_params(bf)
    for name, p in bf.named_parameters():
        want = torch.bfloat16 if p.ndim >= 2 else torch.float32
        assert p.dtype == want, name
