"""The MBRL slice of the PyTorch port against the JAX package, on the CPU in
fp32 at TINY / a 2-layer LM (the VQ lookup and the attention ops take their
plain versions here; K1, K3 and K4-K6 are held against them on the card):

- the tokenizer's decode cache and single-frame decode;
- the DrQ-v2 policy mean through ``drqv2_state_dict``, the truncated-normal
  sample, the schedule DSL, symlog / symexp;
- the imagination rollout with replayed actions, for an fp32 and an int8
  KV cache: the port's own sampled tokens are rebuilt into the token
  stream and the JAX LM is run teacher-forced over it (never compared with
  a JAX rollout drawn from the same seed); the policy-driven rollout and
  ``expl_uniform``;
- one tokenizer step and one LM step against the JAX ``VideoPredictor``'s
  ``_tok_step`` / ``_model_step``, the frozen codebooks bit-unchanged in
  the port and moved by their clipped gradient in the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ivideogpt_tpu import generation as jgen
from ivideogpt_tpu.configs import ActionModelConfig
from ivideogpt_tpu.mbrl import drqv2 as jdrq
from ivideogpt_tpu.mbrl import utils as jutils
from ivideogpt_tpu.mbrl import video_predictor as jvp
from ivideogpt_tpu.train import optim as joptim
from ivideogpt_tpu_torch import tokens as ttok
from ivideogpt_tpu_torch.mbrl import drqv2 as tdrq
from ivideogpt_tpu_torch.mbrl import utils as tutils
from ivideogpt_tpu_torch.mbrl import video_predictor as tvp
from ivideogpt_tpu_torch.train.optim import global_norm
from ivideogpt_tpu_torch.utils import checkpoint as port_ckpt
from tests.test_tokenizer_model import TINY
from tests.test_torch_checkpoint import (LM_TINY, jitter, make_lm,
                                         make_tokenizer, port_config,
                                         to_numpy_tree)

CTX, H, K, A = 2, 3, 3, 4           # context, horizon, frame stack, actions
T = CTX + H
B = 3
RES = TINY.resolution
NCTX, NDYN = TINY.ctx_tokens_per_frame, TINY.dyn_tokens_per_frame
P1 = (NCTX + 1) * CTX
SDF = TINY.vocab_size - 1
HEAD = ActionModelConfig(action_dim=A, context_length=CTX, segment_length=T,
                         tokens_per_context=NCTX, tokens_per_dyna=NDYN,
                         reward_prediction=True)


@pytest.fixture(scope="module")
def models():
    """JAX inits (jittered) of the tokenizer and the LM with the reward
    head, as numpy trees, and their JAX modules."""
    tok_model, tok_params, _ = make_tokenizer(TINY, seed=0, T=T)
    lm_model, lm_params, _ = make_lm(ctx=CTX, T=T, seed=1,
                                     reward_prediction=True)
    return dict(tok_model=tok_model, tok_params=tok_params,
                lm_model=lm_model, lm_params=lm_params)


def _port_vp(models, cache_dtype=torch.float32, **kw):
    return tvp.VideoPredictor(
        port_config(TINY), port_config(LM_TINY), port_config(HEAD),
        tok_state_dict=port_ckpt.tokenizer_state_dict(models["tok_params"]),
        lm_state_dict=port_ckpt.action_model_state_dict(models["lm_params"]),
        compute_dtype=torch.float32, rollout_cache_dtype=cache_dtype,
        device="cpu", **kw)


def _stack(seed, b=B):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, RES, RES, 3 * K)).astype(np.float32)


# ----------------------------------------------------------------------
# the tokenizer's decode cache


def test_decode_cache_and_dyn_frame_match_jax(models):
    m, params = models["tok_model"], models["tok_params"]
    vp = _port_vp(models)
    rng = np.random.default_rng(2)
    idx_c = rng.integers(0, TINY.num_vq_embeddings, (B, CTX, NCTX))
    idx_d = rng.integers(0, TINY.num_dyn_embeddings, (B, NDYN))
    ref_dec, ref_cache = jax.jit(lambda p, i: m.apply(
        p, i, method=m.build_decode_cache))(params, jnp.asarray(idx_c))
    ref_frame = jax.jit(lambda p, i, c: m.apply(
        p, i, c, method=m.decode_dyn_frame))(params, jnp.asarray(idx_d),
                                              ref_cache)
    with torch.no_grad():
        dec, cache = vp.tokenizer.build_decode_cache(torch.from_numpy(idx_c))
        frame = vp.tokenizer.decode_dyn_frame(torch.from_numpy(idx_d), cache)
    assert tuple(dec.shape) == (B * CTX, RES, RES, 3)
    assert tuple(frame.shape) == (B, RES, RES, 3)
    # fp32, the decoders' sums in another order: detokenize's tolerance
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref_dec), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(frame.numpy(), np.asarray(ref_frame),
                               atol=1e-4, rtol=0)
    for ours, ref in zip(cache["cond_features"], ref_cache["cond_features"]):
        # the port's features are NCHW: (B, ctx, C, h, w) against NHWC
        np.testing.assert_allclose(ours.permute(0, 1, 3, 4, 2).numpy(),
                                   np.asarray(ref), atol=1e-4, rtol=0)


# ----------------------------------------------------------------------
# the policy and the helpers


def _jax_policy(obs_shape, seed, feature_dim=16, hidden_dim=32):
    """JAX Encoder + Actor params (jittered) and the port's policy loaded
    from them through ``drqv2_state_dict`` (strict)."""
    dummy = jnp.zeros((1, *obs_shape), jnp.float32)
    enc = jdrq.Encoder()
    enc_p = to_numpy_tree(enc.init(jax.random.key(seed), dummy))
    feat = enc.apply(enc_p, dummy)
    actor = jdrq.Actor(A, feature_dim, hidden_dim)
    act_p = to_numpy_tree(actor.init(jax.random.key(seed + 1), feat))
    enc_p, act_p = jitter(enc_p, seed), jitter(act_p, seed + 1)
    port = tdrq.DrQV2Policy(obs_shape, A, feature_dim, hidden_dim)
    port.load_state_dict(port_ckpt.drqv2_state_dict(enc_p, act_p),
                         strict=True)
    return enc, enc_p, actor, act_p, port.eval()


def test_policy_mean_matches_jax():
    obs_shape = (RES, RES, 3 * K)
    enc, enc_p, actor, act_p, port = _jax_policy(obs_shape, seed=3)
    obs = _stack(4, b=5)
    ref = actor.apply(act_p, enc.apply(enc_p, jnp.asarray(obs)))
    with torch.no_grad():
        feat = port.encoder(torch.from_numpy(obs))
        mean = port(torch.from_numpy(obs))
    assert feat.shape[1] == tdrq.Encoder.output_dim(RES, RES)
    # fp32 convs and dense layers in another summation order
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    # the features in the JAX (NHWC) order: the actor reads them as JAX does
    np.testing.assert_allclose(feat.numpy(), np.asarray(
        enc.apply(enc_p, jnp.asarray(obs))), atol=1e-5, rtol=0)


def test_build_policy_wants_cuda_and_is_seeded():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdrq.build_policy((64, 64, 9), 4)
    a = tdrq.build_policy((16, 16, 9), 4, seed=5, device="cpu")
    b = tdrq.build_policy((16, 16, 9), 4, seed=5, device="cpu")
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("clip", [None, 0.3])
def test_truncated_normal_sample_bounds(clip):
    loc = torch.linspace(-1.5, 1.5, 4001)
    gen = torch.Generator().manual_seed(0)
    x = tutils.truncated_normal_sample(loc, 1.0, gen, clip=clip)
    assert float(x.min()) >= -1 + 1e-6 and float(x.max()) <= 1 - 1e-6
    inner = (loc.abs() < 0.5)
    if clip is not None:
        # only the clamp to [low+eps, high-eps] can move a sample further
        assert float((x - loc)[inner].abs().max()) <= clip + 1e-6
    else:
        assert float((x - loc)[inner].abs().max()) > 0.3
    again = tutils.truncated_normal_sample(
        loc, 1.0, torch.Generator().manual_seed(0), clip=clip)
    assert torch.equal(x, again)


def test_symlog_symexp_and_schedule_match_jax():
    x = np.linspace(-50, 50, 1001).astype(np.float32)
    np.testing.assert_allclose(tutils.symlog(torch.from_numpy(x)).numpy(),
                               np.asarray(jvp.symlog(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    y = np.linspace(-4, 4, 801).astype(np.float32)
    np.testing.assert_allclose(tutils.symexp(torch.from_numpy(y)).numpy(),
                               np.asarray(jvp.symexp(jnp.asarray(y))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tutils.symexp(tutils.symlog(torch.from_numpy(x))).numpy(), x,
        rtol=1e-5, atol=1e-5)
    for spec in ("0.3", "linear(1.0,0.1,100)",
                 "step_linear(1.0,0.5,10,0.1,10)"):
        for step in (0, 5, 50, 1000):
            assert tutils.schedule(spec, step) == jutils.schedule(spec, step)
    with pytest.raises(NotImplementedError):
        tutils.schedule("cosine(1)", 0)


# ----------------------------------------------------------------------
# the rollout


def _stream(vp, stack, toks):
    """The token stream the rollout decoded: the context tokens of the
    stack's last CTX frames with their separators, then each frame's sdf
    and its 16 sampled tokens; the final sdf dropped."""
    frames = torch.from_numpy(stack / 255.0).float().view(
        B, RES, RES, K, 3).movedim(3, 1)[:, -CTX:]
    with torch.no_grad():
        idx_c = vp.tokenizer.encode_context(frames.contiguous())
    prelude = ttok.make_prelude(idx_c, TINY.num_vq_embeddings,
                                TINY.num_dyn_embeddings)
    sdf = toks.new_full((B, H, 1), SDF)
    dyn = torch.cat([toks, sdf], 2).reshape(B, -1)[:, :-1]
    return idx_c, torch.cat([prelude, dyn], 1)


def _jax_replay(model, params, stream, action, cache_dtype):
    """JAX teacher-forced cached replay of the stream: the logits that each
    sampled token was drawn from ([S, B, V], S = H * (NDYN + 1), as
    ``generation.replay_logits``) and the reward after each frame's last
    token ([B, H])."""
    def m(method, *args):
        return model.apply(params, *args, method=getattr(model, method))
    embeds = m("embed_tokens", stream)
    positions = P1 - 1 + jnp.arange(H) * (NDYN + 1)
    a = m("action_embeds", action)[:, CTX - 1:-1]
    embeds = embeds.at[:, positions].add(a.astype(embeds.dtype))
    L = stream.shape[1]
    cache = m("init_cache", B, L + 1, cache_dtype)
    hidden, cache = m("decode_cached", embeds[:, :P1], cache, 0)
    logits, hiddens = [m("unembed", hidden[:, -1])], []
    for idx in range(P1, L):
        hidden, cache = m("decode_cached", embeds[:, idx:idx + 1], cache,
                          idx)
        hiddens.append(hidden[:, 0])
        logits.append(m("unembed", hidden[:, 0]))
    last = jnp.stack([hiddens[f * (NDYN + 1) + NDYN - 1] for f in range(H)],
                     1)
    return jnp.stack(logits), m("reward", last)


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_rollout_matches_jax_teacher_forced(models, cache):
    tok_model, tok_params = models["tok_model"], models["tok_params"]
    lm_model, lm_params = models["lm_model"], models["lm_params"]
    vp = _port_vp(models, getattr(torch, cache))
    stack = _stack(5)
    replay = np.random.default_rng(6).uniform(-1, 1, (B, H, A)).astype(
        np.float32)
    pending = vp.rollout_async(stack, None, None, H, frame_stack=K,
                               generator=torch.Generator().manual_seed(0),
                               replay_actions=replay)
    obss, actions, rewards = pending.fetch()
    toks = pending.result.tokens
    assert obss.shape == (B, H + 1, RES, RES, 3 * K) and obss.dtype == np.uint8
    assert actions.shape == (B, H + 1, A) and rewards.shape == (B, H + 1)
    np.testing.assert_array_equal(actions[:, 0], 0)
    np.testing.assert_array_equal(rewards[:, 0], 0)
    np.testing.assert_array_equal(actions[:, 1:], replay)

    idx_c, stream = _stream(vp, stack, toks)
    ref_c = tok_model.apply(
        tok_params, jnp.asarray(stack / 255.0, jnp.float32).reshape(
            B, RES, RES, K, 3).transpose(0, 3, 1, 2, 4)[:, -CTX:],
        method=tok_model.encode_context)
    np.testing.assert_array_equal(idx_c.numpy(), np.asarray(ref_c))

    action = np.zeros((B, T, A), np.float32)
    action[:, CTX - 1:CTX - 1 + H] = replay
    js, ja = jnp.asarray(stream.numpy(), jnp.int32), jnp.asarray(action)
    if cache == "float32":
        out = lm_model.apply(lm_params, js, None, ja)
        # the training forward's logit at position p predicts token p + 1
        logits = jnp.moveaxis(out["logits"][:, P1 - 1:], 1, 0)
        reward_pred = out["reward_pred"]
        tol = 1e-4
    else:
        logits, reward_pred = _jax_replay(lm_model, lm_params, js, ja,
                                          jnp.int8)
        # the same int8 rounding on both sides; fp32 sums in another order
        # can flip a rounding of a k/v element (test_torch_rollout's 1e-3)
        tol = 1e-3
    logits = np.asarray(logits)
    np.testing.assert_allclose(rewards[:, 1:], np.asarray(
        jvp.symexp(reward_pred)), atol=tol, rtol=tol)
    sampled = stream.numpy()
    for s in range(H * (NDYN + 1) - 1):
        if s % (NDYN + 1) == NDYN:
            continue  # a forced sdf, not sampled
        keys, kth = jgen.exact_kth_largest_key(jnp.asarray(logits[s]), 100)
        keep = np.asarray(keys >= kth[:, None])
        assert keep[np.arange(B), sampled[:, P1 + s]].all(), s

    _, dcache = tok_model.apply(tok_params, jnp.asarray(idx_c.numpy()),
                                method=tok_model.build_decode_cache)
    dyn = np.clip(toks.numpy() - TINY.num_vq_embeddings, 0,
                  TINY.num_dyn_embeddings - 1)
    for f in range(H):
        ref = tok_model.apply(tok_params, jnp.asarray(dyn[:, f]), dcache,
                              method=tok_model.decode_dyn_frame)
        ref = np.round(255 * np.clip(np.asarray(ref), 0, 1))
        got = obss[:, f + 1, ..., -3:].astype(np.float32)
        # within 1e-4 before rounding to 1/255: one level at a boundary
        assert np.abs(got - ref).max() <= 1, f

    np.testing.assert_array_equal(obss[:, 0], stack.astype(np.uint8))
    for t in range(H):
        np.testing.assert_array_equal(obss[:, t + 1, ..., :-3],
                                      obss[:, t, ..., 3:])


def test_policy_rollout_acts_on_each_stack(models):
    vp = _port_vp(models)
    _, _, _, _, policy = _jax_policy((RES, RES, 3 * K), seed=7)
    seen = []

    def policy_fn(state, obs, stddev, generator):
        seen.append(obs.clone())
        return tdrq.batched_policy(state, obs, stddev, generator)

    stack = _stack(8)
    obss, actions, _ = vp.rollout(stack, policy_fn, policy, H, frame_stack=K,
                                  policy_stddev=0.0,
                                  generator=torch.Generator().manual_seed(1))
    assert len(seen) == H
    for t, obs in enumerate(seen):
        # the stack the policy saw is the stored one before rounding to uint8
        assert float((obs - torch.from_numpy(obss[:, t]).float()).abs()
                     .max()) <= 0.5 + 1e-3
        with torch.no_grad():
            want = policy(obs).clamp(-1 + 1e-6, 1 - 1e-6)
        np.testing.assert_array_equal(actions[:, t + 1], want.numpy())

    _, uniform, _ = vp.rollout(stack, policy_fn, policy, H, frame_stack=K,
                               generator=torch.Generator().manual_seed(1),
                               expl_uniform=True)
    flat = uniform[:, 1:].ravel()
    assert flat.min() >= -1 and flat.max() <= 1
    assert not np.allclose(uniform[:, 1:], actions[:, 1:])
    assert len(seen) == H   # expl_uniform does not ask the policy


# ----------------------------------------------------------------------
# online finetuning


def _batch(seed):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (2, T, RES, RES, 3)).astype(np.float32)
    action = rng.uniform(-1, 1, (2, T, A)).astype(np.float32)
    reward = rng.normal(size=(2, T)).astype(np.float32)
    return obs, action, reward


def _keep_grads():
    """An optax transformation that applies nothing and keeps the last
    gradients as its state: the JAX step's gradients, read exactly."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads
    return optax.GradientTransformation(init, update)


def _pair(models, lpips_scale, **kw):
    """The JAX VideoPredictor and the port's with the same weights, fp32,
    frozen codebooks; LPIPS' ``lin`` heads scaled by ``lpips_scale``."""
    kw = dict(tok_wd=0.01, model_wd=0.01, freeze_codebook=True,
              max_target_frames=2, **kw)
    ref = jvp.VideoPredictor(
        TINY, LM_TINY, HEAD, tok_params=jax.tree_util.tree_map(
            jnp.asarray, models["tok_params"]),
        lm_params=jax.tree_util.tree_map(jnp.asarray, models["lm_params"]),
        compute_dtype=jnp.float32, **kw)
    lparams = to_numpy_tree(ref.lpips_params)
    for key in lparams["params"]:
        if key.startswith("lin"):
            lparams["params"][key] = lparams["params"][key] * lpips_scale
    ref.lpips_params = jax.tree_util.tree_map(jnp.asarray, lparams)
    ref._tok_step = ref._make_tok_step()
    vp = _port_vp(models, **kw)
    vp.lpips.load_state_dict(port_ckpt.lpips_state_dict(lparams), strict=True)
    return ref, vp


def _tok_step_pair(models, lpips_scale, jax_update=True):
    """One tokenizer step of each package from the same weights on the same
    frames and targets: (JAX metrics, JAX state after the step or None,
    JAX gradients, port metrics, port gradients before the clip, the
    port's VideoPredictor, its codebooks before the step)."""
    ref, vp = _pair(models, lpips_scale)
    obs01 = _batch(9)[0] / 255.0
    idx = np.array([0, 2])
    books = {n: p.detach().clone() for n, p in vp.tokenizer.named_parameters()
             if n in tvp.CODEBOOKS}
    grads = []
    apply = vp.tok_state.apply_gradients

    def keep_then_apply():
        grads.append({n: p.grad.clone() for n, p in
                      vp.tokenizer.named_parameters()})
        apply()
    vp.tok_state.apply_gradients = keep_then_apply
    jstate = None
    if jax_update:
        jstate, _ = ref._tok_step(ref.tok_state, jnp.asarray(obs01),
                                  jnp.asarray(idx))
    kept, jm = ref._tok_step(joptim.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, models["tok_params"]),
        _keep_grads()), jnp.asarray(obs01), jnp.asarray(idx))
    jgrads = port_ckpt.tokenizer_state_dict(
        jax.tree_util.tree_map(np.asarray, kept.opt_state))
    m = vp.tokenizer_step(torch.from_numpy(obs01), torch.from_numpy(idx))
    return jm, jstate, jgrads, m, grads[0], vp, books


def test_tokenizer_step_matches_jax_and_codebooks_stay_frozen(models):
    """LPIPS' heads zeroed on both sides: its gradient is a discontinuous
    function of the decoded pixels (ReLU and max-pool kinks), which
    differ between the frameworks by fp32 rounding, and AdamW's first step
    moves every element by about lr whatever its gradient's size, so a
    flipped sign would move an element by 2 lr. Without LPIPS every
    updated parameter is held elementwise; the next test holds the step
    with LPIPS by its gradients' norms."""
    jm, jstate, jgrads, m, grads, vp, books = _tok_step_pair(models, 0.0)
    assert float(m["perceptual_loss"]) == 0.0
    for k, v in jm.items():
        # forward values: fp32 sums in another order
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    # a gradient under 1e-6 of the largest is zero but for rounding (a key
    # bias in front of a softmax, a bias in front of a GroupNorm)
    floor = 1e-6 * max(float(g.abs().max()) for g in jgrads.values())
    for name, g in grads.items():
        # fp32 sums in another order: 1e-3 of each gradient's largest
        # element, as the tokenizer trainer's G step
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), rtol=0,
                                   atol=1e-3 * float(jgrads[name].abs().max())
                                   + floor, err_msg=name)
    want = port_ckpt.tokenizer_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    before = port_ckpt.tokenizer_state_dict(models["tok_params"])
    for name, p in vp.tokenizer.state_dict().items():
        if name in tvp.CODEBOOKS:
            assert torch.equal(p, books[name]), name
            continue
        p, w, p0 = p.numpy(), want[name].numpy(), before[name].numpy()
        live = np.abs(jgrads[name].numpy()) > floor
        # one AdamW step at lr 1e-4 (test_torch_train's bound)
        np.testing.assert_allclose(p[live], w[live], rtol=0, atol=1e-5,
                                   err_msg=name)
        # a rounding-level gradient, compared with Adam's eps (1e-8), moves
        # its element by a noise-set fraction of lr in either package: held
        # to the most AdamW's first step moves any element
        assert np.abs(p - p0)[~live].max(initial=0) <= 1.01e-4, name
        assert np.abs(w - p0)[~live].max(initial=0) <= 1.01e-4, name
    # the JAX package's frozen codebooks move by their clipped gradient:
    # optax.masked hands the masked-out leaves' updates through unchanged
    scale = min(1.0, 1.0 / float(global_norm(jgrads.values())))
    for name in tvp.CODEBOOKS:
        moved = want[name].numpy() - before[name].numpy()
        assert np.abs(moved).max() > 0, name
        np.testing.assert_allclose(moved, jgrads[name].numpy() * scale,
                                   rtol=1e-4, atol=1e-9, err_msg=name)


def test_tokenizer_step_with_lpips_matches_jax(models):
    """The step with random LPIPS heads: the losses held tightly, the
    gradients by their norms (see test_tokenizer_step_with_perceptual_loss
    in tests/test_torch_tokenizer_train.py for why)."""
    jm, _, jgrads, m, grads, vp, books = _tok_step_pair(models, 1.0,
                                                        jax_update=False)
    assert float(m["perceptual_loss"]) > 0
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    diff2 = sum(float(((g - jgrads[n]) ** 2).sum()) for n, g in grads.items())
    ref2 = sum(float((w ** 2).sum()) for w in jgrads.values())
    # all gradients together, as the tokenizer trainer's LPIPS step
    assert diff2 ** 0.5 < 1e-2 * ref2 ** 0.5
    for name, g in grads.items():
        err = float((g - jgrads[name]).norm())
        assert err < 3e-2 * float(jgrads[name].norm()) + 1e-5 * ref2 ** 0.5, \
            name
    for name, p in vp.tokenizer.named_parameters():
        if name in tvp.CODEBOOKS:
            assert torch.equal(p, books[name]), name


def test_model_step_matches_jax(models):
    ref, vp = _pair(models, 1.0)
    obs, action, reward = _batch(13)
    obs01 = obs / 255.0
    reward = np.array(jvp.symlog(jnp.asarray(reward)))
    jstate, jm = ref._model_step(
        ref.model_state, jax.tree_util.tree_map(jnp.asarray,
                                                models["tok_params"]),
        jnp.asarray(obs01), jnp.asarray(action), jnp.asarray(reward))
    m = vp.model_step(torch.from_numpy(obs01), torch.from_numpy(action),
                      torch.from_numpy(reward))
    assert sorted(m) == sorted([*jm, "model_grad_norm"])
    for k, v in jm.items():
        # fp32 sums in another order (test_torch_train's 1e-5)
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = port_ckpt.action_model_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    for name, p in vp.model.state_dict().items():
        # one AdamW step at lr 1e-4 (test_torch_train's bound)
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_train_draws_targets_and_squeezes_rewards(models):
    vp = _port_vp(models, freeze_codebook=True, max_target_frames=2)
    books = {n: p.detach().clone() for n, p in vp.tokenizer.named_parameters()
             if n in tvp.CODEBOOKS}
    obs, action, reward = _batch(10)
    seen = []
    step = vp.tokenizer_step
    vp.tokenizer_step = lambda o, idx: seen.append(idx.tolist()) or step(o,
                                                                         idx)
    m = vp.train((obs, action, reward[..., None]))
    for k in ("tokenizer_loss", "ce_loss", "reward_loss", "model_loss"):
        assert np.isfinite(m[k]), k
    assert len(seen[0]) == 2 and seen[0] == sorted(set(seen[0]))
    assert all(0 <= i < H for i in seen[0])
    for n, p in vp.tokenizer.named_parameters():
        if n in books:
            assert torch.equal(p, books[n]), n
    # the [B, T, 1] reward gives the [B, T] reward's loss
    m2 = _port_vp(models).train((obs, action, reward),
                                update_tokenizer=False)
    m3 = _port_vp(models).train((obs, action, reward[..., None]),
                                update_tokenizer=False)
    assert m2["reward_loss"] == m3["reward_loss"]


def test_bf16_rollout_sees_trained_weights(models):
    """bf16 compute: the rollout runs bf16 copies of the masters, refreshed
    by each training step, so a rollout after train() reads the new
    weights."""
    vp = tvp.VideoPredictor(
        port_config(TINY), port_config(LM_TINY), port_config(HEAD),
        tok_state_dict=port_ckpt.tokenizer_state_dict(models["tok_params"]),
        lm_state_dict=port_ckpt.action_model_state_dict(models["lm_params"]),
        model_lr=1e-2, tok_lr=1e-2, device="cpu")
    stack = _stack(11)
    replay = np.zeros((B, H, A), np.float32)

    def run():
        return vp.rollout(stack, None, None, H, frame_stack=K,
                          generator=torch.Generator().manual_seed(3),
                          replay_actions=replay)
    first = run()
    tok, lm = vp.rollout_tokenizer, vp.rollout_model
    assert tok is not vp.tokenizer and lm is not vp.model
    vp.train(_batch(12))
    second = run()
    for master, copy in ((vp.tokenizer, tok), (vp.model, lm)):
        for (n, p), q in zip(master.named_parameters(), copy.parameters()):
            assert q.dtype == (torch.bfloat16 if p.ndim >= (
                3 if master is vp.tokenizer else 2) else torch.float32), n
            assert torch.equal(q, p.detach().to(q.dtype)), n
    assert not np.array_equal(first[2], second[2])


def test_video_predictor_wants_the_reward_head():
    with pytest.raises(ValueError, match="reward"):
        tvp.VideoPredictor(port_config(TINY), port_config(LM_TINY),
                           port_config(HEAD).replace(reward_prediction=False),
                           device="cpu")
