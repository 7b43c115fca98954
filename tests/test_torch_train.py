"""The GPT training slice of the PyTorch port against the JAX package, on
the CPU in fp32 (the attention is the plain version there; the CUDA kernels
are held against it on the card):

- the training forward (logits, loss, action reconstruction, reward head)
  against ``HeadModelWithAction.apply``, and every parameter's gradient
  against ``jax.grad``, with the weights carried by the bridge;
- remat on and off give the same gradients;
- LR schedules, the no-weight-decay rule, clipping, gradient
  accumulation, EMA and per-module gradient norms against
  ``ivideogpt_tpu/train/optim.py``;
- the slice end to end: pixels -> frozen tokenizer -> 3 ``train_step``s
  against ``make_tokenize_fn`` + ``make_train_step`` + ``make_optimizer``,
  parameters compared after each step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ivideogpt_tpu.models.llama import cross_entropy_loss as jax_ce
from ivideogpt_tpu.train import gpt_trainer as jtrain
from ivideogpt_tpu.train import optim as joptim
from ivideogpt_tpu_torch import tokens as ttok
from ivideogpt_tpu_torch.models.action_model import \
    HeadModelWithAction as TorchHead
from ivideogpt_tpu_torch.models.llama import cross_entropy_loss
from ivideogpt_tpu_torch.train import gpt_trainer as ttrain
from ivideogpt_tpu_torch.train import optim as toptim
from ivideogpt_tpu_torch.utils import checkpoint as port_ckpt
from tests.test_tokenizer_model import TINY
from tests.test_torch_checkpoint import (LM_TINY, make_lm, make_tokenizer,
                                         port_config)

B, CTX, T = 2, 2, 5
NCTX, NDYN = TINY.ctx_tokens_per_frame, TINY.dyn_tokens_per_frame


@pytest.fixture(scope="module")
def heads_lm():
    return make_lm(ctx=CTX, T=T, seed=2, reward_prediction=True,
                   action_recon=0.5)


def _batch(seed):
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(rng.integers(0, TINY.num_vq_embeddings,
                                      (B, CTX, NCTX)))
    d = torch.from_numpy(rng.integers(0, TINY.num_dyn_embeddings,
                                      (B, T - CTX, NDYN)))
    ids, labels = ttok.assemble(c, d, TINY.num_vq_embeddings,
                                TINY.num_dyn_embeddings)
    act = rng.normal(size=(B, T, 4)).astype(np.float32)
    return ids, labels, act


def _jax_out(model, params, ids, labels, act):
    return model.apply(params, jnp.asarray(ids.numpy(), jnp.int32),
                       jnp.asarray(labels.numpy(), jnp.int32),
                       jnp.asarray(act))


def _port_grads(port, ids, labels, act):
    port.train()
    port.zero_grad(set_to_none=True)
    port(ids, labels, torch.from_numpy(act))["loss"].backward()
    # a head outside the loss (reward) gets no gradient: jax.grad's zeros
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in port.named_parameters()}


def test_training_forward_matches_jax(heads_lm):
    model, params, port = heads_lm
    ids, labels, act = _batch(0)
    ref = _jax_out(model, params, ids, labels, act)
    port.train()
    with torch.no_grad():
        out = port(ids, labels, torch.from_numpy(act))
    assert set(out) == set(ref) == {"logits", "loss", "action_recon_loss",
                                    "reward_pred"}
    assert out["logits"].dtype == torch.float32
    # fp32 on both sides, matmul sums in another order
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(ref["logits"]),
                               rtol=1e-5, atol=1e-5)
    for key in ("loss", "action_recon_loss"):
        np.testing.assert_allclose(float(out[key]), float(ref[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(out["reward_pred"].numpy(),
                               np.asarray(ref["reward_pred"]), rtol=1e-5,
                               atol=1e-6)


def test_every_gradient_matches_jax_grad(heads_lm):
    model, params, port = heads_lm
    ids, labels, act = _batch(1)
    jgrads = jax.grad(lambda p: _jax_out(model, p, ids, labels, act)["loss"])(
        params)
    ref = port_ckpt.action_model_state_dict(
        jax.tree_util.tree_map(np.asarray, jgrads))
    ours = _port_grads(port, ids, labels, act)
    assert sorted(ours) == sorted(ref)
    for name, g in ours.items():
        want = ref[name].numpy()
        # fp32 sums in another order: within 1e-4 of the gradient's max
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * scale + 1e-12, err_msg=name)


def test_remat_gives_the_same_gradients(heads_lm):
    _, _, port = heads_lm
    ids, labels, act = _batch(2)
    remat = TorchHead(port.llm_config.replace(remat=True), port.head_config)
    remat.load_state_dict(port.state_dict())
    ours, theirs = (_port_grads(m, ids, labels, act) for m in (remat, port))
    for name in ours:
        # the same ops recomputed: the same sums on the CPU
        torch.testing.assert_close(ours[name], theirs[name], rtol=1e-6,
                                   atol=1e-9, msg=name)


def test_unported_training_options_raise(heads_lm):
    """Attention dropout in train() needs the step's dropout key, and runs
    with one (the "dots" remat policy, once refused here, is ported:
    tests/test_torch_remat_dots.py)."""
    _, _, port = heads_lm
    ids, labels, act = _batch(3)
    m = TorchHead(port.llm_config.replace(attention_dropout=0.1),
                  port.head_config).train()
    with pytest.raises(ValueError, match="dropout_key"):
        m(ids, labels, torch.from_numpy(act))
    m(ids, labels, torch.from_numpy(act), dropout_key=(0, 1))
    # dropout is inert in eval, as in the JAX package's deterministic forward
    m.eval()
    m(ids, labels, torch.from_numpy(act))


def test_cross_entropy_matches_jax_and_is_zero_when_all_ignored():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 9, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 9))
    labels[0, :5] = -100
    for lab in (labels, np.full_like(labels, -100)):
        ours = cross_entropy_loss(torch.from_numpy(logits),
                                  torch.from_numpy(lab))
        ref = jax_ce(jnp.asarray(logits), jnp.asarray(lab))
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    assert float(ours) == 0.0


@pytest.mark.parametrize("kind", ["constant", "cosine", "linear"])
@pytest.mark.parametrize("warmup,total", [(0, 50), (5, 60), (100, 1000)])
def test_lr_schedule_matches_optax(kind, warmup, total):
    ref = joptim.make_lr_schedule(kind, 3e-4, warmup, total)
    ours = toptim.make_lr_schedule(kind, 3e-4, warmup, total)
    steps = range(total + 5)
    want = np.array([ref(jnp.int32(s)) for s in steps], np.float32)
    got = np.array([ours(s) for s in steps], np.float32)
    if kind == "cosine":
        # XLA's float32 cosine is not correctly rounded: one ulp at most
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    else:
        np.testing.assert_array_equal(got, want)
    assert got[0] == 0.0  # read before the increment: warmup starts at 0


def test_no_weight_decay_rule_matches_jax(heads_lm):
    _, params, port = heads_lm
    mask = joptim._no_wd_mask(params)
    # the mask, broadcast to each leaf, through the bridge's name mapping
    tree = jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params)
    want = port_ckpt.action_model_state_dict(tree)
    got = {n: toptim.decays(n, p) for n, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    for n, d in got.items():
        assert bool(want[n].flatten()[0]) == d, n
    assert not got["llm.model.embed_tokens.weight"]
    assert got["llm.lm_head.weight"] and not got["action_linear.bias"]


def test_flax_path_inverts_the_bridge(heads_lm):
    _, params, port = heads_lm
    flat = port_ckpt._flatten(params["params"])
    paths = [port_ckpt.action_model_flax_path(n)
             for n, _ in port.named_parameters()]
    assert sorted(paths) == sorted(flat)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_per_module_grad_norms_match_jax(heads_lm, depth):
    """The same gradients, carried by the bridge and keyed by their Flax
    paths, give the JAX package's groups, names and norms."""
    model, params, _ = heads_lm
    ids, labels, act = _batch(4)
    jgrads = jax.grad(lambda p: _jax_out(model, p, ids, labels, act)["loss"])(
        params)
    ref = joptim.per_module_grad_norms(jgrads["params"], depth=depth)
    grads = port_ckpt.action_model_state_dict(
        jax.tree_util.tree_map(np.asarray, jgrads))
    ours = toptim.per_module_grad_norms(
        {port_ckpt.action_model_flax_path(n): g for n, g in grads.items()},
        depth=depth)
    assert sorted(ours) == sorted(ref)
    for key, norm in ours.items():
        # fp32 sums of squares in another order
        np.testing.assert_allclose(float(norm), float(ref[key]), rtol=1e-6,
                                   err_msg=key)


def test_ema_update_matches_jax(heads_lm):
    _, params, _ = heads_lm
    rng = np.random.default_rng(5)
    new = jax.tree_util.tree_map(
        lambda p: (p + rng.normal(size=np.shape(p))).astype(np.float32),
        params)
    ref = jax.tree_util.tree_map(np.asarray,
                                 joptim.ema_update(params, new, 0.99))
    ours = toptim.ema_update(port_ckpt.action_model_state_dict(params),
                             port_ckpt.action_model_state_dict(new), 0.99)
    want = port_ckpt.action_model_state_dict(ref)
    assert sorted(ours) == sorted(want)
    for name, e in ours.items():
        # the same two fp32 multiplies and one add on each element
        np.testing.assert_allclose(e.numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("max_norm", [0.5, 4.0, 1e3])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    ours = [torch.from_numpy(g.copy()) for g in grads]
    norm = toptim.clip_by_global_norm_(ours, max_norm)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                               rtol=1e-6)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def _linear_pair(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=3).astype(np.float32)
    lin = torch.nn.Linear(4, 3)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    return lin, {"dense": {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)}}


def test_gradient_accumulation_matches_multisteps():
    """k=2 micro-steps == one step on the mean gradient == optax.MultiSteps
    (the equivalence of tests/test_optim.py:47, with decay and clipping)."""
    kw = dict(learning_rate=1e-2, lr_scheduler="constant", warmup_steps=0,
              total_steps=100, weight_decay=0.1, max_grad_norm=1.0)
    g1 = [np.full((3, 4), 1.0, np.float32), np.full(3, -2.0, np.float32)]
    g2 = [np.full((3, 4), 3.0, np.float32), np.full(3, 0.5, np.float32)]
    acc_lin, jparams = _linear_pair(0)
    ref_lin, _ = _linear_pair(0)
    acc = toptim.TrainState(acc_lin, gradient_accumulation_steps=2, **kw)
    ref = toptim.TrainState(ref_lin, **kw)
    tx, _ = joptim.make_optimizer(jparams, gradient_accumulation_steps=2,
                                  **kw)
    jstate = joptim.TrainState.create(jparams, tx)
    for step in range(4):  # two applied updates: lr 0, then lr 1e-2
        ga, gb = (g1, g2) if step % 2 == 0 else (g2, g1)
        for p, g in zip(acc.params, ga):
            p.grad = torch.from_numpy(g.copy())
        acc.apply_gradients()
        jstate = jstate.apply_gradients(
            {"dense": {"kernel": jnp.asarray(ga[0].T),
                       "bias": jnp.asarray(ga[1])}})
        if step % 2 == 0:
            assert acc.updates == step // 2  # nothing applied mid-window
            continue
        for p, a, b in zip(ref.params, ga, gb):
            p.grad = torch.from_numpy((a + b) / 2)
        ref.apply_gradients()
        assert acc.updates == ref.updates == step // 2 + 1
        for p, q in zip(acc.params, ref.params):
            torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)
        jd = jstate.params["dense"]
        np.testing.assert_allclose(acc_lin.weight.detach().numpy(),
                                   np.asarray(jd["kernel"]).T, atol=1e-6)
        np.testing.assert_allclose(acc_lin.bias.detach().numpy(),
                                   np.asarray(jd["bias"]), atol=1e-6)


def test_train_steps_match_jax_from_pixels():
    """The slice: pixels -> frozen tokenizer -> 3 clipped AdamW steps with
    a warmup-cosine schedule and weight decay, parameters after each."""
    tok_model, tok_params, tok = make_tokenizer(TINY, seed=0, T=T)
    lm_model, lm_params, port = make_lm(ctx=CTX, T=T, seed=4,
                                        action_recon=0.5)
    rng = np.random.default_rng(6)
    px = rng.uniform(0, 1, (B, T, 32, 32, 3)).astype(np.float32)
    act = rng.normal(size=(B, T, 4)).astype(np.float32)

    jids, jlabels = jtrain.make_tokenize_fn(tok_model, tok_params, CTX)(
        jnp.asarray(px))
    ids, labels = ttrain.make_tokenize_fn(tok, CTX)(torch.from_numpy(px))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))

    # the reference recipe's lr: Adam moves an element by up to ~lr whatever
    # its gradient, so a gradient near 0 whose fp32 rounding differs between
    # the frameworks moves it by a fraction of lr (2e-5 seen at lr 1e-3)
    kw = dict(learning_rate=1e-4, lr_scheduler="cosine", warmup_steps=1,
              total_steps=10, weight_decay=0.01, max_grad_norm=1.0)
    jparams = jax.tree_util.tree_map(jnp.asarray, lm_params)
    tx, _ = joptim.make_optimizer(jparams, **kw)
    jstate = joptim.TrainState.create(jparams, tx)
    jstep = jtrain.make_train_step(lm_model, action_conditioned=True)
    state = toptim.TrainState(port, **kw)
    jbatch = {"input_ids": jids, "labels": jlabels, "action": jnp.asarray(act)}
    batch = {"input_ids": ids, "labels": labels,
             "action": torch.from_numpy(act)}
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch, jax.random.key(i))
        m = ttrain.train_step(state, batch)
        for key in ("loss", "grad_norm", "perplexity"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"step {i} {key}")
        want = port_ckpt.action_model_state_dict(
            jax.tree_util.tree_map(np.asarray, jstate.params))
        for name, p in port.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"step {i} {name}")
    assert state.updates == 3


def test_build_train_models_on_cpu_at_the_trainers_shapes():
    tok, model = ttrain.build_train_models(
        port_config(TINY), port_config(LM_TINY), context_length=CTX,
        segment_length=T, action_recon=0.5, device="cpu")
    assert model.training and not tok.training
    assert not any(p.requires_grad for p in tok.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.dtype == torch.bfloat16
    assert model.llm_config.vocab_size == TINY.vocab_size
    assert model.head_config.prelude_tokens_num == ttok.prelude_len(CTX, NCTX)
    ev = ttrain.eval_step(model, {"input_ids": torch.zeros(1, 180,
                                                           dtype=torch.long),
                                  "labels": torch.zeros(1, 180,
                                                        dtype=torch.long)})
    assert torch.isfinite(ev["loss"])


def test_build_train_models_keeps_the_callers_lm_config():
    """remat and dropout are the caller's: a config with dropout (the
    medium recipe's 0.1) raises in training without the step's dropout key
    rather than training without dropout, and remat stays on."""
    ids = torch.zeros(1, 180, dtype=torch.long)
    for cfg, remat in ((port_config(LM_TINY).replace(remat=True), True),
                       (port_config(LM_TINY).replace(attention_dropout=0.1),
                        False)):
        _, model = ttrain.build_train_models(
            port_config(TINY), cfg, context_length=CTX, segment_length=T,
            device="cpu")
        assert model.llm_config.remat is remat
        assert model.llm_config.attention_dropout == cfg.attention_dropout
        if cfg.attention_dropout:
            with pytest.raises(ValueError, match="dropout_key"):
                model(ids, ids)


def test_train_config_defaults_match_jax():
    from ivideogpt_tpu.configs import GPTTrainConfig
    ours = port_config(GPTTrainConfig())
    assert ours == ttrain.GPTTrainConfig()
    assert ours.learning_rate == 1e-4 and ours.lr_scheduler == "cosine"
