"""The DrQ-v2 agent of the PyTorch port against the JAX package's, on the
CPU in fp32 at small widths (24 x 24 x 9 observations, feature 16, hidden
32, batch 8):

- ``random_shift_aug`` bit-equal to JAX's for the shifts that
  ``jax.random.randint`` draws from the same key;
- the critic's Q1 / Q2 and the policy through ``drqv2_agent_state_dict``
  (strict);
- one ``update`` without and with the actor step against the JAX agent's
  ``_update_impl`` fed the same draws: the metrics, every gradient (read
  from AdamW's first moments, 0.1 g after the first step on both sides),
  every parameter after AdamW and the Polyak target. Tolerances: losses
  and Q means 1e-5 relative; first moments 1e-5 of the tensor's largest;
  parameters 1e-6 absolute (lr 1e-4, weights ~0.1), except elements whose
  gradient is rounding-level (below 1e-5 of the tensor's largest), which
  AdamW's first step moves by up to lr either way: those are held to
  2 lr + 1e-6;
- ``act``: the uniform exploration actions bit-equal to JAX's from the same
  ``np.random`` seed, the eval-mode mean to 1e-5;
- ``Until`` / ``Every`` / ``Timer`` / ``schedule`` / ``soft_update``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu.mbrl import drqv2 as jdrq
from ivideogpt_tpu.mbrl import utils as jutils
from ivideogpt_tpu_torch.mbrl import drqv2 as tdrq
from ivideogpt_tpu_torch.mbrl import utils as tutils
from ivideogpt_tpu_torch.utils import checkpoint as port_ckpt
from tests.test_torch_checkpoint import jitter, to_numpy_tree

torch.set_num_threads(2)

OBS = (24, 24, 9)
A, FEAT, HID, N = 4, 16, 32, 8
LR = 1e-4


# ----------------------------------------------------------------------
# the helpers


def test_until_every_timer_match_jax():
    for until, rep in ((None, 1), (10, 1), (100, 2), (7, 3)):
        for step in range(60):
            assert tutils.Until(until, rep)(step) == \
                jutils.Until(until, rep)(step)
    for every, rep in ((None, 1), (10, 1), (200, 2), (9, 3)):
        for step in range(100):
            assert tutils.Every(every, rep)(step) == \
                jutils.Every(every, rep)(step)
    timer = tutils.Timer()
    elapsed, total = timer.reset()
    assert 0 <= elapsed <= total and timer.total_time() >= total


@pytest.mark.parametrize("spec", ["0.2", "linear(1.0,0.1,100000)",
                                  "step_linear(1.0,0.5,100,0.1,300)"])
def test_schedule_matches_jax(spec):
    for step in (0, 1, 50, 100, 101, 250, 400, 10**6):
        assert tutils.schedule(spec, step) == jutils.schedule(spec, step)


def test_soft_update_matches_jax():
    rng = np.random.default_rng(0)
    t = [rng.normal(size=s).astype(np.float32) for s in ((3, 5), (5,))]
    o = [rng.normal(size=s).astype(np.float32) for s in ((3, 5), (5,))]
    want = jutils.soft_update({"w": t[0], "b": t[1]},
                              {"w": o[0], "b": o[1]}, 0.01)
    target, online = torch.nn.Linear(3, 5), torch.nn.Linear(3, 5)
    with torch.no_grad():
        for mod, (w, b) in ((target, t), (online, o)):
            mod.weight.copy_(torch.from_numpy(w).T)
            mod.bias.copy_(torch.from_numpy(b))
    tutils.soft_update(target, online, 0.01)
    np.testing.assert_allclose(target.weight.detach().numpy().T,
                               np.asarray(want["w"]), rtol=0, atol=1e-7)
    np.testing.assert_allclose(target.bias.detach().numpy(),
                               np.asarray(want["b"]), rtol=0, atol=1e-7)


# ----------------------------------------------------------------------
# augmentation and the networks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_shift_aug_bit_equal_to_jax(seed):
    key = jax.random.key(seed)
    x = np.random.default_rng(seed).integers(
        0, 256, (N, *OBS)).astype(np.float32)
    want = np.asarray(jdrq.random_shift_aug(key, jnp.asarray(x)))
    shifts = np.asarray(jax.random.randint(key, (N, 2), 0, 2 * 4 + 1))
    got = tdrq.random_shift_aug(torch.from_numpy(x),
                                torch.from_numpy(shifts.copy()).long())
    np.testing.assert_array_equal(got.numpy(), want)
    # the window reaches both edges: replicate padding, not zeros
    corner = tdrq.random_shift_aug(torch.from_numpy(x[:1]),
                                   torch.tensor([[0, 8]]))
    np.testing.assert_array_equal(corner[0, :4, -1].numpy(),
                                  np.broadcast_to(x[0, 0, -1], (4, OBS[2])))


def _jax_agent(seed=0, **kw):
    """The JAX agent with jittered weights (biases and LayerNorms off their
    init) and fresh AdamW states, and the port agent loaded from them."""
    agent = jdrq.DrQV2Agent(OBS, A, lr=LR, feature_dim=FEAT, hidden_dim=HID,
                            seed=seed, **kw)
    st = agent.state
    enc, act, cri = (jitter(to_numpy_tree(p), seed + i) for i, p in
                     enumerate((st.encoder_params, st.actor_params,
                                st.critic_params)))
    tgt = jitter(cri, seed + 7)
    agent.state = st.replace(
        encoder_params=enc, actor_params=act, critic_params=cri,
        critic_target_params=tgt, encoder_opt=agent.tx.init(enc),
        actor_opt=agent.tx.init(act), critic_opt=agent.tx.init(cri))
    port = tdrq.DrQV2Agent(OBS, A, lr=LR, feature_dim=FEAT, hidden_dim=HID,
                           seed=seed, device="cpu", **kw)
    port.load_state_dict(port_ckpt.drqv2_agent_state_dict(enc, act, cri,
                                                          tgt), strict=True)
    return agent, port


def _obs(seed, n=N):
    return np.random.default_rng(seed).integers(
        0, 256, (n, *OBS)).astype(np.uint8)


def test_critic_and_policy_through_the_bridge():
    agent, port = _jax_agent(seed=3)
    st = agent.state
    obs = _obs(4).astype(np.float32)
    action = np.random.default_rng(5).uniform(-1, 1, (N, A)).astype(
        np.float32)
    feat = agent.encoder.apply(st.encoder_params, jnp.asarray(obs))
    q1, q2 = agent.critic.apply(st.critic_params, feat, jnp.asarray(action))
    t1, t2 = agent.critic.apply(st.critic_target_params, feat,
                                jnp.asarray(action))
    mu = agent.actor.apply(st.actor_params, feat)
    with torch.no_grad():
        f = port.policy.encoder(torch.from_numpy(obs))
        p1, p2 = port.critic(f, torch.from_numpy(action))
        u1, u2 = port.critic_target(f, torch.from_numpy(action))
        m = port.policy(torch.from_numpy(obs))
    for ours, ref in ((p1, q1), (p2, q2), (u1, t1), (u2, t2), (m, mu)):
        # fp32 convs and dense layers summed in another order
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)
    assert sorted(port.state_dict()) == sorted(
        port_ckpt.drqv2_agent_state_dict(
            to_numpy_tree(st.encoder_params), to_numpy_tree(st.actor_params),
            to_numpy_tree(st.critic_params),
            to_numpy_tree(st.critic_target_params)))


# ----------------------------------------------------------------------
# the update


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (_obs(seed), rng.uniform(-1, 1, (N, A)).astype(np.float32),
            rng.normal(size=(N, 1)).astype(np.float32),
            np.full((N, 1), 0.99 ** 3, np.float32), _obs(seed + 100))


def _jax_draws(rng):
    """The draws ``_update_impl`` makes from ``rng``, in its order."""
    r_aug1, r_aug2, r_next, r_actor = jax.random.split(rng, 4)
    return tdrq.UpdateDraws(
        *(torch.from_numpy(np.asarray(jax.random.randint(
            k, (N, 2), 0, 9))).long() for k in (r_aug1, r_aug2)),
        *(torch.from_numpy(np.asarray(jax.random.normal(
            k, (N, A), jnp.float32))) for k in (r_next, r_actor)))


def _flat(params):
    return {k: np.asarray(v) for k, v in port_ckpt._flatten(
        to_numpy_tree(params)["params"]).items()}


_TO_FLAX = {"trunk.0": "Dense_0", "trunk.1": "LayerNorm_0",
            "policy.0": "Dense_1", "policy.2": "Dense_2",
            "policy.4": "Dense_3"}


def _flax_path(name):
    """A port parameter name of the encoder, actor or critic -> its Flax
    path (the bridge's map, read backwards)."""
    mod, leaf = name.rsplit(".", 1)
    if mod.startswith("convnet."):
        mod = f"Conv_{int(mod.split('.')[1]) // 2}"
        return f"{mod}/{'kernel' if leaf == 'weight' else leaf}"
    mod = _TO_FLAX.get(mod, mod)
    if leaf == "weight":
        leaf = "scale" if mod.startswith("LayerNorm") else "kernel"
    return f"{mod}/{leaf}"


def _moments(opt_state):
    """optax.adamw's state -> {flax path: first moment}."""
    return {k: np.asarray(v) for k, v in port_ckpt._flatten(
        to_numpy_tree(opt_state[0].mu)["params"]).items()}


def _hold(what, got, want, grad, tol=1e-6):
    """Parameters after AdamW's first step: 1e-6 where the gradient is
    clear of rounding, 2 lr + 1e-6 where it is rounding-level."""
    tiny = np.abs(grad) < 1e-5 * max(np.abs(grad).max(), 1e-30)
    err = np.abs(got - want)
    assert (err[~tiny] <= tol).all(), (what, err[~tiny].max())
    assert (err[tiny] <= 2 * LR + tol).all(), (what, err[tiny].max())


@pytest.mark.parametrize("update_actor", [False, True])
def test_update_matches_jax(update_actor):
    agent, port = _jax_agent(seed=10, delay_steps=1)
    st0 = agent.state
    batch = _batch(11)
    rng = jax.random.key(12)
    stddev = 0.3
    st1, jm = agent._update(st0, tuple(jnp.asarray(x) for x in batch),
                            stddev, rng, update_actor=update_actor)
    pm = port.update_step(tuple(torch.from_numpy(x) for x in batch), stddev,
                          _jax_draws(rng), update_actor)
    assert sorted(pm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert port.updated_steps == int(st1.updated_steps) == 1

    parts = [("encoder", port.policy.encoder, port.encoder_state,
              st1.encoder_params, st1.encoder_opt),
             ("critic", port.critic, port.critic_state, st1.critic_params,
              st1.critic_opt)]
    if update_actor:
        parts.append(("actor", port.policy.actor, port.actor_state,
                      st1.actor_params, st1.actor_opt))
    else:
        # no actor step: the actor's AdamW never ran
        assert not port.actor_state.optimizer.state
    for label, module, state, params, opt in parts:
        want_p, want_m = _flat(params), _moments(opt)
        assert len(want_p) == len(list(module.parameters())), label
        for name, p in module.named_parameters():
            path = _flax_path(name)
            m = state.optimizer.state[p]["exp_avg"].numpy()
            ref_m = want_m[path]
            if p.ndim == 2 and "convnet" not in name:
                m, got = m.T, p.detach().numpy().T
            elif p.ndim == 4:
                m = np.transpose(m, (2, 3, 1, 0))
                got = np.transpose(p.detach().numpy(), (2, 3, 1, 0))
            else:
                got = p.detach().numpy()
            scale = max(np.abs(ref_m).max(), 1e-30)
            assert np.abs(m - ref_m).max() <= 1e-5 * scale, (label, name)
            _hold(f"{label}.{name}", got, want_p[path], ref_m)
    want_t = _flat(st1.critic_target_params)
    for name, p in port.critic_target.named_parameters():
        got = p.detach().numpy()
        got = got.T if p.ndim == 2 else got
        # the Polyak average of the updated critic: tau times its 1e-6
        np.testing.assert_allclose(got, want_t[_flax_path(name)], rtol=0,
                                   atol=1e-6, err_msg=name)


def test_update_cadence_and_draws():
    """``update`` skips the steps between ``update_every_steps``, takes the
    actor step every ``delay_steps`` updates, and draws shifts in [0, 8]
    and normals from its own seeded generator: two agents on the same
    numpy stream update alike."""
    runs = []
    for _ in range(2):
        np.random.seed(0)
        port = tdrq.DrQV2Agent(OBS, A, lr=LR, feature_dim=FEAT,
                               hidden_dim=HID, seed=1, device="cpu",
                               update_every_steps=2, delay_steps=2)
        out = [port.update(_batch(20 + s), s) for s in range(4)]
        runs.append((out, {k: v.clone() for k, v in
                           port.state_dict().items()}))
    (out, sd), (out2, sd2) = runs
    assert out[1] == {} and out[3] == {}
    assert "actor_loss" in out[0] and "actor_loss" not in out[2]
    assert out == out2
    for k in sd:
        assert torch.equal(sd[k], sd2[k]), k
    # optax.adamw(lr, weight_decay=1e-6): one group, every parameter
    for name, state in port.train_states().items():
        (group,) = state.optimizer.param_groups
        # the fixed schedule gives lr as a float32, as optax does
        assert group["weight_decay"] == 1e-6, name
        assert group["lr"] == float(np.float32(LR)), name
        assert len(group["params"]) == len(list(state.model.parameters()))
        assert state.max_grad_norm is None
    d = tdrq.update_draws(64, A, torch.Generator().manual_seed(0))
    assert d.shift_obs.min() >= 0 and d.shift_obs.max() == 8
    assert d.next_noise.shape == (64, A)


def test_act_matches_jax():
    agent, port = _jax_agent(seed=30, num_expl_steps=5)
    obs = _obs(31, n=1)[0]
    for step in (0, 4):
        np.random.seed(step)
        want = agent.act(obs, step, eval_mode=False)
        np.random.seed(step)
        got = port.act(obs, step, eval_mode=False)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32
    np.random.seed(1)
    want = agent.act(obs, 10, eval_mode=True)
    got = port.act(obs, 10, eval_mode=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    noisy = port.act(obs, 10, eval_mode=False)
    assert noisy.shape == (A,) and (np.abs(noisy) < 1).all()
    assert not np.array_equal(noisy, got)


def test_agent_wants_cuda():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tdrq.DrQV2Agent(OBS, A)
