"""The tokenizer-training slice of the PyTorch port against the JAX package,
on the CPU in fp32 (the VQ lookup is the plain version there; K1 and K2 are
held against it on the card):

- the tokenizer's training forward (``deterministic=True``): dec, ref_dec,
  both commit losses and ``pre_out``;
- one generator step with and without GAN and one discriminator step:
  loss, metrics (the adaptive weight and the ``grad_norm/<a>/<b>`` groups
  included) and every gradient against the JAX steps, whose gradients are
  read through an optax transformation that keeps them; the eval step;
- the tokenizer's weight-decay mask name by name and its Flax paths, the
  dropout of the training forward, and a bf16 G+D pair.

Cross-attention dropout is set to 0 through ``.replace`` for every parity
check: the two frameworks cannot draw the same dropout masks. The
discriminator and LPIPS modules are held on their own in
``tests/test_torch_discriminator.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ivideogpt_tpu.configs import TokenizerTrainConfig
from ivideogpt_tpu.train import optim as joptim
from ivideogpt_tpu.train import tokenizer_trainer as jtrain
from ivideogpt_tpu_torch.models import discriminator as tdisc
from ivideogpt_tpu_torch.ops import vq as tvq
from ivideogpt_tpu_torch.train import optim as toptim
from ivideogpt_tpu_torch.train import tokenizer_trainer as ttrain
from ivideogpt_tpu_torch.utils import checkpoint as port_ckpt
from tests.test_tokenizer_model import TINY
from tests.test_torch_checkpoint import make_tokenizer, port_config
from tests.test_torch_discriminator import (DISC, RES, close,
                                            make_disc_and_lpips, pixels,
                                            stats_of, jax_stats)

B, CTX, T = 2, 2, 5
CFG = TINY.replace(cross_attn_dropout=0.0)
TRAIN = TokenizerTrainConfig(segment_length=T, context_length=CTX,
                             learning_rate=5e-4, disc_learning_rate=5e-4,
                             lr_warmup_steps=0)
PORT_TRAIN = port_config(TRAIN)


@pytest.fixture(scope="module")
def models():
    """One JAX init of each module, jittered, and the port's modules
    loaded from it."""
    model, params, port = make_tokenizer(CFG, seed=0, T=T)
    return dict(model=model, params=params, port=port.train(),
                **make_disc_and_lpips())


def _pixels(seed):
    return pixels(seed, (B, T, RES, RES, 3))


def _keep_grads():
    """An optax transformation that applies nothing and keeps the last
    gradients as its state: the JAX steps' gradients, read exactly."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads
    return optax.GradientTransformation(init, update)


def _capture(state):
    """Make the port's state keep its gradients instead of updating."""
    grads = []
    state.apply_gradients = lambda: grads.append(
        [p.grad.detach().clone() for p in state.params])
    return grads


def _grads_close(ours, want, rel):
    """Each gradient within ``rel`` of its largest element, plus a floor of
    1e-6 of the largest gradient overall: a bias in front of a
    normalisation (InstanceNorm, a softmax's key bias) has a gradient that
    is zero but for rounding."""
    gmax = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, g in ours.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=0,
            atol=rel * float(np.abs(ref).max()) + 1e-6 * gmax, err_msg=name)


# ----------------------------------------------------------------------
# the training forward


def test_training_forward_matches_jax(models):
    model, params, port = models["model"], models["params"], models["port"]
    px = _pixels(8)
    ctx = px[:, :CTX].reshape(-1, RES, RES, 3)
    fut = px[:, CTX:].reshape(-1, RES, RES, 3)
    ref = jax.jit(lambda p, c, f: model.apply(
        p, c, f, T - CTX, deterministic=True, return_pre_out=True))(
        params, jnp.asarray(ctx), jnp.asarray(fut))
    with torch.no_grad():
        ours = port(torch.from_numpy(ctx), torch.from_numpy(fut), T - CTX,
                    deterministic=True, return_pre_out=True)
    names = ("dec", "ref_dec", "commit", "dyn_commit", "pre_out")
    shapes = ((B * (T - CTX), RES, RES, 3), (B * CTX, RES, RES, 3), (), (),
              (B * (T - CTX), RES, RES, CFG.block_out_channels[0]))
    for name, o, r, shape in zip(names, ours, ref, shapes):
        assert tuple(o.shape) == tuple(r.shape) == shape, name
        # fp32 with equal ids (checked by tests/test_torch_tokenizer.py):
        # the decoders' sums in another order, as detokenize's 1e-4
        close(o, r, 1e-4, 1e-4, name)


def test_training_forward_refuses_remat(models):
    from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
    port = CompressiveVQModel(port_config(CFG.replace(remat=True)))
    x = torch.zeros(CTX, RES, RES, 3)
    with pytest.raises(NotImplementedError):
        port(x, torch.zeros(T - CTX, RES, RES, 3), T - CTX)


# ----------------------------------------------------------------------
# the steps


def _disc_vars(models):
    return jax.tree_util.tree_map(jnp.asarray, models["dvars"])


def _generator_step_pair(models, use_gan, perc_weight, seed):
    """One generator step of each package from the same weights, pixels and
    discriminator: (port metrics, JAX metrics, port grads, JAX grads), the
    gradients by the port's names, before any update."""
    model, params, port = models["model"], models["params"], models["port"]
    cfg = TRAIN.replace(perc_weight=perc_weight)
    px = _pixels(seed)
    jstep = jtrain.make_generator_step(model, models["disc"], models["lpips"],
                                       jax.tree_util.tree_map(
                                           jnp.asarray, models["lparams"]),
                                       cfg, use_gan=use_gan)
    jstate = joptim.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), _keep_grads())
    jstate, jm = jstep(jstate, _disc_vars(models), jnp.asarray(px),
                       jax.random.key(0))
    want = port_ckpt.tokenizer_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.opt_state))

    state, _ = ttrain.create_train_states(port, models["port_disc"],
                                          port_config(cfg))
    grads = _capture(state)
    stats = stats_of(models["port_disc"])
    step = ttrain.make_generator_step(port, models["port_disc"],
                                      models["port_lpips"], port_config(cfg),
                                      use_gan=use_gan)
    m = step(state, torch.from_numpy(px), torch.Generator().manual_seed(0))
    # the G step reads the discriminator's stats and leaves them
    for k, v in stats_of(models["port_disc"]).items():
        np.testing.assert_array_equal(v, stats[k], err_msg=k)
    assert sorted(m) == sorted(jm)
    names = [n for n, _ in port.named_parameters()]
    return m, jm, dict(zip(names, grads[0])), {n: want[n] for n in names}


LOSSES = ("recon_loss", "ref_recon_loss", "perceptual_loss",
          "ref_perceptual_loss", "commit_loss", "dyn_commit_loss", "gan_loss",
          "gen_loss")


def test_generator_step_with_gan_matches_jax(models):
    """Every loss term but LPIPS' in the gradient (perc_weight 0; LPIPS
    still drives the adaptive weight): recon, commit, the straight-through
    estimator, the GAN loss and the adaptive weight."""
    m, jm, grads, want = _generator_step_pair(models, True, 0.0, seed=10)
    assert 0 < float(m["adaptive_weight"]) < 1e4
    for key, v in m.items():
        # fp32 sums in another order; the adaptive weight's LPIPS gradient
        # sits behind ReLU kinks (see the next test): 2e-4 measured
        close(v, jm[key], 1e-3, 1e-6, key)
    # within 1e-3 of each gradient's largest element: 2.5e-4 measured
    _grads_close(grads, want, 1e-3)


def test_generator_step_with_perceptual_loss_matches_jax(models):
    """The recipe's weights without GAN: LPIPS in the loss. LPIPS' gradient
    is a discontinuous function of its input (ReLU and max-pool kinks of
    the VGG), and its input, the decoder's output, differs between the
    frameworks by fp32 rounding (~1e-6): moving the pixels by 1e-7 moves
    the port's own gradients by up to 1 % (measured). So the losses are
    held tightly, the gradients by their norms."""
    m, jm, grads, want = _generator_step_pair(models, False, 1.0, seed=9)
    for key in LOSSES[:6] + ("gen_loss",):
        # forward values: fp32 sums in another order
        close(m[key], jm[key], 1e-5, 1e-7, key)
    for key in (k for k in m if k.startswith("grad_norm")):
        # gradient norms: 2e-3 measured
        close(m[key], jm[key], 1e-2, 1e-7, key)
    diff2 = sum(float(((g - want[n]) ** 2).sum()) for n, g in grads.items())
    ref2 = sum(float((w ** 2).sum()) for w in want.values())
    # all gradients together: 1.8e-3 measured
    assert diff2 ** 0.5 < 1e-2 * ref2 ** 0.5
    for name, g in grads.items():
        # each tensor: 4e-3 of its norm measured; the floor as above
        err = float((g - want[name]).norm())
        assert err < 3e-2 * float(want[name].norm()) + 1e-5 * ref2 ** 0.5, \
            name


def test_discriminator_step_matches_jax(models):
    model, params = models["model"], models["params"]
    dvars = models["dvars"]
    px = _pixels(11)
    jstep = jtrain.make_discriminator_step(model, models["disc"], TRAIN)
    jstate = joptim.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, dvars["params"]), _keep_grads())
    jstate, jstats, jm = jstep(
        jstate, {"batch_stats": jax.tree_util.tree_map(
            jnp.asarray, dvars["batch_stats"])},
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(px),
        jax.random.key(0))
    want = port_ckpt.discriminator_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, jstate.opt_state)})

    port_disc = tdisc.Discriminator(port_config(DISC))
    port_disc.load_state_dict(port_ckpt.discriminator_state_dict(dvars))
    _, disc_state = ttrain.create_train_states(models["port"], port_disc,
                                               PORT_TRAIN)
    grads = _capture(disc_state)
    step = ttrain.make_discriminator_step(models["port"], port_disc,
                                          PORT_TRAIN)
    m = step(disc_state, torch.from_numpy(px),
             torch.Generator().manual_seed(0))
    assert sorted(m) == sorted(jm)
    for key, v in m.items():
        close(v, jm[key], 1e-4, 1e-6, key)
    names = [n for n, _ in port_disc.named_parameters()]
    # fp32 sums in another order
    _grads_close(dict(zip(names, grads[0])), want, 1e-4)
    # the second call's stats: u advanced one power iteration, not two
    for k, v in jax_stats(jstats["batch_stats"]).items():
        close(stats_of(port_disc)[k], v, 1e-5, 1e-6, k)


def test_eval_step_matches_jax(models):
    px = _pixels(12)
    jstep = jtrain.make_eval_step(models["model"], models["lpips"],
                                  jax.tree_util.tree_map(
                                      jnp.asarray, models["lparams"]), TRAIN)
    jm, jdec, _ = jstep(jax.tree_util.tree_map(jnp.asarray, models["params"]),
                        jnp.asarray(px))
    m, dec, _ = ttrain.make_eval_step(models["port"], models["port_lpips"],
                                      PORT_TRAIN)(torch.from_numpy(px))
    assert sorted(m) == sorted(jm)
    for key, v in m.items():
        close(v, jm[key], 1e-4, 1e-6, key)
    close(dec, jdec, 1e-4, 1e-4, "dec")


def test_weight_decay_mask_matches_jax(models):
    params = models["params"]
    mask = jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32),
        joptim._no_wd_mask(params), params)
    # the mask, broadcast to each leaf, through the bridge's name mapping
    want = port_ckpt.tokenizer_state_dict(mask)
    got = {n: toptim.decays(n, p) for n, p in models["port"].named_parameters()}
    assert sorted(got) == sorted(want)
    for n, d in got.items():
        assert bool(want[n].flatten()[0]) == d, n
    assert not got["quantize.embedding.weight"]
    assert not got["cond_encoder.cross_att_blocks.0.kv_pos_emb"]
    assert got["cond_encoder.cross_att_blocks.0.att.in_proj_weight"]


def test_flax_tree_inverts_the_bridge(models):
    """The port's tensors under their Flax paths, as views, give back the
    JAX tree exactly: the keys of the ``grad_norm/<a>/<b>`` groups."""
    tree = port_ckpt.tokenizer_flax_tree(
        dict(models["port"].named_parameters()))
    flat = port_ckpt._flatten(models["params"]["params"])
    assert sorted(tree) == sorted(flat)
    for path, v in tree.items():
        np.testing.assert_array_equal(v.detach().numpy(), flat[path],
                                      err_msg=path)


# ----------------------------------------------------------------------
# dropout, and the bf16 pair


def test_training_forward_dropout_is_drawn_from_the_generator(models):
    from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
    port = CompressiveVQModel(port_config(TINY))   # cross_attn_dropout 0.1
    port.load_state_dict(models["port"].state_dict())
    px = torch.from_numpy(_pixels(13))
    ctx, fut = ttrain.split_frames(px, CTX)

    def run(deterministic, seed):
        with torch.no_grad():
            return port(ctx, fut, T - CTX, deterministic=deterministic,
                        generator=torch.Generator().manual_seed(seed))[0]
    a, b, c = run(False, 0), run(False, 0), run(False, 1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a, run(True, 0))


def test_bf16_pair_on_the_cpu():
    tok, disc, lp = ttrain.build_tokenizer_train_models(
        port_config(TINY), port_config(DISC), seed=3, device="cpu")
    assert tok.dtype == torch.bfloat16 and tok.training
    assert all(p.dtype == torch.float32 for m in (tok, disc, lp)
               for p in m.parameters())
    assert not any(p.requires_grad for p in lp.parameters())
    cfg = PORT_TRAIN
    state, disc_state = ttrain.create_train_states(tok, disc, cfg)
    g_step = ttrain.make_generator_step(tok, disc, lp, cfg, use_gan=True)
    d_step = ttrain.make_discriminator_step(tok, disc, cfg)
    gen = torch.Generator().manual_seed(0)
    px = torch.from_numpy(_pixels(14))
    launches = (tvq.vq_argmin.launches, tvq.vq_argmin_tiled.launches)
    for _ in range(2):
        m, dm = g_step(state, px, gen), d_step(disc_state, px, gen)
    for k, v in {**m, **dm}.items():
        assert torch.isfinite(v).all(), k
    assert m["recon_loss"].dtype == torch.float32
    assert state.updates == disc_state.updates == 2
    # CPU tensors take the plain version: no kernel launch counted
    assert (tvq.vq_argmin.launches, tvq.vq_argmin_tiled.launches) == launches
