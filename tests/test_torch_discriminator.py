"""The tokenizer-training slice's loss modules of the PyTorch port against
the JAX package, on the CPU in fp32: the discriminator (Flax spectral norm,
the stats after ``update_stats``), ``hinge_d_loss``, ``gen_loss``, LPIPS
(forward and gradient), their weight bridges, dropout's statistics and the
trainer configs. The helpers here (JAX init -> port modules) are shared
with ``tests/test_torch_tokenizer_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu.configs import DiscriminatorConfig, TokenizerTrainConfig
from ivideogpt_tpu.models.discriminator import Discriminator as JaxDisc
from ivideogpt_tpu.models.discriminator import gen_loss as jax_gen_loss
from ivideogpt_tpu.models.discriminator import hinge_d_loss as jax_hinge
from ivideogpt_tpu.models.lpips import LPIPS as JaxLPIPS
from ivideogpt_tpu.train import optim as joptim
from ivideogpt_tpu_torch.models import discriminator as tdisc
from ivideogpt_tpu_torch.models.layers import dropout
from ivideogpt_tpu_torch.models.lpips import LPIPS
from ivideogpt_tpu_torch.train import optim as toptim
from ivideogpt_tpu_torch.utils import checkpoint as port_ckpt
from tests.test_torch_checkpoint import jitter, port_config, to_numpy_tree

RES = 32
# the small discriminator of tests/multiproc_worker.py: 32 -> 4 px logits
DISC = DiscriminatorConfig(depth=3, hidden_channels=64)


def make_disc_and_lpips():
    """JAX inits of the discriminator and LPIPS (parameters jittered, so the
    zero biases and the all-ones LPIPS heads take part) and the port's
    modules loaded from them with ``strict=True``."""
    disc = JaxDisc(DISC)
    dvars = to_numpy_tree(jax.jit(disc.init)(
        jax.random.key(1), jnp.zeros((2, RES, RES, 3), jnp.float32)))
    dvars = {"params": jitter(dvars["params"], 1),
             "batch_stats": dvars["batch_stats"]}
    port_disc = tdisc.Discriminator(port_config(DISC))
    port_disc.load_state_dict(port_ckpt.discriminator_state_dict(dvars),
                              strict=True)
    lpips = JaxLPIPS()
    lparams = to_numpy_tree(jax.jit(lpips.init)(
        jax.random.key(2), jnp.zeros((1, RES, RES, 3)),
        jnp.zeros((1, RES, RES, 3))))
    lparams = jitter(lparams, 2, std=0.05)
    port_lpips = LPIPS()
    port_lpips.load_state_dict(port_ckpt.lpips_state_dict(lparams),
                               strict=True)
    port_lpips.requires_grad_(False)
    return dict(disc=disc, dvars=dvars, port_disc=port_disc, lpips=lpips,
                lparams=lparams, port_lpips=port_lpips)


def pixels(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def close(ours, theirs, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(theirs, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def stats_of(port_disc):
    return {n: b.detach().numpy() for n, b in port_disc.named_buffers()}


def jax_stats(stats):
    """Flax batch_stats -> the port's buffer names."""
    return {k: v.numpy() for k, v in port_ckpt.discriminator_state_dict(
        {"params": {}, "batch_stats": to_numpy_tree(stats)}).items()}


@pytest.fixture(scope="module")
def models():
    return make_disc_and_lpips()


def test_discriminator_bridge_and_forward_match_flax(models):
    disc, dvars, port = models["disc"], models["dvars"], models["port_disc"]
    sd = port_ckpt.discriminator_state_dict(dvars)
    assert sorted(sd) == sorted(port.state_dict())
    x = pixels(3, (3, RES, RES, 3))
    before = stats_of(port)
    ref = disc.apply(dvars, jnp.asarray(x), update_stats=False)
    with torch.no_grad():
        ours = port(torch.from_numpy(x), update_stats=False)
    assert ours.shape == ref.shape == (3, RES // 8, RES // 8, 1)
    # fp32 convs and one power iteration, sums in another order
    close(ours, ref, 1e-5, 1e-5, "logits")
    for k, v in stats_of(port).items():   # update_stats=False stores nothing
        np.testing.assert_array_equal(v, before[k], err_msg=k)


def test_discriminator_stats_after_update_match_flax(models):
    disc, dvars = models["disc"], models["dvars"]
    port = tdisc.Discriminator(port_config(DISC))
    port.load_state_dict(port_ckpt.discriminator_state_dict(dvars))
    x = pixels(4, (2, RES, RES, 3))
    ref, new = disc.apply(dvars, jnp.asarray(x), update_stats=True,
                          mutable=["batch_stats"])
    with torch.no_grad():
        ours = port(torch.from_numpy(x), update_stats=True)
    close(ours, ref, 1e-5, 1e-5, "logits")
    want = jax_stats(new["batch_stats"])
    got = stats_of(port)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        # u is unit-norm and sigma O(1): one iteration in another order
        close(v, want[k], 1e-5, 1e-6, k)
        assert not np.array_equal(v, jax_stats(dvars["batch_stats"])[k]), k


def test_hinge_and_generator_losses_match_jax():
    rng = np.random.default_rng(5)
    real, fake = (rng.normal(size=(4, 2, 2, 1)).astype(np.float32) * 2
                  for _ in range(2))
    ours = tdisc.hinge_d_loss(torch.from_numpy(real), torch.from_numpy(fake))
    close(ours, jax_hinge(jnp.asarray(real), jnp.asarray(fake)), 1e-6, 0,
          "hinge")
    close(tdisc.gen_loss(torch.from_numpy(fake)),
          jax_gen_loss(jnp.asarray(fake)), 1e-6, 0, "gen_loss")


def test_lpips_forward_matches_flax(models):
    a, b = (pixels(s, (3, RES, RES, 3)) * 2 - 1 for s in (6, 7))
    ref = jax.jit(models["lpips"].apply)(models["lparams"], jnp.asarray(a),
                                         jnp.asarray(b))
    with torch.no_grad():
        ours = models["port_lpips"](torch.from_numpy(a), torch.from_numpy(b))
    assert ours.shape == (3,)
    # fp32 VGG convs in another order, then a normalised difference
    close(ours, ref, 1e-5, 1e-7, "lpips")


def test_lpips_gradient_matches_jax(models):
    """LPIPS' gradient on fixed inputs, where no ReLU kink moves (see
    tests/test_torch_tokenizer_train.py for inputs that come out of a
    decoder)."""
    a, b = (pixels(s, (2, RES, RES, 3)) * 2 - 1 for s in (15, 16))
    ref = jax.jit(jax.grad(lambda x: models["lpips"].apply(
        models["lparams"], jnp.asarray(a), x).mean()))(jnp.asarray(b))
    bt = torch.from_numpy(b).requires_grad_()
    models["port_lpips"](torch.from_numpy(a), bt).mean().backward()
    # fp32 VGG backward in another order: 7e-6 of the norm measured
    err = np.linalg.norm(bt.grad.numpy() - np.asarray(ref))
    assert err < 1e-4 * np.linalg.norm(np.asarray(ref))


def test_lpips_bridge_loads_strictly(models):
    sd = port_ckpt.lpips_state_dict(models["lparams"])
    assert sorted(sd) == sorted(models["port_lpips"].state_dict())
    assert [k for k in sd if k.startswith("lin")] == [f"lin{s}"
                                                      for s in range(5)]
    for k, v in models["port_lpips"].state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)


def test_discriminator_weight_decay_mask_matches_jax(models):
    params = models["dvars"]["params"]
    mask = jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32),
        joptim._no_wd_mask(params), params)
    want = port_ckpt.discriminator_state_dict({"params": mask})
    got = {n: toptim.decays(n, p)
           for n, p in models["port_disc"].named_parameters()}
    assert sorted(got) == sorted(want)   # u and sigma are buffers
    for n, d in got.items():
        assert bool(want[n].flatten()[0]) == d, n
    assert got["conv_in.weight"] and not got["conv_in.bias"]


def test_dropout_statistics_and_repeatable_draws():
    x = torch.ones(400_000)
    out = dropout(x, 0.1, False, torch.Generator().manual_seed(0))
    kept = out != 0
    # binomial(4e5, 0.9): 5 standard deviations are 0.0024
    assert abs(float(kept.float().mean()) - 0.9) < 0.0025
    # kept values scaled by 1 / 0.9 (one fp32 division)
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.9),
                               rtol=1e-7, atol=0)
    again = dropout(x, 0.1, False, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert torch.equal(dropout(x, 0.1, True), x)
    assert torch.equal(dropout(x, 0.0, False), x)


def test_trainer_configs_round_trip_through_json():
    from ivideogpt_tpu_torch import configs as tcfg
    for jax_cfg in (DiscriminatorConfig(), TokenizerTrainConfig(), DISC):
        assert port_config(jax_cfg).to_json() == jax_cfg.to_json()
    assert port_config(TokenizerTrainConfig()) == tcfg.TokenizerTrainConfig()
    assert port_config(DiscriminatorConfig()) == tcfg.DiscriminatorConfig()
