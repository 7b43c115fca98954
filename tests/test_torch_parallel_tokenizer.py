"""The port's data-parallel tokenizer (VQGAN) training on the CPU: 2 ranks
over gloo (``tests/torch_parallel_worker.py``), 3 alternating G, D, G
steps with the GAN on from step 0 (``disc_start=0``) on the JAX worker's
tokenizer (``tests/multiproc_worker.py:154-166``, global batch 8), against
the JAX package's single-process steps: every loss, the adaptive weight
(whose two last-layer gradients are averaged over the data group before
their norms) and the gradient norms within rtol 2e-4 (the JAX
multi-process test's tolerance); both models, the discriminator's
spectral-norm ``u`` buffers included, bit-identical across the ranks.
Cross-attention dropout is 0 (the frameworks cannot draw one mask) and
LPIPS weighs 0 in the loss (its kinks make trajectories chaotic under
rounding; it still drives the adaptive weight)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu.configs import TokenizerTrainConfig
from ivideogpt_tpu.train import optim as joptim
from ivideogpt_tpu.train import tokenizer_trainer as jtrain
from ivideogpt_tpu_torch.train import tokenizer_trainer as ttrain
from ivideogpt_tpu_torch.utils import checkpoint as port_ckpt
from tests import torch_parallel_worker as W
from tests.test_tokenizer_model import TINY
from tests.test_torch_checkpoint import make_tokenizer, port_config
from tests.test_torch_discriminator import DISC, RES, make_disc_and_lpips

CTX, T, GB = 2, 4, 8
CFG = TINY.replace(cross_attn_dropout=0.0)
TRAIN = TokenizerTrainConfig(segment_length=T, context_length=CTX,
                             disc_start=0, learning_rate=1e-4,
                             disc_learning_rate=1e-4, lr_warmup_steps=0,
                             max_train_steps=10, weight_decay=1e-4,
                             perc_weight=0.0)
KEYS = {0: ("gen_loss", "recon_loss", "gan_loss", "adaptive_weight",
            "commit_loss", "grad_norm"),
        1: ("discr_loss", "real_logits", "fake_logits", "disc_grad_norm")}


@pytest.fixture(scope="module")
def setup():
    model, params, port = make_tokenizer(CFG, seed=0, T=T)
    dl = make_disc_and_lpips()
    rng = np.random.default_rng(0)
    px = rng.uniform(0, 1, (GB, T, RES, RES, 3)).astype(np.float32)
    inputs = {"tok_json": port.config.to_json(), "tok_sd": port.state_dict(),
              "disc_json": port_config(DISC).to_json(),
              "disc_sd": dl["port_disc"].state_dict(),
              "lpips_sd": dl["port_lpips"].state_dict(),
              "train_json": port_config(TRAIN).to_json(),
              "pixels": torch.from_numpy(px)}
    return dict(model=model, params=params, px=px, inputs=inputs, **dl)


@pytest.fixture(scope="module")
def jax_metrics(setup):
    """The JAX single-process G, D, G steps on the whole batch."""
    kw = dict(learning_rate=1e-4, warmup_steps=0, total_steps=10,
              weight_decay=1e-4)
    params = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    dvars = jax.tree_util.tree_map(jnp.asarray, setup["dvars"])
    state = joptim.TrainState.create(
        params, joptim.make_optimizer(params, **kw)[0])
    disc_state = joptim.TrainState.create(
        dvars["params"], joptim.make_optimizer(dvars["params"], **kw)[0])
    stats = {k: v for k, v in dvars.items() if k != "params"}
    g = jtrain.make_generator_step(
        setup["model"], setup["disc"], setup["lpips"],
        jax.tree_util.tree_map(jnp.asarray, setup["lparams"]), TRAIN,
        use_gan=True)
    d = jtrain.make_discriminator_step(setup["model"], setup["disc"], TRAIN)
    px = jnp.asarray(setup["px"])
    out = []
    for i in range(3):
        if i % 2 == 0:
            state, m = g(state, {"params": disc_state.params, **stats}, px,
                         jax.random.key(i))
        else:
            disc_state, stats, m = d(disc_state, stats, state.params, px,
                                     jax.random.key(i))
        out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    return W.run_ranks("tokenizer", 2, tmp_path_factory.mktemp("tok"),
                       setup["inputs"])


def test_dp_steps_match_the_jax_single_process_steps(ranks, jax_metrics):
    for rank in ranks:
        for i, (got, want) in enumerate(zip(rank["metrics"], jax_metrics)):
            for k in KEYS[i % 2]:
                np.testing.assert_allclose(got[k], want[k], rtol=2e-4,
                                           atol=2e-6, err_msg=f"{i} {k}")


def test_dp_ranks_hold_bit_identical_models(ranks):
    for key in ("tok", "disc", "disc_buffers"):
        assert ranks[0][key] == ranks[1][key], key


def test_dp_adaptive_weight_is_the_global_batchs(ranks, setup):
    """The port's one-process steps on the whole batch give the ranks'
    adaptive weight; one rank's rows alone give another."""
    one = W.tokenizer_run(setup["inputs"])
    for i in (0, 2):
        np.testing.assert_allclose(
            [r["metrics"][i]["adaptive_weight"] for r in ranks],
            [one["metrics"][i]["adaptive_weight"]] * 2, rtol=1e-5)
    half = W.tokenizer_run({**setup["inputs"],
                            "pixels": setup["inputs"]["pixels"][:GB // 2]},
                           steps=1)
    assert abs(half["metrics"][0]["adaptive_weight"]
               - one["metrics"][0]["adaptive_weight"]) > 1e-4 * abs(
        one["metrics"][0]["adaptive_weight"])
    for name, t in one["tok_sd"].items():
        np.testing.assert_allclose(ranks[0]["tok_sd"][name].numpy(),
                                   t.numpy(), rtol=0, atol=2e-4, err_msg=name)


def test_dropout_streams_differ_across_data_ranks():
    from ivideogpt_tpu_torch import train_tokenizer as tt
    dev = torch.device("cpu")
    draw = [torch.rand(8, generator=tt.step_generator(3, 5, dev, r))
            for r in (0, 0, 1, 2)]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    assert not torch.equal(draw[2], draw[3])
    # data rank 0 draws what one process draws
    s = np.random.SeedSequence((3, 5)).generate_state(1, np.uint64)[0]
    assert torch.equal(draw[0], torch.rand(
        8, generator=torch.Generator().manual_seed(int(s))))


def test_scale_lr_counts_the_data_ranks():
    from ivideogpt_tpu_torch import train_tokenizer as tt
    args = tt.parse_args(["--scale_lr", "--batch_size", "4",
                          "--learning_rate", "1e-5",
                          "--gradient_accumulation_steps", "2"])
    assert tt.train_config(args, 3).learning_rate == pytest.approx(
        1e-5 * 4 * 3 * 2)
    assert tt.train_config(args).learning_rate == pytest.approx(1e-5 * 8)
    assert ttrain.make_generator_step  # the factories take mesh=
