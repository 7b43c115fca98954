"""The port's data- and tensor-parallel GPT training on the CPU: 2 ranks
over gloo, spawned as subprocesses (``tests/torch_parallel_worker.py``),
against the JAX package's single-process step on the same global batch
(the JAX worker's GPT, ``tests/multiproc_worker.py:74-82``, global batch
8):

- DP=2 and TP=2 (dropout 0): 3 steps' losses and gradient norms within
  the JAX multi-process test's own tolerance (rtol 2e-4, atol 2e-5) of
  ``make_train_step``'s, the parameters within Adam's step bound;
  parameters bit-identical across the data ranks;
- DP=2 with attention dropout 0.1 equal to the port's own 1-process run
  (the masks are drawn at global rows, so the ranks drop what one process
  drops);
- TP=2 teacher-forced logits against ``model.apply`` (atol = rtol = 2e-5,
  as ``tests/test_sharded_generation.py`` holds JAX's own TP);
- the port's ``param_spec`` against JAX's on every LLaMA parameter, and
  the refusals: indivisible KV heads, MLP width and batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu import tokens as jtokens
from ivideogpt_tpu.configs import ActionModelConfig, TransformerConfig
from ivideogpt_tpu.models.action_model import HeadModelWithAction
from ivideogpt_tpu.parallel import mesh as jmesh
from ivideogpt_tpu.train import gpt_trainer as jtrain
from ivideogpt_tpu.train import optim as joptim
from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
from ivideogpt_tpu_torch.train import gpt_trainer as ttrain
from ivideogpt_tpu_torch.utils import checkpoint as port_ckpt
from tests import torch_parallel_worker as W

LR = 1e-4  # the recipe's: Adam moves a near-zero gradient's element ~lr
KW = dict(learning_rate=LR, lr_scheduler="cosine", warmup_steps=1,
          total_steps=10, weight_decay=0.01, max_grad_norm=1.0)
STEPS = 3


def _batch():
    rng = np.random.default_rng(0)
    L = jtokens.seq_len(W.CTX, W.T, ctx_tokens=W.NCTX, dyn_tokens=W.NDYN)
    ids = rng.integers(0, 128, (W.GB, L)).astype(np.int64)
    act = rng.normal(size=(W.GB, W.T, W.ACTION_DIM)).astype(np.float32)
    return ids, act


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX model, its params, the port's state dict of them, the batch
    and the JAX single-process trajectory."""
    model = HeadModelWithAction(TransformerConfig(**W.LM),
                                ActionModelConfig(**W.HEAD))
    ids, act = _batch()
    params = model.init(jax.random.key(0), jnp.asarray(ids, jnp.int32),
                        jnp.asarray(ids, jnp.int32), jnp.asarray(act))
    host = jax.tree_util.tree_map(np.asarray, params)  # the step donates
    sd = port_ckpt.action_model_state_dict(host)
    tx, _ = joptim.make_optimizer(params, **KW)
    state = joptim.TrainState.create(params, tx)
    step = jtrain.make_train_step(model, action_conditioned=True)
    batch = {"input_ids": jnp.asarray(ids, jnp.int32),
             "labels": jnp.asarray(ids, jnp.int32),
             "action": jnp.asarray(act)}
    losses, norms = [], []
    for i in range(STEPS):
        state, m = step(state, batch, jax.random.key(1 + i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    final = port_ckpt.action_model_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params))
    return dict(model=model, params=host, sd=sd, ids=ids, act=act,
                losses=losses, norms=norms, final=final)


def _tbatch(ref):
    ids = torch.from_numpy(ref["ids"])
    return {"input_ids": ids, "labels": ids.clone(),
            "action": torch.from_numpy(ref["act"])}


@pytest.fixture(scope="module")
def ranks(jax_ref, tmp_path_factory):
    """One 2-rank spawn: DP=2 without dropout, DP=2 with dropout 0.1, TP=2
    without dropout, LoRA at DP=2 with dropout 0.1; each rank's outputs."""
    drop = TransformerConfig(**{**W.LM, "attention_dropout": 0.1}).to_json()
    inputs = {"state_dict": jax_ref["sd"], "batch": _tbatch(jax_ref),
              "steps": STEPS, "lr": LR, "seed": 7,
              "runs": [{"n_model": 1}, {"n_model": 1, "lm_json": drop},
                       {"n_model": 2},
                       {"n_model": 1, "lm_json": drop, "lora": True}]}
    return W.run_ranks("gpt", 2, tmp_path_factory.mktemp("gpt"), inputs)


def _one_process(jax_ref, lm_json=None):
    """The port's own 1-process run of the same steps."""
    model = W.lm_model(lm_json, None, jax_ref["sd"])
    state = W.train_state(model, LR)
    batch = _tbatch(jax_ref)
    out = [ttrain.train_step(state, batch, rng=(7, i)) for i in range(STEPS)]
    return ([float(m["loss"]) for m in out], model.state_dict())


def _against_jax(run, jax_ref):
    np.testing.assert_allclose(run["losses"], jax_ref["losses"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(run["grad_norms"], jax_ref["norms"],
                               rtol=2e-4, atol=2e-5)
    for name, want in jax_ref["final"].items():
        # Adam's update of an element is at most ~lr a step whatever its
        # gradient, so rounding near a zero gradient moves it by < 2 lr
        np.testing.assert_allclose(run["params"][name].numpy(),
                                   want.numpy(), rtol=0, atol=2 * LR,
                                   err_msg=name)


@pytest.mark.parametrize("run", [0, 2], ids=["dp2", "tp2"])
def test_two_ranks_match_the_jax_single_process_step(ranks, jax_ref, run):
    for rank in ranks:
        _against_jax(rank[run], jax_ref)


def test_data_ranks_hold_bit_identical_parameters(ranks):
    for run in (0, 1):
        assert ranks[0][run]["digest"] == ranks[1][run]["digest"]
        assert ranks[0][run]["mesh"] == {"data": 2, "model": 1}
    # TP: each rank holds its own shard, and both write one full state
    tp0, tp1 = ranks[0][2], ranks[1][2]
    assert tp0["mesh"] == {"data": 1, "model": 2}
    assert tp0["digest"] != tp1["digest"]
    for name, t in tp0["params"].items():
        assert torch.equal(t, tp1["params"][name]), name


def test_dp_dropout_equals_the_one_process_run(ranks, jax_ref):
    drop = TransformerConfig(**{**W.LM, "attention_dropout": 0.1}).to_json()
    losses, params = _one_process(jax_ref, drop)
    no_drop, _ = _one_process(jax_ref)
    assert not np.allclose(losses, no_drop, rtol=1e-3)  # it does drop
    for rank in ranks:
        np.testing.assert_allclose(rank[1]["losses"], losses, rtol=2e-4,
                                   atol=2e-5)
        for name, want in params.items():
            np.testing.assert_allclose(rank[1]["params"][name].numpy(),
                                       want.numpy(), rtol=0, atol=2 * LR,
                                       err_msg=name)


def test_tp_checkpoint_state_is_the_full_adamw_state(ranks, jax_ref):
    """HostState gathers the AdamW moments of the split parameters: the TP
    run's state has the one-process run's shapes and values."""
    model = W.lm_model(None, None, jax_ref["sd"])
    state = W.train_state(model, LR)
    batch = _tbatch(jax_ref)
    for i in range(STEPS):
        ttrain.train_step(state, batch, rng=(7, i))
    want = state.state_dict()["optimizer"]["state"]
    got = ranks[0][2]["optimizer"]["state"]
    assert sorted(got) == sorted(want)
    for i, entry in want.items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert got[i][key].shape == entry[key].shape
            np.testing.assert_allclose(got[i][key].numpy(),
                                       entry[key].numpy(), rtol=1e-3,
                                       atol=1e-8)


def test_tp_logits_match_jax_apply(jax_ref, tmp_path):
    out = W.run_ranks("logits", 2, tmp_path, {
        "state_dict": jax_ref["sd"], "batch": _tbatch(jax_ref),
        "n_model": 2})
    ids = jnp.asarray(jax_ref["ids"], jnp.int32)
    want = np.asarray(jax_ref["model"].apply(
        jax_ref["params"], ids, ids, jnp.asarray(jax_ref["act"]))["logits"])
    for rank in out:
        np.testing.assert_allclose(rank["logits"].numpy(), want, atol=2e-5,
                                   rtol=2e-5)


def test_param_spec_matches_jax_on_every_llama_parameter(jax_ref):
    split = 0
    for name, t in jax_ref["sd"].items():
        path = port_ckpt.action_model_flax_path(name)
        flax_shape = tuple(reversed(t.shape)) if t.ndim == 2 else t.shape
        want = tuple(jmesh.param_spec(path, flax_shape))
        want = tuple(reversed(want)) if t.ndim == 2 else want
        want += (None,) * (t.ndim - len(want))
        got = mesh_lib.param_spec(name, tuple(t.shape))
        if "embed_tokens" in name or "lm_head" in name:
            # the port keeps them whole (parallel/mesh.py's docstring)
            assert got == (None,) * t.ndim, name
            continue
        assert got == want, (name, got, want)
        split += "model" in got
    assert split == 7 * W.LM["num_hidden_layers"]


def test_shard_params_refuses_what_does_not_split(jax_ref):
    three = mesh_lib.Mesh(n_data=1, n_model=3, data_rank=0, model_rank=0)
    with pytest.raises(ValueError, match="KV heads"):
        mesh_lib.shard_params(W.lm_model(None, None, jax_ref["sd"]), three)
    cfg = TransformerConfig(**{**W.LM, "num_attention_heads": 6,
                               "num_key_value_heads": 6,
                               "hidden_size": 384, "intermediate_size": 256})
    two_of_six = mesh_lib.Mesh(n_data=1, n_model=4, data_rank=0,
                               model_rank=0)
    with pytest.raises(ValueError):
        mesh_lib.shard_params(W.lm_model(cfg.to_json()), two_of_six)
    mlp = TransformerConfig(**{**W.LM, "intermediate_size": 255}).to_json()
    two = mesh_lib.Mesh(n_data=1, n_model=2, data_rank=0, model_rank=1)
    with pytest.raises(ValueError, match="MLP width"):
        mesh_lib.shard_params(W.lm_model(mlp), two)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_lib.batch_rows(7, mesh_lib.Mesh(2, 1, 1, 0))
    assert mesh_lib.batch_rows(8, mesh_lib.Mesh(2, 1, 1, 0)) == slice(4, 8)


def test_lora_dp_equals_the_one_process_run(ranks, jax_ref):
    """LoRA keeps the base whole on every rank and averages the adapters'
    gradients: the ranks' adapters are bit-identical and follow the
    one-process run's (dropout 0.1 at the ranks' global rows)."""
    drop = TransformerConfig(**{**W.LM, "attention_dropout": 0.1}).to_json()
    one = W.lora_run({"state_dict": jax_ref["sd"], "batch": _tbatch(jax_ref),
                      "steps": STEPS, "lr": LR, "seed": 7, "lm_json": drop})
    assert ranks[0][3]["digest"] == ranks[1][3]["digest"]
    np.testing.assert_allclose(ranks[0][3]["losses"], one["losses"],
                               rtol=2e-4, atol=2e-5)
    moved = 0
    for name, want in one["adapters"].items():
        got = ranks[0][3]["adapters"][name]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=2 * LR, err_msg=name)
        moved += name.startswith("b.") and bool(want.abs().max() > 0)
    assert moved  # the second update moved every b off 0
