"""The port's trainer CLI (``ivideogpt_tpu_torch/train_gpt.py``) on the CPU,
in-process with ``--device cpu``, on a tiny hub and synthetic npz episodes
made here:

- a warm start through ``--load_internal_llm`` at lr 0 leaves the LLaMA bit-
  exact in the export (``tests/test_finetune_surface.py``'s check), with
  finite metrics, validation with generation and its GIF strips;
- a state restored from a checkpoint equals the live one (parameters,
  AdamW's moments and counts, the counters, the accumulation buffer inside a
  window), and the next step from each is bit-equal;
- a resumed run draws the dropout keys of an uninterrupted run;
- the exported transformer reads back through the JAX package's
  ``load_action_model_safetensors`` and the port's loaders, equal;
- ``--eval_only --use_fvd --use_frame_metrics`` against the JAX
  ``evaluate`` on the same hub, eval split and weight files, with
  ``generation.generate`` patched in both packages to return the same token
  streams: the loss, the best-of-t frame metrics and FVD agree; the
  validations of a training run carry them as ``gen_*``;
- the flags of paths the port does not have raise, and so does an
  ``--i3d_weights`` file that does not exist;
- ``--lora``: a run checkpointed and resumed equals an uninterrupted one
  (adapters, AdamW, counters); the base export stays bit-equal to the
  warm start and ``lora.safetensors`` beside it, folded by
  ``vp/interface``, gives the trainer's merged model; the validation's loss
  is the merged model's, not the base's;
- the GPT stage of ``scripts/pretrain/oxe-256-act-free.sh`` (``--resolution
  256`` over a narrow five-level 256 px tokenizer hub) and
  ``scripts/pretrain/oxe-64-goal-cond.sh`` (``--goal_conditioned
  --segment_length 17``), one step each through the CLI, against the JAX
  package's tokenizer and ``make_train_step`` on the same pixels, weights
  and dropout masks.
"""

import importlib.util
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu import configs as jax_configs
from ivideogpt_tpu import generation as jax_generation
from ivideogpt_tpu.data import EvalDataLoader as JaxEvalDataLoader
from ivideogpt_tpu.models.i3d import I3D as JaxI3D
from ivideogpt_tpu.models.action_model import \
    HeadModelWithAction as JaxHead
from ivideogpt_tpu.models.lpips import LPIPS as JaxLPIPS
from ivideogpt_tpu.models.tokenizer import \
    CompressiveVQModel as JaxTokenizer
from ivideogpt_tpu.train import gpt_trainer as jtrain
from ivideogpt_tpu.train import optim as joptim
from ivideogpt_tpu.utils import checkpoint as jax_ckpt
from ivideogpt_tpu_torch import generation, train_gpt
from ivideogpt_tpu_torch import rollout as ro
from ivideogpt_tpu_torch.configs import CompressiveVQConfig, TransformerConfig
from ivideogpt_tpu_torch.models.action_model import HeadModelWithAction
from ivideogpt_tpu_torch.models.i3d import I3D
from ivideogpt_tpu_torch.models.lpips import VGG_FEATURE_CONVS, LPIPS
from ivideogpt_tpu_torch.models.llama import LlamaForCausalLM
from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
from ivideogpt_tpu_torch.train import lora
from ivideogpt_tpu_torch.train.optim import TrainState
from ivideogpt_tpu_torch.utils import checkpoint as ckpt
from ivideogpt_tpu_torch.utils import safetensors
from ivideogpt_tpu_torch.vp import interface as vp_interface
from tests.test_torch_flash_dropout import _patched_bernoulli, _port_masks

# tools/make_fake_hub.py's tiny geometry: 64 px frames at toy width
TOK = CompressiveVQConfig(
    block_out_channels=(16, 32, 32), layers_per_block=1, latent_channels=8,
    num_vq_embeddings=64, num_dyn_embeddings=64, norm_num_groups=8,
    mid_block_add_attention=False, context_length=2, resolution=64,
    max_att_resolution=8, patch_size=4)
LM = TransformerConfig(vocab_size=TOK.vocab_size, hidden_size=64,
                       intermediate_size=128, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=4)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """{hub/tokenizer, pretrained/transformer (a bare LLaMA), lm.json,
    data/cmu_stretch/episode_*.npz}"""
    root = tmp_path_factory.mktemp("train_gpt")
    torch.manual_seed(0)
    tok = CompressiveVQModel(TOK)
    tok_dir = root / "hub" / "tokenizer"
    tok_dir.mkdir(parents=True)
    (tok_dir / "config.json").write_text(
        json.dumps(ckpt.tokenizer_hub_config(TOK)))
    ckpt.export_tokenizer_safetensors(tok, str(tok_dir / ckpt.TOKENIZER_FILE))
    tf_dir = root / "pretrained" / "transformer"
    tf_dir.mkdir(parents=True)
    llm = LlamaForCausalLM(LM)
    with torch.no_grad():
        for p in llm.parameters():
            p.add_(torch.randn_like(p) * 0.02)
    ckpt.export_llama_safetensors(llm, str(tf_dir / ckpt.TRANSFORMER_FILE))
    (tf_dir / "config.json").write_text(json.dumps(ckpt.llama_hub_config(LM)))
    (root / "lm.json").write_text(LM.to_json())
    data = root / "data" / "cmu_stretch"
    data.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for e in range(6):
        np.savez(data / f"episode_{e:03d}.npz",
                 image=rng.integers(0, 256, (24, 64, 64, 3), dtype=np.uint8),
                 action=rng.normal(size=(24, 4)).astype(np.float32))
    return root


def _argv(root, out, *extra):
    """The BAIR finetune recipe's LM flags at toy size."""
    return ["--pretrained_model_name_or_path", str(root / "hub"),
            "--pretrained_transformer_path",
            str(root / "pretrained" / "transformer"), "--load_internal_llm",
            "--llm_config_json", str(root / "lm.json"),
            "--action_conditioned", "--action_dim", "4",
            "--mixed_precision", "bf16", "--attention_dropout", "0.1",
            "--embed_no_wd", "--weight_decay", "0.01",
            "--dataset_name", "debug", "--dataset_path", str(root / "data"),
            "--segment_length", "4", "--context_length", "2",
            "--batch_size", "2", "--dataloader_num_workers", "1",
            "--lr_scheduler_type", "constant", "--num_warmup_steps", "0",
            "--validation_steps", "100000", "--log_steps", "1",
            "--output_dir", str(out), "--seed", "3", "--device", "cpu",
            *extra]


def _metrics(out):
    return [json.loads(line)
            for line in (out / "metrics.jsonl").read_text().splitlines()]


def test_warm_start_at_lr0_is_bit_exact_and_validation_generates(root,
                                                                 tmp_path):
    out = tmp_path / "run"
    train_gpt.main(_argv(root, out, "--learning_rate", "0.0",
                         "--max_train_steps", "3", "--checkpointing_steps",
                         "3", "--validation_steps", "3",
                         "--validation_eval_batches", "1"))
    metrics = _metrics(out)
    train = [m for m in metrics if "loss" in m]
    assert [m["step"] for m in train] == [1, 2, 3]
    for m in metrics:
        for k, v in m.items():
            if isinstance(v, float):
                assert np.isfinite(v), (k, v)
    assert {"samples_per_sec", "step_ms", "loader_wait_ms"} <= set(train[0])
    val = [m for m in metrics if "eval_loss" in m]
    assert len(val) == 1 and val[0]["gen_generated"] == 2
    assert val[0]["validation_seconds"] > 0
    assert (out / "samples" / "pred-3-0.gif").exists()
    assert (out / "checkpoint-3" / ckpt.STATE_TENSORS).exists()
    got = safetensors.load_file(str(out / "transformer" /
                                    ckpt.TRANSFORMER_FILE))
    want = safetensors.load_file(str(root / "pretrained" / "transformer" /
                                      ckpt.TRANSFORMER_FILE))
    llm_keys = [k for k in got if k.startswith("llm.")]
    assert len(llm_keys) == len(want)
    for k in llm_keys:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k[len("llm."):]]), k
    # the action head exists and started fresh (zero, as the port builds it)
    assert "action_linear.weight" in got
    cmd = json.loads((out / "cmd.json").read_text())
    assert cmd["attention_dropout"] == 0.1


def _same_state(a: TrainState, b: TrainState):
    sa, sb = a.state_dict(), b.state_dict()
    assert (sa["step"], sa["updates"]) == (sb["step"], sb["updates"])
    for k, v in sa["model"].items():
        assert torch.equal(v, sb["model"][k]), k
    oa, ob = sa["optimizer"], sb["optimizer"]
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i, entry in oa["state"].items():
        for k, v in entry.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(ob["state"][i][k])), (i, k)
    assert (sa["acc"] is None) == (sb["acc"] is None)
    for x, y in zip(sa["acc"] or (), sb["acc"] or ()):
        assert torch.equal(x, y)


def test_restored_state_and_its_next_step_equal_the_live_state(root,
                                                               tmp_path):
    out = tmp_path / "run"
    # the guard saves at a loss >= 4 (the toy vocabulary's) only up to the
    # first checkpointing step: save at 4
    argv = _argv(root, out, "--learning_rate", "1e-3", "--max_train_steps",
                 "4", "--checkpointing_steps", "4",
                 "--no_validation_generation")
    live = train_gpt.main(argv)
    assert sorted(p.name for p in out.iterdir()
                  if p.name.startswith("checkpoint-")) == ["checkpoint-4"]
    args = train_gpt.parse_args(argv)
    _, model = train_gpt.build_models(args, torch.device("cpu"))
    fresh = train_gpt.make_train_state(args, model)
    ckpt.restore_train_state(ckpt.latest_checkpoint(str(out)), fresh)
    _same_state(live, fresh)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, TOK.vocab_size, (2, 547)))
    batch = {"input_ids": ids, "labels": ids,
             "action": torch.from_numpy(rng.normal(size=(2, 4, 4))
                                        .astype(np.float32))}
    for state in (live, fresh):
        train_gpt.train_step(state, batch, rng=(3, 4))
    _same_state(live, fresh)


def test_checkpoint_inside_an_accumulation_window(tmp_path):
    def state():
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Linear(8, 2))
        return TrainState(m, learning_rate=1e-3, warmup_steps=2,
                          gradient_accumulation_steps=3, weight_decay=0.1)
    live, fresh = state(), state()
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(1))
    for i in range(4):   # one update, then a window holding one micro-batch
        live.model(x * i).square().sum().backward()
        live.apply_gradients()
    assert live._acc is not None and live.updates == 1
    ckpt.save_train_state(str(tmp_path), 3, live)
    path = ckpt.save_train_state(str(tmp_path), 4, live, keep=1)
    assert [p.name for p in tmp_path.iterdir()] == ["checkpoint-4"]
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    ckpt.restore_train_state(path, fresh)
    _same_state(live, fresh)
    for s in (live, fresh):
        for _ in range(2):
            s.model(x).sum().backward()
            s.apply_gradients()
    assert live.updates == 2
    _same_state(live, fresh)


def test_resume_draws_the_dropout_keys_of_an_uninterrupted_run(root, tmp_path,
                                                               monkeypatch):
    """The JAX driver keys step i's dropout by the loader index
    (``train_gpt.py:582,596``), which restarts at 0 on resume, so a run
    resumed from checkpoint-N replays the keys of steps 0, 1, ...; the
    port keys it by the global step."""
    keys = []
    step = train_gpt.train_step

    def recording(state, batch, rng=None):
        keys.append(rng)
        return step(state, batch, rng)
    monkeypatch.setattr(train_gpt, "train_step", recording)
    a = tmp_path / "a"
    train_gpt.main(_argv(root, a, "--learning_rate", "1e-3",
                         "--max_train_steps", "4", "--checkpointing_steps",
                         "2", "--no_validation_generation"))
    assert keys == [(3, 0), (3, 1), (3, 2), (3, 3)]
    del keys[:]
    b = tmp_path / "b"
    resumed = train_gpt.main(_argv(
        root, b, "--learning_rate", "1e-3", "--max_train_steps", "4",
        "--checkpointing_steps", "2", "--no_validation_generation",
        "--resume_from_checkpoint", str(a / "checkpoint-2")))
    assert keys == [(3, 2), (3, 3)]
    assert resumed.step == 4 and [m["step"] for m in _metrics(b)] == [3, 4]


def test_exported_transformer_reads_back_in_jax_and_the_port(root, tmp_path):
    out = tmp_path / "run"
    state = train_gpt.main(_argv(root, out, "--learning_rate", "1e-3",
                                 "--max_train_steps", "2",
                                 "--checkpointing_steps", "2",
                                 "--no_validation_generation"))
    tf_dir = str(out / "transformer")
    live = state.model.state_dict()
    tree = jax_ckpt.load_action_model_safetensors(tf_dir)
    from_jax = ckpt.action_model_state_dict(
        {"params": {k: v for k, v in tree["params"].items()}})
    ported = ckpt.load_action_model_safetensors(tf_dir)
    assert sorted(from_jax) == sorted(ported) == sorted(live)
    for k, v in live.items():
        assert torch.equal(ported[k], v), k
        np.testing.assert_array_equal(from_jax[k].numpy(), v.numpy(), k)
    cfg = ckpt.llama_config_from_hub(
        ckpt.read_json(str(out / "transformer" / "config.json")),
        vocab_size=TOK.vocab_size)
    assert cfg == LM.replace(max_position_embeddings=cfg
                             .max_position_embeddings)
    model = HeadModelWithAction(cfg, state.model.head_config)
    model.load_state_dict(ported)


def test_bair_eval_split_validates_and_evaluates(root, tmp_path, monkeypatch):
    """``--dataset_name bair --use_eval_dataset`` (the finetune recipes'
    validation on the fixed eval split, read through ``DATASET.yaml`` in
    the working directory) and ``--eval_only``."""
    rng = np.random.default_rng(2)
    for split, n in (("train", 3), ("test", 2)):
        d = tmp_path / f"bair_{split}"
        d.mkdir()
        for e in range(n):
            np.savez(d / f"traj_{e}.npz",
                     aux1_image=rng.integers(0, 256, (6, 64, 64, 3),
                                             dtype=np.uint8),
                     action=rng.normal(size=(6, 4)).astype(np.float32))
    (tmp_path / "DATASET.yaml").write_text(
        f"bair_train_dataset: {tmp_path / 'bair_train'}\n"
        f"bair_test_dataset: {tmp_path / 'bair_test'}\n")
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "run"
    argv = _argv(root, out, "--max_train_steps", "2",
                 "--validation_steps", "2", "--validation_eval_batches", "1",
                 "--use_eval_dataset")
    argv[argv.index("debug")] = "bair"
    train_gpt.main(argv)
    val = [m for m in _metrics(out) if "eval_loss" in m]
    assert len(val) == 1 and val[0]["gen_generated"] == 2
    assert np.isfinite(val[0]["eval_loss"])
    result = train_gpt.main(argv + ["--eval_only",
                                    "--per_device_eval_batch_size", "2"])
    assert result["generated"] == 0 and np.isfinite(result["eval_loss"])
    assert result["perplexity"] == pytest.approx(np.exp(result["eval_loss"]))


def test_sthsth_mix_raises(root, tmp_path):
    argv = _argv(root, tmp_path / "run", "--max_train_steps", "1")
    argv[argv.index("debug")] = "sthsth"
    with pytest.raises(NotImplementedError, match="sthsth"):
        train_gpt.main(argv)


def test_reference_flag_spellings_parse(root, tmp_path):
    args = train_gpt.parse_args([
        "--pretrained_model_name_or_path", "x", "--oxe_data_mixes_type",
        "bair", "--rand_select", "--llama_attn_drop", "0.2",
        "--config_name", "c.json", "--per_device_train_batch_size", "4",
        "--num_train_epochs", "3", "--report_to", "wandb",
        "--with_tracking"])
    assert (args.dataset_name, args.random_selection, args.attention_dropout,
            args.llm_config_json, args.batch_size) == ("bair", True, 0.2,
                                                       "c.json", 4)
    assert args.device == "cuda" and args.mixed_precision == "no"


def _one_episode(root, frames=4, size=64):
    """One episode of exactly ``frames`` frames, as the held-out split's
    file and the training split's: with ``--no_aug`` every batch is that
    clip, whatever the loader's seed."""
    data = root / "cmu_stretch"
    data.mkdir(parents=True)
    rng = np.random.default_rng(4)
    episode = {"image": rng.integers(0, 256, (frames, size, size, 3),
                                     dtype=np.uint8),
               "action": rng.normal(size=(frames, 4)).astype(np.float32)}
    for e in range(2):
        np.savez(data / f"episode_{e:03d}.npz", **episode)
    return root


def test_lora_run_resumes_exports_and_validates_on_the_merged_model(
        root, tmp_path, monkeypatch):
    data = _one_episode(tmp_path / "data")
    evals = []
    real_eval = train_gpt.eval_step

    def recording(model, batch):
        m = real_eval(model, batch)
        evals.append(({k: v.clone() for k, v in batch.items()},
                      float(m["loss"])))
        return m
    monkeypatch.setattr(train_gpt, "eval_step", recording)

    def argv(out, steps, *extra):
        a = _argv(root, out, "--lora", "--lora_r", "4", "--lora_alpha", "8",
                  "--no_aug", "--learning_rate", "1e-3", "--max_train_steps",
                  str(steps), "--checkpointing_steps", str(steps), *extra)
        a[a.index("--dataset_path") + 1] = str(data)
        return a
    whole = tmp_path / "whole"
    live = train_gpt.main(argv(whole, 4, "--validation_steps", "4",
                               "--validation_eval_batches", "1"))
    assert isinstance(live.model, lora.LoraAdapters)
    assert live.step == live.updates == 4
    assert all(g["weight_decay"] == 0.01
               for g in live.optimizer.param_groups)
    assert len(evals) == 5   # 4 held-out batches, the generation batch's
    val = [m for m in _metrics(whole) if "eval_loss" in m]
    assert len(val) == 1 and val[0]["gen_generated"] == 2
    assert all("grad_norm" not in m for m in _metrics(whole))

    # checkpoint-2, then a resume to 4, equals the uninterrupted run
    parts = tmp_path / "parts"
    train_gpt.main(argv(parts, 2, "--no_validation_generation"))
    held = safetensors.load_file(str(parts / "checkpoint-2" /
                                     ckpt.STATE_TENSORS))
    assert held and all(k.startswith(("model/a.params/llm/",
                                      "model/b.params/llm/", "optimizer/"))
                        for k in held)
    resumed = train_gpt.main(argv(parts, 4, "--no_validation_generation",
                                  "--resume_from_checkpoint", "latest"))
    _same_state(live, resumed)

    # the export: the base as warm-started, the adapters beside it
    args = train_gpt.parse_args(argv(whole, 4))
    _, base = train_gpt.build_models(args, torch.device("cpu"))
    tf_dir = whole / "transformer"
    exported = safetensors.load_file(str(tf_dir / ckpt.TRANSFORMER_FILE))
    assert sorted(exported) == sorted(base.state_dict())
    for k, v in base.state_dict().items():
        assert torch.equal(exported[k], v), k
    assert sorted(ckpt.load_action_model_safetensors(str(tf_dir))) == \
        sorted(exported)
    flat = safetensors.load_file(str(tf_dir / ckpt.LORA_FILE))
    for k, v in live.model.flat().items():
        assert torch.equal(flat[k], v), k

    # the trainer's merged model: the base with the run's adapters
    merged = lora.attach(base, live.model).eval()
    _, folded = vp_interface._load_from_checkpoints(
        str(root / "hub" / "tokenizer"), str(tf_dir), None, action_dim=4,
        context_length=2, segment_length=4, lora=True, lora_r=4,
        lora_alpha=8.0, device="cpu")
    for name, p in folded.named_parameters():
        module, _, attr = name.rpartition(".")
        # the same fp32 product, transpose and add
        assert torch.equal(p, getattr(merged.get_submodule(module), attr)), \
            name
    batch, logged = evals[0]
    with torch.no_grad():
        want = train_gpt.eval_step(merged, batch)["loss"]
        assert float(want) == logged
        lora.detach(base)
        plain = float(train_gpt.eval_step(base, batch)["loss"])
    assert abs(plain - logged) > 1e-4


def _recipe_argv(hub, data, out, *extra):
    """A pretrain recipe's GPT-stage flags (act-free, attention dropout
    0.1, weight decay 0.01 with --embed_no_wd) at toy size for one step
    (a constant schedule: the recipes' cosine takes more than one), fp32:
    XLA's and torch's bf16 products round apart."""
    return ["--pretrained_model_name_or_path", str(hub),
            "--llm_config_json", str(data.parent / "lm.json"),
            "--mixed_precision", "no", "--attention_dropout", "0.1",
            "--embed_no_wd", "--weight_decay", "0.01",
            "--dataset_name", "debug", "--dataset_path", str(data),
            "--context_length", "2", "--batch_size", "2",
            "--dataloader_num_workers", "1", "--learning_rate", "1e-4",
            "--lr_scheduler_type", "constant", "--num_warmup_steps", "0",
            "--max_train_steps", "1", "--validation_steps", "100000",
            "--checkpointing_steps", "100000", "--log_steps", "1",
            "--output_dir", str(out), "--seed", "3", "--device", "cpu",
            *extra]


def _record_first_step(monkeypatch):
    """Record the CLI's first training step: the pixels it tokenized, the
    batch, the model's weights before it and its metrics."""
    rec = {}
    real_tokenize, real_step = train_gpt.make_tokenize_fn, train_gpt.train_step

    def make_tokenize_fn(tokenizer, ctx):
        tokenize = real_tokenize(tokenizer, ctx)

        def recording(pixels):
            rec.setdefault("pixels", pixels.clone())
            return tokenize(pixels)
        return recording

    def step(state, batch, rng=None):
        rec["before"] = {k: v.clone()
                         for k, v in state.model.state_dict().items()}
        rec["batch"], rec["rng"] = batch, rng
        rec["metrics"] = real_step(state, batch, rng)
        return rec["metrics"]
    monkeypatch.setattr(train_gpt, "make_tokenize_fn", make_tokenize_fn)
    monkeypatch.setattr(train_gpt, "train_step", step)
    return rec


def _adam_mu(opt_state):
    import optax
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0].mu


def _matches_the_jax_step(rec, state, hub, tmp_path, monkeypatch):
    """The recorded step against the JAX package's: the tokenizer from the
    same hub on the same pixels (ids equal), then ``make_train_step`` from
    the same weights with the port's dropout masks: loss and gradient norm
    within 1e-5, AdamW's first moments (0.1 of the clipped gradients)
    within 1e-4 of each tensor's largest."""
    model = state.model
    tok_params, tok_cfg = jax_ckpt.load_tokenizer_for_context(
        str(hub / "tokenizer"), 2)
    tokenize = jtrain.make_tokenize_fn(JaxTokenizer(tok_cfg, use_pallas=False),
                                       tok_params, 2)
    ids, labels = tokenize(jnp.asarray(rec["pixels"].numpy()))
    np.testing.assert_array_equal(np.asarray(ids),
                                  rec["batch"]["input_ids"].numpy())
    np.testing.assert_array_equal(np.asarray(labels),
                                  rec["batch"]["labels"].numpy())
    path = str(tmp_path / "before.safetensors")
    safetensors.save_file(rec["before"], path)
    params = jax_ckpt.load_action_model_safetensors(path)
    lm_cfg = jax_configs.TransformerConfig.from_json(
        model.llm_config.to_json())
    head_cfg = jax_configs.ActionModelConfig.from_json(
        model.head_config.to_json())
    jmodel = JaxHead(lm_cfg, head_cfg, dtype=jnp.float32)
    B, S = ids.shape
    seed, step = rec["rng"]
    _patched_bernoulli(monkeypatch,
                       _port_masks(model.llm_config, B, S, seed, step), [])
    tx, _ = joptim.make_optimizer(
        params, learning_rate=1e-4, lr_scheduler="constant", warmup_steps=0,
        total_steps=1, weight_decay=0.01, embed_no_wd=True,
        max_grad_norm=1.0)
    jstate, jm = jtrain.make_train_step(jmodel, action_conditioned=False)(
        joptim.TrainState.create(params, tx),
        {"input_ids": ids, "labels": labels}, jax.random.key(0))
    for key in ("loss", "grad_norm", "perplexity"):
        np.testing.assert_allclose(float(rec["metrics"][key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    want = ckpt.action_model_state_dict(
        jax.tree_util.tree_map(np.asarray, _adam_mu(jstate.opt_state)))
    for name, p in model.named_parameters():
        got = state.optimizer.state[p]["exp_avg"].numpy()
        ref = want[name].numpy()
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=1e-4 * float(np.abs(ref).max()) + 1e-12,
            err_msg=name)
    return S


NARROW_256 = CompressiveVQConfig(
    block_out_channels=(8, 16, 16, 16, 24), layers_per_block=1,
    latent_channels=8, num_vq_embeddings=32, num_dyn_embeddings=32,
    norm_num_groups=4, mid_block_add_attention=False, context_length=2,
    resolution=256, max_att_resolution=8, patch_size=4,
    cross_attn_dropout=0.0, remat=True)


def test_oxe_256_gpt_stage_matches_the_jax_step(tmp_path, monkeypatch):
    """``oxe-256-act-free.sh``'s GPT stage: ``--resolution 256`` over a
    frozen five-level tokenizer (TOKENIZER_256's 16 x 16 latent at toy
    widths), B=2 here (4 in the recipe)."""
    torch.manual_seed(5)
    hub = tmp_path / "hub"
    tok_dir = hub / "tokenizer"
    tok_dir.mkdir(parents=True)
    (tok_dir / "config.json").write_text(
        json.dumps(ckpt.tokenizer_hub_config(NARROW_256)))
    ckpt.export_tokenizer_safetensors(CompressiveVQModel(NARROW_256),
                                      str(tok_dir / ckpt.TOKENIZER_FILE))
    data = tmp_path / "data"
    (data / "cmu_stretch").mkdir(parents=True)
    rng = np.random.default_rng(6)
    for e in range(2):
        np.savez(data / "cmu_stretch" / f"episode_{e}.npz",
                 image=rng.integers(0, 256, (6, 256, 256, 3),
                                    dtype=np.uint8))
    (tmp_path / "lm.json").write_text(
        LM.replace(vocab_size=NARROW_256.vocab_size).to_json())
    rec = _record_first_step(monkeypatch)
    state = train_gpt.main(_recipe_argv(
        hub, data, tmp_path / "run", "--resolution", "256",
        "--segment_length", "4", "--video_stepsize", "1"))
    assert rec["pixels"].shape == (2, 4, 256, 256, 3)
    assert state.model.head_config.tokens_per_context == 256
    assert _matches_the_jax_step(rec, state, hub, tmp_path,
                                 monkeypatch) == 547


def test_goal_conditioned_recipe_matches_the_jax_step(root, tmp_path,
                                                      monkeypatch):
    """``oxe-64-goal-cond.sh``'s GPT stage: ``--goal_conditioned
    --segment_length 17`` (the goal frame first, then 16), S = 768."""
    rec = _record_first_step(monkeypatch)
    state = train_gpt.main(_recipe_argv(
        root / "hub", root / "data", tmp_path / "run", "--resolution", "64",
        "--goal_conditioned", "--segment_length", "17"))
    px = rec["pixels"]
    assert px.shape == (2, 17, 64, 64, 3)
    # the goal (slot 0) is a frame of the segment: the episodes' frames
    # are random noise, so a match means the same frame
    assert all(any(torch.equal(px[b, 0], px[b, t]) for t in range(1, 17))
               for b in range(2))
    assert _matches_the_jax_step(rec, state, root / "hub", tmp_path,
                                 monkeypatch) == 768


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_cli():
    """The JAX driver, ``train_gpt.py`` at the repository's root."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_gpt", os.path.join(REPO, "train_gpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def eval_root(tmp_path_factory):
    """{hub/ (the tiny tokenizer and a whole action-conditioned
    transformer), lm.json, i3d.pt (piergiaj names, He-normal kernels and
    BN statistics away from their init), vgg16.pth (torchvision's VGG16
    feature names), bair_{train,test}/traj_*.npz, DATASET.yaml}"""
    root = tmp_path_factory.mktemp("eval")
    tok, lm = ro.build_models(TOK, LM, context_length=2, segment_length=4,
                              action_dim=4, dtype=torch.float32, seed=0,
                              device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        lm.action_linear.weight.normal_(0, 0.02, generator=g)
    ckpt.export_hub(str(root / "hub"), tok, lm)
    (root / "lm.json").write_text(LM.to_json())
    i3d = {}
    for k, v in I3D().state_dict().items():
        if k.endswith("conv3d.weight"):
            v = torch.randn(v.shape, generator=g) * (2 / v[0].numel()) ** 0.5
        elif k.endswith(("running_var", "bn.weight")):
            v = torch.rand(v.shape, generator=g) + 0.5
        elif v.is_floating_point():
            v = torch.randn(v.shape, generator=g) * 0.1
        i3d[k] = v
    torch.save(i3d, str(root / "i3d.pt"))
    torch.manual_seed(3)
    vgg = LPIPS().vgg
    convs = [m for m in vgg.children()]
    torch.save({f"features.{i}.{leaf}": getattr(c, leaf).detach()
                for i, c in zip(VGG_FEATURE_CONVS, convs)
                for leaf in ("weight", "bias")}, str(root / "vgg16.pth"))
    rng = np.random.default_rng(2)
    for split, n in (("train", 2), ("test", 4)):
        d = root / f"bair_{split}"
        d.mkdir()
        for e in range(n):
            np.savez(d / f"traj_{e}.npz",
                     aux1_image=rng.integers(0, 256, (6, 64, 64, 3),
                                             dtype=np.uint8),
                     action=rng.normal(size=(6, 4)).astype(np.float32))
    (root / "DATASET.yaml").write_text(
        f"bair_train_dataset: {root / 'bair_train'}\n"
        f"bair_test_dataset: {root / 'bair_test'}\n")
    return root


def _eval_argv(root, out, *extra):
    """The BAIR evaluation recipe's flags (``scripts/evaluation/
    bair-64-act-cond.sh``) at toy size, fp32, 2 samples a clip."""
    return ["--pretrained_model_name_or_path", str(root / "hub"),
            "--llm_config_json", str(root / "lm.json"),
            "--action_conditioned", "--action_dim", "4",
            "--mixed_precision", "no", "--dataset_name", "bair",
            "--resolution", "64", "--video_stepsize", "1",
            "--segment_length", "4", "--context_length", "2",
            "--use_fvd", "--use_frame_metrics", "--eval_only",
            "--eval_generate_times", "2", "--eval_max_batchsize", "2",
            "--i3d_weights", str(root / "i3d.pt"),
            "--lpips_weights", str(root / "vgg16.pth"),
            "--output_dir", str(out), "--seed", "0", *extra]


def _jitted(init):
    def call(self, rng, *xs):
        return jax.jit(lambda r, *x: init(self, r, *x))(rng, *xs)
    return call


def _patch_generate(monkeypatch, module, prelude_at, to_array):
    """Replace ``module.generate`` with one that returns, for its k-th
    call, the prelude (positional argument ``prelude_at``) followed by the
    frames of dynamics ids drawn from seed 100 + k, each closed by its sdf,
    as a sampled stream is laid out."""
    calls = []

    def fake(*args, **kw):
        prelude = np.asarray(args[prelude_at])
        B = prelude.shape[0]
        frames = kw["segment_length"] - kw["context_length"]
        rng = np.random.default_rng(100 + len(calls))
        dyn = rng.integers(0, TOK.num_dyn_embeddings, (B, frames, 16))
        sdf = np.full((B, frames, 1), TOK.vocab_size - 1)
        tail = np.concatenate([dyn + TOK.num_vq_embeddings, sdf],
                              2).reshape(B, -1)[:, :-1]
        calls.append(B)
        return SimpleNamespace(tokens=to_array(
            np.concatenate([prelude, tail], 1).astype(np.int32)))
    monkeypatch.setattr(module, "generate", fake)
    return calls


def test_eval_only_metrics_match_jax_evaluate(eval_root, tmp_path,
                                              monkeypatch):
    monkeypatch.chdir(eval_root)
    argv = _eval_argv(eval_root, tmp_path / "run", "--device", "cpu")
    # generate(model, prelude, ...) in the port, (model, params, prelude,
    # key, ...) in the JAX package
    port_calls = _patch_generate(monkeypatch, generation, 1,
                                 lambda a: torch.from_numpy(a).long())
    got = train_gpt.main(argv)

    jax_calls = _patch_generate(monkeypatch, jax_generation, 2, jnp.asarray)
    # the JAX evaluate initialises I3D and LPIPS outside jit, one compile
    # an operation (~40 s on the CPU); jitted, the same values at once
    for cls in (JaxI3D, JaxLPIPS):
        monkeypatch.setattr(cls, "init", _jitted(cls.init))
    cli = _jax_cli()
    monkeypatch.setattr("sys.argv", ["train_gpt.py"] + argv[:-2])
    args = cli.parse_args()
    (tokenizer, tok_cfg, tok_params, model, _, _,
     lm_params) = cli.build_models(args)
    loader = JaxEvalDataLoader("bair_robot_pushing", 4, 64, batch_size=2,
                               load_action=True)
    want = cli.evaluate(args, tokenizer, tok_cfg, tok_params, model,
                        lm_params, loader)
    assert port_calls == jax_calls == [2, 2, 2, 2]
    assert got["generated"] == 8
    assert sorted(want) == ["eval_loss", "fvd", "lpips", "mse", "perplexity",
                            "psnr", "ssim"]
    assert sorted(got) == sorted([*want, "generated"])
    for k, v in got.items():
        assert np.isfinite(v), (k, v)
    assert got["perplexity"] == pytest.approx(np.exp(got["eval_loss"]))
    # the fp32 LM and tokenizer of both packages on the same stream: the
    # loss to 1e-5 of itself; the decoded frames agree to ~1e-6, which
    # bounds MSE and SSIM (absolute, both near 0 on random clips), PSNR
    # (1e-4 dB), LPIPS and I3D's features (relative); FVD compares 4 real
    # clips with 8 generated ones, singular covariances (scipy's sqrtm in
    # the JAX function, test_torch_video_metric.py): 1e-4 of its value
    rtol = {"eval_loss": 1e-5, "perplexity": 1e-5, "lpips": 1e-5,
            "fvd": 1e-4}
    atol = {"mse": 1e-6, "ssim": 1e-6, "psnr": 1e-4}
    for k, v in got.items():
        if k != "generated":
            np.testing.assert_allclose(v, float(want[k]), rtol=rtol.get(k, 0),
                                       atol=atol.get(k, 0), err_msg=k)


def test_validation_carries_the_generation_metrics(eval_root, tmp_path,
                                                   monkeypatch):
    """The BAIR finetune recipe's ``--use_eval_dataset --use_fvd
    --use_frame_metrics``: the validation logs ``gen_*`` beside the loss,
    I3D and LPIPS at random weights from seed 0 (no files named)."""
    monkeypatch.chdir(eval_root)
    out = tmp_path / "run"
    argv = _eval_argv(eval_root, out, "--device", "cpu")
    for flag in ("--eval_only", "--i3d_weights", "--lpips_weights"):
        i = argv.index(flag)
        del argv[i:i + (1 if flag == "--eval_only" else 2)]
    argv += ["--use_eval_dataset", "--batch_size", "2",
             "--dataloader_num_workers", "1", "--max_train_steps", "1",
             "--validation_steps", "1", "--validation_eval_batches", "1",
             "--checkpointing_steps", "100", "--learning_rate", "0.0",
             "--lr_scheduler_type", "constant", "--num_warmup_steps", "0"]
    train_gpt.main(argv)
    val = [m for m in _metrics(out) if "eval_loss" in m]
    assert len(val) == 1
    for k in ("gen_eval_loss", "gen_perplexity", "gen_mse", "gen_psnr",
              "gen_ssim", "gen_lpips", "gen_fvd"):
        assert np.isfinite(val[0][k]), k
    assert val[0]["gen_generated"] == 4
    assert (out / "samples" / "pred-1-0.gif").exists()


def test_missing_i3d_weights_raise(eval_root, tmp_path, monkeypatch):
    monkeypatch.chdir(eval_root)
    argv = _eval_argv(eval_root, tmp_path / "run", "--device", "cpu")
    argv[argv.index("--i3d_weights") + 1] = str(eval_root / "nope.pt")
    with pytest.raises(FileNotFoundError, match="nope.pt"):
        train_gpt.main(argv)
