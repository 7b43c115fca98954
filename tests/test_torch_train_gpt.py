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
- the flags of paths the port does not have raise.
"""

import json

import numpy as np
import pytest
import torch

from ivideogpt_tpu.utils import checkpoint as jax_ckpt
from ivideogpt_tpu_torch import train_gpt
from ivideogpt_tpu_torch.configs import CompressiveVQConfig, TransformerConfig
from ivideogpt_tpu_torch.models.action_model import HeadModelWithAction
from ivideogpt_tpu_torch.models.llama import LlamaForCausalLM
from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
from ivideogpt_tpu_torch.train.optim import TrainState
from ivideogpt_tpu_torch.utils import checkpoint as ckpt
from ivideogpt_tpu_torch.utils import safetensors

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
                 "--no_validation_gifs", "--use_eval_dataset")
    argv[argv.index("debug")] = "bair"
    train_gpt.main(argv)
    val = [m for m in _metrics(out) if "eval_loss" in m]
    assert len(val) == 1 and val[0]["gen_generated"] == 2
    assert np.isfinite(val[0]["eval_loss"])
    result = train_gpt.main(argv + ["--eval_only",
                                    "--per_device_eval_batch_size", "2"])
    assert result["generated"] == 0 and np.isfinite(result["eval_loss"])
    assert result["perplexity"] == pytest.approx(np.exp(result["eval_loss"]))


@pytest.mark.parametrize("extra", [["--lora"], ["--use_fvd"],
                                   ["--use_frame_metrics"],
                                   ["--n_model", "2"],
                                   ["--num_processes", "2"]])
def test_unported_flags_raise(root, tmp_path, extra):
    with pytest.raises(NotImplementedError, match="Queue 1 item"):
        train_gpt.main(_argv(root, tmp_path / "run", *extra))


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
