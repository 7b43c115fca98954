"""The tokenizer trainer CLI of the PyTorch port (``python -m
ivideogpt_tpu_torch.train_tokenizer``) in-process with ``--device cpu``,
at ``tests/test_tokenizer_resume.py``'s MICRO_CFG widths on 32 px
synthetic episodes:

- against the JAX CLI (``train_tokenizer.py``, a subprocess on one CPU
  device): both warm-started from one hub tokenizer that the JAX exporter
  wrote from JAX-initialised parameters at ctx 2 (both re-slice it to
  ctx 1), both with one LPIPS VGG16 ``.pth`` the test writes from seeded
  random tensors, fp32, one loader worker, the same seed and episodes,
  ``--disc_start`` past the run, LPIPS logged but out of the loss: the
  generator's losses and grad norm at every log point within rtol 1e-5
  (and 2e-6 absolute, the loggers' 6-decimal rounding);
- a resumed run equal to the uninterrupted one bit for bit (both
  TrainStates with the spectral-norm buffers, the EMA copy, the counters),
  with the GAN on, dropout on and the checkpoint inside an accumulation
  window;
- the exported tokenizer (the EMA weights) read by the JAX package's
  ``load_tokenizer_for_context``: its ids equal the port's;
- ``load_torch_lpips`` against the JAX loader on the test-written files;
  a missing file raises;
- the unported flags raise naming their ROADMAP item; the reference's
  flag spellings parse; validation and training grids are PNGs.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ivideogpt_tpu.configs import CompressiveVQConfig as JaxConfig
from ivideogpt_tpu.models import CompressiveVQModel as JaxTokenizer
from ivideogpt_tpu.models.lpips import LPIPS as JaxLPIPS
from ivideogpt_tpu.models.lpips import load_torch_lpips as jax_load_lpips
from ivideogpt_tpu.utils import checkpoint as jax_ckpt
from ivideogpt_tpu_torch import train_tokenizer as tt
from ivideogpt_tpu_torch.models.lpips import (LPIPS, VGG_FEATURE_CONVS,
                                              VGG_SLICES, load_torch_lpips)
from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
from ivideogpt_tpu_torch.utils import checkpoint as port_ckpt
from tests.test_tokenizer_resume import MICRO_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, SEG = 32, 3
G_LOSSES = ("gen_loss", "recon_loss", "ref_recon_loss", "perceptual_loss",
            "ref_perceptual_loss", "commit_loss", "dyn_commit_loss")


def _write_vgg(path, seed):
    """torchvision vgg16 ``features`` conv names and shapes, He-normal from
    a seed; the LPIPS heads' file beside it."""
    rng = np.random.default_rng(seed)
    sd, in_ch = {}, 3
    convs = iter(VGG_FEATURE_CONVS)
    for ch, n in VGG_SLICES:
        for _ in range(n):
            idx = next(convs)
            sd[f"features.{idx}.weight"] = torch.from_numpy(rng.normal(
                0, (2.0 / (9 * in_ch)) ** 0.5, (ch, in_ch, 3, 3))
                .astype(np.float32))
            sd[f"features.{idx}.bias"] = torch.from_numpy(
                rng.normal(0, 0.01, ch).astype(np.float32))
            in_ch = ch
    torch.save(sd, path / "vgg16.pth")
    lin = {f"lin{s}.model.1.weight": torch.from_numpy(
        rng.uniform(0, 0.2, (1, ch, 1, 1)).astype(np.float32))
        for s, (ch, _) in enumerate(VGG_SLICES)}
    torch.save(lin, path / "lpips_lin.pth")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("tok_cli")
    data = root / "data" / "cmu_stretch"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(12):
        np.savez(data / f"episode_{i:03d}.npz",
                 image=rng.integers(0, 256, (10, RES, RES, 3),
                                    dtype=np.uint8))
    _write_vgg(root, seed=1)
    # the hub tokenizer: JAX-initialised at ctx 2, the JAX exporter's files
    hub_cfg = JaxConfig.from_json(json.dumps(dict(MICRO_CFG,
                                                  context_length=2)))
    model = JaxTokenizer(hub_cfg, use_pallas=False)
    params = jax.jit(model.init, static_argnames="segment_len")(
        jax.random.key(3), jnp.zeros((2, RES, RES, 3)),
        jnp.zeros((1, RES, RES, 3)), segment_len=1)
    hub = root / "hub"
    jax_ckpt.export_tokenizer_safetensors(params,
                                          str(hub / "model.safetensors"))
    (hub / "config.json").write_text(hub_cfg.to_json())
    # the run's config: ctx 1, no cross-attention dropout (the frameworks
    # cannot draw the same masks)
    (root / "cfg.json").write_text(json.dumps(
        dict(MICRO_CFG, cross_attn_dropout=0.0)))
    (root / "cfg_drop.json").write_text(json.dumps(MICRO_CFG))
    return root


def _argv(work, out, steps, *extra, cfg="cfg.json"):
    return ["--model_config", str(work / cfg), "--resolution", str(RES),
            "--context_length", "1", "--segment_length", str(SEG),
            "--batch_size", "2", "--dataset_name", "debug",
            "--dataset_path", str(work / "data"),
            "--dataloader_num_workers", "1", "--random_selection",
            "--segment_horizon", "6", "--max_train_steps", str(steps),
            "--log_steps", "2", "--log_image_steps", "0",
            "--validation_steps", "100000",
            "--checkpointing_steps", "100000",
            "--pretrained_model_name_or_path", str(work / "hub"),
            "--lpips_weights", str(work / "vgg16.pth"),
            "--learning_rate", "1e-4", "--lr_warmup_steps", "0",
            "--seed", "5", "--output_dir", str(work / out), *extra]


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_follows_the_jax_clis_generator_losses(work):
    """LPIPS is computed and logged but out of the loss (perc_weight 0):
    the trajectories then agree to the loggers' rounding (1.9e-6 measured).
    With it in (the recipes' weight 1) they are chaotic under fp32
    rounding: LPIPS' gradient jumps at the VGG's ReLU and max-pool kinks
    (tests/test_torch_tokenizer_train.py), Adam's first updates turn a
    changed gradient into a full step of lr, and two runs of the JAX CLI
    alone part by 1.8e-3 after two updates at lr 1e-4 (measured)."""
    extra = ("--mixed_precision", "no", "--disc_start", "1000",
             "--perc_weight", "0")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               IVG_JAX_CACHE=str(work / "jax_cache"))
    env.pop("XLA_FLAGS", None)   # one CPU device: the batch is not sharded
    r = subprocess.run([sys.executable, os.path.join(REPO,
                                                     "train_tokenizer.py"),
                        *_argv(work, "jax", 8, *extra)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"JAX CLI failed:\n{r.stdout}\n{r.stderr}"
    tt.main(_argv(work, "port", 8, *extra, "--device", "cpu"))
    want = {m["step"]: m for m in _metrics(work / "jax")}
    got = {m["step"]: m for m in _metrics(work / "port")}
    assert sorted(want) == sorted(got) == [2, 4, 6, 8]
    for step, m in want.items():
        for key in G_LOSSES + ("grad_norm",):
            np.testing.assert_allclose(got[step][key], m[key], rtol=1e-5,
                                       atol=2e-6, err_msg=f"{key}@{step}")
    assert not any("discr_loss" in m for m in got.values())


def _same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert (sa["step"], sa["updates"]) == (sb["step"], sb["updates"])
    for k, v in sa["model"].items():
        assert torch.equal(v, sb["model"][k]), k
    for i, entry in sa["optimizer"]["state"].items():
        for k, v in entry.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(
                sb["optimizer"]["state"][i][k])), (i, k)


def test_resumed_run_equals_the_uninterrupted_one(work):
    """accumulation 3: G on micro-batches 0-2, 6-8, D on 3-5, 9-11, so
    the checkpoint at step 4 falls inside the discriminator's window."""
    extra = ("--disc_start", "0", "--use_ema", "--disc_depth", "2",
             "--gradient_accumulation_steps", "3", "--checkpointing_steps",
             "4", "--validation_steps", "4", "--log_image_steps", "3",
             "--device", "cpu")
    full = tt.main(_argv(work, "full", 12, *extra, cfg="cfg_drop.json"))
    tt.main(_argv(work, "part", 8, *extra, cfg="cfg_drop.json"))
    resumed = tt.main(_argv(work, "part", 12, *extra,
                            "--resume_from_checkpoint", "latest",
                            cfg="cfg_drop.json"))
    for a, b in zip(full[:2], resumed[:2]):
        _same_state(a, b)
    assert full[2].step == resumed[2].step == 12
    assert full[2].data_iter == resumed[2].data_iter == 12
    for k, v in full[2].ema.items():
        assert torch.equal(v, resumed[2].ema[k]), k
    assert full[0].updates == 2 and full[1].updates == 2
    logged = {m["step"]: m for m in _metrics(work / "full")
              if "discr_loss" in m}
    assert sorted(logged) == [4, 6, 10, 12]
    assert all(np.isfinite(m["discr_loss"]) and "gan_loss" in m
               for m in logged.values())
    # a state restored from checkpoint-12 is the live one
    args = tt.parse_args(_argv(work, "full", 12, *extra, cfg="cfg_drop.json"))
    tokenizer, disc, _ = tt.build_models(args, tt.tokenizer_config(args),
                                         torch.device("cpu"))
    state, disc_state = tt.create_train_states(
        tokenizer, disc, tt.train_config(args),
        disc_lr_scheduler=args.discr_lr_scheduler)
    progress = tt.restore_checkpoint(
        args, str(work / "full" / "checkpoint-12"), state, disc_state)
    _same_state(state, full[0])
    _same_state(disc_state, full[1])
    assert (progress.step, progress.data_iter) == (12, 12)
    for k, v in full[2].ema.items():
        assert torch.equal(v, progress.ema[k]), k
    # the grids: validation at steps 4, 8, 12; training at steps 1, 4, 7,
    # 10 (the generator's micro-batches after every third)
    for name in ("recon/step4.png", "recon/step12.png",
                 "train_recon/step1.png", "train_recon/step7.png"):
        img = np.asarray(Image.open(work / "full" / name))
        assert img.shape == (2 * RES, (SEG - 1) * RES, 3), name


def test_exported_tokenizer_reads_back_in_jax_and_the_port(work):
    """The resume test's export at step 12 holds the EMA weights; the JAX
    loader reads it and tokenizes to the port's ids."""
    tok_dir = work / "full" / "tokenizer"
    if not tok_dir.exists():
        pytest.skip("needs test_resumed_run_equals_the_uninterrupted_one")
    sd, cfg = port_ckpt.load_tokenizer_for_context(str(tok_dir), 1)
    port = CompressiveVQModel(cfg)
    port.load_state_dict(sd)
    ema = port_ckpt.safetensors.load(str(tok_dir))
    assert sorted(ema) == sorted(port.state_dict())
    params, jcfg = jax_ckpt.load_tokenizer_for_context(str(tok_dir), 1)
    assert jcfg.block_out_channels == cfg.block_out_channels
    px = np.random.default_rng(9).uniform(0, 1, (2, SEG, RES, RES, 3)) \
        .astype(np.float32)
    jmodel = JaxTokenizer(jcfg, use_pallas=False)
    want, _ = jmodel.apply(params, jnp.asarray(px), 1,
                           method=jmodel.tokenize)
    with torch.no_grad():
        ids, _ = port.tokenize(torch.from_numpy(px), 1)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))


def test_lpips_loader_matches_jax_and_refuses_missing_files(work, tmp_path):
    vgg, lin = str(work / "vgg16.pth"), str(work / "lpips_lin.pth")
    jparams = JaxLPIPS().init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)),
                              jnp.zeros((1, 16, 16, 3)))
    jparams, loaded = jax_load_lpips(jparams, vgg, lin)
    assert loaded
    want = port_ckpt.lpips_state_dict(
        jax.tree_util.tree_map(np.asarray, jparams))
    port = LPIPS()
    assert load_torch_lpips(port, vgg, lin)
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], torch.as_tensor(v)), k
    fresh = LPIPS()
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    assert not load_torch_lpips(fresh, None)
    assert all(torch.equal(v, before[k])
               for k, v in fresh.state_dict().items())
    with pytest.raises(FileNotFoundError):
        load_torch_lpips(fresh, str(tmp_path / "missing.pth"))
    with pytest.raises(FileNotFoundError):
        load_torch_lpips(fresh, vgg, str(tmp_path / "missing_lin.pth"))


@pytest.mark.parametrize("extra", [["--n_model", "2"],
                                   ["--num_processes", "2"],
                                   ["--coordinator_address", "h:1234"],
                                   ["--oxe_data_mixes_type", "sthsth"],
                                   ["--dataset_name", "select_sthsth"]])
def test_unported_flags_raise(work, tmp_path, extra):
    with pytest.raises(NotImplementedError, match="Queue 1 item"):
        tt.main(_argv(work, tmp_path / "run", 2, "--device", "cpu", *extra))
    assert not (tmp_path / "run").exists()


def test_reference_flag_spellings_parse():
    args = tt.parse_args([
        "--oxe_data_mixes_type", "bair", "--rand_select",
        "--model_config_name_or_path", "c.json", "--train_batch_size", "4",
        "--discr_learning_rate", "1e-5", "--adam_weight_decay", "0.05",
        "--num_train_epochs", "3", "--report_to", "wandb", "--allow_tf32",
        "--use_8bit_adam", "--tracker_project_name", "p",
        "--discriminator_config_name_or_path", "d", "--model_type",
        "ctx_vqgan", "--gradient_checkpointing"])
    assert (args.dataset_name, args.random_selection, args.model_config,
            args.batch_size, args.disc_learning_rate, args.weight_decay) == (
        "bair", True, "c.json", 4, 1e-5, 0.05)
    assert args.device == "cuda" and args.mixed_precision == "no"
    assert args.disc_depth == 4
    cfg = tt.tokenizer_config(tt.parse_args(["--resolution", "256",
                                             "--context_length", "1"]))
    assert cfg.resolution == 256 and cfg.context_length == 1 and cfg.remat
    cfg = tt.tokenizer_config(tt.parse_args(["--gradient_checkpointing"]))
    assert cfg.resolution == 64 and cfg.context_length == 2 and cfg.remat
    scaled = tt.train_config(tt.parse_args([
        "--scale_lr", "--batch_size", "2", "--gradient_accumulation_steps",
        "4", "--learning_rate", "1e-4", "--disc_learning_rate", "2e-4"]))
    assert (scaled.learning_rate, scaled.disc_learning_rate) == (
        pytest.approx(8e-4), pytest.approx(1.6e-3))


def test_trainer_cli_wants_cuda(tmp_path):
    if torch.cuda.is_available():
        return
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.main(["--output_dir", str(out)])
    assert not out.exists()
