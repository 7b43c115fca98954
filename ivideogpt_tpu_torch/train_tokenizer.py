"""Tokenizer (compressive VQGAN) training driver, the port of
``train_tokenizer.py``: generator and discriminator steps alternating by
accumulation window, the GAN loss from ``--disc_start``, an EMA copy,
validation with GT-over-recon PNG grids, train-state checkpoints with
resume, and the tokenizer exported in the hub layout.

    python -m ivideogpt_tpu_torch.train_tokenizer \\
        --dataset_name debug --dataset_path <npz root> \\
        --resolution 64 --segment_length 8 --context_length 2 \\
        --mixed_precision bf16 [--device cpu]

The flags are ``train_tokenizer.py``'s, with its spellings and
compatibility shims, plus ``--device`` (CUDA unless it names another
device; raises when CUDA is absent). The loop is the JAX driver's, step
for step:

- the loader's micro-batch ``i`` is a generator step when ``(i //
  accumulation) % 2 == 0`` and a discriminator step otherwise; before
  ``--disc_start`` the generator step has no GAN term and the
  discriminator's micro-batch is consumed without an update;
  ``global_step`` counts every micro-batch; the EMA copy follows every
  generator micro-batch;
- micro-batch ``i`` draws its dropout from a ``torch.Generator`` seeded
  from (``--seed``, ``i``), the counterpart of ``fold_in(key(seed), i)``;
  a resumed run replays the loader to the checkpoint's ``data_iter``, so
  it draws the batches (with one loader worker) and masks of an
  uninterrupted run;
- logs, validation, grids and checkpoints fall on discriminator steps at
  the JAX driver's cadences.

Differences, each on purpose:

- Checkpoints are the port's own format (``utils/checkpoint.
  save_train_states``), not Orbax's; the tokenizer export
  (``tokenizer/model.safetensors`` and the hub ``config.json``) is the
  exchange format with the JAX package.
- ``--lpips_weights`` naming a file that does not exist raises
  (``models/lpips.load_torch_lpips``); the JAX loader silently keeps the
  random weights.
- Metrics go to ``{output_dir}/metrics.jsonl`` (no TensorBoard), with
  ``step_ms`` and ``loader_wait_ms`` beside ``samples/sec``; validation is
  logged there too, with ``validation_seconds``.
- Not ported, and refused with the ROADMAP item that holds them: more than
  one process or ``--n_model > 1`` (Queue 1 item 10) and the
  Something-Something mixes (Queue 1 item 5).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ivideogpt_tpu_torch.configs import (TOKENIZER_64, TOKENIZER_256,
                                         CompressiveVQConfig,
                                         DiscriminatorConfig,
                                         TokenizerTrainConfig)
from ivideogpt_tpu_torch.data.dataset_mixes import (DATASET_NAMED_MIXES,
                                                    resolve_mix)
from ivideogpt_tpu_torch.data.npz_dataset import InfiniteDataLoader
from ivideogpt_tpu_torch.models.discriminator import Discriminator
from ivideogpt_tpu_torch.models.lpips import LPIPS, load_torch_lpips
from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
from ivideogpt_tpu_torch.train.optim import TrainState, ema_update
from ivideogpt_tpu_torch.train.tokenizer_trainer import (
    create_train_states, make_discriminator_step, make_eval_step,
    make_generator_step)
from ivideogpt_tpu_torch.utils import checkpoint as ckpt
from ivideogpt_tpu_torch.utils import safetensors
from ivideogpt_tpu_torch.utils.image_io import write_png
from ivideogpt_tpu_torch.utils.loggers import TrainLogger
from ivideogpt_tpu_torch.utils.platform import resolve_device, to_device
from ivideogpt_tpu_torch.utils.provenance import write_provenance

STATES = ("generator", "discriminator")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    # model
    p.add_argument("--model_config", type=str, default=None,
                   help="json config; default: built-in 64px/256px tokenizer")
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--context_length", type=int, default=2)
    p.add_argument("--segment_length", type=int, default=8)
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None,
                   help="tokenizer dir (config.json + safetensors) to "
                   "warm-start from, re-sliced to --context_length")
    # data
    p.add_argument("--dataset_name", type=str, default="debug")
    p.add_argument("--dataset_path", type=str, default="/data")
    p.add_argument("--video_stepsize", type=int, default=1)
    p.add_argument("--segment_horizon", type=int, default=None)
    p.add_argument("--random_selection", action="store_true")
    p.add_argument("--random_shuffle", action="store_true")
    p.add_argument("--goal_conditioned", action="store_true")
    p.add_argument("--no_aug", action="store_true")
    p.add_argument("--dataloader_num_workers", type=int, default=8)
    # optimization
    p.add_argument("--train_batch_size", "--batch_size", dest="batch_size",
                   type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--disc_learning_rate", "--discr_learning_rate",
                   dest="disc_learning_rate", type=float, default=5e-4)
    p.add_argument("--lr_scheduler", type=str, default="constant")
    p.add_argument("--discr_lr_scheduler", type=str, default=None,
                   help="discriminator schedule kind; defaults to "
                   "--lr_scheduler")
    p.add_argument("--lr_warmup_steps", type=int, default=1000)
    p.add_argument("--scale_lr", action="store_true",
                   help="scale both lrs by batch * grad-accum (one device)")
    p.add_argument("--max_train_steps", type=int, default=1_000_000)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="recompute the conv blocks in the backward (remat)")
    p.add_argument("--mixed_precision", type=str, default="no",
                   choices=["bf16", "no"],
                   help="bf16 compute over fp32 master params; 'no' is "
                   "IEEE fp32 (TF32 off)")
    p.add_argument("--recon_weight", type=float, default=1.0)
    p.add_argument("--perc_weight", type=float, default=1.0)
    p.add_argument("--disc_weight", type=float, default=0.1)
    p.add_argument("--disc_start", type=int, default=0)
    p.add_argument("--disc_depth", type=int, default=4)
    p.add_argument("--no_balanced_loss", dest="balanced_loss",
                   action="store_false")
    p.add_argument("--vae_loss", type=str, default="l1", choices=["l1", "l2"])
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--weight_decay", "--adam_weight_decay",
                   dest="weight_decay", type=float, default=1e-4)
    # bookkeeping
    p.add_argument("--output_dir", type=str, default="outputs/tokenizer")
    p.add_argument("--exp_name", type=str, default=None,
                   help="run name: output goes to "
                   "output_dir/<UTC timestamp>-<exp_name>")
    p.add_argument("--checkpointing_steps", type=int, default=10000)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--validation_steps", type=int, default=2500)
    p.add_argument("--log_steps", type=int, default=50)
    p.add_argument("--log_grad_norm_steps", type=int, default=500)
    p.add_argument("--log_image_steps", type=int, default=100)
    p.add_argument("--resume_from_checkpoint", type=str, default=None,
                   help="'latest' or a checkpoint dir")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="torchvision vgg16 .pth for real LPIPS")
    # distribution: one process on one device here
    p.add_argument("--n_model", type=int, default=1,
                   help="tensor-parallel size: only 1 is ported")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    # reference-script aliases and compatibility shims
    p.add_argument("--model_type", type=str, default="ctx_vqgan",
                   choices=["ctx_vqgan"])
    p.add_argument("--oxe_data_mixes_type", dest="dataset_name",
                   default=argparse.SUPPRESS)
    p.add_argument("--rand_select", dest="random_selection",
                   action="store_true", default=argparse.SUPPRESS)
    p.add_argument("--sthsth_root_path", type=str, default=None)
    p.add_argument("--model_config_name_or_path", dest="model_config",
                   default=argparse.SUPPRESS)
    for flag, kw in [
            ("--num_train_epochs", dict(type=int)),
            ("--report_to", dict(type=str)),
            ("--tracker_project_name", dict(type=str)),
            ("--logging_dir", dict(type=str)),
            ("--cache_dir", dict(type=str)),
            ("--local_rank", dict(type=int)),
            ("--discriminator_config_name_or_path", dict(type=str)),
            ("--allow_tf32", dict(action="store_true")),
            ("--use_8bit_adam", dict(action="store_true")),
            ("--enable_xformers_memory_efficient_attention",
             dict(action="store_true"))]:
        p.add_argument(flag, default=None, help="compat shim: ignored", **kw)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def refuse_unported(args):
    """Raise on the flags whose paths the port does not have."""
    if (args.n_model != 1 or (args.num_processes or 1) > 1
            or args.coordinator_address or args.process_id):
        raise NotImplementedError(
            "multi-process training and --n_model > 1 are not ported "
            "(ROADMAP Queue 1 item 10)")
    if any(name == "sthsth"
           for name, _ in DATASET_NAMED_MIXES.get(args.dataset_name, ())):
        raise NotImplementedError(
            f"--dataset_name {args.dataset_name}: the Something-Something "
            f"dataset is not ported (ROADMAP Queue 1 item 5)")


def tokenizer_config(args) -> CompressiveVQConfig:
    """--model_config's JSON as it is, else TOKENIZER_256 at --resolution
    256 and TOKENIZER_64 otherwise at --context_length; --gradient_
    checkpointing turns remat on (``train_tokenizer.py:216-223``)."""
    if args.model_config:
        with open(args.model_config) as f:
            cfg = CompressiveVQConfig.from_json(f.read())
    else:
        cfg = (TOKENIZER_256 if args.resolution == 256 else TOKENIZER_64
               ).replace(context_length=args.context_length)
    if args.gradient_checkpointing:
        cfg = cfg.replace(remat=True)
    return cfg


def train_config(args) -> TokenizerTrainConfig:
    """The loss and optimiser settings of the flags, both learning rates
    scaled by batch x accumulation under --scale_lr."""
    scale = (args.batch_size * args.gradient_accumulation_steps
             if args.scale_lr else 1)
    return TokenizerTrainConfig(
        segment_length=args.segment_length,
        context_length=args.context_length,
        learning_rate=args.learning_rate * scale,
        disc_learning_rate=args.disc_learning_rate * scale,
        lr_scheduler=args.lr_scheduler, lr_warmup_steps=args.lr_warmup_steps,
        max_train_steps=args.max_train_steps,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        max_grad_norm=args.max_grad_norm, recon_weight=args.recon_weight,
        perc_weight=args.perc_weight, disc_weight=args.disc_weight,
        disc_start=args.disc_start, balanced_loss=args.balanced_loss,
        vae_loss=args.vae_loss, weight_decay=args.weight_decay,
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        adam_epsilon=args.adam_epsilon)


def build_models(args, tok_cfg: CompressiveVQConfig, dev: torch.device):
    """(tokenizer, discriminator, LPIPS) with fp32 parameters computing in
    bf16 under --mixed_precision bf16: the tokenizer random from --seed or
    warm-started from --pretrained_model_name_or_path (re-sliced to the
    config's context), the depth --disc_depth discriminator from seed + 1,
    LPIPS from seed + 2 with --lpips_weights' VGG16 where given
    (``train_tokenizer.py:248-279``)."""
    cdtype = (torch.bfloat16 if args.mixed_precision == "bf16"
              else torch.float32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        tokenizer = CompressiveVQModel(tok_cfg, dtype=cdtype)
        torch.manual_seed(args.seed + 1)
        disc = Discriminator(DiscriminatorConfig(depth=args.disc_depth),
                             dtype=cdtype)
        torch.manual_seed(args.seed + 2)
        lpips = LPIPS(dtype=cdtype)
    if args.pretrained_model_name_or_path:
        sd, _ = ckpt.load_tokenizer_for_context(
            args.pretrained_model_name_or_path, tok_cfg.context_length)
        tokenizer.load_state_dict(sd)
    if not load_torch_lpips(lpips, args.lpips_weights):
        print("[warn] LPIPS running with random-init VGG (no weights file); "
              "perceptual loss is a proxy")
    lpips.requires_grad_(False)
    return (tokenizer.to(dev).train(), disc.to(dev).train(),
            lpips.to(dev).eval())


def step_generator(seed: int, i: int, dev: torch.device) -> torch.Generator:
    """Micro-batch ``i``'s dropout generator, seeded from (seed, i)."""
    s = np.random.SeedSequence((seed, i)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=dev).manual_seed(int(s))


class Progress(NamedTuple):
    """What a checkpoint restores beside the two TrainStates."""
    ema: Optional[Dict[str, torch.Tensor]]
    step: int
    data_iter: int


def save_checkpoint(args, step: int, state: TrainState,
                    disc_state: TrainState, progress: Progress) -> str:
    """The JAX driver's ``full_state_tree``: both TrainStates (the
    discriminator's spectral-norm buffers in its model), the EMA copy
    under --use_ema, the global step and the loader index to resume at."""
    return ckpt.save_train_states(
        args.output_dir, step, dict(zip(STATES, (state, disc_state))),
        tensors={"ema": progress.ema} if args.use_ema else None,
        counters={"step": progress.step, "data_iter": progress.data_iter},
        keep=args.checkpoints_total_limit)


def restore_checkpoint(args, path: str, state: TrainState,
                       disc_state: TrainState) -> Progress:
    """Load :func:`save_checkpoint`'s files into the two states; returns
    the EMA copy (on the states' device) and the counters."""
    tensors, counters = ckpt.restore_train_states(
        path, dict(zip(STATES, (state, disc_state))))
    ema = None
    if args.use_ema:
        dev = state.params[0].device
        ema = {k: v.to(dev) for k, v in tensors["ema"].items()}
    return Progress(ema, counters["step"], counters["data_iter"])


def export_tokenizer(output_dir: str, tokenizer: CompressiveVQModel,
                     weights: Dict[str, torch.Tensor]):
    """``{output_dir}/tokenizer/model.safetensors`` (``weights``: the live
    state dict or the EMA copy) and the hub ``config.json``."""
    tok_dir = os.path.join(output_dir, "tokenizer")
    safetensors.save_file(weights, os.path.join(tok_dir, "model.safetensors"))
    with open(os.path.join(tok_dir, "config.json"), "w") as f:
        json.dump(ckpt.tokenizer_hub_config(tokenizer.config), f, indent=2)


def dump_recon_grid(context_length: int, pixels: torch.Tensor,
                    dec: torch.Tensor, path: str):
    """The first clip's future frames over their reconstructions, one PNG
    (``train_tokenizer.py:151-163``)."""
    gt = pixels[0, context_length:].float().cpu().numpy()
    rc = dec[:len(gt)].float().clamp(0, 1).cpu().numpy()
    grid = np.concatenate([np.concatenate(list(gt), axis=1),
                           np.concatenate(list(rc), axis=1)], axis=0)
    write_png(path, (grid * 255).astype(np.uint8))


def main(argv: Optional[List[str]] = None):
    """Train. Returns (generator state, discriminator state, Progress) as
    they are at the end."""
    args = parse_args(argv)
    refuse_unported(args)
    dev = resolve_device(args.device)
    if args.exp_name:
        args.output_dir = os.path.join(
            args.output_dir, time.strftime("%Y-%m-%d-%H-%M-%S", time.gmtime())
            + f"-{args.exp_name}")
    os.makedirs(args.output_dir, exist_ok=True)
    write_provenance(args.output_dir, args)

    tok_cfg = tokenizer_config(args)
    cfg = train_config(args)
    tokenizer, disc, lpips = build_models(args, tok_cfg, dev)
    state, disc_state = create_train_states(
        tokenizer, disc, cfg, disc_lr_scheduler=args.discr_lr_scheduler)
    ema = ({k: v.detach().clone() for k, v in tokenizer.state_dict().items()}
           if args.use_ema else None)
    progress = Progress(ema, 0, 0)
    if args.resume_from_checkpoint:
        path = (ckpt.latest_checkpoint(args.output_dir)
                if args.resume_from_checkpoint == "latest"
                else args.resume_from_checkpoint)
        if path:
            progress = restore_checkpoint(args, path, state, disc_state)
            print(f"resumed from {path} at step {progress.step}")
    ema, global_step = progress.ema, progress.step

    bs = args.batch_size
    mix = resolve_mix(args.dataset_name, args.dataset_path)
    loader = InfiniteDataLoader(
        args.dataset_path, mix, batch_size=bs,
        num_workers=args.dataloader_num_workers, stepsize=args.video_stepsize,
        segment_length=args.segment_length,
        context_length=args.context_length,
        segment_horizon=args.segment_horizon,
        random_selection=args.random_selection,
        random_shuffle=args.random_shuffle,
        goal_conditioned=args.goal_conditioned,
        random_resized_crop_scale=(0.8, 1.0),
        random_resized_crop_ratio=(0.9, 1.1),
        no_aug=args.no_aug, image_size=args.resolution, seed=args.seed)
    eval_loader = InfiniteDataLoader(
        args.dataset_path, mix, batch_size=bs, num_workers=1,
        stepsize=args.video_stepsize, segment_length=args.segment_length,
        context_length=args.context_length, train=False, no_aug=True,
        image_size=args.resolution, seed=args.seed + 99)

    logger = TrainLogger(args.output_dir)
    gen_step_nogan = make_generator_step(tokenizer, disc, lpips, cfg,
                                         use_gan=False)
    gen_step_gan = make_generator_step(tokenizer, disc, lpips, cfg,
                                       use_gan=True)
    disc_step = make_discriminator_step(tokenizer, disc, cfg)
    eval_step = make_eval_step(tokenizer, lpips, cfg)
    ctx = args.context_length

    def run_validation(step):
        """Recon metrics over 4 held-out batches and the last one's grid
        (``train_tokenizer.py:383-404``)."""
        t0 = time.perf_counter()
        agg = {}
        for _ in range(4):
            pixels = to_device(next(eval_loader), dev)
            m, dec, _ = eval_step(pixels)
            for k, v in m.items():
                agg[k] = agg.get(k, 0.0) + float(v) / 4
        dump_recon_grid(ctx, pixels, dec, os.path.join(
            args.output_dir, "recon", f"step{step}.png"))
        agg["validation_seconds"] = time.perf_counter() - t0
        logger.log(agg, step)

    n_params = sum(p.numel() for p in tokenizer.parameters())
    print(f"training on {dev}; params {n_params / 1e6:.1f}M")

    log = {}
    t_end, wait_end = time.time(), loader.wait_s
    data_it = iter(loader)
    if progress.data_iter:
        if args.dataloader_num_workers > 1:
            print("[warn] exact-resume replay with dataloader_num_workers="
                  f"{args.dataloader_num_workers}: batch order is not "
                  "deterministic across workers; the resumed trajectory "
                  "continues from equivalent-distribution batches, not the "
                  "exact pre-crash stream (use 1 worker for exactness)")
        for _ in range(progress.data_iter):
            next(data_it)
    for i, batch in enumerate(data_it, start=progress.data_iter):
        if global_step >= args.max_train_steps:
            break
        pixels = to_device(batch, dev)
        generator_step = (i // args.gradient_accumulation_steps) % 2 == 0
        gen = step_generator(args.seed, i, dev)
        if generator_step:
            fn = (gen_step_gan if global_step >= args.disc_start
                  else gen_step_nogan)
            metrics = fn(state, pixels, gen)
            if args.use_ema:
                ema = ema_update(ema, tokenizer.state_dict(), args.ema_decay)
        elif global_step >= args.disc_start:
            metrics = disc_step(disc_state, pixels, gen)
        else:
            metrics = {}
        global_step += 1

        # grad norms only at the log_grad_norm_steps parities, which catch
        # whichever of G and D lands on the cadence
        keep_gnorms = (args.log_grad_norm_steps
                       and global_step % args.log_grad_norm_steps in (0, 1))
        log.update({k: v for k, v in metrics.items()
                    if keep_gnorms or not k.startswith("grad_norm/")})

        if (generator_step and args.log_image_steps
                and (global_step - 1) % args.log_image_steps == 0):
            _, dec_img, _ = eval_step(pixels)
            dump_recon_grid(ctx, pixels, dec_img, os.path.join(
                args.output_dir, "train_recon", f"step{global_step}.png"))

        if not generator_step and global_step % args.log_steps == 0:
            dt = time.time() - t_end
            t_end = time.time()
            waited, wait_end = loader.wait_s - wait_end, loader.wait_s
            log["samples/sec"] = args.log_steps * bs * 2 / max(dt, 1e-9)
            log["step_ms"] = dt / args.log_steps * 1e3
            log["loader_wait_ms"] = waited / args.log_steps * 1e3
            logger.log(log, global_step)
            # a grad norm appears only in the emission after its cadence
            for k in [k for k in log if k.startswith("grad_norm/")]:
                del log[k]

        if (not generator_step and global_step % args.validation_steps == 0
                and global_step > 0):
            run_validation(global_step)

        if (not generator_step
                and global_step % args.checkpointing_steps == 0
                and global_step > 0):
            save_checkpoint(args, global_step, state, disc_state,
                            Progress(ema, global_step, i + 1))
            export_tokenizer(args.output_dir, tokenizer,
                             ema if args.use_ema else tokenizer.state_dict())

    loader.close()
    eval_loader.close()
    logger.close()
    print("done")
    # batch i was drawn but not trained on
    return state, disc_state, Progress(ema, global_step, i)


if __name__ == "__main__":
    main()
