"""Token-transformer training driver, the port of ``train_gpt.py``: frozen-
tokenizer pixel tokenization, LLaMA next-token training with optional
action conditioning and attention dropout, cosine/warmup schedules,
grouped weight decay, validation with generation, FVD and best-of-t frame
metrics (also alone, ``--eval_only``), train-state checkpoints with resume,
and the transformer exported in the hub layout.

    python -m ivideogpt_tpu_torch.train_gpt \\
        --pretrained_model_name_or_path <dir with tokenizer/> \\
        --dataset_name debug --dataset_path <npz root> \\
        --mixed_precision bf16 --attention_dropout 0.1 [--device cpu]
    python -m ivideogpt_tpu_torch.train_gpt --eval_only \\
        --pretrained_model_name_or_path <hub dir> --dataset_name bair \\
        --use_fvd --use_frame_metrics --eval_generate_times 100 \\
        --eval_max_batchsize 80 [--i3d_weights <i3d_torch.pt>] \\
        [--lpips_weights <vgg16.pth>]    # DATASET.yaml in the working dir

The flags are ``train_gpt.py``'s, with its spellings and compatibility
shims, plus ``--device`` (CUDA unless it names another device; raises when
CUDA is absent).

Differences from the JAX driver, each on purpose:

- Checkpoints are the port's own format (``utils/checkpoint.
  save_train_state``: safetensors + JSON under ``checkpoint-{step}``), not
  Orbax's. The transformer export (``transformer/model.safetensors`` and
  ``config.json``) is the exchange format with the JAX package.
- The attention-dropout stream is keyed by (``--seed``, the global step),
  so a resumed run draws the masks an uninterrupted run would; the JAX
  driver keys it by the loader index, which restarts at 0 on resume. The
  loader itself is re-seeded on resume, as in the JAX driver.
- The generation evaluation (``--use_fvd``, ``--use_frame_metrics``; in
  ``--eval_only`` and in the validations) feeds the I3D
  ``--eval_max_batchsize`` clips at a time, where the JAX driver passes
  all ``--eval_generate_times`` x B clips at once (77 GB of input at the
  evaluation recipes' 100 x 80), and ``--i3d_weights`` naming a missing
  file raises, where the JAX loader keeps the random weights. Without a
  weights file I3D and LPIPS run at random weights from seed 0, with the
  JAX driver's warnings.
- Not ported, and refused with the ROADMAP item that holds them: LoRA
  training (``--lora``, Queue 1 item 5), more than one process or
  ``--n_model > 1`` (Queue 1 item 10), the Something-Something mixes
  (raised by the loader).
- Metrics go to ``{output_dir}/metrics.jsonl`` (no TensorBoard), with
  ``step_ms`` and ``loader_wait_ms`` (the loop's wait on the loader a step)
  beside ``samples_per_sec`` at each log, and ``validation_seconds``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ivideogpt_tpu_torch import generation
from ivideogpt_tpu_torch import tokens as token_lib
from ivideogpt_tpu_torch.configs import (LLAMA_BASE, LLAMA_MEDIUM,
                                         TOKENIZER_64, TOKENIZER_256,
                                         ActionModelConfig, TransformerConfig)
from ivideogpt_tpu_torch.data.dataset_mixes import (resolve_eval_dataset_name,
                                                    resolve_mix)
from ivideogpt_tpu_torch.data.npz_dataset import (EvalDataLoader,
                                                  InfiniteDataLoader)
from ivideogpt_tpu_torch.inference.predict import gif_strips, write_gifs
from ivideogpt_tpu_torch.models.action_model import HeadModelWithAction
from ivideogpt_tpu_torch.models.i3d import I3D, load_torch_i3d
from ivideogpt_tpu_torch.models.lpips import LPIPS, load_torch_lpips
from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
from ivideogpt_tpu_torch.train.gpt_trainer import (eval_step,
                                                   make_tokenize_fn,
                                                   train_step)
from ivideogpt_tpu_torch.train.optim import TrainState
from ivideogpt_tpu_torch.utils import checkpoint as ckpt
from ivideogpt_tpu_torch.utils import safetensors
from ivideogpt_tpu_torch.utils.loggers import TrainLogger
from ivideogpt_tpu_torch.utils.platform import (full_fp32, resolve_device,
                                                to_device)
from ivideogpt_tpu_torch.utils.provenance import write_provenance
from ivideogpt_tpu_torch.utils.video_metric import (Evaluator, FeatureStats,
                                                    frechet_distance)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    # models
    p.add_argument("--pretrained_model_name_or_path", type=str, required=True,
                   help="dir with tokenizer/ (and transformer/ for eval/resume)")
    p.add_argument("--pretrained_transformer_path", type=str, default=None,
                   help="separate transformer warm-start dir (the "
                   "transformer folder itself)")
    p.add_argument("--llm_config", type=str, default="base",
                   choices=["base", "medium"])
    p.add_argument("--llm_config_json", "--config_name",
                   dest="llm_config_json", type=str, default=None,
                   help="path to a TransformerConfig json (overrides "
                   "--llm_config)")
    p.add_argument("--vqgan_type", type=str, default="ctx_vqgan",
                   choices=["ctx_vqgan"])
    p.add_argument("--load_internal_llm", action="store_true")
    p.add_argument("--action_conditioned", action="store_true")
    p.add_argument("--action_dim", type=int, default=4)
    p.add_argument("--action_recon", type=float, default=None)
    p.add_argument("--attention_dropout", type=float, default=0.1)
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="recompute each LM layer in the backward")
    p.add_argument("--lora", action="store_true",
                   help="not ported (ROADMAP Queue 1 item 5): raises")
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    # data
    p.add_argument("--dataset_name", type=str, default="debug")
    p.add_argument("--dataset_path", type=str, default="/data")
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--segment_length", type=int, default=16)
    p.add_argument("--context_length", type=int, default=2)
    p.add_argument("--video_stepsize", type=int, default=1)
    p.add_argument("--segment_horizon", type=int, default=None)
    p.add_argument("--random_selection", action="store_true")
    p.add_argument("--goal_conditioned", action="store_true")
    p.add_argument("--no_aug", action="store_true")
    p.add_argument("--dataloader_num_workers", type=int, default=8)
    # optimization
    p.add_argument("--per_device_train_batch_size", "--batch_size",
                   dest="batch_size", type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--lr_scheduler_type", type=str, default="cosine")
    p.add_argument("--num_warmup_steps", type=int, default=5000)
    p.add_argument("--max_train_steps", type=int, default=1_000_000)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--embed_no_wd", action="store_true", default=True)
    # reference-script compatibility shims
    p.add_argument("--mixed_precision", type=str, default="no",
                   choices=["bf16", "no"],
                   help="'bf16' = bf16 LM compute over fp32 master params")
    p.add_argument("--num_train_epochs", type=int, default=None,
                   help="compat shim: ignored (training is step-based)")
    p.add_argument("--report_to", type=str, default=None,
                   help="compat shim: logging is always JSONL")
    p.add_argument("--with_tracking", action="store_true",
                   help="compat shim: tracking is always on")
    p.add_argument("--trust_remote_code", action="store_true",
                   help="compat shim: no remote code here")
    p.add_argument("--per_device_eval_batch_size", type=int, default=None)
    # eval
    p.add_argument("--eval_only", action="store_true")
    p.add_argument("--use_eval_dataset", action="store_true")
    p.add_argument("--use_fvd", action="store_true",
                   help="FVD of the generated clips (I3D features, "
                   "--eval_max_batchsize clips a call)")
    p.add_argument("--use_frame_metrics", action="store_true",
                   help="best-of-t MSE, PSNR, SSIM and LPIPS")
    p.add_argument("--eval_generate_times", type=int, default=1)
    p.add_argument("--eval_max_batchsize", type=int, default=64)
    p.add_argument("--top_k", type=int, default=100)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--i3d_weights", type=str, default=None)
    p.add_argument("--lpips_weights", type=str, default=None)
    p.add_argument("--max_eval_batches", type=int, default=100)
    # bookkeeping
    p.add_argument("--output_dir", type=str, default="outputs/gpt")
    p.add_argument("--checkpointing_steps", type=int, default=10000)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--validation_steps", type=int, default=5000)
    p.add_argument("--validation_generation", action="store_true",
                   default=True)
    p.add_argument("--no_validation_generation", action="store_false",
                   dest="validation_generation")
    p.add_argument("--validation_eval_batches", type=int, default=2)
    p.add_argument("--log_steps", type=int, default=50)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--seed", type=int, default=42)
    # distribution: one process on one device here
    p.add_argument("--n_model", type=int, default=1,
                   help="tensor-parallel size: only 1 is ported")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    # reference-script aliases
    p.add_argument("--exp_name", type=str, default=None)
    p.add_argument("--oxe_data_mixes_type", dest="dataset_name",
                   default=argparse.SUPPRESS)
    p.add_argument("--rand_select", dest="random_selection",
                   action="store_true", default=argparse.SUPPRESS)
    p.add_argument("--llama_attn_drop", dest="attention_dropout", type=float,
                   default=argparse.SUPPRESS)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def refuse_unported(args):
    """Raise on the flags whose paths the port does not have."""
    if args.lora:
        raise NotImplementedError(
            "--lora: LoRA training is not ported (ROADMAP Queue 1 item 5)")
    if (args.n_model != 1 or (args.num_processes or 1) > 1
            or args.coordinator_address or args.process_id):
        raise NotImplementedError(
            "multi-process training and --n_model > 1 are not ported "
            "(ROADMAP Queue 1 item 10)")


def build_models(args, dev: torch.device):
    """(tokenizer, model): the frozen fp32 tokenizer from the hub dir (re-
    sliced to --context_length; random from --seed where the dir has none)
    and the LM to train, from --llm_config or --llm_config_json with the
    tokenizer's vocabulary, --attention_dropout and --gradient_checkpointing,
    random from --seed + 1 and warm-started from the transformer dir where
    it holds weights (``train_gpt.py:174-258``). The LM keeps fp32 masters
    and computes in bf16 under --mixed_precision bf16."""
    tok_dir = os.path.join(args.pretrained_model_name_or_path, "tokenizer")
    if os.path.exists(os.path.join(tok_dir, "config.json")):
        tok_sd, tok_cfg = ckpt.load_tokenizer_for_context(
            tok_dir, args.context_length)
    else:
        tok_sd = None
        tok_cfg = (TOKENIZER_256 if args.resolution == 256
                   else TOKENIZER_64).replace(
            context_length=args.context_length)
    if args.llm_config_json:
        with open(args.llm_config_json) as f:
            lm_cfg = TransformerConfig.from_json(f.read())
    else:
        lm_cfg = LLAMA_MEDIUM if args.llm_config == "medium" else LLAMA_BASE
    lm_cfg = lm_cfg.replace(vocab_size=tok_cfg.vocab_size,
                            attention_dropout=args.attention_dropout,
                            remat=args.gradient_checkpointing)
    head_cfg = ActionModelConfig(
        action_dim=args.action_dim, context_length=args.context_length,
        segment_length=args.segment_length,
        tokens_per_context=tok_cfg.ctx_tokens_per_frame,
        tokens_per_dyna=tok_cfg.dyn_tokens_per_frame,
        action_recon=args.action_recon)
    cdtype = (torch.bfloat16 if args.mixed_precision == "bf16"
              else torch.float32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        tokenizer = CompressiveVQModel(tok_cfg)
        torch.manual_seed(args.seed + 1)
        model = HeadModelWithAction(lm_cfg, head_cfg, dtype=cdtype)
    if tok_sd is not None:
        tokenizer.load_state_dict(tok_sd)
    tf_dir = args.pretrained_transformer_path or os.path.join(
        args.pretrained_model_name_or_path, "transformer")
    if os.path.isdir(tf_dir) and any(f.endswith(".safetensors")
                                     for f in os.listdir(tf_dir)):
        if args.load_internal_llm:
            # the LLaMA only; the heads stay fresh
            model.llm.load_state_dict(ckpt.load_llm_only_safetensors(tf_dir))
        else:
            model.load_state_dict(ckpt.load_action_model_safetensors(tf_dir))
    elif args.pretrained_transformer_path:
        raise FileNotFoundError(
            f"--pretrained_transformer_path {tf_dir} has no safetensors")
    tokenizer.requires_grad_(False)
    return tokenizer.to(dev).eval(), model.to(dev).train()


def _split(batch, action_conditioned: bool):
    return batch if action_conditioned else (batch, None)


def dump_prediction_gifs(gif_dir: str, step: int, gt: np.ndarray,
                         gen: np.ndarray):
    """Ground truth beside prediction for up to 4 clips, as
    ``pred-{step}-{j}.gif`` (``train_gpt.py:261-271``)."""
    strips = [gif_strips(np.clip(gt[j], 0, 1), gen[j:j + 1])[0]
              for j in range(min(4, gt.shape[0]))]
    write_gifs(strips, gif_dir, name=f"pred-{step}-{{j}}.gif")


def _seeded(cls):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return cls()


def build_evaluator(args, dev: torch.device) -> Optional[Evaluator]:
    """The generation evaluation's metric models, or None without
    --use_fvd and --use_frame_metrics: LPIPS (VGG16 from --lpips_weights)
    with --use_frame_metrics and I3D (from --i3d_weights) with --use_fvd,
    fp32 on ``dev``, random from seed 0 where no file is named
    (``train_gpt.py:293-320``)."""
    if not (args.use_fvd or args.use_frame_metrics):
        return None
    lpips = i3d = None
    if args.use_frame_metrics:
        lpips = _seeded(LPIPS)
        if not load_torch_lpips(lpips, args.lpips_weights):
            print("[warn] LPIPS running with random init (no weights file); "
                  "the lpips metric is relative, not comparable to "
                  "published numbers")
        lpips = lpips.to(dev).eval()
    if args.use_fvd:
        i3d = _seeded(I3D)
        if not load_torch_i3d(i3d, args.i3d_weights):
            print("[warn] I3D running with random init (no weights file); "
                  "FVD is relative, not absolute")
        i3d = i3d.to(dev).eval()
    return Evaluator(lpips, i3d, max_batchsize=args.eval_max_batchsize)


@torch.no_grad()
def evaluate(args, tokenizer: CompressiveVQModel, model: HeadModelWithAction,
             loader, evaluator: Optional[Evaluator] = None,
             max_batches: Optional[int] = None, gif_dir: Optional[str] = None,
             step: int = 0) -> dict:
    """Mean loss and perplexity over the loader's batches. With
    --use_fvd, --use_frame_metrics or a ``gif_dir``, each batch's futures
    are also sampled ``--eval_generate_times`` times from its context over
    a bf16 KV cache and detokenized in fp32; the first batch's are written
    as GIF strips into ``gif_dir`` where one is given, the frame metrics
    are best-of-t, and FVD compares the I3D features of the ground truth
    with those of every sample (``train_gpt.py:274-381``). Returns
    {"eval_loss", "perplexity"[, "mse", "psnr", "ssim"[, "lpips"]][,
    "fvd"], "generated": clips generated}."""
    dev = next(model.parameters()).device
    ctx, T = args.context_length, args.segment_length
    cfg = tokenizer.config
    P1 = token_lib.prelude_len(ctx, cfg.ctx_tokens_per_frame) + 1
    tokenize = make_tokenize_fn(tokenizer, ctx)
    limit = args.max_eval_batches if max_batches is None else max_batches
    generate = args.use_fvd or args.use_frame_metrics or gif_dir is not None
    real_stats, gen_stats = FeatureStats(), FeatureStats()
    losses, frame_metrics, generated = [], [], 0
    for n, batch in enumerate(loader):
        if n >= limit:
            break
        pixels, actions = _split(batch, args.action_conditioned)
        px = to_device(pixels, dev)
        act = None if actions is None else to_device(actions, dev)
        ids, labels = tokenize(px)
        b = {"input_ids": ids, "labels": labels}
        if act is not None:
            b["action"] = act
        losses.append(float(eval_step(model, b)["loss"]))
        if not generate:
            continue
        reps = args.eval_generate_times
        gens = []
        for r in range(reps):
            g = torch.Generator(device=dev).manual_seed(
                args.seed * 1000 + (n + 1) * reps + r)
            res = generation.generate(
                model, ids[:, :P1], segment_length=T, context_length=ctx,
                generator=g, action=act,
                tokens_per_dyna=cfg.dyn_tokens_per_frame, top_k=args.top_k,
                temperature=args.temperature)
            with full_fp32():
                gens.append(tokenizer.detokenize(res.tokens, ctx)
                            .clamp(0.0, 1.0))
        gen_videos = torch.cat(gens)  # [reps * B, T, H, W, C]
        del gens
        if not bool(torch.isfinite(gen_videos).all()):
            raise FloatingPointError("validation generated non-finite frames")
        generated += gen_videos.shape[0]
        if gif_dir is not None and n == 0:
            dump_prediction_gifs(gif_dir, step, np.asarray(pixels),
                                 gen_videos[:px.shape[0]].cpu().numpy())
        if args.use_frame_metrics:
            frame_metrics.append(evaluator.frame_metrics(px, gen_videos))
        if args.use_fvd:
            real_stats.append(evaluator.i3d_features(px))
            gen_stats.append(evaluator.i3d_features(gen_videos))
    mean_loss = float(np.mean(losses))
    result = {"eval_loss": mean_loss, "perplexity": math.exp(mean_loss)}
    for k in (frame_metrics[0] if frame_metrics else ()):
        result[k] = float(np.mean([m[k] for m in frame_metrics]))
    if args.use_fvd and real_stats.num_items:
        result["fvd"] = frechet_distance(real_stats, gen_stats)
    result["generated"] = generated
    return result


def export_transformer(output_dir: str, model: HeadModelWithAction,
                       lm_cfg: TransformerConfig):
    """``{output_dir}/transformer/model.safetensors`` (the whole
    HeadModelWithAction, fp32 masters) and ``config.json`` (the LLaMA's
    config), as ``train_gpt.py:626-636`` writes them."""
    tf_dir = os.path.join(output_dir, "transformer")
    safetensors.save_file(model.state_dict(),
                          os.path.join(tf_dir, ckpt.TRANSFORMER_FILE))
    with open(os.path.join(tf_dir, "config.json"), "w") as f:
        f.write(lm_cfg.to_json())


def make_train_state(args, model: HeadModelWithAction) -> TrainState:
    return TrainState(
        model, learning_rate=args.learning_rate,
        lr_scheduler=args.lr_scheduler_type,
        warmup_steps=args.num_warmup_steps, total_steps=args.max_train_steps,
        weight_decay=args.weight_decay, embed_no_wd=args.embed_no_wd,
        max_grad_norm=args.max_grad_norm,
        gradient_accumulation_steps=args.gradient_accumulation_steps)


def main(argv: Optional[List[str]] = None):
    """Train (or, with --eval_only, evaluate). Returns the TrainState at
    the end of training, or the evaluation's result."""
    args = parse_args(argv)
    refuse_unported(args)
    dev = resolve_device(args.device)
    if args.exp_name:
        args.output_dir = os.path.join(
            args.output_dir, time.strftime("%Y-%m-%d-%H-%M-%S", time.gmtime())
            + f"-{args.exp_name}")
    os.makedirs(args.output_dir, exist_ok=True)
    write_provenance(args.output_dir, args)
    tokenizer, model = build_models(args, dev)
    lm_cfg = model.llm_config

    if args.eval_only:
        loader = EvalDataLoader(resolve_eval_dataset_name(args.dataset_name),
                                args.segment_length, args.resolution,
                                batch_size=(args.per_device_eval_batch_size
                                            or args.eval_max_batchsize),
                                load_action=args.action_conditioned)
        result = evaluate(args, tokenizer, model, loader,
                          build_evaluator(args, dev))
        print(json.dumps(result))
        return result

    state = make_train_state(args, model)
    global_step = 0
    if args.resume_from_checkpoint:
        path = (ckpt.latest_checkpoint(args.output_dir)
                if args.resume_from_checkpoint == "latest"
                else args.resume_from_checkpoint)
        if path:
            ckpt.restore_train_state(path, state)
            global_step = state.step
            print(f"resumed from {path} at step {global_step}")

    bs = args.batch_size
    mix = resolve_mix(args.dataset_name, args.dataset_path)
    loader = InfiniteDataLoader(
        args.dataset_path, mix, batch_size=bs,
        num_workers=args.dataloader_num_workers, stepsize=args.video_stepsize,
        segment_length=args.segment_length,
        context_length=args.context_length,
        segment_horizon=args.segment_horizon,
        random_selection=args.random_selection,
        goal_conditioned=args.goal_conditioned,
        random_resized_crop_scale=(0.8, 1.0),
        random_resized_crop_ratio=(0.9, 1.1),
        no_aug=args.no_aug, image_size=args.resolution,
        load_action=args.action_conditioned, seed=args.seed)
    if args.use_eval_dataset:
        val_loader = EvalDataLoader(
            resolve_eval_dataset_name(args.dataset_name),
            args.segment_length, args.resolution, batch_size=bs,
            load_action=args.action_conditioned, drop_last=True)
        if len(val_loader) == 0:
            raise ValueError(f"eval split smaller than the batch ({bs})")

        def _cycle(loader):
            while True:
                yield from loader
        val_iter = _cycle(val_loader)
    else:
        val_loader = InfiniteDataLoader(
            args.dataset_path, mix, batch_size=bs, num_workers=1,
            stepsize=args.video_stepsize, segment_length=args.segment_length,
            context_length=args.context_length, train=False, no_aug=True,
            image_size=args.resolution, load_action=args.action_conditioned,
            seed=args.seed + 99)
        val_iter = val_loader

    logger = TrainLogger(args.output_dir)
    tokenize = make_tokenize_fn(tokenizer, args.context_length)
    evaluator = (build_evaluator(args, dev) if args.validation_generation
                 else None)

    def device_batch(batch):
        pixels, actions = _split(batch, args.action_conditioned)
        ids, labels = tokenize(to_device(pixels, dev))
        out = {"input_ids": ids, "labels": labels}
        if actions is not None:
            out["action"] = to_device(actions, dev)
        return out

    def run_validation(step):
        """Held-out loss and perplexity on 4 batches, then generation with
        the metrics asked for, logged as ``gen_*`` (``train_gpt.py:546-576``).
        """
        t0 = time.perf_counter()
        agg = {}
        for _ in range(4):
            m = eval_step(model, device_batch(next(val_iter)))
            for k, v in m.items():
                agg[f"eval_{k}"] = agg.get(f"eval_{k}", 0.0) + float(v) / 4
        if args.validation_generation:
            gen = evaluate(
                args, tokenizer, model, val_loader, evaluator,
                max_batches=args.validation_eval_batches,
                gif_dir=os.path.join(args.output_dir, "samples"), step=step)
            agg.update({f"gen_{k}": v for k, v in gen.items()})
        agg["validation_seconds"] = time.perf_counter() - t0
        logger.log(agg, step)

    n_params = sum(p.numel() for p in state.params)
    print(f"training on {dev}; LM params {n_params / 1e6:.1f}M")
    t_end, wait_end = time.time(), loader.wait_s
    for batch in loader:
        if global_step >= args.max_train_steps:
            break
        metrics = train_step(state, device_batch(batch),
                             rng=(args.seed, global_step))
        global_step += 1

        if global_step % args.log_steps == 0:
            dt = time.time() - t_end
            t_end = time.time()
            waited, wait_end = loader.wait_s - wait_end, loader.wait_s
            metrics = dict(metrics)
            metrics["samples_per_sec"] = args.log_steps * bs / max(dt, 1e-9)
            metrics["step_ms"] = dt / args.log_steps * 1e3
            metrics["loader_wait_ms"] = waited / args.log_steps * 1e3
            logger.log(metrics, global_step)

        if global_step % args.validation_steps == 0:
            run_validation(global_step)

        if global_step % args.checkpointing_steps == 0:
            # only on a sane loss (train_gpt.py:622)
            if (float(metrics["loss"]) < 4.0
                    or global_step <= args.checkpointing_steps):
                ckpt.save_train_state(args.output_dir, global_step, state,
                                      keep=args.checkpoints_total_limit)
                export_transformer(args.output_dir, model, lm_cfg)

    loader.close()
    if isinstance(val_loader, InfiniteDataLoader):
        val_loader.close()
    logger.close()
    print("done")
    return state


if __name__ == "__main__":
    main()
