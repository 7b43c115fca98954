"""Tokenizer (VQGAN) training, the port of
``ivideogpt_tpu/train/tokenizer_trainer.py``: alternating generator and
discriminator steps.

    tokenizer, disc, lpips = build_tokenizer_train_models(seed=0)  # on CUDA
    state, disc_state = create_train_states(tokenizer, disc, cfg)
    g_step = make_generator_step(tokenizer, disc, lpips, cfg, use_gan=True)
    d_step = make_discriminator_step(tokenizer, disc, cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)   # dropout draws
    metrics = g_step(state, pixels, gen)    # pixels [B, T, H, W, C] in [0, 1]
    d_metrics = d_step(disc_state, pixels, gen)

- The generator loss: L1 (or L2) reconstruction of the future and context
  frames and their LPIPS, balanced by F/T and ctx/T, plus both commit
  losses, plus the GAN generator loss scaled by the adaptive weight
  ||d perc / d W|| / max(||d gan / d W||, 1e-8), clipped at 1e4 and
  detached, W being ``cond_decoder.conv_out``'s kernel. As in the JAX
  package, the two gradients are targeted: they run through conv_out (from
  the detached ``pre_out`` and bias) and the loss heads only, not through
  the whole model twice as the reference does.
- The discriminator: hinge loss on real against reconstructed frames; its
  spectral-norm stats advance one power iteration a step.

Compute is bf16 over fp32 master parameters by default, as
``train_tokenizer.py`` builds it; VQ distances, the reconstruction losses
and LPIPS' mean are fp32. Each step runs under ``full_fp32``, so an fp32
model's forward and backward are IEEE fp32 on the card. Each step takes a
``torch.Generator`` for its dropout where the JAX step takes an rng key.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ivideogpt_tpu_torch.configs import (TOKENIZER_64, CompressiveVQConfig,
                                         DiscriminatorConfig,
                                         TokenizerTrainConfig)
from ivideogpt_tpu_torch.models.discriminator import (Discriminator,
                                                      gen_loss, hinge_d_loss)
from ivideogpt_tpu_torch.models.lpips import LPIPS
from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
from ivideogpt_tpu_torch.train.optim import (TrainState, global_norm,
                                             per_module_grad_norms)
from ivideogpt_tpu_torch.utils.checkpoint import tokenizer_flax_tree
from ivideogpt_tpu_torch.utils.platform import full_fp32, resolve_device

Metrics = Dict[str, torch.Tensor]


def recon_loss(gt: torch.Tensor, recon: torch.Tensor, kind: str
               ) -> torch.Tensor:
    """Mean L1 (or, for "l2", squared) error, reduced in fp32."""
    diff = gt.float() - recon.float()
    return (diff * diff).mean() if kind == "l2" else diff.abs().mean()


def split_frames(pixels: torch.Tensor, context_length: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T, H, W, C] -> (context [B*ctx, H, W, C], future [B*F, H, W, C])."""
    B, T = pixels.shape[:2]
    rest = pixels.shape[2:]
    return (pixels[:, :context_length].reshape(B * context_length, *rest),
            pixels[:, context_length:].reshape(B * (T - context_length),
                                               *rest))


def build_tokenizer_train_models(
        tok_cfg: CompressiveVQConfig = TOKENIZER_64,
        disc_cfg: DiscriminatorConfig = DiscriminatorConfig(), *,
        compute_dtype: torch.dtype = torch.bfloat16, seed: int = 0,
        device=None) -> Tuple[CompressiveVQModel, Discriminator, LPIPS]:
    """The tokenizer and discriminator to train and the frozen LPIPS, with
    random weights from ``seed``: fp32 parameters, ``compute_dtype``
    compute. On CUDA unless ``device`` says otherwise."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        tokenizer = CompressiveVQModel(tok_cfg, dtype=compute_dtype)
        disc = Discriminator(disc_cfg, dtype=compute_dtype)
        lpips = LPIPS(dtype=compute_dtype)
    lpips.requires_grad_(False)
    return tokenizer.to(dev).train(), disc.to(dev).train(), lpips.to(dev).eval()


def create_train_states(tokenizer: CompressiveVQModel, disc: Discriminator,
                        cfg: TokenizerTrainConfig, *,
                        disc_lr_scheduler: Optional[str] = None
                        ) -> Tuple[TrainState, TrainState]:
    """The generator's and the discriminator's AdamW states, as
    ``train_tokenizer.py`` passes the config to ``make_optimizer``; the
    discriminator's schedule is ``disc_lr_scheduler`` where given, else
    the config's."""
    common = dict(warmup_steps=cfg.lr_warmup_steps,
                  total_steps=cfg.max_train_steps,
                  weight_decay=cfg.weight_decay, b1=cfg.adam_beta1,
                  b2=cfg.adam_beta2, eps=cfg.adam_epsilon,
                  max_grad_norm=cfg.max_grad_norm,
                  gradient_accumulation_steps=cfg.gradient_accumulation_steps)
    return (TrainState(tokenizer, learning_rate=cfg.learning_rate,
                       lr_scheduler=cfg.lr_scheduler, **common),
            TrainState(disc, learning_rate=cfg.disc_learning_rate,
                       lr_scheduler=disc_lr_scheduler or cfg.lr_scheduler,
                       **common))


def _perceptual(lpips_model: LPIPS
                ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    def perc(a, b):
        return lpips_model(a * 2.0 - 1.0, b * 2.0 - 1.0).float().mean()
    return perc


def adaptive_weight(conv_out: torch.nn.Module, pre_out: torch.Tensor,
                    target: torch.Tensor, perc: Callable,
                    disc_model: Discriminator, n_total: int) -> torch.Tensor:
    """||d perc / d W|| / max(||d gan / d W||, 1e-8), clipped at 1e4 and
    detached: W is conv_out's kernel, both losses recomputed from the
    detached pre_out [N, H, W, C0] through conv_out alone (fp32, from the
    master kernel). gan is the reconstructions' share of the generator
    loss over the ``n_total`` frames of the context + future batch."""
    kernel = conv_out.weight.detach().requires_grad_()
    act = pre_out.detach().permute(0, 3, 1, 2).to(kernel.dtype)
    dec = F.conv2d(act, kernel, conv_out.bias.detach(), padding=1)
    dec = dec.permute(0, 2, 3, 1)
    gan = -disc_model(dec, update_stats=False).mean(dim=(1, 2, 3)).sum() \
        / n_total
    g_perc, = torch.autograd.grad(perc(target, dec), kernel,
                                  retain_graph=True)
    g_gan, = torch.autograd.grad(gan, kernel)
    weight = (torch.linalg.vector_norm(g_perc)
              / torch.linalg.vector_norm(g_gan).clamp_min(1e-8))
    return weight.clamp(max=1e4).detach()


def make_generator_step(model: CompressiveVQModel, disc_model: Discriminator,
                        lpips_model: LPIPS, cfg: TokenizerTrainConfig, *,
                        use_gan: bool):
    """Returns step(state, pixels, generator) -> metrics: one generator
    update of ``state`` (built on ``model``), the discriminator read with
    its stats unchanged. Metrics are 0-dim tensors (no host sync), with
    ``grad_norm`` and ``grad_norm/<a>/<b>`` under the Flax paths."""
    T, ctx = cfg.segment_length, cfg.context_length
    F_ = T - ctx
    w_fut = F_ / T if cfg.balanced_loss else 1.0
    w_ctx = ctx / T if cfg.balanced_loss else 1.0
    perc = _perceptual(lpips_model)
    names = [n for n, p in model.named_parameters() if p.requires_grad]

    def step(state: TrainState, pixels: torch.Tensor,
             generator: torch.Generator = None) -> Metrics:
        with full_fp32():
            ref_single, target = split_frames(pixels, ctx)
            dec, ref_dec, commit, dyn_commit, pre_out = model(
                ref_single, target, F_, deterministic=False,
                return_pre_out=True, generator=generator)
            metrics = {"recon_loss": recon_loss(target, dec, cfg.vae_loss),
                       "ref_recon_loss": recon_loss(ref_single, ref_dec,
                                                    cfg.vae_loss),
                       "perceptual_loss": perc(target, dec),
                       "ref_perceptual_loss": perc(ref_single, ref_dec),
                       "commit_loss": commit, "dyn_commit_loss": dyn_commit}
            loss = (cfg.recon_weight * (metrics["recon_loss"] * w_fut
                                        + metrics["ref_recon_loss"] * w_ctx)
                    + cfg.perc_weight * (metrics["perceptual_loss"] * w_fut
                                         + metrics["ref_perceptual_loss"]
                                         * w_ctx)
                    + commit + dyn_commit)
            if use_gan:
                fake = torch.cat([ref_dec, dec])
                g_loss = gen_loss(disc_model(fake, update_stats=False).float())
                weight = adaptive_weight(model.cond_decoder.conv_out, pre_out,
                                         target, perc, disc_model,
                                         fake.shape[0])
                loss = loss + cfg.disc_weight * weight * g_loss
                metrics["gan_loss"] = g_loss
                metrics["adaptive_weight"] = weight
            metrics["gen_loss"] = loss
            grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(state.params, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        metrics.update(per_module_grad_norms(
            tokenizer_flax_tree(dict(zip(names, grads)))))
        for p, g in zip(state.params, grads):
            p.grad = g
        state.apply_gradients()
        return metrics

    return step


def make_discriminator_step(model: CompressiveVQModel,
                            disc_model: Discriminator,
                            cfg: TokenizerTrainConfig):
    """Returns step(disc_state, pixels, generator) -> metrics: one hinge
    update of the discriminator against the tokenizer's reconstructions
    (no gradient into the tokenizer). Both calls start from the same
    spectral-norm ``u`` and the second stores its stats, as the JAX step
    keeps its second call's ``batch_stats``: ``u`` advances one power
    iteration a step."""
    T, ctx = cfg.segment_length, cfg.context_length
    F_ = T - ctx

    def step(disc_state: TrainState, pixels: torch.Tensor,
             generator: torch.Generator = None) -> Metrics:
        with full_fp32():
            ref_single, target = split_frames(pixels, ctx)
            with torch.no_grad():
                dec, ref_dec, _, _ = model(ref_single, target, F_,
                                           deterministic=False,
                                           generator=generator)
            real_logits = disc_model(torch.cat([ref_single, target]),
                                     update_stats=False)
            fake_logits = disc_model(torch.cat([ref_dec, dec]),
                                     update_stats=True)
            loss = hinge_d_loss(real_logits.float(), fake_logits.float())
            grads = torch.autograd.grad(loss, disc_state.params)
        for p, g in zip(disc_state.params, grads):
            p.grad = g
        metrics = {"discr_loss": loss.detach(),
                   "real_logits": real_logits.detach().mean(),
                   "fake_logits": fake_logits.detach().mean(),
                   "disc_grad_norm": global_norm(grads)}
        disc_state.apply_gradients()
        return metrics

    return step


def make_eval_step(model: CompressiveVQModel, lpips_model: LPIPS,
                   cfg: TokenizerTrainConfig):
    """Returns step(pixels) -> (metrics, dec, ref_dec), dropout off."""
    ctx = cfg.context_length
    F_ = cfg.segment_length - ctx

    @torch.no_grad()
    def step(pixels: torch.Tensor):
        with full_fp32():
            ref_single, target = split_frames(pixels, ctx)
            dec, ref_dec, commit, _ = model(ref_single, target, F_,
                                            deterministic=True)
            metrics = {"eval_recon_loss": recon_loss(target, dec,
                                                     cfg.vae_loss),
                       "eval_perceptual_loss": lpips_model(
                           target * 2.0 - 1.0, dec * 2.0 - 1.0).mean(),
                       "eval_commit_loss": commit}
        return metrics, dec, ref_dec

    return step
