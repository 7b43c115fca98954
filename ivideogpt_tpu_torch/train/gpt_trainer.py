"""Token-LM training step, the port of ``ivideogpt_tpu/train/gpt_trainer.py``:
tokenize pixels with the frozen fp32 tokenizer (K1), run the LM's training
forward and backward (K4 forward, K5/K6 backward in each layer's
attention), clip and take an AdamW step.

    tokenizer, model = build_train_models(seed=0)          # on CUDA
    state = create_train_state(model, GPTTrainConfig())
    tokenize = make_tokenize_fn(tokenizer, context_length=2)
    ids, labels = tokenize(pixels)                         # [B, T, H, W, C]
    metrics = train_step(state, {"input_ids": ids, "labels": labels},
                         rng=(seed, step))             # dropout's (seed, step)

Compute is bf16 over fp32 master parameters by default, as ``train_gpt.py``
builds it: the LM's parameters stay fp32 and each layer casts them to bf16
at use, so gradients and AdamW run on the fp32 masters.

The LoRA step (``lora_train_step``, the counterpart of
``ivideogpt_tpu/train/lora.py``'s ``make_lora_train_step``) trains only the
adapters a model carries (``train/lora.attach``) through the merged
weights; its state (``create_lora_train_state``) decays every adapter.

On a mesh (``parallel/mesh``; ``mesh=`` of every step) each rank takes its
rows of the global batch: after the backward the gradients are averaged
over the data group (``parallel/distributed.all_reduce_mean``, the JAX
step's psum), so every data rank applies the same update and the
parameters stay bit-identical across them; the attention dropout is drawn
at the rank's global rows; the clip's norm and the logged one sum a
tensor-parallel model's shards (``mesh.place_state``); the returned loss
is the data group's mean. The mean of the ranks' mean losses is the
global batch's mean because every row of a token batch has the same
number of labelled tokens. A LoRA run keeps its base whole on every rank
and reduces the adapters' gradients.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ivideogpt_tpu_torch.configs import (LLAMA_BASE, TOKENIZER_64,
                                         ActionModelConfig,
                                         CompressiveVQConfig, GPTTrainConfig,
                                         TransformerConfig)
from ivideogpt_tpu_torch.models.action_model import HeadModelWithAction
from ivideogpt_tpu_torch.models.llama import DropoutKey
from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
from ivideogpt_tpu_torch.parallel.mesh import Mesh
from ivideogpt_tpu_torch.train.lora import LoraAdapters
from ivideogpt_tpu_torch.train.optim import TrainState
from ivideogpt_tpu_torch.utils import profiling
from ivideogpt_tpu_torch.utils.platform import full_fp32, resolve_device

Batch = Dict[str, torch.Tensor]


def build_train_models(tok_cfg: CompressiveVQConfig = TOKENIZER_64,
                       lm_cfg: TransformerConfig = LLAMA_BASE, *,
                       context_length: int = 2, segment_length: int = 16,
                       action_dim: int = 4,
                       action_recon: Optional[float] = None,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       seed: int = 0, device=None
                       ) -> Tuple[CompressiveVQModel, HeadModelWithAction]:
    """The frozen fp32 tokenizer and the LM to train, with random weights
    from ``seed``, at the shapes of ``train_gpt.py``'s ``build_models``:
    the LM's vocabulary is the tokenizer's, its parameters fp32, its
    compute ``compute_dtype``. Everything else (remat, dropout) is
    ``lm_cfg``'s as given. On CUDA unless ``device`` says otherwise."""
    dev = resolve_device(device)
    tok_cfg = tok_cfg.replace(context_length=context_length)
    lm_cfg = lm_cfg.replace(vocab_size=tok_cfg.vocab_size)
    head_cfg = ActionModelConfig(
        action_dim=action_dim, context_length=context_length,
        segment_length=segment_length,
        tokens_per_context=tok_cfg.ctx_tokens_per_frame,
        tokens_per_dyna=tok_cfg.dyn_tokens_per_frame,
        action_recon=action_recon)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        tokenizer = CompressiveVQModel(tok_cfg)
        model = HeadModelWithAction(lm_cfg, head_cfg, dtype=compute_dtype)
    tokenizer.requires_grad_(False)
    return tokenizer.to(dev).eval(), model.to(dev).train()


def create_train_state(model: HeadModelWithAction,
                       cfg: GPTTrainConfig) -> TrainState:
    """AdamW, schedule, clipping and accumulation from the trainer config,
    as ``train_gpt.py`` passes them to ``make_optimizer``."""
    return _state(model, cfg, cfg.embed_no_wd)


def create_lora_train_state(adapters: LoraAdapters,
                            cfg: GPTTrainConfig) -> TrainState:
    """The LoRA run's state: AdamW over the adapters alone with the
    config's schedule, clipping and accumulation, every adapter decayed
    (the JAX driver's ``make_optimizer(..., embed_no_wd=False)``, so the
    ``embed_tokens`` pair is not exempt)."""
    return _state(adapters, cfg, embed_no_wd=False)


def _state(model, cfg: GPTTrainConfig, embed_no_wd: bool) -> TrainState:
    return TrainState(
        model, learning_rate=cfg.learning_rate, lr_scheduler=cfg.lr_scheduler,
        warmup_steps=cfg.lr_warmup_steps, total_steps=cfg.max_train_steps,
        weight_decay=cfg.weight_decay, embed_no_wd=embed_no_wd,
        b1=cfg.adam_beta1, b2=cfg.adam_beta2, eps=cfg.adam_epsilon,
        max_grad_norm=cfg.max_grad_norm,
        gradient_accumulation_steps=cfg.gradient_accumulation_steps)


def make_tokenize_fn(tokenizer: CompressiveVQModel, context_length: int
                     ) -> Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                         torch.Tensor]]:
    """pixels [B, T, H, W, C] -> (input_ids, labels) [B, L] through the
    frozen tokenizer: no gradient, TF32 off; the span ``train.tokenize``."""
    def tokenize(pixels):
        with profiling.span("train.tokenize"), torch.no_grad(), full_fp32():
            return tokenizer.tokenize(pixels, context_length)
    return tokenize


def _rank_key(rng: Optional[DropoutKey], batch: Batch,
              mesh: Optional[Mesh]) -> Optional[DropoutKey]:
    """The step's dropout key at this rank's first global row."""
    if rng is None or mesh is None:
        return rng
    return (rng[0], rng[1], mesh.data_rank * batch["input_ids"].shape[0])


def _backward(loss: torch.Tensor, state: TrainState, mesh: Optional[Mesh]):
    """The backward, then the data group's gradient mean on a mesh."""
    with profiling.span("train.backward"):
        loss.backward()
        if mesh is not None:
            mesh.data_mean_([p.grad for p in state.params
                             if p.grad is not None])


def _data_mean(loss: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return loss if mesh is None else mesh.data_mean([loss])[0]


def train_step(state: TrainState, batch: Batch,
               rng: Optional[DropoutKey] = None, mesh: Optional[Mesh] = None
               ) -> Dict[str, torch.Tensor]:
    """One micro-batch: forward, backward, then ``state.apply_gradients``.
    batch: {"input_ids", "labels" [B, L][, "action" [B, T, A]]} (this
    rank's rows on a ``mesh``); ``rng`` is the step's attention-dropout
    key (seed, step), which a model with ``attention_dropout > 0`` needs
    (the JAX step's ``rng``, ``deterministic=False``). Returns 0-dim
    tensors (no host sync): loss, the unclipped gradient norm and
    perplexity. The step is the span (``utils.profiling``) ``train.step``,
    its parts ``train.forward`` (the model and its loss),
    ``train.backward`` (with the data group's gradient mean),
    ``train.clip`` (the norm here and the clip in ``apply_gradients``) and
    ``train.adamw``."""
    with profiling.span("train.step"):
        model = state.model
        model.train()
        with profiling.span("train.forward"):
            loss = model(batch["input_ids"], batch["labels"],
                         batch.get("action"),
                         dropout_key=_rank_key(rng, batch, mesh))["loss"]
        _backward(loss, state, mesh)
        with profiling.span("train.clip"):
            gnorm = state.grad_norm([p.grad for p in state.params
                                     if p.grad is not None])
        state.apply_gradients()
        loss = _data_mean(loss.detach(), mesh)
        return {"loss": loss, "grad_norm": gnorm,
                "perplexity": torch.exp(loss)}


def lora_train_step(state: TrainState, model: HeadModelWithAction,
                    batch: Batch, rng: Optional[DropoutKey] = None,
                    mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One micro-batch of a LoRA run: ``model`` carries the adapters that
    ``state`` trains (``train/lora.attach``), so its forward reads the
    merged weights and the backward reaches only the adapters; then
    ``state.apply_gradients``. ``batch``, ``rng`` and ``mesh`` as in
    :func:`train_step`. Returns 0-dim tensors: loss and perplexity, the
    JAX step's metrics. Its spans are :func:`train_step`'s."""
    with profiling.span("train.step"):
        model.train()
        with profiling.span("train.forward"):
            loss = model(batch["input_ids"], batch["labels"],
                         batch.get("action"),
                         dropout_key=_rank_key(rng, batch, mesh))["loss"]
        _backward(loss, state, mesh)
        state.apply_gradients()
        loss = _data_mean(loss.detach(), mesh)
        return {"loss": loss, "perplexity": torch.exp(loss)}


@torch.no_grad()
def eval_step(model: HeadModelWithAction, batch: Batch,
              mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """Loss and perplexity without dropout, the loss the data group's
    mean on a ``mesh``."""
    model.eval()
    loss = _data_mean(model(batch["input_ids"], batch["labels"],
                            batch.get("action"))["loss"], mesh)
    return {"loss": loss, "perplexity": torch.exp(loss)}
