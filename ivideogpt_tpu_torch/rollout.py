"""The main path: context tokenize -> KV-cached generate -> detokenize.

The port's counterpart of the rollout ``bench.py`` times in the JAX
package (64x64, 16 frames, ctx 2, TOKENIZER_64 + LLAMA_BASE with the
action head, bf16 under the cast rules, int8 KV cache):

    tokenizer, lm = build_models(seed=0)             # on CUDA
    result = rollout(tokenizer, lm, context_frames, action,
                     segment_length=16, generator=torch.Generator("cuda"))

``build_models`` runs on CUDA unless given ``device="cpu"`` and raises
when CUDA is absent. The two knobs of ``bench.py`` are arguments here:
``cache_dtype`` (``BENCH_KV``: ``torch.int8``, the default, bf16 or
``"mixed"``, bf16 K and int8 V) and ``int8_detok`` (``BENCH_INT8_DETOK``:
``"0"``, the default bf16 render, ``"1"`` int8 convs with dynamic scales,
``"static"`` int8 convs with scales calibrated once, on the first chunk
rendered, and a margin of 1.1; see :func:`detokenize`).
``load_hub_models`` builds the same pair from a
published hub dir instead, its tokenizer re-sliced to a shorter context
where asked: the ctx=2 hub tokenizer at ctx=1 is the BAIR eval protocol.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from ivideogpt_tpu_torch import generation, tokens
from ivideogpt_tpu_torch.configs import (LLAMA_BASE, TOKENIZER_64,
                                         ActionModelConfig,
                                         CompressiveVQConfig,
                                         TransformerConfig)
from ivideogpt_tpu_torch.models.action_model import HeadModelWithAction
from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
from ivideogpt_tpu_torch.ops import qconv
from ivideogpt_tpu_torch.utils import checkpoint as ckpt
from ivideogpt_tpu_torch.utils import profiling
from ivideogpt_tpu_torch.utils.platform import resolve_device


class RolloutResult(NamedTuple):
    tokens: torch.Tensor  # [B, seq_len]
    frames: torch.Tensor  # [B, T, H, W, C]


def build_models(tok_cfg: CompressiveVQConfig = TOKENIZER_64,
                 lm_cfg: TransformerConfig = LLAMA_BASE, *,
                 context_length: int = 2, segment_length: int = 16,
                 action_dim: int = 4, dtype: torch.dtype = torch.bfloat16,
                 seed: int = 0, device=None
                 ) -> Tuple[CompressiveVQModel, HeadModelWithAction]:
    """Tokenizer and action-conditioned LM with random weights from ``seed``.

    For a dtype other than fp32 the cast rules apply: the tokenizer's conv
    kernels and the LM's matrices are stored in ``dtype``; 1-D parameters
    and the VQ codebooks stay fp32."""
    dev = resolve_device(device)
    tok_cfg = tok_cfg.replace(context_length=context_length)
    head_cfg = ActionModelConfig(
        action_dim=action_dim, context_length=context_length,
        segment_length=segment_length,
        tokens_per_context=tok_cfg.ctx_tokens_per_frame,
        tokens_per_dyna=tok_cfg.dyn_tokens_per_frame)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        tokenizer = CompressiveVQModel(tok_cfg, dtype)
        lm = HeadModelWithAction(lm_cfg, head_cfg, dtype)
    return _place(tokenizer, lm, dtype, dev)


def _place(tokenizer, lm, dtype, dev):
    """The cast rules for a dtype other than fp32, then onto ``dev``."""
    if dtype != torch.float32:
        generation.cast_conv_params(tokenizer, dtype)
        generation.cast_matmul_params(lm, dtype)
    return tokenizer.to(dev).eval(), lm.to(dev).eval()


def load_hub_models(root: str, *, context_length: int, segment_length: int,
                    device=None
                    ) -> Tuple[CompressiveVQModel, HeadModelWithAction]:
    """Tokenizer and action-conditioned LM from the hub dir ``root`` (the
    action width is the file's), the tokenizer re-sliced to
    ``context_length`` (``utils.checkpoint.load_tokenizer_for_context``:
    raises where the checkpoint's context is shorter), in bf16 under the
    cast rules, as :func:`build_models` makes them."""
    dev = resolve_device(device)
    tok_sd, tok_cfg = ckpt.load_tokenizer_for_context(
        os.path.join(root, "tokenizer"), context_length)
    if tok_cfg is None:
        raise FileNotFoundError(f"{root}/tokenizer has no config.json")
    tf_dir = os.path.join(root, "transformer")
    lm_cfg = ckpt.llama_config_from_hub(
        ckpt.read_json(os.path.join(tf_dir, "config.json")),
        vocab_size=tok_cfg.vocab_size)
    lm_sd = ckpt.load_action_model_safetensors(tf_dir)
    dtype = torch.bfloat16
    tokenizer = CompressiveVQModel(tok_cfg, dtype)
    tokenizer.load_state_dict(tok_sd)
    lm = HeadModelWithAction(lm_cfg, ckpt.action_head_config(
        lm_sd, tok_cfg, action_dim=lm_sd["action_linear.weight"].shape[1],
        context_length=context_length, segment_length=segment_length), dtype)
    lm.load_state_dict(lm_sd)
    return _place(tokenizer, lm, dtype, dev)


@torch.inference_mode()
def rollout(tokenizer: CompressiveVQModel, lm: HeadModelWithAction,
            context_frames: torch.Tensor, action: Optional[torch.Tensor], *,
            segment_length: int, generator: torch.Generator,
            cache_dtype: Union[torch.dtype, str] = torch.int8,
            top_k: int = 100, temperature: float = 1.0,
            detok_chunk: int = 128, int8_detok: str = "0",
            static_scales: Optional[Dict[str, torch.Tensor]] = None
            ) -> RolloutResult:
    """context_frames [B, ctx, H, W, C] (and action [B, T, A]) -> the token
    stream [B, seq_len] and frames [B, T, H, W, C]. ``cache_dtype``: the
    KV cache's, ``"mixed"`` included. Detokenize runs in chunks of
    ``detok_chunk`` samples to cap its activation memory, rendered as
    ``int8_detok`` says (:func:`detokenize`). The call is the span
    (``utils.profiling``) ``rollout``, its stages ``rollout.tokenize``,
    ``rollout.generate`` and ``rollout.detokenize``."""
    device = next(tokenizer.parameters()).device
    if context_frames.device != device:
        raise ValueError(f"context frames on {context_frames.device}, "
                         f"models on {device}")
    B, ctx = context_frames.shape[:2]
    cfg = tokenizer.config
    with profiling.span("rollout"):
        with profiling.span("rollout.tokenize"):
            prelude = tokens.make_prelude(
                tokenizer.encode_context(context_frames),
                cfg.num_vq_embeddings, cfg.num_dyn_embeddings)
        with profiling.span("rollout.generate"):
            res = generation.generate(
                lm, prelude, segment_length=segment_length,
                context_length=ctx, generator=generator, action=action,
                tokens_per_dyna=cfg.dyn_tokens_per_frame, top_k=top_k,
                temperature=temperature, cache_dtype=cache_dtype)
        with profiling.span("rollout.detokenize"):
            frames = detokenize(tokenizer, res.tokens, ctx, detok_chunk,
                                int8_detok, static_scales)
    return RolloutResult(res.tokens, frames)


STATIC_MARGIN = 1.1  # bench.py's headroom over the calibrated absmax


def detokenize(tokenizer: CompressiveVQModel, stream: torch.Tensor,
               ctx: int, chunk: int = 128, int8_detok: str = "0",
               static_scales: Optional[Dict[str, torch.Tensor]] = None
               ) -> torch.Tensor:
    """The token stream [B, L] -> frames [B, T, H, W, C], ``chunk`` samples
    at a time. ``int8_detok``: ``"0"`` the render in the tokenizer's dtype;
    ``"1"`` under ``ops.qconv.int8_convs()`` (dynamic per-tensor scales);
    ``"static"`` under ``int8_convs(static_scales, margin=1.1)``, where
    ``static_scales`` (a dict the caller keeps across rollouts; a fresh
    one when None) is filled on first use from the first chunk's float
    render under ``calibrate_convs``, as ``bench.py`` calibrates on the
    first chunk actually rendered."""
    if int8_detok not in ("0", "1", "static"):
        raise ValueError(f"int8_detok={int8_detok!r}: expected '0', '1' or "
                         f"'static'")
    if static_scales is None:
        static_scales = {}
    parts = []
    for i in range(0, stream.shape[0], chunk):
        ids = stream[i:i + chunk]
        if int8_detok == "static" and not static_scales:
            with qconv.calibrate_convs() as rec:
                tokenizer.detokenize(ids, ctx)
            static_scales.update(rec.scales())
        if int8_detok == "0":
            mode = contextlib.nullcontext()
        elif int8_detok == "1":
            mode = qconv.int8_convs()
        else:
            mode = qconv.int8_convs(static_scales, margin=STATIC_MARGIN)
        with mode:
            parts.append(tokenizer.detokenize(ids, ctx))
    return torch.cat(parts)
