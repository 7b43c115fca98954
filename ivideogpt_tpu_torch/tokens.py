"""The token-stream contract on torch tensors.

    [ctx frame 1: 256 ctx-tokens] [scf] [ctx frame 2: 256 ctx-tokens]
    [sdf] [16 dyn-tokens] [sdf] [16 dyn-tokens] ...   (T - ctx times)

- the first scf is dropped
- dyn token ids are offset by +num_vq_embeddings
- scf = num_vq + num_dyn, sdf = scf + 1
- labels are -100 over the prelude and the first sdf
- sequence length for (ctx=2, T=16, 64px): 2*257 - 1 + 14*17 = 751

Same functions and integers as ``ivideogpt_tpu/tokens.py``.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def seq_len(context_length: int, segment_length: int,
            ctx_tokens: int = 256, dyn_tokens: int = 16) -> int:
    """Total token-stream length for a (ctx, T) segment."""
    return (ctx_tokens + 1) * context_length - 1 \
        + (dyn_tokens + 1) * (segment_length - context_length)


def prelude_len(context_length: int, ctx_tokens: int = 256) -> int:
    """Number of context tokens incl. interleaved scf, excl. the first sdf."""
    return (ctx_tokens + 1) * context_length - 1


def max_new_tokens(context_length: int, segment_length: int,
                   dyn_tokens: int = 16) -> int:
    """HF-generate-equivalent budget: (1+16)*(T-ctx) - 1."""
    return (dyn_tokens + 1) * (segment_length - context_length) - 1


def _context_stream(ctx_indices: torch.Tensor, scf: int) -> torch.Tensor:
    """[B, ctx, n] -> [scf c c ... c] per frame, flattened, first scf dropped."""
    B, ctx, _ = ctx_indices.shape
    scf_col = ctx_indices.new_full((B, ctx, 1), scf)
    return torch.cat([scf_col, ctx_indices], dim=2).reshape(B, -1)[:, 1:]


def assemble(ctx_indices: torch.Tensor, dyn_indices: torch.Tensor,
             num_vq_embeddings: int, num_dyn_embeddings: int):
    """Interleave per-frame token grids with separators into one stream.

    ctx_indices [B, ctx, ctx_tokens] raw context ids; dyn_indices
    [B, F, dyn_tokens] raw dynamics ids (not yet offset).
    Returns (indices [B, L], labels [B, L]).
    """
    B, F, _ = dyn_indices.shape
    scf = num_vq_embeddings + num_dyn_embeddings
    stream_c = _context_stream(ctx_indices, scf)
    sdf_col = dyn_indices.new_full((B, F, 1), scf + 1)
    stream_d = torch.cat([sdf_col, dyn_indices + num_vq_embeddings],
                         dim=2).reshape(B, -1)
    indices = torch.cat([stream_c, stream_d], dim=1)
    labels = torch.cat([
        indices.new_full((B, stream_c.shape[1] + 1), IGNORE_INDEX),
        stream_d[:, 1:],
    ], dim=1)
    return indices, labels


def make_prelude(ctx_indices: torch.Tensor, num_vq_embeddings: int,
                 num_dyn_embeddings: int) -> torch.Tensor:
    """[B, ctx, ctx_tokens] raw context ids -> [B, prelude_len + 1] stream
    ending in the first sdf: the prefix ``generation.generate`` consumes."""
    scf = num_vq_embeddings + num_dyn_embeddings
    stream_c = _context_stream(ctx_indices, scf)
    sdf = stream_c.new_full((stream_c.shape[0], 1), scf + 1)
    return torch.cat([stream_c, sdf], dim=1)


def disassemble(indices: torch.Tensor, context_length: int,
                num_vq_embeddings: int, num_dyn_embeddings: int,
                ctx_tokens: int = 256, dyn_tokens: int = 16):
    """Inverse of :func:`assemble`: split a stream back into token grids.

    Both grids are clamped into their codebooks: an LM-sampled stream can
    carry any vocab id in any slot.
    Returns (ctx_indices [B, ctx, ctx_tokens], dyn_indices [B, F, dyn_tokens]).
    """
    B, L = indices.shape
    rest = L + 1 - (1 + ctx_tokens) * context_length
    if rest < 0 or rest % (1 + dyn_tokens):
        raise ValueError(
            f"stream length {L} does not match ctx={context_length}")
    future = rest // (1 + dyn_tokens)
    full = torch.cat([indices.new_ones((B, 1)), indices], dim=1)
    n_ctx_tok = context_length * (1 + ctx_tokens)
    ctx_part = full[:, :n_ctx_tok].reshape(
        B, context_length, 1 + ctx_tokens)[:, :, 1:]
    dyn_part = full[:, n_ctx_tok:].reshape(B, future, 1 + dyn_tokens)[:, :, 1:]
    ctx_part = ctx_part.clamp(0, num_vq_embeddings - 1)
    dyn_part = (dyn_part - num_vq_embeddings).clamp(0, num_dyn_embeddings - 1)
    return ctx_part, dyn_part


def sdf_positions(context_length: int, segment_length: int,
                  ctx_tokens: int = 256, dyn_tokens: int = 16,
                  device=None) -> torch.Tensor:
    """Positions of the sdf separators: the action-injection slots."""
    start = prelude_len(context_length, ctx_tokens)
    return start + torch.arange(segment_length - context_length,
                                device=device) * (dyn_tokens + 1)
