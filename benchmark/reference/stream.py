"""The token stream of iVideoGPT's LM, written from its description:

    [c ... c] [scf] [c ... c] [sdf] [d ... d] [sdf] [d ... d] ...

the context frames' ids (ctx_tokens each, the first frame's scf dropped),
then for every future frame an sdf and its dyn_tokens dynamics ids offset
by the context codebook's size; scf = n_vq + n_dyn, sdf = scf + 1. Labels
are -100 over the context part and the first sdf.
"""

from __future__ import annotations

import torch

IGNORE = -100


def assemble(ctx_ids, dyn_ids, config: dict):
    """Raw ids [B, ctx, ctx_tokens] and [B, F, dyn_tokens] -> (stream
    [B, L], labels [B, L])."""
    nv = config["num_vq_embeddings"]
    scf = nv + config["num_dyn_embeddings"]
    B, ctx, n = ctx_ids.shape
    F_ = dyn_ids.shape[1]
    c = torch.cat([ctx_ids.new_full((B, ctx, 1), scf), ctx_ids], 2)
    c = c.reshape(B, -1)[:, 1:]
    d = torch.cat([dyn_ids.new_full((B, F_, 1), scf + 1), dyn_ids + nv], 2)
    d = d.reshape(B, -1)
    labels = torch.cat([c.new_full((B, c.shape[1] + 1), IGNORE), d[:, 1:]], 1)
    return torch.cat([c, d], 1), labels


def split_stream(stream, ctx: int, config: dict, dims: dict):
    """A stream [B, L] (the final sdf left out) -> raw ids [B, ctx,
    ctx_tokens] and [B, F, dyn_tokens], each clamped into its codebook: a
    sampled stream may carry any id in any slot."""
    B, L = stream.shape
    nc, nd = dims["ctx_tokens"], dims["dyn_tokens"]
    nv, ndyn = config["num_vq_embeddings"], config["num_dyn_embeddings"]
    full = torch.cat([stream.new_zeros((B, 1)), stream], 1)
    head = ctx * (nc + 1)
    F_ = (L + 1 - head) // (nd + 1)
    c = full[:, :head].reshape(B, ctx, nc + 1)[:, :, 1:]
    d = full[:, head:head + F_ * (nd + 1)].reshape(B, F_, nd + 1)[:, :, 1:]
    return c.clamp(0, nv - 1), (d - nv).clamp(0, ndyn - 1)


def prelude_len(ctx: int, dims: dict) -> int:
    return (dims["ctx_tokens"] + 1) * ctx - 1


def sdf_positions(ctx: int, frames: int, dims: dict) -> torch.Tensor:
    """The stream positions of the F sdf separators, where the actions
    enter."""
    return prelude_len(ctx, dims) + torch.arange(frames) * (
        dims["dyn_tokens"] + 1)


def sampled_positions(ctx: int, frames: int, dims: dict) -> torch.Tensor:
    """The stream positions of the dynamics tokens a rollout samples."""
    sdf = sdf_positions(ctx, frames, dims)
    return (sdf[:, None] + 1 + torch.arange(dims["dyn_tokens"])).reshape(-1)
