"""Multi-process sharded inference, the serving path: the port of
``ivideogpt_tpu/parallel/serving.py``.

The reference serves with Accelerate data parallelism, each GPU a full
replica generating its slice of the batch (reference train_gpt.py:672-679);
the JAX package generalises it to one ("data", "model") mesh. Here each
rank of the mesh (``parallel/mesh``) is one process on one card:

- the batch splits over "data": every rank is handed the global batch
  and runs its rows (``mesh.batch_rows``), sampling from the global
  batch's uniforms (``generation.sample_top_k``), so a data-parallel
  rollout samples what one process samples from the same logits;
- the LM's projections may split over "model" (``mesh.shard_params``):
  each rank holds H / n_model heads and their KV cache, and the block
  outputs are summed over the model group once an attention block and
  once an MLP a decoded token; the ranks of a model group hold the same
  logits and the same generator, so they sample the same tokens.

The functions return this rank's rows; ``distributed.
gather_across_processes`` collects them where a caller needs the whole
batch on one rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from ivideogpt_tpu_torch import generation, tokens
from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
from ivideogpt_tpu_torch.parallel.mesh import Mesh
from ivideogpt_tpu_torch.rollout import detokenize


def _check_batch(B: int, mesh: Mesh) -> None:
    n_data = mesh.shape["data"]
    if B % n_data != 0:
        raise ValueError(
            f"rollout batch {B} not divisible by the data axis {n_data}; "
            f"pad the batch or reshape the mesh")


def place_inference_params(model, mesh: Mesh):
    """Place an LM for serving: the tensor-parallel rules of training
    (``mesh.shard_params``), in place; returns the model. A model is
    placed once: its weights are this rank's shard afterwards."""
    return mesh_lib.shard_params(model, mesh)


def sharded_generate(model, prelude_tokens: torch.Tensor, *, mesh: Mesh,
                     generator: torch.Generator,
                     action: Optional[torch.Tensor] = None,
                     **generate_kwargs) -> generation.GenerateResult:
    """``generation.generate`` of this rank's rows of the global
    ``prelude_tokens`` [B, P1] (and ``action`` [B, T, A]), every rank
    passing the same global batch and a generator in the same state, the
    model already placed (:func:`place_inference_params`). Returns this
    rank's rows of the stream (and rewards)."""
    B = prelude_tokens.shape[0]
    _check_batch(B, mesh)
    rows = mesh_lib.batch_rows(B, mesh)
    if action is not None:
        action = action[rows]
    return generation.generate(model, prelude_tokens[rows],
                               generator=generator, action=action,
                               batch_rows=(rows.start, B), **generate_kwargs)


def sharded_rollout(tokenizer, model, pixels: torch.Tensor, *, mesh: Mesh,
                    generator: torch.Generator, segment_length: int,
                    context_length: int,
                    action: Optional[torch.Tensor] = None,
                    detok_chunk: int = 128, **generate_kwargs):
    """The serving pipeline on a mesh, tokenize ctx -> generate ->
    detokenize, of this rank's rows of the global context pixels [B, ctx,
    H, W, 3]: the multi-process ``inference/predict.py`` flow (reference
    inference/predict.py:101-131). The tokenizer runs whole on every rank
    over the rank's rows (its convs have no tensor-parallel rule).
    ``tokens_per_dyna`` is the tokenizer's ``dyn_tokens_per_frame``, at
    latent_resolution / patch_size, not at max_att_resolution, which only
    gates where the encoder's attention turns on (the two differ for
    TOKENIZER_256). The JAX package's ``_tokenizer_fns`` caches jitted
    programs and has no counterpart: PyTorch runs eagerly. Returns (this
    rank's frames [B / n_data, T, H, W, 3], its GenerateResult)."""
    B = pixels.shape[0]
    _check_batch(B, mesh)
    rows = mesh_lib.batch_rows(B, mesh)
    cfg = tokenizer.config
    with torch.inference_mode():
        prelude = tokens.make_prelude(
            tokenizer.encode_context(pixels[rows]), cfg.num_vq_embeddings,
            cfg.num_dyn_embeddings)
    res = generation.generate(
        model, prelude, segment_length=segment_length,
        context_length=context_length, generator=generator,
        action=None if action is None else action[rows],
        tokens_per_dyna=cfg.dyn_tokens_per_frame,
        batch_rows=(rows.start, B), **generate_kwargs)
    with torch.inference_mode():
        frames = detokenize(tokenizer, res.tokens, context_length,
                            detok_chunk)
    return frames, res
