"""Autoregressive video-token generation over a KV cache, the port of
``ivideogpt_tpu/generation.py`` (its frame-structured ``bshd`` path).

Sequence bookkeeping (ctx tokens per frame C=256, dyn D=16):
  input  = prelude + first sdf            (length (C+1)*ctx, e.g. 514)
  frame f: D sampled dyn tokens, then a forced sdf carrying action[ctx+f]
  output = stream without the final sdf   (length seq_len, e.g. 751)

The JAX package runs this as one jitted scan; here it is a Python loop over
eager steps, with the cache updated in place. Over a cache K3 reads (int8
or ``"mixed"``) on the card, outside tensor parallelism, the one-token LM
step is a CUDA graph captured once a call and replayed at every later
step (:func:`_graphed`, :class:`_GraphedLMStep`); the draw stays eager.
Sampling draws from an explicit ``torch.Generator``; torch cannot
reproduce JAX's threefry draws, so streams from the two packages are
compared through their logits and top-k sets, never token for token.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from ivideogpt_tpu_torch.ops.decode_attention import (capture_launches,
                                                      count_replay)
from ivideogpt_tpu_torch.utils import profiling


class GenerateResult(NamedTuple):
    tokens: torch.Tensor             # [B, seq_len] full token stream
    rewards: Optional[torch.Tensor]  # [B, T-ctx] or None


def _cast_params(module: nn.Module, dtype: torch.dtype, min_ndim: int):
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim >= min_ndim and p.is_floating_point():
                p.data = p.data.to(dtype)
    return module


def cast_matmul_params(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast every >=2-D float parameter (dense kernels, embedding tables) to
    the compute dtype in place, leaving 1-D ones (norm scales, biases) fp32.
    Bit-identical for a model that computes in ``dtype`` (its layers cast at
    use); it saves the per-step cast and halves the weights' memory."""
    return _cast_params(module, dtype, 2)


def cast_conv_params(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Tokenizer companion of :func:`cast_matmul_params`: cast >=3-D float
    parameters (conv kernels) in place, leaving 1-/2-D ones fp32; the 2-D
    ones include the VQ codebooks, which stay fp32 for exact lookups."""
    return _cast_params(module, dtype, 3)


def _float32_order_key(x: torch.Tensor) -> torch.Tensor:
    """Monotonic key as int64 holding the uint32 pattern:
    a > b  <=>  key(a) > key(b) for finite floats."""
    b = x.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= 0, b | 0x80000000, 0xFFFFFFFF ^ b)


def _bf16_order_key(x: torch.Tensor) -> torch.Tensor:
    """Monotonic key over bf16 values, as int32 holding the uint16 pattern."""
    b = x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(x >= 0, b | 0x8000, 0xFFFF ^ b)


def _kth_largest(keys: torch.Tensor, k: int, bits: int) -> torch.Tensor:
    """Largest p with count(keys >= p) >= k, per row, by a binary search on
    the key bits: the exact k-th largest key."""
    p = torch.zeros((keys.shape[0], 1), dtype=keys.dtype, device=keys.device)
    for bit in range(bits - 1, -1, -1):
        cand = p | (1 << bit)
        cnt = (keys >= cand).sum(dim=1, keepdim=True)
        p = torch.where(cnt >= k, cand, p)
    return p[:, 0]


def exact_kth_largest_key(logits: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys [B, V], kth [B]): each logit's order key and the exact k-th
    largest key per row (32-bit search)."""
    keys = _float32_order_key(logits)
    return keys, _kth_largest(keys, k, 32)


def exact_kth_largest_key_bf16(logits: torch.Tensor, k: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """16-bit variant for logits that are exactly bf16-representable (a bf16
    unembed upcast to fp32): the same set in half the passes."""
    keys = _bf16_order_key(logits)
    return keys, _kth_largest(keys, k, 16)


def top_k_keep_mask(logits: torch.Tensor, top_k: int,
                    bf16_exact: bool = False) -> torch.Tensor:
    """[B, V] bool: the logits at or above the k-th largest. Ties at the
    k-th value are all kept, as HF's ``TopKLogitsWarper`` does."""
    search = exact_kth_largest_key_bf16 if bf16_exact else exact_kth_largest_key
    keys, kth = search(logits, top_k)
    return keys >= kth[:, None]


def sample_top_k(logits: torch.Tensor, generator: torch.Generator,
                 top_k: int = 100, temperature: float = 1.0,
                 bf16_exact: bool = False,
                 batch_rows: Optional[Tuple[int, int]] = None
                 ) -> torch.Tensor:
    """Restrict to the top-k set (threshold search), then draw one token
    per row from softmax(logits / T) by the Gumbel-max trick. With
    ``batch_rows`` = (first row, global batch), ``logits`` are a data-
    parallel rank's rows of a global batch: the generator draws the whole
    batch's uniforms and the rank keeps its rows, so it samples what one
    process over the whole batch samples from the same logits."""
    keep = top_k_keep_mask(logits, top_k, bf16_exact)
    masked = torch.where(keep, logits / temperature,
                         torch.full_like(logits, float("-inf")))
    if batch_rows is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
    else:
        r0, total = batch_rows
        u = torch.rand((total, logits.shape[1]), generator=generator,
                       device=logits.device)[r0:r0 + logits.shape[0]]
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (masked - torch.log(-torch.log(u))).argmax(dim=-1)


def _graphed(model, cache, device) -> bool:
    """Whether :func:`generate` replays its one-token LM step as a CUDA
    graph: on a CUDA ``device``, over a cache that K3 reads (its layers
    hold ``vs``: int8 or ``"mixed"``), and with no module of ``model`` in
    a tensor-parallel group (whose collectives stay eager). The bf16
    cache's attention reads its position back to the host, which a
    capture cannot hold."""
    return (torch.device(device).type == "cuda" and "vs" in cache[0]
            and all(getattr(m, "tp_group", None) is None
                    for m in model.modules()))


_side_streams: dict = {}   # device -> the stream graphs are captured on
_last_graphs: dict = {}    # device -> the last graph captured there, kept


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One capture stream a device, kept: cuBLAS keeps a workspace for
    every stream it has run on."""
    stream = _side_streams.get(device)
    if stream is None:
        stream = _side_streams[device] = torch.cuda.Stream(device)
    return stream


def _eager_lm_step(model, cache, emb: torch.Tensor, index: int
                   ) -> torch.Tensor:
    _counters.eager_lm_steps += 1
    return model.decode_cached(emb, cache, index)[0]


class _GraphedLMStep:
    """The one-token LM steps of one :func:`generate` call as one CUDA
    graph. The first call runs its step eagerly on the device's capture
    stream, with the position on the device (cuBLAS, the kernels and the
    caching allocator warm there, outside any capture), then captures the
    same step on that stream over static buffers: the input embedding
    [B, 1, D] and the int32 position. Every later call writes the two
    buffers and replays the graph on the current stream, and counts the K3
    launches the capture recorded. Its output is the static hidden
    [B, 1, D], which the next replay overwrites. The buffers go with the
    object.

    The capture shares the memory pool of the device's last graph, which
    is kept for that alone (never replayed again) until the next capture
    replaces it: the pool then outlives each call, and each capture takes
    the blocks the last one freed. A graph's own pool would stay reserved
    after the graph is dropped, until the allocator next empties its
    cache, so a long-lived process would reserve more with every call. As
    with K3's workspaces, one device's calls must not run on two streams
    at once."""

    def __init__(self, model, cache):
        self.model, self.cache = model, cache
        self.graph = self.emb = self.pos = self.hidden = self.k3 = None

    def __call__(self, emb: torch.Tensor, index: int) -> torch.Tensor:
        if self.graph is not None:
            self.emb.copy_(emb)
            self.pos.fill_(index)
            self.graph.replay()
            count_replay(self.k3)
            _counters.graph_replays += 1
            return self.hidden
        self.emb = emb.clone()
        self.pos = torch.full((1,), index, dtype=torch.int32,
                              device=emb.device)
        main = torch.cuda.current_stream(emb.device)
        side = _side_stream(emb.device)
        side.wait_stream(main)
        last = _last_graphs.get(emb.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            hidden = self.model.decode_cached(self.emb, self.cache,
                                              self.pos)[0]
            with capture_launches() as self.k3:
                graph.capture_begin(pool=None if last is None else last.pool(),
                                    capture_error_mode="thread_local")
                try:
                    self.hidden = self.model.decode_cached(
                        self.emb, self.cache, self.pos)[0]
                finally:
                    graph.capture_end()
        main.wait_stream(side)
        hidden.record_stream(main)
        self.graph = _last_graphs[emb.device] = graph
        _counters.eager_lm_steps += 1
        _counters.graph_captures += 1
        return hidden


@torch.inference_mode()
def generate(model, prelude_tokens: torch.Tensor, *, segment_length: int,
             context_length: int, generator: torch.Generator,
             action: Optional[torch.Tensor] = None,
             action_fn: Optional[Callable[[int], torch.Tensor]] = None,
             on_frame: Optional[Callable] = None,
             tokens_per_dyna: int = 16, top_k: int = 100,
             temperature: float = 1.0, reward_prediction: bool = False,
             cache_dtype: Union[torch.dtype, str] = torch.bfloat16,
             batch_rows: Optional[Tuple[int, int]] = None
             ) -> GenerateResult:
    """Autoregressive rollout of (segment_length - context_length) frames.

    model: a HeadModelWithAction; prelude_tokens [B, P1] context tokens and
    the first sdf. Frame f's sdf carries action[:, ctx - 1 + f] from
    action [B, T, A], or the [B, A] that ``action_fn(f)`` returns; with
    ``action_fn`` every sdf, the first one too, is decoded on its own step
    once its action is known (the prefill stops before the prelude's sdf),
    so an action may depend on the frames before it. ``on_frame(f, tokens
    [B, D], reward [B] or None)`` is called once frame f is sampled. The
    final sampled token is not decoded unless rewards are wanted; rewards
    are read after each frame's last dyn token. The prefill and each
    frame's decode steps run inside the spans (``utils.profiling``)
    ``generation.prefill`` and ``generation.decode``, the callbacks outside
    them; inside a frame's, each LM step (its embed, the action add and
    ``decode_cached``) is a ``generation.lm_step`` and each draw (the
    unembed, ``sample_top_k`` and the token's write) a
    ``generation.sample``. ``cache_dtype``: the KV cache's
    (``models.llama.init_cache``): a float dtype, ``torch.int8`` or
    ``"mixed"``, over the model's ``num_key_value_heads``. ``batch_rows``
    = (first row, global batch) makes the rows a data-parallel rank's
    (:func:`sample_top_k`).

    Where :func:`_graphed` holds, the first one-token LM step runs eagerly
    and every later one replays a CUDA graph captured after it
    (:class:`_GraphedLMStep`); the tokens and rewards are those of the
    eager loop, bit for bit. ``generate.graph_captures``,
    ``generate.graph_replays`` and ``generate.eager_lm_steps`` count the
    captures and the one-token LM steps replayed and run eagerly.
    """
    B, P1 = prelude_tokens.shape
    F = segment_length - context_length
    D = tokens_per_dyna
    D1 = D + 1
    total = P1 + D1 * F
    sdf_token = model.llm_config.vocab_size - 1
    bf16_exact = model.dtype == torch.bfloat16
    if action is not None and action_fn is not None:
        raise ValueError("pass action or action_fn, not both")

    cache = model.init_cache(B, total, cache_dtype, prelude_tokens.device)
    if _graphed(model, cache, prelude_tokens.device):
        lm_step = _GraphedLMStep(model, cache)
    else:
        lm_step = functools.partial(_eager_lm_step, model, cache)
    with profiling.span("generation.prefill"):
        if action_fn is None:
            embeds = model.embed_tokens(prelude_tokens)
        else:
            embeds = model.embed_tokens(prelude_tokens[:, :-1])
        action_embeds = None
        if action is not None:
            action_embeds = model.action_embeds(action)    # [B, T, hidden]
            embeds[:, P1 - 1] += action_embeds[:, context_length - 1].to(
                embeds.dtype)
        hidden, _ = model.decode_cached(embeds, cache, 0)
        sdf_emb = model.embed_tokens(prelude_tokens.new_full((B, 1),
                                                             sdf_token))

    buf = prelude_tokens.new_zeros((B, total))
    buf[:, :P1] = prelude_tokens
    rewards = []
    for f in range(F):
        s0 = P1 + f * D1   # the frame's first token; its sdf just before
        act = action_fn(f) if action_fn is not None else None
        with profiling.span("generation.decode"):
            if f or action_fn is not None:
                with profiling.span("generation.lm_step"):
                    emb = sdf_emb
                    if act is not None:
                        emb = emb + model.action_embeds(act)[:, None].to(
                            emb.dtype)
                    elif action_embeds is not None:
                        emb = emb + action_embeds[
                            :, context_length - 1 + f, None].to(emb.dtype)
                    buf[:, s0 - 1] = sdf_token
                    hidden = lm_step(emb, s0 - 1)
            for j in range(D):
                with profiling.span("generation.sample"):
                    token = sample_top_k(model.unembed(hidden[:, -1]),
                                         generator, top_k, temperature,
                                         bf16_exact, batch_rows)
                    buf[:, s0 + j] = token
                if f == F - 1 and j == D - 1 and not reward_prediction:
                    break  # its logits would only feed the dropped final sdf
                with profiling.span("generation.lm_step"):
                    hidden = lm_step(model.embed_tokens(token[:, None]),
                                     s0 + j)
            reward = (model.reward(hidden[:, -1]).float()
                      if reward_prediction else None)
        if reward is not None:
            rewards.append(reward)
        if on_frame is not None:
            on_frame(f, buf[:, s0:s0 + D], reward)
    tokens = buf[:, :-1]  # the final sdf slot is never written nor needed
    return GenerateResult(tokens,
                          torch.stack(rewards, 1) if reward_prediction else None)


generate.graph_captures = 0
generate.graph_replays = 0
generate.eager_lm_steps = 0
# the counters' holder: a caller may replace the module's ``generate`` by a
# wrapper (the benchmark's timers do) while the steps count here
_counters = generate


@torch.inference_mode()
def replay_logits(model, stream: torch.Tensor, *, segment_length: int,
                  context_length: int, action: Optional[torch.Tensor] = None,
                  tokens_per_dyna: int = 16,
                  cache_dtype: Union[torch.dtype, str] = torch.bfloat16
                  ) -> torch.Tensor:
    """Teacher-forced cached replay of a token stream: the per-step logits
    the decode path samples from. logits[0] is the prefill output at
    position P1-1; logits[s] for s > 0 follows the decode of stream position
    P1-1+s. stream [B, L] (final sdf dropped) -> [L - P1 + 1, B, V] fp32.
    ``cache_dtype`` as in :func:`generate`.
    """
    B, L = stream.shape
    D1 = tokens_per_dyna + 1
    F = segment_length - context_length
    P1 = (model.head_config.tokens_per_context + 1) * context_length

    embeds = model.embed_tokens(stream)
    if action is not None:
        positions = P1 - 1 + torch.arange(F, device=stream.device) * D1
        a = model.action_embeds(action)[:, context_length - 1:-1]
        embeds[:, positions] += a.to(embeds.dtype)

    cache = model.init_cache(B, L + 1, cache_dtype, stream.device)
    hidden, _ = model.decode_cached(embeds[:, :P1], cache, 0)
    out = [model.unembed(hidden[:, -1])]
    for idx in range(P1, L):
        hidden, _ = model.decode_cached(embeds[:, idx:idx + 1], cache, idx)
        out.append(model.unembed(hidden[:, 0]))
    return torch.stack(out).float()
