"""LLaMA-architecture causal LM with a KV cache, the port of
``ivideogpt_tpu/models/llama.py`` (RMSNorm, rotate-half RoPE, SwiGLU, no
biases, fp32 softmax and logits), with grouped KV heads: query head h reads
KV head ``h // (num_attention_heads / num_key_value_heads)``.

The cache is a list of per-layer dicts in the ``bshd`` layout over the KV
heads, updated in place:
- bf16 (or any float dtype): ``k``/``v`` [B, M, Hkv, hd];
- int8: ``k``/``v`` int8 [B, M, Hkv, hd] with bf16 per-(slot, head) scales
  ``ks``/``vs`` [B, M, Hkv], s = max|x|/127 + 1e-8, round half to even;
- ``"mixed"``: ``k`` bf16 without ``ks``, ``v`` int8 with ``vs``.

Attention:
- the training forward (``LlamaForCausalLM.forward``, no cache) and the
  prefill (cache_index 0, S > 1): causal attention over the fresh,
  unquantised k/v, ``ops.flash_attention.causal_attention`` (K4 forward,
  K5/K6 backward), K and V repeated across each head group; the prefill
  also writes the cache for later steps;
- one-token decode over the int8 or mixed cache: ``ops.decode_attention``
  (K3), which reads each KV head for its group of query heads;
- one-token decode over a float cache, and S > 1 tokens at a nonzero
  index over any cache: plain torch over the cache as written (quantized
  where it is, the new tokens included), keys masked past
  cache_index + i, the int8 scales folded into the scores and weights.
A one-token step may take its position on the device (``cache_index`` a
one-element int32 tensor): ``forward_cached`` turns it once a step into a
:class:`DevicePosition`, whose int64 slot RoPE reads and the cache is
written through (``index_copy_``) and whose int32 ``valid`` K3 takes, so
the step launches the same kernels whatever the position and a CUDA
graph of it replays at any position (``generation.generate``). The values
written and read are those of the host int's step, bit for bit. The float
cache's attention slices at host ints, so there the position is read back
(a wait on the card).
Attention dropout (``config.attention_dropout``, 0.1 in every published
recipe) acts in the training forward only, inside the attention kernels:
``forward(..., dropout_key=(seed, step))`` gives layer ``i`` the Philox
stream ``(seed, offset_of(step, i))`` (``ops/philox.py``), a pure function
of (seed, step, layer), so a remat recompute and a resumed run draw the
same masks. ``eval()`` never drops. A data-parallel rank passes
``dropout_key=(seed, step, b0)``, b0 the global index of its first row.
Tensor parallelism (``parallel/mesh.shard_params``): an attention block
holds ``heads`` query heads from global head ``head0`` on and
``kv_heads`` KV heads, an MLP ``intermediate_size`` columns; the block's
input is read whole (its gradient summed over the ``tp_group``) and its
output summed over the group (Megatron's pair,
``parallel/distributed.copy_to_group`` / ``reduce_from_group``). Either
way the kernels draw the dropout bits of the global (row, head) they
hold, so a sharded step drops as a one-process step over the whole batch
does; the cache holds the local KV heads.
Remat (``config.remat``) recomputes each layer in the backward through a
non-reentrant ``torch.utils.checkpoint``: with ``remat_policy`` "none"
the whole layer, with "dots" everything but the outputs of the matrix
products without batch dimensions (``aten.mm``, ``aten.addmm``: the seven
projections a layer), which are kept, as
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` keeps them;
the norms, RoPE, SiLU * up, the residual adds and the attention (the
kernels, or the plain version's batched products) are recomputed, as
under JAX, where a ``pallas_call`` is no dot. The JAX package's ``ghdm``
cache is its TPU kernel's own transposed layout; K3 serves the same
attention on ``bshd``.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ivideogpt_tpu_torch.configs import TransformerConfig
from ivideogpt_tpu_torch.models.layers import Dense
from ivideogpt_tpu_torch.ops.decode_attention import decode_attention
from ivideogpt_tpu_torch.ops.flash_attention import causal_attention
from ivideogpt_tpu_torch.ops.philox import Dropout, offset_of
from ivideogpt_tpu_torch.tokens import IGNORE_INDEX

Cache = List[Dict[str, torch.Tensor]]
# (seed, step) of one training step's attention dropout, or (seed, step,
# b0) for a data-parallel rank whose rows start at global row b0
DropoutKey = Union[Tuple[int, int], Tuple[int, int, int]]


class DevicePosition(NamedTuple):
    """A one-token step's position on the device, made once a step by
    :meth:`LlamaForCausalLM.forward_cached` for its layers: ``slot``
    int64 [1], the slot the step writes, and ``valid`` int32 [1], slot + 1,
    the live slots K3 reads."""
    slot: torch.Tensor
    valid: torch.Tensor


# a cached step's first position: a host int, or (one token) a one-element
# int32 tensor on the device, which the layers see as a DevicePosition
Position = Union[int, torch.Tensor]


# the "dots" policy's kept products: 2-D matrix products (with a bias)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_kwargs(policy: str) -> dict:
    """``checkpoint``'s arguments for a remat policy."""
    if policy == "none":
        return {"use_reentrant": False}
    if policy == "dots":
        return {"use_reentrant": False, "context_fn": partial(
            create_selective_checkpoint_contexts, _keep_dots)}
    raise ValueError(f"remat_policy {policy!r}: 'none' or 'dots'")


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-convention RoPE tables: cos/sin [..., head_dim], freqs duplicated."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=positions.device)
                                / head_dim))
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x, cos, sin):
    """x: [B, S, H, hd]; cos/sin: [B, S, hd] (broadcast over heads)."""
    return x * cos[:, :, None, :] + _rotate_half(x) * sin[:, :, None, :]


def quantize_int8(x: torch.Tensor):
    """[..., hd] -> (int8 values, bf16 scales [...]): s = max|x|/127 + 1e-8
    in fp32, round half to even, scale stored as bf16."""
    x = x.float()
    s = x.abs().amax(dim=-1) / 127.0 + 1e-8
    return torch.round(x / s[..., None]).to(torch.int8), s.to(torch.bfloat16)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(self.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, config: TransformerConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        if c.num_attention_heads % c.num_key_value_heads:
            raise ValueError(f"{c.num_attention_heads} query heads do not "
                             f"group over {c.num_key_value_heads} KV heads")
        self.config = c
        self.dtype = dtype
        # this rank's heads (all of them unless shard_params cut the block)
        self.heads, self.kv_heads = c.num_attention_heads, c.num_key_value_heads
        self.head0 = 0
        self.tp_group = None
        width = c.num_attention_heads * c.head_dim
        kv_width = c.num_key_value_heads * c.head_dim
        self.q_proj = Dense(c.hidden_size, width, bias=False, dtype=dtype)
        self.k_proj = Dense(c.hidden_size, kv_width, bias=False, dtype=dtype)
        self.v_proj = Dense(c.hidden_size, kv_width, bias=False, dtype=dtype)
        self.o_proj = Dense(width, c.hidden_size, bias=False, dtype=dtype)

    def _dropout_shard(self, dropout: Optional[Dropout], b0: int
                       ) -> Optional[Dropout]:
        """``dropout`` (p, seed, offset) at this block's place in the
        global batch of heads: rows from ``b0``, heads from ``head0`` of
        the config's; the three-element form where that is (0, 0, H)."""
        H = self.config.num_attention_heads
        if dropout is None or (b0 == 0 and self.heads == H):
            return dropout
        return tuple(dropout[:3]) + (b0, self.head0, H)

    def _reduce(self, out):
        if self.tp_group is None:
            return out
        from ivideogpt_tpu_torch.parallel.distributed import reduce_from_group
        return reduce_from_group(out, self.tp_group)

    def forward(self, x, cos, sin,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: Union[int, DevicePosition] = 0,
                dropout: Optional[Dropout] = None, batch_offset: int = 0):
        """Without a cache: causal attention over the whole sequence (the
        training forward), with ``dropout`` = (p, seed, offset) on its
        probabilities, drawn at global row ``batch_offset`` on. With one: S
        positions written at ``cache_index`` (a host int, or for S = 1 a
        :class:`DevicePosition`) and attended as the module docstring
        says."""
        c = self.config
        B, S, _ = x.shape
        H, Hkv, hd = self.heads, self.kv_heads, c.head_dim
        rep = H // Hkv
        if self.tp_group is not None:
            from ivideogpt_tpu_torch.parallel.distributed import copy_to_group
            x = copy_to_group(x, self.tp_group)
        q = apply_rope(self.q_proj(x).view(B, S, H, hd), cos, sin)
        k = apply_rope(self.k_proj(x).view(B, S, Hkv, hd), cos, sin)
        v = self.v_proj(x).view(B, S, Hkv, hd)
        if cache is None:
            return self._reduce(self.o_proj(causal_attention(
                q, _repeat_kv(k, rep), _repeat_kv(v, rep), self.dtype,
                self._dropout_shard(dropout, batch_offset))))
        if dropout is not None:
            raise ValueError("attention dropout acts in the training "
                             "forward only, never with a cache")

        if isinstance(cache_index, DevicePosition):
            slots, end = cache_index
        else:
            end = cache_index + S
            slots = slice(cache_index, end)
        for name, x in (("k", k), ("v", v)):
            if name + "s" in cache:     # int8 with its scales
                x, scales = quantize_int8(x)
                _write(cache[name + "s"], slots, scales)
            _write(cache[name], slots, x.to(cache[name].dtype))

        if S > 1 and cache_index == 0:
            out = causal_attention(q, _repeat_kv(k, rep), _repeat_kv(v, rep),
                                   self.dtype)
        elif S == 1 and "vs" in cache:
            out = decode_attention(q[:, 0].contiguous(), cache["k"],
                                   cache.get("ks"), cache["v"], cache["vs"],
                                   end).reshape(B, 1, H * hd)
        else:   # host ints (a position on the device is read back)
            out = self._cached_attention(q, cache, int(end) - S, int(end),
                                         rep)
        return self._reduce(self.o_proj(out))

    def _cached_attention(self, q, cache, cache_index: int, end: int,
                          rep: int):
        """S queries at cache_index .. end - 1 over the cache's slots
        [0, end), as written (int8 values upcast, their scales folded into
        the fp32 scores and the weights), query i seeing slots <=
        cache_index + i; K and V repeated across each head group."""
        B, S, H, hd = q.shape
        dt = self.dtype
        keys = _repeat_kv(cache["k"][:, :end].to(dt), rep)
        values = _repeat_kv(cache["v"][:, :end].to(dt), rep)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, keys).float() * hd ** -0.5
        if "ks" in cache:
            attn = attn * _repeat_kv(cache["ks"][:, :end], rep).float(
                ).transpose(1, 2)[:, :, None, :]
        if S > 1:
            k_pos = torch.arange(end, device=q.device)
            q_pos = cache_index + torch.arange(S, device=q.device)
            attn = attn.masked_fill(k_pos[None, :] > q_pos[:, None],
                                    torch.finfo(torch.float32).min)
        attn = torch.softmax(attn, dim=-1)
        if "vs" in cache:
            attn = attn * _repeat_kv(cache["vs"][:, :end], rep).float(
                ).transpose(1, 2)[:, :, None, :]
        out = torch.einsum("bhqk,bkhd->bqhd", attn.to(dt), values)
        return out.reshape(B, S, H * hd)


def _write(buf: torch.Tensor, slots, x: torch.Tensor):
    """buf [B, M, ...] at ``slots`` = x [B, S, ...]: a slice of host ints,
    or a position on the device as an int64 index along the slots."""
    if isinstance(slots, slice):
        buf[:, slots] = x
    else:
        buf.index_copy_(1, slots, x)


def _repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    """[B, S, Hkv, ...] -> [B, S, Hkv * rep, ...], each KV head repeated
    for its group of query heads (``jnp.repeat(x, rep, axis=2)``)."""
    return x if rep == 1 else x.repeat_interleave(rep, dim=2)


class LlamaMLP(nn.Module):
    def __init__(self, config: TransformerConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        # this rank's columns and tensor-parallel group (shard_params)
        self.intermediate_size = c.intermediate_size
        self.tp_group = None
        self.gate_proj = Dense(c.hidden_size, c.intermediate_size, bias=False,
                               dtype=dtype)
        self.up_proj = Dense(c.hidden_size, c.intermediate_size, bias=False,
                             dtype=dtype)
        self.down_proj = Dense(c.intermediate_size, c.hidden_size, bias=False,
                               dtype=dtype)

    def forward(self, x):
        if self.tp_group is None:
            return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        from ivideogpt_tpu_torch.parallel.distributed import (
            copy_to_group, reduce_from_group)
        x = copy_to_group(x, self.tp_group)
        return reduce_from_group(
            self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x)),
            self.tp_group)


class LlamaLayer(nn.Module):
    def __init__(self, config: TransformerConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps, dtype)
        self.self_attn = LlamaAttention(config, dtype)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps, dtype)
        self.mlp = LlamaMLP(config, dtype)

    def forward(self, x, cos, sin, cache=None,
                cache_index: Union[int, DevicePosition] = 0,
                dropout: Optional[Dropout] = None, batch_offset: int = 0):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, cache,
                               cache_index, dropout, batch_offset)
        return x + self.mlp(self.post_attention_layernorm(x))


class _LlamaModel(nn.Module):
    def __init__(self, config: TransformerConfig, dtype: torch.dtype):
        super().__init__()
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size)
        nn.init.normal_(self.embed_tokens.weight, std=config.initializer_range)
        self.layers = nn.ModuleList([LlamaLayer(config, dtype)
                                     for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, dtype)


class LlamaForCausalLM(nn.Module):
    """Parameter names are those of ``flax_to_torch_llama`` (HF Llama)."""

    def __init__(self, config: TransformerConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.model = _LlamaModel(config, dtype)
        if config.tie_word_embeddings:
            self.lm_head = None
        else:
            self.lm_head = Dense(config.hidden_size, config.vocab_size,
                                 bias=False, dtype=dtype)
            nn.init.normal_(self.lm_head.weight, std=config.initializer_range)

    def embed(self, input_ids):
        return F.embedding(input_ids,
                           self.model.embed_tokens.weight.to(self.dtype))

    def unembed(self, hidden):
        """hidden -> fp32 logits."""
        if self.lm_head is None:
            w = self.model.embed_tokens.weight.to(self.dtype)
            return F.linear(hidden.to(self.dtype), w).float()
        return self.lm_head(hidden).float()

    def forward(self, input_ids=None, inputs_embeds=None, labels=None,
                output_hidden_states: bool = False,
                dropout_key: Optional[DropoutKey] = None
                ) -> Dict[str, torch.Tensor]:
        """Full training/eval forward over positions 0..S-1, no cache.
        Returns dict(logits fp32[, loss][, hidden_states]); with
        ``config.remat`` each layer is recomputed in the backward, as its
        ``remat_policy`` says (the module docstring). In
        ``train()`` with ``config.attention_dropout > 0`` the step's
        ``dropout_key`` (seed, step[, b0]) is required: layer i drops with
        the Philox stream (seed, offset_of(step, i)), at global rows from
        b0 (0 where not given) on."""
        c = self.config
        remat = _remat_kwargs(c.remat_policy) if c.remat else None
        drop = self.training and c.attention_dropout > 0
        if drop and dropout_key is None:
            raise ValueError(
                f"attention_dropout {c.attention_dropout} in train(): pass "
                f"the step's dropout_key=(seed, step)")
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        B, S, _ = inputs_embeds.shape
        pos = torch.arange(S, device=inputs_embeds.device)
        cos, sin = rope_cos_sin(pos[None].expand(B, S), c.head_dim,
                                c.rope_theta, dtype=self.dtype)
        x = inputs_embeds
        b0 = dropout_key[2] if drop and len(dropout_key) > 2 else 0
        for i, layer in enumerate(self.model.layers):
            dropout = ((c.attention_dropout, dropout_key[0],
                        offset_of(dropout_key[1], i)) if drop else None)
            if remat and torch.is_grad_enabled():
                # the recompute draws the same mask: it is (seed, step, i)'s
                x = checkpoint(layer, x, cos, sin, None, 0, dropout, b0,
                               **remat)
            else:
                x = layer(x, cos, sin, dropout=dropout, batch_offset=b0)
        hidden = self.model.norm(x)
        out = {"logits": self.unembed(hidden)}
        if output_hidden_states:
            out["hidden_states"] = hidden
        if labels is not None:
            out["loss"] = cross_entropy_loss(out["logits"], labels)
        return out

    def init_cache(self, batch: int, max_len: int,
                   cache_dtype: Union[torch.dtype, str] = torch.bfloat16,
                   device=None) -> Cache:
        """Zeroed ``bshd`` cache over the KV heads (this rank's, under
        tensor parallelism); ``cache_dtype=torch.int8`` selects the
        quantised cache with bf16 scales, ``"mixed"`` a bf16 K and an int8
        V with its scales."""
        c = self.config
        if device is None:
            device = self.model.embed_tokens.weight.device
        kv_heads = self.model.layers[0].self_attn.kv_heads
        shape = (batch, max_len, kv_heads, c.head_dim)
        sshape = shape[:3]

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        if isinstance(cache_dtype, str):
            if cache_dtype != "mixed":
                raise ValueError(f"cache_dtype {cache_dtype!r}: a dtype or "
                                 f"'mixed'")
            return [{"k": zeros(shape, torch.bfloat16),
                     "v": zeros(shape, torch.int8),
                     "vs": zeros(sshape, torch.bfloat16)}
                    for _ in range(c.num_hidden_layers)]
        if cache_dtype == torch.int8:
            return [{"k": zeros(shape, torch.int8),
                     "v": zeros(shape, torch.int8),
                     "ks": zeros(sshape, torch.bfloat16),
                     "vs": zeros(sshape, torch.bfloat16)}
                    for _ in range(c.num_hidden_layers)]
        return [{"k": torch.zeros(shape, dtype=cache_dtype, device=device),
                 "v": torch.zeros(shape, dtype=cache_dtype, device=device)}
                for _ in range(c.num_hidden_layers)]

    def forward_cached(self, inputs_embeds, cache: Cache,
                       cache_index: Position):
        """Run S positions starting at ``cache_index`` against the cache,
        which is updated in place. Returns (hidden [B, S, D], cache). For
        S = 1, ``cache_index`` may be a one-element int32 tensor on the
        device (the module docstring)."""
        B, S, _ = inputs_embeds.shape
        pos = cache_index + torch.arange(S, device=inputs_embeds.device)
        if isinstance(cache_index, torch.Tensor):
            if S != 1:
                raise ValueError(f"a position on the device takes one "
                                 f"token, not {S}")
            cache_index = DevicePosition(pos, cache_index + 1)
        cos, sin = rope_cos_sin(pos[None].expand(B, S), self.config.head_dim,
                                self.config.rope_theta, dtype=self.dtype)
        x = inputs_embeds
        for layer, layer_cache in zip(self.model.layers, cache):
            x = layer(x, cos, sin, layer_cache, cache_index)
        return self.model.norm(x), cache


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Shifted next-token cross-entropy in fp32, ignoring IGNORE_INDEX:
    sum over valid targets / max(count, 1), so an all-ignored batch gives 0
    (``F.cross_entropy``'s mean would give NaN)."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:]
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1)
