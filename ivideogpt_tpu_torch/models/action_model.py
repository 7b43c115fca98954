"""Action-conditioned LM head wrapper, the port of
``ivideogpt_tpu/models/action_model.py``.

Continuous actions go through a zero-initialised linear layer and are added
to the embedding at each per-frame sdf slot; an optional reward head reads
the hidden state. ``forward`` is the training forward; the other methods
are the building blocks ``generation.generate`` calls.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from ivideogpt_tpu_torch.configs import ActionModelConfig, TransformerConfig
from ivideogpt_tpu_torch.models.layers import Dense
from ivideogpt_tpu_torch.models.llama import (Cache, DropoutKey,
                                              LlamaForCausalLM, Position)
from ivideogpt_tpu_torch.tokens import sdf_positions


class HeadModelWithAction(nn.Module):
    def __init__(self, llm_config: TransformerConfig,
                 head_config: ActionModelConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.llm_config = llm_config
        self.head_config = head_config
        self.dtype = dtype
        h = head_config
        self.llm = LlamaForCausalLM(llm_config, dtype)
        # zero-init: action conditioning starts as a no-op
        self.action_linear = Dense(h.action_dim, llm_config.hidden_size,
                                   dtype=dtype)
        nn.init.zeros_(self.action_linear.weight)
        nn.init.zeros_(self.action_linear.bias)
        if h.reward_prediction:
            self.reward_linear = Dense(llm_config.hidden_size, 1, dtype=dtype)
        if h.action_recon is not None:
            self.action_recon_linear = Dense(llm_config.hidden_size,
                                             h.action_dim, dtype=dtype)

    def embed_tokens(self, input_ids):
        return self.llm.embed(input_ids)

    def action_embeds(self, action):
        return self.action_linear(action)

    def reward(self, hidden):
        return self.reward_linear(hidden)[..., 0]

    def unembed(self, hidden):
        return self.llm.unembed(hidden)

    def init_cache(self, batch: int, max_len: int,
                   cache_dtype: Union[torch.dtype, str] = torch.bfloat16,
                   device=None) -> Cache:
        return self.llm.init_cache(batch, max_len, cache_dtype, device)

    def decode_cached(self, inputs_embeds, cache: Cache,
                      cache_index: Position):
        return self.llm.forward_cached(inputs_embeds, cache, cache_index)

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                action: Optional[torch.Tensor] = None,
                dropout_key: Optional[DropoutKey] = None
                ) -> Dict[str, torch.Tensor]:
        """Training forward: input_ids [B, L], action [B, T, A] (the whole
        segment's actions); ``dropout_key`` (seed, step) keys the attention
        dropout in ``train()`` (``LlamaForCausalLM.forward``). Returns
        dict(logits[, loss][, action_recon_loss][, reward_pred])."""
        h = self.head_config
        embeds = self.llm.embed(input_ids)
        positions = sdf_positions(h.context_length, h.segment_length,
                                  h.tokens_per_context, h.tokens_per_dyna,
                                  device=input_ids.device)
        if action is not None:
            # action[ctx-1 .. T-2] go to the sdf slot before each frame
            a = self.action_linear(action)[:, h.context_length - 1:-1]
            embeds = embeds.index_add(1, positions, a.to(embeds.dtype))
        need_hidden = h.reward_prediction or h.action_recon is not None
        out = self.llm(inputs_embeds=embeds, labels=labels,
                       output_hidden_states=need_hidden,
                       dropout_key=dropout_key)
        result = {"logits": out["logits"]}
        if labels is not None:
            result["loss"] = out["loss"]
        if h.action_recon is not None and action is not None:
            F = h.segment_length - h.context_length
            rec = self.action_recon_linear(
                out["hidden_states"][:, h.prelude_tokens_num:])
            rec = rec.reshape(-1, F, h.tokens_per_dyna + 1, h.action_dim)
            target = action[:, h.context_length - 1:-1, None, :]
            recon_loss = ((rec - target) ** 2).mean()
            result["action_recon_loss"] = recon_loss
            if "loss" in result:
                result["loss"] = result["loss"] + h.action_recon * recon_loss
        if h.reward_prediction:
            # the hidden state at the last dyn token of each frame
            reward_h = out["hidden_states"][:, positions + h.tokens_per_dyna]
            result["reward_pred"] = self.reward_linear(reward_h)[..., 0]
        return result
