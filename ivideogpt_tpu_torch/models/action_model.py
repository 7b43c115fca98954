"""Action-conditioned LM head wrapper, the port of
``ivideogpt_tpu/models/action_model.py``.

Continuous actions go through a zero-initialised linear layer and are added
to the embedding at each per-frame sdf slot; an optional reward head reads
the hidden state. The methods are the building blocks
``generation.generate`` calls.
"""

from __future__ import annotations

import torch
from torch import nn

from ivideogpt_tpu_torch.configs import ActionModelConfig, TransformerConfig
from ivideogpt_tpu_torch.models.layers import Dense
from ivideogpt_tpu_torch.models.llama import Cache, LlamaForCausalLM


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
                   cache_dtype: torch.dtype = torch.bfloat16,
                   device=None) -> Cache:
        return self.llm.init_cache(batch, max_len, cache_dtype, device)

    def decode_cached(self, inputs_embeds, cache: Cache, cache_index: int):
        return self.llm.forward_cached(inputs_embeds, cache, cache_index)
