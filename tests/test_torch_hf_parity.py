"""The port's LLaMA against Hugging Face ``transformers.LlamaForCausalLM``
(eager attention, fp32, CPU), multi-head and with grouped KV heads:
``save_pretrained`` files read by the port's hub loaders
(``llama_config_from_hub``, ``load_llama_safetensors``) give HF's logits
in the training forward and, token by token, through the fp32 KV cache
(prefill, a multi-token step at a nonzero index, then one-token decodes);
the port's ``llama_hub_config`` is a ``LlamaConfig`` that HF reads back,
``num_key_value_heads`` included, and the port's weights load into it.
fp32 in another summation order: 2e-5 (the JAX package's own HF test
holds its logits to 2e-4).
"""

import json
import os

import numpy as np
import pytest
import torch

from ivideogpt_tpu_torch.models.llama import LlamaForCausalLM
from ivideogpt_tpu_torch.utils import checkpoint as ckpt

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)


def _hf(kv, tmp_path):
    cfg = transformers.LlamaConfig(
        vocab_size=130, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=kv,
        max_position_embeddings=256, rms_norm_eps=1e-6,
        attention_dropout=0.0, tie_word_embeddings=False,
        attn_implementation="eager")
    torch.manual_seed(kv)
    hf = transformers.LlamaForCausalLM(cfg).eval()
    path = str(tmp_path / f"hf-{kv}")
    hf.save_pretrained(path, safe_serialization=True)
    return hf, path


def _port(path):
    with open(os.path.join(path, "config.json")) as f:
        cfg = ckpt.llama_config_from_hub(json.load(f))
    port = LlamaForCausalLM(cfg)
    port.load_state_dict(ckpt.load_llama_safetensors(
        os.path.join(path, "model.safetensors")), strict=True)
    return port.eval()


@pytest.mark.parametrize("kv", [4, 2, 1])
def test_logits_match_hf_through_the_hub_loaders(kv, tmp_path):
    hf, path = _hf(kv, tmp_path)
    port = _port(path)
    assert port.config.num_key_value_heads == kv
    ids = torch.from_numpy(np.random.default_rng(kv).integers(0, 130,
                                                              (3, 21)))
    with torch.no_grad():
        ref = hf(ids).logits
        ours = port(ids)["logits"]
    torch.testing.assert_close(ours, ref, rtol=2e-5, atol=2e-5)

    # the cached path: prefill 9, 4 tokens at 9, then one at a time
    cache = port.init_cache(3, 21, torch.float32, device="cpu")
    steps = [(0, 9), (9, 13)] + [(i, i + 1) for i in range(13, 21)]
    with torch.no_grad():
        for lo, hi in steps:
            hidden, cache = port.forward_cached(port.embed(ids[:, lo:hi]),
                                                cache, lo)
            torch.testing.assert_close(port.unembed(hidden), ref[:, lo:hi],
                                       rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kv", [4, 2])
def test_the_ports_hub_config_is_read_back_by_hf(kv, tmp_path):
    _, path = _hf(kv, tmp_path)
    port = _port(path)
    d = ckpt.llama_hub_config(port.config)
    assert d["num_key_value_heads"] == kv
    cfg = transformers.LlamaConfig(**d)
    assert (cfg.num_key_value_heads, cfg.num_attention_heads,
            cfg.head_dim) == (kv, 4, 16)
    hf = transformers.LlamaForCausalLM(cfg).eval()
    missing, unexpected = hf.load_state_dict(port.state_dict(), strict=False)
    assert not unexpected and all("rotary" in k for k in missing), missing
    ids = torch.arange(17)[None] % 130
    with torch.no_grad():
        torch.testing.assert_close(port(ids)["logits"], hf(ids).logits,
                                   rtol=2e-5, atol=2e-5)
