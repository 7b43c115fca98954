"""Random weights from a seed, made on the device in one draw a dtype, and
the port's models built around them.

The values depend on the seed, the parameter list of
``reference/params.py`` and the dtypes alone, so the reference, run after
the program has been freed, draws them again and gets the same tensors.
Each dtype's parameters are views into one buffer: a call of
``torch.randn`` fills it, then each view is scaled in place.
"""

from __future__ import annotations

import json
from typing import Callable, Dict

import torch

from benchmark.reference.params import Spec, lm_spec, std_of, tokenizer_spec

DtypeRule = Callable[[str, tuple], torch.dtype]


def serving_tokenizer_dtype(name: str, shape) -> torch.dtype:
    """The port's cast rule for a bf16 tokenizer: conv kernels in bf16,
    everything else (vectors, dense matrices, the codebooks) fp32."""
    return torch.bfloat16 if len(shape) >= 3 else torch.float32


def serving_lm_dtype(name: str, shape) -> torch.dtype:
    """The port's cast rule for a bf16 LM: matrices and embeddings in bf16,
    vectors fp32."""
    return torch.bfloat16 if len(shape) >= 2 else torch.float32


def fp32(name: str, shape) -> torch.dtype:
    return torch.float32


def draw(spec: Spec, dtype_of: DtypeRule, seed: int, device
         ) -> Dict[str, torch.Tensor]:
    """name -> tensor, every value from ``seed``."""
    groups: Dict[torch.dtype, list] = {}
    for name, (shape, init, scale) in spec.items():
        groups.setdefault(dtype_of(name, shape), []).append(
            (name, shape, init, scale))
    gen = torch.Generator(device=device)
    out = {}
    for k, dtype in enumerate(sorted(groups, key=str)):
        items = groups[dtype]
        total = sum(_numel(s) for _, s, _, _ in items)
        gen.manual_seed((seed * 1_000_003 + k) % 2 ** 63)
        buf = torch.randn(total, dtype=dtype, device=device, generator=gen)
        off = 0
        for name, shape, init, scale in items:
            n = _numel(shape)
            view = buf[off:off + n].view(shape)
            mean, std = std_of(shape, init, scale)
            view.mul_(std).add_(mean)
            out[name] = view
            off += n
    return {n: out[n] for n in spec}


def _numel(shape) -> int:
    n = 1
    for x in shape:
        n *= x
    return n


def tokenizer_weights(cfg: dict, seed: int, device, serving: bool):
    rule = serving_tokenizer_dtype if serving else fp32
    return draw(tokenizer_spec(cfg["tokenizer"]), rule, seed * 2, device)


def lm_weights(cfg: dict, seed: int, device, serving: bool):
    rule = serving_lm_dtype if serving else fp32
    return draw(lm_spec(cfg["transformer"], cfg["action_dim"]),
                rule, seed * 2 + 1, device)


def as_fp32(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.float() for n, t in weights.items()}


# -- the port's models around them -----------------------------------------

def port_tokenizer(cfg: dict, weights, dtype: torch.dtype):
    """The port's ``CompressiveVQModel`` holding ``weights``."""
    from ivideogpt_tpu_torch.configs import CompressiveVQConfig
    from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
    tc = CompressiveVQConfig.from_json(json.dumps(cfg["tokenizer"]))
    with torch.device("meta"):
        model = CompressiveVQModel(tc, dtype)
    model.load_state_dict(weights, strict=True, assign=True)
    return model


def port_lm(cfg: dict, weights, dtype: torch.dtype, attention_dropout=0.0):
    """The port's ``HeadModelWithAction`` holding ``weights``, computing in
    ``dtype``."""
    from ivideogpt_tpu_torch.configs import (ActionModelConfig,
                                             TransformerConfig)
    from ivideogpt_tpu_torch.models.action_model import HeadModelWithAction
    from benchmark.reference.params import tok_dims
    mc = TransformerConfig.from_json(json.dumps(cfg["transformer"])).replace(
        attention_dropout=attention_dropout)
    dims = tok_dims(cfg["tokenizer"])
    head = ActionModelConfig(
        action_dim=cfg["action_dim"],
        context_length=cfg["context_length"],
        segment_length=cfg["segment_length"],
        tokens_per_context=dims["ctx_tokens"],
        tokens_per_dyna=dims["dyn_tokens"])
    with torch.device("meta"):
        model = HeadModelWithAction(mc, head, dtype)
    model.load_state_dict(weights, strict=True, assign=True)
    return model
