"""Weight bridge: a JAX/Flax parameter tree -> the port's state dicts.

The port's own copy of the mapping of ``flax_to_torch_tokenizer``,
``flax_to_torch_llama`` and ``flax_to_torch_action_model`` in
``ivideogpt_tpu/utils/checkpoint.py``. Each takes the Flax tree as nested
dicts of numpy arrays (``{"params": {...}}``) and returns torch tensors under
the torch names, which the port's modules load with ``strict=True``:
- conv kernels HWIO -> OIHW, dense kernels transposed;
- GroupNorm ``scale`` -> ``weight``; ``name_0`` -> ``name.0``;
- cross-attention q/k/v packed into ``att.in_proj_weight``/``in_proj_bias``.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def _conv_out(w):  # flax HWIO -> torch OIHW
    return np.transpose(w, (3, 2, 0, 1))


def _to_torch(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(v) for k, v in sd.items()}


def tokenizer_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """CompressiveVQModel parameters -> the port's tokenizer state dict."""
    sd = {}
    packed: Dict[str, dict] = {}
    for path, v in _flatten(params["params"]).items():
        parts = path.split("/")
        leaf, mods = parts[-1], parts[:-1]
        if path == "codebook":
            sd["quantize.embedding.weight"] = v
            continue
        if path == "dyn_codebook":
            sd["dynamics_quantize.embedding.weight"] = v
            continue
        if (mods and mods[-1] in ("q_proj", "k_proj", "v_proj", "out_proj")
                and "cross_att_blocks" in path):
            packed.setdefault("/".join(mods[:-1]), {})[f"{mods[-1]}.{leaf}"] = v
            continue
        name = ".".join(mods + [leaf])
        name = re.sub(r"_(\d+)(\.|$)", r".\1\2", name)
        name = name.replace(".to_out.", ".to_out.0.")
        if leaf == "kernel":
            base = name[: -len(".kernel")]
            sd[base + ".weight"] = _conv_out(v) if v.ndim == 4 else v.T
        elif leaf == "scale":
            sd[name[: -len(".scale")] + ".weight"] = v
        else:
            sd[name] = v

    for block, t in packed.items():
        name = re.sub(r"_(\d+)(/|$)", r".\1\2", block).replace("/", ".")
        sd[f"{name}.att.in_proj_weight"] = np.concatenate(
            [t["q_proj.kernel"].T, t["k_proj.kernel"].T, t["v_proj.kernel"].T],
            axis=0)
        sd[f"{name}.att.in_proj_bias"] = np.concatenate(
            [t["q_proj.bias"], t["k_proj.bias"], t["v_proj.bias"]], axis=0)
        sd[f"{name}.att.out_proj.weight"] = t["out_proj.kernel"].T
        sd[f"{name}.att.out_proj.bias"] = t["out_proj.bias"]
    return _to_torch(sd)


def _llama_numpy(params: dict) -> Dict[str, np.ndarray]:
    sd = {}
    for path, v in _flatten(params["params"]).items():
        if path == "embed_tokens/embedding":
            sd["model.embed_tokens.weight"] = v
        elif path == "norm/weight":
            sd["model.norm.weight"] = v
        elif path == "lm_head/kernel":
            sd["lm_head.weight"] = v.T
        else:
            m = re.match(r"layers_(\d+)/(.*)/(kernel|weight)$", path)
            if not m:
                raise ValueError(f"unmapped flax key {path}")
            i, rest, leaf = m.groups()
            sd[f"model.layers.{i}.{rest.replace('/', '.')}.weight"] = (
                v.T if leaf == "kernel" else v)
    return sd


def llama_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """LlamaForCausalLM parameters -> the port's (HF-named) state dict."""
    return _to_torch(_llama_numpy(params))


def action_model_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """HeadModelWithAction parameters -> the port's state dict."""
    tree = params["params"]
    sd = {f"llm.{k}": v
          for k, v in _llama_numpy({"params": tree["llm"]}).items()}
    for head in ("action_linear", "reward_linear", "action_recon_linear"):
        if head in tree:
            sd[f"{head}.weight"] = np.asarray(tree[head]["kernel"]).T
            sd[f"{head}.bias"] = np.asarray(tree[head]["bias"])
    return _to_torch(sd)


def action_model_flax_path(name: str) -> str:
    """The port's action-model parameter name -> the "/"-joined Flax path
    (under ``params``) that :func:`action_model_state_dict` loads it from."""
    if not name.startswith("llm."):
        head, leaf = name.rsplit(".", 1)
        return f"{head}/{'kernel' if leaf == 'weight' else leaf}"
    rest = name[len("llm."):]
    fixed = {"model.embed_tokens.weight": "embed_tokens/embedding",
             "model.norm.weight": "norm/weight",
             "lm_head.weight": "lm_head/kernel"}
    if rest in fixed:
        return f"llm/{fixed[rest]}"
    m = re.match(r"model\.layers\.(\d+)\.(.*)\.weight$", rest)
    if not m:
        raise ValueError(f"unmapped port name {name}")
    i, mod = m.groups()
    leaf = "weight" if mod.endswith("layernorm") else "kernel"
    return f"llm/layers_{i}/{mod.replace('.', '/')}/{leaf}"
