"""Weight bridge: a JAX/Flax parameter tree -> the port's state dicts.

The port's own copy of the mapping of ``flax_to_torch_tokenizer``,
``flax_to_torch_llama`` and ``flax_to_torch_action_model`` in
``ivideogpt_tpu/utils/checkpoint.py``, and of the discriminator's, LPIPS's
and the DrQ-v2 encoder's and actor's trees (which the JAX package never
exports). Each takes the Flax
tree as nested dicts of numpy arrays (``{"params": {...}}``) and returns
torch tensors under the torch names, which the port's modules load with
``strict=True``:
- conv kernels HWIO -> OIHW, dense kernels transposed;
- GroupNorm ``scale`` -> ``weight``; ``name_0`` -> ``name.0``;
- cross-attention q/k/v packed into ``att.in_proj_weight``/``in_proj_bias``;
- the discriminator's spectral-norm ``batch_stats`` -> the buffers ``u`` and
  ``sigma`` of each conv.
The ``*_flax_path``/``*_flax_tree`` functions go the other way, so that the
port's gradients can be grouped and named as the JAX package's.
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


_CODEBOOKS = {"quantize.embedding.weight": "codebook",
              "dynamics_quantize.embedding.weight": "dyn_codebook"}


def tokenizer_flax_tree(named: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """The port's tokenizer tensors by name (parameters, or their
    gradients) -> the same values under the "/"-joined Flax paths (under
    ``params``) that :func:`tokenizer_state_dict` reads them from: the
    inverse of the bridge, as views (packed q/k/v split, kernels back to
    HWIO or transposed)."""
    out = {}
    for name, t in named.items():
        if name in _CODEBOOKS:
            out[_CODEBOOKS[name]] = t
            continue
        parts = name.replace(".to_out.0.", ".to_out.").split(".")
        mods: list = []
        for part in parts[:-1]:
            if part.isdigit():
                mods[-1] += f"_{part}"
            elif part != "att":   # the packed-attention holder
                mods.append(part)
        base, leaf = "/".join(mods), parts[-1]
        if leaf in ("in_proj_weight", "in_proj_bias"):
            for proj, chunk in zip(("q_proj", "k_proj", "v_proj"), t.chunk(3)):
                if leaf == "in_proj_weight":
                    out[f"{base}/{proj}/kernel"] = chunk.t()
                else:
                    out[f"{base}/{proj}/bias"] = chunk
        elif leaf == "weight" and t.ndim == 4:
            out[f"{base}/kernel"] = t.permute(2, 3, 1, 0)
        elif leaf == "weight" and t.ndim == 2:
            out[f"{base}/kernel"] = t.t()
        elif leaf == "weight":
            out[f"{base}/scale"] = t
        else:
            out[f"{base}/{leaf}"] = t
    return out


def _disc_module(flax_name: str) -> str:
    m = re.fullmatch(r"conv_(\d+)", flax_name)
    return f"convs.{m.group(1)}" if m else flax_name


def discriminator_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """Discriminator variables -> the port's state dict: the parameters,
    and, where ``variables`` holds them, the spectral-norm ``batch_stats``
    as each conv's ``u`` [1, O] and ``sigma`` buffers (Flax names them
    "<conv>/kernel/u" inside ``SpectralNorm_<i>``)."""
    sd = {}
    for path, v in _flatten(variables["params"]).items():
        mod, leaf = path.split("/")
        if leaf == "kernel":
            sd[f"{_disc_module(mod)}.weight"] = _conv_out(v)
        else:
            sd[f"{_disc_module(mod)}.{leaf}"] = v
    for group in variables.get("batch_stats", {}).values():
        for key, v in group.items():
            mod, _, leaf = key.split("/")
            sd[f"{_disc_module(mod)}.{leaf}"] = np.asarray(v)
    return _to_torch(sd)


def lpips_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """LPIPS parameters -> the port's state dict (``vgg.conv{s}_{i}``
    kernels to OIHW, the ``lin{s}`` heads as they are)."""
    sd = {}
    for path, v in _flatten(params["params"]).items():
        parts = path.split("/")
        if parts[0] == "vgg":
            _, conv, leaf = parts
            sd[f"vgg.{conv}.weight" if leaf == "kernel"
               else f"vgg.{conv}.{leaf}"] = (_conv_out(v) if leaf == "kernel"
                                             else v)
        else:
            sd[path] = v
    return _to_torch(sd)


_DRQV2_ACTOR = {"Dense_0": "trunk.0", "LayerNorm_0": "trunk.1",
                "Dense_1": "policy.0", "Dense_2": "policy.2",
                "Dense_3": "policy.4"}


def drqv2_state_dict(encoder_params: dict, actor_params: dict
                     ) -> Dict[str, torch.Tensor]:
    """DrQ-v2 ``Encoder`` and ``Actor`` parameters -> the state dict of
    ``mbrl.drqv2.DrQV2Policy``: ``Conv_i`` -> ``encoder.convnet.{2i}``
    (HWIO -> OIHW), the actor's ``Dense``/``LayerNorm`` layers ->
    ``actor.trunk``/``actor.policy`` (kernels transposed, ``scale`` ->
    ``weight``)."""
    sd = {}
    for path, v in _flatten(encoder_params["params"]).items():
        mod, leaf = path.split("/")
        name = f"encoder.convnet.{2 * int(mod[len('Conv_'):])}"
        sd[f"{name}.weight" if leaf == "kernel" else f"{name}.{leaf}"] = (
            _conv_out(v) if leaf == "kernel" else v)
    for path, v in _flatten(actor_params["params"]).items():
        mod, leaf = path.split("/")
        name = f"actor.{_DRQV2_ACTOR[mod]}"
        if leaf == "kernel":
            sd[f"{name}.weight"] = v.T
        elif leaf == "scale":
            sd[f"{name}.weight"] = v
        else:
            sd[f"{name}.{leaf}"] = v
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
