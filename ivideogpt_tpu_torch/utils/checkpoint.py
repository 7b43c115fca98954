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

The second half reads and writes the published HF hub layout
(``{model}/tokenizer``, ``{model}/transformer``; ``tools/make_fake_hub.py``)
through the hand-written ``utils/safetensors.py``: the hub files already
hold the port's names, so a loader returns a state dict that the port's
modules take with ``strict=True``, after folding peft adapters, stripping
``llm.`` where asked and refusing any name that does not map. Config
readers turn the hub's ``config.json`` files into the port's dataclasses,
and ``load_tokenizer_for_context`` re-slices a tokenizer to a shorter
context.

The last part keeps a training run's state on disk, the counterparts of
the JAX package's ``save_train_state``, ``latest_checkpoint`` and
``restore_train_state`` (``ivideogpt_tpu/utils/checkpoint.py:33-75``) in a
format of the port's own, not Orbax's: ``{dir}/checkpoint-{step}/`` holds
``train_state.safetensors`` (the model's state dict under ``model/``,
AdamW's moments and step counts under ``optimizer/{index}/``, the
accumulation buffer under ``acc/``) and ``train_state.json`` (the counters,
AdamW's parameter groups and the schedule's settings). A train state of
several parts (``save_train_states``: the tokenizer trainer's generator,
discriminator, EMA copy and loop counters, the JAX CLI's
``full_state_tree``) keeps each part under its name in the same two files.
The exchange format with the JAX package stays the hub's
``model.safetensors`` and ``config.json``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ivideogpt_tpu_torch.configs import (ActionModelConfig,
                                         CompressiveVQConfig,
                                         TransformerConfig)
from ivideogpt_tpu_torch.utils import safetensors


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


_I3D_LEAVES = {"conv3d/kernel": "conv3d.weight", "conv3d/bias": "conv3d.bias",
               "bn_scale": "bn.weight", "bn_bias": "bn.bias",
               "bn_mean": "bn.running_mean", "bn_var": "bn.running_var"}


def i3d_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX I3D's parameters -> the port's (piergiaj) names: conv
    kernels DHWIO -> OIDHW, ``bn_scale`` / ``bn_bias`` / ``bn_mean`` /
    ``bn_var`` -> ``bn.weight`` / ``bias`` / ``running_mean`` /
    ``running_var``; ``Mixed_3b/b1b`` -> ``Mixed_3b.b1b``."""
    sd = {}
    for path, v in _flatten(params["params"]).items():
        parts = path.split("/")
        n = 2 if parts[-2] == "conv3d" else 1
        leaf = _I3D_LEAVES["/".join(parts[-n:])]
        sd[".".join(parts[:-n] + [leaf])] = (
            np.transpose(v, (4, 3, 0, 1, 2)) if leaf == "conv3d.weight"
            else v)
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


def drqv2_critic_state_dict(critic_params: dict) -> Dict[str, torch.Tensor]:
    """A DrQ-v2 ``Critic``'s parameters -> the state dict of
    ``mbrl.drqv2.Critic``: ``Dense_0`` / ``LayerNorm_0`` -> ``trunk.0`` /
    ``trunk.1``, the heads ``Q1_1`` ... ``Q2_out`` by their own names
    (kernels transposed, ``scale`` -> ``weight``)."""
    sd = {}
    for path, v in _flatten(critic_params["params"]).items():
        mod, leaf = path.split("/")
        name = {"Dense_0": "trunk.0", "LayerNorm_0": "trunk.1"}.get(mod, mod)
        if leaf == "kernel":
            sd[f"{name}.weight"] = v.T
        elif leaf == "scale":
            sd[f"{name}.weight"] = v
        else:
            sd[f"{name}.{leaf}"] = v
    return _to_torch(sd)


def drqv2_agent_state_dict(encoder_params: dict, actor_params: dict,
                           critic_params: dict, critic_target_params: dict
                           ) -> Dict[str, torch.Tensor]:
    """The weights of a JAX ``AgentState`` (its encoder, actor, critic and
    critic-target params) -> the state dict of ``mbrl.drqv2.DrQV2Agent``:
    :func:`drqv2_state_dict` under ``policy.``, the critic and its target
    by :func:`drqv2_critic_state_dict` under ``critic.`` and
    ``critic_target.``."""
    sd = {f"policy.{k}": v for k, v in
          drqv2_state_dict(encoder_params, actor_params).items()}
    for prefix, params in (("critic", critic_params),
                           ("critic_target", critic_target_params)):
        sd.update({f"{prefix}.{k}": v for k, v in
                   drqv2_critic_state_dict(params).items()})
    return sd


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


# ---------------------------------------------------------------------------
# The published hub layout
# ---------------------------------------------------------------------------

TOKENIZER_FILE = "diffusion_pytorch_model.safetensors"
TRANSFORMER_FILE = "model.safetensors"
# LoRA adapters beside a transformer's weights (``train/lora.py``): the
# transformer loaders below read the weights without it
LORA_FILE = "lora.safetensors"
HEADS = ("action_linear", "reward_linear", "action_recon_linear")
StateDict = Dict[str, torch.Tensor]


def is_peft_state_dict(sd: StateDict) -> bool:
    return any(".lora_A." in k or ".lora_embedding_A." in k for k in sd)


def merge_peft_state_dict(sd: StateDict, alpha: Optional[float] = None,
                          rank: Optional[int] = None) -> StateDict:
    """Fold a peft-wrapped state dict into a plain one (the port of
    ``merge_peft_state_dict``, ``ivideogpt_tpu/utils/checkpoint.py:271``).

    An adapted Linear is ``X.base_layer.weight`` + ``X.lora_A.default.weight``
    [r, in] + ``X.lora_B.default.weight`` [out, r], folded as
    W += (alpha/r) B @ A; an adapted embedding is ``X.base_layer.weight`` +
    ``X.lora_embedding_A.default`` [r, n] + ``X.lora_embedding_B.default``
    [d, r], folded as W += (alpha/r) (B @ A)^T. ``base_model.model.`` and
    ``.base_layer.`` leave the names; every tensor comes back fp32. A plain
    state dict comes back as it is.

    The file does not record alpha and rank, so a peft-wrapped state dict
    needs both: without them this raises, where the JAX function folds at
    scale 1.0 (ROADMAP Queue 3)."""
    if not is_peft_state_dict(sd):
        return sd
    if alpha is None and rank is None:
        raise ValueError(
            "the state dict holds LoRA adapters; pass the alpha and rank "
            "they were trained with (the file does not record them)")
    if alpha is None or rank is None:
        raise ValueError("pass both alpha and rank")
    rank_seen = next(v.shape[0] for k, v in sd.items()
                     if ".lora_A.default.weight" in k
                     or ".lora_embedding_A.default" in k)
    if rank != rank_seen:
        raise ValueError(f"rank={rank} but the adapters in the file have "
                         f"rank {rank_seen}")
    scale = alpha / rank
    out = {}
    for k, v in sd.items():
        if ".lora_" in k:
            continue
        v = v.float()
        if ".base_layer.weight" in k:
            a = sd.get(k.replace(".base_layer.weight",
                                 ".lora_A.default.weight"))
            ea = sd.get(k.replace(".base_layer.weight",
                                  ".lora_embedding_A.default"))
            if a is not None:
                b = sd[k.replace(".base_layer.weight",
                                 ".lora_B.default.weight")]
                v = v + scale * (b.float() @ a.float())
            elif ea is not None:
                eb = sd[k.replace(".base_layer.weight",
                                  ".lora_embedding_B.default")]
                v = v + scale * (eb.float() @ ea.float()).t()
        out[k.replace("base_model.model.", "").replace(".base_layer.",
                                                       ".")] = v
    return out


def llama_names(sd: StateDict) -> StateDict:
    """A LlamaForCausalLM state dict, with or without the ``model.``
    prefix, under the port's (HF) names; ``rotary_emb`` buffers of older
    exports are dropped and any other name that does not map raises."""
    out = {}
    for key, v in sd.items():
        k = key[len("model."):] if key.startswith("model.") else key
        if "rotary_emb" in k:
            continue
        if k == "lm_head.weight":
            out[k] = v
        elif (k in ("embed_tokens.weight", "norm.weight")
              or re.match(r"layers\.\d+\..*\.weight$", k)):
            out["model." + k] = v
        else:
            raise ValueError(f"unmapped llama key {key}")
    return out


def action_model_names(sd: StateDict, lora_alpha: Optional[float] = None,
                       lora_rank: Optional[int] = None) -> StateDict:
    """A HeadModelWithAction state dict (``llm.*`` and the head linears),
    plain or peft-wrapped, under the port's names; a name that is neither
    raises."""
    sd = merge_peft_state_dict(sd, lora_alpha, lora_rank)
    heads = {f"{h}.{leaf}" for h in HEADS for leaf in ("weight", "bias")}
    unknown = sorted(k for k in sd
                     if not k.startswith("llm.") and k not in heads)
    if unknown:
        raise ValueError(f"unmapped action-model keys {unknown[:5]}")
    llm = llama_names({k[len("llm."):]: v for k, v in sd.items()
                       if k.startswith("llm.")})
    out = {f"llm.{k}": v for k, v in llm.items()}
    out.update({k: v for k, v in sd.items() if k in heads})
    return out


def load_tokenizer_safetensors(path: str) -> StateDict:
    """The tokenizer's state dict from a hub file or directory: the file's
    names are the port's."""
    return safetensors.load(path)


def load_llama_safetensors(path: str, alpha: Optional[float] = None,
                           rank: Optional[int] = None) -> StateDict:
    """A bare LlamaForCausalLM file (peft-wrapped: pass alpha and rank)."""
    return llama_names(merge_peft_state_dict(
        safetensors.load(path, skip=(LORA_FILE,)), alpha, rank))


def load_llm_only_safetensors(path: str, alpha: Optional[float] = None,
                              rank: Optional[int] = None) -> StateDict:
    """Only the LLaMA of a transformer file: a bare-LLaMA file as it is, or
    the ``llm.`` subtree of a HeadModelWithAction export (its heads
    dropped)."""
    sd = merge_peft_state_dict(safetensors.load(path, skip=(LORA_FILE,)),
                               alpha, rank)
    if any(k.startswith("llm.") for k in sd):
        sd = {k[len("llm."):]: v for k, v in sd.items()
              if k.startswith("llm.")}
    return llama_names(sd)


def load_action_model_safetensors(path: str,
                                  lora_alpha: Optional[float] = None,
                                  lora_rank: Optional[int] = None
                                  ) -> StateDict:
    """A HeadModelWithAction's state dict from a transformer file or
    directory (a directory's ``lora.safetensors`` is not read)."""
    return action_model_names(safetensors.load(path, skip=(LORA_FILE,)),
                              lora_alpha, lora_rank)


def tokenizer_config_from_hub(d: dict) -> CompressiveVQConfig:
    """A diffusers tokenizer ``config.json`` (as a dict) -> the port's
    config: the keys that ``vp/interface.py:45-58`` reads, with its
    defaults, plus the channel counts and ``vq_embed_dim``."""
    return CompressiveVQConfig(
        in_channels=d.get("in_channels", 3),
        out_channels=d.get("out_channels", 3),
        block_out_channels=tuple(d["block_out_channels"]),
        layers_per_block=d.get("layers_per_block", 2),
        latent_channels=d["latent_channels"],
        num_vq_embeddings=d["num_vq_embeddings"],
        num_dyn_embeddings=d.get("num_dyn_embeddings",
                                 d["num_vq_embeddings"]),
        norm_num_groups=d.get("norm_num_groups", 32),
        vq_embed_dim=d.get("vq_embed_dim"),
        mid_block_add_attention=d.get("mid_block_add_attention", True),
        context_length=d.get("context_length", 1),
        resolution=d.get("resolution", 64),
        max_att_resolution=d.get("max_att_resolution", 16),
        patch_size=d.get("patch_size", 4),
        cross_attn_heads=d.get("cross_attn_heads", 4))


def llama_config_from_hub(d: dict, vocab_size: Optional[int] = None
                          ) -> TransformerConfig:
    """An HF ``LlamaConfig`` json (as a dict) -> the port's config: the keys
    that ``vp/interface.py:62-73`` reads, with its defaults, plus
    ``rope_theta`` and ``tie_word_embeddings``. ``vocab_size`` (the
    tokenizer's) is used where the json has none and must equal it where
    it has one. Raises on a setting the port's LLaMA does not compute."""
    heads = d["num_attention_heads"]
    odd = {k: d.get(k) for k, want in (
        ("rope_scaling", None), ("hidden_act", "silu"),
        ("attention_bias", False), ("mlp_bias", False),
        ("head_dim", d["hidden_size"] // heads)) if d.get(k, want) != want}
    if odd:
        raise ValueError(f"the port's LLaMA does not compute {odd}")
    vocab = d.get("vocab_size", vocab_size)
    if vocab_size is not None and vocab != vocab_size:
        raise ValueError(f"transformer vocab {vocab} != the tokenizer's "
                         f"{vocab_size}")
    return TransformerConfig(
        vocab_size=vocab, hidden_size=d["hidden_size"],
        intermediate_size=d["intermediate_size"],
        num_hidden_layers=d["num_hidden_layers"],
        num_attention_heads=heads,
        num_key_value_heads=d.get("num_key_value_heads", heads),
        max_position_embeddings=d.get("max_position_embeddings", 1024),
        rms_norm_eps=d.get("rms_norm_eps", 1e-6),
        rope_theta=d.get("rope_theta", 10000.0),
        tie_word_embeddings=d.get("tie_word_embeddings", False))


def action_head_config(sd: StateDict, tok_cfg: CompressiveVQConfig, *,
                       action_dim: int, context_length: int,
                       segment_length: int) -> ActionModelConfig:
    """The action head's config for a HeadModelWithAction state dict: the
    tokenizer's frame geometry, with the reward and action-reconstruction
    heads where the state dict holds them."""
    return ActionModelConfig(
        action_dim=action_dim, context_length=context_length,
        segment_length=segment_length,
        tokens_per_context=tok_cfg.ctx_tokens_per_frame,
        tokens_per_dyna=tok_cfg.dyn_tokens_per_frame,
        reward_prediction="reward_linear.weight" in sd,
        action_recon=0.0 if "action_recon_linear.weight" in sd else None)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def set_context_length(sd: StateDict, old_context: int, new_context: int
                       ) -> StateDict:
    """Keep the last ``new_context * R^2`` rows of every ``kv_pos_emb``
    (``set_context_length``, ``ivideogpt_tpu/utils/checkpoint.py:430``):
    the reference slices these embeddings, never grows them."""
    if new_context == old_context:
        return sd
    if new_context > old_context:
        raise ValueError(f"context {new_context} > {old_context}: kv "
                         f"positional embeddings can be sliced, not grown")
    return {k: (v[-new_context * (v.shape[0] // old_context):].contiguous()
                if k.endswith("kv_pos_emb") else v) for k, v in sd.items()}


def load_tokenizer_for_context(tok_dir: str, target_context: int
                               ) -> Tuple[StateDict, Optional[
                                   CompressiveVQConfig]]:
    """A tokenizer dir re-sliced to ``target_context``: (state dict, config
    with ``context_length == target_context``), or (state dict, None) where
    the dir has no ``config.json``. Raises when the checkpoint's context is
    smaller than the target."""
    sd = load_tokenizer_safetensors(tok_dir)
    cfg_path = os.path.join(tok_dir, "config.json")
    if not os.path.exists(cfg_path):
        return sd, None
    cfg = tokenizer_config_from_hub(read_json(cfg_path))
    if target_context == cfg.context_length:
        return sd, cfg
    if target_context > cfg.context_length:
        raise ValueError(
            f"checkpoint tokenizer context {cfg.context_length} < requested "
            f"{target_context}: kv positional embeddings can be sliced, not "
            f"grown; finetune at context <= {cfg.context_length}")
    print(f"[warn] pretrained tokenizer context {cfg.context_length} != "
          f"requested {target_context}; re-slicing kv pos-embs")
    return (set_context_length(sd, cfg.context_length, target_context),
            cfg.replace(context_length=target_context))


def tokenizer_hub_config(cfg: CompressiveVQConfig) -> dict:
    """The diffusers ``config.json`` of a tokenizer: the schema of
    ``tools/make_fake_hub.py``'s ``diffusers_tokenizer_config``, plus
    ``cross_attn_heads``."""
    n = len(cfg.block_out_channels)
    return {
        "_class_name": "CompressiveVQModel", "_diffusers_version": "0.30.1",
        "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
        "down_block_types": ["DownEncoderBlock2D"] * n,
        "up_block_types": ["UpDecoderBlock2D"] * n,
        "block_out_channels": list(cfg.block_out_channels),
        "layers_per_block": cfg.layers_per_block, "act_fn": cfg.act_fn,
        "latent_channels": cfg.latent_channels, "sample_size": 32,
        "num_vq_embeddings": cfg.num_vq_embeddings,
        "norm_num_groups": cfg.norm_num_groups,
        "vq_embed_dim": cfg.vq_embed_dim, "scaling_factor": 0.18215,
        "norm_type": "group",
        "mid_block_add_attention": cfg.mid_block_add_attention,
        "lookup_from_codebook": False, "force_upcast": False,
        "num_dyn_embeddings": cfg.num_dyn_embeddings,
        "context_length": cfg.context_length,
        "max_att_resolution": cfg.max_att_resolution,
        "resolution": cfg.resolution, "patch_size": cfg.patch_size,
        "cross_attn_heads": cfg.cross_attn_heads}


def llama_hub_config(cfg: TransformerConfig) -> dict:
    """The HF ``LlamaConfig`` json of a LLaMA config."""
    return {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "head_dim": cfg.head_dim, "hidden_act": "silu",
        "max_position_embeddings": cfg.max_position_embeddings,
        "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
        "rope_scaling": None, "attention_bias": False, "mlp_bias": False,
        "tie_word_embeddings": cfg.tie_word_embeddings}


def export_tokenizer_safetensors(tokenizer: nn.Module, path: str):
    safetensors.save_file(tokenizer.state_dict(), path)


def export_llama_safetensors(llm: nn.Module, path: str):
    """A LlamaForCausalLM as a bare-LLaMA file (the act-free layout)."""
    safetensors.save_file(llm.state_dict(), path)


def export_hub(root: str, tokenizer: nn.Module, model: nn.Module) -> str:
    """Write ``root/tokenizer`` and ``root/transformer`` in the published
    action-conditioned layout: the tokenizer's diffusers config and
    weights; the LLaMA's config and the whole HeadModelWithAction state
    dict (the act-free layout's bare LLaMA: ``export_llama_safetensors``)."""
    tok_dir = os.path.join(root, "tokenizer")
    tf_dir = os.path.join(root, "transformer")
    for d, cfg in ((tok_dir, tokenizer_hub_config(tokenizer.config)),
                   (tf_dir, llama_hub_config(model.llm_config))):
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2)
    export_tokenizer_safetensors(tokenizer,
                                 os.path.join(tok_dir, TOKENIZER_FILE))
    safetensors.save_file(model.state_dict(),
                          os.path.join(tf_dir, TRANSFORMER_FILE))
    return root


# ---------------------------------------------------------------------------
# Training state on disk
# ---------------------------------------------------------------------------

STATE_TENSORS = "train_state.safetensors"
STATE_META = "train_state.json"
STATE_FORMAT = "ivideogpt_tpu_torch train state 1"
STATES_FORMAT = "ivideogpt_tpu_torch train states 1"


def _checkpoints(ckpt_dir: str):
    """checkpoint-{step} directory names under ckpt_dir, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    names = [d for d in os.listdir(ckpt_dir)
             if re.fullmatch(r"checkpoint-\d+", d)]
    return sorted(names, key=lambda d: int(d.split("-")[1]))


def _state_entries(state, prefix: str = ""):
    """(tensors under ``prefix``, JSON metadata) of a TrainState."""
    sd = state.state_dict()
    tensors = {f"{prefix}model/{k}": v for k, v in sd["model"].items()}
    opt = sd["optimizer"]
    scalars = {}
    for idx, entry in opt["state"].items():
        for key, val in entry.items():
            if torch.is_tensor(val):
                tensors[f"{prefix}optimizer/{idx}/{key}"] = val
            else:
                scalars[f"{idx}/{key}"] = val
    for i, a in enumerate(sd["acc"] or ()):
        tensors[f"{prefix}acc/{i}"] = a
    meta = {"state_step": sd["step"], "updates": sd["updates"],
            "acc": None if sd["acc"] is None else len(sd["acc"]),
            "param_groups": opt["param_groups"], "optimizer_scalars": scalars,
            "schedule": sd["schedule"]}
    return tensors, meta


def _load_state(state, tensors, meta: dict, prefix: str = ""):
    """Load what :func:`_state_entries` wrote under ``prefix``."""
    def under(group):
        head = f"{prefix}{group}/"
        return {k[len(head):]: v for k, v in tensors.items()
                if k.startswith(head)}
    entries: Dict[int, dict] = {}
    for k, v in under("optimizer").items():
        idx, key = k.split("/", 1)
        entries.setdefault(int(idx), {})[key] = v
    for k, v in meta["optimizer_scalars"].items():
        idx, key = k.split("/", 1)
        entries.setdefault(int(idx), {})[key] = v
    groups = [{k: (tuple(v) if k == "betas" else v) for k, v in g.items()}
              for g in meta["param_groups"]]
    acc = (None if meta["acc"] is None
           else [tensors[f"{prefix}acc/{i}"] for i in range(meta["acc"])])
    state.load_state_dict({
        "model": under("model"),
        "optimizer": {"state": entries, "param_groups": groups},
        "step": meta["state_step"], "updates": meta["updates"], "acc": acc,
        "schedule": meta["schedule"]})


def _write_checkpoint(ckpt_dir: str, step: int, tensors, meta: dict,
                      keep: Optional[int]) -> str:
    path = os.path.abspath(os.path.join(ckpt_dir, f"checkpoint-{step}"))
    tmp = f"{path}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    safetensors.save_file(tensors, os.path.join(tmp, STATE_TENSORS))
    with open(os.path.join(tmp, STATE_META), "w") as f:
        json.dump(meta, f, indent=1)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    if keep is not None:
        for d in _checkpoints(ckpt_dir)[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, d))
    return path


def _read_checkpoint(path: str, fmt: str):
    with open(os.path.join(path, STATE_META)) as f:
        meta = json.load(f)
    if meta.get("format") != fmt:
        raise ValueError(f"{path}: not a {fmt!r} checkpoint "
                         f"({meta.get('format')!r})")
    return safetensors.load_file(os.path.join(path, STATE_TENSORS)), meta


def save_train_state(ckpt_dir: str, step: int, state,
                     keep: Optional[int] = None) -> str:
    """Write ``state`` (a ``train.optim.TrainState``) under
    ``{ckpt_dir}/checkpoint-{step}``, replacing one of that name, then
    prune all but the newest ``keep`` checkpoints. Returns the path."""
    tensors, meta = _state_entries(state)
    return _write_checkpoint(ckpt_dir, step, tensors,
                             {"format": STATE_FORMAT, "step": int(step),
                              **meta}, keep)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest ``checkpoint-{step}`` under ckpt_dir, or None."""
    names = _checkpoints(ckpt_dir)
    return os.path.join(ckpt_dir, names[-1]) if names else None


def restore_train_state(path: str, state):
    """Load a :func:`save_train_state` checkpoint into ``state`` (a
    ``TrainState`` built as the saved one was) and return it."""
    tensors, meta = _read_checkpoint(path, STATE_FORMAT)
    _load_state(state, tensors, meta)
    return state


def save_train_states(ckpt_dir: str, step: int, states: Dict[str, object],
                      tensors: Optional[Dict[str, StateDict]] = None,
                      counters: Optional[Dict[str, int]] = None,
                      keep: Optional[int] = None) -> str:
    """A train state of several parts in one ``checkpoint-{step}``: each
    TrainState of ``states`` by its name (its model's state dict, buffers
    included), each dict of tensors of ``tensors`` by its name (an EMA
    copy), and integer ``counters``. Replaces a checkpoint of that name and
    prunes all but the newest ``keep``, as :func:`save_train_state`."""
    flat, parts = {}, {}
    for name, state in states.items():
        t, parts[name] = _state_entries(state, f"{name}/")
        flat.update(t)
    groups = {}
    for name, sd in (tensors or {}).items():
        groups[name] = sorted(sd)
        flat.update({f"{name}/{k}": v for k, v in sd.items()})
    meta = {"format": STATES_FORMAT, "step": int(step), "states": parts,
            "tensors": groups,
            "counters": {k: int(v) for k, v in (counters or {}).items()}}
    return _write_checkpoint(ckpt_dir, step, flat, meta, keep)


def restore_train_states(path: str, states: Dict[str, object]
                         ) -> Tuple[Dict[str, StateDict], Dict[str, int]]:
    """Load a :func:`save_train_states` checkpoint into ``states`` (the
    TrainStates built as the saved ones were, by the same names). Returns
    (the tensor dicts by name, on the CPU; the counters). Raises when the
    checkpoint holds other states than ``states``."""
    flat, meta = _read_checkpoint(path, STATES_FORMAT)
    if sorted(meta["states"]) != sorted(states):
        raise ValueError(f"{path}: holds states {sorted(meta['states'])}, "
                         f"not {sorted(states)}")
    for name, state in states.items():
        _load_state(state, flat, meta["states"][name], f"{name}/")
    tensors = {name: {k: flat[f"{name}/{k}"] for k in keys}
               for name, keys in meta["tensors"].items()}
    return tensors, meta["counters"]
