"""Every parameter of the two models, by the published torch checkpoints'
names (the diffusers-style tokenizer, HF ``LlamaForCausalLM`` under
``llm.`` with the action head beside it), with its shape and the scale of
the random values the benchmark gives it.

The benchmark draws the weights from these lists and hands the same
tensors to the program and to the reference; a name or a shape the
program does not have fails its ``load_state_dict``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# name -> (shape, init, scale)
Spec = Dict[str, Tuple[Tuple[int, ...], str, float]]


def tok_dims(t: dict) -> dict:
    """The tokenizer's derived sizes from its config."""
    n = len(t["block_out_channels"])
    r = t["resolution"] // 2 ** (n - 1)
    d = t["vq_embed_dim"] or t["latent_channels"]
    return {"latent_res": r, "ctx_tokens": r * r,
            "dyn_tokens": (r // t["patch_size"]) ** 2, "embed_dim": d}


def _conv(spec: Spec, name: str, cin: int, cout: int, k: int):
    spec[name + ".weight"] = ((cout, cin, k, k), "fan_in", 1.0)
    spec[name + ".bias"] = ((cout,), "normal", 0.02)


def _dense(spec: Spec, name: str, cin: int, cout: int, bias: bool = True,
           init: str = "fan_in", scale: float = 1.0):
    spec[name + ".weight"] = ((cout, cin), init, scale)
    if bias:
        spec[name + ".bias"] = ((cout,), "normal", 0.02)


def _norm(spec: Spec, name: str, c: int, bias: bool = True):
    spec[name + ".weight"] = ((c,), "one", 0.1)
    if bias:
        spec[name + ".bias"] = ((c,), "normal", 0.02)


def _resnet(spec: Spec, p: str, cin: int, cout: int):
    _norm(spec, p + "norm1", cin)
    _conv(spec, p + "conv1", cin, cout, 3)
    _norm(spec, p + "norm2", cout)
    _conv(spec, p + "conv2", cout, cout, 3)
    if cin != cout:
        _conv(spec, p + "conv_shortcut", cin, cout, 1)


def _mid(spec: Spec, p: str, c: int, attention: bool):
    _resnet(spec, p + "resnets.0.", c, c)
    if attention:
        a = p + "attentions.0."
        _norm(spec, a + "group_norm", c)
        for n in ("to_q", "to_k", "to_v", "to_out.0"):
            _dense(spec, a + n, c, c)
    _resnet(spec, p + "resnets.1.", c, c)


def _cross(spec: Spec, p: str, c: int, res: int, frames: int):
    spec[p + "kv_pos_emb"] = ((frames * res * res, c), "normal", 0.02)
    spec[p + "q_pos_emb"] = ((res * res, c), "normal", 0.02)
    _norm(spec, p + "kv_norm", c)
    _norm(spec, p + "q_norm", c)
    spec[p + "att.in_proj_weight"] = ((3 * c, c), "fan_in", 1.0)
    spec[p + "att.in_proj_bias"] = ((3 * c,), "normal", 0.02)
    _dense(spec, p + "att.out_proj", c, c)


def cross_levels(t: dict, encoder: bool) -> List[Tuple[int, int]]:
    """(block index, resolution) of each block a cross-attention block
    follows, as the conditional encoder (resolution halving) or decoder
    (doubling) walks its blocks; the decoder's first cross block, after
    its mid block, is not listed."""
    ch = t["block_out_channels"]
    n = len(ch)
    res = t["resolution"] if encoder else tok_dims(t)["latent_res"]
    out = []
    for i in range(n):
        if i != n - 1:
            res = res // 2 if encoder else res * 2
        if res <= t["max_att_resolution"]:
            out.append((i, res))
    return out


def tokenizer_spec(t: dict) -> Spec:
    ch = list(t["block_out_channels"])
    n = len(ch)
    lp = t["layers_per_block"]
    lat = t["latent_channels"]
    dims = tok_dims(t)
    d, r, ctx = dims["embed_dim"], dims["latent_res"], t["context_length"]
    spec: Spec = {}
    for part, cond in (("encoder.", False), ("cond_encoder.", True)):
        _conv(spec, part + "conv_in", t["in_channels"], ch[0], 3)
        for i, c in enumerate(ch):
            cin = ch[max(i - 1, 0)]
            for j in range(lp):
                _resnet(spec, f"{part}down_blocks.{i}.resnets.{j}.",
                        cin if j == 0 else c, c)
            if i != n - 1:
                _conv(spec, f"{part}down_blocks.{i}.downsamplers.0.conv",
                      c, c, 3)
        if cond:
            for k, (i, res) in enumerate(cross_levels(t, True)):
                _cross(spec, f"{part}cross_att_blocks.{k}.", ch[i], res, ctx)
        _mid(spec, part + "mid_block.", ch[-1],
             cond or t["mid_block_add_attention"])
        _norm(spec, part + "conv_norm_out", ch[-1])
        _conv(spec, part + "conv_out", ch[-1], lat, 3)
    rev = ch[::-1]
    for part, cond in (("decoder.", False), ("cond_decoder.", True)):
        _conv(spec, part + "conv_in", lat, rev[0], 3)
        _mid(spec, part + "mid_block.", rev[0],
             cond or t["mid_block_add_attention"])
        if cond:
            _cross(spec, part + "cross_att_blocks.0.", rev[0], r, ctx)
            for k, (i, res) in enumerate(cross_levels(t, False)):
                _cross(spec, f"{part}cross_att_blocks.{k + 1}.", rev[i], res,
                       ctx)
        for i, c in enumerate(rev):
            cin = rev[max(i - 1, 0)]
            for j in range(lp + 1):
                _resnet(spec, f"{part}up_blocks.{i}.resnets.{j}.",
                        cin if j == 0 else c, c)
            if i != n - 1:
                _conv(spec, f"{part}up_blocks.{i}.upsamplers.0.conv", c, c, 3)
        _norm(spec, part + "conv_norm_out", rev[-1])
        _conv(spec, part + "conv_out", rev[-1], t["out_channels"], 3)
    p2 = t["patch_size"] ** 2
    _conv(spec, "quant_conv", lat, d, 1)
    _conv(spec, "post_quant_conv", d, lat, 1)
    _dense(spec, "quant_linear", lat * p2, d)
    _dense(spec, "post_quant_linear", d, lat * p2)
    spec["quantize.embedding.weight"] = ((t["num_vq_embeddings"], d),
                                         "normal", 0.5)
    spec["dynamics_quantize.embedding.weight"] = (
        (t["num_dyn_embeddings"], d), "normal", 0.5)
    return spec


def lm_spec(m: dict, action_dim: int) -> Spec:
    """The LLaMA under ``llm.`` and the action head; ``action_dim`` is the
    head's input width (the head exists in an action-free model too, and
    then never reads an action)."""
    h, f = m["hidden_size"], m["intermediate_size"]
    hd = h // m["num_attention_heads"]
    kv = m["num_key_value_heads"] * hd
    s = m["initializer_range"]
    spec: Spec = {"llm.model.embed_tokens.weight": ((m["vocab_size"], h),
                                                    "normal", s)}
    for i in range(m["num_hidden_layers"]):
        p = f"llm.model.layers.{i}."
        _norm(spec, p + "input_layernorm", h, bias=False)
        for n, o in (("q_proj", h), ("k_proj", kv), ("v_proj", kv)):
            _dense(spec, p + "self_attn." + n, h, o, False, "normal", s)
        _dense(spec, p + "self_attn.o_proj", h, h, False, "normal", s)
        _norm(spec, p + "post_attention_layernorm", h, bias=False)
        _dense(spec, p + "mlp.gate_proj", h, f, False, "normal", s)
        _dense(spec, p + "mlp.up_proj", h, f, False, "normal", s)
        _dense(spec, p + "mlp.down_proj", f, h, False, "normal", s)
    _norm(spec, "llm.model.norm", h, bias=False)
    if not m["tie_word_embeddings"]:
        _dense(spec, "llm.lm_head", h, m["vocab_size"], False, "normal", s)
    _dense(spec, "action_linear", action_dim, h, True, "normal", s)
    return spec


def std_of(shape, init: str, scale: float) -> Tuple[float, float]:
    """(mean, std) of a parameter's random values."""
    if init == "one":
        return 1.0, scale
    if init == "fan_in":
        fan = 1
        for x in shape[1:]:
            fan *= x
        return 0.0, scale / fan ** 0.5
    return 0.0, scale
