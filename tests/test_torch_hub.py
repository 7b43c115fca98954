"""The port's checkpoint bridge against the published hub layout and the
JAX package's loaders, on the tiny hub of ``tools/make_fake_hub.py``:
- ``utils/safetensors.py`` (written by hand) reads what
  ``safetensors.numpy.save_file``, ``safetensors.torch.save_file`` and
  ``transformers``' ``save_pretrained`` write, and they read what it writes,
  bit for bit, for every dtype (BF16 through the torch API; numpy has none);
- the hub loaders give state dicts bit-equal to ``tokenizer_state_dict`` /
  ``llama_state_dict`` / ``action_model_state_dict`` of the JAX loaders'
  trees, and the port's modules take them with ``strict=True``;
- the peft fold equals the JAX fold at an explicit alpha and rank (within
  1e-6: two fp32 matmuls summed in another order); without them the port
  raises where the JAX package folds at scale 1.0 (both pinned);
- the context re-slice and the config readers match the JAX package.
"""

import json
import os
import shutil
import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load
from safetensors.numpy import save_file as np_save
from safetensors.torch import load_file as torch_load
from safetensors.torch import save_file as torch_save

from ivideogpt_tpu.utils import checkpoint as jax_ckpt
from ivideogpt_tpu_torch.utils import checkpoint as ckpt
from ivideogpt_tpu_torch.utils import safetensors as st
from tests.test_torch_checkpoint import port_config

torch.set_num_threads(2)

NUMPY_DTYPES = ("float64", "float32", "float16", "int64", "int32", "int16",
                "int8", "uint8", "bool")


@pytest.fixture(scope="module")
def hubs(tmp_path_factory):
    from tools.make_fake_hub import make_fake_hub
    root = tmp_path_factory.mktemp("hubs")
    return {"free": make_fake_hub(str(root / "free"), size="tiny"),
            "cond": make_fake_hub(str(root / "cond"), size="tiny",
                                  action_conditioned=True)}


def _arrays(dtype, seed=0):
    """Tensors of one numpy dtype: odd lengths, a scalar, an empty one and
    a transposed view."""
    rng = np.random.default_rng(seed)

    def make(shape):
        if dtype == "bool":
            return rng.integers(0, 2, shape).astype(bool)
        if dtype.startswith(("int", "uint")):
            info = np.iinfo(dtype)
            return rng.integers(max(info.min, -1000), min(info.max, 1000),
                                shape).astype(dtype)
        return rng.normal(size=shape).astype(dtype)
    return {"odd": make((3,)), "matrix": make((5, 7)), "scalar": make(()),
            "empty": make((0, 4)), "wide": make((2, 3, 4)),
            "view": make((4, 6)).T}


def _same(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        o = ours[k]
        o = o.numpy() if torch.is_tensor(o) else o
        assert o.dtype == np.asarray(v).dtype and o.shape == np.shape(v), k
        np.testing.assert_array_equal(o, np.asarray(v), err_msg=k)


@pytest.mark.parametrize("dtype", NUMPY_DTYPES)
def test_reader_reads_safetensors_numpy_files(dtype, tmp_path):
    arrays = _arrays(dtype)
    path = str(tmp_path / "x.safetensors")
    np_save({k: v.copy() for k, v in arrays.items()}, path)
    _same(st.load_file(path), arrays)


@pytest.mark.parametrize("dtype", NUMPY_DTYPES)
def test_writer_output_reads_in_safetensors_numpy(dtype, tmp_path):
    arrays = _arrays(dtype, seed=1)
    path = str(tmp_path / "x.safetensors")
    st.save_file({k: torch.from_numpy(v.copy()) for k, v in arrays.items()},
                 path)
    _same(np_load(path), arrays)
    # a transposed view is written as its values, not its base buffer
    st.save_file({"view": torch.arange(12.).reshape(3, 4).t()}, path)
    np.testing.assert_array_equal(np_load(path)["view"],
                                  np.arange(12.).reshape(3, 4).T)


def test_bf16_both_ways_through_the_torch_api(tmp_path):
    ts = {"w": torch.randn(5, 3).bfloat16(), "s": torch.tensor(1.5).bfloat16(),
          "e": torch.zeros(0, dtype=torch.bfloat16),
          "h": torch.randn(7).half()}
    theirs = str(tmp_path / "theirs.safetensors")
    ours = str(tmp_path / "ours.safetensors")
    torch_save(ts, theirs)
    st.save_file(ts, ours)
    for got in (st.load_file(theirs), torch_load(ours)):
        assert sorted(got) == sorted(ts)
        for k, v in ts.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_header_padding_metadata_and_unaligned_offsets(tmp_path):
    """The header is padded to 8 bytes; ``__metadata__`` is written and
    skipped; a tensor whose offset is not a multiple of its item size (an
    int8 of 3 bytes written before it) reads bit-equal, in the port's
    reader and in the library's."""
    path = str(tmp_path / "x.safetensors")
    ts = {"a": torch.tensor([1, 2, 3], dtype=torch.int8),
          "b": torch.randn(4, 5), "c": torch.randn(3).bfloat16()}
    st.save_file(ts, path, metadata={"format": "pt"})
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    assert n % 8 == 0 and header["__metadata__"] == {"format": "pt"}
    assert header["b"]["data_offsets"][0] == 3   # unaligned for F32
    got = st.load_file(path)
    for k, v in ts.items():
        assert torch.equal(got[k], v), k
    np.testing.assert_array_equal(np_load(path)["b"], ts["b"].numpy())


def test_directory_merge_and_bad_files(tmp_path):
    d = tmp_path / "dir"
    d.mkdir()
    st.save_file({"x": torch.zeros(2), "y": torch.ones(1)},
                 str(d / "a.safetensors"))
    st.save_file({"x": torch.ones(2)}, str(d / "b.safetensors"))
    st.save_file({"z": torch.ones(1)}, str(d / "c.safetensors"))
    (d / "notes.txt").write_text("not a tensor file")
    got = st.load(str(d))
    assert sorted(got) == ["x", "y", "z"] and torch.equal(got["x"],
                                                          torch.ones(2))
    assert "z" not in st.load(str(d), skip=("c.safetensors",))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        st.load(str(empty))
    # data_offsets that do not match the dtype and shape
    bad = str(tmp_path / "bad.safetensors")
    header = json.dumps({"w": {"dtype": "F32", "shape": [2],
                               "data_offsets": [0, 4]}}).encode()
    with open(bad, "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header + b"\0" * 8)
    with pytest.raises(ValueError, match="data_offsets"):
        st.load_file(bad)


def test_reader_reads_save_pretrained_output(hubs):
    """The act-free transformer file is ``transformers``'
    ``save_pretrained`` output (with its ``__metadata__``)."""
    path = os.path.join(hubs["free"], "transformer", "model.safetensors")
    _same(st.load_file(path), np_load(path))
    assert "lm_head.weight" in np_load(path)   # untied, as LLaMA's default


def _np(tree):
    return {k: v.numpy() for k, v in tree.items()}


def test_loaders_match_the_jax_loaders(hubs):
    from ivideogpt_tpu_torch.utils.checkpoint import (action_model_state_dict,
                                                      llama_state_dict,
                                                      tokenizer_state_dict)
    for name in ("free", "cond"):
        tok = os.path.join(hubs[name], "tokenizer")
        _same(_np(ckpt.load_tokenizer_safetensors(tok)),
              _np(tokenizer_state_dict(
                  jax_ckpt.load_tokenizer_safetensors(tok))))
        tf = os.path.join(hubs[name], "transformer")
        _same(_np(ckpt.load_llm_only_safetensors(tf)),
              _np(llama_state_dict(
                  jax_ckpt.load_llm_only_safetensors(tf))))
    tf = os.path.join(hubs["free"], "transformer")
    _same(_np(ckpt.load_llama_safetensors(tf)),
          _np(llama_state_dict(jax_ckpt.load_llama_safetensors(tf))))
    tf = os.path.join(hubs["cond"], "transformer")
    _same(_np(ckpt.load_action_model_safetensors(tf)),
          _np(action_model_state_dict(
              jax_ckpt.load_action_model_safetensors(tf))))


@pytest.mark.parametrize("conditioned", [False, True])
def test_load_models_takes_the_hub_strictly(hubs, conditioned):
    """``inference.predict.load_models`` on both layouts: every parameter
    of the port's models is the file's (an action-free run over either
    file takes only the LLaMA)."""
    from ivideogpt_tpu_torch.inference.predict import load_models
    hub = hubs["cond" if conditioned else "free"]
    args = SimpleNamespace(pretrained_model_name_or_path=hub,
                           context_length=2, segment_length=16,
                           action_conditioned=conditioned, action_dim=4,
                           device="cpu")
    tok, model = load_models(args)
    tok_sd = np_load(os.path.join(hub, "tokenizer",
                                  "diffusion_pytorch_model.safetensors"))
    _same(_np(tok.state_dict()), tok_sd)
    tf_sd = np_load(os.path.join(hub, "transformer", "model.safetensors"))
    if conditioned:
        _same(_np(model.state_dict()), tf_sd)
    else:
        _same(_np(model.llm.state_dict()), tf_sd)
    # an action-free run also takes a full action-model export
    args.action_conditioned = False
    args.pretrained_model_name_or_path = hubs["cond"]
    _, model = load_models(args)
    tf_sd = np_load(os.path.join(hubs["cond"], "transformer",
                                 "model.safetensors"))
    _same(_np(model.llm.state_dict()),
          {k[len("llm."):]: v for k, v in tf_sd.items()
           if k.startswith("llm.")})
    args.context_length = 1
    with pytest.raises(ValueError, match="context_length"):
        load_models(args)


def test_unmapped_names_raise():
    with pytest.raises(ValueError, match="unmapped llama key"):
        ckpt.llama_names({"model.layers.0.self_attn.q_proj.bias":
                          torch.zeros(2)})
    with pytest.raises(ValueError, match="unmapped action-model keys"):
        ckpt.action_model_names({"value_head.weight": torch.zeros(2)})
    # older HF exports carry rotary buffers: dropped, as in the JAX loader
    got = ckpt.llama_names({"model.layers.0.self_attn.rotary_emb.inv_freq":
                            torch.zeros(2), "norm.weight": torch.ones(2)})
    assert sorted(got) == ["model.norm.weight"]


def _peft_wrap(sd, rank=4, seed=0):
    """A peft-wrapped copy of an action-model state dict: adapters on two
    Linears and on the embedding, every name under ``base_model.model.``."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        if k in ("llm.model.layers.0.self_attn.q_proj.weight",
                 "llm.lm_head.weight"):
            base = k[:-len(".weight")]
            out[f"base_model.model.{base}.base_layer.weight"] = v
            out[f"base_model.model.{base}.lora_A.default.weight"] = \
                rng.normal(0, 0.1, (rank, v.shape[1])).astype(np.float32)
            out[f"base_model.model.{base}.lora_B.default.weight"] = \
                rng.normal(0, 0.1, (v.shape[0], rank)).astype(np.float32)
        elif k == "llm.model.embed_tokens.weight":
            base = k[:-len(".weight")]
            out[f"base_model.model.{base}.base_layer.weight"] = v
            out[f"base_model.model.{base}.lora_embedding_A.default"] = \
                rng.normal(0, 0.1, (rank, v.shape[0])).astype(np.float32)
            out[f"base_model.model.{base}.lora_embedding_B.default"] = \
                rng.normal(0, 0.1, (v.shape[1], rank)).astype(np.float32)
        else:
            out[f"base_model.model.{k}"] = v
    return out


def test_peft_fold_matches_jax_and_the_silent_default_is_not_copied(hubs):
    raw = np_load(os.path.join(hubs["cond"], "transformer",
                               "model.safetensors"))
    wrapped = _peft_wrap(raw)
    ours_in = {k: torch.from_numpy(v) for k, v in wrapped.items()}
    assert ckpt.is_peft_state_dict(ours_in)
    assert jax_ckpt.is_peft_state_dict(wrapped)
    theirs = jax_ckpt.merge_peft_state_dict(wrapped, alpha=32.0, rank=4)
    ours = ckpt.merge_peft_state_dict(ours_in, alpha=32.0, rank=4)
    assert sorted(ours) == sorted(theirs) == sorted(raw)
    for k, v in theirs.items():
        # fp32 matmuls summed in another order
        np.testing.assert_allclose(ours[k].numpy(), v, rtol=0, atol=1e-6,
                                   err_msg=k)
    assert not np.array_equal(theirs["llm.lm_head.weight"],
                              raw["llm.lm_head.weight"])
    # the port refuses to guess alpha and rank; JAX folds at scale 1.0
    with pytest.raises(ValueError, match="alpha and rank"):
        ckpt.merge_peft_state_dict(ours_in)
    unscaled = jax_ckpt.merge_peft_state_dict(wrapped)
    at_one = jax_ckpt.merge_peft_state_dict(wrapped, alpha=4.0, rank=4)
    for k, v in unscaled.items():
        np.testing.assert_array_equal(v, at_one[k], err_msg=k)
    with pytest.raises(ValueError, match="both"):
        ckpt.merge_peft_state_dict(ours_in, alpha=32.0)
    with pytest.raises(ValueError, match="rank"):
        ckpt.merge_peft_state_dict(ours_in, alpha=32.0, rank=8)
    # a plain state dict passes through untouched
    plain = {"w": torch.ones(2)}
    assert ckpt.merge_peft_state_dict(plain) is plain


def test_context_reslice_matches_jax(hubs, tmp_path):
    from ivideogpt_tpu_torch.utils.checkpoint import tokenizer_state_dict
    tok = os.path.join(hubs["cond"], "tokenizer")
    sd = ckpt.load_tokenizer_safetensors(tok)
    jax_params = jax_ckpt.load_tokenizer_safetensors(tok)
    _same(_np(ckpt.set_context_length(sd, 2, 1)),
          _np(tokenizer_state_dict(
              jax_ckpt.set_context_length(jax_params, 2, 1))))
    assert ckpt.set_context_length(sd, 2, 2) is sd
    with pytest.raises(ValueError):
        ckpt.set_context_length(sd, 1, 2)

    ours, cfg = ckpt.load_tokenizer_for_context(tok, 1)
    theirs, jcfg = jax_ckpt.load_tokenizer_for_context(tok, 1)
    _same(_np(ours), _np(tokenizer_state_dict(theirs)))
    assert cfg == port_config(jcfg) and cfg.context_length == 1
    kv = [k for k in ours if k.endswith("kv_pos_emb")]
    assert kv and all(ours[k].shape[0] * 2 == sd[k].shape[0] for k in kv)
    for target in (3,):
        with pytest.raises(ValueError, match="sliced, not"):
            ckpt.load_tokenizer_for_context(tok, target)
        with pytest.raises(ValueError, match="sliced, not"):
            jax_ckpt.load_tokenizer_for_context(tok, target)
    # without a config.json: no re-slice, no config
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(os.path.join(tok, "diffusion_pytorch_model.safetensors"),
                bare)
    got, none = ckpt.load_tokenizer_for_context(str(bare), 1)
    assert none is None and sorted(got) == sorted(sd)


def test_config_readers_match_jax(hubs):
    """One reader a config: the keys ``vp/interface.py`` reads (a superset
    of ``inference/predict.py``'s), the same model as each JAX reader on
    the published schema."""
    import inference.predict as jax_predict
    from ivideogpt_tpu.vp.interface import _load_from_checkpoints
    tok_json = ckpt.read_json(os.path.join(hubs["cond"], "tokenizer",
                                           "config.json"))
    lm_json = ckpt.read_json(os.path.join(hubs["cond"], "transformer",
                                          "config.json"))
    ours = ckpt.tokenizer_config_from_hub(tok_json)
    args = SimpleNamespace(pretrained_model_name_or_path=hubs["cond"],
                           context_length=2, segment_length=16,
                           action_conditioned=True, action_dim=4)
    tok, _, model, _, jcfg = jax_predict.load_models(args)
    assert ours == port_config(jcfg)
    jtok, _, jmodel, _ = _load_from_checkpoints(
        os.path.join(hubs["cond"], "tokenizer"),
        os.path.join(hubs["cond"], "transformer"), None, action_dim=4,
        context_length=2, segment_length=12, lora=False, lora_r=8,
        lora_alpha=32.0)
    assert ours == port_config(jtok.config)
    lm = ckpt.llama_config_from_hub(lm_json, vocab_size=ours.vocab_size)
    assert lm == port_config(model.llm_config) == port_config(
        jmodel.llm_config)
    with pytest.raises(ValueError, match="vocab"):
        ckpt.llama_config_from_hub(lm_json, vocab_size=ours.vocab_size + 1)
    with pytest.raises(ValueError, match="does not compute"):
        ckpt.llama_config_from_hub(dict(lm_json, rope_scaling={"factor": 2}))


def test_export_hub_round_trip_reads_in_the_jax_loaders(hubs, tmp_path):
    """The port's writer makes a hub that its own loaders and the JAX
    package's read back bit for bit."""
    from ivideogpt_tpu_torch.inference.predict import load_models
    from ivideogpt_tpu_torch.utils.checkpoint import (action_model_state_dict,
                                                      llama_state_dict,
                                                      tokenizer_state_dict)
    args = SimpleNamespace(pretrained_model_name_or_path=hubs["cond"],
                           context_length=2, segment_length=16,
                           action_conditioned=True, action_dim=4,
                           device="cpu")
    tok, model = load_models(args)
    root = ckpt.export_hub(str(tmp_path / "hub"), tok, model)
    tok_dir = os.path.join(root, "tokenizer")
    tf_dir = os.path.join(root, "transformer")
    _same(_np(ckpt.load_tokenizer_safetensors(tok_dir)),
          _np(tok.state_dict()))
    _same(_np(tokenizer_state_dict(
        jax_ckpt.load_tokenizer_safetensors(tok_dir))), _np(tok.state_dict()))
    _same(_np(action_model_state_dict(
        jax_ckpt.load_action_model_safetensors(tf_dir))),
        _np(model.state_dict()))
    assert ckpt.tokenizer_config_from_hub(ckpt.read_json(
        os.path.join(tok_dir, "config.json"))) == tok.config
    assert ckpt.llama_config_from_hub(ckpt.read_json(
        os.path.join(tf_dir, "config.json"))) == model.llm_config
    # the act-free layout's bare LLaMA, read by the JAX loader
    bare = str(tmp_path / "bare.safetensors")
    ckpt.export_llama_safetensors(model.llm, bare)
    _same(_np(llama_state_dict(jax_ckpt.load_llama_safetensors(bare))),
          _np(model.llm.state_dict()))
