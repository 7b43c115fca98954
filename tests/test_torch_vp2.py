"""The port's VP2 predictor (``ivideogpt_tpu_torch/vp/interface.py``) against
the JAX package's, on the tiny hub of ``tools/make_fake_hub.py`` with an
action head of action_dim 5 (the yaml's):
- the shared context is encoded once a chunk, its ids equal to JAX's
  ``encode_context`` (fp32, bit for bit);
- the output contract: [B, 11, 64, 64, 3] float32 in [0, 1], chunked
  generation and decoding, seeded ``seed + calls`` a chunk, and the uint8
  wire (multiples of 1/255, within 1/510 of the float one);
- the ``lora.safetensors`` fold equals ``lora.merge`` (within 1e-6: an fp32
  matmul in another order); the JAX predictor's own fold of that file is a
  no-op (ROADMAP Queue 3), pinned here;
- the load errors (peft-wrapped with ``lora=False``, a missing adapter, a
  peft rank that is not ``lora_r``);
- ``int8_detok``: the same token streams, rendered by the port's int8
  detokenize, as far from the exact render as JAX's int8 render is (within
  10 %, mean |difference|). The two int8 renders are compared as
  ``tests/test_torch_qconv.py`` explains, each in the predictor's decode
  chunks (a dynamic scale is a chunk's): ~1e-6 of float rounding between
  the packages flips activation codes, and the flips spread (measured: a
  median drift of 4e-6, a mean of 0.47 of the int8-vs-exact gap's, a max
  of 0.63 of its max), so the test holds the drift's mean below the gap's
  and its max below 1.5 times the gap's; the per-conv arithmetic is held
  exact there.
"""

import contextlib
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load
from safetensors.numpy import save_file as np_save

from ivideogpt_tpu.train import lora as jlora
from ivideogpt_tpu.vp.interface import _load_from_checkpoints as jax_load
from ivideogpt_tpu_torch.ops import qconv as tq
from ivideogpt_tpu_torch.utils.checkpoint import action_model_state_dict
from ivideogpt_tpu_torch.vp.interface import IVideoGPTPredictor
from tests.test_torch_checkpoint import to_numpy_tree
from tests.test_torch_hub import _peft_wrap

torch.set_num_threads(2)

A, TOP_K = 5, 10


@pytest.fixture(scope="module")
def hub(tmp_path_factory):
    from tools.make_fake_hub import make_fake_hub
    return make_fake_hub(str(tmp_path_factory.mktemp("hub")), size="tiny",
                         action_conditioned=True, action_dim=A)


def _paths(hub):
    return dict(pretrained_vqgan_name_or_path=os.path.join(hub, "tokenizer"),
                pretrained_transformer_path=os.path.join(hub, "transformer"))


def _predictor(hub, **kw):
    return IVideoGPTPredictor(**_paths(hub), action_dim=A, top_k=TOP_K,
                              device="cpu", **kw)


def _batch(b, shared=True, t=10, seed=0):
    rng = np.random.default_rng(seed)
    n = 1 if shared else b
    video = rng.uniform(0, 1, (n, 2, 64, 64, 3)).astype(np.float32)
    return {"video": np.repeat(video, b // n, axis=0),
            "actions": rng.uniform(-1, 1, (b, t, A)).astype(np.float32)}


@pytest.mark.parametrize("shared", [True, False])
def test_context_encode_matches_jax_once_a_chunk(hub, shared):
    pred = _predictor(hub, generate_max_batchsize=2, decode_max_batchsize=1)
    calls = []
    encode = pred.tokenizer.encode_context
    pred.tokenizer.encode_context = lambda x: calls.append(
        (x.clone(), encode(x))) or calls[-1][1]
    batch = _batch(3, shared)
    out = pred(batch)["rgb"]
    assert out.shape == (3, 11, 64, 64, 3)
    # chunks of 2 and 1; a shared context is encoded from one candidate
    assert [c[0].shape[0] for c in calls] == ([1, 1] if shared else [2, 1])
    jtok, jparams, _, _ = jax_load(
        os.path.join(hub, "tokenizer"), os.path.join(hub, "transformer"),
        None, action_dim=A, context_length=2, segment_length=12, lora=False,
        lora_r=8, lora_alpha=32.0)
    encode_jax = jax.jit(lambda p, x: jtok.apply(
        p, x, method=jtok.encode_context))
    for x, ids in calls:
        theirs = encode_jax(jparams, jnp.asarray(x.numpy()))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(theirs))


def test_output_contract_seeds_and_uint8_wire(hub):
    batch = _batch(3, t=12)
    a = _predictor(hub, seed=3, generate_max_batchsize=2,
                   decode_max_batchsize=1, max_pending_chunks=1)
    out = a(batch)["rgb"]
    assert out.shape == (3, 11, 64, 64, 3) and out.dtype == np.float32
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
    assert a._calls == 2          # one generator a chunk: seed + calls
    # the same seed and chunking: the same futures, whatever the window
    b = _predictor(hub, seed=3, generate_max_batchsize=2,
                   decode_max_batchsize=1, max_pending_chunks=3)
    np.testing.assert_array_equal(b(batch)["rgb"], out)
    u8 = _predictor(hub, seed=3, generate_max_batchsize=2,
                    decode_max_batchsize=1, u8_transfer=True)
    wire = u8(batch)["rgb"]
    np.testing.assert_array_equal(wire * 255, np.round(wire * 255))
    np.testing.assert_allclose(wire, out, rtol=0, atol=1 / 510 + 1e-7)


def _adapters(jax_params, seed=0, rank=8):
    """A ``lora.safetensors`` of the JAX package's adapter tree: ``a`` from
    ``init_lora``, ``b`` random (``init_lora`` zeroes it)."""
    rng = np.random.default_rng(seed)
    flat, pairs = {}, {}
    for name, ab in jlora.init_lora(jax_params, jax.random.key(seed),
                                    rank=rank).items():
        a = np.asarray(ab["a"])
        b = rng.normal(0, 0.05, ab["b"].shape).astype(np.float32)
        flat[f"{name}/a"], flat[f"{name}/b"] = a, b
        pairs[name] = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
    return flat, pairs


def test_lora_fold_matches_merge_and_the_jax_fold_is_a_no_op(hub, tmp_path):
    lora_hub = str(tmp_path / "hub")
    shutil.copytree(hub, lora_hub)
    tf = os.path.join(lora_hub, "transformer")
    kw = dict(config_name=None, action_dim=A, context_length=2,
              segment_length=12, lora_r=8, lora_alpha=32.0)
    tok_dir = os.path.join(lora_hub, "tokenizer")
    _, _, _, base = jax_load(tok_dir, tf, lora=False, **kw)
    flat, pairs = _adapters(base)
    np_save(flat, os.path.join(tf, "lora.safetensors"))

    want = action_model_state_dict(to_numpy_tree(
        jlora.merge(base, pairs, alpha=32.0, rank=8)))
    pred = _predictor(lora_hub, lora=True, lora_r=8, lora_alpha=32.0)
    got = pred.model.state_dict()
    assert sorted(got) == sorted(want)
    moved = 0
    for k, v in want.items():
        # one fp32 matmul, summed in another order
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
        moved += not np.array_equal(v.numpy(), action_model_state_dict(
            to_numpy_tree(base))[k].numpy())
    assert moved == 2 * 7 + 2   # 7 projections x 2 layers, embed, lm_head

    # the JAX predictor rebuilds the file into a nested tree that
    # lora.merge never matches: its weights stay the base ones
    _, _, _, jax_folded = jax_load(tok_dir, tf, lora=True, **kw)
    base_sd = action_model_state_dict(to_numpy_tree(base))
    for k, v in action_model_state_dict(to_numpy_tree(jax_folded)).items():
        np.testing.assert_array_equal(v.numpy(), base_sd[k].numpy())


def test_load_errors(hub, tmp_path):
    with pytest.raises(FileNotFoundError, match="allow_missing_lora"):
        _predictor(hub, lora=True)
    assert _predictor(hub, lora=True, allow_missing_lora=True).model

    peft_hub = str(tmp_path / "peft")
    shutil.copytree(hub, peft_hub)
    path = os.path.join(peft_hub, "transformer", "model.safetensors")
    np_save(_peft_wrap(np_load(path), rank=8), path)
    with pytest.raises(ValueError, match="peft-wrapped"):
        _predictor(peft_hub)
    with pytest.raises(ValueError, match="rank"):
        _predictor(peft_hub, lora=True, lora_r=4)
    folded = _predictor(peft_hub, lora=True, lora_r=8, lora_alpha=16.0)
    assert not torch.equal(folded.model.llm.lm_head.weight,
                           _predictor(hub).model.llm.lm_head.weight)

    with pytest.raises(ValueError, match="context_length=2"):
        _predictor(hub, segment_length=16)
    with pytest.raises(ValueError, match="checkpoint paths"):
        IVideoGPTPredictor(device="cpu")


def test_int8_detok_matches_jax(hub):
    from ivideogpt_tpu.ops.qconv import int8_convs
    batch = _batch(3, t=12, seed=5)
    renders = {}
    for int8 in (False, True):
        pred = _predictor(hub, seed=7, generate_max_batchsize=2,
                          decode_max_batchsize=2, int8_detok=int8)
        ids = []
        detok = pred.tokenizer.detokenize
        pred.tokenizer.detokenize = lambda x, ctx: ids.append(x) or detok(
            x, ctx)
        renders[int8] = (pred(batch)["rgb"], torch.cat(ids))
    (exact, ids), (ours, ids8) = renders[False], renders[True]
    assert torch.equal(ids, ids8)      # the knob changes pixels only
    jtok, jparams, _, _ = jax_load(
        os.path.join(hub, "tokenizer"), os.path.join(hub, "transformer"),
        None, action_dim=A, context_length=2, segment_length=12, lora=False,
        lora_r=8, lora_alpha=32.0)

    def render(int8):   # in the predictor's chunks: a scale is a chunk's
        out = []
        for i in (0, 2):
            with int8_convs() if int8 else contextlib.nullcontext():
                px = jtok.apply(jparams, jnp.asarray(ids[i:i + 2].numpy(),
                                                     jnp.int32),
                                2, method=jtok.detokenize)
            out.append(np.clip(np.asarray(px, np.float32), 0.0, 1.0)[:, 1:])
        return np.concatenate(out)
    theirs, theirs_exact = render(True), render(False)
    np.testing.assert_allclose(exact, theirs_exact, rtol=0, atol=1e-5)
    gap = np.abs(theirs - theirs_exact)
    drift = np.abs(ours - theirs)
    error = np.abs(ours - exact).mean() / gap.mean()
    assert gap.mean() > 1e-3
    assert 0.9 < error < 1.1, error
    assert drift.mean() < gap.mean(), (drift.mean(), gap.mean())
    assert drift.max() < 1.5 * gap.max(), (drift.max(), gap.max())
    # the predictor's render is the port's int8 detokenize of those ids
    tok = _predictor(hub).tokenizer
    with tq.int8_convs(), torch.no_grad():
        again = torch.cat([tok.detokenize(ids[i:i + 2], 2) for i in (0, 2)])
    np.testing.assert_array_equal(again.clamp(0.0, 1.0)[:, 1:].numpy(), ours)
