"""Tokenizer of the PyTorch port against the JAX package in fp32 on the CPU:
``encode_context`` and ``tokenize`` ids are equal; ``detokenize`` frames
match within 1e-4; the bf16 port runs finite under the cast rules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu_torch import generation as tgen
from tests.test_tokenizer_model import TINY
from tests.test_torch_checkpoint import make_tokenizer

B, T, CTX = 2, 5, 2


@pytest.fixture(scope="module")
def models():
    return make_tokenizer(TINY, seed=0, T=T)


def _pixels(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (B, T, 32, 32, 3)).astype(np.float32)


def test_encode_context_ids_equal(models):
    model, params, port = models
    px = _pixels(1)
    ref = jax.jit(lambda p, x: model.apply(p, x, method=model.encode_context))(
        params, jnp.asarray(px[:, :CTX]))
    with torch.no_grad():
        ours = port.encode_context(torch.from_numpy(px[:, :CTX]))
    assert ours.shape == (B, CTX, TINY.ctx_tokens_per_frame)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_tokenize_ids_equal(models):
    model, params, port = models
    px = _pixels(2)
    ref_ids, ref_labels = jax.jit(
        lambda p, x: model.apply(p, x, CTX, method=model.tokenize))(
        params, jnp.asarray(px))
    with torch.no_grad():
        ids, labels = port.tokenize(torch.from_numpy(px), CTX)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))


def test_detokenize_frames_match(models):
    model, params, port = models
    from ivideogpt_tpu_torch import tokens
    L = tokens.seq_len(CTX, T, TINY.ctx_tokens_per_frame,
                       TINY.dyn_tokens_per_frame)
    # any vocab id in any slot, as an LM-sampled stream may carry
    ids = np.random.default_rng(3).integers(0, TINY.vocab_size, (B, L))
    ref = jax.jit(lambda p, i: model.apply(p, i, CTX, method=model.detokenize))(
        params, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        ours = port.detokenize(torch.from_numpy(ids), CTX)
    assert ours.shape == (B, T, 32, 32, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


def test_bf16_cast_rules_keep_codebooks_fp32(models):
    _, _, port = models
    from ivideogpt_tpu_torch.configs import CompressiveVQConfig
    from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
    cfg = CompressiveVQConfig.from_json(TINY.to_json())
    bf = CompressiveVQModel(cfg, dtype=torch.bfloat16)
    bf.load_state_dict(port.state_dict())
    tgen.cast_conv_params(bf)
    assert bf.quantize.embedding.weight.dtype == torch.float32
    assert bf.encoder.conv_in.weight.dtype == torch.bfloat16
    assert bf.quant_linear.weight.dtype == torch.float32   # 2-D: cast at use
    px = torch.from_numpy(_pixels(4))
    with torch.no_grad():
        ids = bf.encode_context(px[:, :CTX])
        frames = bf.detokenize(port.tokenize(px, CTX)[0], CTX)
    assert ids.shape == (B, CTX, TINY.ctx_tokens_per_frame)
    assert frames.dtype == torch.bfloat16
    assert torch.isfinite(frames.float()).all()


def test_tokenize_matches_committed_golden_ids():
    """The port, loaded with the seed-0 JAX init of TINY at 64px, tokenizes
    the committed sample trajectory into the committed golden ids
    (tests/golden/synthetic_tokens.npz, the JAX package's own oracle)."""
    import os
    import sys

    from tests.test_torch_checkpoint import port_config, to_numpy_tree
    from ivideogpt_tpu.models import CompressiveVQModel
    from ivideogpt_tpu_torch.models.tokenizer import \
        CompressiveVQModel as TorchTokenizer
    from ivideogpt_tpu_torch.utils import checkpoint as port_ckpt

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from inference.utils import NPZParser

    cfg = TINY.replace(resolution=64, max_att_resolution=16)
    px, _ = NPZParser(16, 64).parse(
        os.path.join(repo, "inference", "samples", "synthetic_sample.npz"),
        "synthetic")
    px = np.asarray(px, np.float32)[None]
    model = CompressiveVQModel(cfg, use_pallas=False)
    params = jax.jit(model.init, static_argnames="segment_len")(
        jax.random.key(0), jnp.asarray(px[0, :2]), jnp.asarray(px[0, 2:]),
        segment_len=14)
    port = TorchTokenizer(port_config(cfg))
    port.load_state_dict(port_ckpt.tokenizer_state_dict(to_numpy_tree(params)),
                         strict=True)
    with torch.no_grad():
        ids, labels = port.tokenize(torch.from_numpy(px), 2)
    golden = np.load(os.path.join(repo, "tests", "golden",
                                  "synthetic_tokens.npz"))
    np.testing.assert_array_equal(ids.numpy(), golden["ids"])
    np.testing.assert_array_equal(labels.numpy(), golden["labels"])
