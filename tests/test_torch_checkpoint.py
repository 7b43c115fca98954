"""Weight bridge of the PyTorch port: ``ivideogpt_tpu_torch.utils.checkpoint``
gives the same names and arrays as the JAX package's exporters, and the
port's modules load them with ``strict=True``.

The helpers here (JAX init -> numpy tree -> port module) are shared by the
other ``test_torch_*`` parity tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu.configs import ActionModelConfig, TransformerConfig
from ivideogpt_tpu.models import CompressiveVQModel, HeadModelWithAction
from ivideogpt_tpu.utils import checkpoint as jax_ckpt
from ivideogpt_tpu_torch import configs as tcfg
from ivideogpt_tpu_torch.models.action_model import \
    HeadModelWithAction as TorchHead
from ivideogpt_tpu_torch.models.tokenizer import \
    CompressiveVQModel as TorchTokenizer
from ivideogpt_tpu_torch.utils import checkpoint as port_ckpt
from tests.test_tokenizer_model import TINY

torch.set_num_threads(2)

# a 2-layer, 64-wide LM over TINY's vocab, as tests/test_golden_fixture.py
LM_TINY = TransformerConfig(
    vocab_size=TINY.vocab_size, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
    max_position_embeddings=2048)


def to_numpy_tree(tree):
    """Flax params -> nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def jitter(tree, seed: int, std: float = 0.02):
    """Add N(0, std) to every leaf, so zero-initialised parameters (pos
    embeddings, biases, the action head) take part in the comparison."""
    rng = np.random.default_rng(seed)

    def visit(t):
        if isinstance(t, dict):
            return {k: visit(v) for k, v in t.items()}
        return (t + rng.normal(0, std, t.shape)).astype(t.dtype)
    return visit(tree)


def port_config(jax_cfg):
    """The same config as the port's own dataclass, through its JSON form."""
    cls = getattr(tcfg, type(jax_cfg).__name__)
    return cls.from_json(jax_cfg.to_json())


def make_tokenizer(cfg=TINY, seed=0, T=5):
    """(JAX model, numpy params, port model in fp32 with the same weights)."""
    model = CompressiveVQModel(cfg, use_pallas=False)
    ctx = cfg.context_length
    H = cfg.resolution
    px = jnp.zeros((ctx, H, H, 3), jnp.float32)
    fut = jnp.zeros((T - ctx, H, H, 3), jnp.float32)
    params = jax.jit(model.init, static_argnames="segment_len")(
        jax.random.key(seed), px, fut, segment_len=T - ctx)
    params = jitter(to_numpy_tree(params), seed)
    port = TorchTokenizer(port_config(cfg))
    port.load_state_dict(port_ckpt.tokenizer_state_dict(params), strict=True)
    return model, params, port.eval()


def make_lm(lm_cfg=LM_TINY, ctx=2, T=5, seed=1, tok_cfg=TINY,
            reward_prediction=False, action_recon=None):
    head = ActionModelConfig(
        action_dim=4, context_length=ctx, segment_length=T,
        tokens_per_context=tok_cfg.ctx_tokens_per_frame,
        tokens_per_dyna=tok_cfg.dyn_tokens_per_frame,
        reward_prediction=reward_prediction, action_recon=action_recon)
    model = HeadModelWithAction(lm_cfg, head)
    L = (tok_cfg.ctx_tokens_per_frame + 1) * ctx - 1 \
        + (tok_cfg.dyn_tokens_per_frame + 1) * (T - ctx)
    ids = jnp.zeros((1, L), jnp.int32)
    params = jax.jit(model.init)(jax.random.key(seed), ids, ids,
                                 jnp.zeros((1, T, 4), jnp.float32))
    params = jitter(to_numpy_tree(params), seed)
    port = TorchHead(port_config(lm_cfg), port_config(head))
    port.load_state_dict(port_ckpt.action_model_state_dict(params),
                         strict=True)
    return model, params, port.eval()


def _same_state_dict(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_tokenizer_bridge_matches_exporter_and_loads_strictly():
    _, params, port = make_tokenizer()  # strict load happens inside
    _same_state_dict(port_ckpt.tokenizer_state_dict(params),
                     jax_ckpt.flax_to_torch_tokenizer(params))
    # every port parameter came from the tree
    sd = port_ckpt.tokenizer_state_dict(params)
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)


def test_llama_bridge_matches_exporter():
    _, params, _ = make_lm()
    llm = {"params": params["params"]["llm"]}
    _same_state_dict(port_ckpt.llama_state_dict(llm),
                     jax_ckpt.flax_to_torch_llama(llm))


@pytest.mark.parametrize("heads", [(False, None), (True, 0.5)])
def test_action_model_bridge_matches_exporter_and_loads(heads):
    reward, recon = heads
    _, params, port = make_lm(reward_prediction=reward, action_recon=recon)
    _same_state_dict(port_ckpt.action_model_state_dict(params),
                     jax_ckpt.flax_to_torch_action_model(params))
    assert hasattr(port, "reward_linear") == reward
    assert hasattr(port, "action_recon_linear") == (recon is not None)


def test_configs_round_trip_through_json():
    from ivideogpt_tpu import configs as jcfg
    for name in ("TOKENIZER_64", "LLAMA_BASE", "LLAMA_MEDIUM"):
        ours, theirs = getattr(tcfg, name), getattr(jcfg, name)
        assert ours.to_json() == theirs.to_json()
        assert port_config(theirs) == ours
    assert tcfg.TOKENIZER_64.vocab_size == jcfg.TOKENIZER_64.vocab_size
    assert tcfg.TOKENIZER_64.ctx_tokens_per_frame == 256
    assert tcfg.LLAMA_BASE.head_dim == 64
    head = ActionModelConfig()
    assert port_config(head).prelude_tokens_num == head.prelude_tokens_num
