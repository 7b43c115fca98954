"""LoRA training of the PyTorch port (``ivideogpt_tpu_torch/train/lora.py``,
``train/gpt_trainer.lora_train_step``) against ``ivideogpt_tpu/train/
lora.py`` on the CPU, in fp32 at tiny widths:

- ``init_lora`` makes the JAX package's names and shapes, ``b`` = 0;
- the attached model computes on the merged weights: logits equal to the
  JAX model's on ``merge(params, lora)``;
- three LoRA steps (the first at the warmup's lr 0) from the same base,
  adapters (carried by ``lora_from_jax``) and batch, attention dropout 0.1
  fed the same masks: the loss and the adapters of
  ``make_lora_train_step`` with ``make_optimizer(embed_no_wd=False,
  ...)``; the base bit-unchanged; the embedding's adapter decayed;
- ``lora.safetensors`` folded by ``merge`` equals the attached model, and
  ``detach`` gives the base Parameters back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu.train import lora as jlora
from ivideogpt_tpu.train import optim as joptim
from ivideogpt_tpu_torch.models.action_model import \
    HeadModelWithAction as TorchHead
from ivideogpt_tpu_torch.train import gpt_trainer as ttrain
from ivideogpt_tpu_torch.train import lora
from ivideogpt_tpu_torch.configs import GPTTrainConfig
from ivideogpt_tpu_torch.utils import safetensors
from tests.test_torch_checkpoint import LM_TINY, make_lm
from tests.test_torch_flash_dropout import _patched_bernoulli, _port_masks
from tests.test_torch_train import _batch

RANK, ALPHA = 4, 16.0


@pytest.fixture(scope="module")
def lm():
    return make_lm(lm_cfg=LM_TINY.replace(attention_dropout=0.1), seed=7)


def _port_copy(port):
    m = TorchHead(port.llm_config, port.head_config)
    m.load_state_dict(port.state_dict())
    return m


def _jax_adapters(params, seed=1, b_std=0.0):
    """JAX's adapters; ``b`` drawn nonzero where asked, so that the merge
    has something to show."""
    tree = jlora.init_lora(params, jax.random.key(seed), rank=RANK)
    rng = np.random.default_rng(seed)
    return {k: {"a": np.asarray(v["a"]),
                "b": (np.asarray(v["b"])
                      + rng.normal(0, b_std, v["b"].shape)).astype(np.float32)}
            for k, v in tree.items()}


def test_init_lora_makes_the_jax_names_and_shapes(lm):
    _, params, port = lm
    want = jlora.init_lora(params, jax.random.key(0), rank=RANK)
    got = lora.init_lora(port, torch.Generator().manual_seed(0), rank=RANK,
                         alpha=ALPHA)
    assert sorted(got.names()) == sorted(want)
    assert any(n.endswith("embed_tokens/embedding") for n in want)
    assert any(n.endswith("lm_head/kernel") for n in want)
    assert not any("action_linear" in n or "norm" in n for n in want)
    for name, ab in want.items():
        assert tuple(got.a[name].shape) == ab["a"].shape, name
        assert tuple(got.b[name].shape) == ab["b"].shape, name
        assert not got.b[name].any(), name
    a = torch.cat([got.a[n].flatten() for n in got.names()])
    # N(0, 0.02) over ~10^4 draws: the std within 5 %
    assert abs(float(a.detach().std()) / 0.02 - 1) < 0.05
    again = lora.init_lora(port, torch.Generator().manual_seed(0), rank=RANK)
    assert all(torch.equal(again.a[n], got.a[n]) for n in got.names())


def test_attached_model_computes_on_the_jax_merge(lm):
    model, params, port = lm
    tree = _jax_adapters(params, b_std=0.05)
    adapters = lora.lora_from_jax(tree, alpha=ALPHA)
    assert adapters.rank == RANK and adapters.scale == ALPHA / RANK
    merged = jlora.merge(params, tree, ALPHA, RANK)
    ids, labels, act = _batch(3)
    ref = model.apply(merged, jnp.asarray(ids.numpy(), jnp.int32),
                      jnp.asarray(labels.numpy(), jnp.int32),
                      jnp.asarray(act))
    m = lora.attach(_port_copy(port).eval(), adapters)
    with torch.no_grad():
        out = m(ids, labels, torch.from_numpy(act))
    # fp32 on both sides, the merge's and the matmuls' sums in another
    # order
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(ref["logits"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(out["loss"]), float(ref["loss"]),
                               rtol=1e-5)
    for k, v in tree.items():
        for leaf in "ab":
            np.testing.assert_array_equal(
                getattr(adapters, leaf)[k].detach().numpy(), v[leaf])


def test_lora_steps_match_make_lora_train_step(lm, monkeypatch):
    model, params, port = lm
    cfg = port.llm_config
    tree = _jax_adapters(params, seed=2)
    ids, labels, act = _batch(5)
    B, S = ids.shape
    seed = 11
    masks = [m for step in range(3)
             for m in _port_masks(cfg, B, S, seed, step)]
    calls = []
    _patched_bernoulli(monkeypatch, masks, calls)

    kw = dict(learning_rate=1e-4, lr_scheduler="constant", warmup_steps=0,
              total_steps=10, weight_decay=0.01, max_grad_norm=1.0)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    tx, _ = joptim.make_optimizer(jtree, embed_no_wd=False, **kw)
    opt = tx.init(jtree)
    step = jlora.make_lora_train_step(model, tx, action_conditioned=True,
                                      alpha=ALPHA, rank=RANK)
    jbatch = {"input_ids": jnp.asarray(ids.numpy(), jnp.int32),
              "labels": jnp.asarray(labels.numpy(), jnp.int32),
              "action": jnp.asarray(act)}

    base = _port_copy(port)
    before = {k: v.clone() for k, v in base.state_dict().items()}
    adapters = lora.lora_from_jax(tree, alpha=ALPHA)
    lora.attach(base, adapters)
    state = ttrain.create_lora_train_state(adapters, GPTTrainConfig(
        learning_rate=kw["learning_rate"], lr_scheduler="constant",
        lr_warmup_steps=0, max_train_steps=10, weight_decay=0.01,
        max_grad_norm=1.0))
    assert all(g["weight_decay"] == 0.01
               for g in state.optimizer.param_groups)
    assert len(state.params) == 2 * len(tree)
    batch = {"input_ids": ids, "labels": labels,
             "action": torch.from_numpy(act)}
    embed = "params/llm/embed_tokens/embedding"
    for i in range(3):
        a_before = adapters.a[embed].detach().clone()
        # flax draws every layer's mask at trace time: run the step eagerly
        with jax.disable_jit():
            jtree, opt, jm = step(params, jtree, opt, jbatch,
                                  jax.random.key(i))
        m = ttrain.lora_train_step(state, base, batch, rng=(seed, i))
        assert set(m) == set(jm) == {"loss", "perplexity"}
        # fp32 sums in another order
        for key in ("loss", "perplexity"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"step {i} {key}")
        for name, ab in jtree.items():
            for leaf in "ab":
                got = getattr(adapters, leaf)[name].detach().numpy()
                # Adam's early steps move an element by ~lr whatever its
                # gradient's size: within 1e-2 lr
                np.testing.assert_allclose(
                    got, np.asarray(ab[leaf]), rtol=0, atol=1e-6,
                    err_msg=f"step {i} {name}/{leaf}")
        if i == 1:
            # b = 0 gave every a a zero gradient: the first update (lr 1e-4)
            # only decays it, the embedding's pair too
            assert torch.equal(adapters.a[embed].detach(),
                               a_before * (1 - 1e-4 * 0.01))
            assert all(adapters.b[n].abs().max() > 0 for n in tree)
    assert len(calls) == 3 * cfg.num_hidden_layers
    assert state.updates == 3
    after = lora.base_state_dict(base)
    assert sorted(after) == sorted(before)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
        assert not after[k].requires_grad, k


def test_lora_file_folds_to_the_attached_model(lm, tmp_path):
    _, params, port = lm
    tree = _jax_adapters(params, seed=3, b_std=0.05)
    adapters = lora.lora_from_jax(tree, alpha=ALPHA)
    attached = lora.attach(_port_copy(port).eval(), adapters)
    path = str(tmp_path / "lora.safetensors")
    lora.save_lora(adapters, path)
    flat = safetensors.load_file(path)
    assert sorted(flat) == sorted(f"{k}/{leaf}" for k in tree
                                  for leaf in "ab")
    folded = lora.merge(_port_copy(port).eval(), flat, alpha=ALPHA,
                        rank=RANK)
    merged = dict(folded.named_parameters())
    with torch.no_grad():
        for name, _ in port.named_parameters():
            # the same fp32 product and add
            torch.testing.assert_close(_read(attached, name), merged[name],
                                       rtol=0, atol=0, msg=name)
    base_params = {n: p for n, p in attached.named_parameters()}
    lora.detach(attached)
    sd = dict(attached.named_parameters())
    assert sorted(sd) == sorted(n for n, _ in port.named_parameters())
    # the very Parameters that held the base, unchanged
    for name, p in sd.items():
        assert any(p is q for q in base_params.values()), name
        assert torch.equal(p, port.get_parameter(name)), name


def _read(model, name):
    """The value a (possibly parametrized) parameter reads as."""
    module, _, attr = name.rpartition(".")
    return getattr(model.get_submodule(module), attr)


def test_attach_refuses_what_it_cannot_fold(lm):
    _, params, port = lm
    tree = _jax_adapters(params)
    bad = dict(tree)
    bad["params/llm/layers_9/self_attn/q_proj/kernel"] = tree[
        "params/llm/layers_0/self_attn/q_proj/kernel"]
    with pytest.raises(ValueError, match="no parameter"):
        lora.attach(_port_copy(port), lora.lora_from_jax(bad))
    m = lora.attach(_port_copy(port), lora.lora_from_jax(tree))
    with pytest.raises(ValueError, match="already"):
        lora.attach(m, lora.lora_from_jax(tree))


def test_transformer_loaders_skip_the_adapter_file(lm, tmp_path):
    """``lora.safetensors`` beside a transformer's weights (the layout the
    trainer exports and ``vp/interface`` reads) is not read as weights."""
    from ivideogpt_tpu_torch.utils import checkpoint as ckpt
    _, params, port = lm
    adapters = lora.lora_from_jax(_jax_adapters(params, b_std=0.05))
    for name, sd in (("head", port.state_dict()),
                     ("bare", port.llm.state_dict())):
        d = tmp_path / name
        d.mkdir()
        safetensors.save_file(sd, str(d / ckpt.TRANSFORMER_FILE))
        lora.save_lora(adapters, str(d / ckpt.LORA_FILE))
    loaded = {"action model": ckpt.load_action_model_safetensors(
                  str(tmp_path / "head")),
              "its LLaMA": ckpt.load_llm_only_safetensors(
                  str(tmp_path / "head")),
              "a bare LLaMA": ckpt.load_llama_safetensors(
                  str(tmp_path / "bare"))}
    for what, got in loaded.items():
        want = (port.state_dict() if what == "action model"
                else port.llm.state_dict())
        assert sorted(got) == sorted(want), what
        assert all(torch.equal(got[k], v) for k, v in want.items()), what
