"""The "dots" remat policy of the port's LLaMA (``models/llama.py``) on the
CPU, in fp32 at tiny widths:

- loss and every gradient against the JAX model under ``remat_policy=
  "dots"`` (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``,
  as ``tests/test_llama.py``'s dots test runs it), and bit-equal to the
  port's own gradients without remat, with attention dropout too;
- what the backward recomputes, counted by a dispatch mode: under "dots"
  it runs the forward's matrix products again nowhere (the backward's
  ``aten.mm`` count equals no remat's), under "none" six of a layer's
  seven (the recompute stops once the backward has what it needs, before
  ``down_proj``), and both recompute the attention's batched products;
- with LoRA adapters attached, "dots" keeps the merges' products too and
  gives the adapters no-remat's gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ivideogpt_tpu_torch.models.action_model import \
    HeadModelWithAction as TorchHead
from ivideogpt_tpu_torch.train import lora
from ivideogpt_tpu_torch.utils import checkpoint as port_ckpt
from tests.test_torch_checkpoint import LM_TINY, make_lm
from tests.test_torch_train import _batch, _jax_out

DOTS = LM_TINY.replace(remat=True, remat_policy="dots")


@pytest.fixture(scope="module")
def dots_lm():
    return make_lm(lm_cfg=DOTS, seed=9, action_recon=0.5)


def _variant(port, remat, policy="none", dropout=0.0):
    m = TorchHead(port.llm_config.replace(remat=remat, remat_policy=policy,
                                          attention_dropout=dropout),
                  port.head_config)
    m.load_state_dict(port.state_dict())
    return m.train()


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _step(model, batch, key=None, trained=None):
    """(loss, gradients of ``trained`` (the model's own parameters by
    default) by name, the backward's ops by count, the forward's)."""
    ids, labels, act = batch
    forward, backward = _Count(), _Count()
    with forward:
        loss = model(ids, labels, torch.from_numpy(act),
                     dropout_key=key)["loss"]
    with backward:
        loss.backward()
    params = (trained or model).named_parameters()
    return (loss.detach(), {n: torch.zeros_like(p) if p.grad is None
                            else p.grad for n, p in params}, backward.ops,
            forward.ops)


def test_dots_gradients_match_jax_dots(dots_lm):
    model, params, port = dots_lm
    assert model.llm_config.remat_policy == "dots"
    assert port.llm_config.remat_policy == "dots"
    ids, labels, act = batch = _batch(6)
    loss, jgrads = jax.value_and_grad(
        lambda p: _jax_out(model, p, ids, labels, act)["loss"])(params)
    ref = port_ckpt.action_model_state_dict(
        jax.tree_util.tree_map(np.asarray, jgrads))
    got_loss, grads, *_ = _step(port.train(), batch)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    assert sorted(grads) == sorted(ref)
    for name, g in grads.items():
        want = ref[name].numpy()
        # fp32 sums in another order: within 1e-4 of the gradient's max
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * scale + 1e-12, err_msg=name)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_dots_gradients_equal_no_remat(dots_lm, dropout):
    """The same ops on the same inputs (the kept products are the
    forward's own; a recomputed mask is (seed, step, layer)'s): bit-equal
    on the CPU."""
    _, _, port = dots_lm
    batch = _batch(7)
    key = (5, 3) if dropout else None
    runs = [_step(_variant(port, remat, policy, dropout), batch, key)
            for remat, policy in ((False, "none"), (True, "none"),
                                  (True, "dots"))]
    (l0, g0, *_), *rest = runs
    for loss, grads, *_ in rest:
        assert torch.equal(loss, l0)
        for name, g in grads.items():
            assert torch.equal(g, g0[name]), name
    if dropout:
        # the masks act: another key gives another loss
        other = _step(_variant(port, False, dropout=dropout), batch, (5, 4))
        assert not torch.equal(other[0], l0)


def test_backward_recomputes_no_product_under_dots(dots_lm):
    _, _, port = dots_lm
    batch = _batch(8)
    layers = port.llm_config.num_hidden_layers
    runs = {policy: _step(_variant(port, remat, policy), batch)
            for remat, policy in ((False, "plain"), (True, "none"),
                                  (True, "dots"))}
    ops = {policy: run[2] for policy, run in runs.items()}
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    plain = ops["plain"][mm]
    assert plain > 0
    assert runs["plain"][3][mm] == 7 * layers + 2   # + lm_head, the loss's
    assert ops["dots"][mm] == plain
    assert ops["none"][mm] == plain + 6 * layers
    # the plain attention's batched products (q k^T, p v by query chunk)
    # run again under both policies, as under JAX's, where dots with batch
    # dims are not kept
    fwd_bmm = runs["plain"][3][bmm]
    assert fwd_bmm >= 2 * layers
    for policy in ("none", "dots"):
        assert ops[policy][bmm] == ops["plain"][bmm] + fwd_bmm


def test_dots_with_lora_adapters(dots_lm):
    _, _, port = dots_lm
    batch = _batch(9)
    runs = []
    for remat, policy in ((False, "none"), (True, "dots"), (True, "none")):
        m = _variant(port, remat, policy)
        adapters = lora.init_lora(m, torch.Generator().manual_seed(2),
                                  rank=4)
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for name in adapters.names():
                adapters.b[name].normal_(0, 0.05, generator=g)
        lora.attach(m, adapters)
        runs.append(_step(m, batch, trained=adapters))
    (l0, g0, ops0, _), (l1, g1, ops1, _), (_, _, ops2, _) = runs
    assert torch.equal(l0, l1)
    for name, g in g1.items():
        assert torch.equal(g, g0[name]), name
    mm = torch.ops.aten.mm.default
    layers = port.llm_config.num_hidden_layers
    assert ops1[mm] == ops0[mm]
    # "none" also merges each of a layer's seven weights again
    assert ops2[mm] == ops0[mm] + (6 + 7) * layers


def test_unknown_policy_raises(dots_lm):
    _, _, port = dots_lm
    ids, labels, act = _batch(0)
    with pytest.raises(ValueError, match="remat_policy"):
        _variant(port, True, "everything")(ids, labels,
                                           torch.from_numpy(act))
