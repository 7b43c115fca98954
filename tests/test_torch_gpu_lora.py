"""LoRA training and the "dots" remat policy on the card, through K4, K5
and K6, against the CPU's plain path.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips when there is none. Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_lora.py

- the LoRA step (``train/gpt_trainer.lora_train_step`` over adapters
  attached by ``train/lora.attach``) in fp32 with attention dropout on
  the card and the CPU from the same base, adapters and batch: loss and
  every adapter's gradient, the base bit-unchanged;
- under ``remat_policy`` "dots" the card's forward products are what
  ``models/layers.Dense`` lowers to (``aten.mm``): the backward runs none
  of them again, K4 runs twice a layer (the forward's and the
  recompute's), K5 and K6 once, and the gradients equal no remat's bit for
  bit, with dropout, in bf16 and fp32, with adapters attached too.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ivideogpt_tpu_torch.configs import ActionModelConfig, TransformerConfig
from ivideogpt_tpu_torch.models.action_model import HeadModelWithAction
from ivideogpt_tpu_torch.ops import flash_attention as fa
from ivideogpt_tpu_torch.train import gpt_trainer as gt
from ivideogpt_tpu_torch.train import lora
from ivideogpt_tpu_torch.train.optim import TrainState

pytestmark = pytest.mark.gpu

# hd 64, the kernels' head width; 3 context tokens and 8 dynamics tokens a
# frame: L = 4 * 2 - 1 + 9 * 10 = 97
LM = TransformerConfig(vocab_size=96, hidden_size=128, intermediate_size=256,
                       num_hidden_layers=2, num_attention_heads=2,
                       num_key_value_heads=2, attention_dropout=0.1)
HEAD = ActionModelConfig(action_dim=4, context_length=2, segment_length=12,
                         tokens_per_context=3, tokens_per_dyna=8)
L = 4 * 2 - 1 + 9 * 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(cfg=LM, dtype=torch.float32, seed=0):
    torch.manual_seed(seed)
    m = HeadModelWithAction(cfg, HEAD, dtype=dtype)
    with torch.no_grad():
        m.action_linear.weight.normal_(0, 0.02)
    return m


def _batch(device, seed=1, B=3):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, LM.vocab_size, (B, L), generator=g)
    act = torch.randn(B, HEAD.segment_length, 4, generator=g)
    return {"input_ids": ids.to(device), "labels": ids.to(device),
            "action": act.to(device)}


def _adapters(model, seed=2):
    adapters = lora.init_lora(model, torch.Generator().manual_seed(seed),
                              rank=4, alpha=8.0)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name in adapters.names():
            adapters.b[name].copy_(torch.randn(adapters.b[name].shape,
                                               generator=g) * 0.05)
    return adapters


def test_lora_step_on_the_card_matches_the_cpu(cuda):
    grads, losses = {}, {}
    for dev in ("cpu", cuda):
        model = _model().to(dev)
        adapters = _adapters(model)
        base = {k: v.clone() for k, v in model.state_dict().items()}
        lora.attach(model, adapters)
        state = TrainState(adapters, learning_rate=1e-3, lr_scheduler="fixed",
                           weight_decay=0.01, embed_no_wd=False)
        m = gt.lora_train_step(state, model, _batch(dev), rng=(7, 3))
        losses[dev] = float(m["loss"])
        # AdamW's first moment is 0.1 of the clipped gradient
        grads[dev] = {n: state.optimizer.state[p]["exp_avg"].cpu()
                      for n, p in adapters.named_parameters()}
        after = lora.base_state_dict(model)
        assert all(torch.equal(after[k], v) for k, v in base.items())
    # fp32 on both; the kernels' three-term TF32 products and sums in
    # another order
    assert abs(losses[cuda] - losses["cpu"]) < 1e-5 * abs(losses["cpu"])
    for name, want in grads["cpu"].items():
        got = grads[cuda][name]
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale + 1e-12, name


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _run(model, batch, trained=None):
    fa.flash_fwd.launches = fa.flash_bwd_dkv.launches = 0
    fa.flash_bwd_dq.launches = 0
    model.train()
    model.zero_grad(set_to_none=True)
    loss = model(batch["input_ids"], batch["labels"], batch["action"],
                 dropout_key=(5, 2))["loss"]
    count = _Count()
    with count:
        loss.backward()
    params = (trained or model).named_parameters()
    return (loss.detach(), {n: p.grad.clone() for n, p in params},
            count.ops, (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches,
                        fa.flash_bwd_dq.launches))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_lora", [False, True])
def test_dots_recomputes_no_product_and_keeps_the_gradients(cuda, dtype,
                                                             with_lora):
    batch = _batch(cuda, seed=4)
    runs = {}
    for policy in ("plain", "none", "dots"):
        cfg = LM.replace(remat=policy != "plain",
                         remat_policy="none" if policy == "plain" else policy)
        model = _model(cfg, dtype).to(cuda)
        trained = None
        if with_lora:
            trained = _adapters(model)
            lora.attach(model, trained)
        runs[policy] = _run(model, batch, trained)
    loss0, g0, ops0, k0 = runs["plain"]
    layers = LM.num_hidden_layers
    assert k0 == (layers, layers, layers)
    mm = torch.ops.aten.mm.default
    for policy in ("none", "dots"):
        loss, grads, ops, launches = runs[policy]
        assert torch.equal(loss, loss0), policy
        for name, g in grads.items():
            assert torch.equal(g, g0[name]), (policy, name)
        # K4 once more a layer in the recompute
        assert launches == (2 * layers, layers, layers), policy
    assert runs["dots"][2][mm] == ops0[mm]
    merges = 7 if with_lora else 0
    assert runs["none"][2][mm] == ops0[mm] + (6 + merges) * layers
