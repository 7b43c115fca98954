"""The plain reference against the port on the CPU at a tiny configuration,
both in fp32 on the same weights (this test imports both; the reference
imports nothing of the port): the tokenizer's ids and render, the LM's
logits, a training step's loss and gradients with attention dropout, and
AdamW behind the clip; Philox4x32-10 against Random123's answers."""

import pytest
import torch

from benchmark import weights as wt
from benchmark.reference import adamw, philox
from benchmark.reference.llama import LM, loss_and_grads, loss_sum
from benchmark.reference.numerics import Precision, fp8_round
from benchmark.reference.params import tok_dims
from benchmark.reference.stream import assemble
from benchmark.reference.tokenizer import Tokenizer, nearest
from benchmark.tests import tiny

CTX, T, B = 2, 5, 2


@pytest.fixture(scope="module")
def models():
    cfg = tiny.config()
    tw = wt.tokenizer_weights(cfg, 3, "cpu", serving=False)
    lw = wt.lm_weights(cfg, 3, "cpu", serving=False)
    g = torch.Generator().manual_seed(0)
    px = torch.rand(B, T, 64, 64, 3, generator=g)
    act = torch.randn(B, T, 4, generator=g)
    return cfg, tw, lw, px, act


def _ref_tokens(cfg, tw, px):
    t = cfg["tokenizer"]
    tok = Tokenizer(tw, t, Precision("fp32"))
    z, feats = tok.context_latents(px[:, :CTX].flatten(0, 1))
    ic = nearest(z, tw["quantize.embedding.weight"])[0]
    zd = tok.dynamics_latents(px[:, CTX:].flatten(0, 1), feats, CTX)
    idd = nearest(zd, tw["dynamics_quantize.embedding.weight"])[0]
    return tok, assemble(ic.view(B, CTX, -1), idd.view(B, T - CTX, -1), t)


@torch.no_grad()
def test_tokenizer_ids_and_render(models):
    cfg, tw, lw, px, act = models
    port = wt.port_tokenizer(cfg, tw, torch.float32).eval()
    ids, labels = port.tokenize(px, CTX)
    tok, (rids, rlabels) = _ref_tokens(cfg, tw, px)
    assert torch.equal(ids, rids) and torch.equal(labels, rlabels)
    frames = port.detokenize(ids, CTX)
    ref = tok.render_stream(ids, CTX)
    assert ((frames - ref).norm() / ref.norm()) < 1e-5


@torch.no_grad()
def test_lm_logits(models):
    cfg, tw, lw, px, act = models
    port = wt.port_tokenizer(cfg, tw, torch.float32).eval()
    ids, labels = port.tokenize(px, CTX)
    lm = wt.port_lm(cfg, lw, torch.float32).eval()
    out = lm(ids, labels, act)
    ref = LM(lw, cfg["transformer"], (CTX, T, tok_dims(cfg["tokenizer"])),
             Precision("fp32"))
    logits = ref.forward(ids, act)
    assert (out["logits"] - logits).abs().max() < 1e-4
    s, n = loss_sum(logits, labels)
    assert float(s / n) == pytest.approx(float(out["loss"]), rel=1e-6)


def test_training_step_with_dropout(models):
    from ivideogpt_tpu_torch.train import gpt_trainer as gt
    cfg, tw, lw, px, act = models
    port_tok = wt.port_tokenizer(cfg, tw, torch.float32).eval()
    ids, labels = port_tok.tokenize(px, CTX)
    start = {n: v.clone() for n, v in lw.items()}
    lm = wt.port_lm(cfg, lw, torch.float32, attention_dropout=0.1).train()
    recipe = dict(tiny.train_mix("finetune-bair-b16")["recipe"],
                  learning_rate=1e-3, lr_scheduler="cosine", warmup_steps=0,
                  max_train_steps=100)
    from benchmark.cells.gpttrain import recipe_config
    state = gt.create_train_state(lm, recipe_config(recipe))
    seed = 2 ** 40 + 3
    out = lm(ids, labels, act, dropout_key=(seed, 5))
    out["loss"].backward()
    grads = {n: p.grad.clone() for n, p in lm.named_parameters()}

    params = {n: v.clone().requires_grad_(True) for n, v in start.items()}
    ref = LM(params, cfg["transformer"], (CTX, T, tok_dims(cfg["tokenizer"])),
             Precision("fp32"))
    loss, rgrads = loss_and_grads(ref, ids, labels, act, (0.1, seed, 5),
                                  rows=1, params=params)
    assert loss == pytest.approx(float(out["loss"].detach()), rel=1e-5)
    for n, g in rgrads.items():
        assert (grads[n] - g).norm() <= 1e-4 * (g.norm() + 1e-6), n
    # a wrong mask (the next step's) is far off
    other, _ = loss_and_grads(ref, ids, labels, act, (0.1, seed, 6),
                              rows=2, params=params)
    assert abs(other - loss) > 100 * abs(loss - float(out["loss"].detach()))

    # two clipped AdamW updates (the first at lr 0) from the same gradients
    opt = adamw.AdamW(params, recipe)
    with torch.no_grad():
        for n, p in lm.named_parameters():
            p.copy_(start[n])
    for _ in range(2):
        for n, p in lm.named_parameters():
            p.grad = rgrads[n].clone()
        state.apply_gradients()
        opt.step(params, adamw.clip(rgrads, recipe["max_grad_norm"])[0])
    for n, p in lm.named_parameters():
        moved = (params[n] - start[n]).abs().max()
        assert (p.detach() - params[n]).abs().max() <= 1e-3 * moved + 1e-9, n


KAT = [((0, 0, 0, 0), (0, 0),
        (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
       ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
        (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
       ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
        (0xa4093822, 0x299f31d0),
        (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    c = [torch.tensor([x], dtype=torch.int64) for x in ctr]
    got = philox.philox(*c, *key)
    assert tuple(int(w) for w in got) == want


def test_mask_matches_the_port():
    from ivideogpt_tpu_torch.ops import philox as port
    seed, off = 2 ** 35 + 11, philox.layer_offset(3, 1)
    ref = philox.keep_scale(0.1, seed, off, 1, 2, 3, 9) > 0
    got = port.keep_mask((0.1, seed, off, 1, 0, 3), 2, 3, 9, 0, 9, 0, 9)
    assert torch.equal(ref, got)


def test_fp8_round():
    x = torch.tensor([448.0, -1.0, 0.0, 3.3])
    y = fp8_round(x)
    assert y[0] == 448.0 and y[2] == 0.0 and y[3] != 3.3
