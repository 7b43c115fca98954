"""``ivideogpt_tpu_torch/utils/profiling.py``, the port's span recorder, and
the spans the port opens:
- off (nothing records, no profiler) ``span`` is one shared null context
  that records nothing;
- under ``recording()`` the spans nest with the right parent and request
  ids on ``perf_counter_ns`` intervals, per thread, and close on an
  exception;
- a ``record_function`` range is opened only under an active profiler;
- ``generate`` opens a ``generation.lm_step`` a decode and a
  ``generation.sample`` a draw, ``rollout`` its stages, ``train_step`` and
  ``lora_train_step`` forward -> backward -> clip -> adamw, the tokenize
  function and the loader theirs; tokens, frames, losses and parameters
  are bit-identical with recording on and off;
- no span reads a tensor or waits for a device."""

import contextlib
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ivideogpt_tpu_torch import generation
from ivideogpt_tpu_torch import rollout as ro
from ivideogpt_tpu_torch.configs import (CompressiveVQConfig, GPTTrainConfig,
                                         TransformerConfig)
from ivideogpt_tpu_torch.data.npz_dataset import _PrefetchLoader
from ivideogpt_tpu_torch.train import gpt_trainer as gt
from ivideogpt_tpu_torch.train import lora
from ivideogpt_tpu_torch.utils import profiling

TOK = CompressiveVQConfig(
    block_out_channels=(16, 32, 32), layers_per_block=1, latent_channels=8,
    num_vq_embeddings=64, num_dyn_embeddings=64, norm_num_groups=8,
    mid_block_add_attention=False, context_length=2, resolution=32,
    max_att_resolution=8, patch_size=4)
LM = TransformerConfig(
    vocab_size=TOK.vocab_size, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
    max_position_embeddings=2048)
B, CTX, T = 2, 2, 5
F, D = T - CTX, TOK.dyn_tokens_per_frame


def names(spans):
    return Counter(s[3] for s in spans)


@pytest.fixture(scope="module")
def models():
    return ro.build_models(TOK, LM, context_length=CTX, segment_length=T,
                           dtype=torch.float32, seed=0, device="cpu")


@pytest.fixture(scope="module")
def inputs():
    g = torch.Generator().manual_seed(3)
    return (torch.rand((B, CTX, 32, 32, 3), generator=g),
            torch.randn((B, T, 4), generator=g))


def test_off_path_is_one_shared_null_context_that_records_nothing():
    first = profiling.span("a")
    assert first is profiling.span("b") is profiling._NULL
    with profiling.span("a"):
        with profiling.span("b"):
            pass
    with profiling.recording() as spans:
        pass
    assert spans == []
    assert profiling.span("a") is profiling._NULL


def test_nesting_gives_parent_and_request_ids_on_perf_counter_ns():
    before = time.perf_counter_ns()
    with profiling.recording() as spans:
        with profiling.span("step"):
            with profiling.span("forward"):
                with profiling.span("inner"):
                    pass
            with profiling.span("backward"):
                pass
        with profiling.span("next"):
            pass
    after = time.perf_counter_ns()
    assert [s[3] for s in spans] == ["inner", "forward", "backward", "step",
                                     "next"]
    by = {s[3]: s for s in spans}
    step, fwd, inner, bwd, nxt = (by[n] for n in ("step", "forward", "inner",
                                                  "backward", "next"))
    assert step[1] == -1 and step[2] == step[0]
    assert fwd[1] == step[0] and bwd[1] == step[0] and inner[1] == fwd[0]
    assert {fwd[2], bwd[2], inner[2]} == {step[0]}
    assert nxt[1] == -1 and nxt[2] == nxt[0] != step[0]
    assert len({s[0] for s in spans}) == len(spans)
    assert before <= step[4] <= fwd[4] <= inner[4] <= inner[5] <= fwd[5] \
        <= bwd[4] <= bwd[5] <= step[5] <= nxt[4] <= nxt[5] <= after


def test_recording_is_not_reentrant_and_ends_with_its_block():
    with profiling.recording():
        with pytest.raises(RuntimeError, match="already on"):
            with profiling.recording():
                pass
    assert profiling.span("x") is profiling._NULL


def test_a_span_closes_on_an_exception():
    with profiling.recording() as spans:
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("failing"):
                    raise ValueError("in the block")
        with profiling.span("after"):
            pass
    assert [(s[3], s[1]) for s in spans] == [
        ("failing", spans[1][0]), ("outer", -1), ("after", -1)]


def test_spans_of_another_thread_keep_their_own_parents():
    opened = threading.Event()
    close = threading.Event()

    def work():
        with profiling.span("worker"):
            opened.set()
            assert close.wait(10)

    with profiling.recording() as spans:
        with profiling.span("main"):
            t = threading.Thread(target=work)
            t.start()
            assert opened.wait(10)
            with profiling.span("main.child"):
                pass
            close.set()
            t.join(10)
    assert not t.is_alive()
    by = {s[3]: s for s in spans}
    assert by["worker"][1] == -1 and by["worker"][2] == by["worker"][0]
    assert by["main.child"][1] == by["main"][0]


def test_profiler_range_only_under_an_active_profiler(monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    with profiling.recording():
        with profiling.span("recorded.only"):
            pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("ivg.region"):
            torch.ones(8).add_(1)
    assert opened == ["ivg.region"]
    assert "ivg.region" in {e.key for e in prof.key_averages()}


def _generate(lm, gen_seed, action=None, action_fn=None):
    g = torch.Generator().manual_seed(11)
    P1 = (TOK.ctx_tokens_per_frame + 1) * CTX
    prelude = torch.randint(0, TOK.num_vq_embeddings, (B, P1), generator=g)
    prelude[:, TOK.ctx_tokens_per_frame::TOK.ctx_tokens_per_frame + 1] = \
        LM.vocab_size - 1
    return generation.generate(
        lm, prelude, segment_length=T, context_length=CTX,
        generator=torch.Generator().manual_seed(gen_seed), action=action,
        action_fn=action_fn, tokens_per_dyna=D, top_k=10)


@pytest.mark.parametrize("path", ["action", "action_fn"])
def test_generate_span_counts_and_tokens_on_and_off(models, inputs, path):
    _, lm = models
    act = inputs[1]
    kw = ({"action": act} if path == "action"
          else {"action_fn": lambda f: act[:, CTX - 1 + f]})
    off = _generate(lm, 5, **kw)
    with profiling.recording() as spans:
        on = _generate(lm, 5, **kw)
    assert torch.equal(off.tokens, on.tokens)
    # a given action rides the prelude's sdf, so frame 0 decodes no sdf;
    # the last sampled token is never decoded
    lm_steps = F * (D + 1) - (2 if path == "action" else 1)
    assert names(spans) == {"generation.prefill": 1, "generation.decode": F,
                            "generation.lm_step": lm_steps,
                            "generation.sample": F * D}
    decodes = {s[0] for s in spans if s[3] == "generation.decode"}
    assert all(s[1] in decodes for s in spans
               if s[3] in ("generation.lm_step", "generation.sample"))


def test_decode_ranges_seen_by_a_cpu_profiler(models):
    _, lm = models
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _generate(lm, 5)
    keys = {e.key: e.count for e in prof.key_averages()}
    assert keys["generation.prefill"] == 1
    assert keys["generation.decode"] == F
    assert keys["generation.sample"] == F * D
    assert keys["generation.lm_step"] == F * (D + 1) - 2


def test_rollout_stages_on_and_off(models, inputs):
    tok, lm = models

    def run():
        return ro.rollout(tok, lm, *inputs, segment_length=T,
                          generator=torch.Generator().manual_seed(2),
                          cache_dtype=torch.int8, top_k=10, detok_chunk=1)

    off = run()
    with profiling.recording() as spans:
        on = run()
    assert torch.equal(off.tokens, on.tokens)
    assert torch.equal(off.frames, on.frames)
    by = {s[3]: s for s in spans}
    root = by["rollout"]
    assert root[1] == -1 and all(s[2] == root[0] for s in spans)
    stages = ["rollout.tokenize", "rollout.generate", "rollout.detokenize"]
    assert [by[n][1] for n in stages] == [root[0]] * 3
    assert [by[n][4] for n in stages] == sorted(by[n][4] for n in stages)
    assert by["generation.prefill"][1] == by["rollout.generate"][0]


def _train(lora_run: bool, record: bool):
    tok, model = gt.build_train_models(
        TOK, LM, context_length=CTX, segment_length=T,
        compute_dtype=torch.float32, seed=4, device="cpu")
    cfg = GPTTrainConfig(learning_rate=1e-3, lr_warmup_steps=1,
                         max_train_steps=10, max_grad_norm=1e-3)
    if lora_run:
        adapters = lora.init_lora(model, torch.Generator().manual_seed(6))
        lora.attach(model, adapters)
        state = gt.create_lora_train_state(adapters, cfg)
    else:
        state = gt.create_train_state(model, cfg)
    tokenize = gt.make_tokenize_fn(tok, CTX)
    px = torch.rand((B, T, 32, 32, 3),
                    generator=torch.Generator().manual_seed(8))
    act = torch.randn((B, T, 4), generator=torch.Generator().manual_seed(9))
    losses = []
    with (profiling.recording() if record
          else contextlib.nullcontext([])) as spans:
        for step in range(2):
            ids, labels = tokenize(px)
            batch = {"input_ids": ids, "labels": labels, "action": act}
            m = (gt.lora_train_step(state, model, batch, rng=(1, step))
                 if lora_run else
                 gt.train_step(state, batch, rng=(1, step)))
            losses.append(m["loss"])
    return losses, [p.detach().clone() for p in state.params], spans


@pytest.mark.parametrize("lora_run", [False, True], ids=["full", "lora"])
def test_train_steps_record_their_parts_in_order_on_and_off(lora_run):
    loss_off, params_off, _ = _train(lora_run, record=False)
    loss_on, params_on, spans = _train(lora_run, record=True)
    assert all(torch.equal(a, b) for a, b in zip(loss_off, loss_on))
    assert all(torch.equal(a, b) for a, b in zip(params_off, params_on))
    steps = sorted((s for s in spans if s[3] == "train.step"),
                   key=lambda s: s[4])
    assert len(steps) == 2 and all(s[1] == -1 for s in steps)
    for st in steps:
        parts = sorted((s for s in spans if s[2] == st[0] and s != st),
                       key=lambda s: s[4])
        assert all(s[1] == st[0] for s in parts)
        order = [s[3] for s in parts]
        clips = ["train.clip"] if lora_run else ["train.clip"] * 2
        assert order == (["train.forward", "train.backward"] + clips
                         + ["train.adamw"])
        assert all(a[5] <= b[4] for a, b in zip(parts, parts[1:]))
    tokenizes = [s for s in spans if s[3] == "train.tokenize"]
    assert len(tokenizes) == 2 and all(s[1] == -1 for s in tokenizes)


def test_loader_wait_is_a_span():
    loader = _PrefetchLoader([lambda: np.zeros(3, np.float32)],
                             batch_size=2)
    try:
        with profiling.recording() as spans:
            batch = next(loader)
        wait = loader.wait_s
    finally:
        loader.close()
    assert batch.shape == (2, 3)
    assert [(s[3], s[1]) for s in spans] == [("data.wait", -1)]
    assert 0 <= wait <= (spans[0][5] - spans[0][4]) / 1e9


class Untouchable(torch.Tensor):
    """Fails on any read of its values: a span that touched it would
    raise."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("item", "tolist", "__bool__", "__float__", "__int__",
                    "numpy", "cpu", "to", "__repr__", "__format__"):
            raise AssertionError(f"{name} read the tensor")
        return super().__torch_function__(func, types, args, kwargs or {})


def test_no_span_reads_a_tensor_or_waits(monkeypatch):
    def no_sync(*a, **kw):
        raise AssertionError("a span synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(torch.Tensor, "item", no_sync)
    x = torch.ones(4).as_subclass(Untouchable)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.recording() as spans:
            with profiling.span("outer"):
                with profiling.span("inner"):
                    y = x * 2
    with profiling.span("off"):
        z = y + 1
    assert type(z) is Untouchable
    assert [s[3] for s in spans] == ["inner", "outer"]
