"""The batch rollout: ``ivideogpt_tpu_torch.rollout.rollout`` on batches of
context frames and actions, back to back, as a batch-imagination caller
drives it (a closed loop of one caller that waits for each rollout's
frames).

Set-up: the kernels built (the first run in a checkout) or loaded, the
weights drawn on the card in the dtypes they are served in, the models
built around them, the inputs made, one rollout to warm up every shape.
The window: rollouts until ``--seconds`` have passed, each waited for.
``frames_per_s`` counts the generated (future) frames of the rollouts
the window completed over the window's seconds.

``correct``: once the window has closed and the program is freed, a
sample of rows, two drawn from each rollout by the seed and then 16 of
those, is held against the fp32 reference (:func:`judge`): the context
ids their stream carries against the reference encoder's nearest codes,
every sampled token against the reference's top-k set of the logits
teacher-forced on the same stream, and the frames against the
reference's render of the stream.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import generate, weights
from benchmark.harness import Spans, patched, phase
from benchmark.reference.llama import LM
from benchmark.reference.numerics import Precision
from benchmark.reference.params import tok_dims
from benchmark.reference.stream import sampled_positions, split_stream
from benchmark.reference.tokenizer import Tokenizer, distance_to, nearest
from benchmark.trace import Trace, traced


def cache_dtype(name: str):
    return {"int8": torch.int8, "bf16": torch.bfloat16}[name]


def build(cfg: dict, mix: dict, seed: int, device):
    """The program's models, in bf16 under its cast rules, and a call that
    runs rollout i on input batch i mod ``distinct_batches``."""
    from ivideogpt_tpu_torch import rollout as ro
    tok = weights.port_tokenizer(
        cfg, weights.tokenizer_weights(cfg, seed, device, serving=True),
        torch.bfloat16).eval()
    lm = weights.port_lm(
        cfg, weights.lm_weights(cfg, seed, device, serving=True),
        torch.bfloat16).eval()
    inputs = generate.rollout_inputs(cfg, mix, seed, device)
    gen = torch.Generator(device=device).manual_seed(
        generate.sub_seed(seed, 3))

    def one(i):
        px, act = inputs[i % len(inputs)]
        return ro.rollout(tok, lm, px, act,
                          segment_length=cfg["segment_length"], generator=gen,
                          cache_dtype=cache_dtype(mix["cache"]),
                          top_k=mix["top_k"], temperature=mix["temperature"],
                          detok_chunk=mix["detok_chunk"])
    return tok, lm, inputs, one


@contextlib.contextmanager
def stage_spans(tok, spans: Spans):
    """Time the three stages ``rollout.rollout`` calls, each synchronised:
    the context encode and its prelude (tokenize), ``generation.generate``
    and ``rollout.detokenize``."""
    from ivideogpt_tpu_torch import generation, tokens
    from ivideogpt_tpu_torch import rollout as ro
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(tok, "encode_context", spans.wrap(
            "tokenize", tok.encode_context)))
        stack.enter_context(patched(tokens, "make_prelude", spans.wrap(
            "tokenize", tokens.make_prelude)))
        stack.enter_context(patched(generation, "generate", spans.wrap(
            "generate", generation.generate)))
        stack.enter_context(patched(ro, "detokenize", spans.wrap(
            "detokenize", ro.detokenize)))
        yield
    # encode_context was an instance attribute only while patched
    tok.__dict__.pop("encode_context", None)


def run(r) -> dict:
    cfg, mix, dev = r.cfg, r.traffic, r.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    tok, lm, inputs, one = build(cfg, mix, r.seed, dev)
    sync()
    phase("weights, models and inputs", r.t_start)
    one(0)
    sync()
    setup_s = time.time() - r.t_start
    phase("one rollout to warm up", r.t_start)

    B = mix["batch"]
    future = cfg["segment_length"] - cfg["context_length"]
    spans = Spans(sync if r.trace else None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    stages = stage_spans(tok, spans) if r.trace else contextlib.nullcontext()
    ends = []

    def done(n):
        ends.append(time.perf_counter() - t0)
        return ends[-1] >= r.seconds

    with stages:
        t0 = time.perf_counter()
        kept = collect(one, mix, r.seed, sync, done)
        elapsed = time.perf_counter() - t0
    n = len(kept)
    print("rollout seconds: " + " ".join(
        f"{b - a:.4f}" for a, b in zip([0.0] + ends, ends)), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    record = {"kind": "rollout", "cfg": cfg, "traffic": mix, "units": n,
              "window_s": elapsed, "spans": spans.seconds}
    trace = None
    if r.trace and dev.type == "cuda":
        trace = Trace()
        # the host's own intervals, not waited for: an idle gap is named
        # by what the host was doing while the card waited
        unit_spans = Spans(None)
        with stage_spans(tok, unit_spans), traced(dev, trace):
            one(n)
        trace.units = 1
        record["trace"] = trace
        record["trace_labels"] = unit_spans.label_at

    del tok, lm, one
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    phase("window and trace done, program freed", r.t_start)
    numbers = judge(cfg, mix, r.seed, dev, inputs, kept)
    phase("reference check done", r.t_start)
    return {"attempted": n, "failed": 0,
            "e2e": {"frames_per_s": (n * B * future / elapsed, "frames/s"),
                    "setup_s": (setup_s, "s"),
                    "peak_mem_gib": (peak / 2 ** 30, "GiB")},
            "memory_peak_bytes": peak, "record": record, "trace": trace,
            "numbers": numbers}


def collect(one, mix: dict, seed: int, sync, done) -> list:
    """Rollouts back to back, each waited for, until ``done(count)``; of
    each, ``check_rows_per_rollout`` rows drawn by the seed are kept
    (rollout, rows, their streams, their frames) for the check."""
    rng = np.random.default_rng(generate.seed_words(seed, 4))
    kept = []
    while True:
        res = one(len(kept))
        rows = torch.as_tensor(rng.choice(mix["batch"],
                                          mix["check_rows_per_rollout"],
                                          replace=False),
                               device=res.tokens.device)
        kept.append((len(kept), rows, res.tokens[rows], res.frames[rows]))
        del res
        sync()
        if done(len(kept)):
            return kept


def sample_rows(kept, seed: int, n: int):
    """n of the kept (rollout, row) pairs, drawn by the seed."""
    pairs = [(k, j) for k in range(len(kept))
             for j in range(len(kept[k][1]))]
    rng = np.random.default_rng(generate.seed_words(seed, 5))
    pick = rng.permutation(len(pairs))[:n]
    return [pairs[i] for i in sorted(pick)]


def references(cfg: dict, seed: int, device, prec: Precision):
    """The reference tokenizer and LM over the served weights (the bf16
    values the program holds, read as fp32)."""
    tw = weights.as_fp32(weights.tokenizer_weights(cfg, seed, device,
                                                   serving=True))
    lw = weights.as_fp32(weights.lm_weights(cfg, seed, device, serving=True))
    dims = tok_dims(cfg["tokenizer"])
    head = (cfg["context_length"], cfg["segment_length"], dims)
    return (Tokenizer(tw, cfg["tokenizer"], prec),
            LM(lw, cfg["transformer"], head, prec))


@torch.no_grad()
def judge(cfg, mix, seed, device, inputs, kept,
          control: Optional[str] = None) -> Dict[str, float]:
    """The compared numbers of the sampled rows: the program's outputs (or,
    with ``control``, those of the reference computed in that precision
    in the program's place, on the program's streams) against the fp32
    reference."""
    pairs = sample_rows(kept, seed, mix["check_rows"])
    stream = torch.stack([kept[k][2][j] for k, j in pairs])
    frames = torch.stack([kept[k][3][j] for k, j in pairs]).float()
    idx = [kept[k][0] % len(inputs) for k, j in pairs]
    rows = [int(kept[k][1][j]) for k, j in pairs]
    px = torch.stack([inputs[i][0][b] for i, b in zip(idx, rows)])
    act = (torch.stack([inputs[i][1][b] for i, b in zip(idx, rows)])
           if cfg["action_conditioned"] else None)
    ref_tok, ref_lm = references(cfg, seed, device, Precision("fp32"))
    ctl = (references(cfg, seed, device, Precision(control))
           if control else None)
    return compare(cfg, mix, seed, ref_tok, ref_lm, ctl, px, act, stream,
                   frames)


def compare(cfg, mix, seed, ref_tok, ref_lm, ctl, px, act, stream, frames,
            block: int = 4) -> Dict[str, float]:
    t = cfg["tokenizer"]
    ctx = cfg["context_length"]
    dims = ref_tok.dims
    future = cfg["segment_length"] - ctx
    pos = sampled_positions(ctx, future, dims).to(stream.device)
    k = mix["top_k"]
    gen = torch.Generator(device=stream.device).manual_seed(
        generate.sub_seed(seed, 6))
    mism = gap_rel = tok_gap = 0.0
    n_ids = 0
    err2 = ref2 = 0.0
    for b0 in range(0, stream.shape[0], block):
        sl = slice(b0, b0 + block)
        s = stream[sl]
        cb = ref_tok.w["quantize.embedding.weight"]
        with ref_tok.p.scope():
            z, _ = ref_tok.context_latents(px[sl].flatten(0, 1))
        best, dbest = nearest(z, cb)
        if ctl is None:
            ids = split_stream(s, ctx, t, dims)[0].reshape(-1)
        else:
            with ctl[0].p.scope():
                zc, _ = ctl[0].context_latents(px[sl].flatten(0, 1))
            ids = nearest(zc, cb)[0]
        mism += float((ids != best).sum())
        n_ids += ids.numel()
        d = distance_to(z, cb, ids)
        gap_rel = max(gap_rel, float(((d - dbest) / dbest.clamp_min(1e-30))
                                     .max()))

        a = None if act is None else act[sl]
        with ref_lm.p.scope():
            logits = ref_lm.forward(s, a)[:, pos - 1]       # [b, n, V]
        kth = torch.topk(logits, k, dim=-1).values[..., -1]
        if ctl is None:
            chosen = s[:, pos]
        else:
            with ctl[1].p.scope():
                cl = ctl[1].forward(s, a)[:, pos - 1]
            chosen = _sample_top_k(cl, k, mix["temperature"], gen)
            del cl
        got = logits.gather(-1, chosen[..., None])[..., 0]
        tok_gap = max(tok_gap, float((kth - got).clamp_min(0).max()))
        del logits

        with ref_tok.p.scope():
            rf = ref_tok.render_stream(s, ctx)
        if ctl is None:
            f = frames[sl]
        else:
            with ctl[0].p.scope():
                f = ctl[0].render_stream(s, ctx)
        err2 += float(((f - rf) ** 2).sum())
        ref2 += float((rf ** 2).sum())
    return {"ctx_id_mismatch": mism / n_ids, "ctx_code_gap": gap_rel,
            "token_topk_gap": tok_gap,
            "frame_rel_err": (err2 / ref2) ** 0.5}


def _sample_top_k(logits, k, temperature, gen):
    """One draw a position from the top-k set of ``logits`` at
    ``temperature`` (Gumbel-max)."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    masked = torch.where(logits >= kth, logits / temperature,
                         torch.full_like(logits, float("-inf")))
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (masked - torch.log(-torch.log(u))).argmax(-1)
