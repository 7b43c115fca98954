"""GPT pretraining steps, as ``train_gpt.py``'s loop drives them: the port's
``InfiniteDataLoader`` (its worker threads reading the episodes the mix's
generator wrote, cropping and resizing each segment) -> the frozen fp32
tokenizer (``gpt_trainer.make_tokenize_fn``) -> ``gpt_trainer.train_step``
(the LM's bf16 forward and backward over fp32 masters with attention
dropout keyed by (seed, step), the global-norm clip and AdamW).

Set-up: the episodes written, the weights drawn on the card (fp32), the
models, the train state and the loader built, and three steps taken
through the window's own call and feed; their losses, the first
gradient (from AdamW's first moment after step 1) and the parameters'
change after step 3 are kept for the check. The window: steps until
``--seconds`` have passed, the loader's wait in each. ``train_tokens_per_s``
counts the LM tokens (batch x stream length) of the steps the window
completed over its seconds, the final synchronisation included.

``correct``: once the window has closed and the program is freed, the
fp32 reference (TF32 off) takes the three set-up steps from the same
weights on the same pixels, its dropout masks from its own Philox, and
:func:`compare` holds the program's readings against its.
"""

from __future__ import annotations

import shutil
import statistics
import tempfile
import time
from typing import Dict

import torch

from benchmark import generate, weights
from benchmark.harness import Spans, phase
from benchmark.reference import adamw
from benchmark.reference.llama import LM, loss_and_grads
from benchmark.reference.numerics import Precision
from benchmark.reference.params import tok_dims
from benchmark.reference.stream import assemble
from benchmark.reference.tokenizer import Tokenizer, nearest
from benchmark.trace import Trace, traced

SETUP_STEPS = 3
TRACED_STEPS = 3


def recipe_config(recipe: dict):
    from ivideogpt_tpu_torch.configs import GPTTrainConfig
    return GPTTrainConfig(
        learning_rate=recipe["learning_rate"],
        lr_scheduler=recipe["lr_scheduler"],
        lr_warmup_steps=recipe["warmup_steps"],
        max_train_steps=recipe["max_train_steps"],
        max_grad_norm=recipe["max_grad_norm"],
        weight_decay=recipe["weight_decay"],
        embed_no_wd=recipe["embed_no_wd"],
        adam_beta1=recipe["adam_beta1"], adam_beta2=recipe["adam_beta2"],
        adam_epsilon=recipe["adam_epsilon"])


class Program:
    """The program's objects of one run: models, train state, tokenize and
    the loader, and the step the window calls."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, root: str):
        from ivideogpt_tpu_torch.data.npz_dataset import InfiniteDataLoader
        from ivideogpt_tpu_torch.train import gpt_trainer as gt
        from ivideogpt_tpu_torch.utils.platform import to_device
        self.gt, self.to_device, self.device = gt, to_device, device
        recipe = mix["recipe"]
        self.action = cfg["action_conditioned"]
        parent, datasets, registry = generate.write_episodes(cfg, mix, seed,
                                                             root)
        self.tok = weights.port_tokenizer(
            cfg, weights.tokenizer_weights(cfg, seed, device, serving=False),
            torch.float32)
        self.tok.requires_grad_(False)
        self.tok.eval()
        self.lm = weights.port_lm(
            cfg, weights.lm_weights(cfg, seed, device, serving=False),
            torch.bfloat16, recipe["attention_dropout"]).train()
        self.state = gt.create_train_state(self.lm, recipe_config(recipe))
        self.tokenize = gt.make_tokenize_fn(self.tok, cfg["context_length"])
        self.names = [n for n, p in self.lm.named_parameters()
                      if p.requires_grad]
        self.drop_seed = generate.sub_seed(seed, 7)
        self.loader = InfiniteDataLoader(
            parent, datasets, batch_size=mix["batch"],
            num_workers=mix["loader_threads"],
            stepsize=mix["video_stepsize"],
            segment_length=cfg["segment_length"],
            context_length=cfg["context_length"], segment_horizon=None,
            random_selection=False, goal_conditioned=False,
            random_resized_crop_scale=tuple(mix["crop_scale"]),
            random_resized_crop_ratio=tuple(mix["crop_ratio"]),
            no_aug=False, image_size=cfg["tokenizer"]["resolution"],
            load_action=self.action, seed=generate.sub_seed(seed, 8),
            registry_path=registry)
        self.steps = 0

    def next_batch(self):
        batch = next(self.loader)
        return batch if self.action else (batch, None)

    def tokenize_batch(self, px):
        return self.tokenize(self.to_device(px, self.device))

    def lm_step(self, ids, labels, act):
        b = {"input_ids": ids, "labels": labels}
        if act is not None:
            b["action"] = self.to_device(act, self.device)
        m = self.gt.train_step(self.state, b,
                               rng=(self.drop_seed, self.steps))
        self.steps += 1
        return m

    def close(self):
        self.loader.close()


def setup_steps(p: Program, cfg: dict, seed: int) -> dict:
    """The three set-up steps, and what the check reads of them."""
    out = {"pixels": [], "actions": [], "ids": [], "loss": []}
    b1 = p.state.optimizer.param_groups[0]["betas"][0]
    for k in range(SETUP_STEPS):
        px, act = p.next_batch()
        ids, labels = p.tokenize_batch(px)
        m = p.lm_step(ids, labels, act)
        out["pixels"].append(px)
        out["actions"].append(act)
        out["ids"].append(ids.clone())
        out["loss"].append(float(m["loss"]))
        if k == 0:
            out["grad_norm"] = float(m["grad_norm"])
            st = p.state.optimizer.state
            out["grad"] = {n: float(st[q]["exp_avg"].double().norm())
                           / (1 - b1) if q in st else 0.0
                           for n, q in zip(p.names, p.state.params)}
    start = weights.lm_weights(cfg, seed, p.device, serving=False)
    out["change"] = {n: float((q.detach() - start[n]).double().norm())
                     for n, q in zip(p.names, p.state.params)}
    del start
    return out


def run(r) -> dict:
    cfg, mix, dev = r.cfg, r.traffic, r.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    root = tempfile.mkdtemp(prefix="portbench-")
    try:
        return _run(r, cfg, mix, dev, sync, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(r, cfg, mix, dev, sync, root) -> dict:
    p = Program(cfg, mix, r.seed, dev, root)
    try:
        sync()
        phase("episodes, weights, models, train state, loader", r.t_start)
        kept = setup_steps(p, cfg, r.seed)
        sync()
        setup_s = time.time() - r.t_start
        phase("three steps", r.t_start)
        spans = Spans(sync if r.trace else None)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        n = 0
        while True:
            step(p, spans)
            n += 1
            if time.perf_counter() - t0 >= r.seconds:
                break
        sync()
        elapsed = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        record = {"kind": "gpttrain", "cfg": cfg, "traffic": mix,
                  "units": n, "window_s": elapsed, "spans": spans.seconds}
        trace = None
        if r.trace and dev.type == "cuda":
            trace = Trace()
            # the host's own intervals, not waited for: an idle gap is
            # named by what the host was doing while the card waited
            unit_spans = Spans(None)
            with traced(dev, trace):
                for _ in range(TRACED_STEPS):
                    step(p, unit_spans)
            trace.units = TRACED_STEPS
            record["trace"] = trace
            record["trace_labels"] = unit_spans.label_at
    finally:
        p.close()
    L = int(kept["ids"][0].shape[1])
    del p
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    phase("window and trace done, program freed", r.t_start)
    numbers = judge(cfg, mix, r.seed, dev, kept)
    phase("reference check done", r.t_start)
    return {"attempted": n, "failed": 0,
            "e2e": {"train_tokens_per_s": (n * mix["batch"] * L / elapsed,
                                           "tokens/s"),
                    "setup_s": (setup_s, "s"),
                    "peak_mem_gib": (peak / 2 ** 30, "GiB")},
            "memory_peak_bytes": peak, "record": record, "trace": trace,
            "numbers": numbers}


def step(p: Program, spans: Spans):
    t = time.perf_counter()
    px, act = p.next_batch()
    spans.add("loader_wait", time.perf_counter() - t)
    with spans.span("tokenize"):
        ids, labels = p.tokenize_batch(px)
    with spans.span("lm_step"):
        p.lm_step(ids, labels, act)


# -- the check -------------------------------------------------------------

def reference_run(cfg: dict, mix: dict, seed: int, device, kept: dict,
                  prec_tok: Precision, prec_lm: Precision,
                  rows: int = 4) -> dict:
    """The three set-up steps by the reference, its tokenizer computing in
    ``prec_tok`` and its LM in ``prec_lm``: its ids from the same pixels,
    each step's loss, the first step's clipped gradient and unclipped
    norm, each parameter's change after the three."""
    recipe = mix["recipe"]
    t = cfg["tokenizer"]
    ctx, seg = cfg["context_length"], cfg["segment_length"]
    dims = tok_dims(t)
    tw = weights.tokenizer_weights(cfg, seed, device, serving=False)
    tok = Tokenizer(tw, t, prec_tok)
    start = weights.lm_weights(cfg, seed, device, serving=False)
    params = {n: v.clone().requires_grad_(True) for n, v in start.items()}
    lm = LM(params, cfg["transformer"], (ctx, seg, dims), prec_lm)
    opt = adamw.AdamW(params, recipe)
    out = {"ids": [], "loss": []}
    p = recipe["attention_dropout"]
    drop_seed = generate.sub_seed(seed, 7)
    for k in range(SETUP_STEPS):
        px = torch.as_tensor(kept["pixels"][k], device=device)
        B = px.shape[0]
        with prec_tok.scope(), torch.no_grad():
            z, feats = tok.context_latents(px[:, :ctx].flatten(0, 1))
            ic = nearest(z, tw["quantize.embedding.weight"])[0]
            zd = tok.dynamics_latents(px[:, ctx:].flatten(0, 1), feats, ctx)
            idd = nearest(zd, tw["dynamics_quantize.embedding.weight"])[0]
            del z, feats, zd
        ids, labels = assemble(ic.view(B, ctx, -1), idd.view(B, seg - ctx, -1),
                               t)
        out["ids"].append(ids)
        act = kept["actions"][k]
        act = None if act is None else torch.as_tensor(act, device=device)
        with prec_lm.scope():
            loss, grads = loss_and_grads(lm, ids, labels, act,
                                         (p, drop_seed, k), rows, params)
        out["loss"].append(loss)
        grads, norm = adamw.clip(grads, recipe["max_grad_norm"])
        if k == 0:
            out["grad_norm"] = norm
            out["grad"] = {n: float(g.double().norm())
                           for n, g in grads.items()}
        opt.step(params, grads)
        del grads
    out["change"] = {n: float((params[n].detach() - start[n]).double().norm())
                     for n in params}
    return out


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    """The worst leaf's |prog - ref| over the larger of its reference norm
    and the median leaf's."""
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def compare(prog: dict, ref: dict, grads_ref: Dict[str, float]
            ) -> Dict[str, float]:
    """The compared numbers of the program's readings ``prog`` against the
    reference's ``ref``. Leaves whose reference gradient (``grads_ref``,
    the fp32 reference's) is under a thousandth of the median leaf's move
    under AdamW by rounding alone and are left out of the gradient and
    change numbers."""
    ids = torch.stack([x.to(ref["ids"][0].device) for x in prog["ids"]])
    ref_ids = torch.stack(ref["ids"])
    med = statistics.median(grads_ref.values())
    live = [n for n, g in grads_ref.items() if g >= 1e-3 * med]
    return {
        "id_mismatch": float((ids != ref_ids).float().mean()),
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["loss"], ref["loss"])),
        "grad_norm_gap": abs(prog["grad_norm"] - ref["grad_norm"])
        / ref["grad_norm"],
        "grad_leaf_gap": leaf_gap(prog["grad"], ref["grad"], live),
        "change_leaf_gap": leaf_gap(prog["change"], ref["change"], live),
    }


def judge(cfg, mix, seed, device, kept) -> Dict[str, float]:
    ref = reference_run(cfg, mix, seed, device, kept, Precision("fp32"),
                        Precision("fp32"))
    return compare(kept, ref, ref["grad"])
