"""The readings a cell's limits are set from, at the cell's own size, all
seeds in one process:

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,13 \\
        [--control] [--fault <name>] ... [--out chiprun_out/cal.jsonl]

For each seed it prints one JSON line: ``program``, the compared numbers of
a sound run of the program (the rollout: two rollouts, 16 rows kept, as
many as a run compares; training: the three set-up steps); with
``--control``, ``control``, the same numbers of the reference computed in
the precision one step below the configuration's in the program's place
(bf16 -> fp8 for the LM, the render and the serving tokenizer; fp32 ->
TF32 for the frozen training tokenizer); with ``--fault``, each fault's
numbers, the fault planted in the program underneath the cell's own
calls (:data:`FAULTS`). Not part of a benchmark run.
"""

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.harness import patched  # noqa: E402

ROLLOUTS = 2


def _token_altered():
    """Every sampled token moved to the next id where it is drawn."""
    from ivideogpt_tpu_torch import generation
    real = generation.sample_top_k

    def sample(logits, *a, **k):
        return (real(logits, *a, **k) + 1) % logits.shape[-1]
    return patched(generation, "sample_top_k", sample)


def _unchanged_state():
    """A step that returns its state unchanged: the gradients are taken
    and dropped, no update is made."""
    from ivideogpt_tpu_torch.train.optim import TrainState

    def apply_gradients(self):
        for p in self.params:
            p.grad = None
        self.step += 1
    return patched(TrainState, "apply_gradients", apply_gradients)


def _half_batch():
    """Half of each batch left out, the loss the mean over the rest."""
    from ivideogpt_tpu_torch.train import gpt_trainer as gt
    real = gt.train_step

    def train_step(state, batch, rng=None, mesh=None):
        half = batch["input_ids"].shape[0] // 2
        return real(state, {k: v[:half] for k, v in batch.items()}, rng, mesh)
    return patched(gt, "train_step", train_step)


def _ids_altered():
    """The first row's context ids moved to the next code where the
    tokenizer produces them."""
    from ivideogpt_tpu_torch.train import gpt_trainer as gt
    real = gt.make_tokenize_fn

    def make(tokenizer, context_length):
        fn = real(tokenizer, context_length)
        n = tokenizer.config.num_vq_embeddings

        def tokenize(px):
            ids, labels = fn(px)
            c = tokenizer.config.ctx_tokens_per_frame
            ids[0, :c] = (ids[0, :c] + 1) % n
            return ids, labels
        return tokenize
    return patched(gt, "make_tokenize_fn", make)


FAULTS = {"rollout": {"token_altered": _token_altered},
          "gpttrain": {"unchanged_state": _unchanged_state,
                       "half_batch": _half_batch,
                       "ids_altered": _ids_altered}}


def rollout_seed(cfg, mix, seed, dev, control, faults):
    from benchmark.cells import rollout as cell
    mix = dict(mix, check_rows_per_rollout=-(-mix["check_rows"] // ROLLOUTS))
    sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731

    def sound_or(fault):
        tok, lm, inputs, one = cell.build(cfg, mix, seed, dev)
        with (FAULTS["rollout"][fault]() if fault
              else contextlib.nullcontext()):
            kept = cell.collect(one, mix, seed, sync, lambda n: n >= ROLLOUTS)
        del tok, lm, one
        torch.cuda.empty_cache()
        return inputs, kept

    inputs, kept = sound_or(None)
    out = {"program": cell.judge(cfg, mix, seed, dev, inputs, kept)}
    if control:
        out["control"] = cell.judge(cfg, mix, seed, dev, inputs, kept, "fp8")
    for f in faults:
        inputs, kept = sound_or(f)
        out[f] = cell.judge(cfg, mix, seed, dev, inputs, kept)
    return out


def gpttrain_seed(cfg, mix, seed, dev, control, faults):
    from benchmark.cells import gpttrain as cell
    from benchmark.reference.numerics import Precision

    def kept_of(fault):
        root = tempfile.mkdtemp(prefix="portbench-")
        try:
            with (FAULTS["gpttrain"][fault]() if fault
                  else contextlib.nullcontext()):
                p = cell.Program(cfg, mix, seed, dev, root)
                try:
                    return cell.setup_steps(p, cfg, seed)
                finally:
                    p.close()
        finally:
            shutil.rmtree(root, ignore_errors=True)
            torch.cuda.empty_cache()

    kept = kept_of(None)
    ref = cell.reference_run(cfg, mix, seed, dev, kept, Precision("fp32"),
                             Precision("fp32"))
    out = {"program": cell.compare(kept, ref, ref["grad"])}
    if control:
        ctl = cell.reference_run(cfg, mix, seed, dev, kept, Precision("tf32"),
                                 Precision("fp8"))
        out["control"] = cell.compare(ctl, ref, ref["grad"])
    for f in faults:
        # the loader's threads race, so a run's batches are its own: the
        # reference follows each faulted run from its own pixels
        k = kept_of(f)
        r = cell.reference_run(cfg, mix, seed, dev, k, Precision("fp32"),
                               Precision("fp32"))
        out[f] = cell.compare(k, r, r["grad"])
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from ivideogpt_tpu_torch import _build
    _build.build_all()
    cell = harness.workload(harness.manifest(), args.workload)
    cfg = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"])
    dev = torch.device("cuda", 0)
    for f in args.fault:
        if f not in FAULTS[mix["kind"]]:
            p.error(f"fault {f!r}: one of {sorted(FAULTS[mix['kind']])}")
    fn = {"rollout": rollout_seed, "gpttrain": gpttrain_seed}[mix["kind"]]
    out = open(args.out, "a") if args.out else None
    for s in args.seeds.split(","):
        t = time.time()
        res = fn(cfg, mix, int(s), dev, args.control, args.fault)
        line = json.dumps({"workload": args.workload, "seed": int(s),
                           "seconds": round(time.time() - t, 1), **res})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
