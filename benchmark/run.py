"""The benchmark of ivideogpt_tpu_torch, one run of one cell:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s workload) names
a configuration and a traffic mix; the mix's ``kind`` names the driver in
``cells/`` that sets the program up, runs the window and the check. With
``--trace 0`` the line reports the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones (host spans around the program's calls,
synchronised, and a device trace after the window).

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``[, ``breakdown``],
``checks``); the compared numbers and their limits are also the last
lines of standard error. Without a CUDA device, or with fewer than the cell
asks for, or with ``jax``, ``flax`` or the JAX package loaded once the
window has closed, the run exits nonzero and prints no result. A cell on
more than one chip starts one process a card, joined by
``torch.distributed`` over NCCL; rank 0 prints the line.

Kernel libraries are built into the port's ``csrc/build/`` inside the
checkout (the first run of a checkout builds them); the episodes of the
training mixes go to a fresh directory under ``TMPDIR``, removed at the
end.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class Run:
    """One run's settings, as a driver reads them."""

    def __init__(self, name, cfg, traffic, seed, seconds, trace, device,
                 t_start, world=1):
        self.name, self.cfg, self.traffic = name, cfg, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start, self.world = device, t_start, world


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by the rank-0 process for the others of a multi-chip cell
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        p.error("--seed must be >= 0 and --seconds > 0")
    return args


def report(r: Run, out: dict, metric_defs, power) -> tuple:
    """(correct, the checks, the result line) of a driver's outcome;
    ``metric_defs`` are the manifest's entries of the metrics the run
    reports, ``power`` the card's name and power limit."""
    from benchmark import harness
    checks = harness.judge(out["numbers"], harness.limits(r.name))
    correct = all(v <= lim for v, lim in checks.values())
    import torch
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(r.device),
              "count": r.world, "memory_peak_bytes": out["memory_peak_bytes"]}
    breakdown = None
    if r.trace:
        record = out["record"]
        metrics = {}
        for m in metric_defs:
            v = harness.metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = (v, m["unit"])
        trace = out["trace"]
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        breakdown = {"device_ops": trace.top_ops(),
                     "idle_gaps": trace.top_gaps(record["trace_labels"])}
    else:
        metrics = {k: v for k, v in out["e2e"].items()
                   if k in {m["name"] for m in metric_defs}}
    line = harness.result_line(correct, out["attempted"], out["failed"],
                               metrics, device, checks, breakdown,
                               {"card": power})
    return correct, checks, line


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness
    man = harness.manifest()
    cell = harness.workload(man, args.workload)
    chips = int(cell["chips"])
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, {torch.cuda.device_count()} "
              f"found", file=sys.stderr)
        return 2
    from benchmark import launch
    children = []
    if chips > 1 and args.rank == 0:
        args.world, args.port = chips, launch.free_port()
        children = launch.spawn_others(
            [sys.executable, os.path.abspath(__file__)]
            + (argv if argv is not None else sys.argv[1:]), chips, args.port)
    device = torch.device("cuda", args.rank)
    torch.cuda.set_device(device)
    harness.phase("torch and the card", T_START)
    from ivideogpt_tpu_torch import _build
    _build.build_all()
    harness.phase("kernel libraries built or found", T_START)
    try:
        if args.world > 1:
            launch.join(args.rank, args.world, args.port, device, "nccl")
        cfg = harness.config(cell["config"])
        mix = harness.traffic(cell["traffic"])
        r = Run(args.workload, cfg, mix, args.seed, args.seconds,
                bool(args.trace), device, T_START, args.world)
        out = harness.driver(mix["kind"]).run(r)
        found = harness.forbidden_modules()
        if found:
            print(f"modules of JAX or the JAX package were loaded: {found}",
                  file=sys.stderr)
            return 3
        if args.rank != 0:
            return 0
        power = harness.card_power_limit()
        print(f"card: {power}", file=sys.stderr)
        correct, checks, line = report(
            r, out, harness.cell_metrics(man, args.workload, bool(args.trace)),
            power)
        harness.print_checks(checks)
        print(line, flush=True)
        return 0
    finally:
        launch.finish(children, args.world)


if __name__ == "__main__":
    sys.exit(main())
