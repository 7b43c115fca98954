"""What every cell shares: the manifest and the files it names, the host
spans of a traced run, the card's power limit, the result line and the
checks a run ends with.

Everything a configuration, a traffic mix or a per-layer metric brings is
a file of its own under this folder, found by the name the manifest
gives it: ``configs/<config>.json``, ``traffic/<traffic>.json`` (whose
``kind`` names the driver in ``cells/``), ``metrics/<metric>.py`` (a
``read(record)`` that returns the metric or None) and
``limits/<workload>.json`` (each compared number's limit).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that must not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "ivideogpt_tpu")


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return read_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return read_json(os.path.join(HERE, "configs", name + ".json"))


def traffic(name: str) -> dict:
    return read_json(os.path.join(HERE, "traffic", name + ".json"))


def limits(name: str) -> dict:
    return read_json(os.path.join(HERE, "limits", name + ".json"))


def driver(kind: str):
    return importlib.import_module(f"benchmark.cells.{kind}")


def metric_reader(name: str) -> Callable:
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(man: dict, name: str, per_layer: bool) -> List[dict]:
    """The metrics a cell reports: a metric with a ``workloads`` list only
    in those cells, one without it in every cell (an end-to-end metric),
    or in every cell that reports the end-to-end metric it moves (a
    per-layer one)."""
    e2e = [m for m in man["end_to_end"]
           if name in m.get("workloads", [name])]
    if not per_layer:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in mine
                             else [])]


def phase(name: str, t_start: float):
    """One line on stderr: a phase of the run done, seconds since the
    process started."""
    print(f"run: {name} at {time.time() - t_start:.3f} s", file=sys.stderr,
          flush=True)


def forbidden_modules() -> List[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


# -- host spans -------------------------------------------------------------

class Spans:
    """Host seconds of named calls, each bracketed by a device
    synchronisation when ``sync`` is set (the traced run), with the
    perf_counter_ns interval of each for the trace's idle gaps."""

    def __init__(self, sync: Optional[Callable[[], None]]):
        self.sync = sync
        self.seconds: Dict[str, List[float]] = {}
        self.intervals: List[tuple] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if self.sync is not None:
            self.sync()
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            t1 = time.perf_counter_ns()
            self.seconds.setdefault(name, []).append((t1 - t0) / 1e9)
            self.intervals.append((t0, t1, name))

    def wrap(self, name: str, fn: Callable) -> Callable:
        def timed(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return timed

    def add(self, name: str, seconds: float):
        self.seconds.setdefault(name, []).append(seconds)

    def label_at(self, t_ns: int) -> str:
        for t0, t1, name in self.intervals:
            if t0 <= t_ns < t1:
                return name
        return "between spans"


@contextlib.contextmanager
def patched(obj, name: str, value):
    """``obj.name = value`` inside the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


# -- the card ---------------------------------------------------------------

def card_power_limit() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card in use, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


# -- the result -------------------------------------------------------------

def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, tuple], device: dict,
                checks: Dict[str, tuple],
                breakdown: Optional[dict] = None,
                context: Optional[dict] = None) -> str:
    """The last line of standard output: ``metrics`` name -> (value, unit),
    ``context`` (the card's name and power limit) as it is, and
    ``checks`` name -> (number, limit), the compared numbers, last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": float(v), "unit": u}
                       for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if context is not None:
        out["context"] = context
    out["checks"] = {k: {"value": float(v), "limit": float(lim)}
                     for k, (v, lim) in checks.items()}
    return json.dumps(out)


def print_checks(checks: Dict[str, tuple]):
    """Each compared number beside its limit, the last lines of stderr."""
    for k, (v, lim) in checks.items():
        verdict = "ok" if v <= lim else "FAILS"
        print(f"check {k}: {v!r} limit {lim!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()


def judge(numbers: Dict[str, float], lim: Dict[str, float]
          ) -> Dict[str, tuple]:
    """(number, limit) of every limited number; a number that is missing or
    not finite reads as the largest float, which no limit passes."""
    out = {}
    for k, limit in lim.items():
        v = float(numbers.get(k, sys.float_info.max))
        if not v < float("inf"):
            v = sys.float_info.max
        out[k] = (v, limit)
    return out
