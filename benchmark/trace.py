"""A device trace of one stretch of a traced run: ``torch.profiler`` with
the CUDA activity alone (the port launches ~140k kernels a rollout, and
tracing the CPU's ops too would lengthen the stretch and its reading).

From the trace: each kernel name's launches and device seconds, the
device's busy seconds (the union of the kernels' intervals: copies and
kernels on several streams are counted once where they overlap) over the
stretch's host seconds, and its idle gaps, each named by the host span it
fell in. The device clock is put onto the host's by a marker kernel
launched first, right after a host timestamp.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch


class Trace:
    def __init__(self):
        self.kernels: Dict[str, Tuple[int, float]] = {}
        self.busy_s = 0.0
        self.window_s = 0.0
        self.gaps: List[Tuple[int, int]] = []   # host ns (start, end)
        self.units = 0

    def seconds_of(self, *parts: str) -> Optional[float]:
        """Device seconds of the kernels whose names hold any of
        ``parts``; None where there is none."""
        found = [s for n, (_, s) in self.kernels.items()
                 if any(p in n for p in parts)]
        return sum(found) if found else None

    def top_ops(self, n: int = 10):
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name[:160], s] for name, (_, s) in ops]

    def top_gaps(self, label, n: int = 10):
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:n]
        return [[label((a + b) // 2), (b - a) / 1e9] for a, b in gaps]


@contextlib.contextmanager
def traced(device: torch.device, out: Trace):
    """Trace the block's device activity into ``out``."""
    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        raise RuntimeError("a device trace needs a CUDA device")
    torch.cuda.synchronize(device)
    marker = torch.zeros(1, device=device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        marker.add_(1.0)
        yield
        torch.cuda.synchronize(device)
        t1 = time.perf_counter_ns()
    _read(prof, t0, t1, out)


def _read(prof, t0: int, t1: int, out: Trace):
    from torch.autograd import DeviceType
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        start, dur = e.start_ns(), e.duration_ns()
        spans.append((start, start + dur))
        n, s = out.kernels.get(e.name(), (0, 0.0))
        out.kernels[e.name()] = (n + 1, s + dur / 1e9)
    out.window_s = (t1 - t0) / 1e9
    if not spans:
        return
    spans.sort()
    shift = spans[0][0] - t0      # the marker ran first
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    out.busy_s = sum(b - a for a, b in merged) / 1e9
    edges = [t0 + shift] + [x for ab in merged for x in ab] + [t1 + shift]
    out.gaps = [(edges[i] - shift, edges[i + 1] - shift)
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
