"""Each device event of a trace beside the host call that launched it, on
the host's ``perf_counter_ns`` clock, so the device time can be split by
the program's own spans (``ivideogpt_tpu_torch.utils.profiling``).

Kineto writes, under the CUDA activity alone, the CUDA API calls
(``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel``,
``cudaMemcpyAsync``, ...) beside the kernels and copies, each pair sharing
a correlation id. A device event counts for the span in which the host
launched it, not the one it ran in: the training cells queue work ahead of
the card, so a kernel often runs after its span has closed.

Kineto's clock is put onto ``perf_counter_ns`` by the launch record of a
marker kernel launched first: the shift maps the launch call's return to
the host reading taken right after it (the call itself can take
milliseconds, the first under the profiler). The stretch's closing
synchronisation gives the residual: its record's return against the host
reading right after it, on the aligned clock. :func:`traced` is
``trace.traced`` with these records kept: the existing ``Trace`` is filled
by ``trace._read`` from the same profiler, so its readings are those of
``trace.traced``.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple

from benchmark import trace as trace_mod

Interval = Tuple[int, int]    # host perf_counter_ns [start, end)


class Launches:
    """The matched device events of one traced stretch, host-clock
    aligned: ``launch_ns`` (sorted), beside each its device ``start_ns``
    and ``end_ns``."""

    def __init__(self, rows: Sequence[Tuple[int, int, int]], unmatched: int,
                 shift_ns: int, residual_ns: Optional[int]):
        rows = sorted(rows)
        self.launch_ns = [r[0] for r in rows]
        self.start_ns = [r[1] for r in rows]
        self.end_ns = [r[2] for r in rows]
        self.unmatched = unmatched
        self.shift_ns = shift_ns
        self.residual_ns = residual_ns   # None: no closing synchronisation
        self._cum = [0]
        for a, b in zip(self.start_ns, self.end_ns):
            self._cum.append(self._cum[-1] + (b - a))
        self._busy = _merge(zip(self.start_ns, self.end_ns))

    def launched_in(self, intervals: Iterable[Interval]) -> Tuple[int, float]:
        """(count, device seconds) of the events launched inside the
        intervals, each event counted once."""
        n = ns = 0
        for a, b in _merge(intervals):
            i = bisect.bisect_left(self.launch_ns, a)
            j = bisect.bisect_left(self.launch_ns, b)
            n += j - i
            ns += self._cum[j] - self._cum[i]
        return n, ns / 1e9

    def idle_within(self, intervals: Iterable[Interval]) -> Optional[float]:
        """The share of the intervals' host time in which no device event
        ran; None for no time."""
        total = busy = 0
        for a, b in _merge(intervals):
            total += b - a
            busy += _overlap(self._busy, a, b)
        return 1.0 - busy / total if total else None


def _merge(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(merged: List[Interval], a: int, b: int) -> int:
    """ns of the sorted, disjoint ``merged`` inside [a, b)."""
    i = max(bisect.bisect_right(merged, (a, a)) - 1, 0)
    ns = 0
    for s, e in merged[i:]:
        if s >= b:
            break
        ns += max(0, min(e, b) - max(s, a))
    return ns


def read(events, t_marked: int, t1: int) -> Launches:
    """The launches of kineto ``events`` (``device_type``, ``name``,
    ``correlation_id``, ``start_ns``, ``duration_ns``,
    ``is_user_annotation``). The marker was launched first, its launch
    call returning just before the host read ``t_marked``; the stretch
    ended with a device synchronisation returning just before ``t1``,
    whose distance from ``t1`` on the aligned clock is the residual (None
    without a synchronisation's record)."""
    from torch.autograd import DeviceType
    calls: Dict[int, Tuple[int, int]] = {}
    device, sync_end = [], None
    for e in events:
        if e.is_user_annotation():
            continue
        if e.device_type() == DeviceType.CUDA:
            device.append(e)
        elif e.name().startswith("cu"):
            end = e.start_ns() + e.duration_ns()
            calls[e.correlation_id()] = (e.start_ns(), end)
            if "Synchronize" in e.name():
                sync_end = end if sync_end is None else max(sync_end, end)
    rows, unmatched = [], 0
    for e in device:
        call = calls.get(e.correlation_id())
        if call is None:
            unmatched += 1
        else:
            rows.append((call, e.start_ns(), e.start_ns() + e.duration_ns()))
    if not rows:
        raise RuntimeError("the trace holds no launch records")
    shift = min(rows)[0][1] - t_marked      # the marker's launch returned
    rows = [(c[0] - shift, s - shift, e - shift) for c, s, e in rows]
    residual = None if sync_end is None else sync_end - shift - t1
    return Launches(rows, unmatched, shift, residual)


@contextlib.contextmanager
def traced(device, out: "trace_mod.Trace", launched: List[Launches]):
    """``trace.traced`` over the block, filling ``out`` as it does, and
    the block's :class:`Launches` appended to ``launched``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        raise RuntimeError("a device trace needs a CUDA device")
    torch.cuda.synchronize(device)
    marker = torch.zeros(1, device=device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        marker.add_(1.0)
        t_marked = time.perf_counter_ns()
        yield
        torch.cuda.synchronize(device)
        t1 = time.perf_counter_ns()
    trace_mod._read(prof, t0, t1, out)
    got = read(prof.profiler.kineto_results.events(), t_marked, t1)
    print(f"launches: {len(got.launch_ns)} device events matched to their "
          f"launch, {got.unmatched} unmatched; clock shift {got.shift_ns} "
          f"ns, residual {got.residual_ns} ns (the closing "
          f"synchronisation's return against the host's reading after it)",
          file=sys.stderr)
    launched.append(got)


# -- the program's spans ------------------------------------------------------
# a span is (id, parent id, request id, name, t0_ns, t1_ns), as
# ``utils.profiling.recording`` lists them

def intervals(spans, name: str) -> List[Interval]:
    return [(s[4], s[5]) for s in spans if s[3] == name]


def self_ns(spans, name: str) -> int:
    """Host ns in the spans named ``name``, less the time of their
    children."""
    ids = {s[0] for s in spans if s[3] == name}
    own = sum(s[5] - s[4] for s in spans if s[0] in ids)
    return own - sum(s[5] - s[4] for s in spans if s[1] in ids)


def innermost(spans, t: int) -> Optional[str]:
    """The name of the innermost span open at host time ``t``."""
    best = None
    for s in spans:
        if s[4] <= t < s[5] and (best is None or s[4] > best[4]):
            best = s
    return None if best is None else best[3]


def labels(outer: Callable[[int], str], spans) -> Callable[[int], str]:
    """A gap's label: ``outer``'s (the benchmark's span), then ``/`` and
    the innermost program span open at that time, where one is."""
    def label(t: int) -> str:
        inner = innermost(spans, t)
        return outer(t) if inner is None else f"{outer(t)}/{inner}"
    return label


def host_ms(spans, name: str, per: str) -> Optional[float]:
    """Host ms in the spans ``name``, their children's time left out, a
    span ``per`` (a rollout, a step); None where either is missing."""
    n = len(intervals(spans, per))
    if not n or not intervals(spans, name):
        return None
    return self_ns(spans, name) / n / 1e6


def device_ms(launched: Launches, spans, name: str, per: str
              ) -> Optional[float]:
    """Device ms of the events launched inside the spans ``name``, a span
    ``per``; None where either is missing."""
    n, inside = len(intervals(spans, per)), intervals(spans, name)
    if not n or not inside:
        return None
    return launched.launched_in(inside)[1] / n * 1e3
