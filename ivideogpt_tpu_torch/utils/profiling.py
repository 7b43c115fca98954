"""Named host spans inside the port: where the rollout's stages, each
decode step's two halves and a training step's parts begin and end.

    with profiling.span("train.forward"):
        ...

    with profiling.recording() as spans:
        rollout(...)
    # spans: (id, parent id, request id, name, t0_ns, t1_ns) of each span,
    # in the order the spans closed

A span costs one check when nothing records and no ``torch.profiler`` is
active: ``span`` then returns one shared null context. Under
:func:`recording` it appends its interval on ``time.perf_counter_ns()``,
the clock a caller's own timers read; the request id is the id of the
outermost span open when it opened, so every span of one rollout or one
training step shares it, and the parent id is -1 at the outermost.
Under an active ``torch.profiler`` a span also opens a
``record_function`` range of its name, so a profiler's trace shows it.

No span reads a tensor or waits for the device: an interval is the host's
time in the block, however much of its work the card still has queued.
Ids and the open-span stack are per thread; spans of other threads land
in the same list.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Iterator, List, Optional

from torch.autograd import profiler as _autograd_profiler

_NULL = contextlib.nullcontext()
# the list recording() fills: (id, parent id, request id, name, t0_ns, t1_ns)
_spans: Optional[List[tuple]] = None
_ids = itertools.count()
_local = threading.local()            # .open: the thread's open spans


def span(name: str):
    """A context manager around the block: recorded under
    :func:`recording`, a ``record_function`` range under an active
    profiler, else the shared null context."""
    if _spans is None and not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


@contextlib.contextmanager
def recording() -> Iterator[List[tuple]]:
    """Record every span inside the block; yields the list they are
    appended to, which the caller reads once the block has closed."""
    global _spans, _ids
    if _spans is not None:
        raise RuntimeError("recording() is already on")
    _spans, _ids = [], itertools.count()
    try:
        yield _spans
    finally:
        _spans = None


class _Span:
    __slots__ = ("name", "range", "into", "id", "parent", "request", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = _autograd_profiler.record_function(self.name)
            self.range.__enter__()
        self.into = _spans
        if self.into is not None:
            stack = _local.__dict__.setdefault("open", [])
            self.id = next(_ids)
            self.parent, self.request = ((stack[-1].id, stack[0].id)
                                         if stack else (-1, self.id))
            stack.append(self)
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.into is not None:
            t1 = time.perf_counter_ns()
            _local.open.pop()
            self.into.append((self.id, self.parent, self.request, self.name,
                              self.t0, t1))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False
