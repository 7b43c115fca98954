"""Tracing and profiling helpers, the port of
``ivideogpt_tpu/utils/profiling.py``: the same wall-clock meters, and
device tracing through ``torch.profiler`` in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional


class AverageMeter:
    """Running value/avg meter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val, self.avg, self.sum, self.count = 0.0, 0.0, 0.0, 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class StepTimer:
    """Tracks data-wait and step durations, yielding samples/sec."""

    def __init__(self):
        self.batch_time = AverageMeter()
        self.data_time = AverageMeter()
        self._last = time.time()

    def data_ready(self):
        now = time.time()
        self.data_time.update(now - self._last)
        return now

    def step_done(self, n_samples: int = 1):
        now = time.time()
        self.batch_time.update(now - self._last)
        self._last = now
        return n_samples / max(self.batch_time.val, 1e-9)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block (the CPU and, where there is one,
    the CUDA device), written as a TensorBoard trace into ``log_dir``; a
    no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """A named range in device traces (``torch.profiler.record_function``)."""
    from torch.profiler import record_function
    with record_function(name):
        yield
