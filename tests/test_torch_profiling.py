"""``ivideogpt_tpu_torch/utils/profiling.py`` against the JAX package's
``utils/profiling.py``: the meters give the same values on the same inputs
and the same clock (exactly: the same float arithmetic), ``device_trace``
writes a trace only when given a directory, and ``annotate`` names a range
that the profiler records."""

import os

import pytest
import torch

from ivideogpt_tpu.utils import profiling as jprof
from ivideogpt_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("updates", [
    [(1.0, 1)], [(0.5, 3), (2.25, 1), (-1.0, 2)], [(1e-3, 7)] * 9])
def test_average_meter_matches_jax(updates):
    ours, theirs = tprof.AverageMeter(), jprof.AverageMeter()
    for val, n in updates:
        ours.update(val, n)
        theirs.update(val, n)
        assert (ours.val, ours.avg, ours.sum, ours.count) == (
            theirs.val, theirs.avg, theirs.sum, theirs.count)
    ours.reset()
    assert (ours.val, ours.avg, ours.sum, ours.count) == (0.0, 0.0, 0.0, 0)


def test_step_timer_matches_jax_on_one_clock(monkeypatch):
    ticks = [10.0, 10.5, 11.25, 11.5, 13.0, 13.125, 14.0]

    def run(mod):
        clock = iter(ticks)
        monkeypatch.setattr(mod.time, "time", lambda: next(clock))
        timer = mod.StepTimer()
        out = [timer.data_ready(), timer.step_done(4), timer.data_ready(),
               timer.step_done(), timer.data_ready(), timer.step_done(8)]
        return out, (timer.batch_time.avg, timer.data_time.avg,
                     timer.batch_time.count)

    assert run(tprof) == run(jprof)


def test_device_trace_writes_only_with_a_directory(tmp_path):
    with tprof.device_trace(None):
        torch.ones(3).sum()
    assert not os.listdir(tmp_path)
    with tprof.device_trace(str(tmp_path)):
        with tprof.annotate("ivg.step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    written = os.listdir(tmp_path)
    assert len(written) == 1 and written[0].endswith(".pt.trace.json")
    with open(os.path.join(tmp_path, written[0])) as f:
        assert '"ivg.step"' in f.read()


def test_annotate_names_a_profiler_range():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tprof.annotate("ivg.region"):
            torch.ones(8).add_(1)
    assert "ivg.region" in {e.key for e in prof.key_averages()}
