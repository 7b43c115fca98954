"""``launches``: device events matched to their host launch by correlation
id, kineto's clock put onto the host's by the marker's launch, the count
and device seconds launched inside host intervals, the idle share within
them, the gap labels with nested program spans, and the per-request
readings of the program's spans. All on synthetic kineto events."""

import pytest
from torch.autograd import DeviceType

from benchmark import launches


class Ev:
    def __init__(self, name, dev, corr, start, dur=0, annotation=False):
        self._n, self._d, self._c = name, dev, corr
        self._s, self._u, self._a = start, dur, annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def is_user_annotation(self):
        return self._a


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
SHIFT = 10 ** 18     # kineto's epoch clock against perf_counter_ns


def events(sync=True):
    """The marker's launch call at host 990-1000 (kineto SHIFT + 990), the
    marker run at 1100-1110; kernel a launched at 2000, run 2500-2700; a
    copy launched by cudaMemcpyAsync at 3000, run 3000-3050; kernel b
    launched at 4000, run 6000-7000; a kernel whose launch record is
    missing; an annotation; the closing synchronisation returning at
    7490."""
    k = SHIFT
    evs = [
        Ev("cudaLaunchKernel", CPU, 1, k + 990, 10),
        Ev("marker", CUDA, 1, k + 1100, 10),
        Ev("cuLaunchKernel", CPU, 2, k + 2000, 5),
        Ev("a", CUDA, 2, k + 2500, 200),
        Ev("cudaMemcpyAsync", CPU, 3, k + 3000, 5),
        Ev("Memcpy HtoD", CUDA, 3, k + 3000, 50),
        Ev("cudaLaunchKernelExC", CPU, 4, k + 4000, 5),
        Ev("b", CUDA, 4, k + 6000, 1000),
        Ev("lost", CUDA, 99, k + 8000, 5),
        Ev("generation.decode", CUDA, 5, k + 2000, 5000, annotation=True),
    ]
    if sync:
        evs.append(Ev("cudaDeviceSynchronize", CPU, 6, k + 4010, 3480))
    return evs


@pytest.fixture
def got():
    return launches.read(events(), 1000, 7500)


def test_match_and_clock(got):
    assert got.launch_ns == [990, 2000, 3000, 4000]
    assert got.start_ns == [1100, 2500, 3000, 6000]
    assert got.end_ns == [1110, 2700, 3050, 7000]
    assert got.unmatched == 1
    assert got.shift_ns == SHIFT and got.residual_ns == -10
    assert launches.read(events(sync=False), 1000, 7500).residual_ns is None


def test_no_launch_records_raise():
    evs = [e for e in events() if e.device_type() == CUDA]
    with pytest.raises(RuntimeError, match="no launch records"):
        launches.read(evs, 0, 10)


def test_launched_in_counts_by_launch_time_not_run_time(got):
    # b runs at 6000-7000 but was launched inside [3500, 4500)
    assert got.launched_in([(3500, 4500)]) == (1, 1000 / 1e9)
    assert got.launched_in([(1500, 3500)]) == (2, 250 / 1e9)
    # overlapping intervals count each event once
    assert got.launched_in([(1500, 3500), (2500, 4500)]) == (3, 1250 / 1e9)
    assert got.launched_in([(5000, 9000)]) == (0, 0.0)
    assert got.launched_in([]) == (0, 0.0)


def test_idle_within(got):
    # the device runs 2500-2700 and 3000-3050 inside [2000, 4000)
    assert got.idle_within([(2000, 4000)]) == pytest.approx(1 - 250 / 2000)
    assert got.idle_within([(6500, 7500)]) == pytest.approx(0.5)
    assert got.idle_within([(2000, 4000), (6500, 7500)]) == pytest.approx(
        1 - 750 / 3000)
    assert got.idle_within([(7100, 7200)]) == 1.0
    assert got.idle_within([]) is None


# (id, parent, request, name, t0, t1), in the order they closed
SPANS = [
    (1, 0, 0, "rollout.tokenize", 100, 200),
    (3, 2, 0, "generation.prefill", 210, 300),
    (5, 4, 0, "generation.lm_step", 310, 340),
    (6, 4, 0, "generation.sample", 340, 380),
    (7, 4, 0, "generation.lm_step", 380, 400),
    (4, 2, 0, "generation.decode", 305, 410),
    (2, 0, 0, "rollout.generate", 205, 420),
    (0, -1, 0, "rollout", 90, 500),
    (9, -1, 9, "data.wait", 600, 700),
]


@pytest.mark.parametrize("t,inner", [
    (150, "rollout.tokenize"), (320, "generation.lm_step"),
    (350, "generation.sample"), (405, "generation.decode"),
    (415, "rollout.generate"), (450, "rollout"), (650, "data.wait"),
    (550, None), (500, None)])
def test_innermost(t, inner):
    assert launches.innermost(SPANS, t) == inner


def test_labels_name_the_benchmark_span_then_the_program_span():
    outer = {True: "generate", False: "between spans"}
    label = launches.labels(lambda t: outer[200 <= t < 420], SPANS)
    assert label(350) == "generate/generation.sample"
    assert label(650) == "between spans/data.wait"
    assert label(550) == "between spans"


def test_self_time_and_per_request_readings(got):
    assert launches.self_ns(SPANS, "generation.decode") == 105 - 90
    assert launches.self_ns(SPANS, "generation.lm_step") == 50
    assert launches.host_ms(SPANS, "generation.sample", "rollout") == 40 / 1e6
    assert launches.host_ms(SPANS, "generation.sample", "train.step") is None
    assert launches.host_ms(SPANS, "train.clip", "rollout") is None
    spans = [(0, -1, 0, "train.step", 1500, 4500),
             (1, 0, 0, "train.forward", 1500, 2500),
             (2, 0, 0, "train.backward", 3500, 4500)]
    assert launches.device_ms(got, spans, "train.backward",
                              "train.step") == pytest.approx(1000 / 1e6)
    assert launches.device_ms(got, spans, "train.clip", "train.step") is None
