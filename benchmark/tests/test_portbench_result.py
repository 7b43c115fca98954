"""The result line, the checks it ends with, which metrics a cell reports,
and ``run.py`` on a machine without a card."""

import json
import os
import subprocess
import sys

from benchmark import harness
from benchmark.trace import Trace


def test_result_line_keys_and_checks_last():
    line = harness.result_line(
        True, 12, 0, {"frames_per_s": (812.5, "frames/s"),
                      "setup_s": (14.25, "s")},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 123},
        {"token_topk_gap": (0.01, 0.05)},
        {"device_ops": [["k", 0.5]], "idle_gaps": [["generate", 0.001]]})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["metrics"]["frames_per_s"] == {"value": 812.5,
                                              "unit": "frames/s"}
    assert out["checks"]["token_topk_gap"] == {"value": 0.01, "limit": 0.05}
    assert "\n" not in line


def test_judge_reads_nan_and_missing_as_failed():
    got = harness.judge({"a": float("nan"), "b": 0.5},
                        {"a": 1.0, "b": 1.0, "c": 1.0})
    big = sys.float_info.max
    assert got["a"][0] == big and got["c"][0] == big
    assert got["b"] == (0.5, 1.0)


def test_cell_metrics():
    man = harness.manifest()
    e2e = {m["name"] for m in harness.cell_metrics(man, "base-rollout-b256",
                                                   False)}
    assert e2e == {"frames_per_s", "peak_mem_gib", "setup_s"}
    per = {m["name"] for m in harness.cell_metrics(man, "base-rollout-b256",
                                                   True)}
    assert "k3_roofline.rollout" in per and "train_mfu" not in per


def test_readers_leave_out_what_they_cannot_read():
    rec = {"kind": "gpttrain", "cfg": harness.config("ivg64-base"),
           "traffic": harness.traffic("finetune-bair-b16"), "units": 4,
           "window_s": 2.0, "spans": {}}
    for m in harness.manifest()["per_layer"]:
        v = harness.metric_reader(m["name"])(rec)
        if m["name"] != "train_mfu":
            assert v is None, m["name"]
    rec["trace"] = Trace()
    rec["trace"].units = 1
    assert harness.metric_reader("flash_roofline.train")(rec) is None


def test_trace_shares():
    t = Trace()
    t.units = 1
    t.kernels = {"flash_fwd_sm90_kernel": (12, 0.002),
                 "flash_bwd_dkv_sm90_kernel": (12, 0.003),
                 "other": (5, 0.01)}
    t.busy_s, t.window_s = 0.3, 0.4
    rec = {"kind": "gpttrain", "cfg": harness.config("ivg64-base"),
           "traffic": harness.traffic("finetune-bair-b16"), "units": 4,
           "window_s": 2.0, "spans": {}, "trace": t}
    idle = harness.metric_reader("device_idle.train")(rec)
    assert abs(idle - 25.0) < 1e-9
    share = harness.metric_reader("flash_roofline.train")(rec)
    from benchmark import roofline
    want = 100 * roofline.flash_step_bound_s(rec["cfg"], 16, 751) / 0.005
    assert abs(share - want) < 1e-9
    assert t.top_ops(2)[0][0] == "other"


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "base-rollout-b256", "--seed", str(2 ** 31 + 9),
                        "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_refuses_an_unknown_workload():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "no-such-cell", "--seed", "1", "--seconds", "1"],
                       cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
