"""Each cell's driver run through on the CPU at a tiny size, past the
harness's look for a card: a sound run's numbers; the control (the
reference one precision step down, in the program's place) reading
well above them; and each fault the cell can have, planted in the
program underneath the cell's own calls, coming out not correct under
the cell's limits."""

import pytest

from benchmark import calibrate, harness
from benchmark.cells import gpttrain, rollout
from benchmark.reference.numerics import Precision
from benchmark.tests import tiny

TRAIN_CELLS = [("medium-gpttrain-b16", "pretrain-select-b16", False),
               ("base-gpttrain-b16", "finetune-bair-b16", True)]


def _correct(name, numbers):
    return all(v <= lim for v, lim in harness.judge(
        numbers, harness.limits(name)).values())


@pytest.fixture(scope="module")
def rollout_run():
    cfg, mix = tiny.config(), tiny.rollout_mix()
    out = rollout.run(tiny.run("base-rollout-b256", cfg, mix))
    return cfg, mix, out


def test_rollout_sound_run(rollout_run):
    cfg, mix, out = rollout_run
    assert out["attempted"] >= 1 and out["failed"] == 0
    fps = out["e2e"]["frames_per_s"][0]
    assert fps > 0
    nums = out["numbers"]
    assert set(nums) >= set(harness.limits("base-rollout-b256"))
    assert 0 <= nums["token_topk_gap"] < 0.05
    assert nums["frame_rel_err"] < 0.05


def test_rollout_control_reads_higher(rollout_run):
    cfg, mix, _ = rollout_run
    r = tiny.run("base-rollout-b256", cfg, mix)
    tok, lm, inputs, one = rollout.build(cfg, mix, r.seed, r.device)
    kept = rollout.collect(one, mix, r.seed, lambda: None, lambda n: n >= 2)
    prog = rollout.judge(cfg, mix, r.seed, r.device, inputs, kept)
    ctl = rollout.judge(cfg, mix, r.seed, r.device, inputs, kept, "fp8")
    assert any(ctl[k] >= 3 * prog[k] for k in ("frame_rel_err",
                                                "ctx_id_mismatch"))


def test_rollout_token_altered_is_not_correct():
    cfg, mix = tiny.config(), tiny.rollout_mix()
    with calibrate.FAULTS["rollout"]["token_altered"]():
        out = rollout.run(tiny.run("base-rollout-b256", cfg, mix))
    assert not _correct("base-rollout-b256", out["numbers"])


@pytest.mark.parametrize("name,traffic,action", TRAIN_CELLS,
                         ids=[c[0] for c in TRAIN_CELLS])
def test_train_sound_run(name, traffic, action):
    out = gpttrain.run(tiny.run(name, tiny.config(action),
                                tiny.train_mix(traffic)))
    assert out["attempted"] >= 1
    nums = out["numbers"]
    assert set(nums) >= set(harness.limits(name))
    assert nums["id_mismatch"] == 0.0 and nums["loss_gap"] < 1e-3


def _setup_readings(cfg, mix, seed, fault=None):
    import contextlib
    import shutil
    import tempfile
    import torch
    root = tempfile.mkdtemp()
    try:
        with (calibrate.FAULTS["gpttrain"][fault]() if fault
              else contextlib.nullcontext()):
            p = gpttrain.Program(cfg, mix, seed, torch.device("cpu"), root)
            try:
                return gpttrain.setup_steps(p, cfg, seed)
            finally:
                p.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("name,traffic,action", TRAIN_CELLS,
                         ids=[c[0] for c in TRAIN_CELLS])
def test_train_control_reads_higher(name, traffic, action):
    import torch
    cfg, mix = tiny.config(action), tiny.train_mix(traffic)
    mix["recipe"]["warmup_steps"] = 1
    seed = 2 ** 32 + 17
    dev = torch.device("cpu")
    kept = _setup_readings(cfg, mix, seed)
    ref = gpttrain.reference_run(cfg, mix, seed, dev, kept,
                                 Precision("fp32"), Precision("fp32"))
    prog = gpttrain.compare(kept, ref, ref["grad"])
    ctl_out = gpttrain.reference_run(cfg, mix, seed, dev, kept,
                                     Precision("tf32"), Precision("fp8"))
    ctl = gpttrain.compare(ctl_out, ref, ref["grad"])
    assert any(ctl[k] >= 3 * max(prog[k], 1e-12)
               for k in ("loss_gap", "grad_leaf_gap", "grad_norm_gap"))


@pytest.mark.parametrize("fault", sorted(calibrate.FAULTS["gpttrain"]))
@pytest.mark.parametrize("name,traffic,action", TRAIN_CELLS,
                         ids=[c[0] for c in TRAIN_CELLS])
def test_train_fault_is_not_correct(name, traffic, action, fault):
    mix = tiny.train_mix(traffic)
    mix["recipe"]["warmup_steps"] = 1
    with calibrate.FAULTS["gpttrain"][fault]():
        out = gpttrain.run(tiny.run(name, tiny.config(action), mix))
    assert not _correct(name, out["numbers"]), out["numbers"]
