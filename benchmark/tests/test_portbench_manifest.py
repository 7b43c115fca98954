"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units and lengths, and every name it gives resolving to its file."""

import json
import os
import re

import pytest

from benchmark import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(harness.ROOT, p))
        assert not p.endswith("_torch")
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    files = [w for w in cmd if "/" in w]
    assert files and all(any(w.startswith(p + "/") for p in MAN["paths"])
                         for w in files)
    assert all(os.path.exists(os.path.join(harness.ROOT, w)) for w in files)
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] \
        <= 51


def _names(key):
    return [x["name"] for x in MAN[key]]


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_are_allowed_and_unique(key):
    names = _names(key)
    assert names and all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def test_metric_names_unique_across_kinds():
    names = _names("end_to_end") + _names("per_layer")
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert _line(cfg["source"]) and _line(cfg["why"])
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert harness.config(cfg["name"])["name"] == cfg["name"]
    assert len(cfg["reduced"]) <= 16 and all(NAME.match(k)
                                             for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    assert cell["config"] in _names("configs")
    assert NAME.match(cell["traffic"])
    mix = harness.traffic(cell["traffic"])
    assert hasattr(harness.driver(mix["kind"]), "run")
    lim = harness.limits(cell["name"])
    assert lim and all(isinstance(v, (int, float)) for v in lim.values())
    e2e = {m["name"] for m in harness.cell_metrics(MAN, cell["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(MAN, cell["name"], True)


def test_cells_pairs_unique():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("m", MAN["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    for w in m.get("workloads", []):
        assert w in _names("workloads")


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_resolves(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES and _line(m["layer"])
    assert m["moves"] in _names("end_to_end")
    for w in m["workloads"]:
        reports = {x["name"] for x in harness.cell_metrics(MAN, w, False)}
        assert m["moves"] in reports
    assert callable(harness.metric_reader(m["name"]))
    if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
            or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_setup_bound():
    setup = [m for m in MAN["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


def test_every_file_under_paths_is_named_from_name_characters():
    for p in MAN["paths"]:
        for root, dirs, files in os.walk(os.path.join(harness.ROOT, p)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in files:
                assert re.match(r"^[A-Za-z0-9_.-]+$", f), f


def test_json_files_parse():
    for sub in ("configs", "traffic", "limits"):
        for f in os.listdir(os.path.join(harness.HERE, sub)):
            with open(os.path.join(harness.HERE, sub, f)) as fh:
                json.load(fh)
