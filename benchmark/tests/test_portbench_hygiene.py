"""What the benchmark may import: nothing of JAX or the JAX package anywhere
under it (top-level module names compared whole, so ``ivideogpt_tpu_torch``
is not ``ivideogpt_tpu``), nothing of the program in the reference, and
neither ``chip_smoke`` nor ``bench``."""

import ast
import os

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "ivideogpt_tpu", "chip_smoke", "bench"}


def _files():
    out = []
    for root, dirs, files in os.walk(harness.HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax_package(path):
    for mod in imported(path):
        assert mod.split(".")[0] not in FORBIDDEN, f"{path} imports {mod}"


@pytest.mark.parametrize(
    "path", [p for p in _files() if os.sep + "reference" + os.sep in p],
    ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_reference_imports_nothing_of_the_program(path):
    for mod in imported(path):
        top = mod.split(".")[0]
        assert top != "ivideogpt_tpu_torch", f"{path} imports {mod}"
        if top == "benchmark":
            assert mod.startswith("benchmark.reference"), mod


def test_whole_name_comparison():
    assert "ivideogpt_tpu_torch".split(".")[0] not in {"ivideogpt_tpu"}
    assert harness.forbidden_modules() == []
