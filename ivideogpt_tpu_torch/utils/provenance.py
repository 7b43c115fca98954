"""Run provenance: what code, what flags, launched how. The port's own copy
of ``ivideogpt_tpu/utils/provenance.py``.

The reference snapshots the full source tree into each run dir with
rsync + a cmd.sh (reference train_tokenizer.py:336-341,
train_gpt.py:565-570, mbrl/train_metaworld_mbpo.py:399-400). The
git-native equivalent: cmd.json (argv + flags + git SHA) plus
src_diff.patch capturing any uncommitted source changes — together they
pin the exact code state without copying the tree into every run. Outside
a git checkout both are recorded as unknown (``None``), quietly.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def write_provenance(output_dir: str, args) -> None:
    prov = dict(vars(args)) if not isinstance(args, dict) else dict(args)
    prov["argv"] = sys.argv
    root = _repo_root()
    try:
        prov["git_rev"] = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=root, text=True,
            stderr=subprocess.DEVNULL).strip()
    except Exception:
        prov["git_rev"] = None
    diff = None
    try:
        diff = subprocess.check_output(
            ["git", "diff", "HEAD"], cwd=root, text=True,
            stderr=subprocess.DEVNULL)
        prov["git_dirty"] = bool(diff.strip())
    except Exception:
        prov["git_dirty"] = None
    with open(os.path.join(output_dir, "cmd.json"), "w") as f:
        json.dump(prov, f, indent=2, default=str)
    patch = os.path.join(output_dir, "src_diff.patch")
    if diff and diff.strip():
        with open(patch, "w") as f:
            f.write(diff)
    elif prov["git_dirty"] is False:
        # a resume from a KNOWN-clean tree must not leave a stale patch
        # contradicting cmd.json's git_dirty=false. git_dirty=None (git
        # unavailable) keeps the prior run's patch — it may be the only
        # record of what code ran. missing_ok: every process writes
        # provenance into the shared run dir concurrently.
        try:
            os.remove(patch)
        except FileNotFoundError:
            pass
