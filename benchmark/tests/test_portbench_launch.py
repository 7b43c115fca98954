"""The multi-chip path on the CPU: rank 0 starts the other ranks with
``launch.spawn_others``, all join one group through the port's bootstrap
(gloo here, NCCL on the cards), a stub cell sums one number a rank, and
rank 0 alone prints the result line."""

import json
import os
import subprocess
import sys
import textwrap

from benchmark import harness, launch

STUB = textwrap.dedent("""
    import argparse, sys
    sys.path.insert(0, {root!r})
    import torch
    import torch.distributed as dist
    from benchmark import harness, launch
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--port", type=int, default=0)
    a = p.parse_args()
    children = []
    if a.rank == 0:
        a.world, a.port = 2, launch.free_port()
        children = launch.spawn_others([sys.executable, __file__], 2, a.port)
    try:
        launch.join(a.rank, a.world, a.port, torch.device("cpu"), "gloo")
        x = torch.tensor([float(a.rank + 1)])
        dist.all_reduce(x)
        if a.rank == 0:
            print(harness.result_line(
                True, 1, 0, {{"setup_s": (1.0, "s")}},
                {{"platform": "cpu", "count": dist.get_world_size(),
                  "memory_peak_bytes": 0}}, {{"sum": (float(x), 3.0)}}))
    finally:
        codes = launch.finish(children, a.world, timeout=60)
        assert codes == [0] * len(children), codes
""")


def test_two_ranks_over_gloo(tmp_path):
    script = tmp_path / "stub_cell.py"
    script.write_text(STUB.format(root=harness.ROOT))
    p = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=180,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["device"]["count"] == 2
    assert out["checks"]["sum"]["value"] == 3.0


def test_free_port_is_a_port():
    assert 0 < launch.free_port() < 65536
