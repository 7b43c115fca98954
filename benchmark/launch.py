"""A cell on several chips: the process the benchmark is started as is rank
0; it starts one more process a card, each the same command with its rank,
and all join one ``torch.distributed`` group through the port's
``parallel/distributed.maybe_initialize`` (``tcp://localhost:<port>``).
Rank 0 waits for every other rank before it exits.
"""

from __future__ import annotations

import socket
import subprocess
from typing import List


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_others(cmd: List[str], world: int, port: int
                 ) -> List[subprocess.Popen]:
    """Ranks 1 .. world - 1 of ``cmd``, their output discarded (rank 0
    prints the result)."""
    return [subprocess.Popen(cmd + ["--rank", str(k), "--world", str(world),
                                    "--port", str(port)],
                             stdout=subprocess.DEVNULL)
            for k in range(1, world)]


def join(rank: int, world: int, port: int, device, backend: str):
    from ivideogpt_tpu_torch.parallel import distributed
    distributed.maybe_initialize(f"localhost:{port}", world, rank,
                                 device=device, backend=backend)


def finish(children: List[subprocess.Popen], world: int,
           timeout: float = 300.0) -> List[int]:
    """Leave the group and wait for every started rank; a rank that has
    not ended by ``timeout`` is killed. Returns their exit codes."""
    if world > 1:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    codes = []
    for c in children:
        try:
            codes.append(c.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            c.kill()
            codes.append(c.wait())
    return codes
