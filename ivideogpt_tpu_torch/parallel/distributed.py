"""Multi-process bootstrap and the collectives of the port's parallel paths:
the port of ``ivideogpt_tpu/parallel/distributed.py`` over
``torch.distributed``.

The reference trains with HF Accelerate, one DDP process per GPU over NCCL
(SURVEY §2.13); the JAX package joins processes with
``jax.distributed.initialize`` and lets GSPMD insert the collectives. Here
each process holds one card, joins one process group, and the port calls
the collectives itself:

- :func:`maybe_initialize` joins the group from explicit flags
  (``--coordinator_address host:port --num_processes N --process_id i``) or
  from the variables ``torch.distributed.run`` sets (``MASTER_ADDR``,
  ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), and does nothing without
  either. A join that fails raises, on auto-detection too: the JAX
  package's fallback to one process after a failed auto-init is not
  copied, since a run that silently trains on one card of N is a wrong
  run, not a slower one.
- :func:`all_reduce_mean` is the data-parallel gradient reduction, one
  flattened buffer per dtype (the JAX step's psum over "data");
  :func:`copy_to_group` and :func:`reduce_from_group` are the pair of
  autograd functions around a tensor-parallel block (Megatron's f and g).
- :func:`gather_across_processes` (eval features and losses, uneven row
  counts too), :func:`params_to_host` (the full state on the CPU from its
  shards), :func:`agreed_timestamp` (rank 0's clock).

Over gloo every collective runs on a CPU copy of its tensors, so a group
works the same whether the tensors lie on the CPU or on a card: gloo's own
CUDA support covers few collectives, and two ranks that share one card
(NCCL refuses them) use gloo. Over NCCL the tensors stay on the card.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# how long a collective waits for its peers before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def local_device(device="cuda", process_id: Optional[int] = None
                 ) -> torch.device:
    """This process's device: ``device`` itself where it names an index or
    is not CUDA, else ``cuda:LOCAL_RANK`` (``torch.distributed.run``'s
    local rank; without it, ``process_id`` modulo the host's cards, 0 for
    one process). Raises when that card does not exist."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    rank = _env_int("LOCAL_RANK")
    if rank is None:
        rank = (process_id or 0) % n
    if not 0 <= rank < n:
        raise RuntimeError(f"LOCAL_RANK {rank}: this host has {n} CUDA "
                           f"device(s)")
    return torch.device("cuda", rank)


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device="cuda",
                     backend: Optional[str] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join the process group iff a multi-process run is configured, by the
    explicit flags or by ``torch.distributed.run``'s variables; returns
    whether this process is in a group after the call (a second call is a
    no-op). ``backend`` defaults to "nccl" for a CUDA ``device`` and "gloo"
    otherwise; a CUDA process selects its card (:func:`local_device`)
    before the group exists. Raises when the join fails."""
    if dist.is_initialized():
        return True
    explicit = coordinator_address is not None
    env = all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                        "WORLD_SIZE", "RANK"))
    if not (explicit or env):
        return False
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes "
                             "and --process_id")
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=int(num_processes), rank=int(process_id))
    else:
        init = dict(init_method="env://",
                    world_size=int(os.environ["WORLD_SIZE"]),
                    rank=int(os.environ["RANK"]))
    dev = local_device(device, init["rank"])
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, timeout=timeout, **init)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def group_size(group=None) -> int:
    """The ranks of ``group`` (the whole world for None); 1 outside a
    process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _comm_device(group=None) -> torch.device:
    """Where a collective of ``group`` runs: the CPU over gloo, this
    process's card over NCCL."""
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` in place over ``group``, in its own dtype."""
    dev = _comm_device(group)
    if t.device == dev:
        dist.all_reduce(t, group=group)
        return t
    buf = t.to(dev)
    dist.all_reduce(buf, group=group)
    t.copy_(buf)
    return t


def all_reduce_mean(grads: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over ``group``, in place: one
    flattened buffer per dtype, one all-reduce each. Every rank ends with
    the same bits (one reduction's result, sent to all). A no-op for a
    group of one."""
    if group_size(group) == 1:
        return
    n = group_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = _all_reduce_sum_(torch.cat([t.reshape(-1) for t in ts]),
                                    group)
            flat /= n
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """A new tensor: ``t`` summed over ``group``, in fp32 and back to
    ``t``'s dtype (a bf16 partial sum is rounded once, after the sum)."""
    if group_size(group) == 1:
        return t
    return _all_reduce_sum_(t.float().clone(), group).to(t.dtype)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, gradient summed over the group backward: the input
    of a column-parallel block, which every rank reads whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward, identity backward: the output of a
    row-parallel block, each rank holding a partial sum."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def _all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (of one shape) in rank order, on ``t``'s device."""
    dev = _comm_device(group)
    src = t.contiguous().to(dev)
    out = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


def gather_across_processes(x, group=None):
    """All ranks' ``x`` concatenated along axis 0 in rank order (a tiled
    all-gather), rows of any count per rank: the sizes are gathered first,
    each rank's rows padded to the largest and trimmed after. A numpy
    array in, a numpy array out; a tensor keeps its device. Returns the
    input unchanged outside a process group. A collective: every rank of
    ``group`` calls it."""
    if not dist.is_initialized() or group_size(group) == 1:
        return x
    is_np = not torch.is_tensor(x)
    t = torch.from_numpy(np.ascontiguousarray(x)) if is_np else x
    n = torch.tensor([t.shape[0]], dtype=torch.int64)
    sizes = [int(s) for s in _all_gather(n, group)]
    pad = max(sizes) - t.shape[0]
    if pad:
        t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
    parts = _all_gather(t, group)
    out = torch.cat([p[:s] for p, s in zip(parts, sizes)])
    return out.numpy() if is_np else out


def params_to_host(tensors: Dict[str, torch.Tensor],
                   split_dims: Optional[Dict[str, int]] = None,
                   group=None) -> Dict[str, torch.Tensor]:
    """The full, unsharded tensors on the CPU: each tensor named in
    ``split_dims`` is all-gathered over ``group`` (the tensor-parallel
    group that cut it) and concatenated along its dim, the others copied.
    A collective: every rank of ``group`` calls it."""
    split_dims = split_dims or {}
    out = {}
    for name, t in tensors.items():
        t = t.detach()
        if name in split_dims and group_size(group) > 1:
            t = torch.cat(_all_gather(t, group), dim=split_dims[name])
        out[name] = t.cpu().clone()
    return out


def barrier(group=None) -> None:
    if dist.is_initialized():
        dist.barrier(group=group)


def agreed_timestamp() -> float:
    """Rank 0's wall clock, sent to every rank (float64), so run
    directories named from it are the same path on every rank; plain
    ``time.time()`` outside a process group."""
    t = time.time()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return t
    buf = torch.tensor([t], dtype=torch.float64, device=_comm_device())
    dist.broadcast(buf, src=0)
    return float(buf.item())


def data_mean(values: Iterable[torch.Tensor], group=None
              ) -> List[torch.Tensor]:
    """0-dim tensors' means over ``group`` (one all-reduce for all), as
    fp32 tensors on their devices: a metric every rank agrees on."""
    values = list(values)
    if group_size(group) == 1 or not values:
        return values
    flat = torch.stack([v.detach().float().reshape(()) for v in values])
    _all_reduce_sum_(flat, group)
    flat /= group_size(group)
    return list(flat.unbind())
