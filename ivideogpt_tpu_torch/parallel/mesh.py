"""The ("data", "model") mesh of a multi-process run and the tensor-parallel
placement rules: the port of ``ivideogpt_tpu/parallel/mesh.py``.

Each process holds one card and is one point of the mesh:

    rank = data_rank * n_model + model_rank

so the ranks of one tensor-parallel ("model") group are consecutive, and
stay on one host under ``torch.distributed.run`` (the counterpart of the
JAX hybrid mesh keeping "model" inside a granule). Data parallelism splits
the batch over "data": rank d of the data axis holds global rows
[d B, (d + 1) B) of a global batch of n_data B (:func:`batch_rows`).
Tensor parallelism splits the LLaMA projections over "model"
(:func:`param_spec`): q/k/v/gate/up_proj are column-parallel (their output
features, torch dim 0, split), o/down_proj row-parallel (their input
features, dim 1, split, the partial outputs summed over the group);
everything else, ``embed_tokens`` and ``lm_head`` included, stays whole on
every rank. The JAX rule splits the embedding and the head too, but that
is placement only and computes the same numbers; whole, they need no
gather of the vocabulary's logits.

:class:`Mesh` holds the process groups; it is the port's own class, not
``torch.distributed.device_mesh.DeviceMesh``, which selects a card by rank
and so cannot put two ranks on one card, as the one-card checks do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ivideogpt_tpu_torch.models.llama import LlamaAttention, LlamaMLP
from ivideogpt_tpu_torch.parallel import distributed as dist_lib
from ivideogpt_tpu_torch.train.optim import global_norm
from ivideogpt_tpu_torch.utils.platform import resolve_device

COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW = ("o_proj", "down_proj")


@dataclass(frozen=True)
class Mesh:
    """This process's place on the ("data", "model") mesh and the groups
    of its two axes (None for an axis of one)."""
    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    # The collectives of one axis; an axis of one has no group (a None group
    # would be the whole world) and does nothing.
    def data_mean_(self, tensors) -> None:
        """Each tensor replaced by its mean over the data axis."""
        if self.n_data > 1:
            dist_lib.all_reduce_mean(tensors, self.data_group)

    def data_mean(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """0-dim tensors' means over the data axis."""
        if self.n_data == 1:
            return list(values)
        return dist_lib.data_mean(values, self.data_group)

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the model axis."""
        if self.n_model == 1:
            return t
        return dist_lib.all_reduce_sum(t, self.model_group)

    def model_broadcast(self, obj):
        """The model group's first rank's ``obj`` (picklable: CPU tensors,
        numbers), on every rank of the group: a tensor-parallel group reads
        one stream of batches, however its first rank's loader threads
        ordered them."""
        if self.n_model == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.data_rank * self.n_model,
                                   group=self.model_group)
        return box[0]

    def host(self, tensors: Dict[str, torch.Tensor],
             split: Dict[str, int]) -> Dict[str, torch.Tensor]:
        """The full tensors on the CPU, those named in ``split`` gathered
        over the model axis (``distributed.params_to_host``): a collective
        of the model group."""
        if self.n_model == 1:
            split = {}
        return dist_lib.params_to_host(tensors, split, self.model_group)


def make_global_mesh(n_model: int = 1) -> Mesh:
    """The mesh over every process of the group (one process a card), or
    the mesh of one outside a process group. Every rank calls it: it makes
    the axes' groups, all of them on every rank, in one order."""
    world = dist_lib.process_count()
    if n_model < 1 or world % n_model:
        raise ValueError(f"{world} processes do not split into tensor-"
                         f"parallel groups of {n_model}")
    n_data = world // n_model
    rank = dist_lib.process_index()
    data_group = model_group = None
    if world > 1:
        for m in range(n_model):
            ranks = [d * n_model + m for d in range(n_data)]
            g = dist.new_group(ranks) if n_data > 1 else None
            if rank in ranks:
                data_group = g
        for d in range(n_data):
            ranks = [d * n_model + m for m in range(n_model)]
            g = dist.new_group(ranks) if n_model > 1 else None
            if rank in ranks:
                model_group = g
    return Mesh(n_data, n_model, rank // n_model, rank % n_model,
                data_group, model_group)


def bootstrap(coordinator_address: Optional[str],
              num_processes: Optional[int], process_id: Optional[int],
              n_model: int, device: str, backend: Optional[str] = None
              ) -> Tuple[torch.device, Mesh]:
    """A trainer CLI's device and mesh: joins the process group when the
    flags or ``torch.distributed.run`` ask for one
    (``distributed.maybe_initialize``), then makes the global mesh; one
    process on ``device`` otherwise. Raises when more than one process is
    asked for and no group is joined, when the processes do not split
    into ``n_model``, and when CUDA is wanted and absent."""
    joined = dist_lib.maybe_initialize(coordinator_address, num_processes,
                                       process_id, device=device,
                                       backend=backend)
    if joined:
        dev = dist_lib.local_device(device, dist_lib.process_index())
    else:
        if (num_processes or 1) > 1:
            raise ValueError(f"--num_processes {num_processes} needs "
                             f"--coordinator_address or torch.distributed."
                             f"run's variables")
        dev = resolve_device(device)
    return dev, make_global_mesh(n_model)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """:func:`make_global_mesh`, checking ``n_data`` where given."""
    mesh = make_global_mesh(n_model)
    if n_data is not None and n_data != mesh.n_data:
        raise ValueError(f"n_data {n_data} x n_model {n_model} is not the "
                         f"{dist_lib.process_count()} processes")
    return mesh


def param_spec(name: str, shape) -> Tuple[Optional[str], ...]:
    """The mesh axis of each dim of a parameter, by name, in the port's
    torch layout (a Linear's weight is [out, in]): ("model", None) for a
    column-parallel weight, (None, "model") for a row-parallel one, all
    None (replicated) otherwise."""
    spec: List[Optional[str]] = [None] * len(shape)
    if len(shape) == 2 and any(k in name for k in COLUMN):
        spec[0] = "model"
    elif len(shape) == 2 and any(k in name for k in ROW):
        spec[1] = "model"
    return tuple(spec)


def _split_dim(name: str, shape) -> Optional[int]:
    spec = param_spec(name, shape)
    return spec.index("model") if "model" in spec else None


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut each weight of ``model`` to this rank's shard per
    :func:`param_spec` and give its attention and MLP blocks their local
    heads, columns and group, in place; returns ``model``. Records the
    split dims as ``model.tp_split_dims`` (name -> dim), which
    :func:`split_dims` reads. Raises where the KV heads or the MLP width do
    not split over ``n_model``. A no-op for n_model 1."""
    n, r = mesh.n_model, mesh.model_rank
    model.tp_split_dims = {}
    if n == 1:
        return model
    for m in model.modules():
        if isinstance(m, LlamaAttention):
            c = m.config
            if c.num_key_value_heads % n:
                raise ValueError(f"{c.num_key_value_heads} KV heads do not "
                                 f"split over {n} tensor-parallel ranks")
            m.heads = c.num_attention_heads // n
            m.kv_heads = c.num_key_value_heads // n
            m.head0 = r * m.heads
            m.tp_group = mesh.model_group
        elif isinstance(m, LlamaMLP):
            if m.intermediate_size % n:
                raise ValueError(f"MLP width {m.intermediate_size} does not "
                                 f"split over {n} tensor-parallel ranks")
            m.tp_group = mesh.model_group
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = _split_dim(name, p.shape)
            if dim is None:
                continue
            size = p.shape[dim] // n
            p.data = p.data.narrow(dim, r * size, size).contiguous().clone()
            model.tp_split_dims[name] = dim
    return model


def split_dims(model: nn.Module) -> Dict[str, int]:
    """name -> dim of every parameter :func:`shard_params` cut."""
    return dict(getattr(model, "tp_split_dims", {}))


def batch_rows(B: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of B: the data rank's B / n_data
    consecutive rows (every rank of a model group the same). Raises where
    B does not split."""
    if B % mesh.n_data:
        raise ValueError(f"batch {B} not divisible by the data axis "
                         f"{mesh.n_data}")
    b = B // mesh.n_data
    return slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows (:func:`batch_rows`) of each array or tensor of a
    batch (a dict, a tuple or one array)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return batch[batch_rows(batch.shape[0], mesh)]


def grad_norm_fn(names: List[str], mesh: Mesh, split: Dict[str, int]):
    """The clip's global norm over gradients in the order of ``names``:
    the squares of the split parameters summed over the model group, the
    replicated ones counted once. Plain ``global_norm`` without a split."""
    sharded = [name in split for name in names]
    if not any(sharded) or mesh.n_model == 1:
        return global_norm

    @torch.no_grad()
    def norm(grads):
        grads = list(grads)
        sq = [(g.float() ** 2).sum() for g in grads]
        whole = sum(s for s, cut in zip(sq, sharded) if not cut)
        part = mesh.model_sum(sum(s for s, cut in zip(sq, sharded) if cut))
        return torch.sqrt(whole + part)
    return norm


def place_state(state, mesh: Mesh):
    """Give a ``TrainState`` built over a (sharded) model the mesh's clip
    norm (:func:`grad_norm_fn`); returns it."""
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    state.grad_norm = grad_norm_fn(names, mesh, split_dims(state.model))
    return state


class HostState:
    """A layout-free view of a ``TrainState`` on a mesh, for the
    checkpoint functions (``utils/checkpoint``): ``state_dict()`` is the
    full state on the CPU (the split parameters, their AdamW moments and
    accumulation buffers all-gathered over the model group: a collective),
    ``load_state_dict`` cuts a full state to this rank's shard and loads
    it. So a checkpoint written at one layout resumes at any other."""

    def __init__(self, state, mesh: Mesh):
        self.state, self.mesh = state, mesh
        named = [(n, p) for n, p in state.model.named_parameters()
                 if p.requires_grad]
        split = split_dims(state.model)
        self._split = split
        # the split dim of each accumulation buffer (``state.params``'
        # order) and of each AdamW state entry (its groups' order)
        self._dims = [split.get(n) for n, _ in named]
        dim_of = {id(p): split.get(n) for n, p in named}
        self._opt_dims = [dim_of[id(p)] for g in state.optimizer.param_groups
                          for p in g["params"]]

    def _gather(self, t, dim):
        return self.mesh.host({"t": t}, {} if dim is None else {"t": dim})["t"]

    def state_dict(self) -> Dict:
        sd = self.state.state_dict()
        sd["model"] = self.mesh.host(sd["model"], self._split)
        opt = sd["optimizer"]
        opt = {"state": {i: {k: (self._gather(v, self._opt_dims[i])
                                 if torch.is_tensor(v) and v.ndim else v)
                             for k, v in entry.items()}
                         for i, entry in opt["state"].items()},
               "param_groups": opt["param_groups"]}
        sd["optimizer"] = opt
        if sd["acc"] is not None:
            sd["acc"] = [self._gather(a, d)
                         for a, d in zip(sd["acc"], self._dims)]
        return sd

    def _cut(self, t, dim):
        if dim is None or self.mesh.n_model == 1:
            return t
        size = t.shape[dim] // self.mesh.n_model
        return t.narrow(dim, self.mesh.model_rank * size, size)

    def load_state_dict(self, sd: Dict):
        sd = dict(sd)
        sd["model"] = {k: self._cut(v, self._split.get(k))
                       for k, v in sd["model"].items()}
        opt = sd["optimizer"]
        sd["optimizer"] = {
            "state": {i: {k: (self._cut(v, self._opt_dims[int(i)])
                              if torch.is_tensor(v) and v.ndim else v)
                          for k, v in entry.items()}
                      for i, entry in opt["state"].items()},
            "param_groups": opt["param_groups"]}
        if sd["acc"] is not None:
            sd["acc"] = [self._cut(a, d) for a, d in zip(sd["acc"],
                                                        self._dims)]
        self.state.load_state_dict(sd)
