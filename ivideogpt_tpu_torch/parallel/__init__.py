"""Data- and tensor-parallel training and serving over torch.distributed:
the port of ``ivideogpt_tpu/parallel``, with its exports. Three of them are
JAX placements with no array to place here, where a rank holds plain local
tensors: ``batch_sharding`` becomes :func:`batch_rows` (a rank's rows of
the global batch), ``global_batch`` becomes :func:`shard_batch` (every
rank is handed the global batch and keeps its rows), and ``replicated``
has no counterpart (a tensor that is not cut is whole on every rank)."""

from ivideogpt_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_rows,
    make_global_mesh,
    make_mesh,
    shard_batch,
    shard_params,
)
from ivideogpt_tpu_torch.parallel.distributed import (  # noqa: F401
    agreed_timestamp,
    all_reduce_mean,
    gather_across_processes,
    is_main_process,
    maybe_initialize,
    params_to_host,
)
