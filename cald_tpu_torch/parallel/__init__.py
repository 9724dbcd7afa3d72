"""Multi-process data parallelism on ``torch.distributed`` (port of
``cald_tpu.parallel``): one full replica per rank, the data strided over the
ranks, gradients averaged, pool scores and evaluation results merged on the
host. ``mesh.py``'s docstring maps the JAX package's mesh functions to
their counterparts."""

from cald_tpu_torch.parallel.mesh import (
    all_gather_objects,
    broadcast_module_,
    gather_cat,
    initialize_distributed,
    local_rank,
    process_count,
    process_draw,
    process_index,
    process_mean,
    process_merge_sum,
    process_shard,
    reduce_gradients_,
)

__all__ = [
    "initialize_distributed", "process_count", "process_index", "local_rank",
    "process_shard", "all_gather_objects", "process_merge_sum", "process_mean",
    "broadcast_module_", "reduce_gradients_", "gather_cat", "process_draw",
]
