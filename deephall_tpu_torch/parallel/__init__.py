"""Walker data parallelism over ``torch.distributed`` (port of ``deephall_tpu/parallel``).

The JAX package shards one global walker array over a device mesh and lets
XLA partition every global mean into per-shard sums and an all-reduce.  Here
each rank holds its contiguous shard of the global ``[batch, nelec, 2]``
walkers and every global reduction is an explicit collective of
:mod:`~deephall_tpu_torch.parallel.mesh`.  Every rank draws the random numbers
of the whole batch from the same seeded generator and keeps its own rows, so
that the chain, the statistics and the checkpoints do not depend on the
number of ranks; checkpoints hold the gathered global batch.

    torchrun --nproc_per_node=K -m deephall_tpu_torch.train key=value ...
"""

from deephall_tpu_torch.parallel.mesh import (
    BACKENDS,
    all_gather_rows,
    all_reduce_max,
    all_reduce_mean,
    all_reduce_sum,
    broadcast_,
    draw_rows,
    in_group,
    initialize_distributed,
    launch_env,
    rank,
    rendezvous_port,
    shard_rows,
    shutdown_distributed,
    world_size,
)

__all__ = [
    "BACKENDS",
    "all_gather_rows",
    "all_reduce_max",
    "all_reduce_mean",
    "all_reduce_sum",
    "broadcast_",
    "draw_rows",
    "in_group",
    "initialize_distributed",
    "launch_env",
    "rank",
    "rendezvous_port",
    "shard_rows",
    "shutdown_distributed",
    "world_size",
]
