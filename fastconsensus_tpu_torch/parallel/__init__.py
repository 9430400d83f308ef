"""Device mesh: the layout (``sharding``) and the collectives that stand
in for XLA's SPMD partitioner (``collectives``), in one process or
across the processes of a ``torch.distributed`` run."""

from fastconsensus_tpu_torch.parallel.sharding import (  # noqa: F401
    EDGE_AXIS,
    ENSEMBLE_AXIS,
    Mesh,
    ShardedSlab,
    gather_labels,
    gather_slab,
    initialize_multihost,
    make_mesh,
    pad_n_p,
    process_count,
    process_index,
    replicate_slab,
    shard_keys,
    shard_labels,
    shard_slab,
    shutdown_multihost,
)
