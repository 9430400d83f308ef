"""Device mesh: the layout (``sharding``) and the collectives that stand
in for XLA's SPMD partitioner (``collectives``)."""

from fastconsensus_tpu_torch.parallel.sharding import (  # noqa: F401
    EDGE_AXIS,
    ENSEMBLE_AXIS,
    Mesh,
    ShardedSlab,
    gather_labels,
    gather_slab,
    make_mesh,
    pad_n_p,
    replicate_slab,
    shard_keys,
    shard_labels,
    shard_slab,
)
