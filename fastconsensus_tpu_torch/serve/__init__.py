"""The engine seams of the serving tier: shape buckets, canonical edges
and fcdelta's edge deltas (numpy), on which a server calls
``consensus.run_consensus_batch`` and ``run_consensus(init_labels=,
active_mask=)``."""
