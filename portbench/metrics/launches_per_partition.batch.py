"""Device records (kernels, copies, memsets) of a batch cell's profiler
session over the partitions detected in its window: the host's dispatch
work for each partition, which captured or fused rounds cut at the cost
of graph pools (``peak_reserved_gib``)."""


def read(facts):
    tr = facts.get("trace")
    if not tr or not tr["records"] or not facts["partitions"]:
        return None
    return tr["records"] / facts["partitions"]
