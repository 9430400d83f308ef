"""Device records (kernels, copies, memsets) of the window's profiler
session over the partitions detected in the window: the host's dispatch
work for each partition."""


def read(facts):
    tr = facts.get("trace")
    if not tr or not tr["records"] or not facts["partitions"]:
        return None
    return tr["records"] / facts["partitions"]
