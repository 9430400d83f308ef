"""Member partitions detected in a batch cell's traced window over its
length: ``partitions_per_s``'s reading where the host's pace spreads it
too widely for an end-to-end bound.  The profiler's host cost is in it,
so it reads below an untraced window's rate."""


def read(facts):
    return facts["partitions"] / facts["window_s"]
