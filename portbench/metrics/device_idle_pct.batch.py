"""Share of a batch cell's window in which no operation ran on the card:
the union of the device records' intervals of the window's profiler
session.  In a host-paced batch cell the cure is to capture or fuse the
round, which the card pays for in graph pools (``peak_reserved_gib``)."""


def read(facts):
    tr = facts.get("trace")
    if not tr or not tr["records"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / facts["window_s"])
