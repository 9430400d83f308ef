"""Share of the window in which no operation ran on the card: the union
of the device records' intervals of the window's profiler session."""


def read(facts):
    tr = facts.get("trace")
    if not tr or not tr["records"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / facts["window_s"])
