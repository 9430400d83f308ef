"""The ``row_totals`` kernel's share of its roofline: the least time of
every launch in the window (its shapes from the program's counter
``ops/row_kernels.ROW_TOTALS_SHAPES``, its bytes and the card's peaks
from ``portbench/roofline.py``) over the kernel's summed device time in
the window's profiler session."""

from portbench import roofline


def read(facts):
    tr = facts.get("trace")
    shapes = facts.get("row_totals_shapes")
    if not tr or not shapes:
        return None
    spent = sum(s for name, s in tr["seconds_by_name"].items()
                if "row_totals" in name)
    if spent <= 0:
        return None
    return 100.0 * roofline.row_totals_bound_total_s(shapes) / spent
