"""Peaks of the card and the least bytes and operations of the port's
kernels, frozen with the benchmark.

Peaks: NVIDIA's H100 SXM data sheet (dense, at the 700 W limit): HBM3 at
3.35 TB/s and 67 TFLOP/s of FP32 outside the tensor cores.

``row_totals`` (``ops/csrc/row_totals.cu``) reads each slot's int32 label
and float32 weight and writes its float32 total and one byte of head:
13 bytes a slot.  Its least work is a sort of each row's labels and a sum
over its runs, ``D * log2(D)`` operations a row of ``D`` slots.  These
are the counts ``chip_smoke.row_totals_bound`` has used since the kernel
was ported.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
ROW_TOTALS_SLOT_BYTES = 13.0


def row_totals_bound_s(rows: int, d: int) -> float:
    """Least seconds of one ``row_totals`` launch on ``[rows, d]``."""
    t_bytes = rows * d * ROW_TOTALS_SLOT_BYTES / PEAK_BYTES_S
    t_ops = rows * d * math.log2(max(d, 2)) / PEAK_FP32_S
    return max(t_bytes, t_ops)


def row_totals_bound_total_s(shapes: Dict[Tuple[int, int], int]) -> float:
    """Least seconds of every launch counted in ``{(rows, d): launches}``."""
    return sum(k * row_totals_bound_s(r, d) for (r, d), k in shapes.items())
