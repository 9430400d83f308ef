"""The ladder geometry of the shape buckets, torch-free: the part of the
reference's ``fastconsensus_tpu/analysis/footprint.py`` that the fleet
router needs.

The router (``serve/router.py``) derives a submission's route key from
the same ``{2^k, 3*2^k}`` grid the replica pads onto, and a router host
must never pay a torch import.  So this torch-free module holds the one
definition of the geometry: ``sizing.grid_up``, ``serve/bucketer.py``'s
class floors and batch ladder and ``models/louvain.py``'s path flip are
imported from here, and router and replicas cannot drift apart.

The rest of the reference's footprint pass (the device-memory model of
each bucket, the executable-surface count and the ``--hbm-bytes`` chip
ceiling) is not ported: on the card it becomes a model of CUDA memory
built on the sweep memory models (``louvain.sweep_temp_bytes``).
"""

from __future__ import annotations

from typing import List

# Floors keep tiny graphs (karate-sized probes) in one bucket.
MIN_NODE_CLASS = 64
MIN_EDGE_CLASS = 64
# Batch widths a server coalesces same-bucket jobs into (B = 1 is the
# solo path); powers of two cap the split overhead at one extra
# sub-batch per burst.
BATCH_RUNGS = (1, 2, 4, 8)
# The matmul/hash detection-path flip (models/louvain.py).
MATMUL_MAX_N = 1024


def grid_up(n: int, minimum: int = 1) -> int:
    """Smallest value >= n on the coarse {2^k, 3*2^k} grid (1, 2, 3, 4,
    6, 8, 12, 16, 24, 32, 48, 64, ...), the reference's rule.  The shape
    buckets (``serve/bucketer.py``) pad every graph's node and edge counts
    up to it; successive classes are at most 4/3 apart."""
    n = max(int(n), int(minimum), 1)
    p = 1
    while p < n:
        p *= 2
    q = (3 * p) // 4
    return q if p >= 4 and q >= n else p


def grid_values(lo: int, hi: int) -> List[int]:
    """Every grid class in [grid_up(lo), grid_up(hi)], ascending."""
    lo, hi = grid_up(lo), grid_up(hi)
    out, v = [], lo
    while v <= hi:
        out.append(v)
        v = grid_up(v + 1)
    return out
