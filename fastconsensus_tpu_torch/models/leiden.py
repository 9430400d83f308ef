"""Leiden-style detector: local move, refinement, aggregation, local move.

Counterpart of ``fastconsensus_tpu/models/leiden.py`` (one Leiden
iteration, the reference's ``leidenalg.find_partition(..., n_iterations=1)``
analog): a modularity local move on the graph; a theta-randomized
refinement that re-partitions each community from singletons on its own
intra-community edges; an aggregate graph over the refined groups, moved
from the unrefined communities; and the flat partition.

The refinement and aggregate levels differ per member (each member masks
and aggregates by its own communities), so they run on member-batched
slabs: one masked slab ``alive[M, capacity]`` and one aggregate slab
``[M, capacity]`` (compacted to ``agg_cap`` slots when
``graph.agg_compaction_active``) for all members at once, with every
lowering's rows and hub split taken per member, as the reference's vmap
gives them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fastconsensus_tpu_torch.graph import (GraphSlab, agg_compaction_active,
                                           compact_alive)
from fastconsensus_tpu_torch.models import louvain as lv
from fastconsensus_tpu_torch.models.base import Detector, ensemble
from fastconsensus_tpu_torch.ops import segment as seg
from fastconsensus_tpu_torch.utils import prng


def refine(slab: GraphSlab, comm: torch.Tensor, keys: torch.Tensor,
           max_sweeps: int = 16, gamma: float = 1.0,
           theta: float = 0.01) -> torch.Tensor:
    """Theta-randomized refinement within ``comm`` ``[M, N]``: each member
    re-partitions its communities from singletons on its intra-community
    edges (uncompacted labels ``[M, N]``).  ``theta`` is in leidenalg's
    unnormalized-gain units."""
    n = slab.n_nodes
    cs = seg.gather_last(comm, slab.src.clamp(0, n - 1))
    cd = seg.gather_last(comm, slab.dst.clamp(0, n - 1))
    masked = dataclasses.replace(slab, alive=slab.alive & (cs == cd))
    return lv.local_move(masked, keys, max_sweeps=max_sweeps, gamma=gamma,
                         theta=theta, singleton_only=True)


def leiden_members(prep: lv.Prepared, keys: torch.Tensor,
                   init_labels: Optional[torch.Tensor] = None,
                   max_sweeps: int = 32, theta: float = 0.01
                   ) -> torch.Tensor:
    """Flat partitions ``[M, N]`` of M members; ``init_labels`` warm-starts
    the first move phase (the later phases derive their own starts).

    Capture-safe (``ops/capture.py``): every phase has static shapes and
    reads nothing back under ``capture.active()``.  The three move
    phases take ``local_move``'s masked loop; the masked refinement slab,
    the aggregate (``louvain.aggregate``'s sorted runs), its compaction
    (``compact_alive``: ranks and counts stay on the device), the label
    compactions and the groups' start labels are data-independent in
    shape, and the aggregate level sweeps on the matmul path (up to
    ``MATMUL_MAX_N`` nodes), the hashed one above, or the exact
    sorted-run one where a forced lowering cannot serve it."""
    slab = prep.slab
    n = slab.n_nodes
    gamma = prep.gamma
    ks = prng.split(keys, 3)
    half = max(max_sweeps // 2, 4)
    comm = lv.local_move(slab, ks[:, 0], init_labels, max_sweeps,
                         gamma=gamma, prep=prep)
    refined = seg.compact_labels(
        refine(slab, comm, ks[:, 1], half, gamma, theta), n)
    agg = lv.aggregate(slab, refined)
    if agg_compaction_active(slab):
        agg = compact_alive(agg, slab.agg_cap)
    # each refined group starts in its community; ids no group uses get
    # the reference's empty-segment value (segment_max's identity)
    m = refined.shape[0]
    group_comm = torch.full((m, n), seg.INT32_MIN, dtype=torch.int64,
                            device=slab.device)
    group_comm.scatter_reduce_(1, refined.clamp(0, n - 1), comm, "amax",
                               include_self=True)
    lvl = seg.compact_labels(
        lv.local_move(agg, ks[:, 2], group_comm, half, gamma=gamma), n)
    return seg.gather_last(lvl, refined.clamp(0, n - 1))


def leiden_single(slab: GraphSlab, key: torch.Tensor,
                  init_labels: Optional[torch.Tensor] = None,
                  max_sweeps: int = 32, gamma: float = 1.0,
                  theta: float = 0.01) -> torch.Tensor:
    """Flat Leiden partition of one key ``[2]``: ``int64[N]``."""
    init = None if init_labels is None else init_labels[None]
    return leiden_members(lv.Prepared(slab, gamma), key[None], init,
                          max_sweeps, theta)[0]


def member_bytes(slab: GraphSlab) -> int:
    """Bytes of one member's temporaries, phase by phase: the move
    phase's sweep (``louvain.sweep_temp_bytes``), the member's masked
    refinement slab (3 bytes a directed slot) with its rows and hub
    prefix, and its aggregate slab (21 bytes a slot) with the larger of
    its build (ten int64 words a slot) and that level's sweep (a matmul
    of the member's own ``[N, N]`` weights, or the hashed aggregation of
    its directed slots)."""
    n = slab.n_nodes
    cap = slab.capacity
    sweep = lv.sweep_temp_bytes(slab)
    rows = {"matmul": 4 * n * n, "dense": 13 * n * (slab.d_cap + 1),
            "hybrid": 13 * n * (slab.d_hyb + 1) + 21 * slab.hub_cap + n
            }.get(lv.select_move_path(slab), 0)
    masked = 3 * 2 * cap + rows
    agg_cap = slab.agg_cap if agg_compaction_active(slab) else cap
    agg_build = 10 * 8 * cap
    if n <= lv.MATMUL_MAX_N:
        agg_sweep = (lv.MATMUL_CELL_BYTES + 4) * n * n
    else:
        agg_sweep = lv.hash_side_bytes(
            2 * agg_cap, seg.hash_buckets_for(2 * agg_cap + n))
    return sweep + masked + 21 * agg_cap + max(agg_build, agg_sweep)


def make_leiden(max_sweeps: Optional[int] = None, gamma: float = 1.0,
                theta: float = 0.01) -> Detector:
    if max_sweeps is None:
        max_sweeps = lv.cold_sweep_budget()

    def detector(sweeps: int, th: float) -> Detector:
        return ensemble(
            lambda prep, keys, init: leiden_members(prep, keys, init,
                                                    sweeps, th),
            lambda slab: lv.Prepared(slab, gamma), member_bytes)

    det = detector(max_sweeps, theta)
    # warm rounds and stagnation refreshes refine greedily (theta 0), as
    # the reference's variants do; fresh detections keep theta
    det.warm_variant = detector(min(lv.warm_sweep_budget(), max_sweeps),
                                0.0)
    det.refresh_variant = detector(max_sweeps, 0.0)
    det.supports_align = True
    # its rounds run capture-safe in the fused round blocks
    # (engine.RoundsBlock, engine.BatchBlock): the cold detector in a run
    # without warm start, the warm variant in one with it.  The refresh
    # variant never enters a graph: a stagnation refresh re-detects from
    # singletons, which a block leaves to a round run on its own
    det.supports_block = True
    det.warm_variant.supports_block = True
    return det


leiden = make_leiden()
