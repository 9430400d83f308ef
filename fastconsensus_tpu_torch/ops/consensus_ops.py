"""Building blocks of the consensus round, over the slab.

Counterpart of ``fastconsensus_tpu/ops/consensus_ops.py``:

* co-membership accumulation  -> comembership_counts
* tau-thresholding            -> threshold_weights
* delta-convergence           -> convergence_stats
* triadic closure             -> build_csr + sample_wedges (CSR sampler)
                                 or sample_wedges_scatter (sort-free),
                                 then insert_edges_hash
* singleton repair            -> singleton_candidates

Scatters with duplicate live indices use ``scatter_reduce`` (min/max) or
integer-valued adds, never ``index_put_``, so results are deterministic on
the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fastconsensus_tpu_torch.graph import GraphSlab
from fastconsensus_tpu_torch.ops import segment as seg
from fastconsensus_tpu_torch.utils import prng

# Members per chunk of the [members, E] co-membership compare.
_COUNT_ELEMS = 1 << 27
# Bound on a scatter-sampler batch group's [G, 2*capacity] priorities and
# [G*(n+1)] argmax segments (the reference's constant).  Groups only batch
# the draws: the sampled wedges do not depend on it.
SCATTER_GROUP_ELEMS = 32_000_000


def comembership_counts(labels: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor) -> torch.Tensor:
    """Per-edge count of members whose endpoints share a community:
    float32[E] in [0, n_p] (integer sums, exact)."""
    n_p = labels.shape[0]
    step = max(1, _COUNT_ELEMS // max(1, src.shape[0]))
    out = torch.zeros(src.shape[0], dtype=torch.int64, device=labels.device)
    for s in range(0, n_p, step):
        lab = labels[s:s + step]
        out += (lab[:, src] == lab[:, dst]).sum(dim=0)
    return out.to(torch.float32)


def update_weights(slab: GraphSlab, counts: torch.Tensor, n_p: int
                   ) -> GraphSlab:
    """New round weights: the counts, except edges already at n_p keep it."""
    frozen = slab.weight >= float(n_p)
    new_w = torch.where(frozen, slab.weight, counts)
    return slab.with_weights(torch.where(slab.alive, new_w, 0.0))


def _f32(x: float) -> float:
    return float(np.float32(x))


def threshold_weights(slab: GraphSlab, tau: float, n_p: int) -> GraphSlab:
    """Kill edges with weight < tau * n_p (float32 product, as the
    reference computes it)."""
    bar = float(np.float32(tau) * np.float32(n_p))
    keep = slab.alive & (slab.weight >= bar)
    return slab.with_weights(torch.where(keep, slab.weight, 0.0), alive=keep)


class ConvergenceStats(NamedTuple):
    converged: torch.Tensor      # bool[]
    n_unconverged: torch.Tensor  # int64[] alive edges with 0 < w < n_p
    n_alive: torch.Tensor        # int64[]


def convergence_stats(slab: GraphSlab, n_p: int, delta: float
                      ) -> ConvergenceStats:
    """Converged iff #(alive edges with weight not in {0, n_p}) <=
    delta * #alive, compared in float32."""
    mid = slab.alive & (slab.weight > 0) & (slab.weight < float(n_p))
    n_mid = mid.sum()
    n_alive = slab.alive.sum()
    converged = n_mid.to(torch.float32) <= \
        torch.full((), _f32(delta), device=slab.device) * \
        n_alive.to(torch.float32)
    return ConvergenceStats(converged, n_mid, n_alive)


class CSR(NamedTuple):
    """Alive directed edges sorted by source (dead entries at the tail)."""

    offsets: torch.Tensor    # int64[n_nodes + 1]
    neighbors: torch.Tensor  # int64[2 * capacity]


def build_csr(slab: GraphSlab) -> CSR:
    srcd, dstd, _, ad = slab.directed()
    key = torch.where(ad, srcd, slab.n_nodes)
    order = torch.argsort(key, stable=True)
    offsets = torch.searchsorted(
        key[order], torch.arange(slab.n_nodes + 1, device=slab.device))
    return CSR(offsets=offsets, neighbors=dstd[order])


def sample_wedges(key: torch.Tensor, csr: CSR, n_nodes: int, n_samples: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Triadic-closure wedge sampling: ``n_samples`` uniform anchors, two
    distinct uniform neighbours each; canonical ``(u, v, valid)``."""
    ks = prng.split(key, 3)
    anchors = prng.randint(ks[0], (n_samples,), 0, n_nodes)
    left = csr.offsets[anchors]
    deg = csr.offsets[anchors + 1] - left
    valid = deg >= 2
    degf = deg.clamp(min=2).to(torch.float32)
    i = torch.floor(prng.uniform(ks[1], (n_samples,)) * degf).to(torch.int64)
    j = torch.floor(prng.uniform(ks[2], (n_samples,)) * (degf - 1.0)
                    ).to(torch.int64)
    i = torch.minimum(i, deg - 1)
    j = torch.minimum(j, deg - 2)
    j = j + (j >= i).to(torch.int64)
    top = csr.neighbors.shape[0] - 1
    a = csr.neighbors[(left + i).clamp(0, top)]
    b = csr.neighbors[(left + j).clamp(0, top)]
    u = torch.minimum(a, b)
    v = torch.maximum(a, b)
    return u, v, valid & (u != v)


def sample_wedges_scatter(key: torch.Tensor, slab: GraphSlab,
                          n_samples: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-free triadic-closure sampling, as the reference's: per draw,
    every node ``u`` picks two independent uniform alive neighbours
    ``p1(u)``, ``p2(u)`` (each a scatter-argmax of content-keyed
    per-directed-edge priorities), and ``(p1, p2)`` is its candidate when
    they differ.  ``ceil(n_samples / N)`` draws; a key-rotated window of
    ``n_samples`` entries of the (draw, node) grid is kept.  Canonical
    ``(u, v, valid)``."""
    n = slab.n_nodes
    srcd, dstd, _, ad = slab.directed()
    valid_e = ad & (srcd != dstd)
    u, v, ok = partner_draw_batches(key, [srcd], [dstd], [valid_e], n,
                                    slab.capacity, n_samples,
                                    scatter_argmax_shards)
    return torch.where(ok, u, 0), torch.where(ok, v, 0), ok


def scatter_argmax_shards(score, segs, label, valid, num: int):
    """The unsharded sampler's per-node argmax: one shard's
    :func:`segment.scatter_argmax_label` (``ops/sharded_tail.
    _node_argmax`` is the cross-shard one)."""
    (score,), (segs,), (label,), (valid,) = score, segs, label, valid
    return seg.scatter_argmax_label(segs, score, label, valid, num)


def partner_draw_batches(key: torch.Tensor, srcd: Sequence[torch.Tensor],
                         dstd: Sequence[torch.Tensor],
                         valid_e: Sequence[torch.Tensor], n: int,
                         capacity: int, n_samples: int, argmax,
                         device: Optional[torch.device] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scatter sampler's draw engine, one definition for the unsharded
    and the edge-sharded tail (their wedges must be bit-identical; only
    the ``argmax`` callee differs).  ``srcd``/``dstd``/``valid_e`` are the
    directed entries of each edge shard (one shard: the whole slab);
    ``argmax(scores, segs, labels, valid, num) -> (best, score, has)``
    takes the shards' lists and returns the per-segment winners on the
    first shard's device, or on ``device`` (a process of a multi-process
    mesh may hold no shard).

    Draw ``d`` uses the two keys of ``split(fold_in(key, d))``; G draws
    run as one flat scatter-argmax over (draw, node) segments, in groups
    of ``min(draws, SCATTER_GROUP_ELEMS // max(2*capacity, n+1))`` draws
    (the reference's ``lax.scan`` over groups, as a loop; ``capacity`` is
    a shard's).  The kept window starts at ``randint(fold_in(key, draws),
    (), 0, draws*n)`` of the unpadded grid and wraps, so neither capacity
    nor the group size changes the result."""
    dev = srcd[0].device if device is None else device
    key = key.to(dev)
    draws = -(-n_samples // max(n, 1))
    if draws == 0:
        z = torch.zeros((0,), dtype=torch.int64, device=dev)
        return z, z, torch.zeros((0,), dtype=torch.bool, device=dev)
    total = draws * n
    if total >= 2 ** 31:
        raise ValueError(
            f"wedge grid draws*n = {total} exceeds int32 indexing; "
            "shard the closure-candidate axis before scaling here")
    group = min(draws, max(1, SCATTER_GROUP_ELEMS // max(2 * capacity,
                                                         n + 1)))
    n_groups = -(-draws // group)
    ks = prng.split(prng.fold_in(
        key, torch.arange(n_groups * group, dtype=torch.int64, device=dev)))
    seg_e = [torch.where(ve, sd, n) for sd, ve in zip(srcd, valid_e)]

    def partners(keys: torch.Tensor):
        g = keys.shape[0]
        scores, segs, labs, oks = [], [], [], []
        for sd, dd, ve, se in zip(srcd, dstd, valid_e, seg_e):
            k = keys.to(sd.device)
            scores.append(seg.pair_jitter(k, sd[None], dd[None], 1.0
                                          ).reshape(-1))
            segs.append((torch.arange(g, device=sd.device)[:, None] *
                         (n + 1) + se[None, :]).reshape(-1))
            labs.append(dd.expand(g, -1).reshape(-1))
            oks.append(ve.expand(g, -1).reshape(-1))
        best, _, has = argmax(scores, segs, labs, oks, g * (n + 1))
        return (best.reshape(g, n + 1)[:, :n], has.reshape(g, n + 1)[:, :n])

    us, vs, oks = [], [], []
    for g0 in range(0, n_groups * group, group):
        p1, h1 = partners(ks[g0:g0 + group, 0])
        p2, h2 = partners(ks[g0:g0 + group, 1])
        oks.append(h1 & h2 & (p1 != p2))
        us.append(torch.minimum(p1, p2))
        vs.append(torch.maximum(p1, p2))
    off = prng.randint(prng.fold_in(key, draws), (), 0, total)
    ar = torch.arange(n_samples, dtype=torch.int64, device=dev)
    rem = total - off
    idx = torch.where(ar < rem, ar + off, ar - rem)
    return (torch.cat(us).reshape(-1)[idx], torch.cat(vs).reshape(-1)[idx],
            torch.cat(oks).reshape(-1)[idx])


def candidate_survivors(tables: seg.HashTables, cu: torch.Tensor,
                        cv: torch.Tensor, cand_valid: torch.Tensor
                        ) -> torch.Tensor:
    """Closure candidates that survive insertion: absent from the slab
    (``tables``, the two-table hash membership of its alive pairs) and
    the first occurrence of their pair among the candidates (scatter-min
    of the candidate index into two tag tables)."""
    k = cu.shape[0]
    exists = seg.lookup_hash_totals(tables, cu, cv) > 0.0
    b_c = seg.hash_buckets_for(k)
    h1 = seg._hash_mix(cu, cv, 0x9E3779B1, 0x85EBCA77, b_c)
    h2 = seg._hash_mix(cu, cv, 0x27D4EB2F, 0x165667B1, b_c)
    tag = torch.arange(k, device=cu.device)
    live = cand_valid & ~exists
    t1 = seg._flat_scatter((b_c + 1,), torch.where(live, h1, b_c), tag,
                           "amin", k)
    t2 = seg._flat_scatter((b_c + 1,), torch.where(live, h2, b_c), tag,
                           "amin", k)
    return live & ((t1[h1] == tag) | (t2[h2] == tag))


def write_slots(slab: GraphSlab, slot: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor, w: torch.Tensor) -> GraphSlab:
    """``slab`` with alive edges ``(u, v, w)`` written at the (distinct)
    slots ``slot``."""
    src, dst = slab.src.clone(), slab.dst.clone()
    weight, alive = slab.weight.clone(), slab.alive.clone()
    src[slot] = u
    dst[slot] = v
    weight[slot] = w.to(torch.float32)
    alive[slot] = True
    return dataclasses.replace(slab, src=src, dst=dst, weight=weight,
                               alive=alive)


def write_slots_at(slab: GraphSlab, at: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor, w: torch.Tensor) -> GraphSlab:
    """:func:`write_slots` with static shapes: candidate ``k`` is written
    at slot ``at[k]``, or nowhere when ``at[k]`` is the capacity (a spill
    slot past the slab; the real slots named are distinct)."""
    cap = slab.capacity

    def put(t, vals):
        ext = torch.cat([t, t.new_zeros((1,))])
        return ext.scatter_(0, at, vals.to(t.dtype))[:cap]

    return dataclasses.replace(
        slab, src=put(slab.src, u), dst=put(slab.dst, v),
        weight=put(slab.weight, w),
        alive=put(slab.alive, torch.ones_like(at, dtype=torch.bool)))


def insert_edges_hash(slab: GraphSlab, cand_u: torch.Tensor,
                      cand_v: torch.Tensor, cand_w: torch.Tensor,
                      cand_valid: torch.Tensor, unique_new: bool = False
                      ) -> Tuple[GraphSlab, torch.Tensor]:
    """Insert candidates into dead slots in slot order, dropping those
    present in the slab (two-table hash membership) and later duplicates
    (:func:`candidate_survivors`).  ``unique_new`` skips both checks
    (exact singleton repair).  Returns the new slab and the number of
    survivors dropped for capacity."""
    from fastconsensus_tpu_torch.models.louvain import _cap_hint

    cap = slab.capacity
    dev = slab.device
    cu = cand_u.to(torch.int64)
    cv = cand_v.to(torch.int64)
    if unique_new:
        surv = cand_valid
    else:
        tables = seg.build_hash_totals(
            slab.src, slab.dst, torch.ones(cap, device=dev), slab.alive,
            seg.hash_buckets_for(_cap_hint(slab)))
        surv = candidate_survivors(tables, cu, cv, cand_valid)
    # the r-th survivor goes to the r-th free slot (slot order), ranked by
    # a cumsum over the dead slots; the rest through a spill slot past the
    # slab: static shapes, no host read
    rank = torch.cumsum(surv.to(torch.int64), dim=0) - 1
    free = ~slab.alive
    free_rank = torch.cumsum(free.to(torch.int64), dim=0) - 1
    slot_of = torch.full((cap + 1,), cap, dtype=torch.int64, device=dev)
    slot_of.scatter_(0, torch.where(free, free_rank, cap),
                     torch.arange(cap, device=dev))
    ok = surv & (rank < free.sum())
    at = torch.where(ok, slot_of[rank.clamp(0, cap)], cap)
    return write_slots_at(slab, at, cu, cv, cand_w), surv.sum() - ok.sum()


def insert_edges(slab: GraphSlab, cand_u: torch.Tensor,
                 cand_v: torch.Tensor, cand_w: torch.Tensor,
                 cand_valid: torch.Tensor) -> Tuple[GraphSlab, torch.Tensor]:
    """The reference's exact (lexsort) insert: a candidate is dropped when
    its ``(u, v)`` is alive in the slab or appeared earlier among the
    candidates; survivors fill dead slots in slot order.  Returns the new
    slab and the number of survivors dropped for capacity.  Static shapes
    throughout (three stable sorts stand in for the lexsort)."""
    cap = slab.capacity
    k = cand_u.shape[0]
    n = slab.n_nodes
    dev = slab.device
    all_u = torch.cat([torch.where(slab.alive, slab.src, n),
                       torch.where(cand_valid, cand_u.to(torch.int64), n)])
    all_v = torch.cat([torch.where(slab.alive, slab.dst, n),
                       torch.where(cand_valid, cand_v.to(torch.int64), n)])
    tag = torch.cat([torch.zeros(cap, dtype=torch.int64, device=dev),
                     torch.arange(1, k + 1, dtype=torch.int64, device=dev)])
    # lexsort by (u, v, tag): stable sorts from the last key to the first
    order = torch.argsort(tag, stable=True)
    order = order[torch.argsort(all_v[order], stable=True)]
    order = order[torch.argsort(all_u[order], stable=True)]
    su, sv, st = all_u[order], all_v[order], tag[order]
    dup_prev = torch.zeros_like(su, dtype=torch.bool)
    dup_prev[1:] = (su[1:] == su[:-1]) & (sv[1:] == sv[:-1])
    surviving = ~dup_prev & (st > 0) & (su < n)
    # back to candidate order through the unique tags 1..k (the slab's
    # entries, tag 0, land in slot 0, sliced off)
    surv = torch.zeros(k + 1, dtype=torch.bool, device=dev).scatter_(
        0, st, surviving)[1:]
    free_slots = torch.argsort(slab.alive.to(torch.int8), stable=True)
    rank = torch.cumsum(surv.to(torch.int64), dim=0) - 1
    ok = surv & (rank < (~slab.alive).sum())
    at = torch.where(ok, free_slots[rank.clamp(0, cap - 1)], cap)
    return write_slots_at(slab, at, cand_u.to(torch.int64),
                          cand_v.to(torch.int64), cand_w), \
        surv.sum() - ok.sum()


def singleton_candidates(slab: GraphSlab, prev: GraphSlab
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Reconnect isolated nodes to their strongest previous-round neighbour
    (ties toward the larger neighbour id); mutual proposals keep the lower
    node's.  Returns ``(u, v, w, valid)`` of length n_nodes."""
    n = slab.n_nodes
    dev = slab.device
    isolated = slab.degrees() == 0
    psrc, pdst, pw, pad = prev.directed()
    pseg = torch.where(pad, psrc, n)
    # segment_max identities for empty segments: -inf and INT32_MIN
    best_w = seg._flat_scatter((n,), pseg, torch.where(pad, pw, seg.NEG_INF),
                               "amax", seg.NEG_INF)
    at_best = pad & (pw == best_w[pseg.clamp(0, n - 1)]) & (pseg < n)
    partner = seg._flat_scatter((n,), pseg, torch.where(at_best, pdst, -1),
                                "amax", seg.INT32_MIN)
    nodes = torch.arange(n, device=dev)
    valid = isolated & (partner >= 0)
    p_c = partner.clamp(0, n - 1)
    mutual = valid & (partner < nodes) & valid[p_c] & (partner[p_c] == nodes)
    valid = valid & ~mutual
    u = torch.minimum(nodes, partner)
    v = torch.maximum(nodes, partner)
    w = torch.where(torch.isfinite(best_w), best_w, 0.0)
    return torch.where(valid, u, 0), torch.where(valid, v, 0), w, valid
