"""Edge-local consensus tail: the round's post-detection phases over a
slab split along a mesh's edge axis.

Counterpart of ``fastconsensus_tpu/ops/sharded_tail.py``.  The reference
writes the tail as one per-shard program under ``jax.shard_map``; the
port is single-controller, so every phase below loops over the edge
chunks of a :class:`parallel.ShardedSlab` (and the ensemble blocks of the
labels) and joins them with explicit collectives
(``parallel/collectives.py``).  What crosses devices is only

* the co-membership contraction over the ensemble axis (label blocks to
  each chunk's device, counts summed over "p"),
* node-indexed ``[N]`` vectors summed or maxed over "e" (degrees,
  partner priorities, strongest previous neighbour, strengths),
* the two hash membership tables of the closure insert, summed over "e",
* per-shard free-slot counts and scalar stats.

The slab's per-edge arrays never leave their device.  Work that the
reference replicates on every device (the candidates' dedup, node-level
stats) runs once, on the mesh's first device; on a mesh that spans
processes it runs in every process, on its home device, after the label
blocks are gathered from every process, and every "e" collective takes
this process's chunks (maybe none) with the axis (``collectives.Axis``),
so each process computes the same results.  Every reduction that
feeds the slab or an integer stat is integer-valued or a max, so the
sharded tail is bit-identical to :func:`engine.consensus_tail` with the
scatter sampler on the same inputs; the quality bundle's two float
metrics (``agreement``, ``member_modularity``) sum in shard order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from fastconsensus_tpu_torch.graph import GraphSlab
from fastconsensus_tpu_torch.ops import consensus_ops as cops
from fastconsensus_tpu_torch.ops import segment as seg
from fastconsensus_tpu_torch.parallel import collectives as coll
from fastconsensus_tpu_torch.parallel.sharding import (Mesh, ShardedSlab,
                                                       shard_labels)

Chunks = List[GraphSlab]
Axis = Optional[coll.Axis]


def _node_psum(vals: Sequence[torch.Tensor], segs: Sequence[torch.Tensor],
               valid: Sequence[torch.Tensor], n: int, ax: Axis
               ) -> List[torch.Tensor]:
    """Cross-shard segment sum into an ``[n]`` vector, one copy per shard
    (integer or float64 values: exact in any order)."""
    local = [seg._flat_scatter((n,), torch.where(m, s, n),
                               torch.where(m, v, torch.zeros_like(v)))
             for v, s, m in zip(vals, segs, valid)]
    return coll.psum(local, ax)


def _node_argmax(score: Sequence[torch.Tensor], segs: Sequence[torch.Tensor],
                 label: Sequence[torch.Tensor], valid: Sequence[torch.Tensor],
                 num: int, ax: Axis
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cross-shard :func:`segment.scatter_argmax_label`: per segment, the
    label of the globally max-score entry, ties toward the larger label,
    as two pmax passes.  ``(label, score, has)`` on the first shard's
    device."""
    s = [torch.where(m, g, num) for g, m in zip(segs, valid)]
    masked = [torch.where(m, x, seg.NEG_INF) for x, m in zip(score, valid)]
    best = coll.pmax([seg._flat_scatter((num,), si, mi, "amax", seg.NEG_INF)
                      for si, mi in zip(s, masked)], ax)
    lab_local = []
    for si, mi, b, lab, m in zip(s, masked, best, label, valid):
        is_best = m & (mi == b[si.clamp(0, num - 1)]) & (si < num)
        lab_local.append(seg._flat_scatter(
            (num,), torch.where(is_best, si, num),
            torch.where(is_best, lab, -1), "amax", -1))
    lab = coll.pmax(lab_local, ax)[0]
    has = torch.isfinite(best[0])
    return (torch.where(has, lab, -1), torch.where(has, best[0], seg.NEG_INF),
            has)


def _degrees(chunks: Chunks, ax: Axis) -> List[torch.Tensor]:
    """Alive degree ``[n]`` (``graph.degrees``), one copy per shard."""
    return coll.psum([c.degrees() for c in chunks], ax)


def _comembership(blocks: Sequence[torch.Tensor], u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Agreement counts of the pairs ``(u, v)`` on their device,
    contracted over the ensemble blocks."""
    return coll.psum([cops.comembership_counts(b.to(u.device), u, v)
                      for b in blocks])[0]


def _conv_stats(chunks: Chunks, n_p: int, delta: float, ax: Axis):
    """``ops/consensus_ops.convergence_stats`` over the shards:
    ``(converged, n_mid, n_alive)`` on the first shard's device."""
    n_mid = coll.psum([(c.alive & (c.weight > 0) &
                        (c.weight < float(n_p))).sum() for c in chunks],
                     ax)[0]
    n_alive = _num_alive(chunks, ax)
    converged = n_mid.to(torch.float32) <= \
        torch.tensor(cops._f32(delta), device=n_mid.device) * \
        n_alive.to(torch.float32)
    return converged, n_mid, n_alive


def _num_alive(chunks: Chunks, ax: Axis) -> torch.Tensor:
    return coll.psum([c.num_alive() for c in chunks], ax)[0]


def _sample_wedges(key: torch.Tensor, chunks: Chunks, n_samples: int,
                   n: int, cap_l: int, home: torch.device, ax: Axis):
    """``consensus_ops.sample_wedges_scatter`` with the partner argmax
    taken across shards (same content-keyed priorities, same winners).
    The group size reads a chunk's capacity ``cap_l`` (the same in every
    process, so that each runs as many collectives); the wedges do not
    depend on it."""
    srcd, dstd, valid_e = [], [], []
    for c in chunks:
        sd, dd, _, ad = c.directed()
        srcd.append(sd)
        dstd.append(dd)
        valid_e.append(ad & (sd != dd))
    u, v, ok = cops.partner_draw_batches(
        key, srcd, dstd, valid_e, n, cap_l, n_samples,
        lambda *a: _node_argmax(*a, ax=ax), device=home)
    return torch.where(ok, u, 0), torch.where(ok, v, 0), ok


def _insert_edges(chunks: Chunks, cand_u, cand_v, cand_w, cand_valid,
                  cap_hint: int, ax: Axis, unique_new: bool = False
                  ) -> Tuple[Chunks, torch.Tensor]:
    """``consensus_ops.insert_edges_hash`` with shard-local tables and
    slots.  The membership tables are summed over "e" (sums of ones:
    exact), the candidates' dedup runs once, and free slots go out in
    GLOBAL slot order: shard s owns slots ``[s * cap_l, (s + 1) *
    cap_l)``, so global rank r falls to the shard whose free-count
    offset covers it, at local free slot ``r - offset`` (the unsharded
    ``nonzero(dead)`` order, bit for bit).  Each survivor is written by
    the shard that owns its slot."""
    cu = cand_u.to(torch.int64)
    cv = cand_v.to(torch.int64)
    if unique_new:
        surv = cand_valid
    else:
        b_e = seg.hash_buckets_for(cap_hint)
        local = [seg.build_hash_totals(
            c.src, c.dst, torch.ones(c.capacity, device=c.device), c.alive,
            b_e) for c in chunks]
        tables = seg.HashTables(t1=coll.psum([t.t1 for t in local], ax)[0],
                                t2=coll.psum([t.t2 for t in local], ax)[0],
                                n_buckets=b_e)
        surv = cops.candidate_survivors(tables, cu, cv, cand_valid)
    dead = [~c.alive for c in chunks]
    counts = coll.all_gather([d.sum() for d in dead], axis=ax)[0].to(
        cu.device)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.cumsum(surv.to(torch.int64), dim=0) - 1
    ok = surv & (rank < counts.sum())
    out = []
    for s, c, d in zip(coll.axis_index(chunks, ax), chunks, dead):
        mine = ok & (rank >= offsets[s]) & (rank < offsets[s] + counts[s])
        dev = c.device
        # fcheck: ok=sync-in-loop (one sync a shard: each shard's free
        # slots are a data-dependent count, as in the unsharded tail)
        local_free = torch.nonzero(d).flatten()
        slot = local_free[(rank[mine] - offsets[s]).to(dev)]
        out.append(cops.write_slots(c, slot, cu[mine].to(dev),
                                    cv[mine].to(dev), cand_w[mine].to(dev)))
    return out, surv.sum() - ok.sum()


def _singleton_candidates(chunks: Chunks, prev: Chunks, n: int, ax: Axis):
    """``consensus_ops.singleton_candidates`` with cross-shard
    reductions: ``(u, v, w, valid)`` of length n on the first shard's
    device."""
    isolated = _degrees(chunks, ax)[0] == 0
    directed = []
    for p in prev:
        psrc, pdst, pw, pad = p.directed()
        directed.append((torch.where(pad, psrc, n), pdst, pw, pad))
    best_w = coll.pmax([seg._flat_scatter(
        (n,), pseg, torch.where(pad, pw, seg.NEG_INF), "amax", seg.NEG_INF)
        for pseg, _, pw, pad in directed], ax)
    partner_local = []
    for (pseg, pdst, pw, pad), bw in zip(directed, best_w):
        at_best = pad & (pw == bw[pseg.clamp(0, n - 1)]) & (pseg < n)
        partner_local.append(seg._flat_scatter(
            (n,), pseg, torch.where(at_best, pdst, -1), "amax",
            seg.INT32_MIN))
    partner = coll.pmax(partner_local, ax)[0]
    best_w = best_w[0]
    nodes = torch.arange(n, device=partner.device)
    valid = isolated & (partner >= 0)
    p_c = partner.clamp(0, n - 1)
    mutual = valid & (partner < nodes) & valid[p_c] & (partner[p_c] == nodes)
    valid = valid & ~mutual
    u = torch.minimum(nodes, partner)
    v = torch.maximum(nodes, partner)
    w = torch.where(torch.isfinite(best_w), best_w, 0.0)
    return torch.where(valid, u, 0), torch.where(valid, v, 0), w, valid


def _quality(chunks: Chunks, prev: Chunks, counts: List[torch.Tensor],
             blocks: List[torch.Tensor], prev_blocks: List[torch.Tensor],
             n_p: int, n: int, ax: Axis) -> dict:
    """The sharded mirror of ``obs/quality.tail_quality``: the same
    formulas, with the cross-shard sums node-, scalar- or member-sized.
    Integer metrics are exact; ``agreement`` and the float32 partial
    sums of ``member_modularity`` reduce in shard order."""
    f = float(n_p)
    mids = [c.alive & (c.weight > 0) & (c.weight < f) for c in chunks]
    ones = [m.to(torch.int64) for m in mids]
    hits = _node_psum(ones, [c.src for c in chunks], mids, n, ax)[0] + \
        _node_psum(ones, [c.dst for c in chunks], mids, n, ax)[0]
    out = dict(
        n_w_zero=coll.psum([(c.alive & (c.weight <= 0.0)).sum()
                            for c in chunks], ax)[0],
        n_w_full=coll.psum([(c.alive & (c.weight >= f)).sum()
                            for c in chunks], ax)[0],
        n_frontier=(hits > 0).sum(),
        labels_changed=coll.all_gather(
            [(b != pb).sum(dim=1) for b, pb in zip(blocks, prev_blocks)],
            tiled=True)[0])
    if n_p <= 1:
        out["agreement"] = torch.tensor(1.0, device=hits.device)
    else:
        tot = coll.psum([torch.where(
            p.alive, c * (c - 1.0) + (f - c) * (f - c - 1.0), 0.0).sum()
            for p, c in zip(prev, counts)], ax)[0]
        n_start = _num_alive(prev, ax).to(torch.float32)
        out["agreement"] = tot / (n_start.clamp(min=1.0) * f * (f - 1.0))
    w = [torch.where(c.alive, c.weight, 0.0) for c in chunks]
    # fcheck: ok=f64-dtype (shard sums of integer weights: exact, so the
    # psum's order does not matter)
    total_w = coll.psum([x.double().sum() for x in w], ax)[0].to(
        torch.float32)
    w_safe = total_w.clamp(min=1e-30)
    # fcheck: ok=f64-dtype (float64 node sums, as graph.strengths: exact,
    # so in any order)
    w64 = [x.double() for x in w]
    alive = [c.alive for c in chunks]
    strength = (_node_psum(w64, [c.src for c in chunks], alive, n, ax)[0] +
                _node_psum(w64, [c.dst for c in chunks], alive, n, ax)[0]
                ).to(torch.float32)
    q = []
    for b in blocks:
        dev = b.device
        intra = coll.psum([torch.where(
            b.to(c.device)[:, c.src] == b.to(c.device)[:, c.dst], x,
            0.0).sum(dim=1) for c, x in zip(chunks, w)], ax)[0].to(dev)
        m = b.shape[0]
        ws = w_safe.to(dev)
        # fcheck: ok=f64-dtype (community degree totals, exact in any
        # scatter order, as obs.quality.member_modularity)
        s64 = strength.to(dev).double().expand(m, n)
        # fcheck: ok=f64-dtype (the same sums)
        d_c = torch.zeros((m, n), dtype=torch.float64, device=dev
                          ).scatter_add_(1, b, s64).to(torch.float32)
        qb = intra / ws - ((d_c / (2.0 * ws)) ** 2).sum(dim=1)
        q.append(torch.where(total_w.to(dev) > 0.0, qb, torch.zeros_like(qb)))
    out["member_modularity"] = coll.all_gather(q, tiled=True)[0]
    return out


def _tail_local(chunks: Chunks, blocks: List[torch.Tensor],
                k_closure: torch.Tensor, prev_blocks: List[torch.Tensor],
                *, n_p: int, tau: float, delta: float, n_closure: int,
                n: int, cap_l: int, home: torch.device, ax: Axis,
                cap_hint: int, d_cap: int, d_hyb: int, hub_cap: int,
                agg_cap: int, hybrid_gate: bool, agg_gate: bool,
                closure_tau: Optional[float] = None):
    """The tail over this process's chunks (see the module docstring)
    and every label block.  The statics and the two gates come from the
    GLOBAL slab: a chunk's capacity would size the hash tables and the
    gates differently."""
    from fastconsensus_tpu_torch.engine import RoundStats

    zero = torch.zeros((), dtype=torch.int64, device=home)
    counts = [_comembership(blocks, c.src, c.dst) for c in chunks]
    prev = chunks
    chunks = [cops.threshold_weights(cops.update_weights(c, k, n_p), tau, n_p)
              for c, k in zip(chunks, counts)]
    mid_converged, _, _ = _conv_stats(chunks, n_p, delta, ax)
    n_closed = n_repaired = n_dropped = zero
    if not bool(mid_converged):
        n0 = _num_alive(chunks, ax)
        cu, cv, cvalid = _sample_wedges(k_closure, chunks, n_closure, n,
                                        cap_l, home, ax)
        cw = _comembership(blocks, cu, cv)
        if closure_tau is not None:
            bar = cops._f32(cops._f32(closure_tau) * cops._f32(n_p))
            cvalid = cvalid & (cw >= bar)
        chunks, dropped = _insert_edges(chunks, cu, cv, cw, cvalid, cap_hint,
                                        ax)
        n1 = _num_alive(chunks, ax)
        su, sv, sw, svalid = _singleton_candidates(chunks, prev, n, ax)
        chunks, dropped2 = _insert_edges(chunks, su, sv, sw, svalid,
                                         cap_hint, ax, unique_new=True)
        n_closed, n_repaired = n1 - n0, _num_alive(chunks, ax) - n1
        n_dropped = dropped + dropped2
    end_converged, end_mid, end_alive = _conv_stats(chunks, n_p, delta, ax)
    deg = _degrees(chunks, ax)[0]
    n_overflow = n_hub_overflow = n_agg_overflow = zero
    if d_cap > 0:
        n_overflow = (deg - d_cap).clamp(min=0).sum()
    if hybrid_gate:
        hub_mass = torch.where(deg > d_hyb, deg, 0).sum()
        n_hub_overflow = (hub_mass - hub_cap).clamp(min=0)
    if agg_gate:
        n_agg_overflow = (end_alive - agg_cap).clamp(min=0)
    qual = _quality(chunks, prev, counts, blocks, prev_blocks, n_p, n, ax)
    stats = RoundStats(
        converged=mid_converged | end_converged, n_alive=end_alive,
        n_unconverged=end_mid, n_closure_added=n_closed,
        n_repaired=n_repaired, n_dropped=n_dropped, n_overflow=n_overflow,
        n_hub_overflow=n_hub_overflow, n_agg_overflow=n_agg_overflow,
        cold=torch.tensor(False, device=home), **qual)
    return chunks, stats


def sharded_consensus_tail(slab: ShardedSlab, labels, k_closure: torch.Tensor,
                           n_p: int, tau: float, delta: float,
                           n_closure: int, mesh: Mesh,
                           closure_tau: Optional[float] = None,
                           prev_labels=None):
    """Run the tail edge-locally over ``mesh`` (axes "p" x "e"):
    ``(next ShardedSlab, RoundStats)``, every stat on the mesh's home
    device, the same in every process.  ``labels`` and ``prev_labels``
    are ``[n_p, N]`` tensors or this process's blocks split along "p";
    ``prev_labels`` None (round 0) measures churn against the singleton
    baseline.  Bit-identical to :func:`engine.consensus_tail` with
    ``sampler="scatter"`` (see the module docstring); with a 1-sized
    edge axis every "e" collective is the identity."""
    from fastconsensus_tpu_torch.graph import agg_compaction_active
    from fastconsensus_tpu_torch.models.louvain import (_cap_hint,
                                                        select_move_path)

    ens = mesh.ensemble_axis()
    blocks = coll.gather_shards(shard_labels(labels, mesh), ens)
    if prev_labels is None:
        prev_labels = torch.arange(slab.n_nodes, device=slab.device
                                   ).expand(n_p, slab.n_nodes)
    prev_blocks = [p.to(b.device) for p, b in zip(
        coll.gather_shards(shard_labels(prev_labels, mesh), ens), blocks)]
    chunks, stats = _tail_local(
        list(slab.chunks), blocks, k_closure.to(slab.device), prev_blocks,
        n_p=n_p, tau=tau, delta=delta, n_closure=n_closure,
        n=slab.n_nodes, cap_l=slab.chunk_capacity, home=slab.device,
        ax=mesh.edge_axis(), cap_hint=_cap_hint(slab), d_cap=slab.d_cap,
        d_hyb=slab.d_hyb, hub_cap=slab.hub_cap, agg_cap=slab.agg_cap,
        hybrid_gate=select_move_path(slab) == "hybrid",
        agg_gate=agg_compaction_active(slab), closure_tau=closure_tau)
    return slab.with_chunks(chunks), stats
