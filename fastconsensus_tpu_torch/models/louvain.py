"""Louvain as synchronous parallel modularity local-move.

Counterpart of ``fastconsensus_tpu/models/louvain.py``: every node scores
its modularity gain for joining each neighbouring community,

    gain(i -> C) = k_i_in(C) - gamma k_i (Sigma_tot(C) - [C = c_i] k_i) / 2m,

content-keyed jitter breaks ties, and a keyed mask applies a subset of the
wanted moves each sweep (a bernoulli subsample early, priority
swap-breaking in the endgame).  Sweeps repeat until no node wants to move
or the sweep budget is spent.

The ensemble is a leading member dimension: ``labels`` is ``[M, N]`` and
``keys`` ``[M, 2]``.  The reference's ``lax.while_loop`` under ``vmap``
runs until the slowest member stops, and a stopped member keeps its
labels; here a Python loop sweeps only the members still running, which
gives each member the same sequence of sweeps.  The slab is shared by the
members or member-batched (Leiden's masked refinement slabs and aggregate
graphs); the label-independent state (``Prepared``) then carries the same
member dimension.

Per-sweep lowerings (``select_move_path``, identical rule): the full
matmul for N <= 1024 (an fp32 ``torch.matmul`` with TF32 off, where the
reference uses an XLA dot at ``Precision.HIGHEST``), padded dense rows,
the degree-partitioned hybrid (dense rows + hashed hub edges), hashed
scatter-adds, or the exact sorted-run oracle ("runs", where a forced path
cannot serve the slab).  Dense and hybrid rows aggregate through the
``row_totals`` kernel; ``FCTPU_FUSED=1`` runs whole dense sweeps in the
``fused_move_rows`` kernel.  ``theta > 0`` switches every lowering to
Leiden's refinement scoring (positive gains only, Gumbel-perturbed, no
stay margin); ``singleton_only`` is the refinement's move rule.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from fastconsensus_tpu_torch.analysis import footprint
from fastconsensus_tpu_torch.graph import GraphSlab
from fastconsensus_tpu_torch.models.base import Detector, ensemble, row_bytes
from fastconsensus_tpu_torch.obs import counters as obs_counters
from fastconsensus_tpu_torch.obs.tracer import get_tracer
from fastconsensus_tpu_torch.ops import capture
from fastconsensus_tpu_torch.ops import dense_adj as da
from fastconsensus_tpu_torch.ops import row_kernels
from fastconsensus_tpu_torch.ops import segment as seg
from fastconsensus_tpu_torch.utils import prng
from fastconsensus_tpu_torch.utils.env import env_int
from fastconsensus_tpu_torch.utils.shapes import broadcast_shape

# Jitter and move margin relative to the gain quantum 1/(2m) (see the
# reference for the measurements behind both).
_JITTER_REL = 0.25
_MARGIN_REL = 0.5

MATMUL_MAX_N = footprint.MATMUL_MAX_N
DENSE_OVER_HASH = 8

NEG_INF = float("-inf")


def _community_reps(labels: torch.Tensor, n: int) -> torch.Tensor:
    """Minimum member node id per community id, ``[M, n]`` (``n`` where
    unused): the member-invariant key of the tie-break jitter."""
    m = labels.shape[0]
    reps = torch.full((m, n), n, dtype=torch.int64, device=labels.device)
    nodes = torch.arange(n, device=labels.device).expand(m, n)
    return reps.scatter_reduce_(1, labels.clamp(0, n - 1), nodes, "amin",
                                include_self=True)


def _sigma_tot(strength: torch.Tensor, labels: torch.Tensor, n: int
               ) -> torch.Tensor:
    """Community strength totals ``[M, n]`` from node strengths ``[n]`` or
    ``[M, n]``, accumulated in float64 so large integer sums stay exact
    and run-independent (see graph._node_sum)."""
    m = labels.shape[0]
    # fcheck: ok=f64-dtype (community totals of integer-weight strengths,
    # exact in any scatter order; float32 atomics would vary by run)
    out = torch.zeros((m, n), dtype=torch.float64, device=labels.device)
    # fcheck: ok=f64-dtype (the same sums' addends)
    s64 = strength.double().expand(m, n)
    return out.scatter_add_(1, labels.clamp(0, n - 1), s64).to(torch.float32)


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[m, idx[m, ...]]`` for a ``[M, n]`` table."""
    m = table.shape[0]
    return torch.gather(table, 1, idx.reshape(m, -1)).view(idx.shape)


def _cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Concatenate along the last axis, broadcasting the member axes."""
    lead = broadcast_shape(a.shape[:-1], b.shape[:-1])
    return torch.cat([a.expand(lead + a.shape[-1:]),
                      b.expand(lead + b.shape[-1:])], dim=-1)


def _theta_score(gain: torch.Tensor, noise_u: torch.Tensor,
                 valid: torch.Tensor, theta: float, m2: torch.Tensor
                 ) -> torch.Tensor:
    """Refinement scores: strictly positive gains plus ``theta/2m`` times
    Gumbel noise, so the argmax samples a candidate with probability
    proportional to exp(gain * 2m / theta) (leidenalg's merge
    distribution); -inf elsewhere.  ``m2`` is shaped to broadcast."""
    g = seg.gumbel_from_uniform(noise_u)
    return torch.where(valid & (gain > 0),
                       gain + (torch.full_like(m2, theta) / m2) * g, NEG_INF)


def _dense_weights(slab: GraphSlab) -> torch.Tensor:
    """Dense symmetric weight matrices float32[B, N, N] (B = 1 for a
    shared slab), zero diagonal."""
    n = slab.n_nodes
    srcd, dstd, wd, ad = slab.directed()
    ok = ad & (srcd != dstd)
    batch = ok.shape[:-1]
    srcd, dstd, wd, ok = (t.expand(batch + t.shape[-1:]).reshape(
        -1, t.shape[-1]) for t in (srcd, dstd, wd, ok))
    b = ok.shape[0]
    member = torch.arange(b, device=slab.device)[:, None]
    # dead slots add 0 into a spill cell past the matrices: no boolean
    # mask, so no host read (ops/capture.py)
    w = torch.zeros(b * n * n + 1, dtype=torch.float32, device=slab.device)
    at = torch.where(ok, (member * n + srcd) * n + dstd, b * n * n)
    return w.index_add_(0, at.reshape(-1),
                        torch.where(ok, wd, 0.0).reshape(-1)
                        )[:b * n * n].view(b, n, n)


def _in_weights(W: torch.Tensor, own: torch.Tensor,
                w_rows: Optional[np.ndarray]) -> torch.Tensor:
    """``W @ own`` per member.  ``w_rows`` (host ints, one per member, in
    runs) names the row of ``W`` each member reads: the members of one
    graph share its matrix, one product per run of members, without a
    copy of it per member.  ``None``: ``W``'s rows are the members' (or
    one row shared by all)."""
    if w_rows is None:
        return torch.matmul(W, own)
    s = torch.empty_like(own)
    starts = np.flatnonzero(np.diff(w_rows, prepend=-1))
    for lo, hi in zip(starts, list(starts[1:]) + [len(w_rows)]):
        g = int(w_rows[lo])
        torch.matmul(W[g:g + 1], own[lo:hi], out=s[lo:hi])
    return s


def _move_step_matmul(W: torch.Tensor, labels: torch.Tensor,
                      key: torch.Tensor, m2: torch.Tensor,
                      strength: torch.Tensor, gamma: float = 1.0,
                      theta: float = 0.0,
                      w_rows: Optional[np.ndarray] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sweep via ``S = W @ onehot(labels)``: k_i_in(C) for every
    community at once.  Candidates are communities with positive in-weight
    plus the node's own; the column index is the community id, so argmax's
    first maximum is the smallest tied label, as in the reference.
    ``W`` is ``[B, N, N]`` (member k reads row ``w_rows[k]`` when given),
    ``m2`` ``[M]``, ``strength`` ``[M, N]``."""
    n = W.shape[-1]
    dev = W.device
    sigma = _sigma_tot(strength, labels, n)
    ids = torch.arange(n, device=dev)
    own = labels[:, :, None] == ids
    s = _in_weights(W, own.to(torch.float32), w_rows)
    k_i = strength[:, :, None]
    m2c = m2.view(-1, 1, 1)
    gain = s - gamma * k_i * (sigma[:, None, :] -
                              torch.where(own, k_i, 0.0)) / m2c
    rep_row = _community_reps(labels, n)[:, None, :]
    if theta > 0.0:
        u = seg.pair_jitter(key, ids[:, None], rep_row, 1.0)
        score = _theta_score(gain, u, (s > 0) & ~own, theta, m2c)
        best = torch.argmax(score, dim=2)
        best_score = torch.gather(score, 2, best[:, :, None])[:, :, 0]
        has = torch.isfinite(best_score)
        return torch.where(has, best, labels), has & (best != labels)
    jitter = seg.pair_jitter(key, ids[:, None], rep_row, _JITTER_REL / m2c)
    score = torch.where((s > 0) | own, gain + jitter, NEG_INF)
    best = torch.argmax(score, dim=2)
    best_score = torch.gather(score, 2, best[:, :, None])[:, :, 0]
    stay = torch.gather(gain, 2, labels.clamp(0, n - 1)[:, :, None])[:, :, 0]
    want = (best != labels) & \
        (best_score > stay + _MARGIN_REL / m2.view(-1, 1))
    return best, want


def _score_rows(tot: da.RowTotals, labels: torch.Tensor, key: torch.Tensor,
                m2: torch.Tensor, strength: torch.Tensor, sigma: torch.Tensor,
                reps: torch.Tensor, gamma: float, theta: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense-row sweep body shared by the dense and hybrid steps."""
    n = labels.shape[1]
    k_i = strength[:, :, None]
    m2c = m2.view(-1, 1, 1)
    lab_c = tot.label.clamp(0, n - 1)
    sig = _gather_rows(sigma, lab_c)
    own = tot.label == labels[:, :, None]
    gain = tot.total - gamma * k_i * (sig - torch.where(own, k_i, 0.0)) / m2c
    nodes = torch.arange(n, device=labels.device)[:, None]
    rep = _gather_rows(reps, lab_c)
    if theta > 0.0:
        u = seg.pair_jitter(key, nodes, rep, 1.0)
        score = _theta_score(gain, u, tot.is_head & ~own, theta, m2c)
        return da.best_candidate(tot, score, labels)
    jitter = seg.pair_jitter(key, nodes, rep, _JITTER_REL / m2c)
    score = torch.where(tot.is_head, gain + jitter, NEG_INF)
    best, want = da.best_candidate(tot, score, labels)
    best_score = score.max(dim=2).values
    stay = torch.where(own & tot.is_head, gain, NEG_INF).max(dim=2).values
    return best, want & (best_score > stay + _MARGIN_REL / m2.view(-1, 1))


def _move_step_dense(adj: da.DenseAdj, labels: torch.Tensor,
                     key: torch.Tensor, m2: torch.Tensor,
                     strength: torch.Tensor, gamma: float = 1.0,
                     theta: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sweep on the padded dense adjacency (row_totals kernel)."""
    n = labels.shape[1]
    sigma = _sigma_tot(strength, labels, n)
    tot = da.row_label_totals(adj, labels)
    return _score_rows(tot, labels, key, m2, strength, sigma,
                       _community_reps(labels, n), gamma, theta)


def _hash_side(node, dst_label, weight, valid, stay_valid, labels, key,
               m2, strength, sigma, reps, n_buckets: int, gamma: float,
               theta: float = 0.0):
    """Hashed aggregation over directed candidate entries ``node ->
    dst_label`` plus a synthetic zero-weight (i, c_i) entry per node where
    ``stay_valid`` (every looked-up pair must be inserted)."""
    n = labels.shape[1]
    m = labels.shape[0]
    dev = labels.device
    nodes = torch.arange(n, device=dev)
    tables = seg.build_hash_totals(
        _cat(node, nodes), torch.cat([dst_label, labels], dim=1),
        _cat(weight, torch.zeros(n, device=dev)), _cat(valid, stay_valid),
        n_buckets)
    tot = seg.lookup_hash_totals(tables, node, dst_label)
    src_c = node.clamp(0, n - 1)
    strength = strength.expand(m, n)
    k_i = seg.gather_last(strength, src_c)
    dst_c = dst_label.clamp(0, n - 1)
    sig = _gather_rows(sigma, dst_c)
    own = dst_label == seg.gather_last(labels, src_c)
    m2c = m2.view(-1, 1)
    gain = tot - gamma * k_i * (sig - torch.where(own, k_i, 0.0)) / m2c
    rep = _gather_rows(reps, dst_c)
    if theta > 0.0:
        u = seg.pair_jitter(key, node, rep, 1.0)
        score = _theta_score(gain, u, valid & ~own, theta, m2c)
        best, _, has_any = seg.scatter_argmax_label(
            node, score, dst_label, valid, n)
        return best, has_any & (best >= 0) & (best != labels)
    jitter = seg.pair_jitter(key, node, rep, _JITTER_REL / m2c)
    score = torch.where(valid, gain + jitter, NEG_INF)
    best, best_score, has_any = seg.scatter_argmax_label(
        node, score, dst_label, valid, n)
    stay_tot = seg.lookup_hash_totals(tables, nodes, labels)
    stay = stay_tot - gamma * strength * (
        _gather_rows(sigma, labels.clamp(0, n - 1)) - strength) / m2c
    want = has_any & (best_score > stay + _MARGIN_REL / m2c) & \
        (best != labels) & (best >= 0)
    return best, want


def _move_step_hash(slab: GraphSlab, labels: torch.Tensor, key, m2,
                    strength, n_buckets: int, gamma: float = 1.0,
                    theta: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sweep via hashed scatter-adds over every directed edge."""
    n = slab.n_nodes
    sigma = _sigma_tot(strength, labels, n)
    srcd, dstd, wd, ad = slab.directed()
    valid = ad & (srcd != dstd)
    lab_dst = seg.gather_last(labels, dstd.clamp(0, n - 1))
    return _hash_side(srcd, lab_dst, wd, valid,
                      torch.ones(n, dtype=torch.bool, device=labels.device),
                      labels, key, m2, strength, sigma,
                      _community_reps(labels, n), n_buckets, gamma, theta)


def _move_step_hybrid(hyb: da.HybridAdj, labels: torch.Tensor, key, m2,
                      strength, n_buckets: int, gamma: float = 1.0,
                      theta: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sweep on the degree-partitioned layout: dense rows (row_totals
    kernel) for non-hub nodes, hashed aggregation over the compacted hub
    edges for hubs."""
    n = labels.shape[1]
    ks = prng.split(key, 2)
    k_dense, k_hub = ks[:, 0], ks[:, 1]
    sigma = _sigma_tot(strength, labels, n)
    reps = _community_reps(labels, n)
    tot = da.row_label_totals(hyb.adj, labels)
    best_d, want_d = _score_rows(tot, labels, k_dense, m2, strength, sigma,
                                 reps, gamma, theta)
    lab_hdst = seg.gather_last(labels, hyb.hdst.clamp(0, n - 1))
    best_h, want_h = _hash_side(hyb.hsrc, lab_hdst, hyb.hw, hyb.hvalid,
                                hyb.is_hub, labels, k_hub, m2, strength,
                                sigma, reps, n_buckets, gamma, theta)
    return (torch.where(hyb.is_hub, best_h, best_d),
            torch.where(hyb.is_hub, want_h, want_d))


def _move_step_runs(slab: GraphSlab, labels: torch.Tensor, key, m2,
                    strength, gamma: float = 1.0, theta: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sweep via the exact sorted-run reduction (the oracle the hash
    path is held against).  Self-loops are left out of k_i_in; a
    zero-weight (i, c_i) run per node keeps "stay" scored."""
    n = slab.n_nodes
    m = labels.shape[0]
    dev = labels.device
    sigma = _sigma_tot(strength, labels, n)
    srcd, dstd, wd, ad = slab.directed()
    nodes = torch.arange(n, device=dev)
    runs = seg.node_label_runs(
        _cat(srcd, nodes),
        torch.cat([seg.gather_last(labels, dstd.clamp(0, n - 1)), labels],
                  dim=1),
        _cat(wd, torch.zeros(n, device=dev)),
        _cat(ad & (srcd != dstd), torch.ones(n, dtype=torch.bool,
                                             device=dev)), n)
    node_c = runs.node.clamp(0, n - 1)
    lab_c = runs.label.clamp(0, n - 1)
    k_i = seg.gather_last(strength.expand(m, n), node_c)
    own = runs.label == seg.gather_last(labels, node_c)
    m2c = m2.view(-1, 1)
    gain = runs.total - gamma * k_i * (
        seg.gather_last(sigma, lab_c) - torch.where(own, k_i, 0.0)) / m2c
    rep = seg.gather_last(_community_reps(labels, n), lab_c)
    if theta > 0.0:
        u = seg.pair_jitter(key, runs.node, rep, 1.0)
        score = _theta_score(gain, u, runs.valid & ~own, theta, m2c)
        best, _, has_any = seg.argmax_label_per_node(
            runs.node, score, runs.label, runs.valid, n)
        return best, has_any & (best >= 0) & (best != labels)
    score = gain + seg.pair_jitter(key, runs.node, rep, _JITTER_REL / m2c)
    best, best_score, has_any = seg.argmax_label_per_node(
        runs.node, score, runs.label, runs.valid, n)
    # unjittered stay score: the node's own-label run (the synthetic one
    # when it has no intra-community edge)
    stay_run = runs.valid & own
    stay = seg._flat_scatter((m, n), torch.where(stay_run, runs.node, n),
                             torch.where(stay_run, gain, NEG_INF), "amax",
                             NEG_INF)
    return best, has_any & (best != labels) & (best >= 0) & \
        (best_score > stay + _MARGIN_REL / m2c)


def _fused_width_ok(d_cap: int) -> bool:
    """The reference's selection rule for the fused sweep (its VMEM guard
    at the lane-padded width), kept so both packages take the same
    lowering — and so draw the same jitter — on the same slab."""
    d1p = (d_cap + 1) + (-(d_cap + 1)) % 128
    return 8 * 6 * d1p * d1p <= 12 * 1024 * 1024


class _FusedRows:
    """Label-independent inputs of the fused dense sweep: neighbour rows
    plus the node's own zero-weight slot (``d_cap + 1`` wide; the TPU's
    lane padding adds only empty slots and is left out).  Rows are shared
    (``[N, D1]``) or per member (``[M, N, D1]``) as ``adj`` is."""

    def __init__(self, slab: GraphSlab, adj: da.DenseAdj,
                 strength: torch.Tensor, m2: torch.Tensor, gamma: float):
        n = slab.n_nodes
        dev = slab.device
        self.n = n
        self.d_self = slab.d_cap
        nodes = torch.arange(n, device=dev)
        lead = adj.nbr.shape[:-1]
        self.nbr = torch.cat([adj.nbr, nodes.expand(lead)[..., None]],
                             dim=-1)
        self.valid = torch.cat(
            [adj.valid, torch.ones(lead + (1,), dtype=torch.bool,
                                   device=dev)], dim=-1)
        self.w = torch.cat([torch.where(adj.valid, adj.w, 0.0),
                            torch.zeros(lead + (1,), device=dev)], dim=-1)
        strength = strength.reshape(-1, n)
        m2c = m2.reshape(-1, 1)
        zero = torch.zeros_like(strength)
        self.scal_base = torch.stack(
            [strength, gamma * strength / m2c,
             torch.full_like(strength, _JITTER_REL) / m2c,
             torch.full_like(strength, _MARGIN_REL) / m2c, zero,
             nodes.to(torch.float32).expand_as(strength), zero, zero],
            dim=-1)

    def take(self, idx: torch.Tensor) -> "_FusedRows":
        out = copy.copy(self)
        out.nbr, out.valid, out.w = self.nbr[idx], self.valid[idx], \
            self.w[idx]
        out.scal_base = self.scal_base[idx]
        return out

    def step(self, labels: torch.Tensor, sigma: torch.Tensor,
             key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        n, d1 = self.nbr.shape[-2:]
        m = labels.shape[0]
        lab = torch.where(self.valid, da.row_gather(labels, self.nbr),
                          da.SENTINEL)
        sig = _gather_rows(sigma, lab.clamp(0, n - 1))
        # 24-bit salt: exact in the float32 scalar pack
        salt = (prng.bits(key, ()) & 0xFFFFFF).to(torch.float32)
        scal = self.scal_base.expand(m, n, 8).clone()
        scal[:, :, 4] = salt[:, None]
        best, want = row_kernels.fused_move_rows(
            lab.to(torch.int32).view(m * n, d1).contiguous(),
            self.w.expand(m, n, d1).reshape(m * n, d1),
            sig.view(m * n, d1).contiguous(), scal.view(m * n, 8),
            self.d_self)
        return best.view(m, n).to(torch.int64), want.view(m, n)


def _swap_break(key: torch.Tensor, slab: GraphSlab, want: torch.Tensor,
                adj: da.DenseAdj = None, hyb: da.HybridAdj = None,
                coin_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Keep each wanting node only if its random priority beats every
    wanting neighbour's.  ``coin_rows`` (bool[N], [M, N] or None) are the
    rows that may miss a neighbour to overflow; they also need a keyed
    coin."""
    n = slab.n_nodes
    m = want.shape[0]
    ks = prng.split(key, 2)
    pri = prng.uniform(ks[:, 0], (n,))
    wpri = torch.where(want, pri, -1.0)
    if hyb is not None or adj is not None:
        rows = hyb.adj if hyb is not None else adj
        nbrp = torch.where(rows.valid, da.row_gather(wpri, rows.nbr), -1.0)
        nbr_best = nbrp.max(dim=2).values
        if hyb is not None:
            hub_best = seg._flat_scatter(
                (m, n), torch.where(hyb.hvalid, hyb.hsrc, n),
                seg.gather_last(wpri, hyb.hdst.clamp(0, n - 1)), "amax",
                -1.0)
            nbr_best = torch.maximum(nbr_best, hub_best)
    else:
        srcd, dstd, _, ad = slab.directed()
        valid = ad & (srcd != dstd)
        nbr_best = seg._flat_scatter(
            (m, n), torch.where(valid, srcd, n),
            seg.gather_last(wpri, dstd.clamp(0, n - 1)), "amax", -1.0)
    keep = want & (wpri > nbr_best)
    if coin_rows is not None:
        keep = keep & (~coin_rows | prng.bernoulli(ks[:, 1], 0.5, (n,)))
    return keep


def _cap_hint(slab: GraphSlab) -> int:
    """Growth-stable stand-in for ``slab.capacity`` in heuristics."""
    return slab.cap_hint or slab.capacity


def select_move_path(slab: GraphSlab) -> str:
    """Which per-sweep lowering :func:`local_move` uses: "matmul",
    "dense", "hybrid", "hash" or "runs" — the reference's rule, including
    the FCTPU_MOVE_PATH override and its fallbacks."""
    n = slab.n_nodes
    hybrid_ok = slab.d_hyb > 0 and slab.hub_cap > 0
    forced = os.environ.get("FCTPU_MOVE_PATH", "")
    if forced:
        if forced == "matmul" and n <= 8 * MATMUL_MAX_N:
            return "matmul"
        if forced == "dense" and slab.d_cap > 0:
            return "dense"
        if forced == "hybrid" and hybrid_ok:
            return "hybrid"
        if forced == "hash":
            return "hash"
        return "runs"
    if n <= MATMUL_MAX_N:
        return "matmul"
    if slab.d_cap > 0 and \
            n * (slab.d_cap + 1) <= DENSE_OVER_HASH * 2 * _cap_hint(slab):
        return "dense"
    if hybrid_ok and \
            n * (slab.d_hyb + 1) <= DENSE_OVER_HASH * 2 * _cap_hint(slab):
        return "hybrid"
    return "hash"


# Bytes a candidate (a matmul cell, a dense-row slot or a hashed entry)
# holds at a sweep's peak, the widest step of seg.pair_jitter: the running
# hash and mul32's lo, hi, shifted hi and their sum, five int64 words.
_JITTER_BYTES = 5 * 8
# A matmul cell at that step: the own-label mask (1), the product s (4),
# the gain (4), the jitter and the score's candidate mask (1).
MATMUL_CELL_BYTES = 1 + 4 + 4 + _JITTER_BYTES + 1
# A dense-row slot at that step: the candidate label (8), clamped (8), its
# community rep (8), the kernel's total (4) and head (1), the own-label
# mask (1), the gathered Sigma_tot (4), the gain (4) and the jitter.
_ROW_SLOT_BYTES = 8 + 8 + 8 + 4 + 1 + 1 + 4 + 4 + _JITTER_BYTES
# A hashed entry: its neighbour label (8), clamped (8) and rep (8), the
# looked-up total (4), k_i (4), Sigma_tot (4), own mask (1), the gain (4)
# and the jitter.
_HASH_ENTRY_BYTES = 8 + 8 + 8 + 4 + 4 + 4 + 1 + 4 + _JITTER_BYTES
# A member's per-node vectors live through a sweep: labels, Sigma_tot,
# reps, best, want and the swap priorities (at most 8 bytes each).
_NODE_BYTES = 6 * 8
# Headroom over the sum: the call's shared rows spread over a chunk of
# members, allocator rounding and the device's scratch buffers.
_HEADROOM = 9 / 8


def hash_side_bytes(n_entries: int, n_buckets: int) -> int:
    """One member's hashed aggregation: its entries and both float32
    tables."""
    return _HASH_ENTRY_BYTES * n_entries + 2 * 4 * n_buckets


def sweep_temp_bytes(slab: GraphSlab) -> int:
    """Peak bytes of one member's per-sweep temporaries on the lowering
    :func:`select_move_path` picks (it sizes member chunks, which never
    change results): the sum of the tensors live at the sweep's peak,

    * matmul, per cell of ``[N, N]``: ``MATMUL_CELL_BYTES`` (50), the
      own-label mask (1), the product ``s`` (4), the gain (4), the
      jitter's five int64 words (40) and the score's candidate mask (1);
    * dense, per slot of ``[N, d_cap + 1]``: ``_ROW_SLOT_BYTES`` (78);
    * hybrid: the larger of the dense side at ``d_hyb + 1`` and, while
      the hub side runs, the dense side's candidates (label 8, total 4,
      head 1 a slot) beside the hashed hub entries and their tables;
    * hash (and the forced-only runs oracle): the hashed aggregation of
      the ``2 * capacity`` directed entries;

    each plus ``_NODE_BYTES`` a node, times ``_HEADROOM``."""
    path = select_move_path(slab)
    n = slab.n_nodes
    if path == "matmul":
        live = MATMUL_CELL_BYTES * n * n
    elif path == "dense":
        live = _ROW_SLOT_BYTES * n * (slab.d_cap + 1)
    elif path == "hybrid":
        slots = n * (slab.d_hyb + 1)
        live = max(_ROW_SLOT_BYTES * slots, 13 * slots + hash_side_bytes(
            slab.hub_cap + n, seg.hash_buckets_for(slab.hub_cap + n)))
    else:
        live = hash_side_bytes(
            2 * slab.capacity, seg.hash_buckets_for(2 * _cap_hint(slab) + n))
    return int(_HEADROOM * (live + _NODE_BYTES * n))


def _take(x, idx: torch.Tensor):
    """Members ``idx`` of member-batched state (a tensor, or a NamedTuple
    of tensors such as DenseAdj)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x[idx]
    return type(x)(*(_take(f, idx) for f in x))


class Prepared:
    """Label-independent per-slab state of a local-move call.  For a
    member-batched slab every member has its own rows, strengths and 2m;
    ``take`` selects the members still sweeping.  For a graph-stacked slab
    (``graph.stack_slabs``) the state is per graph and :meth:`members_of`
    hands it to the members."""

    def __init__(self, slab: GraphSlab, gamma: float = 1.0,
                 theta: float = 0.0):
        n = slab.n_nodes
        self.slab = slab
        self.gamma = gamma
        self.theta = theta
        self.batched = bool(slab.batch)
        self.path = select_move_path(slab)
        self.m2 = slab.total_weight().clamp(min=1e-9).reshape(-1)
        self.strength = slab.strengths().reshape(-1, n)
        self.W = self.adj = self.hyb = self.fused = None
        self.w_rows: Optional[np.ndarray] = None
        self.coin_rows = None
        self.n_buckets = 0
        if self.path == "matmul":
            # fp32 products, no TF32: the reference's Precision.HIGHEST.
            # TF32 keeps 10 mantissa bits and would round the in-weights,
            # so refuse to run rather than change the caller's setting
            if slab.src.is_cuda and torch.backends.cuda.matmul.allow_tf32:
                raise RuntimeError(
                    "the matmul sweep needs full fp32 products; TF32 is on "
                    "(torch.backends.cuda.matmul.allow_tf32, or "
                    "set_float32_matmul_precision below 'highest'): turn it "
                    "off to run Louvain on a graph of <= 1024 nodes")
            self.W = _dense_weights(slab)
        elif self.path == "dense":
            self.adj = da.build_dense_adjacency(slab)
            # always a tensor, all false without overflow (None's moves):
            # no host read
            self.coin_rows = self.adj.valid.all(dim=-1) & \
                (self.adj.n_overflow > 0)[..., None]
            # the fused kernel has no refinement scoring
            if os.environ.get("FCTPU_FUSED", "") == "1" and \
                    _fused_width_ok(slab.d_cap) and theta == 0.0:
                self.fused = _FusedRows(slab, self.adj, self.strength,
                                        self.m2, gamma)
        elif self.path == "hybrid":
            self.hyb = da.build_hybrid(slab)
            self.coin_rows = self.hyb.is_hub & \
                (self.hyb.n_hub_overflow > 0)[..., None]
            self.n_buckets = seg.hash_buckets_for(slab.hub_cap + n)
        elif self.path == "hash":
            self.n_buckets = seg.hash_buckets_for(2 * _cap_hint(slab) + n)

    def take(self, idx: torch.Tensor,
             host_idx: Optional[np.ndarray] = None) -> "Prepared":
        """Members ``idx`` (a device index).  ``host_idx``, the same ids
        on the host, picks the matmul rows ``w_rows`` with no host read
        (:meth:`members_of` knows them from the stream's static layout);
        without it they are read back from ``idx``."""
        if not self.batched:
            return self
        out = copy.copy(self)
        out.slab = self.slab.take(idx)
        out.m2, out.strength = self.m2[idx], self.strength[idx]
        if self.w_rows is None:
            out.W = _take(self.W, idx)
        else:
            if host_idx is None:
                obs_counters.host_sync("member_take")
                host_idx = idx.cpu().numpy()
            out.w_rows = self.w_rows[host_idx]
        out.adj, out.hyb = _take(self.adj, idx), _take(self.hyb, idx)
        out.coin_rows = _take(self.coin_rows, idx)
        if self.fused is not None:
            out.fused = self.fused.take(idx)
        return out

    def members_of(self, graph_of: torch.Tensor,
                   graph_rows: Optional[np.ndarray] = None) -> "Prepared":
        """Graph-stacked state handed to members ``graph_of[k]`` (a run
        per graph; ``graph_rows`` the same ids on the host, so that a
        captured round reads nothing back).  The dense matrices ``W`` stay
        one per graph, read by each member through ``w_rows``; the rest is
        copied per member (:meth:`member_copy_bytes`), since the sweeps
        index it by member."""
        shared = copy.copy(self)
        if self.W is not None:
            shared.w_rows = np.arange(self.W.shape[0])
        return shared.take(graph_of, graph_rows)

    def member_copy_bytes(self) -> int:
        """Bytes :meth:`members_of` copies for each member."""
        return row_bytes(self.slab.src, self.slab.dst, self.slab.weight,
                         self.slab.alive, self.m2, self.strength, self.adj,
                         self.hyb, self.coin_rows) + \
            (0 if self.fused is None else row_bytes(
                self.fused.nbr, self.fused.valid, self.fused.w,
                self.fused.scal_base))

    def step(self, labels: torch.Tensor, key: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        g, th = self.gamma, self.theta
        if self.path == "matmul":
            return _move_step_matmul(self.W, labels, key, self.m2,
                                     self.strength, g, th, self.w_rows)
        if self.fused is not None:
            sigma = _sigma_tot(self.strength, labels, self.slab.n_nodes)
            return self.fused.step(labels, sigma, key)
        if self.path == "dense":
            return _move_step_dense(self.adj, labels, key, self.m2,
                                    self.strength, g, th)
        if self.path == "hybrid":
            return _move_step_hybrid(self.hyb, labels, key, self.m2,
                                     self.strength, self.n_buckets, g, th)
        if self.path == "hash":
            return _move_step_hash(self.slab, labels, key, self.m2,
                                   self.strength, self.n_buckets, g, th)
        return _move_step_runs(self.slab, labels, key, self.m2,
                               self.strength, g, th)


def local_move(slab: GraphSlab, keys: torch.Tensor,
               init_labels: Optional[torch.Tensor] = None,
               max_sweeps: int = 32, update_prob: float = 0.5,
               gamma: float = 1.0, stop_frac: float = 0.0,
               prep: Optional[Prepared] = None, theta: float = 0.0,
               singleton_only: bool = False) -> torch.Tensor:
    """Sweep members ``keys[M, 2]`` until fewer than ``max(1,
    stop_frac*N)`` nodes want to move, or ``max_sweeps``.  Returns
    uncompacted labels ``int64[M, N]``.

    ``theta`` + ``singleton_only`` is Leiden's refinement mode: only
    nodes whose community is a singleton at sweep start may move, and a
    joiner/anchor coin keeps every move's target group stationary for the
    sweep, so groups grow by accretion and stay internally connected.

    fcobs, off the captured path: each sweep's exit test is a host read
    (``host_sync.sweep_exit``, span ``sweep_exit``: one a sweep, and one
    more where the loop stops before ``max_sweeps``); each sweep is a
    ``sweep`` span (args ``it``, ``active``) and counts ``detect.sweeps``
    and its members ``detect.member_sweeps``."""
    n = slab.n_nodes
    dev = slab.device
    if keys.dim() == 1:
        keys = keys[None]
    m = keys.shape[0]
    if init_labels is None:
        labels = torch.arange(n, device=dev).expand(m, n).clone()
    else:
        labels = init_labels.to(device=dev, dtype=torch.int64).clone()
    prep = prep or Prepared(slab, gamma, theta)
    stop_at = max(1, int(stop_frac * n))
    endgame_at = max(1, int(0.05 * n))
    n_want = torch.full((m,), n, dtype=torch.int64, device=dev)

    def sweep(it, lab, p, ks):
        """One sweep of members ``ks``: ``(new_labels, n_want)``."""
        sub = prng.split(prng.fold_in(ks, it), 3)
        best, want = p.step(lab, sub[:, 0])
        if singleton_only:
            return _refine_moves(lab, best, want, sub[:, 2], n)
        nw = want.sum(dim=1)
        bern = prng.bernoulli(sub[:, 2], update_prob, (n,))
        swap = _swap_break(sub[:, 1], p.slab, want, p.adj, p.hyb,
                           p.coin_rows)
        mask = torch.where((nw <= endgame_at)[:, None], swap, bern)
        return torch.where(want & mask, best, lab), nw

    if capture.active():
        # every member sweeps and keeps its labels once it has stopped:
        # a member's sweep reads only its own key and rows, so this is
        # the subset loop below bit for bit, with no host read; a sweep
        # with no member left runs only off the card's graphs.  Members
        # a batched block leaves out (capture.sweeping) start stopped
        mask = capture.sweeping_members(m)
        if mask is not None:
            n_want = torch.where(mask, n_want, 0)
        for it in range(max_sweeps):
            act = n_want >= stop_at

            def run(it=it, act=act):
                new, nw = sweep(it, labels, prep, keys)
                return (torch.where(act[:, None], new, labels),
                        torch.where(act, nw, n_want))

            capture.when(act.any(), run, (labels, n_want))
        return labels
    tracer = get_tracer()
    reg = obs_counters.get_registry()
    for it in range(max_sweeps):
        with tracer.span("sweep_exit", it=it):
            # fcheck: ok=sync-in-loop (the sweep loop's exit test: one
            # deliberate sync a sweep, which also sizes the next sweep's
            # rows)
            act = torch.nonzero(n_want >= stop_at).flatten()
        obs_counters.host_sync("sweep_exit")
        n_act = act.numel()
        if n_act == 0:
            break
        reg.inc("detect.sweeps")
        reg.inc("detect.member_sweeps", n_act)
        with tracer.span("sweep", it=it, active=n_act):
            every = n_act == m
            lab = labels if every else labels[act]
            p = prep if every else prep.take(act)
            new, nw = sweep(it, lab, p, keys if every else keys[act])
            if every:
                labels, n_want = new, nw
            else:
                labels[act] = new
                n_want[act] = nw
    return labels


def _refine_moves(labels: torch.Tensor, best: torch.Tensor,
                  want: torch.Tensor, k_mask: torch.Tensor, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refinement's move rule: ``(new_labels, n_want)``.  Grouped nodes are
    frozen; of the singletons that want to move only joiner-coined ones
    move, and never into a group whose own member departs this sweep."""
    m = labels.shape[0]
    ones = torch.ones_like(labels)
    sizes = seg._flat_scatter((m, n + 1), labels.clamp(0, n), ones)
    want = want & (torch.gather(sizes, 1, labels.clamp(0, n - 1)) == 1)
    coin = prng.bernoulli(k_mask, 0.5, (n,))
    departs = want & coin
    departing = seg._flat_scatter((m, n + 1), labels.clamp(0, n),
                                  departs.to(torch.int64))[:, :n] > 0
    ok = departs & ~torch.gather(departing, 1, best.clamp(0, n - 1))
    return torch.where(ok, best, labels), want.sum(dim=1)


def louvain_members(prep: Prepared, keys: torch.Tensor,
                    init_labels: Optional[torch.Tensor] = None,
                    max_sweeps: int = 32, update_prob: float = 0.5
                    ) -> torch.Tensor:
    """Level-0 partitions of M members, compacted per member."""
    labels = local_move(prep.slab, keys, init_labels, max_sweeps,
                        update_prob, prep.gamma, prep=prep)
    return seg.compact_labels(labels, prep.slab.n_nodes)


def louvain_single(slab: GraphSlab, key: torch.Tensor,
                   init_labels: Optional[torch.Tensor] = None,
                   max_sweeps: int = 32, update_prob: float = 0.5,
                   gamma: float = 1.0) -> torch.Tensor:
    """Level-0 partition of one key ``[2]``: ``int64[N]``."""
    init = None if init_labels is None else init_labels[None]
    return louvain_members(Prepared(slab, gamma), key[None], init,
                           max_sweeps, update_prob)[0]


def aggregate(slab: GraphSlab, labels: torch.Tensor) -> GraphSlab:
    """Community graph per member: a supernode per community of
    ``labels`` ``[M, N]``, summed edge weights, intra-community weight kept
    as self-loops.  Same capacity (runs in (u, v) order, valid first), no
    dense or hybrid sizing, so its moves take the matmul or hash path."""
    n = slab.n_nodes
    c = seg.compact_labels(labels, n)
    cu = seg.gather_last(c, slab.src.clamp(0, n - 1))
    cv = seg.gather_last(c, slab.dst.clamp(0, n - 1))
    runs = seg.node_label_runs(torch.minimum(cu, cv), torch.maximum(cu, cv),
                               slab.weight, slab.alive, n)
    return dataclasses.replace(
        slab, src=torch.where(runs.valid, runs.node, 0),
        dst=torch.where(runs.valid, runs.label, 0), weight=runs.total,
        alive=runs.valid, d_cap=0, d_hyb=0, hub_cap=0)


def modularity_levels(slab: GraphSlab, keys: torch.Tensor, n_levels: int = 2,
                      max_sweeps: int = 32, update_prob: float = 0.5
                      ) -> torch.Tensor:
    """Multi-level optimization per member; returns the flattened final
    labels ``[M, N]`` (level 0 is ``local_move``; each further level
    aggregates, moves supernodes and projects back)."""
    n = slab.n_nodes
    labels = local_move(slab, prng.fold_in(keys, 0), max_sweeps=max_sweeps,
                        update_prob=update_prob)
    flat = seg.compact_labels(labels, n)
    cur, cur_assign = slab, flat
    for level in range(1, n_levels):
        cur = aggregate(cur, cur_assign)
        lvl = local_move(cur, prng.fold_in(keys, level),
                         max_sweeps=max_sweeps, update_prob=update_prob)
        cur_assign = seg.compact_labels(lvl, n)
        flat = seg.gather_last(cur_assign, flat.clamp(0, n - 1))
    return flat


def warm_sweep_budget(default: int = 12) -> int:
    """Sweep cap for warm-started rounds (FCTPU_WARM_SWEEPS overrides)."""
    return max(1, env_int("FCTPU_WARM_SWEEPS", default))


def cold_sweep_budget(default: int = 32) -> int:
    """Sweep cap for cold detection (FCTPU_COLD_SWEEPS overrides)."""
    return max(1, env_int("FCTPU_COLD_SWEEPS", default))


def make_louvain(max_sweeps: Optional[int] = None, update_prob: float = 0.5,
                 gamma: float = 1.0) -> Detector:
    if max_sweeps is None:
        max_sweeps = cold_sweep_budget()

    def detector(sweeps: int) -> Detector:
        return ensemble(
            lambda prep, keys, init: louvain_members(
                prep, keys, init, sweeps, update_prob),
            lambda slab: Prepared(slab, gamma))

    det = detector(max_sweeps)
    det.warm_variant = detector(min(warm_sweep_budget(), max_sweeps))
    # tie-break jitter is content-keyed (_community_reps), so endgame key
    # sharing collapses degenerate disagreements
    det.supports_align = True
    # its rounds run capture-safe in the fused round block
    # (engine.RoundsBlock)
    det.supports_block = True
    return det


louvain = make_louvain()
