"""One consensus round.

Counterpart of ``fastconsensus_tpu/engine.py``.  A round (reference
``fast_consensus.py:138-201``):

    detect (n_p members)  -> co-membership counts per edge
    -> tau-threshold -> convergence check
    -> triadic closure (skipped if converged) -> singleton repair
    -> convergence check

PyTorch runs eagerly, so the reference's jitted executables, fused round
blocks (documented bit-identical to per-round execution) and the
detect-chunk disk cache have no counterpart here; ``lax.cond`` is a host
branch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from fastconsensus_tpu_torch.graph import GraphSlab, agg_compaction_active
from fastconsensus_tpu_torch.models.base import Detector
from fastconsensus_tpu_torch.obs import quality as obs_quality
from fastconsensus_tpu_torch.ops import consensus_ops as cops
from fastconsensus_tpu_torch.utils import prng


class RoundStats(NamedTuple):
    """Per-round statistics (fields as the reference's RoundStats)."""

    converged: torch.Tensor
    n_alive: torch.Tensor
    n_unconverged: torch.Tensor
    n_closure_added: torch.Tensor
    n_repaired: torch.Tensor
    n_dropped: torch.Tensor
    n_overflow: torch.Tensor
    n_hub_overflow: torch.Tensor
    n_agg_overflow: torch.Tensor
    cold: torch.Tensor
    n_w_zero: torch.Tensor
    n_w_full: torch.Tensor
    n_frontier: torch.Tensor
    labels_changed: torch.Tensor
    member_modularity: torch.Tensor
    agreement: torch.Tensor


def consensus_tail(slab: GraphSlab, labels: torch.Tensor,
                   k_closure: torch.Tensor, n_p: int, tau: float,
                   delta: float, n_closure: int,
                   closure_tau: Optional[float] = None,
                   prev_labels: Optional[torch.Tensor] = None,
                   sampler: str = "csr"
                   ) -> Tuple[GraphSlab, RoundStats]:
    """Everything after detection: co-membership -> threshold ->
    convergence -> closure -> repair.  ``sampler`` picks the wedge
    sampler: "csr" (argsort of the directed edges, uniform anchors) or
    "scatter" (sort-free partner draws); the two draw different wedges."""
    dev = slab.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    counts = cops.comembership_counts(labels, slab.src, slab.dst)
    prev = slab  # round-start weights, for singleton repair
    slab = cops.update_weights(slab, counts, n_p)
    slab = cops.threshold_weights(slab, tau, n_p)
    st_mid = cops.convergence_stats(slab, n_p, delta)
    n_closed = n_repaired = n_dropped = zero
    if not bool(st_mid.converged):
        n0 = slab.num_alive()
        if sampler == "csr":
            cu, cv, cvalid = cops.sample_wedges(
                k_closure, cops.build_csr(slab), slab.n_nodes, n_closure)
        else:
            cu, cv, cvalid = cops.sample_wedges_scatter(k_closure, slab,
                                                        n_closure)
        cw = cops.comembership_counts(labels, cu, cv)
        if closure_tau is not None:
            bar = cops._f32(cops._f32(closure_tau) * cops._f32(n_p))
            cvalid = cvalid & (cw >= bar)
        slab, dropped = cops.insert_edges_hash(slab, cu, cv, cw, cvalid)
        n1 = slab.num_alive()
        su, sv, sw, svalid = cops.singleton_candidates(slab, prev)
        slab, dropped2 = cops.insert_edges_hash(slab, su, sv, sw, svalid,
                                                unique_new=True)
        n_closed, n_repaired = n1 - n0, slab.num_alive() - n1
        n_dropped = dropped + dropped2
    st_end = cops.convergence_stats(slab, n_p, delta)
    n_overflow = n_hub_overflow = n_agg_overflow = zero
    if slab.d_cap > 0:
        n_overflow = (slab.degrees() - slab.d_cap).clamp(min=0).sum()
    from fastconsensus_tpu_torch.models.louvain import select_move_path
    if select_move_path(slab) == "hybrid":
        deg = slab.degrees()
        hub_mass = torch.where(deg > slab.d_hyb, deg, 0).sum()
        n_hub_overflow = (hub_mass - slab.hub_cap).clamp(min=0)
    if agg_compaction_active(slab):
        n_agg_overflow = (st_end.n_alive - slab.agg_cap).clamp(min=0)
    qual = obs_quality.tail_quality(prev.alive, counts, slab, labels,
                                    prev_labels, n_p)
    stats = RoundStats(
        converged=st_mid.converged | st_end.converged,
        n_alive=st_end.n_alive, n_unconverged=st_end.n_unconverged,
        n_closure_added=n_closed, n_repaired=n_repaired,
        n_dropped=n_dropped, n_overflow=n_overflow,
        n_hub_overflow=n_hub_overflow, n_agg_overflow=n_agg_overflow,
        cold=torch.tensor(False, device=dev),
        n_w_zero=qual.n_w_zero, n_w_full=qual.n_w_full,
        n_frontier=qual.n_frontier, labels_changed=qual.labels_changed,
        member_modularity=qual.member_modularity, agreement=qual.agreement)
    return slab, stats


def _maybe_align_keys(keys: torch.Tensor, align: bool) -> torch.Tensor:
    """Give every ensemble member member 0's key when ``align`` is true."""
    if not align:
        return keys
    return keys[:1].expand_as(keys).clone()


def consensus_round(slab: GraphSlab, key: torch.Tensor, detect: Detector,
                    n_p: int, tau: float, delta: float, n_closure: int,
                    init_labels: Optional[torch.Tensor] = None,
                    align: bool = False,
                    closure_tau: Optional[float] = None,
                    prev_labels: Optional[torch.Tensor] = None,
                    sampler: str = "csr"
                    ) -> Tuple[GraphSlab, torch.Tensor, RoundStats]:
    """One full round: ``(next_slab, labels[n_p, N], stats)``.  Keys derive
    as in the reference: ``split(key)`` into detection and closure, then
    one ``fold_in`` per member."""
    ks = prng.split(key, 2)
    k_detect, k_closure = ks[0], ks[1]
    keys = _maybe_align_keys(prng.partition_keys(k_detect, n_p), align)
    labels = detect(slab, keys, init_labels)
    slab, stats = consensus_tail(slab, labels, k_closure, n_p, tau, delta,
                                 n_closure, closure_tau=closure_tau,
                                 prev_labels=prev_labels, sampler=sampler)
    return slab, labels, stats

