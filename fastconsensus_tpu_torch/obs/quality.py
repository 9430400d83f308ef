"""Per-round consensus-quality metrics folded into RoundStats.

Counterpart of ``fastconsensus_tpu/obs/quality.py`` (see its module
docstring for the metric definitions): the weight-band histogram, the
active frontier, per-member label churn, mean pairwise co-membership
agreement and per-member Newman modularity, and
:func:`summarize_history`, the served result's ``quality`` block.  The
integer metrics are exact; the two float metrics sum in another order
than the reference and agree to float32 rounding.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from fastconsensus_tpu_torch.graph import GraphSlab


class QualityStats(NamedTuple):
    n_w_zero: torch.Tensor           # int64[]
    n_w_full: torch.Tensor           # int64[]
    n_frontier: torch.Tensor         # int64[]
    labels_changed: torch.Tensor     # int64[n_p]
    member_modularity: torch.Tensor  # float32[n_p]
    agreement: torch.Tensor          # float32[]


def singleton_labels(n_p: int, n_nodes: int, device=None) -> torch.Tensor:
    """The round-0 churn baseline: every vertex its own community."""
    return torch.arange(n_nodes, device=device).expand(n_p, n_nodes)


def weight_band_counts(slab: GraphSlab, n_p: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_w_zero, n_w_full): alive edges at weight 0 and at >= n_p."""
    alive = slab.alive
    return ((alive & (slab.weight <= 0.0)).sum(),
            (alive & (slab.weight >= float(n_p))).sum())


def frontier_mask(slab: GraphSlab, n_p: int) -> torch.Tensor:
    """bool[n_nodes]: vertices incident to >= 1 alive mid-band edge."""
    n = slab.n_nodes
    mid = slab.alive & (slab.weight > 0) & (slab.weight < float(n_p))
    hits = torch.bincount(torch.cat([slab.src[mid], slab.dst[mid]]),
                          minlength=n)
    return hits[:n] > 0


def active_frontier(slab: GraphSlab, n_p: int) -> torch.Tensor:
    return frontier_mask(slab, n_p).sum()


def label_churn(labels: torch.Tensor, prev_labels: torch.Tensor
                ) -> torch.Tensor:
    """int64[n_p]: per-member count of vertices whose label changed."""
    return (labels != prev_labels).sum(dim=1)


def edge_agreement(counts: torch.Tensor, alive: torch.Tensor, n_p: int
                   ) -> torch.Tensor:
    """float32[]: mean pairwise co-membership agreement over alive edges."""
    if n_p <= 1:
        return torch.tensor(1.0, device=counts.device)
    c = counts
    f = float(n_p)
    pair_agree = c * (c - 1.0) + (f - c) * (f - c - 1.0)
    tot = torch.where(alive, pair_agree, 0.0).sum()
    n_alive = alive.sum().to(torch.float32)
    return tot / (n_alive.clamp(min=1.0) * f * (f - 1.0))


def member_modularity(slab: GraphSlab, labels: torch.Tensor) -> torch.Tensor:
    """float32[n_p]: Newman modularity of each member on the weighted slab."""
    n = slab.n_nodes
    m = labels.shape[0]
    w = torch.where(slab.alive, slab.weight, 0.0)
    total_w = w.double().sum().to(torch.float32)
    w_safe = total_w.clamp(min=1e-30)
    deg = slab.strengths()
    intra = torch.where(labels[:, slab.src] == labels[:, slab.dst], w,
                        0.0).sum(dim=1)
    d_c = torch.zeros((m, n), dtype=torch.float64,
                      device=labels.device).scatter_add_(
        1, labels, deg.double().expand(m, n)).to(torch.float32)
    q = intra / w_safe - ((d_c / (2.0 * w_safe)) ** 2).sum(dim=1)
    return torch.where(total_w > 0.0, q, torch.zeros_like(q))


def tail_quality(start_alive: torch.Tensor, counts: torch.Tensor,
                 slab: GraphSlab, labels: torch.Tensor,
                 prev_labels: Optional[torch.Tensor], n_p: int
                 ) -> QualityStats:
    """The per-round quality bundle (``prev_labels`` None = round 0)."""
    if prev_labels is None:
        prev_labels = singleton_labels(n_p, slab.n_nodes, slab.device)
    n_zero, n_full = weight_band_counts(slab, n_p)
    return QualityStats(
        n_w_zero=n_zero, n_w_full=n_full,
        n_frontier=active_frontier(slab, n_p),
        labels_changed=label_churn(labels, prev_labels),
        member_modularity=member_modularity(slab, labels),
        agreement=edge_agreement(counts, start_alive, n_p))


def summarize_history(history: List[Dict[str, Any]],
                      converged: Optional[bool] = None
                      ) -> Optional[Dict[str, Any]]:
    """Compress a run's per-round history into the ``quality`` block.

    Returns None when the history carries no quality series (pre-fcqual
    checkpoints, empty runs) so callers can omit the block instead of
    emitting a husk.  ``converged`` is the run's final convergence flag;
    ``rounds_to_converge`` is reported only when the run converged.
    """
    qrounds = [h for h in history if h.get("agreement") is not None]
    if not qrounds:
        return None
    last = qrounds[-1]
    frontier = [float(h.get("frontier_frac", 0.0)) for h in qrounds]
    # "late" = the second half of the trajectory, where a frontier mask
    # would actually prune work (round 0 is always ~the whole graph)
    late = frontier[len(frontier) // 2:]
    block: Dict[str, Any] = {
        "rounds": len(history),
        "final_agreement": float(last["agreement"]),
        "final_modularity_mean": float(last.get("modularity_mean", 0.0)),
        "final_frontier_frac": float(last.get("frontier_frac", 0.0)),
        "final_churn_frac": float(last.get("churn_frac", 0.0)),
        "late_frontier_frac": sum(late) / max(len(late), 1),
        "frontier_frac_by_round": frontier,
        "agreement_by_round": [float(h["agreement"]) for h in qrounds],
        "labels_changed_total": int(sum(
            int(h.get("labels_changed", 0)) for h in qrounds)),
        "agg_overflow_total": int(sum(
            int(h.get("n_agg_overflow", 0)) for h in qrounds)),
    }
    if converged is not None:
        block["rounds_to_converge"] = \
            len(history) if bool(converged) else None
    return block
