"""Label propagation (LPM) as a synchronous keyed vote.

Counterpart of ``fastconsensus_tpu/models/lpm.py`` (igraph's
``community_label_propagation`` in the reference): every round each node
takes the weighted mode of its neighbours' labels, keyed jitter breaks
ties, and a keyed mask applies a random subset of the changes.  Rounds
repeat until no node wants to change, or ``max_iters``.

Two lowerings, as in the reference: the dense-row vote through the
``row_totals`` kernel when the slab carries a row width (``d_cap > 0``),
the exact sorted-run vote otherwise.  The dense vote's tie-break noise is
drawn per row position; the reference's CPU lowering holds each row
sorted by label, so each candidate here takes the draw of its rank in the
sorted row (``row_label_totals(rank=True)``) and the two packages break
ties alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fastconsensus_tpu_torch.graph import GraphSlab
from fastconsensus_tpu_torch.models.base import Detector, ensemble
from fastconsensus_tpu_torch.ops import dense_adj as da
from fastconsensus_tpu_torch.ops import segment as seg
from fastconsensus_tpu_torch.utils import prng

NEG_INF = float("-inf")


def _vote_step(slab: GraphSlab, labels: torch.Tensor, key: torch.Tensor,
               update_prob: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sorted-run vote round: ``(new_labels, n_want)``."""
    n = slab.n_nodes
    srcd, dstd, wd, ad = slab.directed()
    ks = prng.split(key, 2)
    runs = seg.node_label_runs(
        srcd, seg.gather_last(labels, dstd.clamp(0, n - 1)), wd, ad, n)
    score = runs.total + seg.pair_jitter(ks[:, 0], runs.node, runs.label,
                                         0.5)
    best, _, has_any = seg.argmax_label_per_node(
        runs.node, score, runs.label, runs.valid, n)
    want = has_any & (best != labels)
    mask = prng.bernoulli(ks[:, 1], update_prob, (n,))
    return torch.where(want & mask, best, labels), want.sum(dim=1)


def _vote_step_dense(adj: da.DenseAdj, labels: torch.Tensor,
                     key: torch.Tensor, update_prob: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-row vote.  A node's own zero-weight candidate never outscores
    a real neighbour vote (weights >= 1 against jitter < 0.5) and is left
    out unless it has neighbour weight."""
    n, d = adj.nbr.shape[-2:]
    ks = prng.split(key, 2)
    tot, rank = da.row_label_totals(adj, labels, rank=True)
    jitter = torch.gather(seg.uniform_jitter(ks[:, 0], (n, d + 1), 0.5), 2,
                          rank)
    score = torch.where(tot.is_head & (tot.total > 0), tot.total + jitter,
                        NEG_INF)
    best, want = da.best_candidate(tot, score, labels)
    mask = prng.bernoulli(ks[:, 1], update_prob, (n,))
    return torch.where(want & mask, best, labels), want.sum(dim=1)


class Prepared:
    """The slab and, when it carries a row width, its dense rows."""

    def __init__(self, slab: GraphSlab):
        self.slab = slab
        self.adj = da.build_dense_adjacency(slab) if slab.d_cap > 0 \
            else None

    def step(self, labels, key, update_prob: float):
        if self.adj is not None:
            return _vote_step_dense(self.adj, labels, key, update_prob)
        return _vote_step(self.slab, labels, key, update_prob)


def lpm_members(prep: Prepared, keys: torch.Tensor,
                init_labels: Optional[torch.Tensor] = None,
                max_iters: int = 64, update_prob: float = 0.7
                ) -> torch.Tensor:
    """Compacted partitions ``[M, N]`` of M members (None = every node its
    own label, igraph's start)."""
    n = prep.slab.n_nodes
    dev = prep.slab.device
    m = keys.shape[0]
    if init_labels is None:
        labels = torch.arange(n, device=dev).expand(m, n).clone()
    else:
        labels = init_labels.to(device=dev, dtype=torch.int64).clone()
    n_want = torch.ones(m, dtype=torch.int64, device=dev)
    for it in range(max_iters):
        act = torch.nonzero(n_want > 0).flatten()
        if act.numel() == 0:
            break
        every = act.numel() == m
        lab = labels if every else labels[act]
        k = prng.fold_in(keys if every else keys[act], it)
        new, nw = prep.step(lab, k, update_prob)
        if every:
            labels, n_want = new, nw
        else:
            labels[act] = new
            n_want[act] = nw
    return seg.compact_labels(labels, n)


def lpm_single(slab: GraphSlab, key: torch.Tensor,
               init_labels: Optional[torch.Tensor] = None,
               max_iters: int = 64, update_prob: float = 0.7
               ) -> torch.Tensor:
    """One label-propagation partition of key ``[2]``: ``int64[N]``."""
    init = None if init_labels is None else init_labels[None]
    return lpm_members(Prepared(slab), key[None], init, max_iters,
                       update_prob)[0]


def member_bytes(slab: GraphSlab) -> int:
    """Rough peak of one member's vote temporaries: a dozen 8-byte arrays
    over the padded rows, or over the directed edges for the runs vote."""
    if slab.d_cap > 0:
        return 12 * 8 * slab.n_nodes * (slab.d_cap + 1)
    return 12 * 8 * 2 * slab.capacity


def make_lpm(max_iters: int = 64, update_prob: float = 0.7) -> Detector:
    return ensemble(
        lambda prep, keys, init: lpm_members(prep, keys, init, max_iters,
                                             update_prob),
        Prepared, member_bytes)


lpm = make_lpm()
