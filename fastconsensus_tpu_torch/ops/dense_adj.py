"""Padded dense-row adjacency and per-row neighbour-label aggregation.

Counterpart of ``fastconsensus_tpu/ops/dense_adj.py``.  The directed edges
are scattered once per detection call into fixed-width rows (``[N, D]``);
every sweep then aggregates the neighbour weight per (row, label) with the
``row_totals`` kernel (ops/row_kernels.py), which handles every width a
slab can carry (up to DENSE_D_MAX + 1), so there is no width guard and no
sort lowering: on a CUDA tensor the kernel runs, on a CPU tensor its plain
version.

Labels carry a leading member axis: ``labels`` is ``[M, N]`` and the
aggregated rows ``[M, N, D+1]``.  The rows themselves are shared by the
members, or per member when the slab is member-batched (a masked or
aggregated graph per member).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from fastconsensus_tpu_torch.graph import GraphSlab
from fastconsensus_tpu_torch.ops import row_kernels
from fastconsensus_tpu_torch.ops import segment as seg

SENTINEL = row_kernels.SENTINEL


class DenseAdj(NamedTuple):
    """Padded neighbour rows; invalid slots have ``valid=False``.  A
    member-batched slab gives every field a leading member dimension."""

    nbr: torch.Tensor         # int64[*B, N, D] neighbour id (0 where invalid)
    w: torch.Tensor           # float32[*B, N, D] (0 where invalid)
    valid: torch.Tensor       # bool[*B, N, D]
    n_overflow: torch.Tensor  # int64[*B] directed edges dropped for width


def build_dense_adjacency(slab: GraphSlab, width: int = 0,
                          edge_mask: torch.Tensor = None) -> DenseAdj:
    """Scatter alive directed edges into ``[N, width]`` rows, in the order
    of a stable sort by source (one sort per detection call), per member
    when the slab or ``edge_mask`` is member-batched."""
    d = width or slab.d_cap
    if d <= 0:
        raise ValueError("row width is 0; pack with pack_edges or set d_cap")
    n = slab.n_nodes
    dev = slab.device
    srcd, dstd, wd, ad = slab.directed()
    ad = ad & (srcd != dstd)
    if edge_mask is not None:
        ad = ad & edge_mask
    batch = ad.shape[:-1]
    srcd, dstd, wd, ad = (t.expand(batch + t.shape[-1:]).reshape(
        -1, t.shape[-1]) for t in (srcd, dstd, wd, ad))
    b, e = ad.shape
    key = torch.where(ad, srcd, n)
    order = torch.argsort(key, dim=-1, stable=True)
    ssrc = torch.gather(key, 1, order)
    offsets = torch.searchsorted(
        ssrc, torch.arange(n + 1, dtype=torch.int64,
                           device=dev).expand(b, n + 1).contiguous())
    pos = torch.arange(e, dtype=torch.int64, device=dev) - \
        torch.gather(offsets, 1, ssrc.clamp(0, n - 1))
    ok = (ssrc < n) & (pos < d)
    member = torch.arange(b, dtype=torch.int64, device=dev)[:, None]
    # entries that take no slot go to a spill slot past the rows: no
    # boolean mask, so no host read (ops/capture.py); each real slot is
    # written once
    size = b * n * d
    flat = torch.where(ok, (member * n + ssrc) * d + pos, size).reshape(-1)
    nbr = torch.zeros(size + 1, dtype=torch.int64, device=dev)
    w = torch.zeros(size + 1, dtype=torch.float32, device=dev)
    valid = torch.zeros(size + 1, dtype=torch.bool, device=dev)
    nbr.scatter_(0, flat, torch.gather(dstd, 1, order).reshape(-1))
    w.scatter_(0, flat, torch.gather(wd, 1, order).reshape(-1))
    valid.scatter_(0, flat, ok.reshape(-1))
    n_overflow = ((ssrc < n) & ~ok).sum(dim=1)
    rows = batch + (n, d)
    return DenseAdj(nbr=nbr[:size].view(rows), w=w[:size].view(rows),
                    valid=valid[:size].view(rows),
                    n_overflow=n_overflow.view(batch))


class HybridAdj(NamedTuple):
    """Complete dense rows for nodes of degree <= d_hyb plus a compacted
    prefix of the hubs' directed edges (see the reference); fields carry
    the slab's member dimensions."""

    adj: DenseAdj
    is_hub: torch.Tensor          # bool[*B, N]
    hsrc: torch.Tensor            # int64[*B, hub_cap] (n where invalid)
    hdst: torch.Tensor            # int64[*B, hub_cap]
    hw: torch.Tensor              # float32[*B, hub_cap]
    hvalid: torch.Tensor          # bool[*B, hub_cap]
    n_hub_overflow: torch.Tensor  # int64[*B]


def build_hybrid(slab: GraphSlab) -> HybridAdj:
    """Partition directed edges by source degree.  Hubs are taken from the
    slab's own (per-member) degrees, so a masked slab has its own split."""
    if slab.d_hyb <= 0 or slab.hub_cap <= 0:
        raise ValueError("slab carries no hybrid sizing (d_hyb/hub_cap); "
                         "pack with pack_edges")
    n = slab.n_nodes
    is_hub = slab.degrees() > slab.d_hyb
    srcd, dstd, wd, ad = slab.directed()
    ad = ad & (srcd != dstd)
    hub_src = seg.gather_last(is_hub, srcd.clamp(0, n - 1))
    adj = build_dense_adjacency(slab, width=slab.d_hyb, edge_mask=~hub_src)
    hub_e = ad & hub_src
    order = torch.argsort((~hub_e).to(torch.int8), dim=-1, stable=True)
    take = order[..., :slab.hub_cap]
    hvalid = torch.gather(hub_e, -1, take)
    n_hub = hub_e.sum(dim=-1)

    def pick(t):
        if t.dim() == 1:
            return t[take]
        return torch.gather(t, -1, take.expand(t.shape[:-1] +
                                               take.shape[-1:]))

    return HybridAdj(
        adj=adj, is_hub=is_hub,
        hsrc=torch.where(hvalid, pick(srcd), n),
        hdst=torch.where(hvalid, pick(dstd), n),
        hw=torch.where(hvalid, pick(wd), 0.0), hvalid=hvalid,
        n_hub_overflow=(n_hub - slab.hub_cap).clamp(min=0))


def row_gather(values: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """``values[m, nbr[...]]`` for ``values`` ``[M, N]`` and shared rows
    ``nbr`` ``[N, D]`` or per-member rows ``[M, N, D]``: ``[M, N, D]``."""
    if nbr.dim() == 2:
        return values[:, nbr]
    m = values.shape[0]
    return torch.gather(values, 1, nbr.reshape(m, -1)).view(nbr.shape)


class RowTotals(NamedTuple):
    """Per-row candidate labels with aggregated neighbour weight; only
    ``is_head`` slots are distinct candidates.  Slot ``D`` is the node's
    own label with weight 0, so "stay" is always scored."""

    label: torch.Tensor    # int64[M, N, D+1]
    total: torch.Tensor    # float32[M, N, D+1]
    is_head: torch.Tensor  # bool[M, N, D+1]


def sorted_rank(lab: torch.Tensor) -> torch.Tensor:
    """Per slot of ``lab`` ``[R, D]``, the count of its row's slots with a
    smaller label (its position in the row sorted by label)."""
    return torch.searchsorted(torch.sort(lab, dim=1).values, lab)


def row_label_totals(adj: DenseAdj, labels: torch.Tensor,
                     rank: bool = False):
    """Aggregate neighbour weight per (member, row, neighbour label) with
    the ``row_totals`` kernel.  Consumers treat the result as an unordered
    candidate set (:func:`best_candidate` does).

    With ``rank`` the result is ``(RowTotals, rank int64[M, N, D+1])``:
    each slot's position in its row sorted by label, i.e. the count of the
    row's slots (empty ones included) with a smaller label — the order the
    reference's sorted CPU lowering gives its slots."""
    n, d = adj.nbr.shape[-2:]
    m = labels.shape[0]
    lab_n = torch.where(adj.valid, row_gather(labels, adj.nbr), SENTINEL)
    lab_ext = torch.cat([lab_n, labels[:, :, None]], dim=2).to(torch.int32)
    w_ext = torch.cat([torch.where(adj.valid, adj.w, 0.0),
                       adj.w.new_zeros(adj.w.shape[:-1] + (1,))], dim=-1)
    w_ext = w_ext.expand(m, n, d + 1).reshape(m * n, d + 1)
    total, head = row_kernels.row_totals(
        lab_ext.view(m * n, d + 1), w_ext)
    pos = sorted_rank(lab_ext.view(m * n, d + 1)) if rank else None
    lab_ext = lab_ext.to(torch.int64)
    real = lab_ext != SENTINEL
    tot = RowTotals(label=torch.where(real, lab_ext, 0),
                    total=torch.where(real, total.view(m, n, d + 1), 0.0),
                    is_head=head.view(m, n, d + 1))
    return (tot, pos.view(m, n, d + 1)) if rank else tot


def best_candidate(tot: RowTotals, score: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax candidate per row: ``(best_label, want_move)``.

    Among slots tied at the max score the smallest label wins — the
    candidate the reference's sorted lowering picks (its rows are sorted
    by label and ``argmax`` takes the first) — so the choice does not
    depend on slot order.  Non-head slots must already score -inf."""
    best_score = score.max(dim=-1, keepdim=True).values
    big = torch.iinfo(torch.int64).max
    best = torch.where(score == best_score, tot.label, big).min(dim=-1).values
    has = torch.isfinite(best_score[..., 0])
    best = torch.where(has, best, labels)
    return best, has & (best != labels)
