"""Static-capacity edge slab on a torch device.

The PyTorch counterpart of ``fastconsensus_tpu/graph.py``: the graph is a
fixed-capacity COO slab of canonical edges (``src < dst``) with a weight
and an ``alive`` mask per slot.  Thresholding masks edges out, triadic
closure writes into dead slots, and the static sizing fields (``d_cap``,
``d_hyb``, ``hub_cap``, ``agg_cap``, ``cap_hint``) pick and size the
detection lowering exactly as the reference's do, so both packages take
the same path on the same graph.

Indices are held as int64 (torch's indexing type); values are the same as
the reference's int32 arrays.

A slab may be member-batched: any of ``src``/``dst``/``weight``/``alive``
may carry a leading ensemble dimension (``[M, capacity]``), as the
reference's slabs do under its ensemble ``vmap`` when each member masks or
aggregates the graph its own way (Leiden's refinement and aggregate
levels).  Per-node reductions then return ``[M, n_nodes]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from fastconsensus_tpu_torch.utils.env import resolve_device

# Widest per-node dense candidate row pack_edges will configure.
DENSE_D_MAX = 1024


@dataclasses.dataclass(frozen=True)
class GraphSlab:
    """Fixed-capacity undirected weighted graph in COO form.

    Dead slots have ``alive == False`` and their endpoints are meaningless.
    The static fields mirror the reference's (see its GraphSlab docstring).
    """

    src: torch.Tensor     # int64[capacity] or [M, capacity]
    dst: torch.Tensor     # int64[capacity] or [M, capacity]
    weight: torch.Tensor  # float32[capacity] or [M, capacity]
    alive: torch.Tensor   # bool[capacity] or [M, capacity]
    n_nodes: int
    d_cap: int = 0
    cap_hint: int = 0
    d_hyb: int = 0
    hub_cap: int = 0
    agg_cap: int = 0

    @property
    def capacity(self) -> int:
        return self.src.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def batch(self) -> torch.Size:
        """Leading member dimensions: ``()`` for one shared slab."""
        from fastconsensus_tpu_torch.utils.shapes import broadcast_shape

        return broadcast_shape(
            *(t.shape[:-1] for t in (self.src, self.dst, self.weight,
                                     self.alive)))

    def num_alive(self) -> torch.Tensor:
        return self.alive.sum(dim=-1)

    def take(self, idx: torch.Tensor) -> "GraphSlab":
        """The members ``idx`` of a member-batched slab (shared fields
        stay shared)."""
        def pick(t):
            return t[idx] if t.dim() > 1 else t

        return dataclasses.replace(
            self, src=pick(self.src), dst=pick(self.dst),
            weight=pick(self.weight), alive=pick(self.alive))

    def with_statics(self, **statics) -> "GraphSlab":
        """The slab with new static sizing fields (``d_cap``, ...)."""
        return dataclasses.replace(self, **statics)

    def with_weights(self, weight: torch.Tensor,
                     alive: Optional[torch.Tensor] = None) -> "GraphSlab":
        return dataclasses.replace(
            self, weight=weight, alive=self.alive if alive is None else alive)

    def directed(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
        """Both orientations of every slot: (srcd, dstd, weightd, alived),
        each of length 2*capacity along the last axis."""
        return (torch.cat([self.src, self.dst], dim=-1),
                torch.cat([self.dst, self.src], dim=-1),
                torch.cat([self.weight, self.weight], dim=-1),
                torch.cat([self.alive, self.alive], dim=-1))

    def degrees(self) -> torch.Tensor:
        """Alive-degree per node (a self-loop counts twice), int64[*batch,
        n_nodes]."""
        srcd, _, _, ad = self.directed()
        return _node_sum(self.n_nodes, srcd, ad, ad.to(torch.int64))

    def strengths(self) -> torch.Tensor:
        """Weighted degree per node, float32[*batch, n_nodes]."""
        srcd, _, wd, ad = self.directed()
        # fcheck: ok=f64-dtype (exact integer-weight node sums, the same
        # in any scatter order: see _node_sum)
        w64 = torch.where(ad, wd, 0.0).double()
        return _node_sum(self.n_nodes, srcd, ad, w64).to(torch.float32)

    def total_weight(self) -> torch.Tensor:
        """Sum of the alive directed weights (2m), float32[*batch]."""
        _, _, wd, ad = self.directed()
        # fcheck: ok=f64-dtype (2m of integer weights, exact in any order)
        return torch.where(ad, wd, 0.0).double().sum(dim=-1).to(
            torch.float32)


def _node_sum(n: int, srcd: torch.Tensor, ad: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """``values`` summed per alive source node along the last axis.

    The main path's weights are integer counts, but their sums (community
    strengths, 2m) pass float32's 2**24 integer range on large graphs,
    where float32 atomic adds would round in an order that changes from
    run to run on the card.  Float values are therefore summed as float64
    (exact to 2**53), the same on every run and device; below 2**24 the
    float32 result equals the reference's float32 sum."""
    seg = torch.where(ad, srcd, n)
    seg, values = torch.broadcast_tensors(seg, values)
    out = torch.zeros(seg.shape[:-1] + (n + 1,), dtype=values.dtype,
                      device=values.device)
    return out.scatter_add_(-1, seg, values)[..., :n]


def derive_dense_sizing(degree: np.ndarray, n_nodes: int) -> int:
    """Neighbor-row capacity for the dense sweeps: max degree plus 25%
    closure slack, rounded up to a multiple of 8; 0 past DENSE_D_MAX."""
    max_deg = int(degree.max(initial=0))
    want = min((5 * max_deg) // 4 + 8, max(n_nodes - 1, 1))
    want = int(((want + 7) // 8) * 8)
    return want if want <= DENSE_D_MAX else 0


def derive_hybrid_sizing(degree: np.ndarray, n_nodes: int,
                         n_edges: int) -> Tuple[int, int]:
    """Hybrid sizing ``(d_hyb, hub_cap)``: the row width minimizing the
    per-sweep cost model ``3*N*(d+1) + 6*hub_mass(d)`` over multiples of 8,
    or ``(0, 0)`` when no cut beats the pure-hash baseline of 8 random
    operations per directed edge."""
    if n_nodes <= 0 or n_edges <= 0:
        return 0, 0
    max_deg = int(degree.max(initial=0))
    hi = min(max(((max_deg + 7) // 8) * 8, 8), DENSE_D_MAX,
             max(n_nodes - 1, 1))
    cands = np.arange(8, hi + 1, 8, dtype=np.int64)
    if cands.size == 0:
        return 0, 0
    srt = np.sort(degree.astype(np.int64))
    csum = np.concatenate([[0], np.cumsum(srt)])
    total = int(csum[-1])
    idx = np.searchsorted(srt, cands, side="right")
    hub_mass = total - csum[idx]
    cost = 3 * n_nodes * (cands + 1) + 6 * hub_mass
    best = int(np.argmin(cost))
    if int(cost[best]) >= 8 * 2 * n_edges:
        return 0, 0
    return int(cands[best]), hub_cap_for(int(hub_mass[best]))


def hub_cap_for(hub_mass: int) -> int:
    """Hub-prefix capacity for ``hub_mass`` directed hub edges: 50%
    closure slack plus 64, rounded up to a multiple of 8."""
    return int((((3 * int(hub_mass)) // 2 + 64 + 7) // 8) * 8)


def derive_agg_sizing(n_alive: int) -> int:
    """Compacted-aggregate capacity from the live alive-edge count."""
    if n_alive <= 0:
        return 0
    want = n_alive + n_alive // 8 + 1024
    return ((want + 4095) // 4096) * 4096


def agg_compaction_active(slab: GraphSlab) -> bool:
    """Would the aggregate level compact (drives ``n_agg_overflow``)?"""
    return 0 < slab.agg_cap < (slab.cap_hint or slab.capacity)


def compact_alive(slab: GraphSlab, cap: int) -> GraphSlab:
    """Pack each member's alive edges, in slot order, into a fresh slab of
    capacity ``cap``; alive edges ranked beyond ``cap`` are dropped (the
    engine reports the bound as ``n_agg_overflow``).  The result carries
    no dense/hybrid sizing and ``cap_hint = cap``."""
    alive = slab.alive
    pos = torch.cumsum(alive.to(torch.int64), dim=-1) - 1
    ok = alive & (pos < cap)
    tgt = torch.where(ok, pos, cap)

    def scat(x):
        x, t = torch.broadcast_tensors(x, tgt)
        buf = torch.zeros(t.shape[:-1] + (cap + 1,), dtype=x.dtype,
                          device=x.device)
        # rejected slots all land in the spill slot ``cap``, sliced off
        return buf.scatter_(-1, t, torch.where(ok, x, 0))[..., :cap]

    n_keep = slab.num_alive().clamp(max=cap)
    slot = torch.arange(cap, device=alive.device)
    return GraphSlab(src=scat(slab.src), dst=scat(slab.dst),
                     weight=scat(slab.weight),
                     alive=slot < n_keep[..., None],
                     n_nodes=slab.n_nodes, d_cap=0, cap_hint=cap, d_hyb=0,
                     hub_cap=0, agg_cap=0)


def pack_edges(edges: np.ndarray, n_nodes: int,
               weights: Optional[np.ndarray] = None,
               capacity: Optional[int] = None, device=None) -> GraphSlab:
    """Canonicalize, dedupe (first weight wins), drop self-loops and pad an
    edge array into a slab on ``device`` (default CUDA; raises without
    it, see ``utils.env.resolve_device``); same slots and sizing as the
    reference's ``pack_edges``.  Default capacity ``2 * E + 16``."""
    device = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if weights is None:
        weights = np.ones(edges.shape[0], dtype=np.float32)
    weights = np.asarray(weights, dtype=np.float32)
    u = np.minimum(edges[:, 0], edges[:, 1])
    v = np.maximum(edges[:, 0], edges[:, 1])
    keep = u != v
    u, v, weights = u[keep], v[keep], weights[keep]
    _, first = np.unique(u * np.int64(n_nodes) + v, return_index=True)
    first.sort()
    u, v, weights = u[first], v[first], weights[first]
    n_edges = u.shape[0]
    if capacity is None:
        capacity = 2 * n_edges + 16
    if capacity < n_edges:
        raise ValueError(f"capacity {capacity} < edge count {n_edges}")
    src = np.zeros(capacity, dtype=np.int64)
    dst = np.zeros(capacity, dtype=np.int64)
    w = np.zeros(capacity, dtype=np.float32)
    alive = np.zeros(capacity, dtype=bool)
    src[:n_edges] = u
    dst[:n_edges] = v
    w[:n_edges] = weights
    alive[:n_edges] = True
    degree = np.zeros(max(n_nodes, 1) + 1, dtype=np.int64)
    np.add.at(degree, u, 1)
    np.add.at(degree, v, 1)
    d_hyb, hub_cap = derive_hybrid_sizing(degree[:n_nodes], n_nodes, n_edges)

    def put(a):
        return torch.as_tensor(a, device=device)

    return GraphSlab(src=put(src), dst=put(dst), weight=put(w),
                     alive=put(alive), n_nodes=int(n_nodes),
                     d_cap=derive_dense_sizing(degree[:n_nodes], n_nodes),
                     cap_hint=2 * n_edges + 16, d_hyb=d_hyb, hub_cap=hub_cap,
                     agg_cap=derive_agg_sizing(n_edges))


def _statics(slab: GraphSlab) -> Tuple[int, ...]:
    return (slab.n_nodes, slab.capacity, slab.d_cap, slab.cap_hint,
            slab.d_hyb, slab.hub_cap, slab.agg_cap)


def check_stackable(slabs) -> None:
    """Raise unless every slab has the first one's static fields (what
    :func:`stack_slabs` requires), with the reference's message."""
    if not slabs:
        raise ValueError("stack_slabs needs at least one slab")
    base = _statics(slabs[0])
    for i, s in enumerate(slabs[1:], start=1):
        if _statics(s) != base:
            raise ValueError(
                f"cannot batch slabs with differing static shapes: slab 0 "
                f"has {base}, slab {i} has {_statics(s)} "
                f"(n_nodes, capacity, d_cap, cap_hint, d_hyb, hub_cap, "
                f"agg_cap); pad through one serve/bucketer bucket first")


def stack_slabs(slabs, out: Optional[GraphSlab] = None) -> GraphSlab:
    """Stack B same-shaped slabs along a new leading graph axis: a slab
    whose fields are ``[B, capacity]``.  Every static field (n_nodes,
    capacity and the sizing) must be identical across the batch, as the
    reference requires (``serve/bucketer.py`` canonicalizes them).

    Detection reads such a slab as graph-stacked: with ``K = B * per``
    keys, member ``k`` runs on graph ``k // per`` (``models/base.
    ensemble``).

    ``out`` (a stacked slab of the same statics and B, such as a round
    block's static buffers): the slabs are copied into its fields in
    place, so they keep their addresses (a captured CUDA graph reads
    them), and ``out`` is returned."""
    check_stackable(slabs)
    if out is None:
        return dataclasses.replace(
            slabs[0], src=torch.stack([s.src for s in slabs]),
            dst=torch.stack([s.dst for s in slabs]),
            weight=torch.stack([s.weight for s in slabs]),
            alive=torch.stack([s.alive for s in slabs]))
    if _statics(out) != _statics(slabs[0]) or \
            tuple(out.batch) != (len(slabs),):
        raise ValueError(
            f"cannot stack {len(slabs)} slabs of statics "
            f"{_statics(slabs[0])} into buffers of statics {_statics(out)} "
            f"stacked {tuple(out.batch)}")
    for f in ("src", "dst", "weight", "alive"):
        torch.stack([getattr(s, f) for s in slabs], out=getattr(out, f))
    return out


def unstack_slab(stacked: GraphSlab, b: int, copy: bool = False
                 ) -> GraphSlab:
    """Graph ``b`` of a :func:`stack_slabs` result: views, or with
    ``copy`` fresh tensors (a slab that outlives the next write into a
    round block's static buffers)."""
    def pick(t):
        return t[b].clone() if copy else t[b]

    return dataclasses.replace(
        stacked, src=pick(stacked.src), dst=pick(stacked.dst),
        weight=pick(stacked.weight), alive=pick(stacked.alive))


def grow_slab(slab: GraphSlab, new_capacity: int) -> GraphSlab:
    """Extend capacity with dead tail slots (result-preserving, as in the
    reference: insertion visits existing dead slots before the tail)."""
    pad = new_capacity - slab.capacity
    if pad < 0:
        raise ValueError(
            f"cannot shrink slab: {new_capacity} < {slab.capacity}")
    if pad == 0:
        return slab

    def ext(x):
        return torch.cat([x, torch.zeros(pad, dtype=x.dtype,
                                         device=x.device)])

    return dataclasses.replace(
        slab, src=ext(slab.src), dst=ext(slab.dst), weight=ext(slab.weight),
        alive=ext(slab.alive), cap_hint=slab.cap_hint or slab.capacity)


def host_edges(slab: GraphSlab) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Readback: alive (u, v, w) triples as numpy arrays (endpoints int64,
    the slab's index type; the reference's values, in its int32)."""
    alive = slab.alive.cpu().numpy()
    return (slab.src.cpu().numpy()[alive], slab.dst.cpu().numpy()[alive],
            slab.weight.cpu().numpy()[alive])


def to_networkx(slab: GraphSlab):
    """Debug/interop boundary: materialize a networkx.Graph on the host."""
    from fastconsensus_tpu_torch.utils.synth import import_networkx

    g = import_networkx().Graph()
    g.add_nodes_from(range(slab.n_nodes))
    u, v, w = host_edges(slab)
    g.add_weighted_edges_from(zip(u.tolist(), v.tolist(), w.tolist()))
    return g


def from_networkx(g, capacity: Optional[int] = None,
                  device=None) -> GraphSlab:
    """Interop: pack a networkx graph whose nodes are hashable ids.

    Node ids are compacted to 0..N-1 by sorted order, as in the
    reference; the caller keeps the mapping if it needs original ids.
    ``device`` as in :func:`pack_edges`."""
    nodes = sorted(g.nodes())
    index = {n: i for i, n in enumerate(nodes)}
    edges = np.array([[index[a], index[b]] for a, b in g.edges()],
                     dtype=np.int64).reshape(-1, 2)
    wts = np.array([d.get("weight", 1.0) for _, _, d in g.edges(data=True)],
                   dtype=np.float32)
    return pack_edges(edges, len(nodes), weights=wts, capacity=capacity,
                      device=device)
