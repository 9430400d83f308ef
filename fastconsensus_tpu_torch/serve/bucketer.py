"""Shape buckets: pad incoming graphs onto a canonical ladder.

Counterpart of ``fastconsensus_tpu/serve/bucketer.py``.  Every graph is
padded to a **size class**, the ``{2^k, 3*2^k}`` grid of
:func:`sizing.grid_up`:

* ``n_class`` — node count padded up (extra nodes are isolated: no
  edges, no strength, singleton communities a server slices off);
* ``e_class`` — canonical (deduped) edge count padded up; it sizes the
  slab capacity as ``pack_edges`` would (``2*E + 16`` closure headroom)
  and is the bucket-canonical wedge-sample count L
  (``run_consensus(n_closure=...)``).

The content-derived static slab fields are canonicalized away:
``d_cap``/``d_hyb``/``hub_cap`` are 0 and ``agg_cap``/``cap_hint`` are
functions of the bucket, so any two graphs of one bucket have equal
statics and stack into one batch (``graph.stack_slabs``,
``consensus.run_consensus_batch``).  Detection therefore takes the matmul
sweep for buckets of up to ``MATMUL_MAX_N`` nodes and the hash sweep
above, never the dense or hybrid rows.  Padding is deterministic: the
same graph and config give the same bucket and the same partitions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from fastconsensus_tpu_torch import sizing
from fastconsensus_tpu_torch.analysis import footprint
from fastconsensus_tpu_torch.graph import (GraphSlab, derive_agg_sizing,
                                           pack_edges)

# The ladder's class floors and batch rungs, defined once in the
# torch-free analysis/footprint.py the fleet router routes on.
MIN_NODE_CLASS = footprint.MIN_NODE_CLASS
MIN_EDGE_CLASS = footprint.MIN_EDGE_CLASS
BATCH_LADDER = footprint.BATCH_RUNGS


def batch_rung(n: int) -> int:
    """Largest batch-ladder rung <= n (>= 1)."""
    n = max(int(n), 1)
    rung = BATCH_LADDER[0]
    for b in BATCH_LADDER:
        if b <= n:
            rung = b
    return rung


class BucketTooLarge(ValueError):
    """Admission refused: the graph exceeds the configured ladder top."""


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One rung of the ladder: canonical (node, edge) size class."""

    n_class: int
    e_class: int

    @property
    def capacity(self) -> int:
        """Slab capacity: pack_edges' default headroom at the class."""
        return 2 * self.e_class + 16

    @property
    def agg_cap(self) -> int:
        """Aggregate compaction budget, sized from the capacity so that it
        can never starve (alive edges are bounded by the capacity, and
        ``derive_agg_sizing(capacity) > capacity``): a budget
        re-derivation would change a shared bucket's statics and split a
        batched job off to a solo run."""
        return derive_agg_sizing(self.capacity)

    @property
    def n_closure(self) -> int:
        """Bucket-canonical wedge-sample count L (run_consensus)."""
        return self.e_class

    def key(self) -> str:
        return f"n{self.n_class}_e{self.e_class}"

    def describe(self) -> dict:
        return {"n_class": self.n_class, "e_class": self.e_class,
                "capacity": self.capacity, "key": self.key()}


def bucket_for(n_nodes: int, n_edges: int,
               max_nodes: Optional[int] = None,
               max_edges: Optional[int] = None) -> Bucket:
    """The bucket serving a graph of ``n_nodes`` / ``n_edges``
    (canonical edge count), or raise :class:`BucketTooLarge`."""
    if n_nodes < 1 or n_edges < 1:
        raise ValueError(
            f"graph must have >= 1 node and >= 1 edge, got "
            f"n_nodes={n_nodes}, n_edges={n_edges}")
    if max_nodes is not None and n_nodes > max_nodes:
        raise BucketTooLarge(
            f"graph has {n_nodes} nodes; this server admits at most "
            f"{max_nodes}")
    if max_edges is not None and n_edges > max_edges:
        raise BucketTooLarge(
            f"graph has {n_edges} edges; this server admits at most "
            f"{max_edges}")
    return Bucket(n_class=sizing.grid_up(n_nodes, MIN_NODE_CLASS),
                  e_class=sizing.grid_up(n_edges, MIN_EDGE_CLASS))


def bucket_from_key(key: str) -> Bucket:
    """Parse a bucket key (``"n64_e96"``) back into its Bucket; classes
    must sit exactly on the ladder grid."""
    try:
        n_part, e_part = key.split("_")
        if not (n_part.startswith("n") and e_part.startswith("e")):
            raise ValueError
        n_class, e_class = int(n_part[1:]), int(e_part[1:])
    except ValueError:
        raise ValueError(
            f"bad bucket key {key!r}; expected the form n<N>_e<E>, e.g. "
            f"n64_e96") from None
    want = bucket_for(n_class, e_class)
    got = Bucket(n_class=n_class, e_class=e_class)
    if want != got:
        raise ValueError(
            f"bucket key {key!r} is not on the ladder grid; the "
            f"nearest real bucket is {want.key()}")
    return got


def probe_edges(bucket: Bucket, variant: int = 0) -> np.ndarray:
    """A deterministic synthetic graph landing exactly in ``bucket``:
    ``n_class`` nodes, ``e_class`` canonical edges (a path over the
    first nodes plus chord families); ``variant`` shifts the chords (or,
    without chords, the path's start) so batch lanes carry distinct
    graphs."""
    n, e = bucket.n_class, bucket.e_class
    seen = set()
    rows = []

    def add(u: int, v: int) -> None:
        if u == v:
            return
        k = (min(u, v), max(u, v))
        if k in seen:
            return
        seen.add(k)
        rows.append(k)

    off = (variant % n) if e <= n - 1 else 0
    for i in range(min(e, n - 1)):
        add((off + i) % n, (off + i + 1) % n)
    shift, i = 2 + (variant % max(n - 3, 1)), 0
    while len(rows) < e:
        add(i, (i + shift) % n)
        i += 1
        if i >= n:
            i, shift = 0, shift + 1
            if shift >= n:  # pragma: no cover — e_class <= n*(n-1)/2
                raise ValueError(f"cannot realize {e} edges on {n} nodes")
    return np.asarray(rows, dtype=np.int64)


def pad_to_bucket(edges: np.ndarray, n_nodes: int,
                  weights: Optional[np.ndarray] = None,
                  max_nodes: Optional[int] = None,
                  max_edges: Optional[int] = None,
                  canonical: Optional[Tuple[np.ndarray, np.ndarray,
                                            Optional[np.ndarray]]] = None,
                  device=None) -> Tuple[GraphSlab, Bucket]:
    """Pack a graph into its bucket's canonical slab on ``device`` (CUDA
    unless the caller names another; raises without it, as
    ``pack_edges``).

    Every static field of the result is a function of the bucket alone;
    the alive edges are the input graph's (padding adds dead slots and
    isolated nodes only).  ``canonical``: an already computed
    ``jobs.canonical_edges`` result for these inputs.
    """
    if canonical is None:
        from fastconsensus_tpu_torch.serve.jobs import canonical_edges

        canonical = canonical_edges(edges, n_nodes, weights)
    u, v, w = canonical
    if w is not None and not np.all(np.isfinite(w)):
        # malformed input, refused per graph before any batch is stacked
        raise ValueError("graph carries non-finite edge weights")
    bucket = bucket_for(n_nodes, int(u.shape[0]),
                        max_nodes=max_nodes, max_edges=max_edges)
    slab = pack_edges(np.stack([u, v], axis=1), bucket.n_class,
                      weights=w, capacity=bucket.capacity, device=device)
    slab = dataclasses.replace(
        slab, d_cap=0, d_hyb=0, hub_cap=0,
        cap_hint=bucket.capacity, agg_cap=bucket.agg_cap)
    return slab, bucket
