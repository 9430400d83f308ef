"""Per-(node, label) aggregation primitives: the exact sorted-run
reduction, hashed sum tables, scatter argmax, content-keyed jitter, Gumbel
noise, label compaction.

Counterpart of ``fastconsensus_tpu/ops/segment.py``.  Every function takes
an optional leading batch of ensemble members: arrays are ``[*B, K]`` and
per-node results ``[*B, n]``.  JAX's ``.at[...](mode="drop")`` scatters
become scatters into a buffer with one spill slot that is sliced off;
``.at[].max/min`` become ``scatter_reduce(..., include_self=True)`` on a
buffer whose identity is set explicitly.  Float sums here only ever add
integer-valued weights (co-membership counts), so atomic scatter-adds are
exact in any order.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Tuple

import torch

from fastconsensus_tpu_torch.utils import prng

NEG_INF = float("-inf")
INT32_MIN = -2 ** 31


def _flat_scatter(buf_shape, index, src, reduce=None, fill=0, dtype=None):
    """Scatter ``src`` ``[*B, K]`` into a fresh ``[*B, L]`` buffer along the
    last axis (``index`` in [0, L]; L is the spill slot, sliced off)."""
    *b, length = buf_shape
    index, src = torch.broadcast_tensors(index, src)
    buf = torch.full((*b, length + 1), fill, dtype=dtype or src.dtype,
                     device=src.device)
    if reduce is None:
        buf.scatter_add_(-1, index, src)
    else:
        buf.scatter_reduce_(-1, index, src, reduce=reduce, include_self=True)
    return buf[..., :length]


def _batch_shape(*ts) -> torch.Size:
    return torch.broadcast_shapes(*(t.shape for t in ts))[:-1]


def gather_last(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[..., index]`` per batch row: ``table`` is ``[*B, L]`` and
    ``index`` ``[*B, K]`` or unbatched ``[K]``."""
    if index.dim() < table.dim():
        index = index.expand(*table.shape[:-1], index.shape[-1])
    return torch.gather(table, -1, index)


class Runs(NamedTuple):
    """Aggregated (node, label) runs, ``[*B, E]``, masked by ``valid``;
    runs are in (node, label) order, valid ones first."""

    node: torch.Tensor   # int64; n_nodes for invalid runs
    label: torch.Tensor  # int64; 0 for invalid runs
    total: torch.Tensor  # float32; sum of the run's values
    valid: torch.Tensor  # bool


def node_label_runs(node, label, value, valid, n_nodes: int) -> Runs:
    """Aggregate ``value`` per distinct (node, label) pair along the last
    axis: a stable sort by (node, label) and segmented sums, as the
    reference's lexsort.  Invalid entries sort to the end (node :=
    n_nodes) and never merge with real runs.  Sums accumulate in float64
    (exact for integer weights, see graph._node_sum)."""
    node, label, value, valid = torch.broadcast_tensors(
        node, label, value, valid)
    e = node.shape[-1]
    node_m = torch.where(valid, node, n_nodes)
    label_m = torch.where(valid, label, 0)
    value_m = torch.where(valid, value, 0.0).to(torch.float32)
    # (node, int32 label) as one int64 key in lexicographic order
    key = node_m * (1 << 32) + (label_m + (1 << 31))
    order = torch.argsort(key, dim=-1, stable=True)
    ns = torch.gather(node_m, -1, order)
    ls = torch.gather(label_m, -1, order)
    vs = torch.gather(value_m, -1, order)
    new_run = torch.ones_like(valid)
    new_run[..., 1:] = (ns[..., 1:] != ns[..., :-1]) | \
        (ls[..., 1:] != ls[..., :-1])
    run_id = torch.cumsum(new_run.to(torch.int64), dim=-1) - 1
    total = _flat_scatter(node.shape, run_id, vs.double()).to(torch.float32)
    count = _flat_scatter(node.shape, run_id, torch.ones_like(run_id))
    head_at = torch.where(new_run, run_id, e)
    # one head per run: a sum into zeros writes its value exactly
    run_node = _flat_scatter(node.shape, head_at, ns)
    run_label = _flat_scatter(node.shape, head_at, ls)
    run_valid = (count > 0) & (run_node < n_nodes)
    return Runs(node=torch.where(run_valid, run_node, n_nodes),
                label=torch.where(run_valid, run_label, 0),
                total=torch.where(run_valid, total, 0.0), valid=run_valid)


class HashTables(NamedTuple):
    """Two independent open-addressed sum tables over (node, label) pairs;
    a lookup reads ``min(t1[h1], t2[h2])`` (see the reference docstring for
    the collision bound)."""

    t1: torch.Tensor  # float32[*B, n_buckets]
    t2: torch.Tensor
    n_buckets: int


def _hash_mix(node: torch.Tensor, label: torch.Tensor, c1: int, c2: int,
              n_buckets: int) -> torch.Tensor:
    """Multiply-xorshift mix of a (node, label) pair into [0, n_buckets)."""
    m = (prng.mul32(node & prng.M32, c1) +
         prng.mul32(label & prng.M32, c2)) & prng.M32
    m = m ^ (m >> 15)
    m = prng.mul32(m, 0x2C1B3C6D)
    m = m ^ (m >> 12)
    return m & (n_buckets - 1)


def build_hash_totals(node, label, value, valid, n_buckets: int) -> HashTables:
    """Scatter-add ``value`` per (node, label) into both tables
    (``n_buckets`` a power of two; invalid entries go to the spill slot)."""
    w = torch.where(valid, value, 0.0).to(torch.float32)
    h1 = torch.where(valid, _hash_mix(node, label, 0x9E3779B1, 0x85EBCA77,
                                      n_buckets), n_buckets)
    h2 = torch.where(valid, _hash_mix(node, label, 0x27D4EB2F, 0x165667B1,
                                      n_buckets), n_buckets)
    shape = (*torch.broadcast_shapes(h1.shape, w.shape)[:-1], n_buckets)
    return HashTables(t1=_flat_scatter(shape, h1, w),
                      t2=_flat_scatter(shape, h2, w), n_buckets=n_buckets)


def lookup_hash_totals(tables: HashTables, node, label) -> torch.Tensor:
    """Per-entry total for each queried (node, label) pair."""
    h1 = _hash_mix(node, label, 0x9E3779B1, 0x85EBCA77, tables.n_buckets)
    h2 = _hash_mix(node, label, 0x27D4EB2F, 0x165667B1, tables.n_buckets)
    return torch.minimum(gather_last(tables.t1, h1),
                         gather_last(tables.t2, h2))


def hash_buckets_for(n_entries: int, cap: int = 1 << 26) -> int:
    """Power-of-two table size ~4x the live-pair bound (load <= 0.25)."""
    b = 1
    while b < 4 * max(1, n_entries):
        b <<= 1
    if b > cap:
        logging.getLogger("fastconsensus_tpu_torch").warning(
            "hash table capped at %d buckets for %d entries (load factor "
            "%.2f > 0.25): collision rate exceeds the documented bound",
            cap, n_entries, n_entries / cap)
        return cap
    return b


def scatter_argmax_label(node, score, label, valid, n_nodes: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per node, the label of its max-score entry (ties toward the larger
    label): ``(best_label, best_score, has_any)``, each ``[*B, n_nodes]``.
    Nodes without a valid entry get label -1 and score -inf."""
    seg = torch.where(valid, node, n_nodes)
    masked = torch.where(valid, score, NEG_INF)
    shape = (*_batch_shape(node, score, label, valid), n_nodes)
    best = _flat_scatter(shape, seg, masked, "amax", NEG_INF)
    at = gather_last(best, seg.clamp(0, n_nodes - 1))
    is_best = valid & (masked == at) & (seg < n_nodes)
    best_label = _flat_scatter(shape, torch.where(is_best, seg, n_nodes),
                               torch.where(is_best, label, -1), "amax", -1)
    has_any = torch.isfinite(best)
    return (torch.where(has_any, best_label, -1),
            torch.where(has_any, best, NEG_INF), has_any)


def argmax_label_per_node(runs_node, score, label, valid, n_nodes: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Segment-max form of :func:`scatter_argmax_label`: empty segments
    start from the reduction identities (-inf, INT32_MIN) as
    ``jax.ops.segment_max`` does; the result is the same."""
    seg = torch.where(valid, runs_node, n_nodes)
    masked = torch.where(valid, score, NEG_INF)
    shape = (*_batch_shape(runs_node, score, label, valid), n_nodes)
    best = _flat_scatter(shape, seg, masked, "amax", NEG_INF)
    at = gather_last(best, seg.clamp(0, n_nodes - 1))
    is_best = valid & (masked == at) & (seg < n_nodes)
    best_label = _flat_scatter(shape, seg, torch.where(is_best, label, -1),
                               "amax", INT32_MIN)
    has_any = torch.isfinite(best)
    return (torch.where(has_any, best_label, -1),
            torch.where(has_any, best, NEG_INF), has_any)


def pair_jitter(key: torch.Tensor, node, label, scale) -> torch.Tensor:
    """Keyed tie-break noise in [0, scale), content-keyed on (node, label)
    so it does not depend on array positions (see the reference).

    ``key`` is ``[*B, 2]``; ``node``/``label`` broadcast against
    ``[*B, ...]`` (leading dims aligned with the key batch)."""
    salt = prng.bits(key, (2,))
    extra = max(node.dim(), label.dim()) - (key.dim() - 1)
    s0 = salt[..., 0].reshape(salt.shape[:-1] + (1,) * extra)
    s1 = salt[..., 1].reshape(salt.shape[:-1] + (1,) * extra)
    m = (prng.mul32(node & prng.M32, 0x9E3779B1) +
         prng.mul32(label & prng.M32, 0x85EBCA77) + s0) & prng.M32
    m = m ^ (m >> 15)
    m = (prng.mul32(m, 0x2C1B3C6D) + s1) & prng.M32
    m = m ^ (m >> 13)
    # top 24 bits -> exact float32 in [0, 1), times scale / 2**24
    return (m >> 8).to(torch.float32) * (scale / float(1 << 24))


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` from uniforms in [0, 1),
    float32 at every step as in the reference, with each ``log`` taken in
    float64 and rounded once: the same bits on every device, within about
    1e-6 of the reference's float32 logs (whose own rounding varies by
    backend)."""
    u = u.clamp(1e-7, 1.0 - 1e-7)
    inner = torch.log(u.double()).to(torch.float32)
    return -torch.log((-inner).double()).to(torch.float32)


def uniform_jitter(key: torch.Tensor, shape, scale: float) -> torch.Tensor:
    """Keyed per-position noise in [0, scale): ``[*B, *shape]``."""
    return prng.uniform(key, shape) * scale


def compact_labels(labels: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Relabel to dense 0..k-1 ids ordered by original label id, per row."""
    c = labels.clamp(0, n_nodes)
    present = _flat_scatter((*labels.shape[:-1], n_nodes + 1), c,
                            torch.ones_like(c), "amax", 0)
    rank = torch.cumsum(present, dim=-1) - present
    return torch.where(labels >= 0, gather_last(rank, c), -1)
