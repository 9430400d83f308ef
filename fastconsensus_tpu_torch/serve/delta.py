"""fcdelta: incremental evolving-graph consensus, the numpy half.

Counterpart of ``fastconsensus_tpu/serve/delta.py``.  A delta request
names a parent run (its content hash) and canonical edge ``adds`` /
``removes``; the child graph is the parent's plus the delta, and
consensus re-runs warm-started from the parent's partitions with the
move phase frozen outside the changed edges' neighborhood
(``consensus.run_consensus(init_labels=..., active_mask=...)``).

Everything here is numpy and stdlib: delta parsing and
canonicalization, the child graph, the frontier mask, the warm-start vs
full-run policy (which reads the parent's quality block), and the
derived cache key.  An incremental result is an approximation of the
from-scratch one, so it is cached under a key derived from its lineage
(:func:`delta_cache_key`), never under the child graph's own content
hash.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class DeltaError(ValueError):
    """A malformed delta request (HTTP 400), with the offending
    ``adds[i]``/``removes[i]`` index in the message."""


class ParentNotCached(Exception):
    """The referenced parent hash is not resolvable from the result
    cache (HTTP 404): expired, evicted, never ran on this replica and
    not fetchable from a sibling, or cached before fcdelta existed (no
    graph/config block to rebuild the child graph from)."""


@dataclasses.dataclass(frozen=True)
class DeltaPolicy:
    """Operator thresholds for the warm-start vs full-run decision.

    Every rule that trips falls back to a full run on the child graph —
    fallback is a *correct* answer that costs a full run, incremental is
    a fast answer whose quality rests on the parent being a good seed.
    """

    # largest delta (changed edges / parent edges) eligible for
    # incremental re-consensus; beyond it the changed neighborhood
    # covers so much of the graph that warm-start saves nothing
    max_delta_frac: float = 0.10
    # parent quality floor (fcqual block): an ensemble that disagreed
    # with itself is noise as a warm-start seed
    min_parent_agreement: float = 0.5
    # a parent still churning labels in its final round had not
    # settled; its partitions are a mid-flight snapshot, not a
    # consensus.  The floor is deliberately high: served runs compute
    # churn on the PADDED slab, and community renumbering alone moves
    # the pad singletons' label ids every round (~0.3 on a converged
    # karate-in-n64 run), while a genuinely unsettled run churns ~0.95.
    max_parent_churn: float = 0.75

    def decide(self, n_changed: int, n_parent_edges: int,
               parent: Dict[str, Any], config,
               parent_bucket_key: str, child_bucket_key: str,
               warm_capable: bool,
               huge: bool = False) -> "DeltaDecision":
        """The warm-start vs fallback verdict for one delta submission.

        ``parent`` is the parent's cached result payload; ``config`` the
        (inherited) run config; ``warm_capable`` whether the detector
        supports warm-start at all (``supports_init`` +
        ``config.warm_start``)."""
        frac = float(n_changed) / float(max(n_parent_edges, 1))
        reason = None
        quality = parent.get("quality")
        if not warm_capable:
            reason = "detector_no_warm"
        elif huge:
            reason = "huge_tier"
        elif frac > self.max_delta_frac:
            reason = "delta_too_large"
        elif child_bucket_key != parent_bucket_key:
            # a delta that crosses a bucket boundary lands on different
            # executables AND different padding than the parent ran
            # under; full run keeps the shapes honest
            reason = "bucket_boundary"
        elif len(parent.get("partitions", ())) != config.n_p:
            reason = "ensemble_mismatch"
        elif not parent.get("converged", False):
            reason = "parent_unconverged"
        elif quality is None:
            reason = "parent_quality_missing"
        elif quality.get("final_agreement", 0.0) < \
                self.min_parent_agreement:
            reason = "low_parent_agreement"
        elif quality.get("final_churn_frac", 1.0) > \
                self.max_parent_churn:
            reason = "high_parent_churn"
        mode = "fallback" if reason is not None else "incremental"
        return DeltaDecision(mode=mode, reason=reason,
                             delta_frac=round(frac, 6))


@dataclasses.dataclass(frozen=True)
class DeltaDecision:
    mode: str                       # "incremental" | "fallback"
    reason: Optional[str]           # fallback rule name, None if warm
    delta_frac: float


def parse_edge_pairs(raw: Any, field: str,
                     n_nodes: int) -> np.ndarray:
    """Validate + canonicalize one ``adds``/``removes`` list into
    int64 ``[k, 2]`` with ``u < v``, sorted by edge key — order- and
    orientation-invariant.  Raises :class:`DeltaError` naming the
    offending entry (``adds[3]: ...``) so a client can fix its request
    without diffing the whole delta."""
    if raw is None:
        return np.empty((0, 2), dtype=np.int64)
    if not isinstance(raw, (list, tuple)):
        raise DeltaError(f"{field} must be a list of [u, v] pairs")
    rows: List[Tuple[int, int]] = []
    for i, item in enumerate(raw):
        if not isinstance(item, (list, tuple)) or len(item) != 2:
            raise DeltaError(
                f"{field}[{i}]: expected a [u, v] pair, got {item!r}")
        try:
            a, b = int(item[0]), int(item[1])
        except (TypeError, ValueError):
            raise DeltaError(
                f"{field}[{i}]: endpoints must be integers, "
                f"got {item!r}") from None
        if a == b:
            raise DeltaError(f"{field}[{i}]: self-loop ({a}, {b})")
        if not (0 <= a < n_nodes and 0 <= b < n_nodes):
            bad = max(a, b) if max(a, b) >= n_nodes else min(a, b)
            raise DeltaError(
                f"{field}[{i}]: node {bad} "
                f"out of range for n_nodes={n_nodes}")
        rows.append((min(a, b), max(a, b)))
    if not rows:
        return np.empty((0, 2), dtype=np.int64)
    arr = np.asarray(rows, dtype=np.int64)
    key = arr[:, 0] * np.int64(n_nodes) + arr[:, 1]
    order = np.argsort(key, kind="stable")
    dup = np.flatnonzero(np.diff(key[order]) == 0)
    if dup.size:
        j = int(order[dup[0] + 1])
        u, v = int(arr[j, 0]), int(arr[j, 1])
        raise DeltaError(
            f"{field}[{j}]: duplicate edge ({u}, {v})")
    return arr[order]


def parse_delta(payload: Dict[str, Any],
                n_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(adds, removes)`` canonical int64 ``[k, 2]`` arrays from a
    delta submit body.  An edge in both lists is contradictory and
    rejected; an empty delta is rejected (it is an exact resubmit —
    the content-addressed cache already answers those)."""
    adds = parse_edge_pairs(payload.get("adds"), "adds", n_nodes)
    removes = parse_edge_pairs(payload.get("removes"), "removes",
                               n_nodes)
    if adds.shape[0] == 0 and removes.shape[0] == 0:
        raise DeltaError(
            "empty delta: no adds and no removes (an unchanged graph "
            "is an exact resubmit — use /submit without a parent)")
    if adds.shape[0] and removes.shape[0]:
        akey = adds[:, 0] * np.int64(n_nodes) + adds[:, 1]
        rkey = removes[:, 0] * np.int64(n_nodes) + removes[:, 1]
        both = np.intersect1d(akey, rkey)
        if both.size:
            k = int(both[0])
            u, v = k // n_nodes, k % n_nodes
            j = int(np.flatnonzero(akey == k)[0])
            raise DeltaError(
                f"adds[{j}]: edge ({u}, {v}) appears in both adds "
                f"and removes")
    return adds, removes


def apply_delta(u: np.ndarray, v: np.ndarray, w: Optional[np.ndarray],
                n_nodes: int, adds: np.ndarray, removes: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray,
                           Optional[np.ndarray]]:
    """The child graph's canonical ``(u, v, w)`` from the parent's.

    Set semantics against the parent: every ``removes`` edge must be
    present, every ``adds`` edge must be absent (:class:`DeltaError`
    with the offending index otherwise — a delta against a graph the
    client mis-remembers must fail loudly, not silently drift).  Added
    edges carry weight 1.0 when the parent is weighted.  The result
    stays in canonical ascending edge-key order, so hashing/packing
    need no second sort.
    """
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    key = u * np.int64(n_nodes) + v
    if removes.shape[0]:
        rkey = removes[:, 0] * np.int64(n_nodes) + removes[:, 1]
        pos = np.searchsorted(key, rkey)
        ok = (pos < key.shape[0])
        ok &= np.where(ok, key[np.minimum(pos, key.shape[0] - 1)]
                       == rkey, False)
        if not ok.all():
            j = int(np.flatnonzero(~ok)[0])
            raise DeltaError(
                f"removes[{j}]: edge ({int(removes[j, 0])}, "
                f"{int(removes[j, 1])}) not present in parent")
        keep = np.ones(key.shape[0], dtype=bool)
        keep[pos] = False
        u, v, key = u[keep], v[keep], key[keep]
        if w is not None:
            w = np.asarray(w, dtype=np.float32)[keep]
    if adds.shape[0]:
        akey = adds[:, 0] * np.int64(n_nodes) + adds[:, 1]
        pos = np.searchsorted(key, akey)
        clash = (pos < key.shape[0])
        clash &= np.where(clash, key[np.minimum(pos, key.shape[0] - 1)]
                          == akey, False)
        if clash.any():
            j = int(np.flatnonzero(clash)[0])
            raise DeltaError(
                f"adds[{j}]: edge ({int(adds[j, 0])}, "
                f"{int(adds[j, 1])}) already present in parent")
        u = np.insert(u, pos, adds[:, 0])
        v = np.insert(v, pos, adds[:, 1])
        if w is not None:
            w = np.insert(np.asarray(w, dtype=np.float32), pos,
                          np.float32(1.0))
    if u.shape[0] == 0:
        raise DeltaError("removes empty the graph: no edges remain")
    return u, v, (None if w is None else w)


def neighborhood_mask(u: np.ndarray, v: np.ndarray, n_nodes: int,
                      adds: np.ndarray,
                      removes: np.ndarray) -> np.ndarray:
    """``bool[n_nodes]`` — vertices allowed to move during incremental
    re-consensus: every endpoint of a changed edge plus its 1-hop
    neighborhood in the *child* graph (arXiv:1503.01322's pruning rule:
    only vertices whose neighborhood changed can improve).  Everything
    outside is frozen at the parent's labels by the engine's
    ``active_mask``."""
    changed = np.zeros(n_nodes, dtype=bool)
    for pairs in (adds, removes):
        if pairs.shape[0]:
            changed[pairs[:, 0]] = True
            changed[pairs[:, 1]] = True
    active = changed.copy()
    touched = changed[u] | changed[v]
    active[u[touched]] = True
    active[v[touched]] = True
    return active


def delta_cache_key(child_hash: str, parent_hash: str) -> str:
    """Cache key for an *incremental* result: namespaced by lineage so
    the approximate answer can never shadow the exact content hash of
    the child graph.  An identical delta resubmit (same parent, same
    delta, same config) still dedups exactly."""
    return f"{child_hash}:delta:{parent_hash[:16]}"


def describe_payload(parent_hash: str, decision: DeltaDecision,
                     n_adds: int, n_removes: int) -> Dict[str, Any]:
    """The JSON ``delta`` block stamped on 202/`/status`/`/result` —
    per-submission provenance, deliberately OUTSIDE any content hash
    (like the SLO and trace fields it rides beside)."""
    return {
        "parent": parent_hash,
        "mode": decision.mode,
        "reason": decision.reason,
        "delta_frac": decision.delta_frac,
        "n_adds": int(n_adds),
        "n_removes": int(n_removes),
    }
