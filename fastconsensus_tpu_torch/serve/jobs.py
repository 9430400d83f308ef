"""Canonical edge lists, the serving tier's content form of a graph.

Counterpart of ``canonical_edges`` in ``fastconsensus_tpu/serve/jobs.py``
(the job model, queue states and content hashing there belong to the
server, which is not ported yet).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def canonical_edges(edges: np.ndarray, n_nodes: int,
                    weights: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray,
                               Optional[np.ndarray]]:
    """Canonical ``(u, v, w)`` in ascending edge-key order.

    Same dedup semantics as ``graph.pack_edges`` (src < dst, self-loops
    dropped, first weight wins on duplicates), then sorted by
    ``u * n_nodes + v`` so the result does not depend on input edge
    order.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if weights is not None:
        weights = np.asarray(weights, dtype=np.float32)
    u = np.minimum(edges[:, 0], edges[:, 1])
    v = np.maximum(edges[:, 0], edges[:, 1])
    keep = u != v
    u, v = u[keep], v[keep]
    if weights is not None:
        weights = weights[keep]
    key = u * np.int64(n_nodes) + v
    _, first = np.unique(key, return_index=True)
    first.sort()
    u, v, key = u[first], v[first], key[first]
    if weights is not None:
        weights = weights[first]
    order = np.argsort(key, kind="stable")
    return (u[order], v[order],
            None if weights is None else weights[order])
