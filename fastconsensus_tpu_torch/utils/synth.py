"""Synthetic planted-partition graphs, in numpy.

The port's own copy of the reference's ``utils/synth.planted_partition``
(same draws from the same seed, so both packages build the same graph),
plus the heterogeneous block sizes of ``bench.py``'s email-Eu-core
stand-in.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def heterogeneous_sizes(n: int, n_comm: int, alpha: float) -> np.ndarray:
    """Block sizes ~ rank^-alpha summing to ``n`` (at least 2 each): the
    email-Eu-core stand-in's department histogram (``bench.py``'s
    ``size_alpha``)."""
    w = np.arange(1, n_comm + 1, dtype=float) ** -alpha
    sizes = np.maximum((w / w.sum() * n).astype(np.int64), 2)
    while sizes.sum() > n:
        sizes[np.argmax(sizes)] -= 1
    while sizes.sum() < n:
        sizes[np.argmin(sizes)] += 1
    return sizes


def planted_partition(n: int,
                      n_comm: int,
                      p_in: float,
                      p_out: float,
                      seed: int = 0,
                      sizes: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse planted-partition (SBM) sample.

    Nodes are split into ``n_comm`` contiguous near-equal blocks (or the
    given ``sizes``, which must sum to ``n`` — used to mimic real datasets
    with heterogeneous community sizes, e.g. the email-Eu-core stand-in);
    each intra-block pair is an edge with probability ``p_in``, inter-block
    with ``p_out``.  Sampling is done per block pair by drawing the edge
    *count* from the exact binomial and then drawing that many pairs
    uniformly (duplicates dropped), so the cost is O(E), not O(N^2) —
    required for the 100k-node configs.  The tiny downward bias from
    dropped duplicates is irrelevant for benchmarking and testing.

    Returns ``(edges int64[E, 2] with u < v, labels int64[n])``.
    """
    if not 0 <= p_out <= p_in <= 1:
        raise ValueError(f"need 0 <= p_out <= p_in <= 1, got {p_in}, {p_out}")
    rng = np.random.default_rng(seed)
    if sizes is not None:
        sizes = np.asarray(sizes, dtype=np.int64)
        if sizes.shape != (n_comm,) or sizes.sum() != n or (sizes < 1).any():
            raise ValueError(
                f"sizes must be {n_comm} positive ints summing to {n}")
        bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    else:
        bounds = np.linspace(0, n, n_comm + 1).astype(np.int64)
    labels = np.zeros(n, dtype=np.int64)
    for c in range(n_comm):
        labels[bounds[c]:bounds[c + 1]] = c

    chunks = []

    def sample_block(lo_a, hi_a, lo_b, hi_b, p, same):
        sa, sb = hi_a - lo_a, hi_b - lo_b
        n_pairs = sa * (sa - 1) // 2 if same else sa * sb
        if n_pairs <= 0 or p <= 0:
            return
        count = rng.binomial(n_pairs, p)
        if count == 0:
            return
        # rejection-free for cross blocks; rejection (u<v) for diagonal
        draw = int(count * (2.2 if same else 1.1)) + 8
        u = rng.integers(lo_a, hi_a, draw)
        v = rng.integers(lo_b, hi_b, draw)
        if same:
            keep = u < v
            u, v = u[keep], v[keep]
        pair = np.stack([np.minimum(u, v), np.maximum(u, v)], 1)
        pair = np.unique(pair, axis=0)[:count]
        chunks.append(pair)

    for a in range(n_comm):
        sample_block(bounds[a], bounds[a + 1], bounds[a], bounds[a + 1],
                     p_in, same=True)
        for b in range(a + 1, n_comm):
            sample_block(bounds[a], bounds[a + 1], bounds[b], bounds[b + 1],
                         p_out, same=False)
    if not chunks:
        raise ValueError("generated an empty graph; raise p_in/p_out")
    edges = np.unique(np.concatenate(chunks, axis=0), axis=0)
    return edges, labels
