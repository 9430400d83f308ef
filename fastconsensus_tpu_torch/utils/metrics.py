"""Partition-quality metrics (host-side, numpy): NMI, modularity and the
map equation.

A copy of the reference's ``utils/metrics.py``.

The reference computes no metrics at all (SURVEY.md §5); its validation
protocol is the paper's: NMI against planted partitions on LFR graphs.  These
are the metrics the test-suite and benchmark harness use for that protocol.
"""

from __future__ import annotations

import numpy as np


def nmi(labels_a, labels_b) -> float:
    """Normalized mutual information (arithmetic normalization), in [0, 1].

    Matches sklearn's ``normalized_mutual_info_score(average_method=
    'arithmetic')``; implemented directly so the framework has no sklearn
    dependency on the hot path.
    """
    a = np.asarray(labels_a).ravel()
    b = np.asarray(labels_b).ravel()
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    n = a.shape[0]
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    ka, kb = ai.max() + 1, bi.max() + 1
    cont = np.zeros((ka, kb), dtype=np.float64)
    np.add.at(cont, (ai, bi), 1.0)
    pij = cont / n
    pa = pij.sum(axis=1)
    pb = pij.sum(axis=0)
    outer = pa[:, None] * pb[None, :]
    nz = pij > 0
    mi = float((pij[nz] * np.log(pij[nz] / outer[nz])).sum())
    ha = float(-(pa[pa > 0] * np.log(pa[pa > 0])).sum())
    hb = float(-(pb[pb > 0] * np.log(pb[pb > 0])).sum())
    if ha == 0.0 and hb == 0.0:
        return 1.0
    denom = 0.5 * (ha + hb)
    if denom == 0.0:
        return 0.0
    return max(0.0, min(1.0, mi / denom))


def map_equation(src, dst, weight, labels) -> float:
    """Two-level map equation L(M) in bits (Rosvall–Bergstrom 2008).

    For an undirected weighted graph with visit rates ``p_i =
    strength_i / 2m`` and module exit rates ``q_m = w_cross(m) / 2m``:

        L(M) = plogp(sum_m q_m) - 2 sum_m plogp(q_m)
             + sum_m plogp(q_m + sum_{i in m} p_i) - sum_i plogp(p_i)

    This is the quantity ``native/src/infomap.cpp`` minimizes (which drops
    the partition-independent last term); implemented independently here so
    tests can verify the native optimizer against hand-computed values.
    Self-loops must be passed once; they contribute to strengths but never
    to exit rates.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    w = np.asarray(weight, dtype=np.float64)
    labels = np.asarray(labels)
    m2 = 2.0 * w.sum()
    if m2 == 0.0:
        return 0.0

    def plogp(x):
        x = np.asarray(x, dtype=np.float64)
        out = np.zeros_like(x)
        nz = x > 0
        out[nz] = x[nz] * np.log2(x[nz])
        return out

    n_comm = int(labels.max()) + 1
    strength = np.zeros(labels.shape[0], dtype=np.float64)
    np.add.at(strength, src, w)
    np.add.at(strength, dst, w)
    p_mod = np.zeros(n_comm, dtype=np.float64)
    np.add.at(p_mod, labels, strength / m2)
    q = np.zeros(n_comm, dtype=np.float64)
    cross = labels[src] != labels[dst]
    np.add.at(q, labels[src[cross]], w[cross] / m2)
    np.add.at(q, labels[dst[cross]], w[cross] / m2)
    return float(plogp(q.sum()).sum() - 2.0 * plogp(q).sum()
                 + plogp(q + p_mod).sum() - plogp(strength / m2).sum())


def modularity(src, dst, weight, labels) -> float:
    """Newman modularity of a partition of an undirected weighted graph.

    Edges are given once (canonical orientation); self-loops count once.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    w = np.asarray(weight, dtype=np.float64)
    labels = np.asarray(labels)
    m2 = 2.0 * w.sum()          # 2m
    if m2 == 0.0:
        return 0.0
    n_comm = int(labels.max()) + 1
    strength = np.zeros(labels.shape[0], dtype=np.float64)
    np.add.at(strength, src, w)
    np.add.at(strength, dst, w)
    sigma_tot = np.zeros(n_comm, dtype=np.float64)
    np.add.at(sigma_tot, labels, strength)
    intra = w[labels[src] == labels[dst]].sum()
    return float(2.0 * intra / m2 - np.square(sigma_tot / m2).sum())
