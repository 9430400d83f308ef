"""Normalized mutual information (arithmetic normalization), in numpy.

A frozen copy of ``fastconsensus_tpu_torch/utils/metrics.nmi`` (sklearn's
``normalized_mutual_info_score(average_method='arithmetic')``), kept with
the benchmark so the quality metric cannot move with the program.
"""

from __future__ import annotations

import numpy as np


def nmi(labels_a, labels_b) -> float:
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
