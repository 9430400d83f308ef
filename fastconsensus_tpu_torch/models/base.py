"""Base-detection interface: a detector runs the base algorithm once per key.

    detect(slab, keys[n_p, 2], init_labels=None) -> labels int64[n_p, N]

The reference vmaps a one-partition kernel over the ensemble axis; here
the members are an explicit leading dimension, run in chunks bounded by a
memory budget (``sizing.members_per_call``).  Detectors are per-key independent (member i's labels
depend only on ``(slab, keys[i])``), so the chunking never changes results.
"""

from __future__ import annotations

from typing import Callable, Optional, Protocol

import torch

from fastconsensus_tpu_torch.graph import GraphSlab
from fastconsensus_tpu_torch.sizing import members_per_call


class Detector(Protocol):
    def __call__(self, slab: GraphSlab, keys: torch.Tensor,
                 init_labels: Optional[torch.Tensor] = None
                 ) -> torch.Tensor: ...


def ensemble(run: Callable, prepare: Callable[[GraphSlab], object],
             member_bytes: Optional[Callable[[GraphSlab], int]] = None
             ) -> Detector:
    """Lift a member-batched kernel to the ensemble.

    ``prepare(slab)`` builds the label-independent inputs once per call
    (adjacency rows, strengths); ``run(prep, keys[M, 2], init[M, N] or
    None)`` runs M members; ``member_bytes(slab)`` bounds one member's
    temporaries (default: a Louvain sweep's).  The lifted detector takes
    ``init_labels`` to warm-start member i from ``init_labels[i]``."""

    def detect(slab: GraphSlab, keys: torch.Tensor,
               init_labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        n_p = keys.shape[0]
        chunk = members_per_call(slab, n_p, member_bytes)
        prep = prepare(slab)
        parts = []
        for s in range(0, n_p, chunk):
            init = None if init_labels is None else init_labels[s:s + chunk]
            parts.append(run(prep, keys[s:s + chunk], init))
        return torch.cat(parts, dim=0)

    detect.supports_init = True
    return detect
