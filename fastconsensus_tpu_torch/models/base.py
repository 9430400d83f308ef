"""Base-detection interface: a detector runs the base algorithm once per key.

    detect(slab, keys[n_p, 2], init_labels=None) -> labels int64[n_p, N]

The reference vmaps a one-partition kernel over the ensemble axis; here
the members are an explicit leading dimension, run in chunks bounded by a
memory budget (``sizing.members_per_call``).  Detectors are per-key independent (member i's labels
depend only on ``(slab, keys[i])``), so the chunking never changes results.

A detector built by :func:`ensemble` also takes a graph-stacked slab
(``graph.stack_slabs``: fields ``[G, capacity]``) with ``K = G * per``
keys: member ``k`` runs on graph ``k // per``, and all K members form one
detection stream (the cross-graph batch, ``consensus.run_consensus_batch``).
Such detectors carry ``supports_stack``; the host C++ detectors do not,
and the batch path calls them once per graph.  The graphs' prepared state
reaches their members by view where the sweep's ops allow it (Louvain's
dense matrices on the matmul sweep); what the ops index per member (edge
slots, strengths, rows) is copied per member and counted in the chunk's
memory budget.
"""

from __future__ import annotations

from typing import Callable, Optional, Protocol

import numpy as np
import torch

from fastconsensus_tpu_torch.graph import GraphSlab
from fastconsensus_tpu_torch.obs import counters as obs_counters
from fastconsensus_tpu_torch.obs.tracer import get_tracer
from fastconsensus_tpu_torch.ops import capture
from fastconsensus_tpu_torch.sizing import members_per_call


class Detector(Protocol):
    def __call__(self, slab: GraphSlab, keys: torch.Tensor,
                 init_labels: Optional[torch.Tensor] = None
                 ) -> torch.Tensor: ...


def row_bytes(*xs) -> int:
    """Bytes of one leading-axis row of each tensor in ``xs`` (a tensor,
    a NamedTuple of tensors, or None): what a copy per member costs."""
    total = 0
    for x in xs:
        if x is None:
            continue
        if isinstance(x, torch.Tensor):
            total += x[0].numel() * x.element_size() if x.dim() else 0
        else:
            total += row_bytes(*x)
    return total


def ensemble(run: Callable, prepare: Callable[[GraphSlab], object],
             member_bytes: Optional[Callable[[GraphSlab], int]] = None
             ) -> Detector:
    """Lift a member-batched kernel to the ensemble.

    ``prepare(slab)`` builds the label-independent inputs once per call
    (adjacency rows, strengths); ``run(prep, keys[M, 2], init[M, N] or
    None)`` runs M members; ``member_bytes(slab)`` bounds one member's
    temporaries (default: a Louvain sweep's) and stays on the detector as
    ``member_bytes``.  The lifted detector takes
    ``init_labels`` to warm-start member i from ``init_labels[i]``.

    On a graph-stacked slab ``prepare`` runs once over the G graphs (its
    state keeps their leading axis: each graph's own strengths, 2m and
    rows) and ``prep.members_of(graph_of_member)`` hands each chunk of
    members its graph's state; the bytes that copies per member
    (``prep.member_copy_bytes()``) count against the chunk's budget.

    fcobs: a ``member_chunk`` span a chunk (args ``chunk``, ``members``)
    and the counter ``detect.member_chunks``, where the host dispatches
    it (a captured block counts its capture, not its replays)."""

    def layout(slab: GraphSlab, n_members: int, prep):
        """``(graph of each member on the device and on the host, bytes
        copied per member)``: ``(None, None, 0)`` for a shared slab."""
        if not slab.batch:
            return None, None, 0
        n_graphs = slab.batch[0]
        if len(slab.batch) != 1 or n_members % n_graphs:
            raise ValueError(
                f"{n_members} keys for a slab stacked {tuple(slab.batch)}: "
                f"expected one axis of graphs and a multiple of it")
        per = n_members // n_graphs
        # the layout is static: the host knows it with no read back
        return (torch.arange(n_graphs, device=slab.device
                             ).repeat_interleave(per),
                np.repeat(np.arange(n_graphs), per),
                prep.member_copy_bytes())

    def detect(slab: GraphSlab, keys: torch.Tensor,
               init_labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        n_keys = keys.shape[0]
        prep = prepare(slab)
        graph_of, graph_rows, copied = layout(slab, n_keys, prep)
        chunk = members_per_call(slab, n_keys, member_bytes, copied)
        # a batched block's sweep mask (ops/capture.py), chunked alike
        mask = capture.sweeping_members(n_keys) if capture.active() \
            else None
        tracer = get_tracer()
        parts = []
        for s in range(0, n_keys, chunk):
            init = None if init_labels is None else init_labels[s:s + chunk]
            p = prep if graph_of is None else prep.members_of(
                graph_of[s:s + chunk], graph_rows[s:s + chunk])
            obs_counters.get_registry().inc("detect.member_chunks")
            with tracer.span("member_chunk", chunk=s // chunk,
                             members=min(chunk, n_keys - s)), \
                    capture.sweeping(None if mask is None
                                     else mask[s:s + chunk]):
                parts.append(run(p, keys[s:s + chunk], init))
        return torch.cat(parts, dim=0)

    def chunk_of(slab: GraphSlab, n_members: int) -> int:
        """The member chunk a call of ``n_members`` keys on ``slab`` runs
        (a round block runs only where it is all of them)."""
        _, _, copied = layout(slab, n_members, prepare(slab))
        return members_per_call(slab, n_members, member_bytes, copied)

    detect.supports_init = True
    detect.supports_stack = True
    # the consensus driver sizes its persisted detect chunks with it
    detect.member_bytes = member_bytes
    detect.chunk_of = chunk_of
    return detect
