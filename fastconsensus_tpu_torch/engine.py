"""One consensus round.

Counterpart of ``fastconsensus_tpu/engine.py``.  A round (reference
``fast_consensus.py:138-201``):

    detect (n_p members)  -> co-membership counts per edge
    -> tau-threshold -> convergence check
    -> triadic closure (skipped if converged) -> singleton repair
    -> convergence check

PyTorch runs eagerly, so the reference's jitted executables have no
counterpart here and ``lax.cond`` is a host branch.  Its batched round
block (``consensus_batch_block``) is :func:`consensus_batch_round` without
the on-device loop: one round of B same-bucket graphs, one detection
stream over all of them, the tail per graph.

:func:`_detect_chunked` is the elastic-recovery detection: the members
run in driver chunks, each persisted to a cache dir as it finishes.  On
a device mesh (``ensemble_sharding``, ``parallel/``) every chunk splits
over the mesh's ensemble axis, each block detected on its own device,
and the round's tail runs edge-locally over the sharded slab
(``ops/sharded_tail.py``).

Not ported: the fused solo round block ``consensus_rounds_block``
(documented bit-identical to per-round execution, so it has no result of
its own; what it saves is launches and readbacks, CUDA-graph work).
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fastconsensus_tpu_torch.graph import (GraphSlab, agg_compaction_active,
                                           stack_slabs, unstack_slab)
from fastconsensus_tpu_torch.models.base import Detector
from fastconsensus_tpu_torch.obs import counters as obs_counters
from fastconsensus_tpu_torch.obs import quality as obs_quality
from fastconsensus_tpu_torch.obs.tracer import get_tracer
from fastconsensus_tpu_torch.ops import consensus_ops as cops
from fastconsensus_tpu_torch.ops.sharded_tail import sharded_consensus_tail
from fastconsensus_tpu_torch.parallel.sharding import (Mesh, gather_labels,
                                                       replicate_slab,
                                                       shard_keys,
                                                       shard_labels)
from fastconsensus_tpu_torch.utils import prng

_logger = logging.getLogger("fastconsensus_tpu_torch")


class RoundStats(NamedTuple):
    """Per-round statistics (fields as the reference's RoundStats)."""

    converged: torch.Tensor
    n_alive: torch.Tensor
    n_unconverged: torch.Tensor
    n_closure_added: torch.Tensor
    n_repaired: torch.Tensor
    n_dropped: torch.Tensor
    n_overflow: torch.Tensor
    n_hub_overflow: torch.Tensor
    n_agg_overflow: torch.Tensor
    cold: torch.Tensor
    n_w_zero: torch.Tensor
    n_w_full: torch.Tensor
    n_frontier: torch.Tensor
    labels_changed: torch.Tensor
    member_modularity: torch.Tensor
    agreement: torch.Tensor


def consensus_tail(slab: GraphSlab, labels: torch.Tensor,
                   k_closure: torch.Tensor, n_p: int, tau: float,
                   delta: float, n_closure: int,
                   closure_tau: Optional[float] = None,
                   prev_labels: Optional[torch.Tensor] = None,
                   sampler: str = "csr"
                   ) -> Tuple[GraphSlab, RoundStats]:
    """Everything after detection: co-membership -> threshold ->
    convergence -> closure -> repair.  ``sampler`` picks the wedge
    sampler: "csr" (argsort of the directed edges, uniform anchors) or
    "scatter" (sort-free partner draws); the two draw different wedges."""
    dev = slab.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    counts = cops.comembership_counts(labels, slab.src, slab.dst)
    prev = slab  # round-start weights, for singleton repair
    slab = cops.update_weights(slab, counts, n_p)
    slab = cops.threshold_weights(slab, tau, n_p)
    st_mid = cops.convergence_stats(slab, n_p, delta)
    n_closed = n_repaired = n_dropped = zero
    if not bool(st_mid.converged):
        n0 = slab.num_alive()
        if sampler == "csr":
            cu, cv, cvalid = cops.sample_wedges(
                k_closure, cops.build_csr(slab), slab.n_nodes, n_closure)
        else:
            cu, cv, cvalid = cops.sample_wedges_scatter(k_closure, slab,
                                                        n_closure)
        cw = cops.comembership_counts(labels, cu, cv)
        if closure_tau is not None:
            bar = cops._f32(cops._f32(closure_tau) * cops._f32(n_p))
            cvalid = cvalid & (cw >= bar)
        slab, dropped = cops.insert_edges_hash(slab, cu, cv, cw, cvalid)
        n1 = slab.num_alive()
        su, sv, sw, svalid = cops.singleton_candidates(slab, prev)
        slab, dropped2 = cops.insert_edges_hash(slab, su, sv, sw, svalid,
                                                unique_new=True)
        n_closed, n_repaired = n1 - n0, slab.num_alive() - n1
        n_dropped = dropped + dropped2
    st_end = cops.convergence_stats(slab, n_p, delta)
    n_overflow = n_hub_overflow = n_agg_overflow = zero
    if slab.d_cap > 0:
        n_overflow = (slab.degrees() - slab.d_cap).clamp(min=0).sum()
    from fastconsensus_tpu_torch.models.louvain import select_move_path
    if select_move_path(slab) == "hybrid":
        deg = slab.degrees()
        hub_mass = torch.where(deg > slab.d_hyb, deg, 0).sum()
        n_hub_overflow = (hub_mass - slab.hub_cap).clamp(min=0)
    if agg_compaction_active(slab):
        n_agg_overflow = (st_end.n_alive - slab.agg_cap).clamp(min=0)
    qual = obs_quality.tail_quality(prev.alive, counts, slab, labels,
                                    prev_labels, n_p)
    stats = RoundStats(
        converged=st_mid.converged | st_end.converged,
        n_alive=st_end.n_alive, n_unconverged=st_end.n_unconverged,
        n_closure_added=n_closed, n_repaired=n_repaired,
        n_dropped=n_dropped, n_overflow=n_overflow,
        n_hub_overflow=n_hub_overflow, n_agg_overflow=n_agg_overflow,
        cold=torch.tensor(False, device=dev),
        n_w_zero=qual.n_w_zero, n_w_full=qual.n_w_full,
        n_frontier=qual.n_frontier, labels_changed=qual.labels_changed,
        member_modularity=qual.member_modularity, agreement=qual.agreement)
    return slab, stats


# Bytes of an int64 word, and of a slab slot: src, dst (int64), weight
# (float32) and alive (bool).
_W = 8
SLAB_SLOT_BYTES = _W + _W + 4 + 1
# Scratch of a stable int64 sort, in words a sorted entry: the keys'
# and the indices' second buffers.
_SORT_SCRATCH_WORDS = 2
# Words live at the peak of one _hash_mix: the input's low word, mul32's
# lo, hi and shifted hi, and the running mix.
_MIX_WORDS = 6
# Words live at the peak of sample_wedges per sample: a threefry draw's
# counters and state (six), the anchors, offsets, degrees, the two
# partner positions and their temporaries (seven).
_WEDGE_WORDS = 13


def tail_temp_bytes(slab: GraphSlab, n_p: int, n_closure: int) -> int:
    """Peak bytes :func:`consensus_tail` (the CSR sampler) allocates over
    its inputs, on an unconverged round (closure runs): the largest of
    its phases, each the tensors live across it plus its own
    temporaries, with ``E`` slots, ``N`` nodes, ``P = n_p`` members and
    ``L = n_closure`` wedge samples:

    * co-membership (``comembership_counts``): the int64 count and sum
      ``[E]`` and a chunk of ``s`` members' two int64 endpoint gathers
      and their compare, ``17 s E``;
    * the weight update and threshold: the counts (float32, kept to the
      quality bundle) and two float32 weights and masks;
    * the CSR build: the directed copy (42 bytes a slot), the sort key,
      order and sorted key, the sort's scratch and the neighbours;
    * the wedge sample (``_WEDGE_WORDS`` int64 words a sample) beside
      the CSR, then the candidates' co-membership;
    * the insertion: the slab's two float32 hash tables, the hashed
      candidates' two int64 tag tables and the slab written anew (21
      bytes a slot);
    * singleton repair: two directed copies and their segment scatters;
    * the quality bundle: per-member modularity's two int64 endpoint
      gathers, compare and float32 weights, ``21 P E``, and the float64
      community degrees.

    The new slab it returns is counted in the last phases."""
    from fastconsensus_tpu_torch.models.louvain import _cap_hint
    from fastconsensus_tpu_torch.ops import segment as seg

    e, n, p, lc = slab.capacity, slab.n_nodes, int(n_p), int(n_closure)

    def comember(k: int) -> int:
        step = max(1, cops._COUNT_ELEMS // max(1, k))
        return 2 * _W * k + 17 * min(p, step) * k

    counts = 4 * e
    thresholded = counts + 4 * e + e                 # weight, alive
    cand = (2 * _W + 1) * lc                         # cu, cv, cvalid
    b_slab = seg.hash_buckets_for(_cap_hint(slab))
    b_cand = seg.hash_buckets_for(lc)
    directed = 2 * SLAB_SLOT_BYTES * e
    degrees = directed + 4 * _W * e + _W * n         # node-sum segments
    phases = (
        comember(e),
        counts + 2 * (4 * e + e),
        thresholded + directed + (3 + _SORT_SCRATCH_WORDS) * 2 * _W * e
        + 2 * _W * e + _W * n,
        thresholded + 2 * _W * e + _W * n + _WEDGE_WORDS * _W * lc,
        thresholded + cand + comember(lc),
        thresholded + cand + 4 * lc + 2 * 4 * b_slab + max(
            8 * e + (2 + _MIX_WORDS) * _W * e,
            2 * _W * b_cand + (4 + _MIX_WORDS) * _W * lc,
            _W * e + SLAB_SLOT_BYTES * e + 5 * _W * lc),
        counts + SLAB_SLOT_BYTES * e + cand + 4 * lc + max(
            degrees, directed + 4 * 2 * _W * e),
        counts + 2 * SLAB_SLOT_BYTES * e + cand + 4 * lc + 4 * _W * n
        + _W * e,
        counts + SLAB_SLOT_BYTES * e + cand + 4 * lc + max(
            degrees, 12 * e + (2 * _W + 1 + 4) * p * e
            + (_W + 4 + 4) * p * n))
    return int(max(phases))


def _maybe_align_keys(keys: torch.Tensor, align: bool) -> torch.Tensor:
    """Give every ensemble member member 0's key when ``align`` is true."""
    if not align:
        return keys
    return keys[:1].expand_as(keys).clone()


def round_keys(key: torch.Tensor, n_p: int, align: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A round's member detection keys ``[n_p, 2]`` and its closure key,
    as the reference derives them: ``split(key)`` into detection and
    closure, then one ``fold_in`` per member."""
    ks = prng.split(key, 2)
    return _maybe_align_keys(prng.partition_keys(ks[0], n_p), align), ks[1]


def consensus_round(slab: GraphSlab, key: torch.Tensor, detect: Detector,
                    n_p: int, tau: float, delta: float, n_closure: int,
                    init_labels: Optional[torch.Tensor] = None,
                    align: bool = False,
                    closure_tau: Optional[float] = None,
                    prev_labels: Optional[torch.Tensor] = None,
                    sampler: str = "csr",
                    active: Optional[torch.Tensor] = None,
                    ensemble_sharding: Optional[Mesh] = None
                    ) -> Tuple[GraphSlab, torch.Tensor, RoundStats]:
    """One full round: ``(next_slab, labels[n_p, N], stats)``.

    ``active`` (bool[N], fcdelta) freezes the vertices outside the mask:
    after detection their labels are set back to the round-entering
    ``prev_labels``, which it therefore requires.  ``None`` adds no op.

    ``ensemble_sharding`` (a ``parallel.Mesh``): ``slab`` is a
    ``ShardedSlab`` on its edge axis, and ``detect`` places the ensemble
    itself: it takes the sharded slab and all ``n_p`` keys, and each
    ensemble shard detects its block of keys on its own device against a
    replicated slab (the driver passes a detector through
    :func:`_detect_chunked` with ``ensemble_sharding``).  The
    labels (in and out) stay split along "p", and the tail runs
    edge-locally (``ops/sharded_tail.py``, the scatter sampler).  Not
    with ``active``: the mesh path serves no fcdelta jobs."""
    if active is not None and ensemble_sharding is not None:
        raise ValueError("active mask is not supported on the mesh path")
    if active is not None and prev_labels is None:
        raise ValueError("active mask requires prev_labels (the freeze "
                         "source for masked-out vertices)")
    tracer = get_tracer()
    keys, k_closure = round_keys(key, n_p, align)
    with tracer.span("detect"):
        labels = detect(slab, keys, init_labels)
    if active is not None:
        labels = torch.where(active[None, :], labels, prev_labels)
    with tracer.span("tail"):
        if ensemble_sharding is not None:
            labels = shard_labels(labels, ensemble_sharding)
            slab, stats = sharded_consensus_tail(
                slab, labels, k_closure, n_p, tau, delta, n_closure,
                ensemble_sharding, closure_tau=closure_tau,
                prev_labels=prev_labels)
        else:
            slab, stats = consensus_tail(slab, labels, k_closure, n_p, tau,
                                         delta, n_closure,
                                         closure_tau=closure_tau,
                                         prev_labels=prev_labels,
                                         sampler=sampler)
    return slab, labels, stats


def detect_stacked(detect: Detector, stacked: GraphSlab, keys: torch.Tensor,
                   init_labels: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Detection of the B graphs of a :func:`graph.stack_slabs` result,
    ``keys[B * n_p, 2]`` (graph b's members at rows ``b * n_p ...``): one
    call, one stream of members, for a detector that takes a stacked slab
    (``supports_stack``); the host C++ detectors (CNM, Infomap) loop over
    members anyway and run once per graph."""
    if getattr(detect, "supports_stack", False):
        return detect(stacked, keys, init_labels)
    n_graphs = stacked.batch[0]
    n_p = keys.shape[0] // n_graphs
    return torch.cat([
        detect(unstack_slab(stacked, b), keys[b * n_p:(b + 1) * n_p],
               None if init_labels is None
               else init_labels[b * n_p:(b + 1) * n_p])
        for b in range(n_graphs)], dim=0)


def consensus_batch_round(slabs: List[GraphSlab], keys: List[torch.Tensor],
                          detect: Detector, n_p: int, tau: float,
                          delta: float, n_closure: int,
                          init_labels: Optional[List[torch.Tensor]],
                          align: List[bool],
                          prev_labels: List[torch.Tensor],
                          closure_tau: Optional[float] = None,
                          sampler: str = "csr"
                          ) -> List[Tuple[GraphSlab, torch.Tensor,
                                          RoundStats]]:
    """One round of B same-bucket graphs: graph b's
    :func:`consensus_round` with round key ``keys[b]``, init
    ``init_labels[b]`` (None: no init for any) and ``align[b]``, its
    members all detected in one stream (:func:`detect_stacked`) and the
    tail run per graph.  Each graph's result is its solo round's."""
    derived = [round_keys(k, n_p, a) for k, a in zip(keys, align)]
    labels = detect_stacked(
        detect, stack_slabs(slabs), torch.cat([d for d, _ in derived], dim=0),
        None if init_labels is None else torch.cat(init_labels, dim=0))
    out = []
    for b, (slab, (_, k_closure)) in enumerate(zip(slabs, derived)):
        lab = labels[b * n_p:(b + 1) * n_p]
        slab, stats = consensus_tail(slab, lab, k_closure, n_p, tau, delta,
                                     n_closure, closure_tau=closure_tau,
                                     prev_labels=prev_labels[b],
                                     sampler=sampler)
        out.append((slab, lab, stats))
    return out


def stats_to_host(stats: List[RoundStats]) -> List[RoundStats]:
    """Every field of every round's stats in one device-to-host copy, as
    numpy (float64 holds each int and float32 field exactly)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64)
                      for st in stats for t in st]).cpu().numpy()
    out, at = [], 0
    for st in stats:
        fields = []
        for t in st:
            n = t.numel()
            fields.append(flat[at:at + n].reshape(t.shape))
            at += n
        out.append(RoundStats(*fields))
    return out


def _detect_chunked(detect: Detector, slab: GraphSlab, keys: torch.Tensor,
                    members: int, cache_dir: Optional[str] = None,
                    cache_tag: str = "",
                    init_labels: Optional[torch.Tensor] = None,
                    ensemble_sharding: Optional[Mesh] = None
                    ) -> torch.Tensor:
    """Run detection as ``ceil(n_p / members)`` separate calls of
    ``members`` keys each (the reference's split dispatch), every chunk
    synchronized and, with ``cache_dir``, persisted as it finishes.

    Each finished chunk's labels go to ``{cache_dir}/{cache_tag}_c{i}.npy``
    (int32 ``[members, n_nodes]``, written to ``.tmp`` and renamed), and a
    restarted run loads finished chunks instead of detecting them again.
    Results are identical either way: chunk keys are position-derived and
    the detectors are per-key independent.  The keys are padded to whole
    chunks by repeating the last key (and ``init_labels`` row), as the
    reference pads them, so the files match the reference's.  Inside a
    chunk the detector still chunks its members by memory
    (``models/base.ensemble``).  ``members >= n_p`` is one call, with no
    barrier and no cache.

    ``ensemble_sharding`` (a ``parallel.Mesh``): every call splits its
    keys (a multiple of the ensemble axis) over "p", each block detected
    on its shard's device against a replicated slab (gathered once, for
    every chunk); the labels come back as per-shard blocks."""
    n_p = keys.shape[0]
    tracer = get_tracer()
    obs_reg = obs_counters.get_registry()
    mesh = ensemble_sharding
    if mesh is not None:
        reps = replicate_slab(slab, mesh)
        slab = reps[0]

    def call(ks, init):
        if mesh is None:
            return detect(slab, ks, init)
        ib = [None] * len(reps) if init is None else shard_labels(init, mesh)
        return [detect(rep, kb, None if i is None else i.to(rep.device))
                for rep, kb, i in zip(reps, shard_keys(ks, mesh), ib)]

    if members >= n_p:
        with tracer.span("detect_dispatch", members=n_p):
            return call(keys, init_labels)
    if mesh is not None and init_labels is not None:
        init_labels = gather_labels(init_labels)
    n_calls = -(-n_p // members)
    pad = n_calls * members - n_p
    if pad:
        idx = torch.cat([torch.arange(n_p, device=keys.device),
                         torch.full((pad,), n_p - 1, device=keys.device)])
        keys = keys[idx]
        if init_labels is not None:
            init_labels = init_labels[idx.to(init_labels.device)]
    dev = slab.device
    parts = []
    for i in range(n_calls):
        path = None
        if cache_dir:
            path = os.path.join(cache_dir, f"{cache_tag}_c{i}.npy")
            if os.path.exists(path):
                cached = np.load(path)
                if cached.shape != (members, slab.n_nodes) or \
                        cached.dtype != np.int32:
                    raise ValueError(
                        f"stale detect-chunk cache {path}: shape "
                        f"{cached.shape} dtype {cached.dtype}, expected "
                        f"{(members, slab.n_nodes)} int32; clean the "
                        f"cache dir")
                parts.append(torch.as_tensor(cached.astype(np.int64),
                                             device=dev))
                obs_reg.inc("detect.chunks_cached")
                _logger.debug("detect call %d/%d: loaded from %s", i + 1,
                              n_calls, path)
                continue
        t0 = time.perf_counter()
        sl = slice(i * members, (i + 1) * members)
        with tracer.span("detect_chunk", chunk=i, members=members,
                         tag=cache_tag):
            out = call(keys[sl],
                       None if init_labels is None else init_labels[sl])
            # the per-chunk barrier: each chunk's time is its own, and a
            # chunk is durable only once it is done
            for block in ([out] if mesh is None else out):
                if block.is_cuda:
                    torch.cuda.synchronize(block.device)
            out = gather_labels(out).to(dev)
        obs_counters.host_sync("detect_chunk")
        dt = time.perf_counter() - t0
        obs_reg.inc("detect.chunks")
        obs_reg.observe("detect.call_s", dt)
        _logger.debug("detect call %d/%d (%d members): %.1fs", i + 1,
                      n_calls, members, dt)
        if path is not None:
            tmp = path + ".tmp"
            with open(tmp, "wb") as fh:  # np.save would append .npy to tmp
                np.save(fh, out.cpu().numpy().astype(np.int32))
            os.replace(tmp, path)
        parts.append(out)
    labels = torch.cat(parts, dim=0)[:n_p]
    return labels if mesh is None else shard_labels(labels, mesh)
