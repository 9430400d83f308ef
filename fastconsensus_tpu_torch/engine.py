"""One consensus round.

Counterpart of ``fastconsensus_tpu/engine.py``.  A round (reference
``fast_consensus.py:138-201``):

    detect (n_p members)  -> co-membership counts per edge
    -> tau-threshold -> convergence check
    -> triadic closure (skipped if converged) -> singleton repair
    -> convergence check

PyTorch runs eagerly, so the reference's jitted executables have no
counterpart here and ``lax.cond`` is a host branch.
:func:`consensus_batch_round` is one round of B same-bucket graphs: one
detection stream over all of them, the tail per graph.

:func:`_detect_chunked` is the elastic-recovery detection: the members
run in driver chunks, each persisted to a cache dir as it finishes.  On
a device mesh (``ensemble_sharding``, ``parallel/``) every chunk splits
over the mesh's ensemble axis, each block detected on its own device,
and the round's tail runs edge-locally over the sharded slab
(``ops/sharded_tail.py``).

:class:`RoundsBlock` (with :func:`consensus_rounds_block`) is the fused
solo round block: up to ``BLOCK_MAX`` rounds with one stats readback,
each round run through its capture-safe variants (``ops/capture.py``)
and, on the card, replayed from one captured CUDA graph.
:class:`BatchBlock` (with :func:`consensus_batch_block`, the reference's
batched block) does the same for the B jobs of a batch: rounds of
:func:`consensus_batch_round` with per-job stops, one graph a batch run.
Each computes exactly what one round a host step computes.  The host
C++ detectors run in both as a :class:`HostDetect` step, on the card a
host node of the graph.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fastconsensus_tpu_torch import policy
from fastconsensus_tpu_torch.graph import (GraphSlab, agg_compaction_active,
                                           stack_slabs, unstack_slab)
from fastconsensus_tpu_torch.models.base import Detector
from fastconsensus_tpu_torch.obs import counters as obs_counters
from fastconsensus_tpu_torch.obs import quality as obs_quality
from fastconsensus_tpu_torch.obs.tracer import get_tracer
from fastconsensus_tpu_torch.ops import capture
from fastconsensus_tpu_torch.ops import consensus_ops as cops
from fastconsensus_tpu_torch.ops import row_kernels
from fastconsensus_tpu_torch.ops.sharded_tail import sharded_consensus_tail
from fastconsensus_tpu_torch.parallel.sharding import (Mesh, ShardedSlab,
                                                       gather_labels,
                                                       gather_slab,
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

    def closure(slab):
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
        return slab, n1 - n0, slab.num_alive() - n1, dropped + dropped2

    if capture.active():
        # the reference's lax.cond: closure and repair only on an
        # unconverged round, decided on the device
        outs = [slab.src.clone(), slab.dst.clone(), slab.weight.clone(),
                slab.alive.clone(), zero.clone(), zero.clone(), zero.clone()]

        def run():
            s, *ns = closure(slab)
            return [s.src, s.dst, s.weight, s.alive, *ns]

        capture.when(~st_mid.converged, run, outs)
        slab = dataclasses.replace(slab, src=outs[0], dst=outs[1],
                                   weight=outs[2], alive=outs[3])
        n_closed, n_repaired, n_dropped = outs[4:]
    elif not bool(st_mid.converged):
        slab, n_closed, n_repaired, n_dropped = closure(slab)
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
        cold=torch.zeros((), dtype=torch.bool, device=dev),
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


def _maybe_align_keys(keys: torch.Tensor, align) -> torch.Tensor:
    """Give every ensemble member member 0's key when ``align`` (a bool,
    or a bool scalar on the device: the fused block's) is true."""
    if isinstance(align, torch.Tensor):
        # fcheck: ok=key-reuse (a select between the aligned and the
        # member keys: each member draws from exactly one of them)
        return torch.where(align, keys[:1].expand_as(keys), keys)
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
    # fcheck: ok=f64-dtype (one host copy of every stats field: float64
    # holds each int32 count and float32 value exactly)
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


# ---------------------------------------------------------------------------
# The fused round block
# ---------------------------------------------------------------------------

# Rounds one block runs at most (the reference's cap on its block size).
BLOCK_MAX = 8


def _stats_like(n_p: int, device, lead=()) -> RoundStats:
    """Zeroed RoundStats of one round (``lead`` = ()) or a stack of them."""
    def z(dtype, *shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    i64, f32, b = torch.int64, torch.float32, torch.bool
    return RoundStats(
        converged=z(b), n_alive=z(i64), n_unconverged=z(i64),
        n_closure_added=z(i64), n_repaired=z(i64), n_dropped=z(i64),
        n_overflow=z(i64), n_hub_overflow=z(i64), n_agg_overflow=z(i64),
        cold=z(b), n_w_zero=z(i64), n_w_full=z(i64), n_frontier=z(i64),
        labels_changed=z(i64, n_p), member_modularity=z(f32, n_p),
        agreement=z(f32))


class _DeviceXP:
    """``policy``'s array module over scalars on the device, so that its
    rules run inside the block with no host read: numbers become fills on
    the device, never copies from the host."""

    float32 = torch.float32
    int32 = torch.int32

    def __init__(self, device):
        self.device = device

    def asarray(self, x, dtype=None):
        if isinstance(x, torch.Tensor):
            return x if dtype is None else x.to(dtype)
        if dtype is None:
            dtype = torch.bool if isinstance(x, bool) else \
                torch.int32 if isinstance(x, int) else torch.float32
        return torch.full((), x, dtype=dtype, device=self.device)

    def maximum(self, a, b):
        return torch.maximum(self.asarray(a), self.asarray(b))

    def where(self, c, a, b):
        return torch.where(c, self.asarray(a), self.asarray(b))


class HostDetect:
    """The host detectors' step of a fused block (CNM, Infomap): the
    reference's ``jax.pure_callback`` inside its jitted block.  It detects
    the ``n_jobs`` jobs of a block's static slabs ``slabs`` (views of the
    block's carry: the solo block's one slab, or the batched block's
    stacked ones, whose fields are ``fields``, each ``[n_jobs,
    capacity]``) into :attr:`labels` (int64 ``[n_jobs, n_p, N]``), job j
    where ``runs[j]`` holds, in job order, each exactly as one eager
    round's ``detect(slab_j, keys_j)``; a job whose flag is clear keeps
    its labels and draws no seed.

    On the card (:meth:`__call__` under capture) the step is the
    graph's: the fields, the keys and the flags are copied into pinned
    buffers, a host node runs ``fc_host_detect`` (``native/src/
    host_detect.cpp``) on them, and the int32 labels come back and are
    widened on the device.  All of it sits at the graph's top level, so
    the flags are the C++'s own test of a stopped block or a frozen job.
    On the CPU the step calls ``detect`` itself, job by job: the plain
    version.  :attr:`calls` counts the steps that detected a job."""

    def __init__(self, detect: Detector, slabs: List[GraphSlab], fields,
                 n_p: int, key_words: int = 2):
        from fastconsensus_tpu_torch import native

        if not all(f.is_contiguous() for f in fields):
            raise ValueError("host detection stages contiguous fields")
        self.detect, self.slabs, self.fields = detect, slabs, list(fields)
        b, cap = self.fields[0].shape
        n, dev = slabs[0].n_nodes, slabs[0].device
        self.n_p, self.device = n_p, dev
        self.labels = torch.zeros((b, n_p, n), dtype=torch.int64, device=dev)
        self._calls = self._folded = 0
        self._closed = False
        self.args = None
        if dev.type != "cuda":
            return

        self._buffers = capture.HostBuffers()
        pinned = self._buffers.empty
        self.h_fields = [pinned((b, cap), f.dtype) for f in self.fields]
        self.h_keys = pinned((b * n_p, key_words), torch.int64)
        self.h_runs = pinned((b,), torch.bool)
        self.h_labels = pinned((b, n_p, n), torch.int32)
        self.d_labels = torch.zeros((b, n_p, n), dtype=torch.int32,
                                    device=dev)
        src, dst, weight, alive = self.h_fields
        self.fn = native.host_detect_fn()
        self.args = native.HostDetectArgs(
            detector=native.HOST_DETECTORS[detect.host_fn], n_jobs=b,
            n_nodes=n, n_p=n_p, capacity=cap, key_words=key_words,
            src=src.data_ptr(), dst=dst.data_ptr(),
            weight=weight.data_ptr(), alive=alive.data_ptr(),
            keys=self.h_keys.data_ptr(), runs=self.h_runs.data_ptr(),
            labels=self.h_labels.data_ptr(), calls=0, detections=0)

    @property
    def calls(self) -> int:
        """Steps that detected at least one job (on the card: host-node
        runs that did, read after the block's readback synchronized)."""
        return self._calls if self.args is None else int(self.args.calls)

    def close(self) -> None:
        """Free the pinned buffers, once no graph uses them (after the
        block's graph is closed)."""
        if self.args is None:
            return
        torch.cuda.synchronize(self.device)
        self.h_fields = self.h_keys = self.h_runs = self.h_labels = None
        self._buffers.close()
        self._closed = True

    def fold(self) -> None:
        """After a block's readback: add the steps that detected since the
        last fold to ``engine.host_detect.calls``."""
        calls = self.calls
        obs_counters.get_registry().inc("engine.host_detect.calls",
                                        calls - self._folded)
        self._folded = calls

    def __call__(self, keys: torch.Tensor, runs: torch.Tensor) -> None:
        """Detect job j's members with ``keys[j * n_p:(j + 1) * n_p]``
        where ``runs[j]`` (bool ``[n_jobs]``) holds."""
        if self.args is None:
            # the plain version: the detector itself, job by job
            ran = False
            for j, slab in enumerate(self.slabs):
                if bool(runs[j]):
                    self.labels[j].copy_(self.detect(
                        slab, keys[j * self.n_p:(j + 1) * self.n_p]))
                    ran = True
            self._calls += int(ran)
            return
        if self._closed:
            raise RuntimeError("host detection after close()")
        for h, d in zip(self.h_fields, self.fields):
            capture.stage_to_host(h, d)
        capture.stage_to_host(self.h_keys, keys.contiguous())
        capture.stage_to_host(self.h_runs, runs)
        capture.host_node(self.fn, self.args)
        self.d_labels.copy_(self.h_labels, non_blocking=True)
        self.labels.copy_(self.d_labels)


class BlockResult(NamedTuple):
    """What one fused block hands back to ``run_consensus``."""

    slab: GraphSlab           # the slab after the ``done`` rounds
    labels: torch.Tensor      # the labels after them [n_p, N]
    done: int                 # rounds completed (and to be recorded)
    stats: List[RoundStats]   # host stats of those rounds, then, when
                              # ``grow``, of the round that dropped
    grow: bool                # a round dropped survivors under auto-grow:
                              # it is not counted and did not change state


class RoundsBlock:
    """The fused round block of one run configuration and slab sizing:
    the reference's ``consensus_rounds_block`` and its executable.  Up to
    ``BLOCK_MAX`` rounds a call, with one readback of their stats.

    Every round of the block is :func:`consensus_round` with ``detect``
    through the capture-safe variants (``ops/capture.py``), its key
    derived from ``(key, start_round + i)``.  With warm start
    (``detect`` the warm variant) each round decides its mode on the
    device from the carried ``policy.PolicyState`` (``policy.stalled`` /
    ``stale`` / ``observe`` / ``align_now``, the host loop's own
    rules), so a block computes exactly what one round a host step
    computes.  The block stops after the round that converged, after a
    round whose budgets starve where the host would re-derive them
    (``watch``: auto-grow; ``noop``: the overflow levels of the last
    re-derivation that changed nothing), before counting a round that
    dropped survivors under auto-grow (that round changes nothing;
    ``run_consensus`` grows the slab it started from and runs it again,
    as it does one round a step), and before a round that re-detects from
    singletons (the run's cold start or a stagnation refresh), which
    ``run_consensus`` runs on its own: a captured round holds one
    detector's sweeps, the warm variant's 12, not the cold one's 32
    besides.

    On the card the first :meth:`run` captures one guarded round into a
    CUDA graph and each call replays it once per round; a replay after
    the stop changes nothing (its round sits in an IF node on ``go``).
    Elsewhere the same round runs eagerly, its branches computed and
    selected.  Capacity and the static budgets are part of the captured
    shapes: ``run_consensus`` makes a new block when they change.

    A host detector (CNM, Infomap: ``host_fn``; no warm rounds) detects
    in a :class:`HostDetect` step at the guarded step's top level, on
    ``go``, before the IF node; the round inside reads its labels."""

    def __init__(self, slab: GraphSlab, detect: Detector, n_p: int,
                 tau: float, delta: float, n_closure: int, warm: bool,
                 align_frac: float = 0.0, sampler: str = "csr",
                 closure_tau: Optional[float] = None,
                 active: Optional[torch.Tensor] = None):
        dev = slab.device
        self.device = dev
        self.detect = detect
        self.n_p, self.tau, self.delta = n_p, tau, delta
        self.n_closure, self.warm = n_closure, warm
        self.align_frac, self.sampler = align_frac, sampler
        self.closure_tau = closure_tau
        n, cap = slab.n_nodes, slab.capacity

        def z(dtype, *shape):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.src, self.dst = z(torch.int64, cap), z(torch.int64, cap)
        self.weight, self.alive = z(torch.float32, cap), z(torch.bool, cap)
        self.slab = dataclasses.replace(slab, src=self.src, dst=self.dst,
                                        weight=self.weight, alive=self.alive)
        self.labels = z(torch.int64, n_p, n)
        self.active = None if active is None else active.to(dev).clone()
        self.key = z(torch.int64, 2)
        self.start_round, self.max_iters = z(torch.int64), z(torch.int64)
        self.cold_round = z(torch.int64)
        self.watch, self.noop = z(torch.bool), z(torch.int64, 3)
        self.i = z(torch.int64)
        self.conv, self.need = z(torch.bool), z(torch.bool)
        self.grow, self.stop = z(torch.bool), z(torch.bool)
        self.aligned = z(torch.bool)
        self.pst = [z(torch.int32) for _ in policy.INITIAL]
        self.buf = _stats_like(n_p, dev, (BLOCK_MAX,))
        self.tmp = _stats_like(n_p, dev)
        self.step = None
        self.host = None
        if getattr(detect, "host_fn", None):
            if warm:
                raise ValueError("a host detector's block runs no warm "
                                 "rounds")
            self.host = HostDetect(detect, [self.slab], [
                t.unsqueeze(0) for t in (self.src, self.dst, self.weight,
                                         self.alive)], n_p)
            # the round reads the labels the host step wrote
            self.detect = lambda slab, keys, init=None: self.host.labels[0]

    # -- the guarded round --------------------------------------------

    def _round(self) -> List[torch.Tensor]:
        """One round from the carry: the new carry and the round's
        stats, in the order :meth:`_step` lists them."""
        dev = self.device
        xp = _DeviceXP(dev)
        r = self.start_round + self.i
        k = prng.stream(self.key, prng.STREAM_ROUND, r)
        pst = policy.PolicyState(*self.pst)
        state = [self.src, self.dst, self.weight, self.alive, self.labels]

        def run(init=None, align=False):
            s, lab, st = consensus_round(
                self.slab, k, self.detect, self.n_p, self.tau, self.delta,
                self.n_closure, init_labels=init, align=align,
                closure_tau=self.closure_tau, prev_labels=self.labels,
                sampler=self.sampler, active=self.active)
            return [s.src, s.dst, s.weight, s.alive, lab, *st]

        if self.warm:
            # the host loop's rules for the round's mode: a round that
            # re-detects from singletons (the run's first, or a
            # stagnation refresh) ends the block before it runs, and
            # run_consensus runs it on its own
            cold = (r == self.cold_round) | \
                policy.stale(xp, self.delta, pst) | \
                policy.stalled(xp, self.delta, pst, self.aligned)
            outs = [t.clone() for t in state + list(self.tmp)]
            capture.when(~cold, lambda: run(self.labels, self.aligned),
                         outs)
            stop = cold
        else:
            outs = run()
            cold = torch.ones((), dtype=torch.bool, device=dev)
            stop = torch.zeros((), dtype=torch.bool, device=dev)
        st = RoundStats(*outs[5:])._replace(cold=cold)
        # a round that dropped survivors under auto-grow does not count
        drop = self.watch & (st.n_dropped > 0) & ~stop
        keep = ~drop & ~stop
        pst_new = policy.observe(xp, pst, cold,
                                 st.n_unconverged.to(torch.int32),
                                 st.n_alive.to(torch.int32))
        if self.warm and self.align_frac > 0:
            aligned = policy.align_now(xp, self.align_frac, pst_new)
        else:
            aligned = torch.zeros((), dtype=torch.bool, device=dev)
        s = self.slab
        need = policy.budgets_stale(
            xp, st.n_overflow, st.n_hub_overflow, s.d_cap, s.hub_cap,
            s.n_nodes, st.n_alive, s.agg_cap) & self.watch & (
            (st.n_overflow > self.noop[0]) |
            (st.n_hub_overflow > self.noop[1]) |
            (st.n_alive > self.noop[2]))
        return ([torch.where(keep, new, old)
                 for new, old in zip(outs[:5], state)] +
                [self.i + keep.to(torch.int64), keep & st.converged,
                 keep & need, drop, stop,
                 torch.where(keep, aligned, self.aligned)]
                + [torch.where(keep, v.to(torch.int32), o)
                   for v, o in zip(pst_new, self.pst)] + list(st))

    def _step(self) -> None:
        """One guarded round: runs where the block has not stopped
        (``go``), and writes the round's stats into row ``i``."""
        i0 = self.i.clone()
        go = ~self.conv & ~self.need & ~self.grow & ~self.stop & \
            (self.i < self.max_iters)
        if self.host is not None:
            # the host detection runs at the top level, on the round's
            # member keys, where the round goes
            k = prng.stream(self.key, prng.STREAM_ROUND,
                            self.start_round + self.i)
            self.host(round_keys(k, self.n_p)[0], go.reshape(1))
        carry = [self.src, self.dst, self.weight, self.alive, self.labels,
                 self.i, self.conv, self.need, self.grow, self.stop,
                 self.aligned, *self.pst]
        capture.when(go, self._round, carry + list(self.tmp))
        for b, t in zip(self.buf, self.tmp):
            b.index_copy_(0, i0.reshape(1), t.unsqueeze(0))

    # -- a block --------------------------------------------------------

    def run(self, slab: GraphSlab, key: torch.Tensor, labels0: torch.Tensor,
            start_round: int, n_rounds: int, align0: bool, pstate0,
            watch0: bool, noop0, cold_round: int) -> BlockResult:
        """Up to ``n_rounds`` (at most ``BLOCK_MAX``) rounds from ``slab``
        and ``labels0`` (the previous round's labels, or the singletons),
        with one readback.  ``cold_round`` is the run's round that starts
        from singletons (-1: none, an fcdelta or resumed run)."""
        if not 1 <= n_rounds <= BLOCK_MAX:
            raise ValueError(f"a block runs 1..{BLOCK_MAX} rounds, not "
                             f"{n_rounds}")
        for dst, src in ((self.src, slab.src), (self.dst, slab.dst),
                         (self.weight, slab.weight),
                         (self.alive, slab.alive), (self.labels, labels0),
                         (self.key, key)):
            dst.copy_(src)
        for t, v in ((self.start_round, start_round),
                     (self.max_iters, n_rounds), (self.i, 0),
                     (self.cold_round, cold_round), (self.conv, False),
                     (self.need, False), (self.grow, False),
                     (self.stop, False),
                     (self.aligned, bool(align0)), (self.watch, bool(watch0))):
            t.fill_(v)
        for t, v in zip(self.pst, pstate0):
            t.fill_(int(v))
        for j, v in enumerate(noop0):
            self.noop[j].fill_(int(v))
        on_card = self.device.type == "cuda"
        if on_card:
            if self.step is None:
                self._capture()
            for _ in range(n_rounds):
                self.step.replay()
        else:
            with capture.capture_safe():
                for _ in range(n_rounds):
                    self._step()
        # the block's one readback: rounds done, the grow flag, every
        # round's stats and (on the card) the replayed kernel launches
        parts = [self.i.reshape(1), self.grow.reshape(1),
                 *(b.reshape(-1) for b in self.buf)]
        if on_card:
            parts.append(row_kernels.device_counts(self.device))
        # fcheck: ok=f64-dtype (one host copy of every stats field: float64
        # holds each int count and float32 value exactly)
        flat = torch.cat([p.to(torch.float64) for p in parts]).cpu().numpy()
        done, grow = int(flat[0]), bool(flat[1])
        at, fields = 2, []
        for b in self.buf:
            fields.append(flat[at:at + b.numel()].reshape(b.shape))
            at += b.numel()
        if on_card:
            row_kernels.fold_device_counts(self.device, flat[at:])
        if self.host is not None:
            self.host.fold()
        rows = [RoundStats(*(f[j] for f in fields))
                for j in range(done + int(grow))]
        out = dataclasses.replace(self.slab, src=self.src.clone(),
                                  dst=self.dst.clone(),
                                  weight=self.weight.clone(),
                                  alive=self.alive.clone())
        return BlockResult(out, self.labels.clone(), done, rows, grow)

    def _capture(self) -> None:
        """Capture the guarded round (the counterpart of the reference's
        ``setup_executables`` re-jit): span- and counter-wrapped."""
        obs_reg = obs_counters.get_registry()
        t0 = time.perf_counter()
        with get_tracer().span("setup_executables"):
            self.step = capture.CapturedStep(self._step, self.device)
        obs_reg.inc("engine.setup_executables")
        obs_reg.observe("engine.setup_executables.seconds",
                        time.perf_counter() - t0)

    def close(self) -> None:
        """Free the captured graph and its pools, and the host step's
        pinned buffers."""
        if self.step is not None:
            self.step.close()
            self.step = None
        if self.host is not None:
            self.host.close()


def consensus_rounds_block(slab: GraphSlab, key: torch.Tensor,
                           labels0: torch.Tensor, start_round: int,
                           max_iters: int, align0: bool, pstate0,
                           watch0: bool, noop0, cold_round: int,
                           detect: Detector, n_p: int, tau: float,
                           delta: float, n_closure: int, block: int,
                           warm: bool, align_frac: float = 0.0,
                           sampler: str = "csr",
                           closure_tau: Optional[float] = None,
                           active: Optional[torch.Tensor] = None
                           ) -> BlockResult:
    """Up to ``min(block, max_iters)`` rounds in one block (see
    :class:`RoundsBlock`, which ``run_consensus`` keeps across blocks so
    that the card captures once per slab sizing).  ``detect`` is the
    detector of the block's rounds: the warm variant with ``warm``."""
    runner = RoundsBlock(slab, detect, n_p, tau, delta, n_closure, warm,
                         align_frac, sampler, closure_tau, active)
    try:
        return runner.run(slab, key, labels0, start_round,
                          min(block, max_iters), align0, pstate0, watch0,
                          noop0, cold_round)
    finally:
        runner.close()


class BatchBlockResult(NamedTuple):
    """What one batched block hands back to ``run_consensus_batch``, per
    job."""

    slabs: List[GraphSlab]          # each job's slab after its done rounds
    labels: List[torch.Tensor]      # each job's labels after them [n_p, N]
    done: List[int]                 # rounds each job completed
    stats: List[List[RoundStats]]   # host stats of those rounds, then,
                                    # when ``grow``, of the round that
                                    # dropped
    grow: List[bool]                # a round dropped survivors under
                                    # auto-grow (not counted, no change)


class BatchBlock:
    """The batched round block of one ``run_consensus_batch`` call: the
    reference's ``consensus_batch_block`` under ``_jitted_rounds_batch``.
    Up to ``BLOCK_MAX`` rounds of B same-bucket jobs a call, with one
    readback of every job's stats.

    One static mode: ``warm`` (each job's round from its carried labels
    with the warm variant, keys aligned by its carried flag) or
    ``scratch`` (every round from no init, a run without warm start).  A
    cold round 0 and a masked stagnation refresh run outside, as one
    eager batched round.  Job b's round ``i`` derives its key from
    ``(key_b, start_round_b + i)`` and folds its policy on the device by
    ``policy.observe``, as the solo driver does.

    A job freezes after the round that converged, at its ``max_iters``,
    after a round whose budgets starve where the host would re-derive
    them (``watch``/``noop``), and before counting a round that dropped
    survivors under auto-grow (``run_consensus_batch`` splits such a job
    off to a solo run).  Before a warm round that a job's policy would run
    cold (``policy.stale`` / ``stalled``) the block stops for every job:
    one batched round a host step runs that refresh before any other
    job's next round, so the block's rounds keep its member streams.

    A frozen job still rides the stacked detection at its static shape,
    its members started stopped (``capture.sweeping``: they add no sweep
    and keep their start labels), and keeps its labels and slab by
    ``torch.where``; the tail runs per job, each in an IF node on its
    job's ``run``, and the whole round in one IF node on "any job runs".
    So a block launches exactly what one batched round a host step
    launches.

    The block object lives for a whole batch run: B and the bucket's
    statics never change under it (a job whose statics would change is
    split off), so the card captures once a run and replays the one
    graph for every block.  Elsewhere the same round runs eagerly, its
    branches computed and selected.

    A host detector (CNM, Infomap) detects in one :class:`HostDetect`
    step a round, at the step's top level: every job that runs, in job
    order (the reference's ``vmap_method="sequential"`` callback); a
    frozen job's labels stay as they were and are not used."""

    def __init__(self, slab: GraphSlab, n_jobs: int, detect: Detector,
                 n_p: int, tau: float, delta: float, n_closure: int,
                 warm: bool, align_frac: float = 0.0, sampler: str = "csr",
                 closure_tau: Optional[float] = None):
        dev = slab.device
        self.device = dev
        self.n_jobs = n_jobs
        self.detect = detect
        self.n_p, self.tau, self.delta = n_p, tau, delta
        self.n_closure, self.warm = n_closure, warm
        self.align_frac, self.sampler = align_frac, sampler
        self.closure_tau = closure_tau
        n, cap, b = slab.n_nodes, slab.capacity, n_jobs

        def z(dtype, *shape):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.stacked = dataclasses.replace(
            slab, src=z(torch.int64, b, cap), dst=z(torch.int64, b, cap),
            weight=z(torch.float32, b, cap), alive=z(torch.bool, b, cap))
        self.slabs = [unstack_slab(self.stacked, j) for j in range(b)]
        self.labels = z(torch.int64, b, n_p, n)
        self.keys = z(torch.int64, b, 2)
        self.start_round, self.max_iters = z(torch.int64, b), \
            z(torch.int64, b)
        self.i = z(torch.int64, b)
        self.watch, self.noop = z(torch.bool, b), z(torch.int64, b, 3)
        self.conv, self.need = z(torch.bool, b), z(torch.bool, b)
        self.grow, self.stop = z(torch.bool, b), z(torch.bool, b)
        self.aligned = z(torch.bool, b)
        self.pst = [z(torch.int32, b) for _ in policy.INITIAL]
        self.buf = _stats_like(n_p, dev, (BLOCK_MAX, b))
        self.tmp = _stats_like(n_p, dev, (b,))
        self.step = None
        self.host = None
        if getattr(detect, "host_fn", None):
            if warm:
                raise ValueError("a host detector's block runs no warm "
                                 "rounds")
            s = self.stacked
            self.host = HostDetect(detect, self.slabs,
                                   [s.src, s.dst, s.weight, s.alive], n_p)

    # -- the guarded round --------------------------------------------

    def _state(self) -> List[torch.Tensor]:
        s = self.stacked
        return [s.src, s.dst, s.weight, s.alive, self.labels]

    def _round_keys(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each job's member keys and closure key of the round at ``i``."""
        k = prng.stream(self.keys, prng.STREAM_ROUND,
                        self.start_round + self.i)
        return [round_keys(k[j], self.n_p, self.aligned[j] if self.warm
                           else False) for j in range(self.n_jobs)]

    def _round(self, run: torch.Tensor) -> List[torch.Tensor]:
        """One round of the jobs ``run`` (bool[B]) from the carry: the new
        carry and the round's stats, in the order :meth:`_step` lists
        them."""
        dev, b, n_p = self.device, self.n_jobs, self.n_p
        n = self.stacked.n_nodes
        xp = _DeviceXP(dev)
        derived = self._round_keys()
        if self.host is not None:
            lab = self.host.labels     # the host step's, at the top level
        else:
            with capture.sweeping(run.repeat_interleave(n_p)):
                lab = detect_stacked(
                    self.detect, self.stacked,
                    torch.cat([d for d, _ in derived], dim=0),
                    self.labels.reshape(b * n_p, n) if self.warm else None
                ).view(b, n_p, n)
        state = self._state()
        new = [t.clone() for t in state[:4]]
        tmp = [t.clone() for t in self.tmp]
        for j, (_, k_closure) in enumerate(derived):
            def tail(j=j, k_closure=k_closure):
                s, st = consensus_tail(
                    self.slabs[j], lab[j], k_closure, n_p, self.tau,
                    self.delta, self.n_closure,
                    closure_tau=self.closure_tau, prev_labels=self.labels[j],
                    sampler=self.sampler)
                return [s.src, s.dst, s.weight, s.alive, *st]

            capture.when(run[j], tail, [t[j] for t in new + tmp])
        cold = torch.full((b,), not self.warm, dtype=torch.bool, device=dev)
        st = RoundStats(*tmp)._replace(cold=cold)
        # a round that dropped survivors under auto-grow does not count
        drop = self.watch & (st.n_dropped > 0) & run
        keep = run & ~drop
        pst_new = policy.observe(xp, policy.PolicyState(*self.pst), cold,
                                 st.n_unconverged.to(torch.int32),
                                 st.n_alive.to(torch.int32))
        if self.warm and self.align_frac > 0:
            aligned = policy.align_now(xp, self.align_frac, pst_new)
        else:
            aligned = torch.zeros((b,), dtype=torch.bool, device=dev)
        s = self.stacked
        need = policy.budgets_stale(
            xp, st.n_overflow, st.n_hub_overflow, s.d_cap, s.hub_cap,
            s.n_nodes, st.n_alive, s.agg_cap) & self.watch & (
            (st.n_overflow > self.noop[:, 0]) |
            (st.n_hub_overflow > self.noop[:, 1]) |
            (st.n_alive > self.noop[:, 2]))
        return ([torch.where(keep[:, None], a, o)
                 for a, o in zip(new, state[:4])] +
                [torch.where(keep[:, None, None], lab, self.labels),
                 self.i + keep.to(torch.int64),
                 torch.where(run, keep & st.converged, self.conv),
                 torch.where(run, keep & need, self.need),
                 torch.where(run, drop, self.grow),
                 torch.where(keep, aligned, self.aligned)]
                + [torch.where(keep, v.to(torch.int32), o)
                   for v, o in zip(pst_new, self.pst)] + list(st))

    def _step(self) -> None:
        """One guarded round of every job still going, its stats written
        into each job's row ``i``."""
        b = self.n_jobs
        i0 = self.i.clone()
        go = ~self.conv & ~self.need & ~self.grow & ~self.stop & \
            (self.i < self.max_iters)
        if self.warm:
            xp = _DeviceXP(self.device)
            pst = policy.PolicyState(*self.pst)
            cold = policy.stale(xp, self.delta, pst) | \
                policy.stalled(xp, self.delta, pst, self.aligned)
            halt = (go & cold).any()
            self.stop.copy_(self.stop | halt)
            run = go & ~halt
        else:
            run = go
        if self.host is not None:
            # the host detection of the jobs that run, at the top level
            self.host(torch.cat([d for d, _ in self._round_keys()]), run)
        carry = self._state() + [self.i, self.conv, self.need, self.grow,
                                 self.aligned, *self.pst]
        capture.when(run.any(), lambda: self._round(run),
                     carry + list(self.tmp))
        at = i0 * b + torch.arange(b, device=self.device)
        for buf, t in zip(self.buf, self.tmp):
            buf.view((BLOCK_MAX * b,) + buf.shape[2:]).index_copy_(0, at, t)

    # -- a block --------------------------------------------------------

    def run(self, slabs: List[GraphSlab], keys: List[torch.Tensor],
            labels0: List[torch.Tensor], start_rounds, max_iters, align0,
            pstates0, watch0, noops0) -> BatchBlockResult:
        """Up to ``max(max_iters)`` (at most ``BLOCK_MAX``) rounds of the
        B jobs, job b from ``slabs[b]`` and ``labels0[b]`` (its previous
        round's labels) for ``max_iters[b]`` rounds (0: frozen), with one
        readback."""
        n_steps = self.load(slabs, keys, labels0, start_rounds, max_iters,
                            align0, pstates0, watch0, noops0)
        on_card = self.device.type == "cuda"
        if on_card:
            if self.step is None:
                self._capture()
            for _ in range(n_steps):
                self.step.replay()
        else:
            with capture.capture_safe():
                for _ in range(n_steps):
                    self._step()
        return self._readback()

    def load(self, slabs: List[GraphSlab], keys: List[torch.Tensor],
             labels0: List[torch.Tensor], start_rounds, max_iters, align0,
             pstates0, watch0, noops0) -> int:
        """Write a block's inputs into the static buffers: the number of
        steps it runs."""
        b = self.n_jobs
        n_steps = max(int(m) for m in max_iters)
        if not 1 <= n_steps <= BLOCK_MAX:
            raise ValueError(f"a block runs 1..{BLOCK_MAX} rounds, not "
                             f"{n_steps}")
        stack_slabs(slabs, out=self.stacked)
        torch.stack([t.to(self.device) for t in labels0], out=self.labels)
        torch.stack([t.to(self.device) for t in keys], out=self.keys)
        # every job's scalars in one copy to the device
        ints = np.zeros((b, 16), np.int64)
        ints[:, 0] = start_rounds
        ints[:, 1] = max_iters
        ints[:, 2] = align0
        ints[:, 3] = watch0
        ints[:, 4:7] = noops0
        ints[:, 7:14] = [[int(v) for v in p] for p in pstates0]
        host = torch.as_tensor(ints).to(self.device)
        for j, t in enumerate((self.start_round, self.max_iters,
                               self.aligned, self.watch)):
            t.copy_(host[:, j])
        self.noop.copy_(host[:, 4:7])
        for j, t in enumerate(self.pst):
            t.copy_(host[:, 7 + j])
        for t in (self.i, self.conv, self.need, self.grow, self.stop):
            t.zero_()
        return n_steps

    def _readback(self) -> BatchBlockResult:
        b = self.n_jobs
        on_card = self.device.type == "cuda"
        # the block's one readback: each job's rounds done and grow flag,
        # every round's stats and (on the card) the replayed launches
        parts = [self.i, self.grow, *(t.reshape(-1) for t in self.buf)]
        if on_card:
            parts.append(row_kernels.device_counts(self.device))
        # fcheck: ok=f64-dtype (one host copy of every stats field: float64
        # holds each int count and float32 value exactly)
        flat = torch.cat([p.to(torch.float64) for p in parts]).cpu().numpy()
        done = [int(v) for v in flat[:b]]
        grow = [bool(v) for v in flat[b:2 * b]]
        at, fields = 2 * b, []
        for t in self.buf:
            fields.append(flat[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        if on_card:
            row_kernels.fold_device_counts(self.device, flat[at:])
        if self.host is not None:
            self.host.fold()
        stats = [[RoundStats(*(f[r, j] for f in fields))
                  for r in range(done[j] + int(grow[j]))] for j in range(b)]
        return BatchBlockResult(
            [unstack_slab(self.stacked, j, copy=True) for j in range(b)],
            [self.labels[j].clone() for j in range(b)], done, stats, grow)

    def _capture(self) -> None:
        """Capture the guarded batched round: span- and counter-wrapped,
        as :meth:`RoundsBlock._capture`."""
        obs_reg = obs_counters.get_registry()
        t0 = time.perf_counter()
        with get_tracer().span("setup_executables"):
            self.step = capture.CapturedStep(self._step, self.device)
        obs_reg.inc("engine.setup_executables")
        obs_reg.observe("engine.setup_executables.seconds",
                        time.perf_counter() - t0)

    def close(self) -> None:
        """Free the captured graph and its pools, and the host step's
        pinned buffers."""
        if self.step is not None:
            self.step.close()
            self.step = None
        if self.host is not None:
            self.host.close()


def consensus_batch_block(slabs: List[GraphSlab], keys: List[torch.Tensor],
                          labels0: List[torch.Tensor], start_rounds,
                          max_iters, align0, pstates0, watch0, noops0,
                          detect: Detector, n_p: int, tau: float,
                          delta: float, n_closure: int, warm: bool,
                          align_frac: float = 0.0, sampler: str = "csr",
                          closure_tau: Optional[float] = None
                          ) -> BatchBlockResult:
    """One batched block of the jobs ``slabs`` (see :class:`BatchBlock`,
    which ``run_consensus_batch`` keeps for the whole run so that the
    card captures once).  ``detect`` is the detector of the block's
    rounds: the warm variant with ``warm``."""
    runner = BatchBlock(slabs[0], len(slabs), detect, n_p, tau, delta,
                        n_closure, warm, align_frac, sampler, closure_tau)
    try:
        return runner.run(slabs, keys, labels0, start_rounds, max_iters,
                          align0, pstates0, watch0, noops0)
    finally:
        runner.close()


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
    every chunk); the labels come back as per-shard blocks.  On a mesh
    that spans processes each process detects its own blocks and
    gathers the slab and every finished chunk with the others."""
    n_p = keys.shape[0]
    tracer = get_tracer()
    obs_reg = obs_counters.get_registry()
    mesh = ensemble_sharding
    if mesh is not None:
        if isinstance(slab, ShardedSlab):
            slab = gather_slab(slab)
        reps = replicate_slab(slab, mesh)

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
        init_labels = gather_labels(init_labels, mesh)
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
                    # fcheck: ok=sync-in-loop (the deliberate per-chunk
                    # barrier above; one sync per chunk of members)
                    torch.cuda.synchronize(block.device)
            out = gather_labels(out, mesh).to(dev)
        obs_counters.host_sync("detect_chunk")
        dt = time.perf_counter() - t0
        obs_reg.inc("detect.chunks")
        obs_reg.observe("detect.call_s", dt)
        _logger.debug("detect call %d/%d (%d members): %.1fs", i + 1,
                      n_calls, members, dt)
        if path is not None:
            tmp = path + ".tmp"
            with open(tmp, "wb") as fh:  # np.save would append .npy to tmp
                # fcheck: ok=sync-in-loop (the cache stores each finished
                # chunk on disk; it is already synced above)
                np.save(fh, out.cpu().numpy().astype(np.int32))
            os.replace(tmp, path)
        parts.append(out)
    labels = torch.cat(parts, dim=0)[:n_p]
    return labels if mesh is None else shard_labels(labels, mesh)
