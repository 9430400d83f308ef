"""fcserve job model: specs, states, priorities, content addressing.

Counterpart of ``fastconsensus_tpu/serve/jobs.py``.  The content hash is
the reference's byte for byte: both packages' ``ConsensusConfig`` give
the same ``dataclasses.astuple``, so one request hashes the same in
either, and a result cache one package spills answers the other's
requests.

A job is one consensus request — a graph plus a :class:`ConsensusConfig`
— flowing through the service's queue (serve/queue.py) into the worker
loop (serve/server.py).  Two identity notions coexist deliberately:

* the **job id** (``Job.job_id``) names one *submission* — every submit
  gets a fresh one, it is what ``/status`` and ``/result`` key on;
* the **content hash** (:func:`content_hash`) names the *work*: a
  deterministic SHA-256 over the canonicalized graph bytes and every
  result-relevant config field.  It is the key of the result cache
  (serve/cache.py), so resubmitting the same graph+config — regardless
  of edge order, duplicate edges, or which client sent it — is answered
  without touching the device.

Canonicalization mirrors ``graph.pack_edges`` (canonical ``src < dst``
orientation, self-loops dropped, duplicates merged keeping the first
weight) and then *sorts by edge key*, so the hash is invariant to input
edge order — the property that makes it content addressing rather than
payload addressing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from fastconsensus_tpu_torch.consensus import ConsensusConfig

# Smaller pops first (serve/queue.py is a min-heap on priority).
PRIORITY_INTERACTIVE = 0
PRIORITY_NORMAL = 1
PRIORITY_BATCH = 2
PRIORITY_NAMES = {
    "interactive": PRIORITY_INTERACTIVE,
    "normal": PRIORITY_NORMAL,
    "batch": PRIORITY_BATCH,
}

# SLO classes (fclat): per-class end-to-end latency targets in
# milliseconds.  A job's class defaults from its priority name and can
# be overridden per request (``slo`` / ``slo_target_ms`` in the submit
# body).  Attainment is *observed* — counted into ``serve.slo.*`` when
# the job finishes — and since fcshape (serve/shaping.py) the target
# also SHAPES scheduling: it sets the job's absolute deadline
# (``Job.deadline_mono``), which orders the admission heap (EDF within
# a priority), bounds the hold-for-coalesce window, and drives
# deadline-aware shedding at submit.  The counters remain the ground
# truth the shaper is judged against.
SLO_CLASSES = {
    "interactive": 1_000.0,
    "normal": 10_000.0,
    "batch": 120_000.0,
    # fcdelta: incremental re-consensus of a cached parent — a short
    # frontier-restricted warm-start run, so its latency floor is a
    # fraction of a full run's and shaping/EDF/shed must treat it to a
    # tighter promise than "normal".  Delta submissions default here;
    # it is a legal explicit class for any request.
    "delta": 2_000.0,
}

# The per-job phase timeline (fclat): each phase closes at the named
# monotonic stamp, in this order, starting from the admit stamp —
# phases are CONSECUTIVE DIFFERENCES of one monotonic clock, so the
# per-job phase sum equals the end-to-end latency by construction
# (the /metricsz consistency pin in tests/test_latency.py).  A missing
# stamp (e.g. a cache hit never packs) folds its interval into the next
# present phase.  The trailing "respond" phase closes at the finished
# stamp and is computed in Job.timing().  Every pop path stamps
# "hold_start" (Job.stamp_hold) alongside "dispatched", so for a job
# the shaper never held the hold phase reads exactly 0 and queue_wait
# keeps its pre-shaping meaning; only a job that never pops at all (a
# submit-time cache hit) lacks both, folding its whole life into
# "respond" as before.
PHASE_STAMPS: Tuple[Tuple[str, str], ...] = (
    ("queue_wait", "hold_start"),    # admission heap -> hold/pop point
    ("hold", "dispatched"),          # hold-for-coalesce window -> pop
    ("dispatch", "enqueued"),        # routing -> a worker's deque
    ("deque_wait", "dequeued"),      # parked in the deque -> worker
    ("pack", "packed"),              # canonicalize + pad to the bucket
    ("device", "device_done"),       # the consensus device call(s)
    ("fanout", "fanned_out"),        # slice/recompact/cache-fill
)
PHASE_NAMES: Tuple[str, ...] = tuple(
    [p for p, _ in PHASE_STAMPS] + ["respond"])

# Job lifecycle.  There is deliberately no "rejected" state: admission
# control (queue full, graph too large, draining) refuses the submission
# before a Job exists — backpressure is an error the client sees, never
# unbounded queue growth (serve/queue.py module notes).
STATE_QUEUED = "queued"
STATE_RUNNING = "running"
STATE_DONE = "done"
STATE_FAILED = "failed"
STATES = (STATE_QUEUED, STATE_RUNNING, STATE_DONE, STATE_FAILED)

_HASH_VERSION = b"fcserve-v1"
_job_seq = itertools.count(1)


def canonical_edges(edges: np.ndarray, n_nodes: int,
                    weights: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray,
                               Optional[np.ndarray]]:
    """Canonical ``(u, v, w)`` in ascending edge-key order.

    Same dedup semantics as ``graph.pack_edges`` (src < dst, self-loops
    dropped, first weight wins on duplicates), then sorted by
    ``u * n_nodes + v`` so the result — and therefore the content hash —
    does not depend on input edge order.
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


def content_hash(edges: np.ndarray, n_nodes: int,
                 config: ConsensusConfig,
                 weights: Optional[np.ndarray] = None) -> str:
    """Deterministic SHA-256 of (canonical graph bytes, config)."""
    return hash_canonical(canonical_edges(edges, n_nodes, weights),
                          n_nodes, config)


def hash_canonical(canonical: Tuple[np.ndarray, np.ndarray,
                                    Optional[np.ndarray]],
                   n_nodes: int, config: ConsensusConfig) -> str:
    """:func:`content_hash` over an already-canonicalized ``(u, v, w)``
    (JobSpec memoizes the canonicalization — at the serving limit of
    millions of edges the sort/dedupe pass is worth doing once, not
    once for the hash and again for the bucket pack)."""
    u, v, w = canonical
    h = hashlib.sha256()
    h.update(_HASH_VERSION)
    h.update(int(n_nodes).to_bytes(8, "little"))
    h.update(np.ascontiguousarray(u, dtype="<i8").tobytes())
    h.update(np.ascontiguousarray(v, dtype="<i8").tobytes())
    if w is not None and not np.all(w == 1.0):
        h.update(np.ascontiguousarray(w, dtype="<f4").tobytes())
    # every ConsensusConfig field is result-relevant (the checkpoint
    # fingerprints in consensus.py guard the same set); astuple keeps
    # this in lockstep with future config fields automatically
    h.update(repr(dataclasses.astuple(config)).encode())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One consensus request: compact 0-based edges + run config."""

    edges: np.ndarray            # int64[E, 2], compact 0-based ids
    n_nodes: int
    config: ConsensusConfig
    weights: Optional[np.ndarray] = None
    priority: int = PRIORITY_NORMAL
    # SLO class (fclat): None derives the class from the priority name.
    # Deliberately OUTSIDE the content hash (hash_canonical hashes the
    # config only): the SLO changes what we *promise* about a result,
    # never the result — distinct SLOs must share one cache entry.
    slo: Optional[str] = None
    slo_target_ms: Optional[float] = None
    # fctrace id (router-minted, X-FCTPU-Trace).  Like the SLO it is
    # OUTSIDE the content hash: a trace identifies one *submission*,
    # never the result — two traced requests for the same graph must
    # share one cache entry, and a cache hit still carries the hitting
    # request's own trace through its flight events.
    trace: Optional[str] = None
    # fcdelta provenance (serve/delta.py describe_payload dict: parent
    # hash, mode, reason, delta_frac, counts) — per-SUBMISSION metadata
    # outside the content hash, stamped on the 202/`/status`/`/result`.
    delta: Optional[Dict[str, Any]] = None
    # fcdelta warm-start plumbing (incremental mode only, real-node
    # sized; the worker pads both to the bucket): the parent's
    # partitions as init labels and the changed-edge neighborhood as
    # the move mask.  Outside the hash like every per-submission field.
    warm_labels: Optional[np.ndarray] = None   # int32 [n_p, n_nodes]
    warm_active: Optional[np.ndarray] = None   # bool [n_nodes]

    def slo_class(self) -> str:
        """The job's SLO class name (``SLO_CLASSES``)."""
        if self.slo is not None:
            return self.slo
        for name, prio in PRIORITY_NAMES.items():
            if prio == self.priority:
                return name
        return "normal"

    def slo_target(self) -> float:
        """End-to-end target in milliseconds (explicit override, else
        the class default)."""
        if self.slo_target_ms is not None:
            return float(self.slo_target_ms)
        return SLO_CLASSES.get(self.slo_class(),
                               SLO_CLASSES["normal"])

    def n_edges_raw(self) -> int:
        """Raw (pre-dedupe) edge count — the cheap admission bound."""
        return int(np.asarray(self.edges).reshape(-1, 2).shape[0])

    def canonical(self) -> Tuple[np.ndarray, np.ndarray,
                                 Optional[np.ndarray]]:
        """Memoized :func:`canonical_edges` of this spec — hashing (at
        submit) and bucket packing (in the worker) share ONE O(E log E)
        canonicalization pass."""
        cached = getattr(self, "_canonical", None)
        if cached is None:
            cached = canonical_edges(self.edges, self.n_nodes,
                                     self.weights)
            object.__setattr__(self, "_canonical", cached)
        return cached

    def content_hash(self) -> str:
        return hash_canonical(self.canonical(), self.n_nodes,
                              self.config)

    def bucket(self):
        """Memoized shape bucket (serve/bucketer.py) — the routing key
        of the multi-device scheduler (serve/scheduler.py): the pool
        dispatcher classifies every popped job by bucket, and a fresh
        O(E log E) canonicalization under the dispatch path would stall
        every worker behind one big graph.  ``canonical()`` is already
        memoized; this adds the grid lookup on top."""
        cached = getattr(self, "_bucket", None)
        if cached is None:
            from fastconsensus_tpu_torch.serve import bucketer

            u, _, _ = self.canonical()
            cached = bucketer.bucket_for(self.n_nodes,
                                         max(int(u.shape[0]), 1))
            object.__setattr__(self, "_bucket", cached)
        return cached

    def batch_group(self) -> str:
        """Coalescing key for cross-request batching (serve/queue.py
        ``pop_batch``): two jobs may share one batched device call iff they
        land in the same shape bucket AND run the same config in every field
        but the seed. The seed is excluded deliberately — it reaches the engine
        as a per-job PRNG key (never per-batch), so distinct seeds share one
        batch and results stay bit-identical to solo runs (run_consensus_batch
        contract).
        Memoized: pop_batch evaluates it under the queue lock.
        """
        cached = getattr(self, "_batch_group", None)
        if cached is None:
            cfg = dataclasses.replace(self.config, seed=0)
            cached = f"{self.bucket().key()}|" \
                     f"{repr(dataclasses.astuple(cfg))}"
            if self.warm_labels is not None:
                # fcdelta incremental jobs run SOLO: the batched engine
                # path carries no per-member init-labels/active-mask,
                # and coalescing a warm-start job into a cold batch
                # would silently drop its warm start.  A unique group
                # key guarantees pop_batch never rides it along.
                cached += f"|delta-solo:{id(self)}"
            object.__setattr__(self, "_batch_group", cached)
        return cached


class Job:
    """One submission's mutable lifecycle record.

    Field writes are guarded by the per-job lock; the service mutates
    only through :meth:`mark` so HTTP handler threads always read a
    consistent (state, result/error) pair via :meth:`describe`.
    """

    def __init__(self, spec: JobSpec, key: Optional[str] = None) -> None:
        self.spec = spec
        self.key = key if key is not None else spec.content_hash()
        self.job_id = f"j{next(_job_seq):06d}-{self.key[:10]}"
        self.state = STATE_QUEUED
        # Wall stamps are DISPLAY ONLY (operators correlate them with
        # logs); every duration derives from the monotonic stamps below
        # — wall-clock differences skew (or go negative) under NTP
        # steps, which is exactly when a latency dashboard matters most.
        self.submitted_at = time.time()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        # fclat phase timeline: monotonic checkpoints, written through
        # stamp() as the job crosses each serving stage (PHASE_STAMPS).
        self._mono: Dict[str, float] = {"admit": time.monotonic()}
        # fcshape EDF deadline: the absolute monotonic instant this
        # job's SLO expires.  The admission heap orders on it within a
        # priority (serve/queue.py) and the hold-for-coalesce window is
        # bounded by the tightest one queued (serve/shaping.py).
        self.deadline_mono: float = \
            self._mono["admit"] + spec.slo_target() / 1000.0
        self.error: Optional[str] = None
        self.result: Optional[Dict[str, Any]] = None
        # Cross-request batching metadata (serve/server.py): set when
        # the worker coalesces this job into a batched device call.
        # batch_size stays 1 for solo execution.
        self.batch_id: Optional[str] = None
        self.batch_size: int = 1
        # Multi-device metadata (serve/pool.py): the worker/device tag
        # that ran (or is running) the job, and the devices this job may
        # no longer be routed to — a worker that dies mid-batch requeues
        # its jobs with itself excluded, so a job that KILLS workers
        # burns through the pool at most once per device and then fails
        # as itself instead of looping forever.
        self.device: Optional[int] = None
        self.requeues: int = 0
        self._excluded: frozenset = frozenset()
        self._lock = threading.Lock()

    def set_batch(self, batch_id: str, batch_size: int) -> None:
        with self._lock:
            self.batch_id = batch_id
            self.batch_size = int(batch_size)

    def set_device(self, device: int) -> None:
        with self._lock:
            self.device = int(device)

    def exclude_device(self, device: int) -> None:
        with self._lock:
            self._excluded = self._excluded | {int(device)}
            self.requeues += 1

    def excluded(self) -> frozenset:
        with self._lock:
            return self._excluded

    def stamp(self, name: str, at: Optional[float] = None) -> None:
        """Record one monotonic phase checkpoint (PHASE_STAMPS names).
        Re-stamping (a requeued job re-crosses the pipeline) keeps the
        LATEST time — the timeline then attributes the whole retry to
        the phases it actually re-ran.  ``at`` lets the queue stamp a
        whole coalesced pop with ONE instant (and a non-holding pop
        stamp ``hold_start``/``dispatched`` identically, so the hold
        phase reads exactly 0, not clock-read jitter)."""
        with self._lock:
            self._mono[name] = time.monotonic() if at is None \
                else float(at)

    def stamp_hold(self, t_begin: float) -> None:
        """Record where this job's hold-for-coalesce window began
        (closes the ``queue_wait`` phase; ``dispatched`` then closes
        ``hold``).  A hold episode starts once per pop but covers every
        group member, so ``t_begin`` is clamped into
        ``[admit, now]`` — a ride-along admitted mid-hold attributes
        only ITS share of the window, and a non-holding pop passes the
        pop instant so hold reads exactly 0."""
        with self._lock:
            now = time.monotonic()
            self._mono["hold_start"] = \
                min(max(float(t_begin), self._mono["admit"]), now)

    def mark(self, state: str, result: Optional[Dict[str, Any]] = None,
             error: Optional[str] = None) -> None:
        assert state in STATES, state
        with self._lock:
            self.state = state
            if state == STATE_RUNNING:
                self.started_at = time.time()
                self._mono["started"] = time.monotonic()
            if state in (STATE_DONE, STATE_FAILED):
                self.finished_at = time.time()
                self._mono["finished"] = time.monotonic()
            if result is not None:
                self.result = result
            if error is not None:
                self.error = error

    def phase_seconds(self) -> Optional[Tuple[Dict[str, float], float]]:
        """``(phases, e2e)`` in exact (unrounded) monotonic seconds for
        a finished job, or None before it finishes.  Phases are the
        consecutive differences of the recorded stamps walked in
        PHASE_STAMPS order, closed by ``respond`` (last stamp ->
        finished), so ``sum(phases.values()) == e2e`` up to float
        addition — the attribution always accounts for the whole
        lifetime, never double-counts, never leaks an interval.
        """
        with self._lock:
            mono = dict(self._mono)
        end = mono.get("finished")
        if end is None:
            return None
        admit = mono["admit"]
        phases: Dict[str, float] = {}
        prev = admit
        for phase, stamp_name in PHASE_STAMPS:
            t = mono.get(stamp_name)
            if t is None:
                continue
            phases[phase] = max(t - prev, 0.0)
            prev = min(max(t, prev), end)
        phases["respond"] = max(end - prev, 0.0)
        return phases, max(end - admit, 0.0)

    def phases_so_far(self) -> Dict[str, float]:
        """Phase attribution in seconds that works MID-FLIGHT — the
        fcflight in-flight jobs table (obs/postmortem.py bundles).

        Same fold semantics as :meth:`phase_seconds` over the stamps
        recorded so far, plus one OPEN interval from the last recorded
        stamp to now, named for the phase the job is currently *in* (the
        phase the next missing stamp would close) — so a job wedged in
        the device call shows ``device: 312.4``, a heap-parked job shows
        a growing ``queue_wait``, and a finished job matches
        :meth:`phase_seconds` exactly.
        """
        with self._lock:
            mono = dict(self._mono)
        end = mono.get("finished", time.monotonic())
        admit = mono["admit"]
        phases: Dict[str, float] = {}
        prev = admit
        last_i = -1
        for i, (phase, stamp_name) in enumerate(PHASE_STAMPS):
            t = mono.get(stamp_name)
            if t is None:
                continue
            phases[phase] = max(t - prev, 0.0)
            prev = min(max(t, prev), end)
            last_i = i
        if "finished" in mono or last_i == len(PHASE_STAMPS) - 1:
            open_name = "respond"
        else:
            open_name = PHASE_STAMPS[last_i + 1][0]
        phases[open_name] = phases.get(open_name, 0.0) \
            + max(end - prev, 0.0)
        return phases

    def timing(self) -> Optional[Dict[str, Any]]:
        """JSON-ready server-side timing block for ``/status`` and
        ``/result`` (milliseconds, monotonic-derived): the per-phase
        breakdown, the end-to-end latency, and the job's SLO verdict."""
        ph = self.phase_seconds()
        if ph is None:
            return None
        phases, e2e = ph
        e2e_ms = e2e * 1000.0
        target = self.spec.slo_target()
        return {
            "e2e_ms": round(e2e_ms, 3),
            "phases_ms": {k: round(v * 1000.0, 3)
                          for k, v in phases.items()},
            "phase_sum_ms": round(sum(phases.values()) * 1000.0, 3),
            "slo": self.spec.slo_class(),
            "slo_target_ms": target,
            "slo_met": bool(e2e_ms <= target),
        }

    def describe(self) -> Dict[str, Any]:
        """JSON-ready status summary (no result payload — that is
        ``/result``'s job; keeps ``/status`` polls cheap).  Wall stamps
        are for log correlation only; the ``timing`` block (present once
        the job finishes) carries the monotonic-derived durations."""
        timing = self.timing()   # takes the lock itself; compute first
        with self._lock:
            # fcqual: the quality block is content-derived and rides the
            # result payload (see server._finish_result) — surfacing it
            # here keeps /status self-contained once the job is done,
            # and it is small (scalars + per-round lists bounded by
            # max_rounds), unlike the partitions we deliberately omit.
            quality = (self.result or {}).get("quality") \
                if self.state == STATE_DONE else None
            return {
                "job_id": self.job_id,
                "state": self.state,
                "priority": self.spec.priority,
                "slo": self.spec.slo_class(),
                "slo_target_ms": self.spec.slo_target(),
                "content_hash": self.key,
                "trace": self.spec.trace,
                "n_nodes": self.spec.n_nodes,
                "algorithm": self.spec.config.algorithm,
                "submitted_at": self.submitted_at,
                "started_at": self.started_at,
                "finished_at": self.finished_at,
                "error": self.error,
                "batch_id": self.batch_id,
                "batch_size": self.batch_size,
                "device": self.device,
                "requeues": self.requeues,
                "excluded_devices": sorted(self._excluded),
                "timing": timing,
                "quality": quality,
                # fcdelta provenance: present only for delta
                # submissions (None otherwise keeps the wire shape
                # stable for every existing reader)
                "delta": self.spec.delta,
            }
