"""fcflight: the always-on flight recorder — bounded per-thread event rings.

When a serving replica wedges or a request lands at the p99, the
existing observability answers "how is the fleet doing on average"
(fcobs counters, fclat histograms, fcqual series) but not "what was
*this* process doing just now".  The tracer (obs/tracer.py) could
answer it, but it is off by default and unbounded per span — the wrong
shape for an incident recorder that must be running BEFORE the incident.

The flight recorder is the always-on complement:

* **Per-thread ring buffers.**  Each recording thread owns one ring
  (minted lazily on first ``record()`` and cached in a
  ``threading.local``), so the hot-path append takes only that ring's
  own — uncontended — lock: O(1), no cross-thread contention, no
  allocation beyond the event dict itself.  Threads past ``max_rings``
  share one overflow ring (lock-protected; correctness unchanged,
  contention only in a pathological thread storm).
* **Hard memory cap.**  A ring holds at most ``capacity`` events and
  overwrites its oldest (the overwritten count is reported as
  ``dropped``); the recorder's whole footprint is bounded by
  ``max_rings × capacity`` small dicts regardless of uptime or load.
* **Atomic snapshot.**  ``snapshot()`` copies the ring list under the
  recorder lock, then each ring's contents under that ring's lock —
  each ring is copied atomically, appends racing the snapshot land in
  the next one.  Ring and recorder locks are leaves (nothing is
  acquired while holding them), so fcheck-concurrency passes over this
  module with zero pragmas.

Event vocabulary (the serving stack's instrumentation points; the
``kind`` field is an open set, these are the core ones):

=================  ====================================================
``admit``          AdmissionQueue accepted a job
``reject_429``     queue full — backpressure returned to the client
``shed``           deadline shed at admission (fcshape)
``hold``           hold-for-coalesce episode closed over a pop
``pop``            job left the admission queue
``route``          StickyScheduler picked a worker
``dequeue``        worker thread picked a batch off its deque
``device``         device call dispatched (bucket/rung/cold tagged)
``device_done``    device call returned
``finish``         job reached DONE (e2e attached)
``fail``           job reached FAILED
``cache_hit``      admission answered from the result cache
``cordon``         a worker was cordoned (death or watchdog)
``requeue``        jobs re-admitted after a worker death/cordon
``watchdog_trip``  the hang watchdog declared a worker suspect
``bundle``         a post-mortem bundle was written
``span_open``/``span_close``  tracer spans, mirrored when tracing is on
``proxy``          router proxied a status/result poll to a replica
``rehome_replay``  router replayed an in-flight job onto a new replica
``fleet_bundle``   FleetManager collected a replica's bundles (fctrace)
``delta``          fcdelta admission: parent resolved, mode decided
=================  ====================================================

The router tier (serve/router.py) records into the same vocabulary:
``route`` doubles as the router's placement decision (ring lookup →
replica), and ``proxy``/``rehome_replay``/``fleet_bundle`` are the
router/fleet-side kinds — every one carries the ``trace`` id minted at
submit, which is how ``fleettrace render`` stitches router and replica
rings into one timeline.

Everything here is stdlib-only and jax-free: the post-mortem reader
(``python -m fastconsensus_tpu_torch.obs.postmortem``) renders snapshots on a
box where jax cannot even import.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

# Defaults bound the recorder to max_rings * capacity events; at ~200
# bytes per small event dict that is ~6 MiB worst case for a serving
# process with every ring full — the "hard memory cap" contract.
DEFAULT_CAPACITY = 2048
DEFAULT_MAX_RINGS = 16

# The machine-readable twin of the docstring table above: every kind
# the serving stack records.  fcheck-contract's ``event-vocab`` rule
# holds the two sides together — a ``record("newkind", ...)`` without a
# row here fails the gate, and a row nothing records is flagged stale —
# so postmortem renderers and ``merge_events(kinds=...)`` filters can
# trust this tuple as the full vocabulary.
EVENT_KINDS = (
    "admit", "reject_429", "shed", "hold", "pop", "route", "dequeue",
    "device", "device_done", "finish", "fail", "cache_hit", "cordon",
    "requeue", "watchdog_trip", "bundle", "span_open", "span_close",
    "proxy", "rehome_replay", "fleet_bundle", "delta",
)


class _Ring:
    """One thread's bounded event ring (oldest-overwrite)."""

    def __init__(self, thread_name: str, capacity: int) -> None:
        self.thread_name = thread_name
        self.capacity = capacity
        self._ring_lock = threading.Lock()
        self._slots: List[Optional[Dict[str, Any]]] = [None] * capacity
        self._appended = 0

    def append(self, event: Dict[str, Any]) -> None:
        with self._ring_lock:
            self._slots[self._appended % self.capacity] = event
            self._appended += 1

    def snapshot(self) -> Dict[str, Any]:
        """This ring's retained events, oldest first, plus the count
        overwritten before the snapshot."""
        with self._ring_lock:
            n = self._appended
            slots = list(self._slots)
        if n <= self.capacity:
            events = [e for e in slots[:n]]
        else:
            head = n % self.capacity
            events = slots[head:] + slots[:head]
        return {
            "thread": self.thread_name,
            "dropped": max(n - self.capacity, 0),
            "events": [e for e in events if e is not None],
        }

    def clear(self) -> None:
        with self._ring_lock:
            self._slots = [None] * self.capacity
            self._appended = 0


class FlightRecorder:
    """The process flight recorder; see the module docstring."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 max_rings: int = DEFAULT_MAX_RINGS) -> None:
        self.capacity = max(int(capacity), 1)
        self.max_rings = max(int(max_rings), 1)
        self._lock = threading.Lock()
        self._rings: List[_Ring] = []
        self._overflow: Optional[_Ring] = None
        self._tl = threading.local()

    # -- hot path -----------------------------------------------------

    def record(self, kind: str, job: Optional[str] = None,
               **aux: Any) -> None:
        """Append one event to the calling thread's ring.  ``aux``
        values should be small scalars (str/int/float/bool) — they are
        serialized verbatim into post-mortem bundles."""
        ring = getattr(self._tl, "ring", None)
        if ring is None:
            ring = self._ring_for_thread()
        event: Dict[str, Any] = {"ts": time.monotonic(), "kind": kind}
        if job is not None:
            event["job"] = job
        if aux:
            event.update(aux)
        ring.append(event)

    def _ring_for_thread(self) -> _Ring:
        name = threading.current_thread().name
        with self._lock:
            if len(self._rings) < self.max_rings:
                ring = _Ring(name, self.capacity)
                self._rings.append(ring)
            else:
                # thread storm: correctness over contention — latecomers
                # share one ring so the memory cap holds
                if self._overflow is None:
                    self._overflow = _Ring("<overflow>", self.capacity)
                    self._rings.append(self._overflow)
                ring = self._overflow
        self._tl.ring = ring
        return ring

    # -- cold path ----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """All rings (each copied atomically under its own lock): the
        bundle's ``flight.json`` payload.

        The ``time_unix``/``time_mono`` pair is the monotonic↔wall
        clock anchor (same convention as the bundle MANIFEST): event
        ``ts`` values are ``time.monotonic()`` stamps, so a reader maps
        them onto the wall clock via ``ts + (time_unix - time_mono)``.
        That is what lets ``fleettrace render`` align snapshots taken
        on DIFFERENT processes (each with its own monotonic epoch) onto
        one shared fleet timeline."""
        with self._lock:
            rings = list(self._rings)
        ring_snaps = [r.snapshot() for r in rings]
        return {
            "capacity": self.capacity,
            "max_rings": self.max_rings,
            "n_events": sum(len(r["events"]) for r in ring_snaps),
            "dropped": sum(r["dropped"] for r in ring_snaps),
            "time_unix": round(time.time(), 3),
            "time_mono": round(time.monotonic(), 6),
            "rings": ring_snaps,
        }

    def events(self, job: Optional[str] = None,
               kinds: Optional[Any] = None,
               limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Merged timeline across rings, sorted by ``ts`` (each event
        tagged with its ring's thread name).  ``job``/``kinds`` filter;
        ``limit`` keeps the most recent N after filtering — the
        ``/debugz/slowest`` per-job timeline helper."""
        snap = self.snapshot()
        return merge_events(snap, job=job, kinds=kinds, limit=limit)

    def reset(self) -> None:
        """Clear every ring's contents (tests).  Rings stay registered:
        threads cache their ring in a ``threading.local``, so dropping
        rings here would orphan those cached references and lose their
        future events from snapshots."""
        with self._lock:
            rings = list(self._rings)
        for ring in rings:
            ring.clear()


def merge_events(snapshot: Dict[str, Any], job: Optional[str] = None,
                 kinds: Optional[Any] = None,
                 limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """Flatten a :meth:`FlightRecorder.snapshot` into one thread-tagged
    timeline, sorted by ``ts`` — shared by the live ``/debugz``
    endpoints and the jax-free bundle reader (obs/postmortem.py)."""
    kind_set = set(kinds) if kinds is not None else None
    out: List[Dict[str, Any]] = []
    for ring in snapshot.get("rings", ()):
        thread = ring.get("thread")
        for event in ring.get("events", ()):
            if job is not None and event.get("job") != job:
                continue
            if kind_set is not None and event.get("kind") not in kind_set:
                continue
            out.append({**event, "thread": thread})
    out.sort(key=lambda e: e.get("ts", 0.0))
    if limit is not None and len(out) > limit:
        out = out[-limit:]
    return out


_RECORDER = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    """The process-global recorder (the serving stack records into it;
    post-mortem bundles snapshot it)."""
    return _RECORDER


def record(kind: str, job: Optional[str] = None, **aux: Any) -> None:
    """Module-level convenience: record into the global recorder."""
    _RECORDER.record(kind, job, **aux)
