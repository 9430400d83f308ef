"""fcflight hang watchdog: detect a wedged device call, cordon, dump.

``utils/supervise.py`` already survives a wedged PROCESS (progress-file
watchdog, SIGKILL, relaunch), but inside a serving replica that is the
wrong granularity: one stuck device call — a pathological graph, a
CUDA driver fault — would freeze one worker while seven
healthy chips keep serving, and killing the process throws away all
eight.  The hang watchdog is the per-worker version of the same idea:

* **Heartbeats, not progress files.**  Workers stamp a heartbeat at
  batch dequeue, device dispatch and device done
  (:meth:`HangWatchdog.beat` — the pool and the service's device-call
  sites call it; each beat is one uncontended lock take, O(1)).
* **A measured threshold, not a constant.**  A device call is "hung"
  when it exceeds ``k ×`` the bucket's measured service p95
  (``LatencyRegistry.service_estimate`` — the fcshape estimator, which
  already excludes cache hits and cold-compile-tagged timelines), with
  a floor (``floor_s``) so sub-millisecond buckets don't trip on
  scheduler jitter.  Two guards keep false positives structural, not
  tuned: a dispatch the server expects to COMPILE (bucket not warm on
  that worker) is exempt — a cold worker builds the CUDA kernels with
  nvcc first — and a
  bucket with fewer than ``min_history`` completed device calls never
  trips at all (no distribution, no verdict).
* **Cordon-on-stall.**  A trip marks the worker *suspect*, writes a
  post-mortem bundle (obs/postmortem.py), and cordons the worker
  through the same machinery a worker death uses: the deque
  backlog requeues onto surviving devices with the suspect excluded,
  so the fleet keeps serving while the stuck call either returns late
  (the worker finishes its job but takes no new work) or never does.
  Surfaced in ``/healthz`` (``suspect_devices``, ``last_bundle``) and
  the ``serve.flight.*`` counters.

Counterpart of ``fastconsensus_tpu/serve/watchdog.py``, unchanged in
behaviour.  Everything here is stdlib-only (torch-free) and fake-clock
testable:
:meth:`check` is a pure function of the heartbeat table, the latency
registry and ``now``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

_logger = logging.getLogger("fastconsensus_tpu_torch")


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """Hang-watchdog knobs (``ServeConfig.watchdog``).

    ``k``            trip at ``k x`` the bucket's service p95
    ``floor_s``      never trip below this elapsed time (absorbs
                     scheduler jitter on microsecond buckets)
    ``min_history``  minimum completed device calls in the bucket
                     before its p95 is trusted (the min-history guard)
    ``poll_s``       watchdog thread wake interval
    ``cordon``       False = observe-only (trip counters + bundle, no
                     cordon) — the cautious first-deploy posture
    """

    enabled: bool = True
    k: float = 8.0
    floor_s: float = 30.0
    min_history: int = 8
    poll_s: float = 0.5
    cordon: bool = True

    def validate(self) -> None:
        if self.k <= 0:
            raise ValueError(f"watchdog k={self.k} must be > 0")
        if self.floor_s < 0:
            raise ValueError(
                f"watchdog floor_s={self.floor_s} must be >= 0")
        if self.min_history < 1:
            raise ValueError(
                f"watchdog min_history={self.min_history} must be >= 1")
        if self.poll_s <= 0:
            raise ValueError(
                f"watchdog poll_s={self.poll_s} must be > 0")


class _Beat:
    """One worker's latest heartbeat (all fields guarded by the
    watchdog lock — instances never leave :class:`HangWatchdog`)."""

    __slots__ = ("state", "since", "job", "bucket", "cold", "n_jobs",
                 "seq", "tripped")

    def __init__(self) -> None:
        self.state = "idle"
        self.since = 0.0
        self.job: Optional[str] = None
        self.bucket: Optional[str] = None
        self.cold = False
        self.n_jobs = 0
        self.seq = 0
        self.tripped = False


class HangWatchdog:
    """The per-pool hang watchdog; see the module docstring.

    ``latency`` is anything with a ``service_estimate(bucket=...,
    min_count=...)`` method (the fclat registry in production, a stub
    in tests); ``clock`` defaults to ``time.monotonic`` and is
    injectable for fake-clock units; ``on_trip`` receives each trip
    dict exactly once per suspect episode.
    """

    def __init__(self, latency: Any,
                 config: Optional[WatchdogConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_trip: Optional[Callable[[Dict[str, Any]],
                                            None]] = None) -> None:
        self.config = config or WatchdogConfig()
        self.config.validate()
        self.latency = latency
        self.clock = clock
        self.on_trip = on_trip
        self._lock = threading.Lock()
        self._beats: Dict[int, _Beat] = {}
        self._suspects: Dict[int, Dict[str, Any]] = {}
        self._trips = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the hot path (workers) ---------------------------------------

    def beat(self, idx: int, state: str, job: Optional[str] = None,
             bucket: Optional[str] = None, cold: bool = False,
             n_jobs: int = 0) -> None:
        """Stamp worker ``idx``'s heartbeat: ``state`` is one of
        ``dequeue`` / ``device`` / ``device_done`` / ``idle``.  A beat
        ends any suspect episode for the worker — the stuck call
        returned after all — so the next hang trips (and bundles)
        afresh."""
        now = self.clock()
        with self._lock:
            b = self._beats.get(idx)
            if b is None:
                b = self._beats[idx] = _Beat()
            b.state = state
            b.since = now
            b.job = job
            b.bucket = bucket
            b.cold = cold
            b.n_jobs = n_jobs
            b.seq += 1
            b.tripped = False
            if state in ("device_done", "idle"):
                self._suspects.pop(idx, None)

    # -- the verdict --------------------------------------------------

    def check(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Evaluate every heartbeat; returns the NEW trips (each suspect
        episode trips once).  Estimates are read outside the watchdog
        lock — the latency registry has its own locks and the beat
        table must stay O(1) to stamp."""
        t_now = self.clock() if now is None else float(now)
        with self._lock:
            candidates = [
                (idx, b.seq, b.job, b.bucket, t_now - b.since)
                for idx, b in self._beats.items()
                if b.state == "device" and not b.tripped and not b.cold]
        trips: List[Dict[str, Any]] = []
        for idx, seq, job, bucket, elapsed in candidates:
            est = self.latency.service_estimate(
                bucket=bucket, min_count=self.config.min_history)
            if est is None:
                continue   # min-history guard: no distribution yet
            p95 = float(est.get("p95_s") or 0.0)
            threshold = max(self.config.k * p95, self.config.floor_s)
            if elapsed <= threshold:
                continue
            trip = {
                "device": idx,
                "job": job,
                "bucket": bucket,
                "elapsed_s": round(elapsed, 6),
                "threshold_s": round(threshold, 6),
                "service_p95_s": round(p95, 9),
                "history": est.get("count"),
            }
            with self._lock:
                b = self._beats.get(idx)
                if b is None or b.seq != seq:
                    continue   # the call finished while we deliberated
                b.tripped = True
                self._trips += 1
                self._suspects[idx] = trip
            trips.append(trip)
        return trips

    def suspects(self) -> List[Dict[str, Any]]:
        """Current suspect episodes (cleared when the worker beats
        again) — the ``/healthz`` ``suspect_devices`` payload."""
        with self._lock:
            return [dict(t) for _, t in sorted(self._suspects.items())]

    def trips(self) -> int:
        with self._lock:
            return self._trips

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            beats = {
                idx: {"state": b.state, "job": b.job, "bucket": b.bucket,
                      "cold": b.cold, "n_jobs": b.n_jobs,
                      "since_mono": round(b.since, 6),
                      "tripped": b.tripped}
                for idx, b in sorted(self._beats.items())}
            trips = self._trips
            suspects = [dict(t) for _, t in sorted(self._suspects.items())]
        return {"config": dataclasses.asdict(self.config),
                "trips": trips, "suspects": suspects, "beats": beats}

    # -- the thread ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._poll_loop, name="fcflight-watchdog", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)

    def _poll_loop(self) -> None:
        from fastconsensus_tpu_torch.obs import counters as obs_counters

        reg = obs_counters.get_registry()
        while not self._stop.wait(self.config.poll_s):
            try:
                trips = self.check()
            except Exception:  # noqa: BLE001 — a poisoned estimate must
                # not kill the only thread that detects hangs; count it
                # so /metricsz shows a watchdog that polls but cannot
                # judge
                reg.inc("serve.watchdog.poll_errors")
                _logger.exception("fcflight: watchdog check failed")
                continue
            for trip in trips:
                cb = self.on_trip
                if cb is not None:
                    try:
                        cb(trip)
                    except Exception:  # noqa: BLE001 — the trip handler
                        # writes bundles and cordons; a bug there must
                        # not kill the watchdog itself
                        reg.inc("serve.watchdog.trip_errors")
                        _logger.exception(
                            "fcflight: watchdog trip handler failed")


class DisabledWatchdog:
    """No-op watchdog (``watchdog.enabled=False``): call sites stay
    unconditional, like the disabled tracer singleton."""

    config = WatchdogConfig(enabled=False)

    def beat(self, idx: int, state: str, job: Optional[str] = None,
             bucket: Optional[str] = None, cold: bool = False,
             n_jobs: int = 0) -> None:
        pass

    def check(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        return []

    def suspects(self) -> List[Dict[str, Any]]:
        return []

    def trips(self) -> int:
        return 0

    def describe(self) -> Dict[str, Any]:
        return {"config": {"enabled": False}, "trips": 0,
                "suspects": [], "beats": {}}

    def start(self) -> None:
        pass

    def stop(self, timeout: float = 5.0) -> None:
        pass


DISABLED_WATCHDOG = DisabledWatchdog()
