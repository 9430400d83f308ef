"""fcobs counters: a process-wide counter / gauge / series registry.

Where spans (obs/tracer.py) answer *where the wall clock went*, the
registry answers *how many times did X happen* — and stays always-on:
every operation is a dict update under a lock, cheap enough for the host
driver loop's handful-of-events-per-round rate, so counts exist even when
span tracing is disabled (``bench.py`` builds its ``telemetry`` block
from exactly this).

Three kinds of signal:

* **counters** — monotonically increasing ints (``inc``): consensus
  rounds, host-sync crossings (:func:`host_sync` — called at every
  ``# fcheck: ok=sync-in-loop``-pragma'd readback in engine.py /
  consensus.py and at the eager Louvain round's reads), closure/repair
  edge totals, regrow events;
* **gauges** — last-write-wins floats (``gauge``): slab capacity, device
  memory (:func:`record_device_memory`, from ``torch.cuda.memory_stats``);
* **series** — observed samples (``observe``) summarized on demand
  (:meth:`ObsRegistry.summary`: count / total / mean / p50 / p95 / max):
  per-round wall seconds, per-member detect-call latency.

Scoping: the registry is process-global (one consensus run per process is
the operating mode — CLI, bench, supervised long runs).  Callers that
need per-run deltas ``reset()`` before the run or diff ``snapshot()``s.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional


def percentile(sorted_values: List[float], q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted non-empty list."""
    if not sorted_values:
        raise ValueError("percentile of an empty series")
    n = len(sorted_values)
    rank = max(1, min(n, math.ceil(q * n)))
    return sorted_values[rank - 1]


class ObsRegistry:
    """Thread-safe counter/gauge/series store; see module docstring."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._series: Dict[str, List[float]] = {}
        self._series_limit: Optional[int] = None
        # samples dropped per series by the window (set_series_limit):
        # summaries over a truncated series describe the RECENT WINDOW,
        # not the run — snapshot() must say so (a windowed p95 presented
        # as a run p95 is how a latency regression hides in /metricsz)
        self._series_dropped: Dict[str, int] = {}

    # -- writes ------------------------------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            series = self._series.setdefault(name, [])
            series.append(float(value))
            if self._series_limit and len(series) > self._series_limit:
                n_drop = len(series) - self._series_limit
                del series[:n_drop]
                self._series_dropped[name] = \
                    self._series_dropped.get(name, 0) + n_drop

    def set_series_limit(self, limit: Optional[int]) -> None:
        """Bound every series to its most recent ``limit`` samples.

        One-shot consumers (CLI, bench) keep the default ``None`` — full
        history, whole-run percentiles.  A RESIDENT process must bound
        this: the serving layer observes per-job/per-round latencies
        forever, and unbounded sample lists are a slow memory leak
        (serve/server.py sets a window at start; summaries then describe
        the recent window, which is what a serving dashboard wants
        anyway).  Applies retroactively to existing series.
        """
        with self._lock:
            self._series_limit = None if limit is None \
                else max(1, int(limit))
            if self._series_limit:
                for name, series in self._series.items():
                    n_drop = len(series) - self._series_limit
                    if n_drop > 0:
                        del series[:n_drop]
                        self._series_dropped[name] = \
                            self._series_dropped.get(name, 0) + n_drop

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._series.clear()
            self._series_dropped.clear()

    def restore_counters(self, saved: Dict[str, int]) -> Dict[str, int]:
        """Restore checkpointed counter totals by *delta*: each counter is
        raised to at least its saved value (``inc`` by ``saved - current``
        when positive, nothing otherwise).

        This is the telemetry-continuity primitive (utils/checkpoint.py
        persists ``snapshot()["counters"]`` in the checkpoint metadata): a
        fresh process resuming a run starts at zero, so the delta restore
        replays the dead process's totals and every later ``inc`` lands on
        top — ``--trace`` summaries of a resumed run report cumulative
        counts.  In the same process that already holds the run's counts
        (e.g. an immediate in-process resume after convergence) the delta
        is zero and nothing double-counts.  Returns the applied deltas.
        """
        applied: Dict[str, int] = {}
        with self._lock:
            for name, value in saved.items():
                delta = int(value) - self._counters.get(name, 0)
                if delta > 0:
                    self._counters[name] = \
                        self._counters.get(name, 0) + delta
                    applied[name] = delta
        return applied

    # -- reads -------------------------------------------------------

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def counters_since(self, base: Dict[str, int]) -> Dict[str, int]:
        """Positive counter increments since a ``counters()`` snapshot —
        the run-scoping primitive: a checkpoint must persist THIS run's
        counts (plus its own restored base), not whatever an earlier run
        in the same process left in the global registry."""
        return {k: v - base.get(k, 0) for k, v in self.counters().items()
                if v - base.get(k, 0) > 0}

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def series(self, name: str) -> List[float]:
        with self._lock:
            return list(self._series.get(name, ()))

    def summary(self, name: str) -> Optional[dict]:
        """Summary stats of one series, or None if nothing was observed.

        When the series window (:meth:`set_series_limit`) has dropped
        samples, the summary describes the RECENT WINDOW only and says
        so: ``window_truncated: True`` plus the dropped count — without
        the stamp, a windowed p95 reads as a run total's p95 (the
        serving layer's whole-run latency now lives on the fclat
        histograms in obs/latency.py, which never truncate).
        """
        with self._lock:
            values = list(self._series.get(name, ()))
            dropped = self._series_dropped.get(name, 0)
        if not values:
            return None
        values.sort()
        total = sum(values)
        out = {
            "count": len(values),
            "total": round(total, 6),
            "mean": round(total / len(values), 6),
            "p50": round(percentile(values, 0.50), 6),
            "p95": round(percentile(values, 0.95), 6),
            "max": round(values[-1], 6),
        }
        if dropped:
            out["window_truncated"] = True
            out["dropped"] = dropped
        return out

    def snapshot(self) -> dict:
        """One JSON-ready dict of everything (series as summaries)."""
        with self._lock:
            names = list(self._series)
        return {
            "counters": self.counters(),
            "gauges": self.gauges(),
            "series": {n: self.summary(n) for n in names},
        }


_REGISTRY = ObsRegistry()


def get_registry() -> ObsRegistry:
    """The process-global registry."""
    return _REGISTRY


def host_sync(tag: str, n: int = 1) -> None:
    """Count a host-device sync crossing.

    Called next to every deliberate device-to-host readback or
    synchronize in the driver (engine.py / consensus.py) and next to the
    eager Louvain round's own reads (a sweep's exit test, a batched
    sweep's row read, the tail's convergence test), so a trace can
    separate "the engine started syncing per item" from "the device got
    slower".
    """
    _REGISTRY.inc("host_sync.total", n)
    _REGISTRY.inc(f"host_sync.{tag}", n)


def fold_round(entry: dict) -> None:
    """Fold one round's history entry (consensus.run_consensus.record)
    into the registry: round counts, closure/repair/drop totals, the
    converged-edge fraction series, the slab-capacity gauge, and the
    fcqual ``consensus.quality.*`` series (obs/quality.py).  The quality
    keys are optional — pre-fcqual entries (resumed legacy checkpoints)
    fold without them."""
    _REGISTRY.inc("rounds.total")
    if entry.get("cold"):
        _REGISTRY.inc("rounds.cold")
    _REGISTRY.inc("closure.edges_added", entry.get("n_closure_added", 0))
    _REGISTRY.inc("repair.edges_added", entry.get("n_repaired", 0))
    _REGISTRY.inc("capacity.edges_dropped", entry.get("n_dropped", 0))
    n_alive = entry.get("n_alive", 0)
    if n_alive:
        frac = 1.0 - entry.get("n_unconverged", 0) / n_alive
        _REGISTRY.observe("round.converged_frac", frac)
    if entry.get("capacity"):
        _REGISTRY.gauge("slab.capacity", entry["capacity"])
    # fcqual: per-round quality series + cumulative counters (the
    # counters persist in checkpoints and delta-restore on resume, like
    # every other counter in the registry)
    for key in ("agreement", "frontier_frac", "churn_frac",
                "modularity_mean"):
        if entry.get(key) is not None:
            _REGISTRY.observe(f"consensus.quality.{key}", float(entry[key]))
    _REGISTRY.inc("quality.labels_changed_total",
                  entry.get("labels_changed", 0))
    _REGISTRY.inc("quality.agg_overflow_total",
                  entry.get("n_agg_overflow", 0))


def device_memory(device=None) -> Optional[dict]:
    """Allocator stats of a CUDA device (default: the current one), as
    ``torch.cuda.memory_stats`` gives them, plus the reference's three
    headline keys: ``bytes_in_use`` (``allocated_bytes.all.current``),
    ``peak_bytes_in_use`` (``allocated_bytes.all.peak``) and
    ``bytes_limit`` (the card's total memory).  None on the CPU, where
    PyTorch keeps no allocator stats."""
    try:
        import torch

        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None
        stats = torch.cuda.memory_stats(dev)
        limit = torch.cuda.mem_get_info(dev)[1]
    except Exception:  # noqa: BLE001 — observability must never raise
        return None
    if not stats:
        return None
    out = {k: int(v) for k, v in stats.items()
           if isinstance(v, (int, float))}
    out.update(bytes_in_use=out.get("allocated_bytes.all.current", 0),
               peak_bytes_in_use=out.get("allocated_bytes.all.peak", 0),
               bytes_limit=int(limit))
    return out


def record_device_memory(prefix: str = "device_mem",
                         device=None) -> Optional[dict]:
    """Gauge the headline allocator numbers (bytes in use / peak / limit)
    into the registry; returns the raw stats dict (or None)."""
    stats = device_memory(device)
    if stats:
        for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
            if key in stats:
                _REGISTRY.gauge(f"{prefix}.{key}", stats[key])
    return stats
