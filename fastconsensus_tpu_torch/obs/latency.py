"""fclat: request-lifecycle latency attribution — streaming histograms.

The serving stack measures itself with two existing tools, and both are
wrong for *latency at serving scale*: span traces (obs/tracer.py) keep
every event and are therefore windowed on a resident server, and the
``observe()`` series in obs/counters.py hold raw samples whose
``set_series_limit`` window silently turns "run percentiles" into
"recent-window percentiles" (the footgun obs/counters.py now stamps
``window_truncated`` on).  A latency distribution the regression gate
can trust needs **bounded memory, unbounded history**:

* :class:`LatencyHistogram` — a fixed bank of log2 buckets (upper edge
  ``2^k`` seconds for ``k`` in ``MIN_EXP..MAX_EXP``, ~1 µs to ~68 min,
  plus an overflow bucket), exact ``count``/``sum``/``min``/``max``, and
  p50/p95/p99 read off the cumulative counts.  Recording is O(1), the
  whole histogram is ~35 ints, and — because buckets are *fixed*, never
  rebalanced — two histograms **merge exactly**: summing their bucket
  counts gives bit-identical quantiles to having recorded every sample
  into one histogram.  That property is what makes per-worker recording,
  cross-process aggregation, and per-window attribution (via
  :func:`diff_snapshots` — merge's inverse) all safe.
* :class:`RateTracker` — per-key inter-arrival tracking over a bounded
  window of monotonic stamps; ``rates()`` reports arrivals/s per key.
  The serving layer marks one tracker at admission (per-bucket *offered*
  load) and one at scheduler routing (per-bucket *dispatch* rate) — the
  two numbers the ROADMAP's adaptive hold-for-coalesce window needs
  (hold time ∝ expected time-to-fill = rung / arrival rate).
* :class:`LatencyRegistry` — tagged histograms (``hist(name, bucket=...,
  rung=..., priority=..., device=...)``) plus the two rate trackers,
  with a JSON ``snapshot()`` (the ``/metricsz`` ``latency`` block) and a
  text exposition (:func:`render_text`).

Everything here is stdlib-only (jax-free — the history/report tooling
loads by file path with jax poisoned) and thread-safe: every histogram
field is guarded by the instance lock, and the registry lock is never
held across a histogram operation, so the lock graph stays acyclic
(analysis/concurrency.py runs clean over this module without pragmas).

Quantile semantics: a reported pXX is the **upper edge** of the log2
bucket containing that rank (clamped to the exact observed max), i.e. a
conservative bound within 2x of the true quantile — the right trade for
a regression gate, which compares a statistic against *itself* across
rounds: the bucketing error is deterministic and cancels.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

# Bucket upper edges are 2^k seconds, k in [MIN_EXP, MAX_EXP]:
# 2^-20 s ~ 0.95 us (below any measurable phase) up to 2^12 s ~ 68 min
# (beyond any sane request lifetime); one extra overflow bucket above.
MIN_EXP = -20
MAX_EXP = 12
N_BUCKETS = MAX_EXP - MIN_EXP + 2   # [<=2^MIN_EXP, ..., <=2^MAX_EXP, inf]
_OVERFLOW = N_BUCKETS - 1

# fcflight tail exemplars: per bucket, at most this many (id, value)
# pairs ride the histogram — enough to link a bucket's outliers back to
# their flight-recorder timelines, bounded so exemplars can never grow
# the ~35-int histogram into a sample store.  The LARGEST values win a
# slot: for a latency histogram the interesting exemplar is the worst.
EXEMPLAR_SLOTS = 2


def bucket_index(seconds: float) -> int:
    """Index of the log2 bucket holding ``seconds`` (>= 0)."""
    if seconds <= 0.0:
        return 0
    # smallest k with v <= 2^k; exact at powers of two (log2 is exact
    # there), and off-by-one *within* a bucket's float neighborhood is
    # deterministic — the merge-exactness contract only needs every
    # writer to bucket a given value identically
    k = math.ceil(math.log2(seconds))
    if k <= MIN_EXP:
        return 0
    if k > MAX_EXP:
        return _OVERFLOW
    return k - MIN_EXP


def bucket_edge(index: int) -> float:
    """Upper edge (seconds) of bucket ``index``; inf for the overflow."""
    if index >= _OVERFLOW:
        return math.inf
    return 2.0 ** (MIN_EXP + index)


class LatencyHistogram:
    """Fixed log2-bucket streaming histogram; see the module docstring.

    Thread-safe: every field access happens under ``self._lock`` —
    including reads — so concurrent writers and ``/metricsz`` snapshot
    readers never see a torn (count, sum, buckets) triple.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._buckets: List[int] = [0] * N_BUCKETS
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        # bucket index -> [(exemplar id, value), ...] (largest-value
        # wins, at most EXEMPLAR_SLOTS per bucket — fcflight)
        self._exemplars: Dict[int, List[Tuple[str, float]]] = {}

    def record(self, seconds: float,
               exemplar: Optional[str] = None) -> None:
        """Fold one observation (seconds; negatives clamp to 0).

        ``exemplar`` (fcflight) attaches an identifier — the serving
        layer passes the job id on ``serve.e2e`` — to the observation's
        bucket: the largest :data:`EXEMPLAR_SLOTS` values per bucket
        keep their ids, so a tail outlier stays traceable to its
        flight-recorder timeline (``/debugz/slowest``) without the
        histogram ever storing raw samples."""
        v = max(float(seconds), 0.0)
        idx = bucket_index(v)
        with self._lock:
            self._buckets[idx] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            if exemplar is not None:
                slots = self._exemplars.setdefault(idx, [])
                slots.append((str(exemplar), v))
                if len(slots) > EXEMPLAR_SLOTS:
                    slots.sort(key=lambda s: s[1], reverse=True)
                    del slots[EXEMPLAR_SLOTS:]

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready state: exact count/sum/min/max, bucketed
        p50/p95/p99, the sparse non-zero bucket counts (keyed by the
        bucket's upper-edge exponent; ``"inf"`` for the overflow), and
        — when any observation carried one — the per-bucket exemplar
        slots (same keying)."""
        with self._lock:
            buckets = list(self._buckets)
            count, total = self._count, self._sum
            vmin, vmax = self._min, self._max
            exemplars = {i: list(s) for i, s in self._exemplars.items()}
        return _snapshot_from(buckets, count, total, vmin, vmax,
                              exemplars)


def _bucket_key(index: int) -> str:
    return "inf" if index == _OVERFLOW else str(MIN_EXP + index)


def _snapshot_from(buckets: List[int], count: int, total: float,
                   vmin: Optional[float], vmax: Optional[float],
                   exemplars: Optional[Dict[int, List[Tuple[str, float]]]]
                   = None) -> Dict[str, Any]:
    sparse = {}
    for i, c in enumerate(buckets):
        if c:
            sparse[_bucket_key(i)] = c
    out = {
        "count": count,
        "sum_s": round(total, 9),
        "min_s": None if vmin is None else round(vmin, 9),
        "max_s": None if vmax is None else round(vmax, 9),
        "p50_s": _quantile(buckets, count, vmax, 0.50),
        "p95_s": _quantile(buckets, count, vmax, 0.95),
        "p99_s": _quantile(buckets, count, vmax, 0.99),
        "buckets": sparse,
    }
    if exemplars:
        # Emitted only when an observation carried one, keyed like
        # ``buckets``, value [id, seconds] — an optional sidecar so
        # snapshots without exemplars stay byte-identical to before.
        out["exemplars"] = {
            _bucket_key(i): [[e, round(v, 9)] for e, v in slots]
            for i, slots in sorted(exemplars.items()) if slots}
    return out


def _quantile(buckets: List[int], count: int, vmax: Optional[float],
              q: float) -> Optional[float]:
    """Upper-edge-of-bucket quantile, clamped to the exact max."""
    if count < 1:
        return None
    rank = max(1, min(count, math.ceil(q * count)))
    seen = 0
    for i, c in enumerate(buckets):
        seen += c
        if seen >= rank:
            edge = bucket_edge(i)
            if vmax is not None:
                edge = min(edge, vmax)
            return round(edge, 9)
    return None if vmax is None else round(vmax, 9)  # pragma: no cover


def _dense_buckets(snap: Dict[str, Any]) -> List[int]:
    dense = [0] * N_BUCKETS
    for key, c in (snap.get("buckets") or {}).items():
        idx = _OVERFLOW if key == "inf" else int(key) - MIN_EXP
        dense[idx] = int(c)
    return dense


def merge_snapshots(snaps: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Exact merge of histogram snapshots: bucket counts, counts and
    sums add; min/max combine.  Because buckets are fixed, the merged
    quantiles equal those of one histogram that recorded every
    underlying sample — the property tests/test_latency.py pins across
    4 concurrent writers."""
    buckets = [0] * N_BUCKETS
    count, total = 0, 0.0
    vmin: Optional[float] = None
    vmax: Optional[float] = None
    exemplars: Dict[int, List[Tuple[str, float]]] = {}
    for snap in snaps:
        for i, c in enumerate(_dense_buckets(snap)):
            buckets[i] += c
        count += int(snap.get("count", 0))
        total += float(snap.get("sum_s", 0.0))
        v = snap.get("min_s")
        if v is not None:
            vmin = v if vmin is None else min(vmin, v)
        v = snap.get("max_s")
        if v is not None:
            vmax = v if vmax is None else max(vmax, v)
        for key, slots in (snap.get("exemplars") or {}).items():
            idx = _OVERFLOW if key == "inf" else int(key) - MIN_EXP
            merged = exemplars.setdefault(idx, [])
            merged.extend((str(e), float(v)) for e, v in slots)
            if len(merged) > EXEMPLAR_SLOTS:
                merged.sort(key=lambda s: s[1], reverse=True)
                del merged[EXEMPLAR_SLOTS:]
    return _snapshot_from(buckets, count, total, vmin, vmax, exemplars)


def merge_registry_snapshots(snaps: Iterable[Dict[str, Any]]
                             ) -> Dict[str, Any]:
    """Exact merge of whole :meth:`LatencyRegistry.snapshot` payloads —
    the cross-PROCESS use of :func:`merge_snapshots` (fctrace): the
    router's ``/fleetz`` feeds every replica's ``/metricsz`` latency
    block through this, and because the log2 buckets are fixed the
    merged quantiles are bit-identical to one registry having recorded
    every replica's samples.

    Histograms are matched by ``(name, sorted tags)`` — the registry's
    own identity — and each merged entry reports how many source
    registries contributed (``sources``).  The rate-tracker views
    (``arrivals``/``dispatches``) are deliberately NOT merged: their
    windows are monotonic stamps on per-process clocks, which have no
    shared epoch to merge on.
    """
    groups: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                 List[Dict[str, Any]]] = {}
    for snap in snaps:
        for h in (snap or {}).get("histograms") or ():
            key = (str(h.get("name")), _tag_key(h.get("tags") or {}))
            groups.setdefault(key, []).append(h)
    return {"histograms": [
        {"name": name, "tags": dict(tags), "sources": len(hs),
         **merge_snapshots(hs)}
        for (name, tags), hs in sorted(groups.items())]}


def diff_snapshots(new: Dict[str, Any],
                   old: Dict[str, Any]) -> Dict[str, Any]:
    """Merge's inverse: the histogram of samples recorded *between* two
    snapshots of one histogram (``old`` taken first).  Counts and sums
    subtract exactly; min/max are not invertible from counts alone, so
    the diff reports ``new``'s (a conservative bound the window's
    quantile clamp stays correct under)."""
    buckets = [max(n - o, 0) for n, o in zip(_dense_buckets(new),
                                             _dense_buckets(old))]
    count = max(int(new.get("count", 0)) - int(old.get("count", 0)), 0)
    total = max(float(new.get("sum_s", 0.0))
                - float(old.get("sum_s", 0.0)), 0.0)
    # Exemplar slots keep the largest values, so ``new``'s slots are a
    # superset of the window's candidates — carry them through (same
    # not-invertible-from-counts reasoning as min/max above).
    exemplars: Dict[int, List[Tuple[str, float]]] = {}
    for key, slots in (new.get("exemplars") or {}).items():
        idx = _OVERFLOW if key == "inf" else int(key) - MIN_EXP
        exemplars[idx] = [(str(e), float(v)) for e, v in slots]
    return _snapshot_from(buckets, count, total, new.get("min_s"),
                          new.get("max_s"), exemplars)


class RateTracker:
    """Per-key arrival-rate tracking over a bounded stamp window.

    ``max_keys`` bounds the KEY cardinality (the per-key windows are
    already bounded): trackers keyed by open-ended identifiers — the
    shaping group tracker, whose keys are batch-group strings minted
    per distinct config — evict the longest-idle key past the cap, so
    a resident server's memory cannot grow with config diversity.
    """

    WINDOW = 256

    def __init__(self, max_keys: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._max_keys = max_keys
        self._marks: Dict[str, deque] = {}
        self._totals: Dict[str, int] = {}

    def mark(self, name: str, at: Optional[float] = None) -> None:
        t = time.monotonic() if at is None else float(at)
        with self._lock:
            marks = self._marks.get(name)
            if marks is None:
                if self._max_keys is not None and \
                        len(self._marks) >= self._max_keys:
                    idle = min(self._marks,
                               key=lambda k: self._marks[k][-1])
                    del self._marks[idle]
                    self._totals.pop(idle, None)
                marks = self._marks[name] = deque(maxlen=self.WINDOW)
            marks.append(t)
            self._totals[name] = self._totals.get(name, 0) + 1

    def rates(self, now: Optional[float] = None
              ) -> Dict[str, Dict[str, Any]]:
        """``{key: {count, window, window_s, rate_per_s}}`` — the rate
        is arrivals-1 over the span from the first retained mark to
        NOW (not to the last mark: a bucket whose traffic stopped must
        DECAY toward zero, or the adaptive hold-for-coalesce consumer
        would hold jobs for phantom ride-alongs forever).  0.0 until
        two marks exist."""
        t_now = time.monotonic() if now is None else float(now)
        with self._lock:
            items = [(k, list(m), self._totals.get(k, 0))
                     for k, m in self._marks.items()]
        out: Dict[str, Dict[str, Any]] = {}
        for key, marks, total in items:
            span = max(t_now - marks[0], 0.0) if len(marks) >= 2 else 0.0
            rate = (len(marks) - 1) / span if span > 0 else 0.0
            out[key] = {
                "count": total,
                "window": len(marks),
                "window_s": round(span, 6),
                "rate_per_s": round(rate, 6),
            }
        return out

    # The control-signal recency horizon (seconds): rate() judges only
    # marks this recent.  The full-window view (rates()) spans to the
    # oldest retained mark, which is right for exposition but wrong
    # for burst detection — after a quiet spell, a handful of old
    # sparse marks would dilute a fresh burst's rate for the whole
    # window and the hold-for-coalesce consumer would never see it.
    HORIZON_S = 0.5

    def rate(self, name: str, now: Optional[float] = None,
             horizon_s: Optional[float] = None) -> float:
        """One key's CURRENT arrivals/s — the traffic shaper's control
        signal (serve/shaping.py): computed over the marks inside the
        trailing ``horizon_s`` window only (default
        :data:`HORIZON_S`), spanning to NOW, so a fresh burst registers
        within a few arrivals and an idle key reads 0.0 as soon as the
        horizon empties.  Single-key on purpose: the hold decision runs
        under the admission queue's condition, where recomputing every
        key's window would scale the lock hold time with bucket
        cardinality."""
        t_now = time.monotonic() if now is None else float(now)
        h = self.HORIZON_S if horizon_s is None else float(horizon_s)
        cutoff = t_now - h
        with self._lock:
            marks = self._marks.get(name)
            if marks is None or len(marks) < 2:
                return 0.0
            recent = [m for m in marks if m >= cutoff]
        if len(recent) < 2:
            return 0.0
        span = max(t_now - recent[0], 0.0)
        return (len(recent) - 1) / span if span > 0 else 0.0

    def reset(self) -> None:
        with self._lock:
            self._marks.clear()
            self._totals.clear()


# The phases that constitute one job's *service* time — work the device
# path actually performs per job, as opposed to time spent queued/held/
# routed.  The shaping estimator sums these per-phase distributions.
SERVICE_PHASES: Tuple[str, ...] = ("pack", "device", "fanout")


def _tag_key(tags: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in tags.items()))


class LatencyRegistry:
    """Tagged histograms + the arrival/dispatch rate trackers.

    ``hist()`` hands the histogram out from under the registry lock and
    callers record on it afterwards — the registry lock never nests a
    histogram lock, keeping the acquisition graph trivially acyclic.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hists: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                          LatencyHistogram] = {}
        self.arrivals = RateTracker()
        self.dispatches = RateTracker()
        # Per-BATCH-GROUP arrival tracking (fcshape): a rung can only
        # fill with same-group arrivals (bucket + config-minus-seed),
        # so the hold predictor prefers this over the per-bucket rate —
        # mixed-config traffic on one bucket would otherwise trigger
        # holds that can never fill.  Key-capped (group strings are
        # open-ended) and deliberately NOT in snapshot(): it is a
        # control signal, not an exposition surface.
        self.group_arrivals = RateTracker(max_keys=1024)

    def hist(self, name: str, **tags: Any) -> LatencyHistogram:
        key = (str(name), _tag_key(tags))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = LatencyHistogram()
            return h

    def snapshot(self) -> Dict[str, Any]:
        """The ``/metricsz`` ``latency`` block: every histogram (name +
        tags + counts + quantiles) and both rate-tracker views."""
        with self._lock:
            items = sorted(self._hists.items())
        return {
            "histograms": [
                {"name": name, "tags": dict(tags), **h.snapshot()}
                for (name, tags), h in items],
            "arrivals": self.arrivals.rates(),
            "dispatches": self.dispatches.rates(),
        }

    def service_estimate(self, bucket: Optional[str] = None,
                         min_count: int = 1,
                         prior: Optional[float] = None
                         ) -> Optional[Dict[str, Any]]:
        """Measured per-job service time (seconds) derived from the
        existing ``serve.phase.*`` histograms — the traffic shaper's
        (serve/shaping.py) view of how long one job occupies the
        serving path once dispatched.

        Per phase in :data:`SERVICE_PHASES` the tagged histograms are
        exact-merged (``bucket`` filters to one shape bucket; rung-0 —
        cache-hit — histograms are always excluded: a hit performs no
        service, and ``cold``-tagged ones too: a compiling job's device
        phase measures XLA, not serving), then combined across phases: the mean is the sum of
        per-phase means (phases tile a job's lifetime, so means add
        exactly) and ``p95_s`` the sum of per-phase p95s (a
        conservative upper bound — quantiles do not add, but for a
        deadline-slack bound only overestimation is safe).  Batched
        jobs stamp the whole batched call's duration as each member's
        device phase, which also overestimates per-job service — the
        same safe direction.  None until the device phase has
        ``min_count`` samples — unless a ``prior`` (static
        device-seconds estimate, e.g. analysis/cost.py's mirrored
        roofline for the bucket) is supplied: a history-less bucket
        then returns ``{"count": 0, "mean_s": prior, "p95_s": prior,
        "prior": True}`` so cold admission math starts from the model
        instead of a constant guess.  Measured history always wins.
        """
        with self._lock:
            items = list(self._hists.items())
        per_phase: Dict[str, List[Dict[str, Any]]] = {}
        prefix = "serve.phase."
        for (name, tags), h in items:
            if not name.startswith(prefix):
                continue
            phase = name[len(prefix):]
            if phase not in SERVICE_PHASES:
                continue
            td = dict(tags)
            if td.get("rung") == "0" or td.get("cold"):
                continue
            if bucket is not None and td.get("bucket") != str(bucket):
                continue
            per_phase.setdefault(phase, []).append(h.snapshot())
        merged = {p: merge_snapshots(s) for p, s in per_phase.items()}
        dev = merged.get("device")
        if dev is None or dev["count"] < max(int(min_count), 1):
            if prior is not None and prior > 0:
                return {"count": 0, "mean_s": round(float(prior), 9),
                        "p95_s": round(float(prior), 9), "prior": True}
            return None
        mean = sum(m["sum_s"] / m["count"]
                   for m in merged.values() if m["count"])
        p95 = sum(m["p95_s"] or 0.0 for m in merged.values())
        return {"count": dev["count"],
                "mean_s": round(mean, 9),
                "p95_s": round(p95, 9)}

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()
        self.arrivals.reset()
        self.dispatches.reset()
        self.group_arrivals.reset()


_REGISTRY = LatencyRegistry()


def get_latency_registry() -> LatencyRegistry:
    """The process-global registry (serve/server.py records into it;
    ``/metricsz`` snapshots it)."""
    return _REGISTRY


def render_text(snapshot: Dict[str, Any]) -> str:
    """Text exposition of a :meth:`LatencyRegistry.snapshot` — one line
    per histogram (``name{tag=value,...} count=N sum=S p50=... p95=...
    p99=... max=...``) and one per rate-tracker key, stable-ordered so
    diffs between scrapes are meaningful."""
    lines: List[str] = []
    for h in snapshot.get("histograms", ()):
        tags = ",".join(f"{k}={v}" for k, v in sorted(h["tags"].items()))
        label = f"{h['name']}{{{tags}}}" if tags else h["name"]
        lines.append(
            f"{label} count={h['count']} sum={h['sum_s']} "
            f"p50={h['p50_s']} p95={h['p95_s']} p99={h['p99_s']} "
            f"max={h['max_s']}")
    for kind in ("arrivals", "dispatches"):
        for key, r in sorted((snapshot.get(kind) or {}).items()):
            lines.append(
                f"{kind}{{key={key}}} count={r['count']} "
                f"rate_per_s={r['rate_per_s']} window_s={r['window_s']}")
    return "\n".join(lines)
