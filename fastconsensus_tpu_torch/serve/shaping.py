"""fcshape: SLO-aware traffic shaping for the serving stack.

Counterpart of ``fastconsensus_tpu/serve/shaping.py``, unchanged in behaviour:
routing and shaping decide exactly as the reference's, on the same static prior
(``analysis/cost.py``). The reference measured the problem it solves: p95 grew
with load with **deque-wait, not device time, as the growth driver** — the
queue fragments steady traffic into small batch rungs because ``pop_batch``
never waits, and batching only wins when the heap happens to be deep. fcshape
turns the observed SLO classes, arrival rates and phase histograms into a
control loop with three arms:

* **earliest-deadline-first admission ordering** — every job carries an
  absolute monotonic deadline (``Job.deadline_mono`` = admit +
  ``JobSpec.slo_target()``), the admission heap orders by
  ``(priority, deadline, seq)``, and ``pop_batch`` pops in that order,
  so within a priority a tight-deadline job is never starved behind
  earlier-admitted loose ones (``serve.shape.edf_promotions`` counts
  each reordering EDF actually performed);

* **adaptive hold-for-coalesce** (:meth:`TrafficShaper.hold_decision`)
  — when the head-of-queue's bucket shows an arrival rate that predicts
  a larger batch rung will fill *within the deadline slack*, the pop
  holds for ``hold_margin x`` the expected time-to-fill (Poisson
  arrivals are noisy; a bare mean-fill hold would abandon half its
  rungs one arrival short) and coalesces the stragglers into one
  device call.  The hold is bounded by the **tightest queued deadline
  minus the measured service-time estimate** — never by hope — and a
  rung that cannot fill inside ``min(max_hold_s, slack)`` bypasses
  instantly (``serve.shape.{holds,bypass}``), so a lone tight-deadline
  job dispatches with zero added latency;

* **honest backpressure** — Retry-After on a 429 derives from queued
  depth x the per-bucket observed service time over the pool's live
  parallelism (:meth:`TrafficShaper.retry_after_s`), replacing the old
  literal ``"1"``; and a job that *provably* cannot meet its deadline
  at the current depth is shed at submit (:meth:`should_shed`,
  ``serve.shape.deadline_sheds``) instead of occupying a slot just to
  miss — the client learns in microseconds what the queue would have
  told it after the whole SLO window.

Everything here is stdlib-only (torch-free: the predictor and estimator
must be loadable by the report tooling and testable under a fake
clock) and lock-light: the shaper's only mutable state is a small
estimate cache guarded by one leaf lock that never nests another, so
``fcheck-concurrency`` runs clean with zero pragmas.  The queue calls
:meth:`hold_decision` while holding its own condition — the resulting
acquisition edges (queue cond -> shaper cache -> fclat registry locks)
are one-directional by construction.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from fastconsensus_tpu_torch.obs import counters as obs_counters
from fastconsensus_tpu_torch.obs import latency as obs_latency

# Mirror of serve/bucketer.py BATCH_LADDER, kept import-light so the
# shaper stays torch-free (bucketer pulls graph -> torch); pinned against
# the real ladder in tests/test_torch_serve.py.
BATCH_LADDER: Tuple[int, ...] = (1, 2, 4, 8)

# How long a computed per-bucket service estimate is reused before the
# histograms are re-read: hold_decision runs under the admission
# queue's condition on EVERY pop, and re-merging every phase histogram
# there would make the queue lock's hold time grow with metric
# cardinality.  Estimates move on the time scale of traffic shifts,
# not pops.
ESTIMATE_TTL_S = 0.25


@dataclasses.dataclass(frozen=True)
class ShapingConfig:
    """Operator knobs for the traffic-shaping control loop.

    Each arm degrades independently to the pre-shaping posture:
    ``edf=False`` restores FIFO-within-priority ordering,
    ``hold=False`` restores the never-waits ``pop_batch``, and
    ``shed=False`` restores depth-only 429s (Retry-After stays derived
    — honesty costs nothing).
    """

    edf: bool = True
    hold: bool = True
    shed: bool = True
    # Hard cap on one hold episode.  The principled bound is the
    # deadline slack; this cap exists so a batch-class queue (120 s
    # slack) still cannot park the dispatcher for seconds chasing a
    # rung — past ~50 ms the coalescing win is already amortized away
    # by the wait itself at interactive service times.
    max_hold_s: float = 0.050
    # Hold for margin x expected fill: inter-arrival times are
    # exponential, so the expected-fill point leaves ~half of rungs one
    # arrival short; 1.5x trades a little worst-case latency (still
    # slack-bounded) for most of that tail.
    hold_margin: float = 1.5
    # Estimates with fewer service samples than this never shed work or
    # shape Retry-After (cold start must not reject traffic on noise);
    # hold decisions use whatever exists — a hold's worst case is
    # bounded latency, a shed's is a wrongly refused job.
    min_estimate_count: int = 8
    retry_after_default_s: float = 1.0
    retry_after_max_s: float = 600.0


@dataclasses.dataclass(frozen=True)
class HoldDecision:
    """One ``pop_batch`` hold verdict: wait ``hold_s`` (0 = dispatch
    now) for the batch rung ``target`` to fill; ``reason`` names why."""

    hold_s: float
    target: int
    reason: str


def next_rung(have: int, max_b: int,
              ladder: Tuple[int, ...] = BATCH_LADDER) -> Optional[int]:
    """The next batch-ladder rung above ``have`` reachable under
    ``max_b``, or None when ``have`` already fills the top rung."""
    for rung in ladder:
        if have < rung <= max_b:
            return rung
    return None


def expected_fill_s(have: int, target: int, rate_per_s: float) -> float:
    """Predicted seconds until ``target - have`` more same-group jobs
    arrive at ``rate_per_s`` (the per-bucket arrival tracker's view).
    ``inf`` when the rate is unknown or zero — an idle bucket predicts
    no ride-alongs, so the caller must bypass, never hold on hope.
    Pure arithmetic: the fake-clock predictor unit drives it with
    :meth:`obs.latency.RateTracker.rate` values stamped at explicit
    times."""
    need = max(int(target) - int(have), 0)
    if need == 0:
        return 0.0
    if rate_per_s <= 0.0:
        return math.inf
    return need / float(rate_per_s)


def find_deadline_inversions(pop_log: Iterable[Any]) -> List[str]:
    """EDF-order findings over a completed pop sequence; [] = clean.

    ``pop_log`` is the jobs (or ``(priority, deadline, seq)`` tuples)
    in the order they were popped from a fully loaded queue.  Within a
    priority the deadlines must be non-decreasing — a later pop with an
    earlier deadline means a tight-deadline job waited behind a loose
    one, the starvation EDF exists to prevent.  Each finding names the
    check (``deadline-inversion``) so the CI negative probe can assert
    the failure is THIS check firing, not an unrelated crash.
    """
    problems: List[str] = []
    last: Dict[int, Tuple[float, Any]] = {}
    for item in pop_log:
        if hasattr(item, "deadline_mono"):
            prio = item.spec.priority
            deadline = item.deadline_mono
            tag = item.job_id
        else:
            prio, deadline, tag = item[0], item[1], item[2]
        prev = last.get(prio)
        if prev is not None and deadline < prev[0] - 1e-9:
            problems.append(
                f"deadline-inversion: priority {prio} popped {tag!r} "
                f"(deadline {deadline:.6f}) after {prev[1]!r} "
                f"(deadline {prev[0]:.6f}) — EDF ordering violated")
        last[prio] = (deadline, tag)
    return problems


def _no_prior(bucket: str) -> Optional[float]:
    """Fallback cost-prior when the analyzer cannot load: no seeding."""
    return None


class TrafficShaper:
    """The shaping control loop shared by queue, admission and HTTP.

    Reads the fclat signals (per-bucket arrival rates marked at submit,
    per-bucket phase histograms folded per finished job) and answers
    three questions: *should this pop wait* (:meth:`hold_decision`),
    *should this submit be shed* (:meth:`should_shed`), and *when
    should a rejected client retry* (:meth:`retry_after_s`).  All
    decisions are recorded into ``serve.shape.*`` counters so
    ``/metricsz`` exposes the loop's behavior, not just its outcome.
    """

    def __init__(self, config: Optional[ShapingConfig] = None,
                 lat: Optional[obs_latency.LatencyRegistry] = None,
                 reg=None,
                 parallelism: Optional[Callable[[], int]] = None,
                 cost_prior: Optional[
                     Callable[[str], Optional[float]]] = None) -> None:
        self.config = config or ShapingConfig()
        self._lat = lat if lat is not None \
            else obs_latency.get_latency_registry()
        self._reg = reg if reg is not None \
            else obs_counters.get_registry()
        self._parallelism = parallelism
        self._busy_probe: Optional[Callable[[], bool]] = None
        self._solo_probe: Optional[Callable[[str], bool]] = None
        # Cold-start device-seconds model: bucket key -> est seconds or
        # None.  Default resolves lazily to the torch-free
        # mirror (analysis/cost.py static_service_prior) on first cold
        # lookup; tests inject a fake, and ``lambda b: None`` disables
        # seeding outright.
        self._cost_prior = cost_prior
        self._lock = threading.Lock()
        # bucket key (or None = all buckets) -> (computed_at, estimate)
        self._est_cache: Dict[Optional[str],
                              Tuple[float, Optional[dict]]] = {}
        # buckets whose estimate has been prior-seeded at least once
        # (the serve.shape.prior_seeded counter counts BUCKETS, not
        # lookups — service_estimate runs on every pop)
        self._prior_seeded: set = set()

    def set_parallelism(self, fn: Callable[[], int]) -> None:
        """Install the live-worker counter (the pool's eligible chip
        count) once the pool exists — Retry-After and shed math divide
        the queued work across the devices actually draining it."""
        self._parallelism = fn

    def set_busy_probe(self, fn: Callable[[], bool]) -> None:
        """Install the pool's all-chips-busy probe.  This is the hold
        economics in one bit: while every eligible worker is occupied a
        held job would only have waited in a worker deque anyway, so
        the hold is FREE latency-wise and pure occupancy gain; the
        moment a worker sits idle, holding trades real latency for
        predicted occupancy — a bad trade at interactive service
        times, so the decision bypasses.  Without a probe (unit tests,
        embedded use) holding is assumed free."""
        self._busy_probe = fn

    def hold_is_free(self) -> bool:
        """True while holding costs nothing (see set_busy_probe); the
        queue also re-checks this mid-hold so a worker going idle ends
        the episode within one wait slice instead of at the window."""
        if self._busy_probe is None:
            return True
        try:
            return bool(self._busy_probe())
        except Exception:  # noqa: BLE001 — a mid-drain pool must not
            return True    # wedge the pop path

    def set_solo_probe(self, fn: Callable[[str], bool]) -> None:
        """Install the pool's bucket-runs-solo probe (True for buckets
        the mesh/huge tier serves): those jobs execute one at a time
        regardless of coalescing, so a hold buys a bigger pop that
        still runs solo — pure added latency.  hold_decision bypasses
        them."""
        self._solo_probe = fn

    def runs_solo(self, bucket: Optional[str]) -> bool:
        """Whether this bucket's jobs execute solo (mesh/huge tier) —
        the queue also consults it for the heap it would delay."""
        if bucket is None or self._solo_probe is None:
            return False
        try:
            return bool(self._solo_probe(bucket))
        except Exception:  # noqa: BLE001 — an unparseable key routes
            return False   # chip-tier; the pop will sort it out

    def _workers(self) -> int:
        if self._parallelism is None:
            return 1
        try:
            return max(int(self._parallelism()), 1)
        except Exception:  # noqa: BLE001 — a mid-drain pool must not
            return 1       # break admission math

    # -- the service-time estimate ------------------------------------

    def service_estimate(self, bucket: Optional[str],
                         now: Optional[float] = None,
                         fallback: bool = True) -> Optional[dict]:
        """Cached :meth:`LatencyRegistry.service_estimate` for one
        bucket.  With ``fallback`` (the default), a bucket with no
        history yet borrows the all-bucket estimate — fine for hold
        bounds and Retry-After, where overestimating only shortens a
        hold or delays a retry; the shed path passes ``fallback=False``
        because refusing a job on ANOTHER bucket's service time is not
        "provably late".  Cached for :data:`ESTIMATE_TTL_S` because the
        queue consults it under its condition on every pop.

        A bucket with NO measured history anywhere in the chain is
        seeded from the static cost prior (the fcheck-cost mirrored
        roofline): ``{"count": 0, "mean_s": prior, "p95_s": prior,
        "prior": True}`` — so cold hold bounds, Retry-After and shed
        math start from the model instead of a constant guess.  Any
        measured sample beats the model (the prior only fills
        ``est is None``), and ``retry_after_s`` / ``should_shed``
        accept a seeded estimate in place of their
        ``min_estimate_count`` history gate (the ``"prior"`` marker)."""
        est = self._cached_estimate(bucket, now)
        if est is None and fallback and bucket is not None:
            est = self._cached_estimate(None, now)
        if est is None and bucket is not None:
            prior = self._static_prior(bucket)
            if prior is not None and prior > 0:
                with self._lock:
                    if bucket not in self._prior_seeded:
                        self._prior_seeded.add(bucket)
                        seed_new = True
                    else:
                        seed_new = False
                if seed_new:
                    self._reg.inc("serve.shape.prior_seeded")
                est = {"count": 0, "mean_s": round(float(prior), 9),
                       "p95_s": round(float(prior), 9), "prior": True}
        return est

    def _static_prior(self, bucket: str) -> Optional[float]:
        fn = self._cost_prior
        if fn is None:
            # analysis/cost.py is pure arithmetic; the import is deferred so
            # embedded shapers with an injected prior never load it
            try:
                from fastconsensus_tpu_torch.analysis import cost as _cost
                fn = _cost.static_service_prior
            except Exception:  # noqa: BLE001 — a broken analyzer must
                fn = _no_prior  # not take down admission
            self._cost_prior = fn
        try:
            return fn(bucket)
        except Exception:  # noqa: BLE001 — ditto: an unparseable key
            return None    # just means "no prior"

    def _cached_estimate(self, which: Optional[str],
                         now: Optional[float]) -> Optional[dict]:
        """TTL-cached per-bucket (None = all-bucket) estimate read."""
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            hit = self._est_cache.get(which)
            if hit is not None and t - hit[0] <= ESTIMATE_TTL_S:
                return hit[1]
        est = self._lat.service_estimate(which)
        with self._lock:
            self._est_cache[which] = (t, est)
        return est

    # -- arm 2: adaptive hold-for-coalesce ----------------------------

    def hold_decision(self, bucket: Optional[str], have: int,
                      max_b: int, slack_s: float,
                      now: Optional[float] = None,
                      group: Optional[str] = None,
                      blocks_solo: bool = False) -> HoldDecision:
        """Should ``pop_batch`` wait for a larger rung?

        ``have`` is the same-group jobs already queued, ``slack_s`` the
        tightest queued deadline minus now (across the WHOLE heap — a
        hold delays every queued job, not just its own group), and
        ``group`` the head's batch group: the fill prediction prefers
        the GROUP arrival rate, because only same-group arrivals can
        join the rung — the bucket rate is just the fallback for a
        group with no history yet.  ``blocks_solo`` means a mesh-tier
        job is queued behind the head: its idle tier cannot be probed
        cheaply, so the decision bypasses rather than park work a
        separate tier could be running.  The hold window is
        ``min(hold_margin x expected fill, max_hold_s, slack - service
        estimate)``; when the expected fill cannot complete inside that
        bound the decision is an instant bypass — holding a doomed rung
        would buy occupancy with missed SLOs.
        """
        cfg = self.config
        if not cfg.hold or max_b <= 1:
            return HoldDecision(0.0, max(have, 1), "disabled")
        target = next_rung(have, max_b)
        if target is None:
            return HoldDecision(0.0, have, "rung_full")
        if self.runs_solo(bucket):
            # mesh/huge-tier buckets execute solo whatever the pop
            # size: a bigger rung gains nothing, the wait is pure loss
            self._reg.inc("serve.shape.bypass")
            return HoldDecision(0.0, target, "solo_tier")
        if blocks_solo:
            self._reg.inc("serve.shape.bypass")
            return HoldDecision(0.0, target, "blocks_solo_tier")
        if not self.hold_is_free():
            # an idle worker means a held job pays the wait for real
            # (it could be running RIGHT NOW); dispatch immediately —
            # coalescing under light load is the deque re-merge's job
            self._reg.inc("serve.shape.bypass")
            return HoldDecision(0.0, target, "worker_idle")
        est = self.service_estimate(bucket, now=now)
        est_s = (est or {}).get("p95_s") or 0.0
        slack = float(slack_s) - est_s
        if slack <= 0.0:
            self._reg.inc("serve.shape.bypass")
            return HoldDecision(0.0, target, "deadline")
        rate = self._lat.group_arrivals.rate(group, now=now) \
            if group is not None else 0.0
        if rate <= 0.0:
            rate = self._lat.arrivals.rate(bucket, now=now) \
                if bucket is not None else 0.0
        fill = expected_fill_s(have, target, rate)
        bound = min(cfg.max_hold_s, slack)
        if fill > bound:
            self._reg.inc("serve.shape.bypass")
            return HoldDecision(0.0, target, "fill_exceeds_slack")
        hold = min(fill * cfg.hold_margin, bound)
        self._reg.inc("serve.shape.holds")
        return HoldDecision(hold, target, "hold")

    # -- arm 3: honest backpressure -----------------------------------

    def retry_after_s(self, depth: int,
                      bucket: Optional[str] = None) -> float:
        """Seconds until the queue has plausibly drained ``depth``
        jobs: depth x the observed per-job service time over the live
        worker count.  Until the estimate has ``min_estimate_count``
        samples, a prior-seeded estimate (the static cost model — see
        :meth:`service_estimate`) still derives the answer; only a
        bucket with neither history nor a prior falls back to
        ``retry_after_default_s`` — an honest guess beats a precise
        fabrication."""
        cfg = self.config
        est = self.service_estimate(bucket)
        if est is None or not est["mean_s"] or (
                est["count"] < cfg.min_estimate_count
                and not est.get("prior")):
            return cfg.retry_after_default_s
        v = max(int(depth), 1) * est["mean_s"] / self._workers()
        return min(max(v, 0.001), cfg.retry_after_max_s)

    def should_shed(self, bucket: Optional[str], deadline_mono: float,
                    depth: int,
                    now: Optional[float] = None) -> Optional[str]:
        """A shed reason when the job provably cannot meet its deadline
        at the current queued depth, else None (admit it).

        "Provably" is held to an OPTIMISTIC service model: the drain
        rate is the better of the per-bucket observed dispatch rate
        (which already includes every batching win) and ``workers /
        mean service time``; only when even that model lands the job
        past its deadline is it refused.  Anything less conservative
        would shed traffic the pool could have served — a 429 storm is
        the failure mode, not the feature.
        """
        cfg = self.config
        if not cfg.shed or depth <= 0:
            return None
        # per-bucket history ONLY (no cross-bucket fallback): "provably
        # late" judged on another bucket's service time is a guess, and
        # the estimator already excludes cold-compile samples — both
        # are real false-shed modes tier-1 caught.  A prior-seeded
        # estimate (this bucket's OWN static model) is admissible where
        # a borrowed measurement is not: it is conservative (worst-case
        # sweep counts) and bucket-specific, so "provably late" against
        # it errs toward admitting.
        est = self.service_estimate(bucket, now=now, fallback=False)
        if est is None or not est["mean_s"] or (
                est["count"] < cfg.min_estimate_count
                and not est.get("prior")):
            return None
        t = time.monotonic() if now is None else float(now)
        per_worker = self._workers() / est["mean_s"]
        dispatch = self._lat.dispatches.rate(bucket, now=t) \
            if bucket is not None else 0.0
        drain = max(per_worker, dispatch)
        eta = t + depth / drain + est["p95_s"]
        if eta <= deadline_mono:
            return None
        self._reg.inc("serve.shape.deadline_sheds")
        late_ms = (eta - deadline_mono) * 1000.0
        return (f"deadline shed: {depth} queued job(s) at "
                f"~{est['mean_s'] * 1000.0:.1f} ms/job across "
                f"{self._workers()} worker(s) put completion "
                f"~{late_ms:.0f} ms past the "
                f"{(deadline_mono - t) * 1000.0:.0f} ms deadline slack; "
                f"retry later or relax the SLO class")

    # -- introspection ------------------------------------------------

    def describe(self, depth: int = 0,
                 buckets: Iterable[str] = ()) -> Dict[str, Any]:
        """The ``/metricsz`` ``shaping`` block: the live config, the
        ``serve.shape.*`` counters, per-bucket service estimates for
        every bucket with arrival history, and the Retry-After a 429
        issued right now would carry."""
        cfg = self.config
        counters = self._reg.counters()
        estimates = {}
        for b in buckets:
            # through the TTL cache (fallback off: a borrowed estimate
            # would render as the bucket's own) — a metrics scraper
            # polling /metricsz must not re-merge every histogram per
            # bucket per poll
            est = self.service_estimate(b, fallback=False)
            if est is not None:
                estimates[b] = est
        return {
            "config": {
                "edf": cfg.edf, "hold": cfg.hold, "shed": cfg.shed,
                "max_hold_s": cfg.max_hold_s,
                "hold_margin": cfg.hold_margin,
                "min_estimate_count": cfg.min_estimate_count,
            },
            "counters": {
                name: counters.get(f"serve.shape.{name}", 0)
                for name in ("holds", "bypass", "edf_promotions",
                             "deadline_sheds", "prior_seeded")},
            "estimates": estimates,
            "retry_after_hint_s": round(self.retry_after_s(depth), 6),
        }
