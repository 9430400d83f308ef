"""fcpool scheduler: sticky bucket->device affinity routing.

Counterpart of ``fastconsensus_tpu/serve/scheduler.py``, unchanged in
behaviour.  The reference routes by affinity because a jit executable
lives on the device that compiled it; on the port a device's warm state
is its built CUDA kernels and its caching allocator's pools, and the
same routing keeps each bucket's work (and the compile counters the
wire reports) on one device.  Routing is not round-robin: it sends
same-bucket work back to the device that already ran the bucket.  That is the
**sticky home**: the first time a bucket is routed, the least-loaded
eligible worker becomes its home, and every later batch of that bucket
lands there.

Stickiness is not absolute, because a hot bucket would otherwise turn
the pool back into a single chip.  When the home's backlog exceeds
``spill_backlog`` queued jobs, the batch **spills** to the least-loaded
eligible worker — preferring workers that already ran this bucket (they
are warm for it) and falling back to a cold worker only when no warm one
exists (minting a second home, which the warm-preference then reuses).

Cordoning: a worker that died (serve/pool.py failure isolation) is never
routed to again, and a job that *killed* a worker carries that device in
its exclusion set (``Job.excluded_devices``) so the requeue cannot
bounce it back.  A bucket whose home is cordoned is re-homed on its next
batch.  When no eligible worker remains, :class:`NoEligibleWorker`
propagates and the caller fails the jobs explicitly — a poisoned job
that cordons every device must end as ITS failure, not an infinite
requeue loop.

Workers are duck-typed (tests drive the scheduler with plain stubs):
``idx`` (int device tag), ``eligible(exclude)`` (alive, not cordoned,
not excluded), ``load()`` (queued jobs + unfinished pre-warm specs) and
``is_warm(bucket)`` (whether this worker has executed the bucket — a
locked accessor, because routing threads probe it while the worker
thread updates its residency set).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, FrozenSet, Optional, Sequence

from fastconsensus_tpu_torch.obs import counters as obs_counters
from fastconsensus_tpu_torch.obs import flight as obs_flight
from fastconsensus_tpu_torch.obs import latency as obs_latency


class NoEligibleWorker(RuntimeError):
    """Every worker for the tier is cordoned, dead, or excluded."""


class StickyScheduler:
    """Route buckets to workers; see the module docstring."""

    def __init__(self, spill_backlog: int = 8,
                 cost_weight: Optional[
                     Callable[[str], float]] = None) -> None:
        if spill_backlog < 0:
            raise ValueError(
                f"spill_backlog must be >= 0, got {spill_backlog}")
        self.spill_backlog = int(spill_backlog)
        # Per-bucket backlog weight (>= 1.0) from the static cost
        # model: ``spill_backlog`` counts JOBS, but a queued job of a
        # minutes-long bucket is not the backlog of a 10 ms one —
        # weighting the home's load by the bucket's modeled device
        # seconds (analysis/cost.py spill_weight) makes expensive
        # buckets spill off a busy home instead of serializing behind
        # it, while sub-second buckets keep weight 1.0 and route
        # exactly as before.  None = unweighted (weight 1.0).
        self._cost_weight = cost_weight
        self._affinity: Dict[str, int] = {}   # bucket key -> worker idx
        self._lock = threading.Lock()
        self._reg = obs_counters.get_registry()
        self._lat = obs_latency.get_latency_registry()

    def _weight(self, bucket: str) -> float:
        if self._cost_weight is None:
            return 1.0
        try:
            return max(float(self._cost_weight(bucket)), 1.0)
        except Exception:  # noqa: BLE001 — a broken cost model must
            return 1.0     # not take down routing

    def affinity(self) -> Dict[str, int]:
        """Snapshot of the bucket -> home-device map (``/healthz``)."""
        with self._lock:
            return dict(self._affinity)

    def route(self, bucket: str, workers: Sequence,
              exclude: FrozenSet[int] = frozenset(),
              n_jobs: int = 1):
        """The worker that should run the next batch of ``bucket``.

        ``workers`` is the tier's worker list (chip workers for normal
        buckets, mesh workers for huge ones — serve/pool.py picks the
        tier before calling); ``n_jobs`` is how many jobs the routed
        batch carries.  Raises :class:`NoEligibleWorker` when nothing
        can take the work.
        """
        candidates = [w for w in workers if w.eligible(exclude)]
        if not candidates:
            raise NoEligibleWorker(
                f"no eligible worker for bucket {bucket!r} "
                f"(excluded: {sorted(exclude)})")
        # fclat dispatch-rate tracking: together with the per-bucket
        # ARRIVAL rate marked at admission (serve/server.py submit),
        # this is the signal pair the fcshape control loop reads —
        # arrivals/s predicts the time-to-fill of a batch rung
        # (hold-for-coalesce) and dispatches/s is the honest drain rate
        # the deadline-shed math trusts.  Marked once PER JOB, not per
        # batch: a rung-8 batch drains eight jobs, and a batch-counted
        # rate would understate the drain by the mean occupancy —
        # shedding work an 8-wide pool was about to serve.
        for _ in range(max(int(n_jobs), 1)):
            self._lat.dispatches.mark(bucket)
        with self._lock:
            home_idx = self._affinity.get(bucket)
            home = next((w for w in candidates if w.idx == home_idx),
                        None)
            if home is not None and \
                    home.load() * self._weight(bucket) \
                    <= self.spill_backlog:
                self._reg.inc("serve.sched.sticky_hits")
                obs_flight.record("route", bucket=bucket,
                                  device=home.idx, via="sticky",
                                  n_jobs=n_jobs)
                return home
            # spill (home overloaded) or first/renewed assignment (no
            # home, or the home is cordoned/excluded): least-loaded,
            # warm-capable first
            warm = [w for w in candidates if w.is_warm(bucket)
                    and w is not home]
            pool = warm or [w for w in candidates if w is not home] \
                or candidates
            pick = min(pool, key=lambda w: (w.load(), w.idx))
            if home_idx is None:
                # sticky home minted where the bucket will first run
                self._affinity[bucket] = pick.idx
                self._reg.inc("serve.sched.assigns")
                via = "assign"
            elif home is None:
                # the recorded home is cordoned/excluded: re-home the
                # bucket where its work lands now
                self._affinity[bucket] = pick.idx
                self._reg.inc("serve.sched.rehomes")
                via = "rehome"
            else:
                self._reg.inc("serve.sched.spills")
                if not pick.is_warm(bucket):
                    self._reg.inc("serve.sched.spill_cold")
                via = "spill"
            obs_flight.record("route", bucket=bucket, device=pick.idx,
                              via=via, n_jobs=n_jobs)
            return pick
