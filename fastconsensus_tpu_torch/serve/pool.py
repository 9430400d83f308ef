"""fcpool: the worker pool behind ``ConsensusService``, the port's
counterpart of ``fastconsensus_tpu/serve/pool.py``.

* **one device-pinned worker thread per GPU** (:class:`DeviceWorker`):
  each worker enters ``torch.cuda.device(i)`` for its whole life and the
  service packs every slab of its jobs onto ``cuda:i`` explicitly (the
  port keeps no global default device), so prewarm probes, solo jobs and
  coalesced batches all run on ITS card.  With ``device="cpu"``,
  ``devices=k`` gives k workers that share the CPU: they stand in for
  the reference's fake XLA devices, so the pool's contracts run in the
  CPU tests.  The card always uses real ordinals;
* **the mesh-sharded "huge" tier** (:class:`MeshWorker`): the LAST
  ``huge_devices`` devices form a reserved group that runs jobs SOLO
  through ``run_consensus(mesh=...)`` with the slab edge-sharded across
  the group; buckets whose edge class exceeds ``chip_max_edges`` route
  there.  On CUDA the group takes real ordinals, so one GPU cannot hold
  a huge tier beside a serving chip; on the CPU the ``devices=k``
  workers share the host and the group's mesh lists the CPU once per
  member;
* **sticky bucket->device routing** (serve/scheduler.py): a dispatcher
  thread pops coalesced batches off the admission queue and routes each
  to the bucket's home worker within its tier; overflow spills to the
  least-loaded warm-capable worker;
* **failure isolation**: an exception that escapes a worker's batch
  machinery (the per-job try/excepts in serve/server.py absorb job-level
  errors; a CUDA kernel that fails to build fails its job and escapes,
  since every later job of the worker would fail the same way) cordons
  the worker, requeues its unfinished jobs with that device excluded
  (``Job.excluded_devices``), and lets the survivors carry the traffic.
  ``/healthz`` surfaces the cordon; a job that cordons every device
  fails as itself.

Observability: every worker tags its spans with ``device=i`` and owns a
thread-filtered :class:`analysis.CompileGuard` feeding
``serve.device.<i>.xla_compiles`` (on the port: the kernel builds the
worker ran), so ``/metricsz`` breaks builds, jobs and busy-time down per
device and the drain-time Perfetto trace renders one track per device.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import deque
from typing import Dict, FrozenSet, List, Optional, Sequence

from fastconsensus_tpu_torch.obs import counters as obs_counters
from fastconsensus_tpu_torch.obs import flight as obs_flight
from fastconsensus_tpu_torch.obs import latency as obs_latency
from fastconsensus_tpu_torch.serve.jobs import (STATE_FAILED, STATE_QUEUED,
                                                STATE_RUNNING, Job)
from fastconsensus_tpu_torch.serve.scheduler import (NoEligibleWorker,
                                                     StickyScheduler)
from fastconsensus_tpu_torch.serve.watchdog import (DISABLED_WATCHDOG,
                                                    HangWatchdog)

_logger = logging.getLogger("fastconsensus_tpu_torch")

def _cost_spill_weight():
    """The scheduler's per-bucket backlog weight from the cost mirror
    (analysis/cost.py spill_weight), or None when it cannot load —
    routing then stays unweighted, never broken."""
    try:
        from fastconsensus_tpu_torch.analysis import cost as _cost
        return _cost.spill_weight
    except Exception:  # noqa: BLE001 — optional model, mandatory pool
        return None


class _Worker:
    """One device-driving worker thread (base: queueing + lifecycle).

    The worker owns a deque of batches fed by the dispatcher, a
    long-lived thread-filtered CompileGuard (per-device compile
    attribution), and the residency/warmth bookkeeping the scheduler
    routes on.  Subclasses provide the device scope.
    """

    kind = "chip"

    def __init__(self, idx: int, service, pool) -> None:
        self.idx = idx
        self.service = service
        self.pool = pool
        self.cordoned = False
        self.error: Optional[str] = None
        self.jobs_done = 0
        self.batches_done = 0
        self.busy_s = 0.0
        self.warm_buckets: set = set()
        self.buckets: Dict[str, int] = {}   # residency: bucket -> jobs
        self.prewarm_specs: List[str] = []
        self.prewarm_left = 0
        self.tid: Optional[int] = None      # thread ident once running
        self._running = False               # mid-batch right now
        self._batches: "deque[List[Job]]" = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._started = False
        self._thread = threading.Thread(
            target=self._loop, name=f"fcpool-{self.kind}-{idx}",
            daemon=True)
        self._reg = obs_counters.get_registry()

    # -- scheduler interface ----------------------------------------

    def alive(self) -> bool:
        """Not yet started (pre-warm assignment runs before the threads
        do) or the thread is still running."""
        return not self._started or self._thread.is_alive()

    def eligible(self, exclude: FrozenSet[int] = frozenset()) -> bool:
        if self.idx in exclude or not self.alive():
            return False
        with self._cond:
            if self.cordoned:
                return False
            # a closed worker still drains its backlog, but routing new
            # work at one about to exit would strand the jobs
            return not (self._closed and not self._batches)

    def load(self) -> int:
        """Queued jobs + unfinished pre-warm specs (routing weight)."""
        with self._cond:
            return sum(len(b) for b in self._batches) + self.prewarm_left

    def queued_jobs(self) -> int:
        """Admitted jobs parked in this worker's deque (the admission
        bound's view — excludes pre-warm, which consumed no queue
        slot)."""
        with self._cond:
            return sum(len(b) for b in self._batches)

    def is_busy(self) -> bool:
        """Mid-batch or holding backlog — the fcshape hold-economics
        probe (serve/shaping.py set_busy_probe): while every worker is
        busy a held job would only have waited in a deque, so holding
        for coalescing costs nothing."""
        with self._cond:
            return self._running or bool(self._batches)

    # -- dispatcher interface ---------------------------------------

    def start(self) -> None:
        self._started = True
        self._thread.start()

    def enqueue(self, batch: List[Job]) -> None:
        for job in batch:
            # fclat: the dispatch phase closes when the job lands in a
            # worker's deque (stamped outside _cond — Job.stamp takes
            # the job's own lock, and keeping it out of the critical
            # section keeps _cond covering only the deque)
            job.stamp("enqueued")
        with self._cond:
            self._batches.append(batch)
            self._cond.notify()

    def close(self) -> None:
        """Finish the backlog, then exit (drain)."""
        with self._cond:
            self._closed = True
            self._cond.notify()

    def join(self, timeout: Optional[float]) -> bool:
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def note_job(self, bucket: str) -> None:
        """Residency bookkeeping (``bucket`` is the bucket key string),
        called by the service per finished job.  Guarded: ``describe``
        snapshots these maps from /healthz handler threads, and a dict
        iterated while this thread inserts raises RuntimeError."""
        with self._cond:
            self.jobs_done += 1
            self.warm_buckets.add(bucket)
            self.buckets[bucket] = self.buckets.get(bucket, 0) + 1

    def note_warm(self, bucket: str) -> None:
        """Mark a bucket warm on this worker (pre-warm path)."""
        with self._cond:
            self.warm_buckets.add(bucket)

    def is_warm(self, bucket: str) -> bool:
        """Whether this worker already ran (or pre-warmed) the bucket
        (the scheduler's warm-preference probe — a locked accessor, so
        routing threads never read the set mid-mutation)."""
        with self._cond:
            return bucket in self.warm_buckets

    def add_prewarm(self, spec: str) -> None:
        """Queue one pre-warm spec (called before ``start()``, but
        locked anyway: the field is read by the worker thread)."""
        with self._cond:
            self.prewarm_specs.append(spec)
            self.prewarm_left += 1

    # -- the worker loop --------------------------------------------

    def _device_scope(self):
        raise NotImplementedError

    def _next(self) -> Optional[List[Job]]:
        with self._cond:
            while True:
                if self._batches:
                    batch = self._batches.popleft()
                    self._coalesce(batch)
                    # busy flips on ATOMICALLY with the deque pop: a
                    # gap between "deque emptied" and "running set"
                    # would read as idle to the fcshape busy probe and
                    # spuriously abort a free hold mid-handoff
                    self._running = True
                    return batch
                if self._closed:
                    return None
                self._cond.wait()

    def _coalesce(self, batch: List[Job]) -> None:
        """Merge immediately-following same-group deque batches into
        ``batch`` up to ``max_batch`` (caller holds ``_cond``).

        The dispatcher pops eagerly — while this worker is busy, a
        same-bucket burst lands in the deque as single-job batches, and
        without this re-merge the cross-request coalescing win
        (serve/queue.py ``pop_batch``) would only survive when the
        admission heap itself ran deep.  Order is preserved: merging
        stops at the first batch of a different group, so nothing jumps
        the deque."""
        max_b = self.service.config.max_batch
        if max_b <= 1 or not batch:
            return
        group = batch[0].spec.batch_group()
        if any(j.spec.batch_group() != group for j in batch[1:]):
            return  # a mixed batch never merges (and never packs)
        merged = 0
        # fcheck: ok=guarded-field (the caller — _next — holds
        # self._cond across this whole merge; the lock is a documented
        # precondition of _coalesce, not re-taken to stay re-entrant)
        while self._batches and len(batch) < max_b:
            # fcheck: ok=guarded-field (same caller-held _cond contract)
            nxt = self._batches[0]
            if len(batch) + len(nxt) > max_b or \
                    any(j.spec.batch_group() != group for j in nxt):
                break
            batch.extend(self._batches.popleft())
            merged += 1
        if merged:
            self._reg.inc("serve.pool.deque_coalesced", merged)

    def _loop(self) -> None:
        from fastconsensus_tpu_torch.analysis import CompileGuard

        tid = threading.get_ident()
        with self._cond:
            # published for thread_names() (drain-time track naming),
            # which reads from the main thread
            self.tid = tid
        batch: Optional[List[Job]] = None
        guard = CompileGuard(
            registry=self._reg,
            counter=f"serve.device.{self.idx}.xla_compiles",
            thread_ident=tid)
        try:
            with self._device_scope(), guard:
                self._prewarm()
                while True:
                    batch = self._next()
                    if batch is None:
                        return
                    self._run(batch)
                    batch = None
                    self.service._flush_trace()
        except Exception as e:  # noqa: BLE001 — the worker is broken
            # (per-job failures never escape _run); isolate the device,
            # keep the pool serving
            self._die(e, batch)
        finally:
            with self._cond:
                busy = self.busy_s
            self._reg.gauge(f"serve.device.{self.idx}.busy_s",
                            round(busy, 6))

    def _prewarm(self) -> None:
        with self._cond:
            specs = list(self.prewarm_specs)
        for spec in specs:
            try:
                self.service._prewarm_one(spec, worker=self)
            except Exception as e:  # noqa: BLE001 — a bad warm spec
                # must not cordon a worker before it served anything
                self._reg.inc("serve.prewarm.failed")
                _logger.warning("fcserve pre-warm %r failed on device "
                                "%d: %s", spec, self.idx, e)
            with self._cond:
                self.prewarm_left -= 1
            self.pool.note_prewarm_done()

    def _run(self, batch: List[Job]) -> None:
        for job in batch:
            # fclat: deque_wait closes when the worker thread takes the
            # batch (after any _coalesce re-merge — ride-alongs merged
            # from later deque entries stamp here too)
            job.stamp("dequeued")
        obs_flight.record("dequeue", device=self.idx, n_jobs=len(batch))
        self.pool.watchdog.beat(self.idx, "dequeue",
                                n_jobs=len(batch))
        t0 = time.perf_counter()
        with self._cond:
            self._running = True
        try:
            self.service._drain_group(deque(batch), worker=self)
        finally:
            self.pool.watchdog.beat(self.idx, "idle")
            with self._cond:
                self._running = False
                self.busy_s += time.perf_counter() - t0
                self.batches_done += 1
                busy = self.busy_s
            self._reg.gauge(f"serve.device.{self.idx}.busy_s",
                            round(busy, 6))

    def _die(self, exc: Exception, batch: Optional[List[Job]]) -> None:
        with self._cond:
            self.cordoned = True
            self.error = f"{type(exc).__name__}: {exc}"
        self._reg.inc("serve.pool.worker_deaths")
        self._reg.inc(f"serve.device.{self.idx}.deaths")
        obs_flight.record("cordon", device=self.idx, reason="death",
                          error=f"{type(exc).__name__}: {exc}")
        _logger.exception(
            "fcpool worker %d (%s) died; cordoning the device and "
            "requeueing its jobs", self.idx, self.kind)
        pending: List[Job] = list(batch or ())
        with self._cond:
            while self._batches:
                pending.extend(self._batches.popleft())
        self._requeue_pending(pending)
        self.service._on_worker_death(self, exc)

    def cordon(self, reason: str) -> None:
        """Externally cordon this worker — the hang watchdog's
        cordon-on-stall path.  A hung worker cannot run its own
        ``_die`` (its thread is wedged inside a device call), so the
        WATCHDOG thread flips the cordon flag and requeues the deque
        backlog onto surviving devices with this one excluded.  The
        in-flight batch stays with the stuck thread: it either finishes
        late (the worker completes it but — cordoned — takes no new
        work) or never, and its jobs stay visible in the in-flight
        table either way."""
        with self._cond:
            if self.cordoned:
                return
            self.cordoned = True
            self.error = reason
            pending: List[Job] = []
            while self._batches:
                pending.extend(self._batches.popleft())
        self._reg.inc("serve.pool.worker_cordons")
        self._reg.inc(f"serve.device.{self.idx}.cordons")
        obs_flight.record("cordon", device=self.idx, reason="watchdog",
                          error=reason)
        _logger.warning(
            "fcpool worker %d (%s) cordoned: %s (requeueing %d backlog "
            "job(s))", self.idx, self.kind, reason, len(pending))
        self._requeue_pending(pending)

    def _requeue_pending(self, pending: List[Job]) -> None:
        """The shared cordon tail (worker death and watchdog cordon):
        re-admit this worker's unfinished backlog with the device
        excluded, so the survivors carry the traffic."""
        requeue = [j for j in pending
                   if j.state in (STATE_QUEUED, STATE_RUNNING)]
        for job in requeue:
            job.exclude_device(self.idx)
            job.mark(STATE_QUEUED)
        if requeue:
            self._reg.inc("serve.pool.requeued_jobs", len(requeue))
            obs_flight.record("requeue", device=self.idx,
                              n_jobs=len(requeue))
            self.pool.requeue(requeue)

    def describe(self) -> dict:
        # one atomic snapshot: /healthz handler threads call this while
        # the worker mutates the residency maps — iterating them
        # unlocked is the "dictionary changed size" crash class the
        # concurrency lint exists to catch
        alive = self.alive()
        with self._cond:
            return {
                "device": self.idx,
                "kind": self.kind,
                "alive": alive,
                "cordoned": self.cordoned,
                "error": self.error,
                "backlog": sum(len(b) for b in self._batches),
                "jobs": self.jobs_done,
                "batches": self.batches_done,
                "busy_s": round(self.busy_s, 3),
                "buckets": dict(self.buckets),
                "warm": sorted(self.warm_buckets),
                "prewarm_pending": self.prewarm_left,
            }


class DeviceWorker(_Worker):
    """A worker pinned to one device: a GPU, or the CPU (shared by every
    CPU worker)."""

    kind = "chip"

    def __init__(self, idx: int, device, service, pool) -> None:
        super().__init__(idx, service, pool)
        self.device = device

    def _device_scope(self):
        import torch

        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()


class MeshWorker(_Worker):
    """The huge-tier worker: drives a reserved group of devices as one
    mesh.

    Jobs here run SOLO through ``run_consensus(mesh=...)``: the batch
    path is single-device (``run_consensus_batch``), and huge graphs are
    bound by the device, not the dispatch.  The mesh's edge axis spans
    the whole group, so the slab shards across every reserved device;
    its ensemble axis stays 1, so any ``n_p`` is admissible.  Slabs are
    packed on the group's first device (``device``) and sharded from
    there."""

    kind = "mesh"

    def __init__(self, idx: int, devices: Sequence, service, pool) -> None:
        super().__init__(idx, service, pool)
        self.devices = list(devices)
        self.device = self.devices[0]
        self.mesh = None   # built on the worker thread, first use

    def _device_scope(self):
        from fastconsensus_tpu_torch import parallel

        self.mesh = parallel.make_mesh(ensemble=1, edge=len(self.devices),
                                       devices=self.devices)
        return contextlib.nullcontext()

    def describe(self) -> dict:
        out = super().describe()
        # the group's device ordinals (the worker idx is the first)
        out["mesh_devices"] = list(range(self.idx,
                                         self.idx + len(self.devices)))
        return out


class WorkerPool:
    """Dispatcher + workers + scheduler for one ``ConsensusService``.

    Built (and its device list resolved) inside ``start()`` so the
    torch-free paths — thin clients, ``-h`` — never import torch through
    the pool.  On CUDA it drives ``devices`` GPUs (default: every one
    ``torch.cuda.device_count()`` reports); on the CPU ``devices``
    workers (default 1) share the host.  The last ``huge_devices`` of
    them form the huge tier's mesh group.
    """

    def __init__(self, service) -> None:
        import torch

        self.service = service
        cfg = service.config
        base = service.device
        if base.type == "cuda":
            avail = torch.cuda.device_count()
            n = cfg.devices if cfg.devices is not None else avail
            if not 1 <= n <= avail:
                raise ValueError(
                    f"devices={cfg.devices} out of range 1..{avail}")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            n = cfg.devices if cfg.devices is not None else 1
            if n < 1:
                raise ValueError(f"devices={cfg.devices} must be >= 1")
            devices = [base] * n
        huge = int(cfg.huge_devices)
        if huge < 0 or (huge > 0 and huge >= n):
            raise ValueError(
                f"huge_devices={huge} must leave at least one serving "
                f"chip (devices={n})")
        if cfg.chip_max_edges is not None and huge < 1:
            raise ValueError(
                "chip_max_edges needs a huge tier: set huge_devices >= 1")
        if huge >= 1 and cfg.chip_max_edges is None:
            # without a ceiling no bucket ever routes huge, so the
            # reserved mesh group would sit idle forever
            raise ValueError(
                "huge_devices reserves a mesh group nothing can reach: "
                "set chip_max_edges (the single-chip bucket ceiling)")
        self._reg = obs_counters.get_registry()
        self.scheduler = StickyScheduler(
            spill_backlog=cfg.spill_backlog,
            cost_weight=_cost_spill_weight())
        # the LAST huge_devices devices form the reserved mesh group;
        # chip workers take the rest (device ordinal == worker idx ==
        # the fcobs `device=` tag)
        self.chip_workers: List[DeviceWorker] = [
            DeviceWorker(i, devices[i], service, self)
            for i in range(n - huge)]
        self.mesh_workers: List[MeshWorker] = []
        if huge:
            self.mesh_workers.append(
                MeshWorker(n - huge, devices[n - huge:n], service, self))
        self.workers: List[_Worker] = \
            list(self.chip_workers) + list(self.mesh_workers)
        self._prewarm_total = 0
        self._prewarm_done = 0
        self._prewarm_lock = threading.Lock()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="fcpool-dispatch",
            daemon=True)
        # fcflight: the hang watchdog thread (serve/watchdog.py) — the
        # disabled singleton keeps every beat/describe call site
        # unconditional, like the disabled tracer
        wd_cfg = cfg.watchdog
        if wd_cfg is not None and wd_cfg.enabled:
            self.watchdog = HangWatchdog(
                obs_latency.get_latency_registry(), wd_cfg,
                on_trip=service._on_watchdog_trip)
        else:
            self.watchdog = DISABLED_WATCHDOG

    # -- lifecycle ---------------------------------------------------

    def start(self) -> None:
        # admitted work the dispatcher already moved into worker deques
        # still counts against the queue's depth bound — eager dispatch
        # must not hollow out the 429 backpressure contract
        self.service.queue.set_extra_depth(self.backlog)
        self._assign_prewarm()
        for w in self.workers:
            w.start()
        self._dispatcher.start()
        self.watchdog.start()
        self._reg.gauge("serve.pool.workers", len(self.workers))

    def backlog(self) -> int:
        """Admitted-but-undispatched jobs across every worker deque
        (the queue's ``extra_depth`` hook; running jobs don't count —
        they hold no admission slot, exactly as before the pool)."""
        return sum(w.queued_jobs() for w in self.workers)

    def chips_all_busy(self) -> bool:
        """True when no eligible chip worker sits idle — the fcshape
        busy probe: a hold-for-coalesce window is free exactly while
        the head job could not have started anywhere anyway.  An EMPTY
        eligible set (every chip cordoned) reports False: nothing can
        serve a held job, so holding buys latency on a path already
        headed for NoEligibleWorker.  Called under the admission
        queue's condition; worker locks are always taken after it (the
        documented extra_depth ordering)."""
        eligible = [w for w in self.chip_workers if w.eligible()]
        return bool(eligible) and all(w.is_busy() for w in eligible)

    def drain(self, timeout: Optional[float]) -> bool:
        """Join the dispatcher and every worker (the queue must already
        be closed — ConsensusService.begin_drain).  True = all exited."""
        # no trips during shutdown: a drain that exceeds its deadline is
        # the DRAIN-TIMEOUT incident (its own bundle), not a hang
        self.watchdog.stop()
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        remaining = lambda: (None if deadline is None else  # noqa: E731
                             max(0.0, deadline - time.monotonic()))
        self._dispatcher.join(remaining())
        ok = not self._dispatcher.is_alive()
        for w in self.workers:
            ok = w.join(remaining()) and ok
        return ok

    # -- pre-warm distribution ---------------------------------------

    def _assign_prewarm(self) -> None:
        """Distribute ``--warm`` specs across workers through the
        scheduler, so each bucket warms on the device the routing will
        later send its traffic to (the sticky home IS minted here, before
        the first request)."""
        from fastconsensus_tpu_torch.serve import bucketer

        for spec in self.service.config.prewarm:
            self._prewarm_total += 1
            key = spec.partition(":")[0]
            try:
                bucket = bucketer.bucket_from_key(key)
                worker = self.route_bucket(bucket.key(),
                                           huge=self._is_huge(bucket))
            except (ValueError, NoEligibleWorker):
                # unparseable/ineligible specs still consume a slot so
                # /healthz progress adds up; the worker's warm-time
                # error path owns the counting and the log line
                worker = self.workers[0]
            worker.add_prewarm(spec)

    def note_prewarm_done(self) -> None:
        with self._prewarm_lock:
            self._prewarm_done += 1

    def prewarm_progress(self) -> dict:
        with self._prewarm_lock:
            done = self._prewarm_done
        return {"specs": self._prewarm_total, "done": done,
                "finished": done >= self._prewarm_total}

    # -- routing ------------------------------------------------------

    def _is_huge(self, bucket) -> bool:
        ceiling = self.service.config.chip_max_edges
        return bool(self.mesh_workers) and ceiling is not None \
            and bucket.e_class > ceiling

    def _classify(self, job: Job):
        """(bucket key, huge?) for routing; specs the bucketer rejects
        route anywhere (they will fail as their own job at pack time)."""
        try:
            bucket = job.spec.bucket()
            return bucket.key(), self._is_huge(bucket)
        except Exception:  # noqa: BLE001 — routing must never reject
            return f"solo:{job.job_id}", False

    def route_bucket(self, bucket_key: str, huge: bool,
                     exclude: FrozenSet[int] = frozenset(),
                     n_jobs: int = 1) -> _Worker:
        tier = self.mesh_workers if huge else self.chip_workers
        return self.scheduler.route(bucket_key, tier, exclude=exclude,
                                    n_jobs=n_jobs)

    def dispatch(self, batch: List[Job]) -> None:
        """Route one coalesced pop.  Jobs requeued after a worker death
        carry per-job exclusion sets and may mix batch groups (several
        deque batches die together), so the batch splits by (bucket,
        exclusions, batch group) — uniform for normal traffic, and a
        requeued mix can never pack different configs into one batched
        device call."""
        groups: Dict[tuple, List[Job]] = {}
        for job in batch:
            bucket_key, huge = self._classify(job)
            try:
                group = job.spec.batch_group()
            except Exception:  # noqa: BLE001 — routing must never
                group = f"solo:{job.job_id}"   # reject (packs solo)
            sig = (bucket_key, huge, job.excluded(), group)
            groups.setdefault(sig, []).append(job)
        for (bucket_key, huge, exclude, _group), jobs in groups.items():
            try:
                worker = self.route_bucket(bucket_key, huge,
                                           exclude=exclude,
                                           n_jobs=len(jobs))
            except NoEligibleWorker as e:
                for job in jobs:
                    job.mark(STATE_FAILED, error=str(e))
                    self._reg.inc("serve.jobs.failed")
                    # an SLO miss, not a gap: during a full cordon the
                    # attainment counters must crater with the traffic
                    self.service._record_timeline(job, failed=True)
                _logger.warning(
                    "fcpool: failed %d job(s) of bucket %s: %s",
                    len(jobs), bucket_key, e)
                continue
            worker.enqueue(jobs)

    def requeue(self, jobs: List[Job]) -> None:
        """Re-dispatch a dead worker's unfinished jobs directly (the
        admission queue may already be closed and drained mid-shutdown,
        so requeues never pass through it)."""
        now = time.monotonic()
        for job in jobs:
            # requeues bypass the admission queue's pop, so the fclat
            # dispatch checkpoint is re-stamped here: the retry's
            # timeline re-opens at routing, not at a stale first pop
            # (and not at a stale first hold — hold re-stamps to 0)
            job.stamp_hold(now)
            job.stamp("dispatched", at=now)
        self.dispatch(list(jobs))

    # -- the dispatcher ----------------------------------------------

    def _dispatch_loop(self) -> None:
        service = self.service
        while True:
            batch = None
            try:
                batch = service.queue.pop_batch(
                    service.config.max_batch,
                    group_key=service._group_key)
                if batch is None:
                    break  # queue closed and drained
                self.dispatch(batch)
            except Exception as e:  # noqa: BLE001 — the dispatcher is
                # the pool's only feed: one poisoned pop must fail its
                # own batch, not silently kill the thread and starve
                # every worker behind a healthy-looking queue
                self._reg.inc("serve.pool.dispatch_errors")
                for job in (batch or []):
                    job.mark(STATE_FAILED,
                             error=f"dispatch: {type(e).__name__}: {e}")
                    self._reg.inc("serve.jobs.failed")
                    self.service._record_timeline(job, failed=True)
                _logger.exception(
                    "fcpool: dispatch error, failed %d job(s)",
                    len(batch or []))
        for w in self.workers:
            w.close()

    # -- introspection ------------------------------------------------

    def worker_for(self, idx: int) -> Optional[_Worker]:
        """Worker by device ordinal (the watchdog trip dict's
        ``device`` field) — the cordon-on-stall lookup."""
        for w in self.workers:
            if w.idx == idx:
                return w
        return None

    def describe(self) -> List[dict]:
        return [w.describe() for w in self.workers]

    def thread_names(self) -> Dict[int, str]:
        """Raw thread ident -> display name, for the drain-time Perfetto
        export (one named track per device)."""
        return {w.tid: (f"device-{w.idx}" if w.kind == "chip"
                        else f"mesh-{w.idx}")
                for w in self.workers if w.tid is not None}
