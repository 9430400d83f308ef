"""fcserve: a long-lived consensus service over ``run_consensus``, the
port's counterpart of ``fastconsensus_tpu/serve/server.py`` with the same
class names, counter names and HTTP payloads (the reference's
``ServeClient`` reads a port replica, and the port's reads the
reference's).

One resident process keeps the device warm across requests:

* requests are padded onto canonical shape buckets (serve/bucketer.py),
  so any two graphs of one bucket have equal slab statics and stack into
  one batch;
* queued same-bucket jobs COALESCE: a worker takes up to ``max_batch``
  same-group jobs at once (serve/queue.pop_batch) and drives them as ONE
  member-batched device stream (``consensus.run_consensus_batch``) at
  batch-ladder rungs {1, 2, 4, 8}, each job's result its solo run's;
* identical work is answered from a content-addressed LRU+TTL result
  cache (serve/cache.py) without touching the device at all;
* admission control is explicit: a bounded priority queue
  (serve/queue.py) rejects overload with backpressure (HTTP 429),
  oversized graphs are refused up front (413), and a draining server
  says so (503) — accepted work always finishes;
* admission is SLO-shaped (serve/shaping.py): EDF within a priority, a
  deadline-bounded hold for predicted same-bucket arrivals, a derived
  Retry-After, and shedding at submit of a job that provably cannot
  meet its deadline;
* fcdelta (``submit_delta``): a child graph of a cached parent runs
  warm-started from the parent's partitions with the moves restricted
  to the changed edges' neighborhood (``run_consensus(init_labels=,
  active_mask=)``), when the policy allows;
* graphs past the single-chip bucket ceiling (``chip_max_edges``) route
  to a reserved mesh group (``huge_devices``) and run solo and
  edge-sharded (``run_consensus(mesh=)``, the "huge" tier) instead of
  413-ing.

Every job runs on an explicit ``torch.device``: ``ServeConfig.device``
(default ``"cuda"``, resolved by ``utils/env.resolve_device``, which
never falls back), one worker per GPU (serve/pool.py), each packing its
slabs onto its own card.  Compiles are counted with
``analysis.CompileGuard``; on the port that is the CUDA kernels' ``nvcc``
builds (and the host library's ``g++`` build) a worker runs, so a cold
worker's first job counts them and every later job counts 0.  The
counter and field names stay the reference's (``serve.xla_compiles``,
``compiles``).

Threading model: HTTP handler threads (stdlib ``ThreadingHTTPServer``)
only touch the queue / cache / jobs table; the device side is the
**fcpool worker pool** (serve/pool.py), fed by a dispatcher that pops
coalesced batches and routes them by sticky bucket->device affinity
(serve/scheduler.py).  A worker that dies mid-batch is cordoned
(visible in ``/healthz``) and its jobs requeue with that device
excluded.

Shutdown: SIGTERM (serve/__main__.py) closes the queue, finishes every
admitted job, spills the result cache (``cache_path``), optionally
exports the server's own fcobs trace artifacts (``--trace-dir``), and
exits 0 — a graceful drain, never dropped work.

The whole front end is stdlib-only (http.server / json / urllib on the
client side).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import math
import os
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from fastconsensus_tpu_torch.cli import ALGORITHMS, DEFAULT_TAU
from fastconsensus_tpu_torch.obs import counters as obs_counters
from fastconsensus_tpu_torch.obs import flight as obs_flight
from fastconsensus_tpu_torch.obs import latency as obs_latency
from fastconsensus_tpu_torch.obs import postmortem as obs_postmortem
from fastconsensus_tpu_torch.obs.tracer import get_tracer
from fastconsensus_tpu_torch.ops.row_kernels import KernelBuildError
from fastconsensus_tpu_torch.serve import bucketer
from fastconsensus_tpu_torch.serve.jobs import (PRIORITY_BATCH,
                                                PRIORITY_INTERACTIVE,
                                                PRIORITY_NAMES,
                                                PRIORITY_NORMAL, SLO_CLASSES,
                                                STATE_DONE, STATE_FAILED,
                                                STATE_QUEUED, STATE_RUNNING,
                                                Job, JobSpec, hash_canonical)
from fastconsensus_tpu_torch.serve.queue import (AdmissionQueue, DeadlineShed,
                                                 QueueClosed, QueueFull)
from fastconsensus_tpu_torch.serve.cache import ResultCache
from fastconsensus_tpu_torch.serve.delta import (DeltaError, DeltaPolicy,
                                                 ParentNotCached)
from fastconsensus_tpu_torch.serve.shaping import ShapingConfig, TrafficShaper
from fastconsensus_tpu_torch.serve.watchdog import WatchdogConfig

_logger = logging.getLogger("fastconsensus_tpu_torch")

# Finished-job retention (status/result remain queryable this long after
# completion); bounded so the jobs table cannot grow without limit.
MAX_RETAINED_JOBS = 4096
# Resident-memory bound on the server's own tracer (--trace-dir): spans
# stream to the .jsonl continuously; once this many have streamed, the
# in-memory list resets (the drain-time Perfetto blob then covers the
# recent window — the full history lives in the .jsonl).
TRACE_EVENT_WINDOW = 20_000


class GraphTooLarge(ValueError):
    """Admission refused before queueing (HTTP 413)."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Operator knobs for one service instance."""

    queue_depth: int = 64
    cache_entries: int = 256
    cache_ttl_s: float = 3600.0
    max_nodes: int = 1 << 20
    max_edges: int = 1 << 22
    drain_timeout_s: float = 300.0
    # The device the workers run on ("cuda": one worker per GPU; "cpu":
    # ``devices`` workers sharing the host).  Resolved by
    # utils/env.resolve_device: asking for CUDA without it raises.
    device: str = "cuda"
    # The reference pins its adaptive executable sizing while serving
    # (env defaults set in start(); an operator-set env var wins):
    # FCTPU_DETECT_CALL_MEMBERS=0 switches its member splitting off.
    # start() sets the same default, but the port reads that knob only
    # as the detect cache's driver chunk, which a served run never uses:
    # its member chunks stay on the FCTPU_ENSEMBLE_BUDGET_MB memory
    # budget (sizing.members_per_call), which bounds a batch's memory,
    # and chunking does not change partitions.  The reference's other
    # pin, FCTPU_ROUNDS_BLOCK=8, is not set: the port's block size does
    # not depend on the host's speed unless FCTPU_ROUNDS_BLOCK=auto asks
    # (consensus.rounds_block_size), and on the card a block's graph
    # captures cost served jobs more than the blocks save.
    pin_sizing: bool = True
    # Where drain() writes the server's own fcobs artifacts
    # (fcserve_trace.json + .jsonl); None = no server-side tracing.
    trace_dir: Optional[str] = None
    # Most-recent-samples window applied to the process-global fcobs
    # series registry at start() (ObsRegistry.set_series_limit): a
    # resident server observes per-job/per-round latencies forever, and
    # unbounded sample lists are a slow leak.  0/None disables.
    series_window: Optional[int] = 4096
    # Cross-request batching: the worker coalesces up to this many
    # queued same-group jobs (same bucket, same config-but-seed —
    # jobs.JobSpec.batch_group) into ONE batched device call
    # (consensus.run_consensus_batch), executed at batch-ladder rungs
    # (bucketer.BATCH_LADDER).
    # 1 disables coalescing (every job runs solo).
    max_batch: int = 8
    # Persist the content-addressed result cache across restarts: loaded
    # at start(), spilled on graceful drain (ResultCache.spill/load).
    # A restarted server answers repeats of pre-restart work as cache
    # hits without touching the device.  None = in-memory only.
    cache_path: Optional[str] = None
    # fcfleet: ALSO spill the cache every this-many seconds while
    # serving (ResultCache.spill_if_dirty — skipped when nothing
    # changed, never concurrent with the drain spill).  A drain-only
    # spill means a SIGKILLed replica's cache dies with it; the
    # periodic spill is what lets a fleet successor inherit it
    # (serve/fleet.py on_death -> POST /cachez/load).  Requires
    # cache_path; None/0 disables (the pre-fcfleet posture).
    cache_spill_s: Optional[float] = None
    # Pre-warm bucket specs ("n64_e96" or "n64_e96:4"): before serving,
    # the worker drives deterministic probe graphs through the solo path
    # and the batch ladder up to the given rung (default: max_batch) —
    # on the card a cold worker builds its CUDA kernels there, so the
    # first request into a warmed bucket builds nothing.
    prewarm: Tuple[str, ...] = ()
    # ConsensusConfig field overrides for the pre-warm probes (e.g.
    # {"n_p": 50, "algorithm": "leiden"}).
    prewarm_config: Optional[Dict[str, Any]] = None
    # Multi-device serving (serve/pool.py): how many workers the pool
    # runs (None = one per GPU on CUDA, 1 on the CPU).
    devices: Optional[int] = None
    # Devices reserved (off the END of the device list) for the
    # mesh-sharded "huge" tier.  0 disables the tier.  On CUDA these are
    # real ordinals; on the CPU the workers share the host.
    huge_devices: int = 0
    # Single-chip bucket ceiling: buckets whose edge class exceeds this
    # route to the huge tier (edge-sharded across the reserved mesh
    # group) instead of a single device.  Requires huge_devices >= 1.
    # None = every admitted bucket runs single-device (the max_edges
    # 413 bound still applies either way).
    chip_max_edges: Optional[int] = None
    # Sticky-affinity spill threshold (serve/scheduler.py): a bucket's
    # batches leave their home device only when the home has more than
    # this many jobs queued.
    spill_backlog: int = 8
    # SLO-aware traffic shaping (serve/shaping.py): EDF admission
    # ordering, the adaptive hold-for-coalesce window, and
    # deadline-aware shedding with derived Retry-After.  The default
    # config enables all three arms; ShapingConfig is frozen, so the
    # shared default instance is safe.
    shaping: ShapingConfig = ShapingConfig()
    # fcflight hang watchdog (serve/watchdog.py): heartbeat-based
    # wedged-device detection with cordon-on-stall.  None or
    # enabled=False disables the watchdog thread entirely (the
    # DISABLED_WATCHDOG no-op keeps every call site unconditional).
    watchdog: Optional[WatchdogConfig] = WatchdogConfig()
    # Where post-mortem bundles land (obs/postmortem.py): None falls
    # back to $FCTPU_FLIGHT_DIR, else ./fcflight.
    flight_dir: Optional[str] = None
    # fcdelta warm-start vs full-run thresholds (serve/delta.py): the
    # delta-size ceiling and the parent-quality floors an incremental
    # submission must clear; every tripped rule stamps its name as the
    # fallback ``reason``.  Frozen, so the shared default is safe.
    delta_policy: DeltaPolicy = DeltaPolicy()


def _trace_aux(job) -> Dict[str, Any]:
    """fctrace: the flight-event aux carrying a job's trace id — empty
    when the submission carried none, so untraced traffic's events stay
    byte-identical to before this field existed."""
    trace = getattr(job.spec, "trace", None)
    return {"trace": trace} if trace else {}


def validate_warm_specs(config: ServeConfig) -> None:
    """Fail fast on ``--warm`` specs the running server could never use.

    Checked at server START (raises ValueError -> the CLI exits 2)
    rather than logged at warm time, because each bad shape silently
    wastes a pre-warm no request can reach: a malformed/off-grid key, a
    rung < 1, a bucket outside the admission bounds (no request can
    ever land there), or a bucket past the single-chip ceiling — the
    mesh tier serves those solo and edge-sharded, so a single-device
    ladder pre-warm for them warms paths no job will take.
    """
    from fastconsensus_tpu_torch import sizing

    n_cap = sizing.grid_up(config.max_nodes, bucketer.MIN_NODE_CLASS)
    e_cap = sizing.grid_up(config.max_edges, bucketer.MIN_EDGE_CLASS)
    for spec in config.prewarm:
        key, _, b = spec.partition(":")
        if b and (not b.isdigit() or int(b) < 1):
            raise ValueError(
                f"--warm {spec!r}: rung must be an integer >= 1")
        bucket = bucketer.bucket_from_key(key)   # off-grid -> ValueError
        if bucket.n_class > n_cap or bucket.e_class > e_cap:
            raise ValueError(
                f"--warm {spec!r}: bucket {bucket.key()} is outside the "
                f"admission bounds (max_nodes={config.max_nodes}, "
                f"max_edges={config.max_edges} admit buckets up to "
                f"n{n_cap}_e{e_cap}); no request can ever land in it")
        if config.chip_max_edges is not None and \
                bucket.e_class > config.chip_max_edges:
            raise ValueError(
                f"--warm {spec!r}: bucket {bucket.key()} exceeds the "
                f"single-chip ceiling ({config.chip_max_edges} edges); "
                f"its traffic routes to the mesh tier, which runs solo "
                f"edge-sharded — a single-device ladder pre-warm there "
                f"warms paths no job will take")


class ConsensusService:
    """The queue -> bucket -> cache -> ``run_consensus`` pipeline."""

    def __init__(self, config: Optional[ServeConfig] = None) -> None:
        from fastconsensus_tpu_torch.utils.env import resolve_device

        self.config = config or ServeConfig()
        # the base device (cuda:0 / cpu): where embedded run_spec calls
        # run; pool workers pack onto their own card
        self.device = resolve_device(self.config.device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", 0)
        self.queue = AdmissionQueue(self.config.queue_depth,
                                    edf=self.config.shaping.edf)
        self.shaper = TrafficShaper(self.config.shaping)
        if self.config.shaping.hold and self.config.max_batch > 1:
            self.queue.set_shaper(self.shaper)
        self.cache = ResultCache(max_entries=self.config.cache_entries,
                                 ttl_seconds=self.config.cache_ttl_s)
        self._jobs: "OrderedDict[str, Job]" = OrderedDict()
        self._lock = threading.Lock()
        self.pool = None   # serve/pool.WorkerPool, built in start()
        self._tracer = None
        self._trace_lock = threading.Lock()
        self._trace_jsonl: Optional[str] = None
        self._streamed_events = 0
        self._buckets: Dict[str, int] = {}
        self._started_at = time.time()
        self._reg = obs_counters.get_registry()
        self._lat = obs_latency.get_latency_registry()
        self._batch_seq = itertools.count(1)
        self._prewarm_total = len(self.config.prewarm)
        self._prewarm_done = 0
        self._prewarm_finished = self._prewarm_total == 0
        # fcflight: last post-mortem bundle path (guarded by self._lock
        # — the watchdog thread writes it, /healthz handlers read it)
        self._last_bundle: Optional[str] = None
        # fcfleet periodic cache spill (cache_spill_s): stopped by
        # drain() before the final drain-time spill
        self._spill_stop = threading.Event()
        self._spill_thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------

    def start(self) -> "ConsensusService":
        """Build the device worker pool and launch it (idempotent).

        Raises ValueError on a config the server could never serve
        correctly — ``--warm`` specs past the admission bounds or the
        single-chip ceiling, or a huge tier without its ceiling (and the
        mirror) — at start, not on first traffic."""
        if self.pool is not None:
            return self
        validate_warm_specs(self.config)
        if self.config.pin_sizing:
            os.environ.setdefault("FCTPU_DETECT_CALL_MEMBERS", "0")
        if self.config.series_window:
            self._reg.set_series_limit(self.config.series_window)
        if self.config.trace_dir:
            from fastconsensus_tpu_torch.obs import Tracer, set_tracer

            os.makedirs(self.config.trace_dir, exist_ok=True)
            self._trace_jsonl = os.path.join(self.config.trace_dir,
                                             "fcserve_trace.json.jsonl")
            open(self._trace_jsonl, "w", encoding="utf-8").close()
            self._tracer = Tracer()
            set_tracer(self._tracer)
        if self.config.cache_path and \
                os.path.exists(self.config.cache_path):
            n = self.cache.load(self.config.cache_path)
            _logger.info("fcserve: reloaded %d cached result(s) from %s",
                         n, self.config.cache_path)
        if self.config.cache_path and self.config.cache_spill_s:
            self._spill_thread = threading.Thread(
                target=self._spill_loop, name="fcserve-cache-spill",
                daemon=True)
            self._spill_thread.start()
        from fastconsensus_tpu_torch.serve.pool import WorkerPool

        self.pool = WorkerPool(self)
        self.pool.start()
        # Retry-After / shed math divides queued work across the chips
        # actually draining it; the callable re-counts per decision so
        # cordoned workers stop flattering the estimate.
        pool = self.pool
        self.shaper.set_parallelism(
            lambda: sum(1 for w in pool.chip_workers if w.eligible()))
        # hold economics: pop_batch may hold only while every chip is
        # already occupied (the held job would have waited in a deque
        # anyway) — an idle chip turns every held millisecond into
        # real added latency, so the shaper bypasses then
        self.shaper.set_busy_probe(pool.chips_all_busy)
        if self.config.chip_max_edges is not None:
            # huge-tier buckets run SOLO on the mesh group whatever the
            # pop size — holding them coalesces nothing
            self.shaper.set_solo_probe(
                lambda key: pool._is_huge(bucketer.bucket_from_key(key)))
        return self

    def _spill_loop(self) -> None:
        """fcfleet periodic cache persistence (``cache_spill_s``): the
        crash-survival complement to the drain-time spill — a replica
        killed without a drain still leaves a recent npz for the ring
        successor to inherit.  ``spill_if_dirty`` makes the idle loop
        free (no write when nothing changed) and yields to a
        concurrent drain spill instead of double-writing."""
        while not self._spill_stop.wait(self.config.cache_spill_s):
            try:
                n = self.cache.spill_if_dirty(self.config.cache_path)
                if n > 0:
                    _logger.debug("fcserve: periodic spill wrote %d "
                                  "cached result(s)", n)
            except OSError:
                # same contract as the drain spill: persistence is an
                # optimization and a full disk must not kill serving
                self._reg.inc("serve.cache.persist_write_failed")
                _logger.exception(
                    "fcserve: periodic cache spill failed; continuing")

    def begin_drain(self) -> None:
        """Stop admissions; already-admitted jobs keep running."""
        self.queue.close()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: close intake, finish every admitted job on
        every worker, export ONE merged trace with per-device tracks
        (``trace_dir``).  True = fully drained."""
        self.begin_drain()
        # stop the periodic spill loop BEFORE the final spill below: the
        # drain-time write must be the last one (spill_if_dirty would
        # skip on the shared lock anyway, but a loop outliving drain
        # could resurrect the file after an operator removed it)
        self._spill_stop.set()
        if self._spill_thread is not None:
            self._spill_thread.join(timeout=5.0)
            self._spill_thread = None
        ok = True
        if self.pool is not None:
            ok = self.pool.drain(timeout if timeout is not None
                                 else self.config.drain_timeout_s)
        if ok:
            if self.config.cache_path:
                try:
                    n = self.cache.spill(self.config.cache_path)
                    _logger.info(
                        "fcserve: spilled %d cached result(s) to %s",
                        n, self.config.cache_path)
                except OSError:
                    # a full/unwritable disk must not turn a clean drain
                    # into exit 1 — the cache is an optimization, the
                    # drain contract is the product
                    self._reg.inc("serve.cache.persist_write_failed")
                    _logger.exception(
                        "fcserve: cache spill failed; draining anyway")
            self._export_trace()
        else:
            # some worker is STILL RUNNING a job: exporting now would
            # race its per-batch _flush_trace on the stream index and
            # the .jsonl file (duplicate/desynced records); the streamed
            # .jsonl up to the last finished batch is already on disk
            _logger.warning(
                "fcserve drain timed out with a job in flight; "
                "skipping trace export (streamed .jsonl is intact)")
            # a drain that refuses to finish IS an incident: dump the
            # in-flight table, thread stacks and event rings while the
            # wedged state still exists to photograph
            self.write_bundle("drain_timeout")
        return ok

    # -- fcflight incident hooks --------------------------------------

    def bundle_sections(self) -> Dict[str, Any]:
        """The serving layer's post-mortem sections (obs/postmortem.py
        adds flight/counters/latency/stacks on top): the resolved
        config, the in-flight jobs table with per-job phase timelines,
        and the pool / scheduler / queue / watchdog / shaping state."""
        sections: Dict[str, Any] = {
            "config": dataclasses.asdict(self.config),
            "jobs": self._jobs_section(),
        }
        try:
            sections["queue"] = {
                "depth": self.queue.depth(),
                "total_depth": self.queue.total_depth(),
                "max_depth": self.queue.max_depth,
                "draining": self.queue.draining(),
            }
            if self.pool is not None:
                sections["pool"] = self.pool.describe()
                sections["scheduler"] = {
                    "affinity": self.pool.scheduler.affinity()}
                sections["watchdog"] = self.pool.watchdog.describe()
            sections["shaping"] = self.shaping_stats()
        except Exception as exc:  # noqa: BLE001 — a half-wedged server
            # must still dump what it can collect
            sections["sections_error"] = {"error": repr(exc)}
        return sections

    def _jobs_section(self) -> Dict[str, Any]:
        """In-flight jobs with open-ended phase timelines — the bundle
        row the reader prints as 'where is this job's lifetime
        accumulating' (a wedged job shows device=312.4s)."""
        with self._lock:
            jobs = list(self._jobs.values())
        rows: List[Dict[str, Any]] = []
        for j in jobs:
            if j.state not in (STATE_QUEUED, STATE_RUNNING):
                continue
            try:
                bucket = j.spec.bucket().key()
            except Exception:  # noqa: BLE001 — unbucketable specs
                bucket = "-"   # still belong in the incident table
            rows.append({
                "job_id": j.job_id,
                "state": j.state,
                "trace": j.spec.trace,
                "bucket": bucket,
                "priority": j.spec.priority,
                "device": j.device,
                "batch_id": j.batch_id,
                "requeues": j.requeues,
                "phases_s": {k: round(v, 6)
                             for k, v in j.phases_so_far().items()},
            })
        return {"tracked": len(jobs), "in_flight": len(rows),
                "jobs": rows}

    def write_bundle(self, reason: str) -> Optional[str]:
        """Dump one post-mortem bundle (never raises — an incident dump
        that throws during the incident is worse than none)."""
        try:
            path = obs_postmortem.write_bundle(
                reason, self.bundle_sections(),
                base_dir=self.config.flight_dir)
        except Exception:  # noqa: BLE001
            _logger.exception("fcflight: bundle write failed (reason=%s)",
                              reason)
            return None
        self._reg.inc("serve.flight.bundles")
        obs_flight.record("bundle", reason=reason, path=path)
        with self._lock:
            self._last_bundle = path
        _logger.warning("fcflight: post-mortem bundle written to %s "
                        "(reason=%s)", path, reason)
        return path

    def _on_watchdog_trip(self, trip: Dict[str, Any]) -> None:
        """Watchdog-thread callback, once per suspect episode: count,
        record, bundle, then cordon through the worker-death machinery (unless
        ``watchdog.cordon=False`` — observe-only)."""
        wd = self.config.watchdog
        cordon = wd is not None and wd.cordon
        self._reg.inc("serve.flight.watchdog_trips")
        obs_flight.record("watchdog_trip", job=trip.get("job"),
                          device=trip.get("device"),
                          bucket=trip.get("bucket"),
                          elapsed_s=trip.get("elapsed_s"),
                          threshold_s=trip.get("threshold_s"))
        _logger.error(
            "fcflight watchdog: device %s wedged %.1fs inside a device "
            "call (threshold %.1fs, job %s)%s", trip.get("device"),
            trip.get("elapsed_s") or 0.0, trip.get("threshold_s") or 0.0,
            trip.get("job"), "; cordoning" if cordon else
            " (observe-only: cordon disabled)")
        self.write_bundle(f"watchdog_d{trip.get('device')}")
        if cordon and self.pool is not None:
            worker = self.pool.worker_for(trip["device"])
            if worker is not None:
                worker.cordon(
                    f"hang watchdog: device call exceeded "
                    f"{trip.get('threshold_s')}s (job {trip.get('job')})")

    def _on_worker_death(self, worker, exc: Exception) -> None:
        """Pool callback after a worker's ``_die`` cordoned it and
        requeued its backlog: photograph the process while the broken
        state is fresh."""
        self.write_bundle(f"worker_death_d{worker.idx}")

    def slowest(self, limit: int = 8) -> Dict[str, Any]:
        """The ``/debugz/slowest`` payload: the worst ``serve.e2e``
        exemplars (job id + latency, per bucket/rung/device tags)
        joined to their retained flight-recorder timelines and — while
        the jobs table still holds them — their phase breakdowns.  The
        answer to "why was THIS request the p99"."""
        snap = self._lat.snapshot()
        rows: List[Dict[str, Any]] = []
        for h in snap.get("histograms", ()):
            if h.get("name") != "serve.e2e":
                continue
            tags = h.get("tags") or {}
            for slots in (h.get("exemplars") or {}).values():
                for job_id, secs in slots:
                    rows.append({
                        "job_id": job_id,
                        "e2e_s": secs,
                        "bucket": tags.get("bucket"),
                        "rung": tags.get("rung"),
                        "priority": tags.get("priority"),
                        "device": tags.get("device"),
                    })
        rows.sort(key=lambda r: -float(r["e2e_s"]))
        del rows[max(int(limit), 1):]
        recorder = obs_flight.get_flight_recorder()
        for r in rows:
            r["events"] = recorder.events(job=r["job_id"], limit=64)
            job = self.job(r["job_id"])
            if job is not None:
                r["timing"] = job.timing()
        return {"slowest": rows}

    # -- fcflight device-call instrumentation -------------------------

    def _device_begin(self, worker, job_id: Optional[str],
                      bucket_name: str, n_jobs: int = 1) -> bool:
        """Open the watchdog's "device" heartbeat window and record the
        flight event; returns the cold-compile prediction (bucket not
        warm on that worker — the watchdog exemption, and the honest
        tag for the flight timeline)."""
        cold = worker is not None and not worker.is_warm(bucket_name)
        obs_flight.record("device", job=job_id,
                          device=None if worker is None else worker.idx,
                          bucket=bucket_name, cold=cold, n_jobs=n_jobs)
        if worker is not None and self.pool is not None:
            self.pool.watchdog.beat(worker.idx, "device", job=job_id,
                                    bucket=bucket_name, cold=cold,
                                    n_jobs=n_jobs)
        return cold

    def _device_end(self, worker, job_id: Optional[str],
                    bucket_name: str) -> None:
        if worker is not None and self.pool is not None:
            self.pool.watchdog.beat(worker.idx, "device_done")
        obs_flight.record("device_done", job=job_id,
                          device=None if worker is None else worker.idx,
                          bucket=bucket_name)

    def _flush_trace(self) -> None:
        """Stream newly finished spans to the .jsonl (once per batch)
        and bound resident span memory: past TRACE_EVENT_WINDOW streamed
        spans the in-memory list resets — the history is already on
        disk, and a heavy-traffic server must not retain every span of
        every request until drain.  Every pool worker calls this between
        batches, so the stream index and the reset are serialized under
        their own lock."""
        # local bindings: tracer/jsonl are written once in start() and
        # never change after the workers exist — hoisting them out of
        # the locked region keeps the lock covering only the state it
        # actually guards (the stream index + the file append)
        tracer, jsonl = self._tracer, self._trace_jsonl
        if tracer is None or jsonl is None:
            return
        with self._trace_lock:
            new = tracer.events_since(self._streamed_events)
            self._streamed_events += len(new)
            if self._streamed_events > TRACE_EVENT_WINDOW:
                # atomic snapshot+clear (Tracer.drain_since): a span
                # another worker closes between a separate read and
                # clear() would vanish from memory AND the stream
                new = new + tracer.drain_since(self._streamed_events)
                self._streamed_events = 0
            if new:
                with open(jsonl, "a", encoding="utf-8") as fh:
                    for ev in new:
                        fh.write(json.dumps({"kind": "span", **ev})
                                 + "\n")

    def _export_trace(self) -> None:
        if self._tracer is None or not self.config.trace_dir:
            return
        from fastconsensus_tpu_torch.obs import export as obs_export
        from fastconsensus_tpu_torch.obs import set_tracer

        set_tracer(None)
        self._flush_trace()
        snapshot = self._reg.snapshot()
        # Perfetto blob from the retained (recent-window) spans; the
        # complete stream is the .jsonl next to it.  Worker threads map
        # to named per-device tracks ("device-0", "device-1", ...).
        events = self._tracer.events()
        path = os.path.join(self.config.trace_dir, "fcserve_trace.json")
        thread_names = self.pool.thread_names() if self.pool else None
        obs_export.write_perfetto(path, events, snapshot,
                                  process_name="fcserve",
                                  thread_names=thread_names)
        with open(self._trace_jsonl, "a", encoding="utf-8") as fh:
            fh.write(json.dumps({"kind": "counters", **snapshot}) + "\n")
        _logger.info("fcserve trace written to %s (+.jsonl)", path)

    # -- submission --------------------------------------------------

    def submit(self, spec: JobSpec, key: Optional[str] = None) -> Job:
        """Admit a job (or answer it from the cache immediately).

        Raises :class:`GraphTooLarge` (413), :class:`queue.QueueFull`
        (429) or :class:`queue.QueueClosed` (503); on success the
        returned job is either queued, or already DONE when its content
        hash hit the cache — a cache hit costs no queue slot, so cached
        traffic flows even through a saturated queue.

        ``key`` overrides the cache key (fcdelta: incremental results
        live under :func:`serve.delta.delta_cache_key`, never under the
        child graph's own content hash — approximate answers must not
        shadow the exact-dedup promise).
        """
        n_raw = spec.n_edges_raw()
        if n_raw < 1:
            raise ValueError("graph has no edges")
        if spec.n_nodes > self.config.max_nodes:
            raise GraphTooLarge(
                f"graph has {spec.n_nodes} nodes; this server admits at "
                f"most {self.config.max_nodes}")
        if n_raw > self.config.max_edges:
            raise GraphTooLarge(
                f"graph has {n_raw} edges; this server admits at most "
                f"{self.config.max_edges}")
        job = Job(self._normalize_spec(spec), key=key)
        bucket_key = None
        try:
            # fclat per-bucket arrival rate: offered load, marked for
            # EVERY admissible request (cache hits included — the
            # adaptive coalescing window must see the true arrival
            # process, not the cache-filtered one).  canonical() is
            # already memoized by the content hash above, so bucket()
            # is just the grid lookup.
            bucket_key = job.spec.bucket().key()
            self._lat.arrivals.mark(bucket_key)
        # fcheck: ok=swallowed-error (deliberate: the arrival
        # mark is telemetry; an unbucketable spec still fails
        # as its own job at pack time, visibly)
        except Exception:  # noqa: BLE001 — rate tracking must never
            pass           # reject a job the bucketer will judge later
        cached = self.cache.get(job.key)
        if cached is not None:
            job.mark(STATE_DONE, result=dict(cached, cached=True))
            self._remember(job)
            self._reg.inc("serve.jobs.cached")
            obs_flight.record("cache_hit", job=job.job_id,
                              bucket=bucket_key, **_trace_aux(job))
            self._record_timeline(job, cached=True)
            return job
        # fcshape deadline-aware shedding: a job the measured service
        # rate provably cannot finish inside its SLO at the current
        # depth is refused NOW — same 429 class as QueueFull, but the
        # client learns in microseconds what the queue would have told
        # it after the whole SLO window.  Cache hits never reach here
        # (they cost no slot); cold-start estimates never shed.
        if bucket_key is not None:
            depth = self.queue.total_depth()
            reason = self.shaper.should_shed(bucket_key,
                                             job.deadline_mono, depth)
            if reason is not None:
                self._reg.inc("serve.queue.rejected_shed")
                obs_flight.record("shed", job=job.job_id,
                                  bucket=bucket_key, depth=depth,
                                  **_trace_aux(job))
                shed = DeadlineShed(depth, self.queue.max_depth, reason)
                shed.retry_after_s = self.shaper.retry_after_s(
                    depth, bucket_key)
                raise shed
        try:
            # Pre-compute (memoize) the coalescing group HERE, on the
            # submitting thread: pop_batch evaluates group_key under
            # the queue lock, and a first evaluation there would run
            # the O(E log E) canonicalization for every heap entry
            # while all submits block.  (canonical() is already warm —
            # the content hash above computed it.)  The GROUP arrival
            # mark is the hold predictor's preferred fill signal: only
            # same-group arrivals can join a rung, so the per-bucket
            # rate alone would predict fills mixed-config traffic can
            # never deliver.
            self._lat.group_arrivals.mark(job.spec.batch_group())
        # fcheck: ok=swallowed-error (deliberate: the group
        # mark is telemetry; _group_key independently falls
        # back to solo for the same spec)
        except Exception:  # noqa: BLE001 — grouping must never reject
            pass           # a job; _group_key falls back to solo
        try:
            self.queue.submit(job)   # QueueClosed propagates as-is
        except QueueFull as e:
            # honest backpressure: the 429 tells the client when the
            # depth it bounced off should actually have drained
            try:
                e.retry_after_s = self.shaper.retry_after_s(
                    e.depth, bucket_key)
            # fcheck: ok=swallowed-error (the 429 re-raises right
            # below — only the optional retry-after refinement is
            # dropped, and the client has its static default)
            except Exception:  # noqa: BLE001 — estimator trouble must
                pass           # never mask the backpressure signal
            raise
        self._remember(job)
        return job

    def submit_delta(self, payload: Dict[str, Any]) -> Job:
        """fcdelta admission: resolve ``payload['parent']`` from the
        result cache, apply the canonical edge delta, and submit the
        child graph — warm-started from the parent's partitions with
        the move phase restricted to the changed edges' neighborhood
        when the policy allows, else as a plain full run with
        ``mode="fallback"`` stamped.

        The parent entry is PINNED for exactly the resolve window
        (``serve.cache.parent_pins``): between reading the hash and
        copying the warm-start labels out, an LRU eviction or TTL
        expiry would otherwise turn an admissible delta into a
        spurious 404 under cache contention.

        Raises :class:`serve.delta.ParentNotCached` (404),
        :class:`serve.delta.DeltaError` (400), plus everything
        :meth:`submit` raises.
        """
        from fastconsensus_tpu_torch.consensus import ConsensusConfig
        from fastconsensus_tpu_torch.models.registry import get_detector
        from fastconsensus_tpu_torch.serve import delta as fcdelta

        parent_hash = payload.get("parent")
        if not isinstance(parent_hash, str) or not parent_hash:
            raise DeltaError("parent must be a content-hash string")
        pinned = self.cache.pin(parent_hash)
        try:
            parent = self.cache.get(parent_hash, count_miss=False) \
                if pinned else None
            if parent is None:
                self._reg.inc("serve.delta.parent_miss")
                raise ParentNotCached(
                    f"parent {parent_hash[:16]}… is not in this "
                    f"replica's result cache (expired, evicted, or "
                    f"never ran here)")
            graph = parent.get("graph")
            cfg_dict = parent.get("config")
            if graph is None or cfg_dict is None:
                self._reg.inc("serve.delta.parent_miss")
                raise ParentNotCached(
                    "parent result carries no graph/config block "
                    "(cached before fcdelta); resubmit the full graph "
                    "once to refresh it")
            n_nodes = int(parent["n_nodes"])
            adds, removes = fcdelta.parse_delta(payload, n_nodes)
            pu = np.asarray(graph["u"], dtype=np.int64)
            pv = np.asarray(graph["v"], dtype=np.int64)
            pw = graph.get("w")
            cu, cv, cw = fcdelta.apply_delta(pu, pv, pw, n_nodes,
                                             adds, removes)
            config = ConsensusConfig(**cfg_dict)
            child_hash = hash_canonical((cu, cv, cw), n_nodes, config)
            parent_bucket = bucketer.bucket_for(
                n_nodes, max(int(pu.shape[0]), 1))
            child_bucket = bucketer.bucket_for(
                n_nodes, max(int(cu.shape[0]), 1))
            detect = get_detector(config.algorithm, gamma=config.gamma)
            warm_capable = bool(config.warm_start and
                                getattr(detect, "supports_init", False))
            # the mesh path takes no init_labels: a huge child runs full
            huge = self.config.chip_max_edges is not None and \
                child_bucket.e_class > self.config.chip_max_edges
            decision = self.config.delta_policy.decide(
                int(adds.shape[0] + removes.shape[0]),
                int(pu.shape[0]), parent, config,
                parent_bucket.key(), child_bucket.key(), warm_capable,
                huge=huge)
            warm_labels = warm_active = key = None
            if decision.mode == "incremental":
                # copies — nothing below may reference the cache entry
                # once the pin releases
                warm_labels = np.stack(
                    [np.asarray(p, dtype=np.int32)
                     for p in parent["partitions"]])
                warm_active = fcdelta.neighborhood_mask(
                    cu, cv, n_nodes, adds, removes)
                key = fcdelta.delta_cache_key(child_hash, parent_hash)
            self._reg.inc(f"serve.delta.{decision.mode}")
        finally:
            if pinned:
                self.cache.unpin(parent_hash)
        spec = JobSpec(
            edges=np.stack([cu, cv], axis=1), n_nodes=n_nodes,
            config=config, weights=cw,
            priority=_parse_priority(payload),
            slo=_parse_slo(payload, default="delta"),
            slo_target_ms=_parse_slo_target(payload),
            trace=_parse_trace(payload),
            delta=fcdelta.describe_payload(
                parent_hash, decision,
                int(adds.shape[0]), int(removes.shape[0])),
            warm_labels=warm_labels, warm_active=warm_active)
        # (cu, cv, cw) is already canonical ascending edge-key order —
        # pre-seed the memo so hashing/packing skip the O(E log E) pass
        object.__setattr__(spec, "_canonical", (cu, cv, cw))
        job = self.submit(spec, key=key)
        obs_flight.record("delta", job=job.job_id,
                          parent=parent_hash[:16], mode=decision.mode,
                          reason=decision.reason,
                          delta_frac=decision.delta_frac,
                          **_trace_aux(job))
        return job

    def job(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(job_id)

    def _normalize_spec(self, spec: JobSpec) -> JobSpec:
        """Drop an ignored gamma before hashing.

        Detectors without a gamma parameter compute identical results
        at every gamma, so letting it into the content hash would
        fragment the cache with distinct keys for provably identical
        work — the same fingerprint poisoning cli.py normalizes away
        for checkpoints/detect caches.
        """
        if spec.config.gamma != 1.0:
            from fastconsensus_tpu_torch.models.registry import supports_param

            if not supports_param(spec.config.algorithm, "gamma"):
                spec = dataclasses.replace(
                    spec, config=dataclasses.replace(spec.config,
                                                     gamma=1.0))
        return spec

    def _remember(self, job: Job) -> None:
        with self._lock:
            self._jobs[job.job_id] = job
            while len(self._jobs) > MAX_RETAINED_JOBS:
                # evict the oldest FINISHED job only: an admitted
                # (queued/running) job must stay queryable for its whole
                # lifetime even while cache-hit traffic churns the table
                for jid, j in self._jobs.items():
                    if j.state in (STATE_DONE, STATE_FAILED):
                        del self._jobs[jid]
                        break
                else:
                    break  # everything retained is live work

    # -- fclat timeline recording -------------------------------------

    def _record_timeline(self, job: Job, rung: int = 1, worker=None,
                         cached: bool = False,
                         failed: bool = False) -> None:
        """Fold one finished job's phase timeline into the fclat
        histograms (per-phase + end-to-end, tagged by bucket / batch
        rung / priority / device) and its SLO verdict into the
        ``serve.slo.*`` attainment counters.  Cache hits record under
        rung 0 — a genuine serve whose latency profile must not blend
        into the device-path distributions.  FAILED jobs always count
        as an SLO miss (a 500 is the worst possible latency from the
        user's side — attainment must crater during an outage, not
        read 1.0 off the surviving successes) and record end-to-end
        only, into ``serve.e2e.failed``, so failure latencies never
        blend into the served distributions."""
        ph = job.phase_seconds()
        if ph is None:
            return
        phases, e2e = ph
        try:
            bucket_key = job.spec.bucket().key()
        except Exception:  # noqa: BLE001 — unbucketable specs fail as
            bucket_key = "-"  # their own job and still count here
        device = worker.idx if worker is not None else (
            job.device if job.device is not None else "-")
        cls = job.spec.slo_class()
        if failed:
            self._lat.hist("serve.e2e.failed", bucket=bucket_key,
                           priority=job.spec.priority).record(e2e)
            self._reg.inc("serve.slo.missed")
            self._reg.inc(f"serve.slo.{cls}.missed")
            obs_flight.record("fail", job=job.job_id, bucket=bucket_key,
                              **_trace_aux(job))
            return
        tags = dict(bucket=bucket_key, rung=0 if cached else int(rung),
                    priority=job.spec.priority, device=device)
        if not cached and (job.result or {}).get("compiles"):
            # a cold job's device phase holds its kernel builds, not just
            # service: tag it so the shaping service-time estimator
            # (obs/latency.py) can exclude it — one slow build in the
            # mean would make the deadline-shed math refuse jobs a warm
            # bucket serves in milliseconds
            tags["cold"] = 1
        for name, secs in phases.items():
            if name == "hold" and secs <= 0.0:
                # every popped job carries a hold stamp (jobs.py), but
                # only actual hold-for-coalesce episodes belong in the
                # serve.phase.hold histogram — a distribution that is
                # 99% synthetic zeros measures nothing
                continue
            self._lat.hist(f"serve.phase.{name}", **tags).record(secs)
        # fcflight: the job id rides the e2e observation as a bounded
        # per-bucket exemplar — /debugz/slowest joins the bucket's worst
        # latencies back to their flight timelines by exactly this id
        self._lat.hist("serve.e2e", **tags).record(
            e2e, exemplar=job.job_id)
        obs_flight.record("finish", job=job.job_id, bucket=bucket_key,
                          e2e_s=round(e2e, 6),
                          rung=0 if cached else int(rung),
                          **_trace_aux(job))
        verdict = "met" if e2e * 1000.0 <= job.spec.slo_target() \
            else "missed"
        self._reg.inc(f"serve.slo.{verdict}")
        self._reg.inc(f"serve.slo.{cls}.{verdict}")

    def latency_stats(self) -> Dict[str, Any]:
        """The ``/metricsz`` ``latency`` block: fclat histogram
        exposition (per-phase/e2e, JSON form), per-bucket arrival and
        dispatch rates, and the per-class SLO attainment summary."""
        snap = self._lat.snapshot()
        counters = self._reg.counters()
        slo: Dict[str, Any] = {}
        for cls, target in SLO_CLASSES.items():
            met = counters.get(f"serve.slo.{cls}.met", 0)
            missed = counters.get(f"serve.slo.{cls}.missed", 0)
            if met or missed:
                slo[cls] = {
                    "met": met, "missed": missed,
                    "attainment": round(met / (met + missed), 4),
                    "target_default_ms": target,
                }
        snap["slo"] = slo
        return snap

    def shaping_stats(self) -> Dict[str, Any]:
        """The ``/metricsz`` ``shaping`` block (typed by the torch-free
        client): the live shaping config, the ``serve.shape.*``
        counters, per-bucket service-time estimates for every bucket
        with arrival history, and the Retry-After a 429 issued at the
        current depth would carry."""
        buckets = sorted(self._lat.arrivals.rates())
        return self.shaper.describe(depth=self.queue.total_depth(),
                                    buckets=buckets)

    # -- the worker paths (driven by serve/pool.py workers) -----------

    def _device_of(self, worker) -> torch.device:
        """Where a job runs: its worker's device, else the base one."""
        return self.device if worker is None else worker.device

    def _group_key(self, job: Job) -> str:
        try:
            return job.spec.batch_group()
        except Exception:  # noqa: BLE001 — a spec the bucketer rejects
            # must still pop (and fail as ITS OWN job, solo); a unique
            # group key guarantees it never coalesces
            return f"solo:{job.job_id}"

    def _drain_group(self, pending: "deque[Job]", worker=None) -> None:
        """Run one coalesced pop: answer cache hits, then execute the
        rest at batch-ladder rungs (one batched device call per rung,
        solo for a rung of 1).  On a mesh (huge-tier) worker every job
        runs solo — the batch path is single-device, and huge jobs are
        device-bound, not dispatch-bound."""
        runnable: List[Job] = []
        for job in pending:
            cached = self.cache.get(job.key, count_miss=False)
            if cached is not None:
                # an identical job finished while this one queued — a
                # genuine serve, same accounting as the solo re-probe
                job.mark(STATE_DONE, result=dict(cached, cached=True))
                self._reg.inc("serve.jobs.completed")
                self._record_timeline(job, worker=worker, cached=True)
            else:
                runnable.append(job)
        solo_only = worker is not None and worker.kind == "mesh"
        while runnable:
            rung = 1 if solo_only else bucketer.batch_rung(
                min(len(runnable), self.config.max_batch))
            chunk, runnable = runnable[:rung], runnable[rung:]
            if len(chunk) == 1:
                self._run_solo_job(chunk[0], worker=worker)
            else:
                self._run_batch(chunk, worker=worker)

    def _run_solo_job(self, job: Job, worker=None) -> None:
        job.mark(STATE_RUNNING)
        if worker is not None:
            job.set_device(worker.idx)
        try:
            result = self.run_spec(job.spec, key=job.key, worker=worker,
                                   job=job)
            job.stamp("fanned_out")
            job.mark(STATE_DONE, result=result)
            self._reg.inc("serve.jobs.completed")
            if worker is not None:
                self._reg.inc(f"serve.device.{worker.idx}.jobs")
            self._record_timeline(job, rung=1, worker=worker,
                                  cached=bool(result.get("cached")))
        except Exception as e:  # noqa: BLE001 — one bad job must
            # never take down the worker (and with it every queued
            # job behind it); the failure is the job's result
            job.mark(STATE_FAILED, error=f"{type(e).__name__}: {e}")
            self._reg.inc("serve.jobs.failed")
            self._record_timeline(job, worker=worker, failed=True)
            _logger.warning("fcserve job %s failed: %s", job.job_id,
                            job.error)
            if isinstance(e, KernelBuildError):
                # the worker cannot launch its kernels, so every later
                # job would fail alike: escape to the pool, which
                # cordons the worker and requeues its backlog elsewhere
                raise

    def _run_batch(self, jobs: List[Job], worker=None) -> None:
        """Execute >= 2 same-group jobs as ONE batched device call.

        Failure isolation, in order: a job whose graph fails to pack
        (e.g. non-finite weights) fails alone at pack time, before any
        batch exists; if the batched call itself raises, every member
        falls back to solo execution so one poison job cannot fail its
        batchmates.  Per-job spans, cache fills and counters fan out of
        the shared call.
        """
        packed: List[Tuple] = []  # (job, normalized spec, slab, bucket)
        for job in jobs:
            job.mark(STATE_RUNNING)
            if worker is not None:
                job.set_device(worker.idx)
            spec = self._normalize_spec(job.spec)
            try:
                slab, bucket = bucketer.pad_to_bucket(
                    spec.edges, spec.n_nodes, spec.weights,
                    max_nodes=self.config.max_nodes,
                    max_edges=self.config.max_edges,
                    canonical=spec.canonical(),
                    device=self._device_of(worker))
            except Exception as e:  # noqa: BLE001 — pack-time rejects
                job.mark(STATE_FAILED,
                         error=f"{type(e).__name__}: {e}")
                self._reg.inc("serve.jobs.failed")
                self._record_timeline(job, worker=worker, failed=True)
                _logger.warning("fcserve job %s failed at pack: %s",
                                job.job_id, job.error)
                continue
            job.stamp("packed")
            packed.append((job, spec, slab, bucket))
        # pack failures can leave an off-ladder width; re-split so
        # every device call stays on a BATCH_LADDER rung
        while packed:
            rung = bucketer.batch_rung(len(packed))
            chunk, packed = packed[:rung], packed[rung:]
            if len(chunk) == 1:
                self._run_solo_job(chunk[0][0], worker=worker)
            else:
                self._run_packed(chunk, worker=worker)

    def _run_packed(self, packed: List[Tuple], worker=None) -> None:
        """One batched device call over already-packed (job, spec, slab,
        bucket) rows (a ladder rung of >= 2)."""
        from fastconsensus_tpu_torch.analysis import CompileGuard
        from fastconsensus_tpu_torch.consensus import run_consensus_batch
        from fastconsensus_tpu_torch.models.registry import get_detector

        batch_id = f"b{next(self._batch_seq):05d}"
        bucket = packed[0][3]
        cfg0 = packed[0][1].config
        seeds = [spec.config.seed for _, spec, _, _ in packed]
        detect = get_detector(cfg0.algorithm, gamma=cfg0.gamma)
        tracer = get_tracer()
        device = worker.idx if worker is not None else None
        t0 = time.perf_counter()
        # thread-filtered: concurrent pool workers compile in parallel,
        # and this job-scoped count must not absorb a neighbor's builds
        guard = CompileGuard(registry=self._reg,
                             counter="serve.xla_compiles",
                             thread_ident=threading.get_ident())
        head_id = packed[0][0].job_id
        self._device_begin(worker, head_id, bucket.key(),
                           n_jobs=len(packed))
        try:
            try:
                with tracer.span("serve.batch", bucket=bucket.key(),
                                 alg=cfg0.algorithm, b=len(packed),
                                 batch_id=batch_id, device=device):
                    with guard:
                        results = run_consensus_batch(
                            [slab for _, _, slab, _ in packed], detect,
                            cfg0, n_closure=bucket.n_closure, seeds=seeds)
            finally:
                # the heartbeat closes even on a failing batch — the
                # worker is not wedged, its members retry solo
                self._device_end(worker, head_id, bucket.key())
        except KernelBuildError as e:
            # no member can run on this worker: each fails as itself and
            # the worker is cordoned (see _run_solo_job)
            for job, _, _, _ in packed:
                job.mark(STATE_FAILED, error=f"{type(e).__name__}: {e}")
                self._reg.inc("serve.jobs.failed")
                self._record_timeline(job, worker=worker, failed=True)
            raise
        except Exception as e:  # noqa: BLE001 — whole-batch failure:
            # isolate by re-running every member solo; only genuinely
            # bad jobs fail, each as itself
            _logger.warning("fcserve batch %s failed (%s); retrying "
                            "members solo", batch_id, e)
            self._reg.inc("serve.batch.fallback_solo")
            for job, _, _, _ in packed:
                self._run_solo_job(job, worker=worker)
            return
        elapsed = time.perf_counter() - t0
        # batch metadata and coalescing metrics record only batches
        # that actually COMPLETED as a batch: stamping before the call
        # would leave fallback-solo jobs advertising a coalesced run
        # that never happened
        for job, _, _, _ in packed:
            job.stamp("device_done")
            job.set_batch(batch_id, len(packed))
            if worker is not None:
                job.set_device(worker.idx)
        self._reg.inc("serve.batch.coalesced")
        self._reg.inc("serve.batch.occupancy", len(packed))
        self._reg.gauge("serve.batch.last_size", len(packed))
        # whole-run latency lives on the fclat histograms (bounded
        # memory, never window-truncated — obs/latency.py), not the
        # windowed observe() series the /metricsz footgun was about
        self._lat.hist("serve.batch.seconds").record(elapsed)
        if worker is not None:
            self._reg.inc(f"serve.device.{worker.idx}.batches")
        for (job, spec, _, _), res in zip(packed, results):
            with tracer.span("serve.job", bucket=bucket.key(),
                             alg=cfg0.algorithm, batch_id=batch_id,
                             device=device):
                result = self._finish_result(
                    spec, job.key, bucket, res.partitions,
                    rounds=res.rounds, converged=res.converged,
                    compiles=guard.count, elapsed=elapsed,
                    batch_id=batch_id, batch_size=len(packed),
                    worker=worker, history=res.history)
            job.stamp("fanned_out")
            job.mark(STATE_DONE, result=result)
            self._reg.inc("serve.jobs.completed")
            if worker is not None:
                self._reg.inc(f"serve.device.{worker.idx}.jobs")
            self._lat.hist("serve.job.seconds").record(
                elapsed / len(packed))
            self._record_timeline(job, rung=len(packed), worker=worker)

    def _finish_result(self, spec: JobSpec, key: str, bucket,
                       partitions_raw, rounds: int, converged: bool,
                       compiles: int, elapsed: float,
                       batch_id: Optional[str] = None,
                       batch_size: int = 1,
                       worker=None, history=None) -> Dict[str, Any]:
        """Slice off bucket padding, recompact ids, fill the cache —
        the shared tail of the solo and batched execution paths.

        ``history`` (the run's per-round entries) yields the fcqual
        ``quality`` block.  Unlike the fclat ``timing`` block — which is
        per SUBMISSION and rides the Job — quality is derived from the
        graph content, so it rides the CACHED result payload: a cache
        hit returns the same quality block the computing job produced.
        """
        from fastconsensus_tpu_torch.obs import quality as obs_quality

        partitions = []
        for p in partitions_raw:
            # fcheck: ok=sync-in-loop (partitions are already host numpy
            # — the engine does its one bulk readback; this loop only
            # slices off the bucket's padding nodes and recompacts ids)
            lab = np.asarray(p)[: spec.n_nodes]
            _, compact = np.unique(lab, return_inverse=True)
            partitions.append(compact.astype(np.int32))
        result = {
            "content_hash": key,
            "bucket": bucket.describe(),
            "partitions": partitions,
            "n_nodes": spec.n_nodes,
            "rounds": rounds,
            "converged": converged,
            "compiles": compiles,
            "elapsed_s": round(elapsed, 6),
            "cached": False,
            "quality": obs_quality.summarize_history(
                history or [], converged=converged),
        }
        # fcdelta: the canonical graph + run config ride the CACHED
        # payload (and the /cachez wire, so a fleet sibling's fetch
        # keeps lineage) — that is what lets a later delta submission
        # resolve this result as its parent and rebuild the child
        # graph server-side.  /result strips the graph block: clients
        # sent the edges, they don't need them echoed.
        gu, gv, gw = spec.canonical()
        result["graph"] = {
            "u": np.asarray(gu, dtype=np.int64),
            "v": np.asarray(gv, dtype=np.int64),
            "w": None if gw is None else np.asarray(gw,
                                                    dtype=np.float32),
        }
        result["config"] = dataclasses.asdict(spec.config)
        if batch_id is not None:
            result["batch_id"] = batch_id
            result["batch_size"] = batch_size
        if worker is not None:
            result["device"] = worker.idx
            result["tier"] = worker.kind
            worker.note_job(bucket.key())
        self.cache.put(key, result)
        with self._lock:
            self._buckets[bucket.key()] = \
                self._buckets.get(bucket.key(), 0) + 1
        return result

    # -- pre-warm ----------------------------------------------------

    def _prewarm_all(self, worker=None) -> None:
        """Warm every configured bucket from the calling thread — the
        embedded/single-worker path (pool workers warm their own
        assigned subset via ``_prewarm_one`` instead)."""
        for spec in self.config.prewarm:
            try:
                self._prewarm_one(spec, worker=worker)
            except Exception as e:  # noqa: BLE001 — a bad warm spec
                # must not kill the worker before it served anything
                self._reg.inc("serve.prewarm.failed")
                _logger.warning("fcserve pre-warm %r failed: %s", spec, e)
            self._prewarm_done += 1
        self._prewarm_finished = True

    def _prewarm_one(self, spec: str, worker=None) -> None:
        """Warm one bucket before the first request: ``"n64_e96"`` warms
        the solo path, ``"n64_e96:4"`` also the batch ladder up to rung 4
        — deterministic probe graphs driven through the REAL
        solo/batched paths (results discarded, cache untouched).  On the
        card that is where a cold worker builds its CUDA kernels and
        its allocator's pools; the builds count under
        ``serve.prewarm.compiles``.  On a mesh (huge-tier) worker only
        the solo sharded path warms — batches never run there.
        """
        from fastconsensus_tpu_torch.analysis import CompileGuard
        from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                       run_consensus,
                                                       run_consensus_batch)
        from fastconsensus_tpu_torch.models.registry import get_detector

        key, _, b = spec.partition(":")
        max_b = self.config.max_batch
        if b:
            if int(b) < 1:
                # a 0-rung spec would compile nothing yet count the
                # bucket as warmed — the silent no-op bucket_from_key's
                # grid check exists to prevent, one knob over
                raise ValueError(
                    f"--warm {spec!r}: rung must be >= 1")
            max_b = min(int(b), self.config.max_batch)
        bucket = bucketer.bucket_from_key(key)
        mesh = None
        if worker is not None and worker.kind == "mesh":
            mesh = worker.mesh
            max_b = 1
        # tau defaults from the RESOLVED algorithm, mirroring the
        # request path (_parse_spec's DEFAULT_TAU[alg] setdefault), so
        # the probes run the config the traffic will
        cfg_kwargs = dict({"algorithm": "louvain"},
                          **(self.config.prewarm_config or {}))
        cfg_kwargs.setdefault("tau", DEFAULT_TAU[cfg_kwargs["algorithm"]])
        cfg = ConsensusConfig(**cfg_kwargs)
        detect = get_detector(cfg.algorithm, gamma=cfg.gamma)
        tracer = get_tracer()
        device = worker.idx if worker is not None else None
        t0 = time.perf_counter()
        guard = CompileGuard(registry=self._reg,
                             counter="serve.prewarm.compiles",
                             thread_ident=threading.get_ident())
        with tracer.span("serve.prewarm", bucket=bucket.key(),
                         alg=cfg.algorithm, max_b=max_b, device=device):
            with guard:
                for rung in bucketer.BATCH_LADDER:
                    if rung > max_b:
                        break
                    # distinct probe content per lane: distinct graphs
                    # keep the probe honest
                    slabs = []
                    for v in range(rung):
                        slab, _ = bucketer.pad_to_bucket(
                            bucketer.probe_edges(bucket, variant=v),
                            bucket.n_class, device=self._device_of(worker))
                        slabs.append(slab)
                    if rung == 1:
                        run_consensus(slabs[0], detect, cfg, mesh=mesh,
                                      n_closure=bucket.n_closure)
                    else:
                        run_consensus_batch(
                            slabs, detect, cfg,
                            n_closure=bucket.n_closure,
                            seeds=list(range(rung)))
        if worker is not None:
            worker.note_warm(bucket.key())
        self._reg.inc("serve.prewarm.buckets")
        _logger.info(
            "fcserve pre-warmed %s ladder to B=%d on device %s "
            "(%d compiles, %.1fs)", bucket.key(), max_b,
            "-" if device is None else device, guard.count,
            time.perf_counter() - t0)

    def run_spec(self, spec: JobSpec, key: Optional[str] = None,
                 worker=None, job: Optional[Job] = None) -> Dict[str, Any]:
        """Run one spec to a result payload (cache-aware, synchronous).

        This is the worker's core, callable directly (tests, embedded
        use; it then runs on the service's base device).  Builds during
        the run are counted live into the fcobs registry
        (``serve.xla_compiles``); a warm worker counts zero.  On a mesh
        worker the run executes edge-sharded over the reserved device
        group (``run_consensus(mesh=...)`` — the huge tier).  ``job``,
        when the call serves one, receives the fclat pack/device phase
        stamps.
        """
        from fastconsensus_tpu_torch.analysis import CompileGuard
        from fastconsensus_tpu_torch.consensus import run_consensus
        from fastconsensus_tpu_torch.models.registry import get_detector

        spec = self._normalize_spec(spec)
        key = key if key is not None else spec.content_hash()
        # re-check, not first-check: the worker path already counted
        # this admission's miss in submit(); recounting it here would
        # halve the /metricsz hit rate (a hit IS a genuine serve — an
        # identical queued job finished first — and always counts)
        cached = self.cache.get(key, count_miss=False)
        if cached is not None:
            return dict(cached, cached=True)
        mesh = worker.mesh if worker is not None \
            and worker.kind == "mesh" else None
        slab, bucket = bucketer.pad_to_bucket(
            spec.edges, spec.n_nodes, spec.weights,
            max_nodes=self.config.max_nodes,
            max_edges=self.config.max_edges,
            canonical=spec.canonical(), device=self._device_of(worker))
        if job is not None:
            job.stamp("packed")
        # get_detector is memoized: every job of one (alg, gamma)
        # shares one detector object
        detect = get_detector(spec.config.algorithm,
                              gamma=spec.config.gamma)
        tracer = get_tracer()
        device = worker.idx if worker is not None else None
        t0 = time.perf_counter()
        guard = CompileGuard(registry=self._reg,
                             counter="serve.xla_compiles",
                             thread_ident=threading.get_ident())
        run_kwargs: Dict[str, Any] = {}
        if spec.warm_labels is not None:
            # fcdelta incremental: pad the parent's labels and the
            # neighborhood mask out to the bucket — pad nodes enter as
            # frozen singletons (label = own id, active False), exactly
            # what a cold run converges them to, so bucket padding and
            # warm-start compose without a special engine path
            n_real, n_pad = spec.n_nodes, slab.n_nodes
            init = np.empty((spec.config.n_p, n_pad), dtype=np.int32)
            init[:, :n_real] = spec.warm_labels
            init[:, n_real:] = np.arange(n_real, n_pad,
                                         dtype=np.int32)[None, :]
            act = np.zeros((n_pad,), dtype=bool)
            act[:n_real] = spec.warm_active
            run_kwargs = {"init_labels": init, "active_mask": act}
        self._device_begin(worker,
                           None if job is None else job.job_id,
                           bucket.key())
        try:
            with tracer.span("serve.job", bucket=bucket.key(),
                             alg=spec.config.algorithm, device=device):
                with guard:
                    res = run_consensus(slab, detect, spec.config,
                                        mesh=mesh,
                                        n_closure=bucket.n_closure,
                                        **run_kwargs)
        finally:
            self._device_end(worker,
                             None if job is None else job.job_id,
                             bucket.key())
        if job is not None:
            job.stamp("device_done")
        elapsed = time.perf_counter() - t0
        result = self._finish_result(spec, key, bucket, res.partitions,
                                     rounds=res.rounds,
                                     converged=res.converged,
                                     compiles=guard.count,
                                     elapsed=elapsed, worker=worker,
                                     history=res.history)
        self._lat.hist("serve.job.seconds").record(elapsed)
        return result

    # -- introspection -----------------------------------------------

    # -- fcfleet cross-replica cache surface ---------------------------

    def cache_entry(self, key: str) -> Optional[Dict[str, Any]]:
        """The cached result for one content hash, or None — the
        ``GET /cachez/<hash>`` read path a fleet sibling fetches on
        miss (serve/router.py).  Counts as a cache hit: it IS a serve,
        just answered one replica over."""
        return self.cache.get(key, count_miss=False)

    def cache_seed(self, payload: Dict[str, Any]) -> str:
        """Insert one wire-shape result (``POST /cachez``) into the
        local cache, so an already-queued job for the same content
        completes via the worker's pre-run re-probe with zero device
        work — the receiving half of fleet fetch-on-miss and prewarm
        cache shipping.  Raises ValueError on a payload that is not
        the standard result shape."""
        key = payload.get("content_hash")
        parts = payload.get("partitions")
        if not isinstance(key, str) or not key or \
                not isinstance(parts, (list, tuple)) or not parts:
            raise ValueError(
                "cache seed needs content_hash + partitions")
        value = dict(payload)
        # per-SUBMISSION fields never ride cached content (the same
        # rule /result applies when attaching them)
        value.pop("timing", None)
        value["partitions"] = [np.asarray(p, dtype=np.int32)
                               for p in parts]
        if any(p.ndim != 1 for p in value["partitions"]):
            raise ValueError("partitions must be 1-D label arrays")
        graph = value.get("graph")
        if graph is not None:
            # fcdelta lineage survives the fleet wire: a seeded result
            # must still resolve delta submissions on the new replica
            value["graph"] = {
                "u": np.asarray(graph["u"], dtype=np.int64),
                "v": np.asarray(graph["v"], dtype=np.int64),
                "w": None if graph.get("w") is None
                else np.asarray(graph["w"], dtype=np.float32),
            }
        # stored uncached; a later hit serves dict(value, cached=True)
        # exactly like a locally computed result
        value["cached"] = False
        self.cache.put(key, value)
        self._reg.inc("serve.cache.seeded")
        return key

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            states: Dict[str, int] = {}
            for j in self._jobs.values():
                states[j.state] = states.get(j.state, 0) + 1
            buckets = dict(self._buckets)
            last_bundle = self._last_bundle
        if self.pool is not None:
            prewarm = self.pool.prewarm_progress()
            workers = self.pool.describe()
            affinity = self.pool.scheduler.affinity()
            cordoned = [w["device"] for w in workers if w["cordoned"]]
            suspects = self.pool.watchdog.suspects()
            watchdog_trips = self.pool.watchdog.trips()
        else:
            prewarm = {"specs": self._prewarm_total,
                       "done": self._prewarm_done,
                       "finished": self._prewarm_finished}
            workers, affinity, cordoned = [], {}, []
            suspects, watchdog_trips = [], 0
        return {
            "uptime_s": round(time.time() - self._started_at, 3),
            "draining": self.queue.draining(),
            "queue_depth": self.queue.depth(),
            "queue_max_depth": self.queue.max_depth,
            "cache_entries": len(self.cache),
            "jobs": states,
            "buckets": buckets,
            "max_batch": self.config.max_batch,
            "prewarm": prewarm,
            "workers": workers,
            "affinity": affinity,
            "cordoned_devices": cordoned,
            # fcflight: the router-facing replica self-diagnosis —
            # which devices the watchdog currently holds suspect, how
            # often it has tripped, and where the freshest crash
            # evidence lives on disk
            "suspect_devices": [t.get("device") for t in suspects],
            "watchdog_trips": watchdog_trips,
            "last_bundle": last_bundle,
        }

    def kernel_stats(self) -> Dict[str, Any]:
        """This process's kernel launches since it started (the counters
        of ``ops/row_kernels.py``, process-scoped like every /metricsz
        counter): a launch inside a replica is invisible to the process
        that sent it the job, so a fleet reads them here per replica."""
        from fastconsensus_tpu_torch.ops import row_kernels as rk

        # one C-level copy of each: a worker adds shapes while a job runs,
        # and a Python loop over the live dict would race it
        launches = dict(rk.LAUNCHES)
        shapes = list(rk.ROW_TOTALS_SHAPES.items())
        return {"launches": launches,
                "row_totals_shapes": sorted([r, d, n]
                                            for (r, d), n in shapes)}

    def device_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-device breakdown for ``/metricsz``: jobs, batches,
        busy-fraction from the pool's own (service-scoped) bookkeeping,
        compiles/deaths from the ``serve.device.<i>.*`` fcobs counters
        (process-scoped, like every other /metricsz counter)."""
        counters = self._reg.counters()
        uptime = max(time.time() - self._started_at, 1e-9)
        out: Dict[str, Dict[str, Any]] = {}
        for worker in (self.pool.workers if self.pool is not None else []):
            w = worker.describe()
            i = w["device"]
            pref = f"serve.device.{i}."
            out[str(i)] = {
                "kind": w["kind"],
                "jobs": w["jobs"],
                "batches": w["batches"],
                "xla_compiles": counters.get(pref + "xla_compiles", 0),
                "deaths": counters.get(pref + "deaths", 0),
                "busy_s": w["busy_s"],
                "busy_frac": round(w["busy_s"] / uptime, 4),
                "backlog": w["backlog"],
                "cordoned": w["cordoned"],
                "warm_buckets": len(w["warm"]),
            }
            # the card's allocator, this process's share of it: replicas
            # sharing one GPU each report their own (absent on the CPU)
            mem = obs_counters.device_memory(worker.device)
            if mem:
                out[str(i)]["memory"] = {
                    k: mem[k] for k in ("bytes_in_use", "peak_bytes_in_use",
                                        "bytes_limit")}
        return out


# ---------------------------------------------------------------------
# HTTP front end (stdlib http.server)
# ---------------------------------------------------------------------

def _parse_spec(payload: Dict[str, Any],
                max_body_edges: int) -> JobSpec:
    """A JobSpec from a ``/submit`` JSON body (raises ValueError)."""
    from fastconsensus_tpu_torch.consensus import ConsensusConfig

    if "edgelist" in payload:
        rows = []
        for lineno, ln in enumerate(
                str(payload["edgelist"]).splitlines(), start=1):
            ln = ln.split("#", 1)[0].strip()
            if not ln:
                continue
            parts = ln.split()
            if len(parts) < 2:
                raise ValueError(
                    f"edgelist line {lineno}: expected 'u v', got {ln!r}")
            rows.append((int(parts[0]), int(parts[1])))
        edges = np.asarray(rows, dtype=np.int64).reshape(-1, 2)
    else:
        edges = np.asarray(payload.get("edges", ()),
                           dtype=np.int64).reshape(-1, 2)
    if edges.shape[0] < 1:
        raise ValueError("no edges in request body")
    if edges.shape[0] > max_body_edges:
        raise GraphTooLarge(
            f"request carries {edges.shape[0]} edges; this server admits "
            f"at most {max_body_edges}")
    n_nodes = int(payload.get("n_nodes", int(edges.max()) + 1))
    if edges.min() < 0 or edges.max() >= n_nodes:
        raise ValueError(
            f"edge endpoints must be compact ids in [0, {n_nodes})")
    alg = str(payload.get("algorithm", "louvain"))
    if alg not in ALGORITHMS:
        raise ValueError(
            f"unknown algorithm {alg!r}; available: {', '.join(ALGORITHMS)}")
    cfg_kwargs: Dict[str, Any] = {"algorithm": alg}
    for field, cast in (("n_p", int), ("tau", float), ("delta", float),
                        ("max_rounds", int), ("seed", int),
                        ("gamma", float), ("auto_grow", bool),
                        ("warm_start", bool), ("align_frac", float),
                        ("closure_sampler", str),
                        ("closure_tau", lambda v: None if v is None
                         else float(v))):
        if field in payload:
            cfg_kwargs[field] = cast(payload[field])
    cfg_kwargs.setdefault("tau", DEFAULT_TAU[alg])
    config = ConsensusConfig(**cfg_kwargs)
    if config.closure_sampler not in ("auto", "csr", "scatter"):
        raise ValueError(
            f"closure_sampler={config.closure_sampler!r}: expected "
            f"'auto', 'csr' or 'scatter'")
    if not 0.0 <= config.tau <= 1.0:
        raise ValueError(f"tau {config.tau} out of range 0..1")
    if not 0.0 <= config.delta <= 1.0:
        raise ValueError(f"delta {config.delta} out of range 0..1")
    if config.n_p < 1 or config.max_rounds < 1:
        raise ValueError("n_p and max_rounds must be >= 1")
    return JobSpec(edges=edges, n_nodes=n_nodes, config=config,
                   priority=_parse_priority(payload),
                   slo=_parse_slo(payload),
                   slo_target_ms=_parse_slo_target(payload),
                   trace=_parse_trace(payload))


def _parse_priority(payload: Dict[str, Any]) -> int:
    """Priority from a submit body (shared by the full and delta
    paths)."""
    prio = payload.get("priority", PRIORITY_NORMAL)
    if isinstance(prio, str):
        if prio not in PRIORITY_NAMES:
            raise ValueError(
                f"unknown priority {prio!r}; one of "
                f"{', '.join(PRIORITY_NAMES)} or an int")
        return PRIORITY_NAMES[prio]
    priority = int(prio)
    if not PRIORITY_INTERACTIVE <= priority <= PRIORITY_BATCH:
        # unclamped ints would let any client jump ahead of every
        # documented class — the priority scheme is an enforced
        # contract, not a suggestion
        raise ValueError(
            f"priority {priority} out of range "
            f"{PRIORITY_INTERACTIVE}..{PRIORITY_BATCH}")
    return priority


def _parse_slo(payload: Dict[str, Any],
               default: Optional[str] = None) -> Optional[str]:
    """SLO class from a submit body; ``default`` is fcdelta's — a delta
    submission lands in the ``delta`` class unless it asks otherwise."""
    slo = payload.get("slo", default)
    if slo is not None:
        slo = str(slo)
        if slo not in SLO_CLASSES:
            raise ValueError(
                f"unknown slo class {slo!r}; one of "
                f"{', '.join(SLO_CLASSES)}")
    return slo


def _parse_slo_target(payload: Dict[str, Any]) -> Optional[float]:
    slo_target_ms = payload.get("slo_target_ms")
    if slo_target_ms is not None:
        slo_target_ms = float(slo_target_ms)
        if not slo_target_ms > 0:
            raise ValueError(
                f"slo_target_ms must be > 0, got {slo_target_ms}")
    return slo_target_ms


def _parse_trace(payload: Dict[str, Any]) -> Optional[str]:
    # fctrace id: set in the body by a direct client, or injected by
    # the handler from the X-FCTPU-Trace header the router forwards.
    # Bounded because it is stamped verbatim into flight-event aux.
    trace = payload.get("trace")
    if trace is not None:
        trace = str(trace)
        if not 0 < len(trace) <= 128:
            raise ValueError("trace id must be 1..128 characters")
    return trace


def _result_json(result: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(result)
    out["partitions"] = [np.asarray(p).tolist()
                         for p in result["partitions"]]
    graph = out.get("graph")
    if graph is not None:
        # the /cachez wire shape (fleet fetch-on-miss must preserve
        # fcdelta lineage); /result pops the block before calling here
        out["graph"] = {
            "u": np.asarray(graph["u"]).tolist(),
            "v": np.asarray(graph["v"]).tolist(),
            "w": None if graph.get("w") is None
            else np.asarray(graph["w"]).tolist(),
        }
    return out


class _Handler(BaseHTTPRequestHandler):
    """Routes: POST /submit; GET /status/<id> /result/<id> /healthz
    /metricsz."""

    server_version = "fcserve/1"
    protocol_version = "HTTP/1.1"

    @property
    def service(self) -> ConsensusService:
        return self.server.fcserve_service  # type: ignore[attr-defined]

    def log_message(self, fmt: str, *args) -> None:  # noqa: A003
        _logger.debug("fcserve http: " + fmt, *args)

    def _send(self, code: int, payload: Dict[str, Any],
              headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_fault(self, e: BaseException) -> None:
        """Last-resort 500: an exception the route arms never mapped
        still answers the promised JSON error body instead of dropping
        the connection with a raw traceback, and stamps
        ``serve.http.unhandled_errors`` so the gap is visible on
        /metricsz (fcheck-fault: unmapped-http-error)."""
        self.service._reg.inc("serve.http.unhandled_errors")
        _logger.exception("fcserve http: unhandled handler error")
        try:
            self._send(500, {"error": "internal error: "
                                      f"{type(e).__name__}: {e}"})
        except OSError:  # fcheck: ok=swallowed-error: the client socket is already gone — there is no one left to answer; the counter above carries the failure
            pass

    def do_POST(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        try:
            self._do_post()
        except Exception as e:  # noqa: BLE001 — catch-all status mapping
            self._send_fault(e)

    def _read_json(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length", "0"))
        return json.loads(self.rfile.read(length) or b"{}")

    def _do_post(self) -> None:
        path = self.path.rstrip("/")
        if path == "/cachez":
            # fcfleet cache seeding: a router (fetch-on-miss) or the
            # fleet manager (prewarm shipping) plants a sibling's
            # result here
            try:
                key = self.service.cache_seed(self._read_json())
            except (ValueError, TypeError, KeyError) as e:
                self._send(400, {"error": f"bad cache seed: {e}"})
                return
            self._send(200, {"seeded": True, "content_hash": key,
                             "cache_entries": len(self.service.cache)})
            return
        if path == "/cachez/load":
            # fcfleet death inheritance: load a dead sibling's spilled
            # npz (serve/fleet.py on_death) — corrupt/missing files
            # load 0 entries, never error (the ResultCache.load
            # contract)
            try:
                spill_path = str(self._read_json()["path"])
            except (ValueError, TypeError, KeyError) as e:
                self._send(400, {"error": f"bad cache load request: {e}"})
                return
            before = set(self.service.cache.keys())
            n = self.service.cache.load(spill_path)
            # the hashes that are new here, so the router can index this
            # replica as their holder (fetch-on-miss after inheritance)
            fresh = [k for k in self.service.cache.keys()
                     if k not in before]
            self._send(200, {"loaded": n, "content_hashes": fresh})
            return
        if path != "/submit":
            self._send(404, {"error": f"no such endpoint {self.path}"})
            return
        try:
            payload = self._read_json()
            # fctrace propagation: the header the router forwards wins
            # over a body-level trace — the router's id is the one its
            # own flight events and the client's answer already carry
            header_trace = self.headers.get("X-FCTPU-Trace")
            if header_trace:
                payload["trace"] = header_trace
            if payload.get("parent") is not None:
                # fcdelta: a delta submit carries no edges of its own —
                # the child graph is rebuilt from the cached parent
                self._submit_delta(payload)
                return
            spec = _parse_spec(payload, self.service.config.max_edges)
        except GraphTooLarge as e:
            self._send(413, {"error": str(e)})
            return
        except (ValueError, TypeError, KeyError) as e:
            self._send(400, {"error": f"bad request: {e}"})
            return
        try:
            job = self.service.submit(spec)
        except GraphTooLarge as e:
            self._send(413, {"error": str(e)})
            return
        except QueueFull as e:
            self._send_backpressure(e)
            return
        except QueueClosed as e:
            self._send(503, {"error": str(e), "draining": True})
            return
        except ValueError as e:
            self._send(400, {"error": str(e)})
            return
        self._send_submit_ack(job)

    def _send_backpressure(self, e: QueueFull) -> None:
        # THE backpressure response: explicit, immediate, retryable
        # — and honest: Retry-After derives from queued depth x the
        # observed per-bucket service rate (serve/shaping.py), not
        # a literal guess.  The header is integer delta-seconds
        # (RFC 9110, rounded up so it never under-promises); the
        # body carries the unrounded float for typed clients.
        retry_s = e.retry_after_s
        if retry_s is None:
            retry_s = self.service.shaper.config.retry_after_default_s
        self._send(429, {"error": str(e), "backpressure": True,
                         "shed": isinstance(e, DeadlineShed),
                         "retry_after_s": round(retry_s, 3),
                         "queue_depth": e.depth,
                         "queue_max_depth": e.max_depth},
                   headers={"Retry-After":
                            str(max(1, math.ceil(retry_s)))})

    def _send_submit_ack(self, job: Job) -> None:
        ack = {"job_id": job.job_id, "state": job.state,
               "content_hash": job.key,
               "trace": job.spec.trace,
               "cached": job.state == STATE_DONE}
        if job.spec.delta is not None:
            # fcdelta: the client learns the warm-start verdict at
            # submit time (mode / fallback reason / delta_frac), not
            # only after polling the result
            ack["delta"] = job.spec.delta
        self._send(202 if job.state == STATE_QUEUED else 200, ack)

    def _submit_delta(self, payload: Dict[str, Any]) -> None:
        """fcdelta POST /submit with ``parent``: full status mapping —
        404 parent-not-cached, 400 malformed delta (with the offending
        ``adds[i]``/``removes[i]`` index), then the standard 413/429/
        503 admission surface."""
        try:
            job = self.service.submit_delta(payload)
        except ParentNotCached as e:
            self._send(404, {"error": str(e),
                             "parent": payload.get("parent")})
            return
        except GraphTooLarge as e:
            self._send(413, {"error": str(e)})
            return
        except QueueFull as e:
            self._send_backpressure(e)
            return
        except QueueClosed as e:
            self._send(503, {"error": str(e), "draining": True})
            return
        except (ValueError, TypeError, KeyError) as e:
            # DeltaError is a ValueError: the line-numbered parse
            # message IS the payload
            self._send(400, {"error": f"bad delta request: {e}"})
            return
        self._send_submit_ack(job)

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        try:
            self._do_get()
        except Exception as e:  # noqa: BLE001 — catch-all status mapping
            self._send_fault(e)

    def _do_get(self) -> None:
        path = self.path.rstrip("/")
        if path == "/healthz":
            stats = self.service.stats()
            self._send(200, {"ok": True, **stats})
            return
        if path == "/metricsz":
            # "scope" is fctrace self-description: this block is ONE
            # replica's view — the router's /metricsz says "router",
            # and the fleet-wide exact merge lives at the router's
            # /fleetz.  A scraper can no longer mistake one process's
            # counters for fleet totals.
            self._send(200, {"scope": "replica",
                             "fcobs": self.service._reg.snapshot(),
                             "serve": self.service.stats(),
                             "devices": self.service.device_stats(),
                             "kernels": self.service.kernel_stats(),
                             "latency": self.service.latency_stats(),
                             "shaping": self.service.shaping_stats()})
            return
        if path == "/debugz/flight":
            # fctrace: the live trace-stamped flight snapshot (with the
            # monotonic<->wall anchor), so the CI drill can assert a
            # trace id spans router and replica without killing anyone
            self._send(200, {"scope": "replica",
                             "flight":
                             obs_flight.get_flight_recorder().snapshot()})
            return
        if path == "/debugz/slowest":
            # fcflight tail exemplars: the bucket-worst serve.e2e jobs
            # joined to their flight timelines (typed in ServeClient)
            self._send(200, self.service.slowest())
            return
        if path == "/cachez":
            # fcfleet: the content-hash index a prewarm-shipping donor
            # advertises (serve/fleet.py ship_cache)
            self._send(200, {"keys": self.service.cache.keys(),
                             "entries": len(self.service.cache)})
            return
        if path.startswith("/cachez/"):
            cached = self.service.cache_entry(path[len("/cachez/"):])
            if cached is None:
                self._send(404, {"error": "no cached result for that "
                                          "content hash"})
            else:
                self._send(200, _result_json(dict(cached, cached=True)))
            return
        for prefix in ("/status/", "/result/"):
            if path.startswith(prefix):
                job = self.service.job(path[len(prefix):])
                if job is None:
                    self._send(404, {"error": "unknown job id"})
                    return
                if prefix == "/status/":
                    self._send(200, job.describe())
                elif job.state == STATE_DONE:
                    # fcdelta: the graph block is cache lineage, not a
                    # client answer — the client sent the edges (or the
                    # delta); echoing a million edges back would bloat
                    # every /result for a field only /cachez needs
                    res = dict(job.result)
                    res.pop("graph", None)
                    out = _result_json(res)
                    # the timing block is PER SUBMISSION, never cached
                    # content: two jobs sharing one cached result each
                    # report their own lifecycle, so it rides the Job,
                    # not the result payload
                    timing = job.timing()
                    if timing is not None:
                        out["timing"] = timing
                    if job.spec.delta is not None:
                        # per-submission like timing: a cache hit on a
                        # delta key still reports ITS OWN provenance
                        out["delta"] = job.spec.delta
                    self._send(200, out)
                elif job.state == STATE_FAILED:
                    self._send(500, job.describe())
                else:
                    self._send(202, job.describe())
                return
        self._send(404, {"error": f"no such endpoint {self.path}"})


def make_http_server(service: ConsensusService, host: str = "127.0.0.1",
                     port: int = 8765) -> ThreadingHTTPServer:
    """Bind the HTTP front end (``port=0`` picks a free port)."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.fcserve_service = service  # type: ignore[attr-defined]
    return httpd
