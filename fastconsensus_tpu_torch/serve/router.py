"""fcfleet router: a torch-free front-end tier over N fcserve replicas.

The port's own copy of ``fastconsensus_tpu/serve/router.py``, with the
same names and wire.  It routes to replicas of either package (they
answer the same endpoints with the same payloads); the fleet manager
(serve/fleet.py) spawns the port's, ``python -m
fastconsensus_tpu_torch.serve``.

Everything below ``make_router_server`` scales *inside* one process:
the fcpool worker pool drives one host's GPUs, StickyScheduler keeps
each bucket on the worker that first ran it (its kernels built, its
allocator warm), and the admission queue bounds one replica's intake.
This module is the same argument one level up — N whole
`ConsensusService` replicas behind one stdlib-HTTP router, with the
router playing the scheduler's role across *hosts*:

* **consistent-hash ring** (:class:`HashRing`) — the route key is the
  cross-host analogue of ``JobSpec.batch_group`` (shape bucket +
  config-minus-seed, derived torch-free from the raw submit payload),
  so same-group traffic lands on one replica and keeps that replica's
  result cache, coalesce groups and shaping estimators hot.  The ring
  hashes ``replica#vnode`` points with sha1 (NEVER Python ``hash()`` —
  placement must be deterministic across processes and restarts), so
  adding or removing a replica re-homes only ~1/N of the groups
  instead of reshuffling everything;
* **health + cordon** (:class:`FleetRouter` poll loop) — each replica's
  ``/healthz`` is polled; a poll failure, a watchdog trip, or a
  draining replica cordons it.  Cordoned replicas stay ON the ring but
  are excluded at lookup (the pool's worker-cordon semantics one
  level up): their groups re-home to ring successors and come back
  when the replica does.  In-flight submissions homed on a cordoned replica are
  REPLAYED to a successor with the dead replica excluded — the fleet
  mirror of ``Job.exclude_device`` requeueing;
* **fleet-aware backpressure** — the poll loop also reads each
  replica's typed ``/metricsz`` shaping block; submit routes around
  replicas whose queues are saturated, a 429 from the home replica
  tries ring successors, and only when EVERY eligible replica sheds
  does the router answer 429 itself — carrying the DEEPEST
  ``retry_after_s`` observed, because the honest fleet-wide answer is
  "when the slowest queue you might land on has drained";
* **cross-replica cache reuse** — the router remembers which replicas
  hold which ``content_hash`` (learned from submit/result traffic);
  a submit that misses on its home replica but is known warm on a
  sibling triggers a fetch (``GET /cachez/<hash>``) + seed
  (``POST /cachez``) so the queued job completes from cache via the
  worker's pre-run re-probe, with zero device work;
* **prewarm shipping** — ``preview_owner`` lets a joining replica
  learn which replica it will inherit groups from, so the fleet
  manager (serve/fleet.py) can ship the donor's warm-spec and cache
  snapshot before the new replica takes traffic.

The module is deliberately torch-free and jax-free (the thin-client
posture of serve/client.py): the grid math it needs for route keys
comes from the stdlib-only ladder geometry (analysis/footprint.py),
which serve/bucketer.py itself imports, not from serve/bucketer.py,
whose graph import pulls in torch.  A router
host needs no GPU and must never pay the engine's import cost.
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

from fastconsensus_tpu_torch.analysis.footprint import (MIN_EDGE_CLASS,
                                                        MIN_NODE_CLASS, grid_up)
from fastconsensus_tpu_torch.obs import counters as obs_counters
from fastconsensus_tpu_torch.obs import flight as obs_flight
from fastconsensus_tpu_torch.obs import latency as obs_latency
from fastconsensus_tpu_torch.obs.fleettrace import (TRACE_HEADER,
                                                    aggregate_fleet)

_logger = logging.getLogger("fastconsensus_tpu_torch")

# Virtual nodes per replica on the ring.  Enough that each replica's
# arc is statistically even (placement spread ~1/sqrt(vnodes)) without
# making ring rebuilds or successor walks measurable — 128 keeps the
# measured re-home fraction on an add/remove within the advertised
# ceil(|groups|/N) across the tested group-set sizes (tests/
# test_fleet.py pins it; 64 overshoots the bound by a few percent).
DEFAULT_VNODES = 128

# Config fields that shape the route key — the payload-level mirror of
# JobSpec.batch_group's "same config in every field but the seed":
# anything that changes executable identity or result content keeps
# traffic apart; the seed deliberately does not (distinct seeds share
# executables and coalesce into one batched call on the replica).
_ROUTE_CONFIG_FIELDS = ("algorithm", "n_p", "tau", "delta", "max_rounds",
                       "gamma", "auto_grow", "warm_start", "align_frac",
                       "closure_sampler", "closure_tau")


class NoEligibleReplica(RuntimeError):
    """Every replica on the ring is cordoned or excluded."""


def route_key(payload: Dict[str, Any]) -> str:
    """The consistent-hash routing key for one ``/submit`` payload.

    Torch-free mirror of ``JobSpec.batch_group``: the ``{2^k, 3*2^k}``
    shape-bucket classes (analysis/footprint.grid_up — the very grid
    serve/bucketer.py pads onto) plus the sorted config-minus-seed
    fields.  The edge count is the RAW payload count, not the deduped
    canonical count the replica computes — affinity is a placement
    heuristic, and a near-bucket-boundary graph landing one class off
    costs one extra warm bucket on one replica, not correctness.
    """
    parent = payload.get("parent")
    if parent is not None:
        # fcdelta (serve/delta.py): a delta submission carries no graph
        # of its own — only a parent content hash plus edge changes —
        # so shape-affinity has nothing to hash.  Route on the parent
        # hash instead: every delta evolving one graph lands on one
        # replica, which (after the first parent prefetch) holds the
        # parent entry and answers the whole lineage warm.
        return f"delta|{parent}"
    if "edgelist" in payload:
        n_edges = sum(1 for ln in str(payload["edgelist"]).splitlines()
                      if ln.strip() and not ln.lstrip().startswith("#"))
    else:
        n_edges = len(payload.get("edges") or ())
    n_nodes = int(payload.get("n_nodes") or 0)
    n_class = grid_up(max(n_nodes, 1), MIN_NODE_CLASS)
    e_class = grid_up(max(n_edges, 1), MIN_EDGE_CLASS)
    cfg = "|".join(f"{f}={payload[f]!r}" for f in _ROUTE_CONFIG_FIELDS
                   if f in payload)
    return f"n{n_class}_e{e_class}|{cfg}"


class HashRing:
    """Consistent-hash ring: route key -> replica name.

    Placement is a pure function of the member set — sha1 over
    ``name#vnode`` for the points, sha1 over the key for lookups — so
    two router processes with the same members agree on every
    placement, and a member add/remove moves only the arcs adjacent to
    its vnodes (~1/N of the keyspace).  Exclusion (cordoned replicas)
    happens at LOOKUP, not by ring surgery: the excluded member keeps
    its arcs and reclaims them the moment it is eligible again,
    instead of triggering a second re-home on recovery.
    """

    def __init__(self, replicas: Tuple[str, ...] = (),
                 vnodes: int = DEFAULT_VNODES) -> None:
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._points: List[Tuple[int, str]] = []   # sorted (hash, name)
        self._names: List[str] = []
        for name in replicas:
            self.add(name)

    @staticmethod
    def _hash(data: str) -> int:
        return int.from_bytes(
            hashlib.sha1(data.encode("utf-8")).digest()[:8], "big")

    def add(self, name: str) -> None:
        if name in self._names:
            raise ValueError(f"replica {name!r} already on the ring")
        self._names.append(name)
        for v in range(self.vnodes):
            bisect.insort(self._points, (self._hash(f"{name}#{v}"), name))

    def remove(self, name: str) -> None:
        if name not in self._names:
            raise ValueError(f"replica {name!r} not on the ring")
        self._names.remove(name)
        self._points = [(h, n) for h, n in self._points if n != name]

    def members(self) -> List[str]:
        return list(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def route(self, key: str,
              exclude: FrozenSet[str] = frozenset()) -> str:
        """The replica owning ``key``: the first ring point clockwise
        of the key's hash whose member is not excluded.  Walking
        successors (instead of re-hashing) is what makes exclusion a
        ~1/N re-home: every key NOT on an excluded arc keeps its home.
        """
        if not self._points:
            raise NoEligibleReplica("the ring has no replicas")
        h = self._hash(key)
        idx = bisect.bisect_right(self._points, (h, "￿"))
        seen: set = set()
        for i in range(len(self._points)):
            _, name = self._points[(idx + i) % len(self._points)]
            if name in seen:
                continue
            seen.add(name)
            if name not in exclude:
                return name
            if len(seen) == len(self._names):
                break
        raise NoEligibleReplica(
            f"all {len(self._names)} replica(s) excluded for {key!r}")

    def preview_owner(self, key: str, joining: str,
                      exclude: FrozenSet[str] = frozenset()) -> Optional[str]:
        """Which CURRENT member would lose ``key`` to ``joining`` —
        the donor whose warm-spec/cache snapshot the joiner should
        inherit (serve/fleet.py prewarm shipping).  None when the key
        would not re-home."""
        trial = HashRing((*self._names, joining), vnodes=self.vnodes)
        if trial.route(key, exclude) != joining:
            return None
        return self.route(key, exclude)


class _ReplicaView:
    """The router's view of one replica: URL, cordon state, and the
    last polled health/shaping snapshot.  Mutated only by the poll
    loop and the submit path's failure handling, under the router
    lock."""

    def __init__(self, name: str, base_url: str) -> None:
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.cordoned = False
        self.cordon_reason: Optional[str] = None
        self.poll_failures = 0          # consecutive
        self.last_poll_ts: Optional[float] = None
        self.queue_depth = 0
        self.queue_max_depth = 0
        self.draining = False
        self.watchdog_trips_seen: Optional[int] = None
        self.retry_after_hint_s: Optional[float] = None
        self.last_bundle: Optional[str] = None
        # route keys this replica owned at cordon time.  _assignments is
        # last-home bookkeeping the live traffic overwrites as soon as
        # the re-homed groups land elsewhere, so successor election
        # (fleet.py on_death -> _successor_of) needs this frozen copy —
        # electing from _assignments alone races the very re-homing the
        # election is about.
        self.rehomed_keys: Tuple[str, ...] = ()

    def saturated(self) -> bool:
        return (self.queue_max_depth > 0
                and self.queue_depth >= self.queue_max_depth)

    def describe(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "url": self.base_url,
            "state": "cordoned" if self.cordoned else "up",
            "cordon_reason": self.cordon_reason,
            "poll_failures": self.poll_failures,
            "queue_depth": self.queue_depth,
            "queue_max_depth": self.queue_max_depth,
            "draining": self.draining,
            "watchdog_trips": self.watchdog_trips_seen,
            "retry_after_hint_s": self.retry_after_hint_s,
            "last_bundle": self.last_bundle,
            "rehomed_keys": list(self.rehomed_keys),
        }


class _RouterJob:
    """One forwarded submission's bookkeeping: enough to replay it."""

    def __init__(self, fleet_id: str, body: bytes, key: str,
                 trace: Optional[str] = None) -> None:
        self.fleet_id = fleet_id
        self.body = body                 # the raw /submit JSON bytes
        self.route_key = key
        self.trace = trace               # fctrace id (X-FCTPU-Trace)
        self.replica: Optional[str] = None
        self.replica_job_id: Optional[str] = None
        self.content_hash: Optional[str] = None
        # fcdelta: the parent content hash a delta submission names —
        # set at admit so every forward (first try AND replay) can
        # prefetch the parent entry into the receiving replica
        self.parent_hash: Optional[str] = None
        self.excluded: set = set()       # replicas that failed this job
        self.replays = 0
        self.done = False


def _http_json(url: str, payload_bytes: Optional[bytes] = None,
               timeout: float = 10.0,
               extra_headers: Optional[Dict[str, str]] = None
               ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
    """One JSON request; returns (status, body, headers).  HTTP error
    statuses return normally (the router maps them itself); transport
    errors raise OSError.  ``extra_headers`` is how trace context rides
    the forwarded hop (fctrace: the X-FCTPU-Trace header)."""
    headers = {"Accept": "application/json"}
    if payload_bytes is not None:
        headers["Content-Type"] = "application/json"
    if extra_headers:
        headers.update(extra_headers)
    req = urllib.request.Request(url, data=payload_bytes, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = json.loads(resp.read() or b"{}")
            return resp.status, body, dict(resp.headers)
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read() or b"{}")
        except ValueError:
            body = {"error": str(e)}
        return e.code, body, dict(e.headers)


class FleetRouter:
    """Route ``/submit`` traffic across N fcserve replicas.

    Thread model: HTTP handler threads call :meth:`submit` /
    :meth:`status` / :meth:`result`; one daemon poll thread refreshes
    replica health.  All shared state (replica views, ring membership,
    the job table, the content-hash index) is guarded by ``_lock``;
    outbound HTTP happens OUTSIDE the lock — a slow replica must never
    stall the router's other handler threads on lock convoy.
    """

    def __init__(self, replicas: Dict[str, str],
                 poll_s: float = 0.5,
                 vnodes: int = DEFAULT_VNODES,
                 timeout: float = 30.0,
                 poll_timeout: float = 2.0,
                 poll_failures_to_cordon: int = 2,
                 max_tracked_jobs: int = 4096) -> None:
        self._lock = threading.Lock()
        self._views: Dict[str, _ReplicaView] = {
            name: _ReplicaView(name, url) for name, url in replicas.items()}
        self.ring = HashRing(tuple(self._views), vnodes=vnodes)
        self.poll_s = float(poll_s)
        self.timeout = float(timeout)
        self.poll_timeout = float(poll_timeout)
        self.poll_failures_to_cordon = int(poll_failures_to_cordon)
        self.max_tracked_jobs = int(max_tracked_jobs)
        self._jobs: Dict[str, _RouterJob] = {}
        self._job_order: List[str] = []      # FIFO retention
        self._hash_holders: Dict[str, set] = {}   # content_hash -> names
        self._assignments: Dict[str, str] = {}    # route key -> last home
        self._seq = itertools.count(1)
        self._trace_seq = itertools.count(1)
        self._reg = obs_counters.get_registry()
        # fctrace: router-phase latency (router.phase.*) and the
        # router's own flight events record into the process-global
        # registries — same posture as the replica, so /metricsz and
        # post-mortem bundles of a router host need no special casing.
        self._lat = obs_latency.get_latency_registry()
        self._flight = obs_flight.get_flight_recorder()
        self._stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None

    def _mint_trace(self) -> str:
        """A fleet-unique trace id: pid + per-router sequence — two
        routers (or a router restart) can never collide, and the id
        stays grep-friendly in logs and flight events."""
        return f"tr-{os.getpid():x}-{next(self._trace_seq):06d}"

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "FleetRouter":
        if self._poll_thread is None:
            self.poll_once()             # first routing decision is informed
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name="fcfleet-poll", daemon=True)
            self._poll_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5.0)
            self._poll_thread = None

    # -- membership ---------------------------------------------------

    def add_replica(self, name: str, base_url: str) -> None:
        """Join a replica: it takes ~1/N of the groups from its ring
        predecessors (serve/fleet.py ships the donor's warm-spec +
        cache snapshot BEFORE calling this, so the re-homed groups
        land warm)."""
        with self._lock:
            if name in self._views:
                raise ValueError(f"replica {name!r} already joined")
            self._views[name] = _ReplicaView(name, base_url)
            self.ring.add(name)
            moved = [k for k, owner in self._assignments.items()
                     if self.ring.route(k, self._excluded_locked()) != owner]
        self._reg.inc("serve.fleet.joins")
        if moved:
            self._reg.inc("serve.fleet.rehomed_buckets", len(moved))

    def preview_donor(self, joining: str,
                      keys: Optional[List[str]] = None) -> Optional[str]:
        """The replica a joiner would inherit most groups from — the
        prewarm-shipping donor.  ``keys`` defaults to every route key
        the router has seen."""
        with self._lock:
            keys = list(keys if keys is not None else self._assignments)
            exclude = self._excluded_locked()
            donors: Dict[str, int] = {}
            for k in keys:
                d = self.ring.preview_owner(k, joining, exclude)
                if d is not None:
                    donors[d] = donors.get(d, 0) + 1
        if not donors:
            return None
        return max(sorted(donors), key=lambda n: donors[n])

    def cordon(self, name: str, reason: str) -> None:
        """Take a replica out of routing (ring membership kept): its
        groups re-home to ring successors and its in-flight
        submissions replay with it excluded."""
        with self._lock:
            view = self._views.get(name)
            if view is None or view.cordoned:
                return
            view.cordoned = True
            view.cordon_reason = reason
            moved = [k for k, owner in self._assignments.items()
                     if owner == name]
            view.rehomed_keys = tuple(moved)
            replay = [j for j in self._jobs.values()
                      if j.replica == name and not j.done]
        self._reg.inc("serve.fleet.cordons")
        if moved:
            self._reg.inc("serve.fleet.rehomed_buckets", len(moved))
        _logger.warning("fcfleet: cordoned replica %s (%s); re-homing "
                        "%d group(s), replaying %d in-flight job(s)",
                        name, reason, len(moved), len(replay))
        for job in replay:
            self._replay(job, exclude_also=name)

    def uncordon(self, name: str) -> None:
        with self._lock:
            view = self._views.get(name)
            if view is None or not view.cordoned:
                return
            view.cordoned = False
            view.cordon_reason = None
            view.poll_failures = 0
        self._reg.inc("serve.fleet.uncordons")

    def _excluded_locked(self) -> FrozenSet[str]:
        return frozenset(n for n, v in self._views.items() if v.cordoned)

    # -- health poll --------------------------------------------------

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            # fcheck: ok=swallowed-error (not silent: the traceback
            # goes to the log below, and per-replica failures are
            # counted inside poll_once — this backstop only keeps one
            # bad sweep from killing the health authority)
            except Exception:  # noqa: BLE001 — the poll loop is the
                # fleet's health authority; one bad snapshot must not
                # kill it (the failure is counted per replica below)
                _logger.exception("fcfleet: poll loop iteration failed")

    def poll_once(self) -> None:
        """One health sweep: refresh every replica's view; cordon on
        repeated poll failure, on a watchdog trip, or on a draining
        replica; uncordon a poll-failure cordon that answers again."""
        with self._lock:
            targets = [(v.name, v.base_url) for v in self._views.values()]
        for name, base_url in targets:
            self._reg.inc("serve.fleet.polls")
            try:
                status, body, _ = _http_json(base_url + "/healthz",
                                             timeout=self.poll_timeout)
                if status != 200:
                    raise OSError(f"/healthz answered HTTP {status}")
            # fcheck: ok=swallowed-error (not swallowed: the error is
            # handed to _note_poll_failure, which stamps
            # serve.fleet.poll_failures and drives the cordon decision)
            except (OSError, ValueError) as e:
                self._note_poll_failure(name, e)
                continue
            self._note_poll_ok(name, base_url, body)

    def _note_poll_failure(self, name: str, err: Exception) -> None:
        self._reg.inc("serve.fleet.poll_failures")
        with self._lock:
            view = self._views.get(name)
            if view is None:
                return
            view.poll_failures += 1
            should_cordon = (not view.cordoned and view.poll_failures
                             >= self.poll_failures_to_cordon)
        if should_cordon:
            self.cordon(name, f"poll failure x{self.poll_failures_to_cordon}"
                              f" ({type(err).__name__})")

    def _note_poll_ok(self, name: str, base_url: str,
                      body: Dict[str, Any]) -> None:
        shaping_hint = None
        try:
            # one extra GET per poll: the typed shaping block is where
            # retry_after_hint_s lives — the fleet-backpressure signal
            status, m, _ = _http_json(base_url + "/metricsz",
                                      timeout=self.poll_timeout)
            if status == 200:
                shaping_hint = (m.get("shaping") or {}).get(
                    "retry_after_hint_s")
        # fcheck: ok=swallowed-error (the hint is advisory — a replica
        # that answered /healthz but not /metricsz stays routable; the
        # next poll retries)
        except (OSError, ValueError):
            pass
        trips = int(body.get("watchdog_trips", 0) or 0)
        draining = bool(body.get("draining", False))
        cordon_reason = None
        uncordon = False
        with self._lock:
            view = self._views.get(name)
            if view is None:
                return
            view.poll_failures = 0
            view.last_poll_ts = time.monotonic()
            view.queue_depth = int(body.get("queue_depth", 0) or 0)
            view.queue_max_depth = int(body.get("queue_max_depth", 0) or 0)
            view.draining = draining
            view.retry_after_hint_s = shaping_hint
            view.last_bundle = body.get("last_bundle")
            if view.watchdog_trips_seen is None:
                # first successful poll sets the trip baseline: a
                # replica restarted after an incident starts clean
                view.watchdog_trips_seen = trips
            if draining and not view.cordoned:
                cordon_reason = "draining"
            elif trips > view.watchdog_trips_seen and not view.cordoned:
                view.watchdog_trips_seen = trips
                cordon_reason = f"watchdog trip ({trips} total)"
            elif (view.cordoned and not draining
                  and view.cordon_reason
                  and view.cordon_reason.startswith("poll failure")):
                # only poll-failure cordons self-heal on a good poll; a
                # trip cordon stays until an operator (or the fleet
                # manager) uncordons deliberately
                uncordon = True
        if cordon_reason is not None:
            self.cordon(name, cordon_reason)
        elif uncordon:
            self.uncordon(name)

    # -- routing ------------------------------------------------------

    def _candidates(self, route_key: str) -> List[_ReplicaView]:
        """Eligible replicas for one submit, best first: the ring home,
        then its successors — with saturated replicas (last polled
        queue at max depth) moved to the back rather than dropped,
        because a stale poll must degrade to "try later in the walk",
        never to "unroutable"."""
        with self._lock:
            exclude = self._excluded_locked()
            ordered: List[_ReplicaView] = []
            seen: set = set()
            walk_exclude = set(exclude)
            while True:
                try:
                    # fcheck: ok=key-reuse (route_key is a batch-group
                    # routing string, not a PRNG key; re-routing it with
                    # a growing exclusion set is the successor walk)
                    name = self.ring.route(route_key,
                                           frozenset(walk_exclude))
                # fcheck: ok=swallowed-error (an exhausted ring is this
                # walk's normal exit; the empty result re-raises
                # NoEligibleReplica right below, so nothing is lost)
                except NoEligibleReplica:
                    break
                if name in seen:
                    break
                seen.add(name)
                walk_exclude.add(name)
                ordered.append(self._views[name])
        if not ordered:
            raise NoEligibleReplica(
                "every replica is cordoned; nothing can take this job")
        fresh = [v for v in ordered if not v.saturated()]
        saturated = [v for v in ordered if v.saturated()]
        if saturated:
            self._reg.inc("serve.fleet.routed_around_saturation",
                          len(saturated))
        return fresh + saturated

    def submit(self, body: bytes, trace: Optional[str] = None
               ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        """Forward one ``/submit`` body: home replica first, ring
        successors on 429/503/transport failure.  Returns the
        (status, payload, headers) the router should answer with —
        2xx payloads get the router's own ``job_id`` so /status and
        /result survive a later replay to a different replica.

        ``trace`` is the client's X-FCTPU-Trace header if it sent one;
        otherwise the router mints one here.  Either way the id rides
        the forwarded hop as the same header (the replica folds it into
        the JobSpec), is stamped on the router's own flight events, and
        is echoed back to the client in the answer."""
        self._reg.inc("serve.fleet.submits")
        t0 = time.monotonic()
        try:
            payload = json.loads(body or b"{}")
            key = route_key(payload)
        except (ValueError, TypeError) as e:
            return 400, {"error": f"bad request: {e}"}, {}
        if not trace and isinstance(payload, dict):
            trace = payload.get("trace")
        trace = str(trace) if trace else self._mint_trace()
        job = _RouterJob(f"f{next(self._seq):06d}", bytes(body), key,
                         trace=trace)
        if isinstance(payload, dict) and payload.get("parent"):
            job.parent_hash = str(payload["parent"])
        self._lat.hist("router.phase.admit").record(
            time.monotonic() - t0)
        status, out, headers = self._forward(job)
        if status in (200, 202):
            with self._lock:
                self._jobs[job.fleet_id] = job
                self._job_order.append(job.fleet_id)
                while len(self._job_order) > self.max_tracked_jobs:
                    dropped = self._job_order.pop(0)
                    self._jobs.pop(dropped, None)
            out = dict(out, job_id=job.fleet_id,
                       fleet_replica=job.replica, trace=trace)
            self._flight.record("route", job=job.fleet_id, trace=trace,
                                replica=job.replica,
                                cached=bool(out.get("cached")))
            self._maybe_fetch_on_miss(job, out)
        return status, out, headers

    def _forward(self, job: _RouterJob) -> Tuple[int, Dict[str, Any],
                                                 Dict[str, str]]:
        deepest_retry: Optional[float] = None
        shed_seen = False
        last_err: Optional[Tuple[int, Dict[str, Any], Dict[str, str]]] = None
        t0 = time.monotonic()
        try:
            candidates = self._candidates(job.route_key)
        except NoEligibleReplica as e:
            self._reg.inc("serve.fleet.unroutable")
            return 503, {"error": str(e), "fleet": True,
                         "draining": False}, {}
        self._lat.hist("router.phase.ring_lookup").record(
            time.monotonic() - t0)
        fwd_headers = {TRACE_HEADER: job.trace} if job.trace else None
        for view in candidates:
            if view.name in job.excluded:
                continue
            if job.parent_hash is not None:
                # fcdelta: make the parent local BEFORE the delta
                # arrives — a replica can only resolve a delta against
                # a parent entry it holds; running this per-candidate
                # (not once per submit) keeps replays and successor
                # hops resolvable too
                self._prefetch_parent(job.parent_hash, view.name)
            try:
                status, out, headers = _http_json(
                    view.base_url + "/submit", job.body,
                    timeout=self.timeout, extra_headers=fwd_headers)
            except (OSError, ValueError) as e:
                # transport failure IS a health signal, not just a
                # routing miss — count it toward the cordon threshold
                self._note_poll_failure(view.name, e)
                self._reg.inc("serve.fleet.forward_errors")
                continue
            if status in (200, 202):
                with self._lock:
                    job.replica = view.name
                    job.replica_job_id = str(out.get("job_id"))
                    job.content_hash = out.get("content_hash")
                    self._assignments[job.route_key] = view.name
                    if job.content_hash:
                        self._hash_holders.setdefault(
                            job.content_hash, set()).add(view.name)
                    if out.get("cached"):
                        job.done = True
                self._reg.inc("serve.fleet.forwards")
                return status, out, headers
            if status == 429:
                self._reg.inc("serve.fleet.backpressure_hops")
                r = out.get("retry_after_s")
                if r is not None:
                    deepest_retry = max(deepest_retry or 0.0, float(r))
                shed_seen = shed_seen or bool(out.get("shed"))
                last_err = (status, out, headers)
                continue
            if status == 503:
                # the replica is draining; the poll loop will cordon it
                # on its next sweep — this submit just walks on
                self._reg.inc("serve.fleet.draining_hops")
                last_err = (status, out, headers)
                continue
            # 4xx (bad request / too large) is the CLIENT's problem on
            # every replica equally — answer it verbatim, no walking
            return status, out, headers
        if deepest_retry is not None or (last_err and last_err[0] == 429):
            self._reg.inc("serve.fleet.shed")
            retry_s = deepest_retry if deepest_retry is not None else 1.0
            return (429,
                    {"error": "every eligible replica is shedding",
                     "backpressure": True, "fleet": True,
                     "shed": shed_seen,
                     "retry_after_s": round(retry_s, 3)},
                    {"Retry-After": str(max(1, int(retry_s + 0.999)))})
        if last_err is not None:
            return last_err
        self._reg.inc("serve.fleet.unroutable")
        return 503, {"error": "no replica accepted the job",
                     "fleet": True, "draining": False}, {}

    def _replay(self, job: _RouterJob,
                exclude_also: Optional[str] = None) -> bool:
        """Resubmit a job's stored body, excluding replicas that
        already failed it (the fleet mirror of Job.exclude_device).  A
        job that burns every replica fails as itself — the caller sees
        the terminal error, never a silent retry loop."""
        if exclude_also is not None:
            job.excluded.add(exclude_also)
        job.replays += 1
        self._reg.inc("serve.fleet.replays")
        t0 = time.monotonic()
        status, out, _ = self._forward(job)
        self._lat.hist("router.phase.replay").record(
            time.monotonic() - t0)
        self._flight.record("rehome_replay", job=job.fleet_id,
                            trace=job.trace, replica=job.replica,
                            replays=job.replays,
                            excluded=",".join(sorted(job.excluded)),
                            ok=status in (200, 202))
        if status in (200, 202):
            self._maybe_fetch_on_miss(job, out)
            return True
        _logger.warning("fcfleet: replay of %s failed everywhere "
                        "(HTTP %s)", job.fleet_id, status)
        self._reg.inc("serve.fleet.replay_failures")
        return False

    # -- cross-replica cache ------------------------------------------

    def note_holder(self, content_hash: str, name: str) -> None:
        """Register ``name`` as holding a cached result.  fcfleet death
        inheritance calls this (serve/fleet.py ``on_death`` loads a
        dead sibling's spill into the successor): without it the hash
        index still points at the corpse and fetch-on-miss can never
        source from the inheritor."""
        with self._lock:
            if name in self._views:
                self._hash_holders.setdefault(
                    content_hash, set()).add(name)

    def _maybe_fetch_on_miss(self, job: _RouterJob,
                             out: Dict[str, Any]) -> None:
        """A submit that MISSED on its home replica but whose content
        hash is known warm on a live sibling: fetch the sibling's
        cached result and seed it into the home replica, so the queued
        job completes via the worker's pre-run cache re-probe with no
        device work."""
        if out.get("cached") or not job.content_hash or job.replica is None:
            return
        with self._lock:
            holders = [n for n in self._hash_holders.get(
                           job.content_hash, ())
                       if n != job.replica and n in self._views
                       and not self._views[n].cordoned]
            home_url = self._views[job.replica].base_url
            holder_urls = [(n, self._views[n].base_url) for n in holders]
        for name, url in holder_urls:
            try:
                status, res, _ = _http_json(
                    url + f"/cachez/{job.content_hash}",
                    timeout=self.timeout)
            # fcheck: ok=swallowed-error (a holder that cannot answer
            # is a miss for that holder only; the walk tries the next
            # one and cache_fetch_misses / cache_no_holder carry the
            # aggregate outcome)
            except (OSError, ValueError):
                continue
            if status != 200:
                self._reg.inc("serve.fleet.cache_fetch_misses")
                continue
            self._reg.inc("serve.fleet.cache_fetch_hits")
            try:
                seed_status, _, _ = _http_json(
                    home_url + "/cachez",
                    json.dumps(res).encode("utf-8"),
                    timeout=self.timeout)
            except (OSError, ValueError):
                return
            if seed_status == 200:
                self._reg.inc("serve.fleet.cache_seeded")
                with self._lock:
                    self._hash_holders.setdefault(
                        job.content_hash, set()).add(job.replica)
            return
        if holder_urls:
            return
        self._reg.inc("serve.fleet.cache_no_holder")

    def _prefetch_parent(self, parent_hash: str, target: str) -> None:
        """The forward-looking twin of :meth:`_maybe_fetch_on_miss`,
        for fcdelta (serve/delta.py): a delta submission is about to
        be forwarded to ``target``, and it can only resolve there if
        the PARENT's cached result is local to that replica.  When the
        hash index says a live sibling holds the parent and ``target``
        does not, copy it over (``GET /cachez/<hash>`` on the holder,
        ``POST /cachez`` on the target — the wire shape carries the
        graph + config lineage blocks) before forwarding, so the
        replica answers incrementally instead of 404ing a parent the
        fleet actually has.  No holder anywhere means the 404 the
        replica will return is the honest fleet-wide answer."""
        with self._lock:
            holders = self._hash_holders.get(parent_hash, set())
            if target in holders or target not in self._views:
                return
            sources = [(n, self._views[n].base_url) for n in holders
                       if n != target and n in self._views
                       and not self._views[n].cordoned]
            target_url = self._views[target].base_url
        if not sources:
            return
        for _name, url in sources:
            try:
                status, res, _ = _http_json(
                    url + f"/cachez/{parent_hash}", timeout=self.timeout)
            # fcheck: ok=swallowed-error (an unreachable holder is a
            # miss for that holder only; the next source is tried, and
            # the replica's own parent-miss 404 stays the honest
            # terminal answer when every source fails)
            except (OSError, ValueError):
                continue
            if status != 200:
                self._reg.inc("serve.fleet.cache_fetch_misses")
                continue
            try:
                seed_status, _, _ = _http_json(
                    target_url + "/cachez",
                    json.dumps(res).encode("utf-8"),
                    timeout=self.timeout)
            # fcheck: ok=swallowed-error (a target that cannot accept
            # the seed will also fail the forward right after — THAT
            # path owns the error accounting)
            except (OSError, ValueError):
                return
            if seed_status == 200:
                self._reg.inc("serve.fleet.delta_parent_prefetch")
                with self._lock:
                    self._hash_holders.setdefault(
                        parent_hash, set()).add(target)
            return

    # -- status / result proxy ----------------------------------------

    def _proxy(self, kind: str, fleet_id: str
               ) -> Tuple[int, Dict[str, Any]]:
        with self._lock:
            job = self._jobs.get(fleet_id)
        if job is None:
            return 404, {"error": "unknown job id"}
        for _ in range(len(self.ring) + 1):
            with self._lock:
                replica = job.replica
                view = self._views.get(replica) if replica else None
            if view is None:
                return 500, {"error": f"job {fleet_id} lost its replica"}
            t0 = time.monotonic()
            try:
                status, out, _ = _http_json(
                    f"{view.base_url}/{kind}/{job.replica_job_id}",
                    timeout=self.timeout)
                # per-replica proxy-overhead attribution (fctrace):
                # the router-side cost of one proxied hop to THIS
                # replica — network + replica handler time, the slice
                # of fleet latency no replica-side histogram can see
                self._lat.hist("router.phase.proxy",
                               replica=replica).record(
                    time.monotonic() - t0)
            except (OSError, ValueError) as e:
                # the replica died under this job: replay elsewhere and
                # answer "still pending" — the client's poll loop keeps
                # working through the failover
                self._note_poll_failure(replica, e)
                if not self._replay(job, exclude_also=replica):
                    return 503, {"error": f"replica {replica} is gone "
                                          f"and no replica can replay "
                                          f"job {fleet_id}"}
                continue
            if status == 500 and kind == "result":
                # the job FAILED server-side (e.g. an injected device-
                # path fault): burn that replica for this job and
                # replay — the fleet answer is "someone else runs it",
                # not the replica's stack trace
                if self._replay(job, exclude_also=replica):
                    continue
                return status, dict(out, fleet_replica=replica,
                                    fleet_replays=job.replays)
            if status == 404:
                # the replica restarted and forgot the job: same
                # failover as a dead replica
                if self._replay(job, exclude_also=replica):
                    continue
                return 404, {"error": f"job {fleet_id} lost by "
                                      f"{replica} and unreplayable"}
            if status == 200 and kind == "result":
                with self._lock:
                    job.done = True
                    if job.content_hash:
                        self._hash_holders.setdefault(
                            job.content_hash, set()).add(replica)
                # one flight event per COMPLETED proxy, not per poll:
                # a 2 ms client poll loop would otherwise flood the
                # bounded rings with thousands of identical events
                self._flight.record("proxy", job=job.fleet_id,
                                    trace=job.trace, replica=replica,
                                    replays=job.replays)
            return status, dict(out, fleet_replica=replica,
                                fleet_replays=job.replays)
        return 503, {"error": f"job {fleet_id} could not be served "
                              f"by any replica"}

    def status(self, fleet_id: str) -> Tuple[int, Dict[str, Any]]:
        return self._proxy("status", fleet_id)

    def result(self, fleet_id: str) -> Tuple[int, Dict[str, Any]]:
        return self._proxy("result", fleet_id)

    # -- introspection ------------------------------------------------

    def fleet_stats(self) -> Dict[str, Any]:
        counters = self._reg.counters()
        with self._lock:
            replicas = [v.describe() for v in self._views.values()]
            assignments = dict(self._assignments)
            tracked = len(self._jobs)
            in_flight = sum(1 for j in self._jobs.values() if not j.done)
            hash_index = len(self._hash_holders)
        return {
            "replicas": replicas,
            "ring": {"members": self.ring.members(),
                     "vnodes": self.ring.vnodes},
            "assignments": assignments,
            "jobs_tracked": tracked,
            "jobs_in_flight": in_flight,
            "content_hash_index": hash_index,
            "counters": {k: n for k, n in sorted(counters.items())
                         if k.startswith("serve.fleet.")},
        }

    def fleetz(self) -> Dict[str, Any]:
        """The ``GET /fleetz`` payload: every replica's ``/metricsz``
        scraped live and folded into one fleet view (fctrace
        ``aggregate_fleet``) — latency histograms exact-merged across
        replicas, SLO met/missed summed per class, plus the router's
        own ``router.phase.*`` family and per-replica proxy-overhead
        attribution.  A replica that cannot be scraped is reported
        ``ok: false``, never silently dropped."""
        self._reg.inc("serve.fleet.fleetz")
        with self._lock:
            targets = [(v.name, v.base_url)
                       for v in self._views.values()]
        per_replica: Dict[str, Optional[Dict[str, Any]]] = {}
        for name, base_url in targets:
            try:
                status, m, _ = _http_json(base_url + "/metricsz",
                                          timeout=self.poll_timeout)
                per_replica[name] = m if status == 200 else None
            # fcheck: ok=swallowed-error (the unscrapable replica is
            # REPORTED — aggregate_fleet marks it ok:false; nothing to
            # re-raise in an aggregation that must answer regardless)
            except (OSError, ValueError):
                per_replica[name] = None
        return aggregate_fleet(per_replica,
                               router_latency=self._lat.snapshot(),
                               router_fleet=self.fleet_stats())


# ---------------------------------------------------------------------
# Router HTTP front end (stdlib http.server, the replica handler's twin)
# ---------------------------------------------------------------------

class _RouterHandler(BaseHTTPRequestHandler):
    """Routes: POST /submit; GET /status/<id> /result/<id> /healthz
    /metricsz — the same surface as one replica, so every existing
    client (serve/client.py, cli.py --server) talks to the fleet
    unchanged — plus the router-only fctrace surface: GET /fleetz
    (exact-merged fleet metrics) and GET /debugz/flight (the router's
    own trace-stamped flight snapshot)."""

    server_version = "fcfleet/1"
    protocol_version = "HTTP/1.1"

    @property
    def router(self) -> FleetRouter:
        return self.server.fcfleet_router  # type: ignore[attr-defined]

    def log_message(self, fmt: str, *args) -> None:  # noqa: A003
        _logger.debug("fcfleet http: " + fmt, *args)

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
        obs_counters.get_registry().inc("serve.fleet.http_unhandled_errors")
        _logger.exception("fcfleet http: unhandled handler error")
        try:
            self._send(500, {"error": "internal error: "
                                      f"{type(e).__name__}: {e}"})
        except OSError:  # fcheck: ok=swallowed-error: the client socket is already gone — there is no one left to answer; the counter above carries the failure
            pass

    def do_POST(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        try:
            if self.path.rstrip("/") != "/submit":
                self._send(404, {"error": f"no such endpoint {self.path}"})
                return
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            status, out, headers = self.router.submit(
                body, trace=self.headers.get(TRACE_HEADER))
            hop = {k: v for k, v in headers.items()
                   if k.lower() == "retry-after"}
            if out.get("trace"):
                hop[TRACE_HEADER] = str(out["trace"])
            self._send(status, out, headers=hop or None)
        except Exception as e:  # noqa: BLE001 — catch-all status mapping
            self._send_fault(e)

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        try:
            self._do_get()
        except Exception as e:  # noqa: BLE001 — catch-all status mapping
            self._send_fault(e)

    def _do_get(self) -> None:
        path = self.path.rstrip("/")
        if path == "/healthz":
            fleet = self.router.fleet_stats()
            up = sum(1 for r in fleet["replicas"] if r["state"] == "up")
            self._send(200, {"ok": up > 0, "fleet": fleet})
            return
        if path == "/metricsz":
            # scope self-description (fctrace): these counters and
            # histograms are ROUTER-local — a scraper must never read
            # them as fleet totals.  The fleet view lives at /fleetz.
            self._send(200, {
                "scope": "router",
                "fcobs": obs_counters.get_registry().snapshot(),
                "latency": obs_latency.get_latency_registry().snapshot(),
                "fleet": self.router.fleet_stats()})
            return
        if path == "/fleetz":
            self._send(200, self.router.fleetz())
            return
        if path == "/debugz/flight":
            self._send(200, {
                "scope": "router",
                "flight": obs_flight.get_flight_recorder().snapshot()})
            return
        for prefix, fn in (("/status/", self.router.status),
                           ("/result/", self.router.result)):
            if path.startswith(prefix):
                status, out = fn(path[len(prefix):])
                self._send(status, out)
                return
        self._send(404, {"error": f"no such endpoint {self.path}"})


def make_router_server(router: FleetRouter, host: str = "127.0.0.1",
                       port: int = 0) -> ThreadingHTTPServer:
    """Bind the router's HTTP front end (``port=0`` picks a free port)."""
    httpd = ThreadingHTTPServer((host, port), _RouterHandler)
    httpd.fcfleet_router = router  # type: ignore[attr-defined]
    return httpd
