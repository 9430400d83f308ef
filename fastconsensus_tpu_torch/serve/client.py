"""fcserve client: a stdlib (urllib) wrapper over the HTTP endpoints.

The port's own copy of ``fastconsensus_tpu/serve/client.py`` (the
replica half; the fleet router's typed blocks come with the fleet tier).
It reads a replica of either package: the payloads are the same.
Deliberately torch-free, jax-free and numpy-optional at import time, so
a thin front-end process (``cli.py --server``) can submit work without
paying the engine's import cost — the whole point of keeping one warm serving
process is that *clients* stay cheap.

Backpressure is surfaced as a typed exception (:class:`Backpressure`,
HTTP 429) rather than a generic error: callers are expected to catch it
and retry-with-delay / shed load — that contract is what keeps an
overloaded server answering instead of queueing itself to death
(serve/queue.py module notes).
"""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class WorkerState:
    """One pool worker's ``/healthz`` entry, typed (serve/pool.py).

    ``device`` is the worker's device ordinal (the fcobs ``device=i``
    tag); ``kind`` is ``"chip"`` or ``"mesh"`` (the huge tier);
    ``cordoned`` workers died and take no more work; ``buckets`` is the
    bucket residency (bucket key -> jobs served there) the sticky
    scheduler routes on.
    """

    device: int
    kind: str
    alive: bool
    cordoned: bool
    backlog: int
    jobs: int
    batches: int
    busy_s: float
    buckets: Dict[str, int]
    warm: Tuple[str, ...]
    prewarm_pending: int
    error: Optional[str] = None
    mesh_devices: Tuple[int, ...] = ()

    @classmethod
    def from_payload(cls, w: Dict[str, Any]) -> "WorkerState":
        return cls(device=int(w["device"]), kind=str(w["kind"]),
                   alive=bool(w["alive"]), cordoned=bool(w["cordoned"]),
                   backlog=int(w["backlog"]), jobs=int(w["jobs"]),
                   batches=int(w["batches"]),
                   busy_s=float(w["busy_s"]),
                   buckets=dict(w.get("buckets") or {}),
                   warm=tuple(w.get("warm") or ()),
                   prewarm_pending=int(w.get("prewarm_pending", 0)),
                   error=w.get("error"),
                   mesh_devices=tuple(w.get("mesh_devices") or ()))


@dataclasses.dataclass(frozen=True)
class JobTiming:
    """A job's server-side fclat timing block (``/result`` /
    ``/status`` ``timing``), typed: monotonic-derived milliseconds per
    phase, the end-to-end latency, and the observed SLO verdict.  The
    phase names tile the lifetime (queue_wait, hold, dispatch,
    deque_wait, pack, device, fanout, respond — ``hold`` is the
    fcshape hold-for-coalesce window, 0 for un-held jobs), so
    ``phase_sum_ms ~= e2e_ms`` — the attribution-consistency contract
    tests pin server-side."""

    e2e_ms: float
    phases_ms: Dict[str, float]
    phase_sum_ms: float
    slo: str
    slo_target_ms: float
    slo_met: bool

    @classmethod
    def from_payload(cls, t: Dict[str, Any]) -> "JobTiming":
        return cls(e2e_ms=float(t["e2e_ms"]),
                   phases_ms={str(k): float(v)
                              for k, v in t["phases_ms"].items()},
                   phase_sum_ms=float(t["phase_sum_ms"]),
                   slo=str(t["slo"]),
                   slo_target_ms=float(t["slo_target_ms"]),
                   slo_met=bool(t["slo_met"]))


@dataclasses.dataclass(frozen=True)
class JobQuality:
    """A finished job's fcqual convergence-quality block (``/result`` /
    ``/status`` ``quality``), typed: how the consensus run converged —
    final ensemble agreement / mean modularity, the active-frontier
    trajectory (fraction of vertices still incident to a mid-weight
    consensus edge, per round and averaged over the late half), total
    label churn, and rounds-to-converge (None when the run hit
    max_rounds unconverged).  Content-derived, so two jobs sharing one
    cached result report the same block (contrast :class:`JobTiming`,
    which is per submission)."""

    rounds: int
    final_agreement: Optional[float]
    final_modularity_mean: Optional[float]
    final_frontier_frac: Optional[float]
    final_churn_frac: Optional[float]
    late_frontier_frac: Optional[float]
    frontier_frac_by_round: Tuple[float, ...]
    agreement_by_round: Tuple[float, ...]
    labels_changed_total: int
    agg_overflow_total: int
    rounds_to_converge: Optional[int]

    @classmethod
    def from_payload(cls, q: Dict[str, Any]) -> "JobQuality":
        def _opt(key: str) -> Optional[float]:
            v = q.get(key)
            return None if v is None else float(v)

        rtc = q.get("rounds_to_converge")
        return cls(rounds=int(q.get("rounds", 0)),
                   final_agreement=_opt("final_agreement"),
                   final_modularity_mean=_opt("final_modularity_mean"),
                   final_frontier_frac=_opt("final_frontier_frac"),
                   final_churn_frac=_opt("final_churn_frac"),
                   late_frontier_frac=_opt("late_frontier_frac"),
                   frontier_frac_by_round=tuple(
                       float(v) for v in
                       q.get("frontier_frac_by_round") or ()),
                   agreement_by_round=tuple(
                       float(v) for v in
                       q.get("agreement_by_round") or ()),
                   labels_changed_total=int(
                       q.get("labels_changed_total", 0)),
                   agg_overflow_total=int(
                       q.get("agg_overflow_total", 0)),
                   rounds_to_converge=None if rtc is None else int(rtc))


@dataclasses.dataclass(frozen=True)
class DeltaInfo:
    """A delta submission's fcdelta provenance block (``/submit`` ack,
    ``/status``, ``/result`` ``delta``), typed: which cached parent the
    submission evolved (``parent`` is the parent's content hash), the
    mode the serve-side policy picked (``"incremental"`` — warm-start
    from the parent's ensemble with moves frontier-restricted to the
    changed edges' neighborhood — or ``"fallback"`` — a plain
    from-scratch run), the stable policy-rule name that forced a
    fallback (None for incremental), and the delta's size: edge-change
    fraction relative to the parent plus raw add/remove counts.  Lives
    OUTSIDE the content hash — two submissions producing the same child
    graph dedup to one cache entry regardless of how they got there."""

    parent: str
    mode: str
    reason: Optional[str]
    delta_frac: float
    n_adds: int
    n_removes: int

    @property
    def incremental(self) -> bool:
        return self.mode == "incremental"

    @classmethod
    def from_payload(cls, d: Dict[str, Any]) -> "DeltaInfo":
        reason = d.get("reason")
        return cls(parent=str(d["parent"]), mode=str(d["mode"]),
                   reason=None if reason is None else str(reason),
                   delta_frac=float(d.get("delta_frac", 0.0)),
                   n_adds=int(d.get("n_adds", 0)),
                   n_removes=int(d.get("n_removes", 0)))


@dataclasses.dataclass(frozen=True)
class PhaseLatency:
    """One fclat histogram from ``/metricsz``'s ``latency`` block: a
    log2-bucketed latency distribution (seconds) for one (name, tags)
    pair — e.g. ``serve.phase.device`` at bucket n64_e96 / rung 2.
    ``exemplars`` is the fcflight tail sidecar: per bucket key, the
    retained worst (job_id, seconds) pairs, empty for histograms whose
    observations carried no exemplar id."""

    name: str
    tags: Dict[str, str]
    count: int
    sum_s: float
    min_s: Optional[float]
    max_s: Optional[float]
    p50_s: Optional[float]
    p95_s: Optional[float]
    p99_s: Optional[float]
    buckets: Dict[str, int]
    exemplars: Dict[str, Tuple[Tuple[str, float], ...]] = \
        dataclasses.field(default_factory=dict)

    @classmethod
    def from_payload(cls, h: Dict[str, Any]) -> "PhaseLatency":
        return cls(name=str(h["name"]),
                   tags={str(k): str(v)
                         for k, v in (h.get("tags") or {}).items()},
                   count=int(h["count"]), sum_s=float(h["sum_s"]),
                   min_s=h.get("min_s"), max_s=h.get("max_s"),
                   p50_s=h.get("p50_s"), p95_s=h.get("p95_s"),
                   p99_s=h.get("p99_s"),
                   buckets={str(k): int(v)
                            for k, v in (h.get("buckets") or {}).items()},
                   exemplars={str(k): tuple((str(e), float(v))
                                            for e, v in rows)
                              for k, rows in
                              (h.get("exemplars") or {}).items()})


@dataclasses.dataclass(frozen=True)
class SloStats:
    """Per-class SLO attainment from ``/metricsz`` (observed, never
    enforced: ``serve.slo.<class>.met/missed`` folded server-side)."""

    slo_class: str
    met: int
    missed: int
    attainment: float
    target_default_ms: float

    @classmethod
    def from_payload(cls, name: str, s: Dict[str, Any]) -> "SloStats":
        return cls(slo_class=str(name), met=int(s["met"]),
                   missed=int(s["missed"]),
                   attainment=float(s["attainment"]),
                   target_default_ms=float(s["target_default_ms"]))


@dataclasses.dataclass(frozen=True)
class ShapingStats:
    """The ``/metricsz`` ``shaping`` block (serve/shaping.py), typed:
    which control-loop arms are live, the ``serve.shape.*`` counters
    (holds / bypasses / EDF promotions / deadline sheds / buckets
    seeded from the static cost prior), the per-bucket measured
    service-time estimates the loop decides on, and the Retry-After a
    429 issued right now would carry."""

    edf: bool
    hold: bool
    shed: bool
    max_hold_s: float
    holds: int
    bypass: int
    edf_promotions: int
    deadline_sheds: int
    prior_seeded: int
    estimates: Dict[str, Dict[str, float]]
    retry_after_hint_s: Optional[float]

    @classmethod
    def from_payload(cls, p: Dict[str, Any]) -> "ShapingStats":
        cfg = p.get("config") or {}
        c = p.get("counters") or {}
        return cls(edf=bool(cfg.get("edf", False)),
                   hold=bool(cfg.get("hold", False)),
                   shed=bool(cfg.get("shed", False)),
                   max_hold_s=float(cfg.get("max_hold_s", 0.0)),
                   holds=int(c.get("holds", 0)),
                   bypass=int(c.get("bypass", 0)),
                   edf_promotions=int(c.get("edf_promotions", 0)),
                   deadline_sheds=int(c.get("deadline_sheds", 0)),
                   prior_seeded=int(c.get("prior_seeded", 0)),
                   estimates={str(k): dict(v) for k, v in
                              (p.get("estimates") or {}).items()},
                   retry_after_hint_s=p.get("retry_after_hint_s"))


@dataclasses.dataclass(frozen=True)
class SlowJobExemplar:
    """One ``/debugz/slowest`` row (obs/flight.py fcflight), typed: a
    tail-latency exemplar — a worst-observed ``serve.e2e`` job id with
    its latency and histogram tags — joined to its retained
    flight-recorder timeline (``events``: ts/kind/aux dicts, oldest
    first) and, while the server still tracks the job, its per-phase
    timing block.  The answer to "why was THIS request the p99", one
    HTTP GET away."""

    job_id: str
    e2e_s: float
    bucket: Optional[str]
    rung: Optional[str]
    priority: Optional[str]
    device: Optional[str]
    events: Tuple[Dict[str, Any], ...]
    timing: Optional[JobTiming] = None

    @classmethod
    def from_payload(cls, r: Dict[str, Any]) -> "SlowJobExemplar":
        t = r.get("timing")
        return cls(job_id=str(r["job_id"]), e2e_s=float(r["e2e_s"]),
                   bucket=r.get("bucket"), rung=r.get("rung"),
                   priority=r.get("priority"), device=r.get("device"),
                   events=tuple(dict(e) for e in r.get("events") or ()),
                   timing=None if t is None
                   else JobTiming.from_payload(t))


# What Backpressure.retry_after_s reports when the server sent no (or a
# malformed) Retry-After — the pre-fcshape constant, kept as the
# honest "we know nothing" floor.
DEFAULT_RETRY_AFTER_S = 1.0


def _retry_after_s(header: Optional[str],
                   payload: Dict[str, Any]) -> float:
    """The retry delay a 429 carried, in seconds: the JSON body's
    unrounded ``retry_after_s`` float when present (the header is
    integer delta-seconds, rounded UP server-side), else the parsed
    header, else :data:`DEFAULT_RETRY_AFTER_S`.  Malformed or negative
    values fall back to the default — a client must never interpret a
    broken header as "hammer immediately" (or "wait forever")."""
    from fastconsensus_tpu_torch.obs import counters as obs_counters

    reg = obs_counters.get_registry()
    for candidate in (payload.get("retry_after_s"), header):
        if candidate is None:
            continue
        try:
            v = float(candidate)
        except (TypeError, ValueError):
            # a 429 whose hint cannot be parsed is a wire bug worth
            # counting, not just skipping — the shaping stack promised
            # an honest Retry-After
            reg.inc("serve.client.retry_after_malformed")
            v = None
        if v is not None and v > 0.0:
            return v
    return DEFAULT_RETRY_AFTER_S


class ServeError(RuntimeError):
    """Non-2xx response; carries the HTTP status and decoded payload."""

    def __init__(self, status: int, payload: Dict[str, Any]) -> None:
        super().__init__(
            f"fcserve HTTP {status}: {payload.get('error', payload)}")
        self.status = status
        self.payload = payload


class Backpressure(ServeError):
    """HTTP 429: admission refused (queue full, or the job's deadline
    is provably unmeetable at the current depth — ``shed``).  Retry
    after ``retry_after_s`` seconds: the server derives it from queued
    depth x its observed service rate, so honoring it converges on the
    server's actual drain time instead of a fixed-backoff guess."""

    def __init__(self, status: int, payload: Dict[str, Any],
                 retry_after_s: float = DEFAULT_RETRY_AFTER_S) -> None:
        super().__init__(status, payload)
        self.retry_after_s = float(retry_after_s)
        self.shed = bool(payload.get("shed", False))


class JobFailed(ServeError):
    """The job ran and failed server-side (HTTP 500 on /result)."""


class ServeClient:
    """Talk to one fcserve instance at ``base_url``."""

    def __init__(self, base_url: str, timeout: float = 30.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # -- transport ---------------------------------------------------

    def _request(self, path: str,
                 payload: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
        url = self.base_url + path
        data = None
        headers = {"Accept": "application/json"}
        if payload is not None:
            data = json.dumps(payload).encode("utf-8")
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(url, data=data, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read() or b"{}")
            except ValueError:
                body = {"error": str(e)}
            if e.code == 429:
                raise Backpressure(
                    e.code, body,
                    retry_after_s=_retry_after_s(
                        e.headers.get("Retry-After"), body)) from None
            if e.code == 500 and path.startswith("/result/"):
                raise JobFailed(e.code, body) from None
            raise ServeError(e.code, body) from None

    # -- endpoints ---------------------------------------------------

    def submit(self, edges=None, n_nodes: Optional[int] = None,
               edgelist: Optional[str] = None,
               priority=None, **config) -> Dict[str, Any]:
        """POST /submit.  ``edges`` is a list of ``[u, v]`` pairs (or a
        numpy array — ``.tolist()`` is applied); ``config`` fields are
        the ConsensusConfig subset the server accepts (algorithm, n_p,
        tau, delta, max_rounds, seed, gamma, ...)."""
        payload: Dict[str, Any] = dict(config)
        if edgelist is not None:
            payload["edgelist"] = edgelist
        if edges is not None:
            payload["edges"] = edges.tolist() if hasattr(edges, "tolist") \
                else list(edges)
        if n_nodes is not None:
            payload["n_nodes"] = int(n_nodes)
        if priority is not None:
            payload["priority"] = priority
        return self._request("/submit", payload)

    def submit_delta(self, parent: str, adds=None, removes=None,
                     priority=None, slo: Optional[str] = None,
                     slo_target_ms: Optional[float] = None,
                     trace: Optional[str] = None) -> Dict[str, Any]:
        """POST /submit with a ``parent`` content hash + edge delta
        (fcdelta, serve/delta.py).  ``adds``/``removes`` are lists of
        ``[u, v]`` pairs (numpy arrays accepted) against the parent's
        node ids; at least one must be non-empty.  The server resolves
        the parent's cached result, applies the delta to its canonical
        edge list, and either warm-starts from the parent's ensemble
        (``mode="incremental"``) or falls back to a from-scratch run —
        the ack/status/result ``delta`` block says which and why.
        Delta submissions default to the ``"delta"`` SLO class; pass
        ``slo`` to override.  Raises :class:`ServeError` with status
        404 when the parent is not cached (re-submit the full graph)
        and 400 on a malformed delta (self-loops, out-of-range nodes,
        removes of absent edges, ... — the error message names the
        offending list index)."""
        def _pairs(rows) -> List[List[int]]:
            rows = rows.tolist() if hasattr(rows, "tolist") else rows
            return [list(r) for r in rows]

        payload: Dict[str, Any] = {"parent": str(parent)}
        if adds is not None:
            payload["adds"] = _pairs(adds)
        if removes is not None:
            payload["removes"] = _pairs(removes)
        if priority is not None:
            payload["priority"] = priority
        if slo is not None:
            payload["slo"] = slo
        if slo_target_ms is not None:
            payload["slo_target_ms"] = float(slo_target_ms)
        if trace is not None:
            payload["trace"] = trace
        return self._request("/submit", payload)

    def status(self, job_id: str) -> Dict[str, Any]:
        return self._request(f"/status/{job_id}")

    def result(self, job_id: str) -> Dict[str, Any]:
        """GET /result/<id>; the payload includes ``state`` while the
        job is still pending (HTTP 202)."""
        return self._request(f"/result/{job_id}")

    def healthz(self) -> Dict[str, Any]:
        return self._request("/healthz")

    def metricsz(self) -> Dict[str, Any]:
        return self._request("/metricsz")

    def workers(self) -> List[WorkerState]:
        """The pool's per-worker state (``/healthz``), typed: device id,
        tier kind, bucket residency, queue backlog, cordoned flag."""
        return [WorkerState.from_payload(w)
                for w in self.healthz().get("workers", ())]

    def device_metrics(self) -> Dict[str, Dict[str, Any]]:
        """Per-device breakdown from ``/metricsz`` (jobs, batches,
        compiles, busy-fraction, cordon state), keyed by device id."""
        return self.metricsz().get("devices", {})

    def scope(self) -> str:
        """What ``base_url`` points at, as ``/metricsz`` self-describes
        it: ``"router"`` or ``"replica"``.  Pre-fctrace servers sent no
        scope field; they can only have been replicas."""
        return str(self.metricsz().get("scope", "replica"))

    def latency(self) -> Dict[str, Any]:
        """The fclat request-latency view from ``/metricsz``, typed:
        ``histograms`` ([:class:`PhaseLatency`] — per-phase and
        end-to-end distributions tagged by bucket/rung/priority/
        device), ``slo`` ([:class:`SloStats`] per class), and the raw
        per-bucket ``arrivals`` / ``dispatches`` rate maps.  Works
        against both scopes: a router's block holds its
        ``router.phase.*`` histograms and (having no SLO accounting of
        its own) empty slo/arrivals/dispatches maps."""
        block = self.metricsz().get("latency", {})
        return {
            "histograms": [PhaseLatency.from_payload(h)
                           for h in block.get("histograms", ())],
            "slo": [SloStats.from_payload(name, s)
                    for name, s in sorted(
                        (block.get("slo") or {}).items())],
            "arrivals": dict(block.get("arrivals") or {}),
            "dispatches": dict(block.get("dispatches") or {}),
        }

    def shaping(self) -> ShapingStats:
        """The traffic-shaping view from ``/metricsz``, typed: live
        config arms, ``serve.shape.*`` counters, per-bucket service
        estimates, and the current Retry-After hint."""
        return ShapingStats.from_payload(
            self.metricsz().get("shaping", {}))

    def slowest(self) -> List[SlowJobExemplar]:
        """The server's worst observed end-to-end jobs
        (``/debugz/slowest``), typed — tail exemplars with their flight
        timelines, sorted slowest-first server-side."""
        return [SlowJobExemplar.from_payload(r)
                for r in self._request("/debugz/slowest")
                .get("slowest", ())]

    def timing(self, job_id: str) -> Optional[JobTiming]:
        """A finished job's typed server-side timing block (None while
        the job is still pending, or for pre-fclat servers)."""
        t = self.status(job_id).get("timing")
        return None if t is None else JobTiming.from_payload(t)

    def quality(self, job_id: str) -> Optional[JobQuality]:
        """A finished job's typed fcqual quality block (None while the
        job is still pending, for pre-fcqual servers, and for results
        computed from pre-fcqual checkpoint histories)."""
        q = self.status(job_id).get("quality")
        return None if q is None else JobQuality.from_payload(q)

    def delta_info(self, job_id: str) -> Optional[DeltaInfo]:
        """A delta submission's typed fcdelta provenance block (None
        for plain full-graph submissions and pre-fcdelta servers)."""
        d = self.status(job_id).get("delta")
        return None if d is None else DeltaInfo.from_payload(d)

    def coalescing(self) -> Dict[str, Any]:
        """Operator view of cross-request batching, extracted from
        ``/metricsz``: how many batched device calls ran
        (``serve.batch.coalesced``), how many jobs rode in them
        (``serve.batch.occupancy``), the mean occupancy, and the solo
        fallback count.  ``/status/<id>`` of any coalesced job also
        carries its ``batch_id``/``batch_size``."""
        counters = self.metricsz().get("fcobs", {}).get("counters", {})
        batches = counters.get("serve.batch.coalesced", 0)
        jobs = counters.get("serve.batch.occupancy", 0)
        return {
            "batches": batches,
            "jobs_coalesced": jobs,
            "mean_occupancy": round(jobs / batches, 3) if batches else 0.0,
            "solo_fallbacks": counters.get("serve.batch.fallback_solo", 0),
            "queue_coalesced_pops": counters.get(
                "serve.queue.coalesced_pops", 0),
        }

    def flight(self) -> Dict[str, Any]:
        """The server's raw fcflight ring snapshot
        (``GET /debugz/flight``) with its ``scope`` tag — the
        per-process half of a fleettrace timeline, one HTTP GET away
        (both tiers serve it)."""
        return self._request("/debugz/flight")

    def retry(self, call, attempts: int = 6, backoff: float = 1.5,
              jitter_frac: float = 0.1, max_sleep_s: float = 30.0,
              sleep=time.sleep, rng=None) -> Any:
        """Run ``call()`` (any zero-arg client operation, e.g.
        ``lambda: c.submit(...)``) with backpressure retries: each
        :class:`Backpressure` sleeps the server's TYPED
        ``retry_after_s`` — the shaping stack derived it from queued
        depth x observed service rate, so honoring it converges on the
        actual drain time — scaled by ``backoff ** attempt`` (a still-
        shedding server earns growing patience) plus up to
        ``jitter_frac`` random jitter (synchronized clients all
        retrying at exactly the hinted instant would arrive as one
        thundering herd and shed each other again).  The final
        Backpressure re-raises; non-429 errors propagate immediately.
        ``sleep``/``rng`` are injectable for deterministic tests."""
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        if backoff < 1.0:
            raise ValueError(f"backoff must be >= 1.0, got {backoff}")
        if rng is None:
            import random

            rng = random.Random()
        for attempt in range(attempts):
            try:
                return call()
            except Backpressure as e:
                if attempt == attempts - 1:
                    raise
                delay = min(max_sleep_s,
                            e.retry_after_s * (backoff ** attempt))
                delay += rng.uniform(0.0, jitter_frac * delay)
                sleep(delay)
        raise AssertionError("unreachable")  # the loop returns or raises

    def wait(self, job_id: str, timeout: float = 300.0,
             poll_s: float = 0.2) -> Dict[str, Any]:
        """Poll until the job finishes; returns the result payload.
        Raises :class:`JobFailed` on server-side failure and
        TimeoutError when ``timeout`` elapses first."""
        deadline = time.monotonic() + timeout
        while True:
            res = self.result(job_id)
            if "partitions" in res:
                return res
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"job {job_id} still {res.get('state')!r} after "
                    f"{timeout:.0f}s")
            time.sleep(poll_s)

    def run(self, edges, n_nodes: Optional[int] = None,
            timeout: float = 300.0, **config) -> Dict[str, Any]:
        """submit + wait in one call."""
        sub = self.submit(edges=edges, n_nodes=n_nodes, **config)
        return self.wait(sub["job_id"], timeout=timeout)
