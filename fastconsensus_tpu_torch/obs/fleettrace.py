"""fctrace: fleet-wide tracing, metrics aggregation, incident merge.

The port's own copy of ``fastconsensus_tpu/obs/fleettrace.py``, apart
from the package name unchanged: the merge rests on the port's
``obs/latency.py`` and ``obs/flight.py``, themselves unchanged copies,
so a fleet of either package's replicas merges the same way.

Every observability layer below this one stops at the process
boundary: fclat histograms and fcflight rings describe ONE replica,
post-mortem bundles dump ONE process, and the fcfleet router's own
``/metricsz`` shows only router-local counters.  A request that
crosses router→replica therefore leaves two uncorrelated timelines,
and a fleet kill drill leaves N disjoint bundles with unaligned
clocks.  This module is the stitching layer — three pieces, all
torch-free and jax-free (stdlib + the torch-free obs siblings only, so
the reader runs on a box where neither can even import):

* **Trace context** — the router mints one trace id per submission
  (honoring a client-supplied :data:`TRACE_HEADER`), forwards it on
  the proxied ``/submit`` as the same header, and the replica folds it
  into the JobSpec (outside the content hash — a trace names a
  *submission*, never a result).  Both sides stamp it into their
  flight events, so ``merged_timeline(trace=...)`` reconstructs one
  request end-to-end across processes.
* **Exact-merge aggregation** — :func:`aggregate_fleet` folds every
  replica's ``/metricsz`` into one fleet view: latency histograms
  merge bit-exactly (fixed log2 buckets,
  :func:`~fastconsensus_tpu_torch.obs.latency.merge_registry_snapshots`),
  SLO met/missed counts add per class, counters sum, and the router's
  own ``router.phase.*`` family attributes per-replica proxy
  overhead.  The router's ``GET /fleetz`` is this function over live
  replicas.
* **Incident merge** — flight snapshots and bundle manifests both
  carry a ``time_unix``/``time_mono`` anchor; :func:`merged_timeline`
  maps each process's monotonic event stamps onto the shared wall
  clock (``ts + (time_unix - time_mono)``), tags every event with its
  replica track, and sorts — one clock-aligned fleet timeline out of
  N per-process bundle directories, filterable by trace id.

CLI (mirrors obs/postmortem.py)::

    python -m fastconsensus_tpu_torch.obs.fleettrace render COLLECTED_DIR \
        [--trace ID] [--json] [--tail N]

where ``COLLECTED_DIR`` is what ``FleetManager.collect_bundles()``
produced: one directory holding every replica's bundles, each renamed
``<replica>__<bundle>`` so the merge knows its tracks.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from fastconsensus_tpu_torch.obs import latency as obs_latency
from fastconsensus_tpu_torch.obs.flight import merge_events

SCHEMA = 1

# The trace-context propagation header: client -> router -> replica.
# The router echoes it on every /submit answer too, so a client that
# never set one still learns its request's trace id.
TRACE_HEADER = "X-FCTPU-Trace"

# collect_bundles() joins replica name and bundle basename with this;
# discover_bundles() splits on it to recover the replica track.
REPLICA_SEP = "__"


# ---------------------------------------------------------------------
# fleet metrics aggregation (the /fleetz payload)
# ---------------------------------------------------------------------

def proxy_overhead(router_latency: Optional[Dict[str, Any]]
                   ) -> Dict[str, Dict[str, Any]]:
    """Per-replica proxy-overhead attribution from the ROUTER's own
    registry snapshot: the ``router.phase.proxy`` histograms are tagged
    ``replica=<name>`` per proxied hop, so each replica's entry is the
    router-side cost of talking to it (network + replica handler time
    — the part of fleet latency no replica-side histogram can see)."""
    out: Dict[str, Dict[str, Any]] = {}
    for h in (router_latency or {}).get("histograms") or ():
        if h.get("name") != "router.phase.proxy":
            continue
        name = (h.get("tags") or {}).get("replica", "?")
        out[str(name)] = {
            "count": int(h.get("count", 0)),
            "sum_s": h.get("sum_s"),
            "p50_s": h.get("p50_s"),
            "p95_s": h.get("p95_s"),
        }
    return out


def aggregate_fleet(replica_metrics: Dict[str, Optional[Dict[str, Any]]],
                    router_latency: Optional[Dict[str, Any]] = None,
                    router_fleet: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Fold per-replica ``/metricsz`` payloads into the fleet view.

    ``replica_metrics`` maps replica name -> its ``/metricsz`` body
    (None for a replica that could not be scraped — it is reported,
    not silently dropped: a fleet aggregate that quietly omits a
    replica reads as "healthy" exactly when it is not).

    The latency histograms merge EXACTLY (fixed buckets — the merged
    counts and quantiles equal one registry having recorded every
    replica's samples); SLO met/missed add per class with attainment
    recomputed from the summed counts (the class's default target is
    carried through, so the fleet slo rows parse with the same typed
    client block as a replica's); numeric fcobs counters sum.
    """
    replicas: Dict[str, Dict[str, Any]] = {}
    lat_snaps: List[Dict[str, Any]] = []
    slo_fleet: Dict[str, Dict[str, Any]] = {}
    counters: Dict[str, float] = {}
    for name in sorted(replica_metrics):
        payload = replica_metrics[name]
        if not payload:
            replicas[name] = {"ok": False}
            continue
        lat = payload.get("latency") or {}
        slo = lat.get("slo") or {}
        replicas[name] = {
            "ok": True,
            "scope": payload.get("scope", "replica"),
            "histograms": len(lat.get("histograms") or ()),
            "slo": slo,
        }
        lat_snaps.append(lat)
        for cls, s in slo.items():
            agg = slo_fleet.setdefault(str(cls), {"met": 0, "missed": 0})
            agg["met"] += int(s.get("met", 0) or 0)
            agg["missed"] += int(s.get("missed", 0) or 0)
            # the default target is replica-invariant config, not a
            # measurement: carry the first one seen through the fold
            if ("target_default_ms" not in agg
                    and s.get("target_default_ms") is not None):
                agg["target_default_ms"] = s["target_default_ms"]
        for cname, val in ((payload.get("fcobs") or {})
                           .get("counters") or {}).items():
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                counters[str(cname)] = counters.get(str(cname), 0) + val
    for agg in slo_fleet.values():
        total = agg["met"] + agg["missed"]
        agg["attainment"] = (round(agg["met"] / total, 6)
                             if total else None)
    out: Dict[str, Any] = {
        "schema": SCHEMA,
        "tool": "fctrace-fleetz",
        "scope": "fleet",
        "replicas": replicas,
        "latency": obs_latency.merge_registry_snapshots(lat_snaps),
        "slo": slo_fleet,
        "counters": {k: counters[k] for k in sorted(counters)},
    }
    if router_latency is not None:
        out["router"] = {
            "latency": router_latency,
            "proxy_overhead": proxy_overhead(router_latency),
        }
    if router_fleet is not None:
        out["fleet"] = router_fleet
    return out


# ---------------------------------------------------------------------
# cross-replica incident merge (collected bundles -> one timeline)
# ---------------------------------------------------------------------

def _load_json(path: str) -> Optional[Any]:
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None


def discover_bundles(root: str) -> List[Tuple[str, str]]:
    """``(replica, bundle_dir)`` pairs under a collected directory.

    Entries named ``<replica>__fcflight_...`` (the collect_bundles
    layout) take their track name from the prefix; a bare
    ``fcflight_...`` entry (root IS one replica's flight dir) falls
    back to ``p<pid>`` from its manifest.  Manifest-less partial dirs
    are skipped — same completeness contract as postmortem.list_bundles.
    """
    out: List[Tuple[str, str]] = []
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        return []
    for entry in entries:
        path = os.path.join(root, entry)
        if not os.path.isdir(path):
            continue
        manifest = _load_json(os.path.join(path, "MANIFEST.json"))
        if manifest is None:
            continue
        if REPLICA_SEP in entry and "fcflight_" in entry:
            replica = entry.split(REPLICA_SEP, 1)[0]
        elif entry.startswith("fcflight_"):
            replica = f"p{manifest.get('pid', '?')}"
        else:
            continue
        out.append((replica, path))
    return out


def clock_anchor(bundle_dir: str) -> Optional[float]:
    """The bundle's monotonic→wall offset (``time_unix - time_mono``).
    The flight snapshot's own anchor wins (stamped at the same instant
    as the ring copy); older bundles fall back to the manifest's, which
    is written milliseconds later — within the alignment tolerance any
    cross-host reading needs anyway."""
    for section in ("flight.json", "MANIFEST.json"):
        data = _load_json(os.path.join(bundle_dir, section))
        if (isinstance(data, dict) and data.get("time_unix") is not None
                and data.get("time_mono") is not None):
            return float(data["time_unix"]) - float(data["time_mono"])
    return None


def merged_timeline(root: str, trace: Optional[str] = None
                    ) -> Dict[str, Any]:
    """One clock-aligned fleet timeline out of a collected bundle dir.

    Every flight event becomes ``{"t_wall", "replica", "thread",
    "kind", ...aux}`` with ``t_wall = ts + anchor`` (unix seconds);
    events from bundles with no recoverable anchor are dropped and
    counted in ``skipped_bundles`` rather than mis-ordered.  When one
    replica contributed several bundles (periodic SIGQUIT snapshots of
    one ring), identical events deduplicate on their exact
    (replica, ts, kind, job) identity.  ``trace`` filters to one
    request's events across every track.
    """
    events: List[Dict[str, Any]] = []
    tracks: Dict[str, int] = {}
    skipped: List[str] = []
    seen: set = set()
    for replica, bundle_dir in discover_bundles(root):
        flight = _load_json(os.path.join(bundle_dir, "flight.json"))
        anchor = clock_anchor(bundle_dir)
        if not isinstance(flight, dict) or anchor is None:
            skipped.append(os.path.basename(bundle_dir))
            continue
        for ev in merge_events(flight):
            if trace is not None and ev.get("trace") != trace:
                continue
            ts = float(ev.get("ts", 0.0))
            ident = (replica, ts, ev.get("kind"), ev.get("job"))
            if ident in seen:
                continue
            seen.add(ident)
            events.append({**ev, "replica": replica,
                           "t_wall": round(ts + anchor, 6)})
            tracks[replica] = tracks.get(replica, 0) + 1
    events.sort(key=lambda e: e["t_wall"])
    return {
        "schema": SCHEMA,
        "tool": "fctrace-timeline",
        "trace": trace,
        "replicas": sorted(tracks),
        "events_per_replica": {k: tracks[k] for k in sorted(tracks)},
        "n_events": len(events),
        "skipped_bundles": skipped,
        "events": events,
    }


def render_timeline(payload: Dict[str, Any],
                    tail: Optional[int] = None) -> str:
    """Human-readable view of a :func:`merged_timeline` payload."""
    events = payload.get("events") or []
    lines = [
        "== fctrace merged fleet timeline ==",
        f"replicas : {', '.join(payload.get('replicas') or []) or '-'}",
        f"events   : {payload.get('n_events', 0)}"
        + (f" (trace {payload['trace']})" if payload.get("trace")
           else ""),
    ]
    if payload.get("skipped_bundles"):
        lines.append(f"skipped  : "
                     f"{', '.join(payload['skipped_bundles'])}")
    shown = events[-tail:] if tail is not None else events
    if len(shown) < len(events):
        lines.append(f"-- last {len(shown)} of {len(events)} --")
    for ev in shown:
        extra = {k: v for k, v in ev.items()
                 if k not in ("ts", "t_wall", "kind", "thread",
                              "replica", "job")}
        job = f" job={ev['job']}" if "job" in ev else ""
        extra_s = f" {extra}" if extra else ""
        lines.append(
            f"  [{ev.get('t_wall', 0.0):.6f}] "
            f"{ev.get('replica', '?')}/{ev.get('thread', '?')}: "
            f"{ev.get('kind')}{job}{extra_s}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m fastconsensus_tpu_torch.obs.fleettrace",
        description="fctrace cross-replica incident reader "
                    "(torch-free)")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser(
        "render", help="merge a collected bundle dir into one timeline")
    pr.add_argument("root", help="directory of <replica>__<bundle> "
                                 "dirs (FleetManager.collect_bundles)")
    pr.add_argument("--trace", default=None,
                    help="filter to one trace id's events")
    pr.add_argument("--json", action="store_true",
                    help="emit the merged timeline as JSON")
    pr.add_argument("--tail", type=int, default=None,
                    help="show only the last N events (text mode)")
    args = p.parse_args(argv)
    payload = merged_timeline(args.root, trace=args.trace)
    if not payload["replicas"]:
        print(f"{args.root}: no complete bundles found", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(payload, indent=1))
    else:
        print(render_timeline(payload, tail=args.tail))
    return 0


if __name__ == "__main__":
    sys.exit(main())
