"""fcobs exporters: JSONL event log, Chrome/Perfetto trace JSON, text table.

Three views of one run's spans (obs/tracer.py) + counters
(obs/counters.py):

* :func:`write_jsonl` — append-friendly event log, one JSON object per
  line (``{"kind": "span", ...}`` per span, a final ``{"kind":
  "counters", ...}`` snapshot record).  The machine-diffable artifact for
  regression archaeology.
* :func:`write_perfetto` — Chrome ``trace_event`` JSON (the
  ``{"traceEvents": [...]}`` object form) loadable directly in
  ``ui.perfetto.dev`` or ``chrome://tracing``: complete ("X") events with
  microsecond ``ts``/``dur``, thread tracks named after the host threads
  that ran the spans, the counter snapshot under ``otherData``.  Events
  are sorted by ``ts`` so the artifact is reproducible byte-for-byte for
  a deterministic run.
* :func:`summary_table` — the plain-text per-span-name aggregate (count /
  total / p50 / p95 wall ms) plus counters, for terminals and bench logs.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from fastconsensus_tpu_torch.obs.counters import percentile

PROCESS_NAME = "fastconsensus-tpu"
_PID = 1


def span_stats(events: List[dict]) -> Dict[str, dict]:
    """Per-span-name aggregates over complete ("X") events: count and
    total/p50/p95/max wall milliseconds.  Keyed by span name, ordered by
    descending total time."""
    buckets: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        buckets.setdefault(ev["name"], []).append(ev["dur"] / 1000.0)
    out = {}
    for name, durs in sorted(buckets.items(),
                             key=lambda kv: -sum(kv[1])):
        durs.sort()
        out[name] = {
            "count": len(durs),
            "total_ms": round(sum(durs), 3),
            "p50_ms": round(percentile(durs, 0.50), 3),
            "p95_ms": round(percentile(durs, 0.95), 3),
            "max_ms": round(durs[-1], 3),
        }
    return out


def write_jsonl(path: str, events: List[dict],
                snapshot: Optional[dict] = None) -> None:
    """One JSON object per line: every span event, then the counter
    snapshot (when given) as a trailing ``{"kind": "counters"}`` record."""
    _ensure_parent(path)
    with open(path, "w", encoding="utf-8") as fh:
        for ev in sorted(events, key=lambda e: e["ts"]):
            fh.write(json.dumps({"kind": "span", **ev}) + "\n")
        if snapshot is not None:
            fh.write(json.dumps({"kind": "counters", **snapshot}) + "\n")


def to_perfetto(events: List[dict],
                snapshot: Optional[dict] = None,
                process_name: str = PROCESS_NAME,
                thread_names: Optional[Dict[int, str]] = None) -> dict:
    """Chrome ``trace_event`` object form of a span list (see module
    docstring).  Host thread idents map to small stable tids (in order of
    first appearance) with ``thread_name`` metadata, so multi-threaded
    traces render as named tracks.  ``thread_names`` overrides the
    generic names per raw thread ident — the multi-device server passes
    its worker map so each device renders as its own named track
    ("device-0", "mesh-6", ...; serve/pool.py thread_names)."""
    tids: Dict[int, int] = {}
    for ev in events:
        tids.setdefault(ev.get("tid", 0), len(tids) + 1)
    trace_events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": _PID, "tid": 0, "ts": 0,
        "args": {"name": process_name},
    }]
    for ident, tid in tids.items():
        name = (thread_names or {}).get(ident) or (
            "driver" if tid == 1 else f"thread-{tid}")
        trace_events.append({
            "name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
            "ts": 0, "args": {"name": name},
        })
    for ev in sorted(events, key=lambda e: e["ts"]):
        args = dict(ev.get("args") or {})
        if ev.get("cpu_us"):
            args["cpu_us"] = ev["cpu_us"]
        out = {
            "name": ev["name"],
            "cat": "fcobs",
            "ph": ev.get("ph", "X"),
            "ts": ev["ts"],
            "pid": _PID,
            "tid": tids.get(ev.get("tid", 0), 1),
        }
        if out["ph"] == "X":
            out["dur"] = ev["dur"]
        else:
            out["s"] = "t"  # instant scope: thread
        if args:
            out["args"] = args
        trace_events.append(out)
    blob = {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
    }
    other: dict = {"span_stats": span_stats(events)}
    if snapshot is not None:
        other["counters"] = snapshot
    blob["otherData"] = other
    return blob


def _ensure_parent(path: str) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)


def write_perfetto_blob(path: str, blob: dict) -> None:
    """Write an already-built (possibly device-merged) trace blob."""
    _ensure_parent(path)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(blob, fh)
        fh.write("\n")


def write_perfetto(path: str, events: List[dict],
                   snapshot: Optional[dict] = None,
                   process_name: str = PROCESS_NAME,
                   thread_names: Optional[Dict[int, str]] = None) -> None:
    write_perfetto_blob(path, to_perfetto(events, snapshot, process_name,
                                          thread_names=thread_names))


def _rotated_entries(path: str) -> List[tuple]:
    """Existing rotated segments of ``path`` as sorted ``(n, path)``
    pairs — the single owner of the ``{path}.{n}`` chain naming scheme
    (supervise's rotation derives its next suffix from here too)."""
    import re

    rotated = []
    parent = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path)
    pat = re.compile(re.escape(base) + r"\.(\d+)$")
    if os.path.isdir(parent):
        for name in os.listdir(parent):
            m = pat.match(name)
            if m:
                rotated.append((int(m.group(1)),
                                os.path.join(parent, name)))
    return sorted(rotated)


def next_chain_suffix(path: str) -> int:
    """The suffix the NEXT rotation of ``path`` should use (one past the
    highest existing ``{path}.{n}``; 1 for an unrotated path)."""
    entries = _rotated_entries(path)
    return (entries[-1][0] + 1) if entries else 1


class JsonlStreamer:
    """Incremental JSONL event log: spans flush to disk as they close.

    The batch exporter (:func:`write_jsonl`) writes everything at run
    end — which is exactly when a stall-killed (SIGKILL) process never
    gets to run, losing the whole attempt's spans and defeating the
    supervise rotation chain for the supervisor's PRIMARY failure mode.
    The streamer appends every span recorded since the last ``flush()``
    (cli.py flushes once per consensus round), so a killed attempt
    leaves everything but its in-flight round on disk.  Lines append in
    span-close order, not ``ts`` order; readers
    (:func:`read_jsonl_chain`, the summary tooling) sort or rebase by
    ``ts`` and do not rely on file order.  ``close(snapshot)`` flushes
    the tail and appends the final counters record.
    """

    def __init__(self, path: str, tracer) -> None:
        self.path = path
        self._tracer = tracer
        self._n = 0
        _ensure_parent(path)
        # truncate: each attempt owns one fresh segment (rotation, not
        # appending, is how attempts chain — utils/supervise.py)
        open(path, "w", encoding="utf-8").close()

    def flush(self) -> None:
        new = self._tracer.events_since(self._n)
        if not new:
            return
        self._n += len(new)
        with open(self.path, "a", encoding="utf-8") as fh:
            for ev in new:
                fh.write(json.dumps({"kind": "span", **ev}) + "\n")

    def close(self, snapshot: Optional[dict] = None) -> None:
        self.flush()
        if snapshot is not None:
            with open(self.path, "a", encoding="utf-8") as fh:
                fh.write(json.dumps({"kind": "counters", **snapshot})
                         + "\n")


def chain_segments(path: str) -> List[str]:
    """The rotated-segment chain for an fcobs JSONL log, oldest first.

    ``utils/supervise.py`` rotates a restarting run's event log to
    ``{path}.1``, ``{path}.2``, ... before each relaunch, so a supervised
    run that died N times leaves N rotated segments plus the final live
    file at ``path``.  Returns every existing member in chain order
    (numeric suffixes ascending, then ``path`` itself).
    """
    out = [p for _, p in _rotated_entries(path)]
    if os.path.exists(path):
        out.append(path)
    return out


def profiler_sidecar_path(path: str, segment: str) -> Optional[str]:
    """The Perfetto companion of one JSONL chain segment, if derivable.

    ``cli.py --trace PATH`` writes the Perfetto blob at ``PATH`` and the
    streaming event log at ``PATH.jsonl``; ``supervise --rotate`` moves
    both with lockstep numeric suffixes (both start unrotated, both
    rotate in the same :func:`~fastconsensus_tpu_torch.utils.supervise
    .rotate_for_retry` call), so segment ``PATH.jsonl.k`` pairs with
    ``PATH.k`` and the live ``PATH.jsonl`` with ``PATH``.  Returns None
    when ``path`` does not end in ``.jsonl`` (no naming convention to
    lean on).
    """
    if not path.endswith(".jsonl"):
        return None
    base = path[: -len(".jsonl")]
    return base + segment[len(path):]


def read_jsonl_chain(path: str, with_profiler: bool = False) -> List[dict]:
    """One coherent event stream from a rotated JSONL chain.

    Concatenates every segment of :func:`chain_segments` in order; each
    record gains an ``attempt`` field (1-based segment index), and span
    records' ``ts`` are rebased onto one cumulative timeline — segment
    k's spans start where segment k-1's ended (each process's tracer
    clock restarts at zero, so raw timestamps overlap).  Counter
    records pass through untouched: with checkpointed counter restore
    (obs/counters.restore_counters) the LAST counters record is already
    the run's cumulative truth.

    ``with_profiler``: also pick up each attempt's rotated *Perfetto*
    sidecar (:func:`profiler_sidecar_path` — the ``--trace`` blob the
    same rotation chained next to the JSONL) and splice its
    profiler-originated events in as ``{"kind": "profiler", "attempt":
    k, ...}`` records: a supervised ``--trace --profile-dir`` run's
    per-attempt device timelines read back as one attempt-tagged
    stream.  Only complete/instant events ride along — metadata rows
    ("M") and ``cat == "fcobs"`` spans are skipped (the latter are
    already in the JSONL); timestamps are rebased by the same
    per-attempt offset as the spans (the merge already aligned profiler
    events to that attempt's fcobs clock — obs/device.py).  A missing
    or unparsable sidecar contributes nothing rather than failing the
    read.
    """
    records: List[dict] = []
    offset = 0
    for attempt, seg in enumerate(chain_segments(path), start=1):
        seg_end = 0
        with open(seg, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                rec["attempt"] = attempt
                if rec.get("kind") == "span" and "ts" in rec:
                    seg_end = max(seg_end,
                                  rec["ts"] + rec.get("dur", 0))
                    rec["ts"] = rec["ts"] + offset
                records.append(rec)
        if with_profiler:
            records.extend(
                _profiler_records(path, seg, attempt, offset))
        offset += seg_end
    return records


def _profiler_records(path: str, segment: str, attempt: int,
                      offset: int) -> List[dict]:
    """Profiler events of one segment's Perfetto sidecar (see
    read_jsonl_chain); empty on any miss — chain reading must never
    fail on a half-written attempt."""
    side = profiler_sidecar_path(path, segment)
    if side is None or not os.path.exists(side):
        return []
    try:
        with open(side, encoding="utf-8") as fh:
            blob = json.load(fh)
        events = blob.get("traceEvents") or []
    except (OSError, ValueError):
        return []
    out: List[dict] = []
    for ev in events:
        if ev.get("ph") not in ("X", "i") or ev.get("cat") == "fcobs":
            continue
        rec = {"kind": "profiler", "attempt": attempt, **ev}
        if "ts" in rec:
            rec["ts"] = rec["ts"] + offset
        out.append(rec)
    return out


def flight_bundles(records: List[dict]) -> List[dict]:
    """The fcflight post-mortem bundles a supervised run's telemetry
    chain recorded, attempt-tagged: ``utils/supervise.py`` appends a
    ``{"kind": "flight_bundle", "bundle": <dir>}`` line to a dead
    attempt's JSONL segment before rotating it, and
    :func:`read_jsonl_chain` carries those records through with the
    segment's ``attempt`` — so "which attempts died, and where is each
    one's crash evidence" is one list comprehension, not a directory
    hunt.  Returns ``[{"attempt": k, "bundle": path}, ...]`` in chain
    order."""
    return [{"attempt": r.get("attempt"), "bundle": r.get("bundle")}
            for r in records if r.get("kind") == "flight_bundle"]


def summary_table(events: List[dict],
                  snapshot: Optional[dict] = None) -> str:
    """Aligned plain-text summary: span aggregates, then counters."""
    stats = span_stats(events)
    lines = []
    if stats:
        name_w = max(len("span"), *(len(n) for n in stats))
        header = (f"{'span':<{name_w}}  {'count':>6}  {'total_ms':>10}  "
                  f"{'p50_ms':>9}  {'p95_ms':>9}  {'max_ms':>9}")
        lines.append(header)
        lines.append("-" * len(header))
        for name, s in stats.items():
            lines.append(
                f"{name:<{name_w}}  {s['count']:>6}  {s['total_ms']:>10.3f}"
                f"  {s['p50_ms']:>9.3f}  {s['p95_ms']:>9.3f}"
                f"  {s['max_ms']:>9.3f}")
    else:
        lines.append("(no spans recorded)")
    if snapshot:
        counters = snapshot.get("counters") or {}
        gauges = snapshot.get("gauges") or {}
        if counters or gauges:
            lines.append("")
            lines.append("counters:")
            for k in sorted(counters):
                lines.append(f"  {k} = {counters[k]}")
            for k in sorted(gauges):
                lines.append(f"  {k} = {gauges[k]:g}")
        series = snapshot.get("series") or {}
        live = {k: v for k, v in series.items() if v}
        if live:
            lines.append("series (count / p50 / p95):")
            for k in sorted(live):
                s = live[k]
                lines.append(f"  {k} = {s['count']} / {s['p50']:g} / "
                             f"{s['p95']:g}")
    return "\n".join(lines)
