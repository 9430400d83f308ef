"""fcobs bench history: normalize bench artifacts, trend them, gate them.

The reader of the reference's artifact schema, stdlib only (it imports
neither ``torch`` nor any other package): ``bench.py``'s JSON records
and their ``telemetry`` block, the driver's ``BENCH_r0*.json`` wrappers
(a ``parsed`` record), raw JSON lines (``runs/bench_*.json``), and the
fcheck artifacts that ``python -m fastconsensus_tpu_torch.analysis``
writes with ``--footprint-out`` (tool ``fcheck-footprint``) and
``--cost-out`` (tool ``fcheck-cost``).  Every table and finding is the
reference's, byte for byte, on the same files.

* :func:`load_records` — one normalized record per recognizable bench
  object in a file (driver wrapper, raw JSON object, JSON lines); files
  that are not bench records (``BENCH_BASELINE.json``) give ``[]``.
* :func:`build_history` — records grouped per *config* (graph /
  algorithm / n_p / mesh, parsed from the bench unit string) and ordered
  by sequence number (the driver's ``n``, or an ``_rN`` filename
  suffix).
* :func:`trend_table`, :func:`device_table`, :func:`serve_load_table`,
  :func:`serve_fleet_table`, :func:`quality_table`,
  :func:`footprint_table`, :func:`cost_table` — text or markdown views.
* :func:`check_history` — the throughput / NMI / convergence /
  warm-compile gate: the newest *sequenced* record per config against
  the median of its predecessors.  Unsequenced ad-hoc records trend but
  never gate (``runs/bench_emailEu_rerun.json`` is a degraded one-off).
* :func:`check_serve_load` (tail latency at the curve's reference RPS),
  :func:`check_serve_fleet` (drill health, scaling efficiency),
  :func:`check_delta` (incremental vs its from-scratch twin),
  :func:`check_flight` (no watchdog trip in a clean run),
  :func:`check_fleet_latency` (the router's ``/fleetz`` scrape, the
  ``telemetry.fleet_latency`` block), :func:`check_quality` (rounds to
  converge, agreement, late frontier), :func:`check_footprints`,
  :func:`check_costs` and :func:`check_cost_calibration`.  The
  latency-curve, fleet and delta artifacts are not higher-is-better
  throughputs, so :func:`check_history` leaves their values to their own
  gates (the warm-compile rule still applies).

``python -m fastconsensus_tpu_torch.obs.bench_report`` is the CLI.
``chip_smoke.py``'s phase ``fleet`` builds a ``fleet_latency`` block
from the card's ``/fleetz`` scrape and holds it to
:func:`check_fleet_latency`.
"""

from __future__ import annotations

import json
import os
import re
from statistics import median as _median
from typing import Dict, List, Optional, Tuple

# Thresholds the CI gate uses unless overridden.  max_drop_frac is
# deliberately loose (a 50% drop): the committed history itself shows
# benign 10-20% run-to-run noise on the tracked config, and the round-3
# artifact (6.9 p/s vs 67.7 prior — a 10x transport collapse) is exactly
# the magnitude the gate exists to catch.
DEFAULT_MAX_DROP_FRAC = 0.5
DEFAULT_NMI_DROP = 0.05

# serve_load (fclat latency-curve) gate thresholds: these artifacts are
# LOWER-IS-BETTER latency curves, so the throughput-drop rule above
# never applies to them (check_history skips them; check_serve_load
# owns them).  Growth bounds are loose for the same reason the drop
# bound is: CPU-CI tail latency is noisy run to run, and the gate
# exists to catch the 2-10x regressions a queueing bug or a lost
# coalescing path produces, not scheduler jitter.
DEFAULT_P95_GROWTH_FRAC = 1.0     # p95 at the reference RPS may double
DEFAULT_SLO_DROP = 0.15           # absolute attainment drop at ref RPS
DEFAULT_R429_GROWTH = 0.20        # absolute 429-rate growth at ref RPS

# fcfleet (serve_fleet) gate thresholds.  These artifacts are
# HIGHER-IS-BETTER scaling ratios (achieved-rps at N replicas vs 1
# under weak scaling), but ratios taken at different fleet sizes are
# not one trajectory — check_history skips its value rules for them
# (the warm-compile rule still applies) and check_serve_fleet owns
# them, anchored on matching largest fleet size.  The absolute rules
# (drill health, bundles, inheritance) arm from the FIRST committed
# artifact: a chaos drill that loses jobs is wrong regardless of
# history.
DEFAULT_FLEET_SCALING_DROP = 0.15   # fractional efficiency drop vs median
DEFAULT_FLEET_ATTAIN_MIN = 0.99     # absolute SLO attainment floor/point

# fcdelta (serve_delta) gate thresholds.  Absolute, armed from the
# first committed artifact: every scenario carries its OWN from-scratch
# twin, so the comparison never needs history.  The NMI band matches
# the ISSUE acceptance (incremental quality within 0.02 of scratch);
# the device bound is the existential one — an "incremental" run that
# costs at least a from-scratch recompute has no reason to exist.
DEFAULT_DELTA_NMI_GAP = 0.02        # incremental NMI may trail scratch by
DEFAULT_DELTA_ATTAIN_MIN = 1.0      # delta-class SLO attainment floor

# fctrace (telemetry.fleet_latency) gate thresholds.  The absolute
# rules arm from the first committed artifact: an unscrapable replica
# during the /fleetz scrape, an inexact histogram merge (fleet counts
# != sum of per-replica counts), or a merged fleet p95 that EXCEEDS
# the worst single replica's p95 (a mixture quantile on a shared
# bucket grid is bounded by its components — violating that means the
# merge is wrong, not the fleet slow) each block.  The trajectory
# bounds are loose, like the serve_load ones: CPU-CI proxy hops are
# scheduler-noisy, and the gate hunts the 2-10x regressions a
# busy-poll or serialization bug produces.
DEFAULT_FLEET_E2E_GROWTH = 1.0      # fleet-merged e2e p95 may double
DEFAULT_PROXY_OVERHEAD_GROWTH = 1.5 # worst proxy-overhead p95 growth

# fcqual (quality-block) gate thresholds.  Same calibration philosophy:
# loose enough that detector stochasticity (seeded, but the LFR graphs
# themselves differ per generator build) never trips them, tight enough
# that the failure modes they exist for — a weight-update bug doubling
# rounds-to-converge, a churn bug collapsing ensemble agreement, a
# frontier that stops contracting because thresholding went dead — all
# land well outside the band.
DEFAULT_ROUNDS_GROWTH_FRAC = 1.0  # rounds-to-converge may double
DEFAULT_AGREEMENT_DROP = 0.10     # absolute final-agreement drop
DEFAULT_FRONTIER_GROWTH = 0.25    # absolute late-frontier-frac growth


def _seq_from_name(path: str) -> Optional[int]:
    """``BENCH_r03.json`` / ``bench_lfr1k_r5.json`` -> 3 / 5; None when
    the filename carries no round suffix."""
    m = re.search(r"_r0*(\d+)(?:\.json)?$", os.path.basename(path))
    return int(m.group(1)) if m else None


def _config_key(rec: dict) -> str:
    """Stable per-config grouping key from the bench unit string, e.g.
    ``partitions/s/chip (lfr=lfr1k, alg=louvain, n_p=50)`` ->
    ``lfr1k/louvain/np50`` (plus the mesh shape when sharded)."""
    unit = str(rec.get("unit", ""))
    m = re.search(r"\(lfr=([^,)]+), *alg=([^,)]+), *n_p=(\d+)\)", unit)
    if m:
        # primary: the unit parse — it is the only key the ENTIRE
        # committed history carries, so old and new artifacts of one
        # config land in one trajectory
        key = f"{m.group(1)}/{m.group(2)}/np{m.group(3)}"
    elif rec.get("config"):
        # PR-3+ bench.py artifacts carry an explicit config name;
        # fallback for a future unit-string format change
        key = str(rec["config"])
    else:
        key = str(rec.get("metric", "unknown"))
    mesh = rec.get("mesh")
    if mesh and mesh != "1x1":
        key += f"/mesh{mesh}"
    return key


def _normalize(rec: dict, source: str, seq: Optional[int]) -> dict:
    tel = rec.get("telemetry") or {}

    def p95(name):
        s = tel.get(name)
        return s.get("p95") if isinstance(s, dict) else None

    return {
        "source": source,
        "seq": seq,
        "config": _config_key(rec),
        "metric": rec.get("metric"),
        # the raw bench unit string, kept for matchers that key on the
        # posture it names (check_cost_calibration greps the serve_load
        # bucket out of it)
        "unit": rec.get("unit"),
        "value": float(rec["value"]),
        "vs_baseline": rec.get("vs_baseline"),
        "nmi": rec.get("nmi"),
        "baseline_nmi": rec.get("baseline_nmi"),
        "seconds": rec.get("seconds"),
        "rounds": rec.get("rounds"),
        "converged": rec.get("converged"),
        "backend": rec.get("backend"),
        "mesh": rec.get("mesh"),
        "rtt_post_ms": rec.get("dispatch_rtt_ms_post"),
        "compiles_cold": tel.get("compiles_cold"),
        "compiles_warm": tel.get("compiles_warm"),
        "host_syncs_total": (sum(tel["host_syncs"].values())
                             if isinstance(tel.get("host_syncs"), dict)
                             else None),
        "round_p95_s": p95("round_s"),
        "detect_p95_s": p95("detect_call_s"),
        # multi-device serving artifacts (bench.py serve_multichip /
        # serve/pool.py): per-device jobs/compiles/busy breakdown, kept
        # verbatim for device_table()
        "devices": tel.get("devices") or None,
        # fclat serve_load artifacts (bench.py serve_load): the whole
        # per-RPS latency curve, kept verbatim for serve_load_table()
        # and check_serve_load()
        "serve_load": tel.get("serve_load") or None,
        # fcfleet serve_fleet artifacts (bench.py serve_fleet): the
        # weak-scaling points + chaos-drill block, kept verbatim for
        # serve_fleet_table() and check_serve_fleet()
        "serve_fleet": tel.get("serve_fleet") or None,
        # fcdelta serve_delta artifacts (bench.py serve_delta): the
        # drift-vs-quality scenario block (per-k incremental vs
        # from-scratch device time / NMI / compiles), kept verbatim
        # for check_delta()
        "serve_delta": tel.get("serve_delta") or None,
        # fcflight incident-health block (bench.py serve_load): watchdog
        # trips / bundles written / exemplar count, kept verbatim for
        # check_flight() — a clean sequenced load run that TRIPS the
        # hang watchdog is a serving regression even when the latency
        # curve still passes
        "flight": tel.get("flight") or None,
        # fctrace fleet-latency block (bench.py serve_fleet, scraped
        # from the router's /fleetz): router-phase p95s, per-replica
        # proxy overhead, fleet-merged e2e p95 vs the worst single
        # replica, and the exact-merge verdict, kept verbatim for
        # check_fleet_latency()
        "fleet_latency": tel.get("fleet_latency") or None,
        # fcqual quality block (obs/quality.py summarize_history), kept
        # verbatim for quality_table() and check_quality(); None on
        # pre-fcqual artifacts
        "quality": tel.get("quality") or None,
    }


def _candidate_records(doc) -> List[dict]:
    """Bench records inside one parsed JSON document: the document
    itself, its ``parsed`` field (driver wrapper), or its ``record``
    field (the VMESH artifact shape) — whichever carry metric+value."""
    out = []
    if isinstance(doc, dict):
        # fcheck: ok=phantom-reader (the parsed/record fields are
        # wrapper shapes produced by *external* bench drivers — the
        # VMESH artifact layout — deliberately accepted though nothing
        # in this repo writes them)
        for cand in (doc.get("parsed"), doc.get("record"), doc):
            if isinstance(cand, dict) and "metric" in cand \
                    and "value" in cand:
                out.append(cand)
                break
    return out


def load_records(path: str) -> List[dict]:
    """Normalized bench records from one artifact file (possibly JSON
    lines); [] when the file holds nothing bench-shaped."""
    try:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
    except OSError:
        return []
    docs = []
    try:
        docs = [json.loads(text)]
    except json.JSONDecodeError:
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                docs.append(json.loads(line))
            # fcheck: ok=swallowed-error (a torn/corrupt history
            # line is expected under concurrent appends; the
            # loader keeps every parsable record)
            except json.JSONDecodeError:
                continue
    records = []
    for doc in docs:
        seq = (doc["n"] if isinstance(doc, dict)
               and isinstance(doc.get("n"), int)
               else _seq_from_name(path))
        for rec in _candidate_records(doc):
            records.append(_normalize(rec, os.path.basename(path), seq))
    return records


def build_history(paths: List[str]) -> Dict[str, List[dict]]:
    """Records from every path, grouped by config key and ordered by
    (sequence, source) — unsequenced records sort first (they are
    never "the latest"; see module docstring)."""
    groups: Dict[str, List[dict]] = {}
    for path in paths:
        for rec in load_records(path):
            groups.setdefault(rec["config"], []).append(rec)
    for recs in groups.values():
        recs.sort(key=lambda r: (r["seq"] is not None, r["seq"] or 0,
                                 r["source"]))
    return dict(sorted(groups.items()))


def _fmt(v, nd=3) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        return f"{v:.{nd}f}".rstrip("0").rstrip(".") or "0"
    return str(v)


_COLUMNS: List[Tuple[str, str]] = [
    ("seq", "seq"), ("source", "source"), ("value", "p/s/chip"),
    ("vs_baseline", "vs_cpu"), ("nmi", "nmi"), ("rounds", "rounds"),
    ("converged", "conv"), ("compiles_warm", "warm_compiles"),
    ("host_syncs_total", "host_syncs"), ("round_p95_s", "round_p95_s"),
    ("detect_p95_s", "detect_p95_s"), ("rtt_post_ms", "rtt_post_ms"),
]


def trend_table(groups: Dict[str, List[dict]],
                markdown: bool = False) -> str:
    """Per-config trend report over the normalized history."""
    lines: List[str] = []
    for config, recs in groups.items():
        lines += _render_rows(config, [h for _, h in _COLUMNS],
                              [[_fmt(r[k]) for k, _ in _COLUMNS]
                               for r in recs], markdown)
    return "\n".join(lines).rstrip() or "(no bench records found)"


def device_table(groups: Dict[str, List[dict]],
                 markdown: bool = False) -> str:
    """Per-device breakdown tables for configs whose newest record
    carries one (the ``serve_multichip`` artifacts): device, tier kind,
    jobs, batches, builds (``xla_compiles``), busy seconds and busy
    fraction.  Empty string when no record in the history has device
    telemetry."""
    header = ["device", "kind", "jobs", "batches", "compiles",
              "busy_s", "busy_frac", "cordoned"]
    lines: List[str] = []
    for config, recs in groups.items():
        newest = next((r for r in reversed(recs) if r.get("devices")),
                      None)
        if newest is None:
            continue
        rows = []
        for dev in sorted(newest["devices"], key=lambda d: int(d)):
            d = newest["devices"][dev]
            rows.append([dev, str(d.get("kind", "-")),
                         _fmt(d.get("jobs"), 0),
                         _fmt(d.get("batches"), 0),
                         _fmt(d.get("xla_compiles"), 0),
                         _fmt(d.get("busy_s")),
                         _fmt(d.get("busy_frac")),
                         "yes" if d.get("cordoned") else "no"])
        lines += _render_rows(f"{config} devices [{newest['source']}]",
                              header, rows, markdown)
    return "\n".join(lines).rstrip()


_SL_PHASES = ("queue_wait", "hold", "dispatch", "deque_wait", "pack",
              "device", "fanout", "respond")
_SL_CLASSES = ("interactive", "normal", "batch")


def _sl_rows(points) -> List[List[str]]:
    rows = []
    for pt in points:
        slo = pt.get("slo") or {}
        phases = pt.get("phase_p95_ms") or {}
        batch = pt.get("batch") or {}
        rows.append(
            [_fmt(pt.get("rps")), _fmt(pt.get("achieved_rps")),
             _fmt(pt.get("completed"), 0),
             _fmt(pt.get("rejected_429"), 0),
             _fmt(pt.get("p50_ms")), _fmt(pt.get("p95_ms")),
             _fmt(pt.get("p99_ms")), _fmt(slo.get("attainment")),
             _fmt(batch.get("mean_occupancy"))]
            + [_fmt(phases.get(p)) for p in _SL_PHASES])
    return rows


def serve_load_table(groups: Dict[str, List[dict]],
                     markdown: bool = False) -> str:
    """Latency-vs-RPS tables for configs whose newest record carries a
    ``serve_load`` curve (the ``bench.py serve_load`` artifacts): per
    swept RPS point, the achieved throughput, client-observed and
    server-side percentiles, the 429/backpressure rate, SLO attainment,
    mean batch-rung occupancy, and the per-phase p95 breakdown — so a
    coalescing or admission change shows up as queue-wait/hold
    movement, not just a throughput scalar.  A record carrying the
    fcshape ``mixed`` block (the mixed-SLO-class sweep) renders a
    second table with per-class attainment columns.  Empty string when
    no record has a curve."""
    header = (["rps", "achieved", "jobs", "429s", "p50_ms", "p95_ms",
               "p99_ms", "slo_attain", "occup"]
              + [f"{p}_p95" for p in _SL_PHASES])
    lines: List[str] = []
    for config, recs in groups.items():
        newest = next((r for r in reversed(recs)
                       if r.get("serve_load")), None)
        if newest is None:
            continue
        ref = newest["serve_load"].get("reference_rps")
        lines += _render_rows(
            f"{config} latency vs RPS [{newest['source']}; "
            f"reference rps {_fmt(ref)}]", header,
            _sl_rows(newest["serve_load"].get("points", ())), markdown)
        mixed = newest["serve_load"].get("mixed")
        if mixed:
            mix_header = (["rps", "p95_ms", "429s", "sheds", "occup"]
                          + [f"{c}_attain" for c in _SL_CLASSES])
            rows = []
            for pt in mixed.get("points", ()):
                by_cls = pt.get("slo_by_class") or {}
                batch = pt.get("batch") or {}
                rows.append(
                    [_fmt(pt.get("rps")), _fmt(pt.get("p95_ms")),
                     _fmt(pt.get("rejected_429"), 0),
                     _fmt(pt.get("rejected_shed"), 0),
                     _fmt(batch.get("mean_occupancy"))]
                    + [_fmt((by_cls.get(c) or {}).get("attainment"))
                       for c in _SL_CLASSES])
            lines.append("")
            lines += _render_rows(
                f"{config} mixed-SLO sweep [{newest['source']}; "
                f"mix {mixed.get('mix')}]", mix_header, rows, markdown)
    return "\n".join(lines).rstrip()


def _sl_ref_point(rec: dict) -> Optional[dict]:
    """The record's curve point at its own reference RPS (the gate's
    anchor — the least-saturated point, where p95 measures the serving
    path rather than queueing noise)."""
    sl = rec.get("serve_load") or {}
    ref = sl.get("reference_rps")
    for pt in sl.get("points", ()):
        if pt.get("rps") == ref:
            return pt
    return None


def _r429_rate(pt: dict) -> Optional[float]:
    rejected = pt.get("rejected_429")
    submitted = pt.get("submitted")
    if rejected is None or not submitted:
        return None
    return rejected / submitted


def check_serve_load(groups: Dict[str, List[dict]],
                     p95_growth_frac: float = DEFAULT_P95_GROWTH_FRAC,
                     slo_drop: float = DEFAULT_SLO_DROP,
                     r429_growth: float = DEFAULT_R429_GROWTH
                     ) -> List[str]:
    """Tail-latency regression findings over serve_load curves; [] means
    the gate passes.  Per config, the newest sequenced curve is judged
    at the reference RPS against the median of its sequenced
    predecessors: p95 growth beyond ``p95_growth_frac``, an SLO
    attainment drop beyond ``slo_drop`` (absolute), or a 429-rate
    growth beyond ``r429_growth`` (absolute) is a finding.  One
    committed curve has no trajectory and passes — the gate arms itself
    the round after an artifact lands, like check_history."""
    problems: List[str] = []
    for config, recs in groups.items():
        seqd = [r for r in recs if r["seq"] is not None
                and r.get("serve_load")]
        if len(seqd) < 2:
            continue
        latest_seq = max(r["seq"] for r in seqd)
        latest = [r for r in seqd if r["seq"] == latest_seq]
        latest_refs = {((r.get("serve_load") or {}).get("reference_rps"),
                        (r.get("serve_load") or {}).get("mix"))
                       for r in latest}
        # compare at the SAME (reference RPS, workload mix) only: a
        # sweep whose grid (and therefore reference point) changed has
        # no prior anchor — judging its 8-rps p95 against a 2-rps
        # median would manufacture a "regression" out of ordinary
        # queueing — and neither has one whose SLO-class mix changed
        # (fcshape: a mixed workload queues differently by design; the
        # mixed sweep itself rides the separate `mixed` block, which
        # never gates).  bench.py stamps the main sweep's mix
        # explicitly (None = single-class, the only value it emits
        # today); pre-fcshape artifacts carry no key and read as None
        # too, so existing histories keep gating, while any future
        # mixed-main record separates from single-class priors here.
        prior = [r for r in seqd if r["seq"] < latest_seq
                 and ((r.get("serve_load") or {}).get("reference_rps"),
                      (r.get("serve_load") or {}).get("mix"))
                 in latest_refs]
        prior_pts = [(_sl_ref_point(r), r) for r in prior]
        prior_p95 = [p["p95_ms"] for p, _ in prior_pts
                     if p and p.get("p95_ms") is not None]
        prior_attain = [p["slo"]["attainment"] for p, _ in prior_pts
                        if p and (p.get("slo") or {}).get("attainment")
                        is not None]
        prior_429 = [r for r in (_r429_rate(p) for p, _ in prior_pts
                                 if p) if r is not None]
        for r in latest:
            pt = _sl_ref_point(r)
            if pt is None:
                continue
            tag = f"{config} [{r['source']} seq {r['seq']}]"
            ref = (r.get("serve_load") or {}).get("reference_rps")
            if prior_p95 and pt.get("p95_ms") is not None:
                base = _median(prior_p95)
                ceil = (1.0 + p95_growth_frac) * base
                if pt["p95_ms"] > ceil:
                    problems.append(
                        f"{tag}: p95 {pt['p95_ms']:.1f} ms at the "
                        f"reference RPS ({ref}) grew past "
                        f"{ceil:.1f} ms ({p95_growth_frac:.0%} over "
                        f"the prior median {base:.1f} ms) — a tail-"
                        f"latency regression")
            att = (pt.get("slo") or {}).get("attainment")
            if prior_attain and att is not None:
                base = _median(prior_attain)
                if att < base - slo_drop:
                    problems.append(
                        f"{tag}: SLO attainment {att:.3f} at the "
                        f"reference RPS ({ref}) dropped more than "
                        f"{slo_drop} below the prior median "
                        f"{base:.3f}")
            rate = _r429_rate(pt)
            if prior_429 and rate is not None:
                base = _median(prior_429)
                if rate > base + r429_growth:
                    problems.append(
                        f"{tag}: 429 rate {rate:.3f} at the reference "
                        f"RPS ({ref}) grew more than {r429_growth} "
                        f"over the prior median {base:.3f} — the "
                        f"server sheds load it used to serve")
    return problems


def serve_fleet_table(groups: Dict[str, List[dict]],
                      markdown: bool = False) -> str:
    """Weak-scaling + chaos-drill tables for configs whose newest
    record carries a ``serve_fleet`` block (the ``bench.py
    serve_fleet`` artifacts): per fleet size, the offered/achieved
    RPS, failure/shed counts, percentiles, SLO attainment, and warm
    compiles; then a one-row drill summary (victim, drain exit,
    successor, re-homed groups, bundles, the inherited-cache
    resubmit); then, when the record carries the r18
    ``fleet_latency`` block, the fctrace summary — router phase p95s,
    the exact-merged fleet e2e p95 against the worst single replica,
    and the per-replica proxy-overhead attribution.  Empty string
    when no record has the block."""
    header = ["replicas", "offered", "achieved", "jobs", "failed",
              "429s", "p50_ms", "p95_ms", "attain", "compiles"]
    lines: List[str] = []
    for config, recs in groups.items():
        newest = next((r for r in reversed(recs)
                       if r.get("serve_fleet")), None)
        if newest is None:
            continue
        sf = newest["serve_fleet"]
        rows = [[_fmt(pt.get("replicas"), 0),
                 _fmt(pt.get("offered_rps")),
                 _fmt(pt.get("achieved_rps")),
                 _fmt(pt.get("completed"), 0),
                 _fmt(pt.get("failed"), 0),
                 _fmt(pt.get("rejected_429"), 0),
                 _fmt(pt.get("p50_ms"), 1), _fmt(pt.get("p95_ms"), 1),
                 _fmt(pt.get("attainment")),
                 _fmt(pt.get("compiles"), 0)]
                for pt in sf.get("points", ())]
        scaling = ", ".join(f"x{s}={_fmt(v)}" for s, v in
                            sorted((sf.get("scaling") or {}).items()))
        lines += _render_rows(
            f"{config} weak scaling [{newest['source']}; "
            f"{_fmt(sf.get('rps_per_replica'))} rps/replica; "
            f"scaling {scaling or '-'}]", header, rows, markdown)
        drill = sf.get("drill") or {}
        if drill:
            burst = drill.get("burst") or {}
            resub = drill.get("resubmit_after_death") or {}
            lines += _render_rows(
                f"{config} chaos drill [{newest['source']}]",
                ["victim", "drain_exit", "successor", "jobs", "failed",
                 "replays", "rehomed", "bundles", "resubmit_cached"],
                [[_fmt(drill.get("victim")),
                  _fmt(drill.get("victim_drain_exit"), 0),
                  _fmt(drill.get("successor")),
                  _fmt(burst.get("completed"), 0),
                  _fmt(burst.get("failed"), 0),
                  _fmt((drill.get("fleet_counters") or {}).get(
                      "serve.fleet.replays"), 0),
                  _fmt((drill.get("fleet_counters") or {}).get(
                      "serve.fleet.rehomed_buckets"), 0),
                  _fmt(len(drill.get("bundles") or ()), 0),
                  _fmt(resub.get("cached"))]], markdown)
        fl = newest.get("fleet_latency") or {}
        if fl:
            ph = fl.get("router_phase_p95_ms") or {}
            down = ",".join(fl.get("replicas_down") or ()) or "-"
            lines += _render_rows(
                f"{config} fctrace fleet latency [{newest['source']}; "
                f"merge_exact={_fmt(fl.get('merge_exact'))}; "
                f"down={down}]",
                ["admit_p95", "ring_p95", "proxy_p95", "replay_p95",
                 "fleet_e2e_p95", "worst_e2e_p95"],
                [[_fmt(ph.get("admit")), _fmt(ph.get("ring_lookup")),
                  _fmt(ph.get("proxy")), _fmt(ph.get("replay")),
                  _fmt(fl.get("fleet_e2e_p95_ms"), 1),
                  _fmt(fl.get("worst_replica_e2e_p95_ms"), 1)]],
                markdown)
            overhead = fl.get("proxy_overhead_p95_ms") or {}
            if overhead:
                lines += _render_rows(
                    f"{config} router proxy overhead per replica "
                    f"[{newest['source']}]",
                    ["replica", "proxy_p95_ms"],
                    [[name, _fmt(overhead[name])]
                     for name in sorted(overhead)], markdown)
    return "\n".join(lines).rstrip()


def _fleet_efficiency(rec: dict) -> Optional[Tuple[int, float]]:
    """(largest fleet size, scaling efficiency at it) for one
    serve_fleet record — efficiency = achieved-rps ratio / size, so
    records swept to different fleet sizes compare on one axis."""
    sf = rec.get("serve_fleet") or {}
    scaling = sf.get("scaling") or {}
    sizes = [int(s) for s in scaling if scaling[s] is not None]
    if not sizes:
        return None
    largest = max(sizes)
    return largest, float(scaling[str(largest)]) / largest


def check_serve_fleet(groups: Dict[str, List[dict]],
                      scaling_drop: float = DEFAULT_FLEET_SCALING_DROP,
                      attain_min: float = DEFAULT_FLEET_ATTAIN_MIN
                      ) -> List[str]:
    """fcfleet findings over serve_fleet records; [] means the gate
    passes.  Two kinds of rule:

    * **Absolute**, armed from the first committed artifact, judged on
      the newest sequence only: a scaling point that failed/stranded/
      shed jobs or missed its SLO floor; a chaos drill that lost jobs,
      whose victim's rolling drain exited non-zero, that re-homed
      nothing, collected no flight bundle, or whose inherited-cache
      resubmit came back uncached.  A drill that loses work is wrong
      no matter what earlier rounds did.
    * **Trajectory**: the newest sequenced record's scaling efficiency
      (ratio / fleet size, at its largest size) against the median of
      sequenced predecessors AT THE SAME largest size — a drop beyond
      ``scaling_drop`` (fractional) is a finding.  Ratios at different
      fleet sizes are not one trajectory, same reasoning as
      check_serve_load's reference-RPS anchor.
    """
    problems: List[str] = []
    for config, recs in groups.items():
        seqd = [r for r in recs if r["seq"] is not None
                and r.get("serve_fleet")]
        if not seqd:
            continue
        latest_seq = max(r["seq"] for r in seqd)
        for r in seqd:
            if r["seq"] != latest_seq:
                continue
            tag = f"{config} [{r['source']} seq {r['seq']}]"
            sf = r["serve_fleet"]
            for pt in sf.get("points", ()):
                n = pt.get("replicas")
                lost = ((pt.get("failed") or 0)
                        + (pt.get("stranded") or 0))
                if lost:
                    problems.append(
                        f"{tag}: {lost} job(s) failed/stranded at "
                        f"fleet size {n} — a healthy fleet under its "
                        f"offered load must lose nothing")
                if pt.get("rejected_429"):
                    problems.append(
                        f"{tag}: {pt['rejected_429']} submission(s) "
                        f"shed (429) at fleet size {n} — the router "
                        f"stopped absorbing the per-replica load it "
                        f"used to")
                att = pt.get("attainment")
                if att is not None and att < attain_min:
                    problems.append(
                        f"{tag}: SLO attainment {att:.3f} at fleet "
                        f"size {n} below the {attain_min} floor")
            drill = sf.get("drill") or {}
            if drill:
                burst = drill.get("burst") or {}
                lost = ((burst.get("failed") or 0)
                        + (burst.get("stranded") or 0))
                if lost:
                    problems.append(
                        f"{tag}: the chaos drill lost {lost} job(s) — "
                        f"re-home + replay must hide a replica death "
                        f"from clients")
                drain_exit = drill.get("victim_drain_exit")
                if drain_exit not in (None, 0):
                    problems.append(
                        f"{tag}: the drill victim's rolling drain "
                        f"exited {drain_exit} — drain must absorb its "
                        f"armed spill fault and still exit clean")
                fc = drill.get("fleet_counters") or {}
                if not fc.get("serve.fleet.rehomed_buckets"):
                    problems.append(
                        f"{tag}: the drill re-homed no groups — the "
                        f"kill either missed live traffic or the "
                        f"cordon path went dead")
                if not drill.get("bundles"):
                    problems.append(
                        f"{tag}: the drill collected no flight "
                        f"bundle — the SIGQUIT post-mortem path went "
                        f"dead")
                resub = drill.get("resubmit_after_death") or {}
                if not resub.get("found_victim_job"):
                    problems.append(
                        f"{tag}: the drill found no victim-served job "
                        f"to resubmit — the inheritance demo proved "
                        f"nothing")
                elif resub.get("cached") is not True:
                    problems.append(
                        f"{tag}: resubmitting a dead replica's job "
                        f"came back uncached — cache inheritance "
                        f"(on_death spill load) went dead")
        # trajectory: efficiency at the newest record's largest size vs
        # the median of sequenced predecessors at the same size
        latest = [r for r in seqd if r["seq"] == latest_seq]
        for r in latest:
            eff = _fleet_efficiency(r)
            if eff is None:
                continue
            size, latest_eff = eff
            prior = [e for e in (_fleet_efficiency(p) for p in seqd
                                 if p["seq"] < latest_seq)
                     if e is not None and e[0] == size]
            if not prior:
                continue
            base = _median([e for _, e in prior])
            floor = (1.0 - scaling_drop) * base
            if latest_eff < floor:
                tag = f"{config} [{r['source']} seq {r['seq']}]"
                problems.append(
                    f"{tag}: scaling efficiency {latest_eff:.3f} at "
                    f"fleet size {size} fell below {floor:.3f} "
                    f"({scaling_drop:.0%} drop from the prior median "
                    f"{base:.3f}) — the fleet stopped scaling")
    return problems


def check_delta(groups: Dict[str, List[dict]],
                nmi_gap: float = DEFAULT_DELTA_NMI_GAP,
                attain_min: float = DEFAULT_DELTA_ATTAIN_MIN
                ) -> List[str]:
    """fcdelta findings over serve_delta records (``bench.py
    serve_delta`` drift-vs-quality artifacts); [] means the gate
    passes.  Every rule is **absolute** and judged on the newest
    sequence only: each scenario carries its own from-scratch twin of
    the same perturbed graph, so the incremental path's contract —
    cheaper than recomputing, and nearly as good — is checkable inside
    one artifact with no history anchor.

    * a scenario whose policy ``mode`` differs from the scenario's
      ``expected_mode`` (a small drift that fell back, or an oversized
      one the policy failed to refuse) is a policy regression;
    * an incremental scenario whose NMI trails its from-scratch twin
      by more than ``nmi_gap`` broke the quality contract;
    * an incremental scenario whose device time is >= its from-scratch
      twin's broke the speed contract — an "incremental" run that
      costs a full recompute has no reason to exist;
    * an incremental scenario that compiled anything warm broke the
      shared-executable contract (the frontier mask and warm labels
      are data, not shape — bucketed executables must be reused);
    * delta-class SLO attainment below ``attain_min`` means the new
      SLO class regressed the moment it shipped.
    """
    problems: List[str] = []
    for config, recs in groups.items():
        seqd = [r for r in recs if r["seq"] is not None
                and r.get("serve_delta")]
        if not seqd:
            continue
        latest_seq = max(r["seq"] for r in seqd)
        for r in seqd:
            if r["seq"] != latest_seq:
                continue
            tag = f"{config} [{r['source']} seq {r['seq']}]"
            sd = r["serve_delta"]
            for sc in sd.get("scenarios", ()):
                k = sc.get("k_pct")
                mode = sc.get("mode")
                expected = sc.get("expected_mode")
                if expected is not None and mode != expected:
                    problems.append(
                        f"{tag}: k={k}% perturbation ran "
                        f"mode={mode!r} (reason "
                        f"{sc.get('reason')!r}), expected "
                        f"{expected!r} — the delta policy regressed")
                    continue
                if mode != "incremental":
                    continue  # fallback scenarios ARE the scratch run
                inc = sc.get("incremental") or {}
                scr = sc.get("scratch") or {}
                i_nmi, s_nmi = inc.get("nmi"), scr.get("nmi")
                if i_nmi is not None and s_nmi is not None and \
                        i_nmi < s_nmi - nmi_gap:
                    problems.append(
                        f"{tag}: k={k}% incremental NMI {i_nmi:.4f} "
                        f"trails its from-scratch twin {s_nmi:.4f} by "
                        f"more than {nmi_gap} — warm-start quality "
                        f"broke")
                i_dev, s_dev = inc.get("device_s"), scr.get("device_s")
                if i_dev is not None and s_dev is not None and \
                        float(i_dev) >= float(s_dev):
                    problems.append(
                        f"{tag}: k={k}% incremental device time "
                        f"{float(i_dev):.4f}s >= from-scratch "
                        f"{float(s_dev):.4f}s — the warm-start run "
                        f"costs a full recompute")
                if sc.get("warm_compiles"):
                    problems.append(
                        f"{tag}: k={k}% incremental run compiled "
                        f"{sc['warm_compiles']} executable(s) warm — "
                        f"delta runs must reuse the bucketed "
                        f"executables")
            att = sd.get("slo_delta_attainment")
            if att is not None and float(att) < attain_min:
                problems.append(
                    f"{tag}: delta-class SLO attainment "
                    f"{float(att):.3f} below the {attain_min} floor")
    return problems


def check_flight(groups: Dict[str, List[dict]]) -> List[str]:
    """fcflight findings over sequenced records; [] means the gate
    passes.  Unlike the trend gates this one is absolute, not
    trajectory-based: a CLEAN sequenced load run (the CI serve_load
    sweep drives moderate traffic at healthy RPS) must never trip the
    hang watchdog — a trip means either a real stall in the serving
    path or a watchdog threshold so tight it fires on healthy traffic,
    and both block.  Only the newest sequence is judged (historic
    records keep their trips as archaeology), and records without a
    ``flight`` block (pre-fcflight artifacts) pass vacuously."""
    problems: List[str] = []
    for config, recs in groups.items():
        seqd = [r for r in recs if r["seq"] is not None
                and r.get("flight")]
        if not seqd:
            continue
        latest_seq = max(r["seq"] for r in seqd)
        for r in seqd:
            if r["seq"] != latest_seq:
                continue
            trips = int((r.get("flight") or {}).get(
                "watchdog_trips", 0) or 0)
            if trips > 0:
                problems.append(
                    f"{config} [{r['source']} seq {r['seq']}]: the "
                    f"hang watchdog tripped {trips} time(s) during a "
                    f"clean sequenced load run — a serving stall or a "
                    f"threshold regression (telemetry.flight)")
    return problems


def _worst_proxy_p95(rec: dict) -> Optional[float]:
    """The slowest replica's proxy-overhead p95 (ms) in one record's
    fleet_latency block — the per-replica attribution folded to the
    single worst number a trajectory can run on."""
    fl = rec.get("fleet_latency") or {}
    vals = [float(v) for v in (fl.get("proxy_overhead_p95_ms")
                               or {}).values() if v is not None]
    return max(vals) if vals else None


def check_fleet_latency(groups: Dict[str, List[dict]],
                        e2e_growth: float = DEFAULT_FLEET_E2E_GROWTH,
                        proxy_growth: float =
                        DEFAULT_PROXY_OVERHEAD_GROWTH) -> List[str]:
    """fctrace findings over records carrying a ``fleet_latency``
    block (bench.py serve_fleet's /fleetz scrape); [] means the gate
    passes.  Judged on the newest sequence only, two kinds of rule:

    * **Absolute**, armed from the first committed artifact: a replica
      the /fleetz scrape could not reach, an inexact merge (fleet
      histogram counts != sum of per-replica counts — the bit-exact
      merge contract broke), or a fleet-merged e2e p95 above the worst
      single replica's p95 (impossible for a correct mixture quantile
      on the shared bucket grid; small-count bucket rounding gets a
      5% tolerance).
    * **Trajectory**: fleet-merged e2e p95 and worst-replica proxy
      overhead p95 vs the median of sequenced predecessors — growth
      beyond ``e2e_growth`` / ``proxy_growth`` (fractional) is a
      finding.  Pre-fctrace artifacts pass vacuously."""
    problems: List[str] = []
    for config, recs in groups.items():
        seqd = [r for r in recs if r["seq"] is not None
                and r.get("fleet_latency")]
        if not seqd:
            continue
        latest_seq = max(r["seq"] for r in seqd)
        for r in seqd:
            if r["seq"] != latest_seq:
                continue
            tag = f"{config} [{r['source']} seq {r['seq']}]"
            fl = r["fleet_latency"]
            down = fl.get("replicas_down") or ()
            if down:
                problems.append(
                    f"{tag}: /fleetz could not scrape "
                    f"{', '.join(str(d) for d in down)} — a fleet "
                    f"aggregate that omits a replica reads healthy "
                    f"exactly when it is not")
            if fl.get("merge_exact") is False:
                problems.append(
                    f"{tag}: the /fleetz histogram merge is inexact — "
                    f"fleet counts != sum of per-replica counts, the "
                    f"bit-exact merge contract broke")
            fleet_p95 = fl.get("fleet_e2e_p95_ms")
            worst_p95 = fl.get("worst_replica_e2e_p95_ms")
            if fleet_p95 is not None and worst_p95 is not None \
                    and float(fleet_p95) > 1.05 * float(worst_p95):
                problems.append(
                    f"{tag}: fleet-merged e2e p95 {fleet_p95:.1f}ms "
                    f"exceeds the worst replica's {worst_p95:.1f}ms — "
                    f"a mixture quantile cannot, so the merge (or the "
                    f"scrape) is wrong")
            # trajectory vs the median of sequenced predecessors
            prior = [p for p in seqd if p["seq"] < latest_seq]
            if fleet_p95 is not None:
                base = [float(p["fleet_latency"]["fleet_e2e_p95_ms"])
                        for p in prior
                        if p["fleet_latency"].get("fleet_e2e_p95_ms")
                        is not None]
                if base:
                    ceil = (1.0 + e2e_growth) * _median(base)
                    if float(fleet_p95) > ceil:
                        problems.append(
                            f"{tag}: fleet-merged e2e p95 "
                            f"{float(fleet_p95):.1f}ms grew past "
                            f"{ceil:.1f}ms ({e2e_growth:.0%} over the "
                            f"prior median) — the fleet's tail "
                            f"regressed")
            worst_proxy = _worst_proxy_p95(r)
            if worst_proxy is not None:
                base = [w for w in (_worst_proxy_p95(p) for p in prior)
                        if w is not None]
                if base:
                    ceil = (1.0 + proxy_growth) * _median(base)
                    if worst_proxy > ceil:
                        problems.append(
                            f"{tag}: worst-replica proxy overhead p95 "
                            f"{worst_proxy:.2f}ms grew past "
                            f"{ceil:.2f}ms ({proxy_growth:.0%} over "
                            f"the prior median) — the router hop got "
                            f"expensive")
    return problems


_Q_COLUMNS: List[Tuple[str, str]] = [
    ("rounds", "rounds"), ("rounds_to_converge", "rtc"),
    ("final_agreement", "agreement"),
    ("final_modularity_mean", "modularity"),
    ("final_frontier_frac", "frontier"),
    ("late_frontier_frac", "late_frontier"),
    ("final_churn_frac", "churn"),
    ("labels_changed_total", "labels_moved"),
    ("agg_overflow_total", "agg_ovfl"),
]


def quality_table(groups: Dict[str, List[dict]],
                  markdown: bool = False) -> str:
    """Convergence-quality trend tables for configs whose records carry
    the fcqual ``quality`` block: per artifact, rounds run / rounds to
    converge (``-`` = hit max_rounds unconverged), final ensemble
    agreement and mean modularity, the final and late-half active-
    frontier fractions (how much of the graph still has undecided
    consensus edges — the number a frontier-masked detect pass would
    exploit), total label churn, and aggregate-overflow total.  Empty
    string when no record in the history has a quality block."""
    lines: List[str] = []
    for config, recs in groups.items():
        rows = [[_fmt(r["seq"]), r["source"]]
                + [_fmt((r["quality"] or {}).get(k)) for k, _ in
                   _Q_COLUMNS]
                for r in recs if r.get("quality")]
        if not rows:
            continue
        lines += _render_rows(f"{config} quality",
                              ["seq", "source"]
                              + [h for _, h in _Q_COLUMNS],
                              rows, markdown)
    return "\n".join(lines).rstrip()


def check_quality(groups: Dict[str, List[dict]],
                  rounds_growth_frac: float = DEFAULT_ROUNDS_GROWTH_FRAC,
                  agreement_drop: float = DEFAULT_AGREEMENT_DROP,
                  frontier_growth: float = DEFAULT_FRONTIER_GROWTH
                  ) -> List[str]:
    """Partition-quality regression findings over the fcqual blocks; []
    means the gate passes.  Per config, the newest sequenced record
    carrying a quality block is judged against the median of its
    sequenced predecessors (same arming rule as every other gate here:
    fewer than two sequenced quality-carrying records = no trajectory =
    pass):

    * **rounds-to-converge growth** — the run converges, but in more
      than ``(1 + rounds_growth_frac) x`` the prior median rounds: the
      consensus loop is spinning (a weight-update or churn bug that
      throughput alone hides, because later rounds are cheaper);
    * **final-agreement drop** — final ensemble agreement fell more
      than ``agreement_drop`` (absolute) below the prior median: the
      ensemble stopped agreeing on the partition it ships;
    * **late-frontier growth** — the late-half mean active-frontier
      fraction grew more than ``frontier_growth`` (absolute) over the
      prior median: the frontier stopped contracting, i.e. weight
      thresholding/freezing went dead and "converged" is no longer
      doing work.
    """
    problems: List[str] = []
    for config, recs in groups.items():
        seqd = [r for r in recs if r["seq"] is not None
                and r.get("quality")]
        if len(seqd) < 2:
            continue
        latest_seq = max(r["seq"] for r in seqd)
        latest = [r for r in seqd if r["seq"] == latest_seq]
        prior = [r["quality"] for r in seqd if r["seq"] < latest_seq]

        def _prior(key):
            vals = [q.get(key) for q in prior]
            return [v for v in vals if v is not None]

        prior_rtc = _prior("rounds_to_converge")
        prior_agree = _prior("final_agreement")
        prior_frontier = _prior("late_frontier_frac")
        for r in latest:
            q = r["quality"]
            tag = f"{config} [{r['source']} seq {r['seq']}]"
            rtc = q.get("rounds_to_converge")
            if prior_rtc and rtc is not None:
                base = _median(prior_rtc)
                ceil = (1.0 + rounds_growth_frac) * base
                if rtc > ceil:
                    problems.append(
                        f"{tag}: rounds-to-converge {rtc} grew past "
                        f"{ceil:.1f} ({rounds_growth_frac:.0%} over the "
                        f"prior median {base:.1f}) — the consensus loop "
                        f"is spinning (quality.rounds_to_converge)")
            agree = q.get("final_agreement")
            if prior_agree and agree is not None:
                base = _median(prior_agree)
                if agree < base - agreement_drop:
                    problems.append(
                        f"{tag}: final ensemble agreement {agree:.3f} "
                        f"dropped more than {agreement_drop} below the "
                        f"prior median {base:.3f} "
                        f"(quality.final_agreement)")
            frontier = q.get("late_frontier_frac")
            if prior_frontier and frontier is not None:
                base = _median(prior_frontier)
                if frontier > base + frontier_growth:
                    problems.append(
                        f"{tag}: late-round active-frontier fraction "
                        f"{frontier:.3f} grew more than "
                        f"{frontier_growth} over the prior median "
                        f"{base:.3f} — the frontier stopped "
                        f"contracting (quality.late_frontier_frac)")
    return problems


def load_footprints(paths: List[str]) -> List[dict]:
    """fcheck-footprint artifacts (``runs/footprint_rNN.json`` — the
    schema analysis/footprint.py documents), normalized and ordered by
    round sequence; files that are not footprint artifacts are skipped
    silently, mirroring :func:`load_records`."""
    out = []
    for path in paths:
        try:
            with open(path, encoding="utf-8") as fh:
                doc = json.load(fh)
        # fcheck: ok=swallowed-error (an unreadable footprint
        # artifact simply drops out of the trend gate's window)
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(doc, dict) or \
                doc.get("tool") != "fcheck-footprint":
            continue
        gate = doc.get("gate") or []
        worst = max(gate, key=lambda r: r.get("peak_bytes", 0),
                    default=None)
        out.append({
            "source": os.path.basename(path),
            "seq": _seq_from_name(path),
            "surface_count": doc.get("surface_count"),
            "surface_budget": doc.get("surface_budget"),
            "chip_ceiling_edges": doc.get("chip_ceiling_edges"),
            "max_pad_frac": doc.get("max_pad_frac"),
            "hbm_bytes": (doc.get("config") or {}).get("hbm_bytes"),
            "worst_peak_bytes": (worst or {}).get("peak_bytes"),
            "worst_bucket": (worst or {}).get("bucket"),
            "buckets": doc.get("buckets") or [],
        })
    out.sort(key=lambda r: (r["seq"] is not None, r["seq"] or 0,
                            r["source"]))
    return out


def _render_rows(title: str, header: List[str], rows: List[List[str]],
                 markdown: bool) -> List[str]:
    lines: List[str] = []
    if markdown:
        lines.append(f"### {title}")
        lines.append("| " + " | ".join(header) + " |")
        lines.append("|" + "|".join("---" for _ in header) + "|")
        lines.extend("| " + " | ".join(row) + " |" for row in rows)
    else:
        lines.append(f"== {title} ==")
        widths = [max(len(header[i]), *(len(r[i]) for r in rows))
                  for i in range(len(header))]
        lines.append("  ".join(h.ljust(w)
                               for h, w in zip(header, widths)))
        for row in rows:
            lines.append("  ".join(c.ljust(w)
                                   for c, w in zip(row, widths)))
    lines.append("")
    return lines


def _gib(v) -> str:
    return "-" if v is None else f"{v / (1 << 30):.2f}"


def footprint_table(fps: List[dict], markdown: bool = False) -> str:
    """Trend + per-bucket footprint tables: the executable-surface and
    padding columns of the serving memory model.  Empty string when no
    footprint artifact is committed."""
    if not fps:
        return ""
    lines = _render_rows(
        "fcheck-footprint trend",
        ["seq", "source", "surface", "budget", "ceiling_edges",
         "worst_peak_gib", "worst_bucket", "max_pad"],
        [[_fmt(f["seq"]), f["source"], _fmt(f["surface_count"]),
          _fmt(f["surface_budget"]), _fmt(f["chip_ceiling_edges"]),
          _gib(f["worst_peak_bytes"]), _fmt(f["worst_bucket"]),
          _fmt(f["max_pad_frac"])] for f in fps],
        markdown)
    newest = fps[-1]
    if newest["buckets"]:
        lines += _render_rows(
            f"footprint buckets [{newest['source']}]",
            ["bucket", "batch", "peak_gib", "solo_gib", "arg_mib",
             "pad_frac"],
            [[b["bucket"], _fmt(b.get("batch")),
              _gib(b.get("peak_bytes")), _gib(b.get("solo_peak_bytes")),
              "-" if b.get("arg_bytes") is None
              else f"{b['arg_bytes'] / (1 << 20):.1f}",
              _fmt(b.get("pad_frac"))] for b in newest["buckets"]],
            markdown)
    return "\n".join(lines).rstrip()


def check_footprints(fps: List[dict]) -> List[str]:
    """Footprint regression findings: the newest sequenced artifact's
    executable surface grew versus the prior committed one (a silent
    static-axis or ladder expansion — deliberate growth should raise
    footprint.SURFACE_BUDGET_DEFAULT with a rationale in the same
    change), or its surface breached its own pinned budget."""
    problems: List[str] = []
    seqd = [f for f in fps if f["seq"] is not None
            and f["surface_count"] is not None]
    if not seqd:
        return problems
    newest = seqd[-1]
    tag = f"footprint [{newest['source']} seq {newest['seq']}]"
    prior = [f for f in seqd if f["seq"] < newest["seq"]]
    if prior:
        base = prior[-1]
        if newest["surface_count"] > base["surface_count"]:
            problems.append(
                f"{tag}: executable surface grew "
                f"{base['surface_count']} -> {newest['surface_count']} "
                f"vs {base['source']} — every extra executable is a "
                f"compile the fleet pays per bucket; if deliberate, "
                f"raise the pinned surface budget in the same change")
    if newest["surface_budget"] is not None and \
            newest["surface_count"] > newest["surface_budget"]:
        problems.append(
            f"{tag}: surface {newest['surface_count']} exceeds its own "
            f"pinned budget {newest['surface_budget']}")
    return problems


def load_costs(paths: List[str]) -> List[dict]:
    """fcheck-cost artifacts (``runs/cost_rNN.json`` — the schema
    analysis/cost.py documents), normalized and ordered by round
    sequence; files that are not cost artifacts are skipped silently,
    mirroring :func:`load_footprints`."""
    out = []
    for path in paths:
        try:
            with open(path, encoding="utf-8") as fh:
                doc = json.load(fh)
        # fcheck: ok=swallowed-error (an unreadable cost artifact
        # simply drops out of the trend gate's window)
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(doc, dict) or doc.get("tool") != "fcheck-cost":
            continue
        dead = doc.get("dead_compute") or {}
        out.append({
            "source": os.path.basename(path),
            "seq": _seq_from_name(path),
            "run_dead_frac": dead.get("run_dead_frac"),
            "late_round_dead_frac": dead.get("late_round_dead_frac"),
            "waste_budget": dead.get("waste_budget"),
            "dead_bucket": dead.get("bucket"),
            "round_flops": dead.get("round_flops"),
            "duality": doc.get("duality") or [],
            "gate": doc.get("gate") or [],
            "calibration": doc.get("calibration"),
        })
    out.sort(key=lambda r: (r["seq"] is not None, r["seq"] or 0,
                            r["source"]))
    return out


def _tflop(v) -> str:
    return "-" if v is None else f"{v / 1e12:.3f}"


def cost_table(costs: List[dict], markdown: bool = False) -> str:
    """Trend + duality + roofline tables of the static compute-cost
    model.  Empty string when no cost artifact is committed."""
    if not costs:
        return ""
    lines = _render_rows(
        "fcheck-cost trend",
        ["seq", "source", "dead_bucket", "round_tflops", "run_dead",
         "late_dead", "budget", "cal_est_ms"],
        [[_fmt(c["seq"]), c["source"], _fmt(c["dead_bucket"]),
          _tflop(c["round_flops"]), _fmt(c["run_dead_frac"]),
          _fmt(c["late_round_dead_frac"]), _fmt(c["waste_budget"]),
          _fmt((c["calibration"] or {}).get("est_device_ms"))]
         for c in costs],
        markdown)
    newest = costs[-1]
    if newest["duality"]:
        lines += _render_rows(
            f"cost duality [{newest['source']}]",
            ["bucket", "batch", "solo_s", "per_job_s", "saving"],
            [[d["bucket"], _fmt(d.get("batch")),
              _fmt(d.get("solo_est_s")), _fmt(d.get("per_job_est_s")),
              _fmt(d.get("per_job_saving_frac"))]
             for d in newest["duality"]],
            markdown)
    if newest["gate"]:
        worst = sorted(newest["gate"],
                       key=lambda r: -(r.get("est_device_s") or 0.0))[:8]
        lines += _render_rows(
            f"cost roofline, costliest executables [{newest['source']}]",
            ["kind", "bucket", "batch", "tflops", "intensity", "est_s"],
            [[g["kind"], g["bucket"], _fmt(g.get("batch")),
              _tflop(g.get("flops")), _fmt(g.get("arith_intensity")),
              _fmt(g.get("est_device_s"))] for g in worst],
            markdown)
    return "\n".join(lines).rstrip()


# Modeled est_device_s growth per surface kind between consecutive
# committed cost artifacts that counts as a roofline regression.  Loose
# enough that mirror-coefficient refits pass, tight enough that an
# accidental algorithmic blowup (a lost frontier gate reintroducing an
# n^2 path doubles the estimate and more) always lands outside.
DEFAULT_COST_GROWTH_FRAC = 0.5


def check_costs(costs: List[dict],
                growth_frac: float = DEFAULT_COST_GROWTH_FRAC
                ) -> List[str]:
    """Cost regression findings: per matching (kind, bucket, batch)
    gate row, the newest sequenced artifact's modeled ``est_device_s``
    grew beyond ``growth_frac`` over the prior committed one
    (``cost-roofline-regress``), or the newest dead-compute bill
    breaches its own pinned waste budget (``cost-dead-compute``)."""
    problems: List[str] = []
    seqd = [c for c in costs if c["seq"] is not None]
    if not seqd:
        return problems
    newest = seqd[-1]
    tag = f"cost [{newest['source']} seq {newest['seq']}]"
    prior = [c for c in seqd if c["seq"] < newest["seq"]]
    if prior:
        base_rows = {(g["kind"], g["bucket"], g.get("batch")):
                     g.get("est_device_s") for g in prior[-1]["gate"]}
        for g in newest["gate"]:
            base = base_rows.get((g["kind"], g["bucket"], g.get("batch")))
            est = g.get("est_device_s")
            if not base or est is None:
                continue
            if est > base * (1.0 + growth_frac):
                problems.append(
                    f"{tag}: cost-roofline-regress: modeled "
                    f"est_device_s for {g['kind']} at {g['bucket']} "
                    f"grew {base:.6f}s -> {est:.6f}s "
                    f"(> +{growth_frac:.0%} vs {prior[-1]['source']}) "
                    f"— the static surface got costlier; if "
                    f"deliberate, land the re-baseline with the "
                    f"change that justifies it")
    if newest["run_dead_frac"] is not None and \
            newest["waste_budget"] is not None and \
            newest["run_dead_frac"] > newest["waste_budget"]:
        problems.append(
            f"{tag}: cost-dead-compute: run dead-compute fraction "
            f"{newest['run_dead_frac']:.2f} breaches the pinned waste "
            f"budget {newest['waste_budget']:.2f}")
    return problems


def check_cost_calibration(costs: List[dict],
                           groups: Dict[str, List[dict]]) -> List[str]:
    """Predicted-vs-measured honesty gate for the static cost model:
    the newest cost artifact's ``calibration.est_device_ms`` (the
    modeled device time of the serve_load reference executable) must
    land within ``calibration.band`` (either direction) of the measured
    ``serve.phase.device`` tail at the reference RPS of the newest
    committed serve_load curve on the same bucket.  A model outside the
    band is feeding the shaper and scheduler priors that no longer
    describe the hardware."""
    problems: List[str] = []
    cal = None
    for c in costs:
        if c.get("calibration"):
            cal = (c, c["calibration"])
    if cal is None:
        return problems
    crec, cblock = cal
    bucket = str(cblock.get("bucket") or "")
    est_ms = cblock.get("est_device_ms")
    band = float(cblock.get("band") or 4.0)
    if not est_ms or not bucket:
        return problems
    measured: List[Tuple[int, str, float]] = []
    for recs in groups.values():
        for r in recs:
            if not r.get("serve_load") or r["seq"] is None:
                continue
            if f"bucket {bucket}" not in str(r.get("unit", "")):
                continue
            pt = _sl_ref_point(r)
            dev = ((pt or {}).get("phase_p95_ms") or {}).get("device")
            if dev:
                measured.append((r["seq"], r["source"], float(dev)))
    if not measured:
        return problems
    seq, source, dev_ms = max(measured)
    ratio = max(est_ms / dev_ms, dev_ms / est_ms)
    if ratio > band:
        problems.append(
            f"cost [{crec['source']} seq {crec['seq']}]: calibration "
            f"drift at {bucket}: modeled device time {est_ms:.1f} ms "
            f"vs measured serve.phase.device p95 {dev_ms:.1f} ms "
            f"[{source} seq {seq}] is {ratio:.1f}x apart "
            f"(band {band:.0f}x) — refit the machine-model constants "
            f"or find what the model stopped seeing")
    return problems


def check_history(groups: Dict[str, List[dict]],
                  max_drop_frac: float = DEFAULT_MAX_DROP_FRAC,
                  nmi_drop: float = DEFAULT_NMI_DROP) -> List[str]:
    """Regression findings over the history; [] means the gate passes.

    Per config, the newest sequenced record(s) are judged against the
    median of the earlier sequenced ones (median, not min/max: the
    committed history contains one known transport-collapsed round whose
    value must neither fail the gate retroactively nor drag the baseline
    down).  Configs with fewer than two sequenced records have no
    trajectory to judge and pass.
    """
    problems: List[str] = []
    for config, recs in groups.items():
        seqd = [r for r in recs if r["seq"] is not None]
        if len(seqd) < 2:
            continue
        latest_seq = max(r["seq"] for r in seqd)
        latest = [r for r in seqd if r["seq"] == latest_seq]
        prior = [r for r in seqd if r["seq"] < latest_seq]
        if not prior:
            continue
        base_value = _median([r["value"] for r in prior])
        prior_nmi = [r["nmi"] for r in prior if r["nmi"] is not None]
        for r in latest:
            tag = f"{config} [{r['source']} seq {r['seq']}]"
            if r.get("serve_load") or r.get("serve_fleet") \
                    or r.get("serve_delta"):
                # latency-curve artifacts are lower-is-better: the
                # throughput-drop/NMI rules would gate the WRONG
                # direction (an improvement would "fail").  The tail-
                # latency gate (check_serve_load) owns them; the
                # warm-compile retrace rule still applies below.
                # serve_fleet artifacts are higher-is-better scaling
                # RATIOS, but ratios taken at different largest fleet
                # sizes are not one trajectory — check_serve_fleet
                # owns them, anchored on matching size.  serve_delta
                # artifacts are speedup ratios vs an in-artifact
                # from-scratch twin — check_delta owns them with
                # absolute rules.
                if (r["compiles_warm"] or 0) > 0:
                    problems.append(
                        f"{tag}: {r['compiles_warm']} warm-run "
                        f"compile(s) — a retrace regression "
                        f"(telemetry.compiles_warm)")
                continue
            floor = (1.0 - max_drop_frac) * base_value
            if r["value"] < floor:
                problems.append(
                    f"{tag}: throughput {r['value']:.3f} fell below "
                    f"{floor:.3f} ({max_drop_frac:.0%} drop from the "
                    f"prior median {base_value:.3f})")
            if prior_nmi and r["nmi"] is not None and \
                    r["nmi"] < _median(prior_nmi) - nmi_drop:
                problems.append(
                    f"{tag}: NMI {r['nmi']:.4f} dropped more than "
                    f"{nmi_drop} below the prior median "
                    f"{_median(prior_nmi):.4f}")
            prior_conv = [p["converged"] for p in prior
                          if p["converged"] is not None]
            # prior_conv must be non-empty: with no prior convergence
            # evidence at all, all([]) would vacuously "prove" every
            # prior run converged and fail CI on a false premise
            if r["converged"] is False and prior_conv and \
                    all(prior_conv):
                problems.append(
                    f"{tag}: run no longer converges (every prior "
                    f"sequenced run did)")
            if (r["compiles_warm"] or 0) > 0:
                problems.append(
                    f"{tag}: {r['compiles_warm']} warm-run compile(s) — "
                    f"a retrace regression (telemetry.compiles_warm)")
    return problems
