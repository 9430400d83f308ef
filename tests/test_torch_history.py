"""The port's bench-history reader (obs/history.py) and its CLI
(``python -m fastconsensus_tpu_torch.obs.bench_report``), against the
reference's.

* Cross-package parity on every committed artifact (``BENCH_*.json``,
  ``runs/bench_*.json``, ``runs/footprint_r08.json``,
  ``runs/cost_r16.json``): each file alone and the whole history go
  through both packages' ``load_records``, ``build_history``, every
  ``*_table`` (text and markdown) and every ``check_*``, with equal
  records, text and findings; the port's own ``--footprint-out`` and
  ``--cost-out`` blocks load and render equally in both.
* The reference's sixteen ``tests/test_history.py`` cases run against
  the port's module, the CLI cases through the port's ``bench_report``.
* The module and the CLI with ``torch``, ``jax`` and
  ``fastconsensus_tpu`` poisoned in ``sys.modules``.

Tolerance: exact.
"""

import glob
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from fastconsensus_tpu.obs import history as jhist
from fastconsensus_tpu_torch.obs import history

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORT = ["-m", "fastconsensus_tpu_torch.obs.bench_report"]

BENCH = sorted(glob.glob(os.path.join(REPO, "BENCH_*.json"))) + \
    sorted(glob.glob(os.path.join(REPO, "runs", "bench_*.json")))
FOOTPRINTS = sorted(glob.glob(os.path.join(REPO, "runs",
                                           "footprint_r*.json")))
COSTS = sorted(glob.glob(os.path.join(REPO, "runs", "cost_r*.json")))

TABLES = ("trend_table", "device_table", "serve_load_table",
          "serve_fleet_table", "quality_table")
CHECKS = ("check_history", "check_serve_load", "check_serve_fleet",
          "check_delta", "check_flight", "check_fleet_latency",
          "check_quality")


def test_the_committed_artifacts_are_all_there():
    names = {os.path.basename(p) for p in BENCH + FOOTPRINTS + COSTS}
    assert {"BENCH_r03.json", "bench_lfr1k_r5.json",
            "bench_serve_fleet_r18.json", "bench_serve_delta_r19.json",
            "footprint_r08.json", "cost_r16.json"} <= names


def test_thresholds_equal_the_reference():
    consts = {k: v for k, v in vars(jhist).items()
              if k.startswith("DEFAULT_")}
    assert len(consts) == 15
    assert {k: getattr(history, k) for k in consts} == consts


def _views(mod, paths):
    """Every view and finding of one path set, in one dict."""
    groups = mod.build_history(paths)
    out = {"groups": groups}
    for name in TABLES:
        for md in (False, True):
            out[f"{name}/{md}"] = getattr(mod, name)(groups, markdown=md)
    for name in CHECKS:
        out[name] = getattr(mod, name)(groups)
    fps = mod.load_footprints(paths)
    costs = mod.load_costs(paths)
    out.update(footprints=fps, costs=costs,
               check_footprints=mod.check_footprints(fps),
               check_costs=mod.check_costs(costs),
               check_cost_calibration=mod.check_cost_calibration(costs,
                                                                 groups))
    for md in (False, True):
        out[f"footprint_table/{md}"] = mod.footprint_table(fps, markdown=md)
        out[f"cost_table/{md}"] = mod.cost_table(costs, markdown=md)
    return out


@pytest.mark.parametrize("path", BENCH + FOOTPRINTS + COSTS,
                         ids=os.path.basename)
def test_each_artifact_gives_the_references_records_views_and_findings(
        path):
    assert history.load_records(path) == jhist.load_records(path)
    assert _views(history, [path]) == _views(jhist, [path])


def test_the_whole_history_gives_the_references_views_and_findings():
    paths = BENCH + FOOTPRINTS + COSTS
    got, want = _views(history, paths), _views(jhist, paths)
    assert got == want
    # the history carries every kind of block the views render
    for key in ("trend_table/False", "device_table/False",
                "serve_load_table/False", "serve_fleet_table/False",
                "quality_table/False", "footprint_table/False",
                "cost_table/False"):
        assert got[key], key
    assert got["check_history"] == []


def test_the_ports_own_fcheck_artifacts_load_in_both(tmp_path):
    """The blocks the port's analysis CLI writes with --footprint-out and
    --cost-out carry every key the loaders read."""
    from fastconsensus_tpu_torch.analysis import cost, footprint

    _, fp = footprint.evaluate(
        footprint.SurfaceSpec(hbm_bytes=footprint.H100_HBM_BYTES),
        rules=set(footprint.FOOTPRINT_RULES), with_table=True,
        with_ceiling=False)
    _, cb = cost.evaluate(cost.CostSpec(), rules=set(cost.COST_RULES),
                          with_table=True)
    paths = []
    for name, block in (("footprint_r30.json", fp), ("cost_r30.json", cb)):
        p = tmp_path / name
        p.write_text(json.dumps(block))
        paths.append(str(p))
    fps = history.load_footprints(paths)
    costs = history.load_costs(paths)
    assert fps == jhist.load_footprints(paths) and len(fps) == 1
    assert costs == jhist.load_costs(paths) and len(costs) == 1
    f, c = fps[0], costs[0]
    for key in ("surface_count", "surface_budget", "max_pad_frac",
                "hbm_bytes", "worst_peak_bytes", "worst_bucket"):
        assert f[key] is not None, key
    assert f["buckets"] and all(
        {"bucket", "batch", "peak_bytes", "solo_peak_bytes", "arg_bytes",
         "pad_frac"} <= set(b) for b in f["buckets"])
    for key in ("run_dead_frac", "late_round_dead_frac", "waste_budget",
                "dead_bucket", "round_flops", "calibration"):
        assert c[key] is not None, key
    assert c["duality"] and c["gate"]
    assert {"est_device_ms", "bucket", "band"} <= set(c["calibration"])
    for md in (False, True):
        assert history.footprint_table(fps, markdown=md) == \
            jhist.footprint_table(fps, markdown=md)
        assert history.cost_table(costs, markdown=md) == \
            jhist.cost_table(costs, markdown=md)
    assert history.check_footprints(fps) == jhist.check_footprints(fps)
    assert history.check_costs(costs) == jhist.check_costs(costs)


@pytest.mark.parametrize("argv", [
    ["--check"], ["--markdown"], ["--check", "--quiet"]])
def test_bench_report_prints_what_the_references_prints(argv):
    """Same stdout, stderr and exit code as scripts/bench_report.py on
    the committed history (the reference validates its gate against its
    own inventory, the port against the port's)."""
    port = _run_report(*argv)
    ref = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "bench_report.py"),
         *argv], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert port.returncode == ref.returncode == 0, port.stderr + ref.stderr
    assert port.stdout == ref.stdout
    assert port.stderr == ref.stderr


_POISONED = textwrap.dedent("""\
    import sys

    sys.modules["torch"] = None
    sys.modules["jax"] = None
    sys.modules["fastconsensus_tpu"] = None
    sys.path.insert(0, sys.argv[1])
    import glob, os
    from fastconsensus_tpu_torch.obs import bench_report, history

    paths = sorted(glob.glob(os.path.join(sys.argv[1], "BENCH_*.json")))
    groups = history.build_history(paths)
    assert groups and history.check_history(groups) == []
    assert history.trend_table(groups)
    sys.exit(bench_report.main(["--check", "--quiet"]))
    """)


def test_history_and_bench_report_run_with_torch_and_jax_poisoned():
    proc = subprocess.run([sys.executable, "-c", _POISONED, REPO],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "no regressions" in proc.stderr


# -- the reference's tests/test_history.py, against the port ------------


def _driver_artifact(seq, value, nmi=0.95, telemetry=None, **over):
    parsed = {"metric": "consensus_partitions_per_sec_per_chip",
              "value": value,
              "unit": "partitions/s/chip (lfr=lfr1k, alg=louvain, "
                      "n_p=50)",
              "vs_baseline": value / 3.6, "nmi": nmi,
              "baseline_nmi": 0.9222, "seconds": 1.0, "rounds": 4,
              "converged": True, "n_chips": 1, "mesh": "1x1",
              "backend": "tpu", "dispatch_rtt_ms_post": 0.1}
    if telemetry is not None:
        parsed["telemetry"] = telemetry
    parsed.update(over)
    return {"n": seq, "cmd": "python bench.py", "rc": 0, "parsed": parsed}


def _write_series(tmp_path, values, **last_over):
    paths = []
    for i, v in enumerate(values, start=1):
        over = last_over if i == len(values) else {}
        p = tmp_path / f"BENCH_r{i:02d}.json"
        p.write_text(json.dumps(_driver_artifact(i, v, **over)))
        paths.append(str(p))
    return paths


def test_load_records_handles_all_committed_shapes():
    # driver wrapper with "n"
    recs = history.load_records(os.path.join(REPO, "BENCH_r03.json"))
    assert len(recs) == 1 and recs[0]["seq"] == 3
    assert recs[0]["config"] == "lfr1k/louvain/np50"
    assert recs[0]["value"] == 6.897
    # raw bench JSON line, seq from the _rN filename suffix
    recs = history.load_records(
        os.path.join(REPO, "runs", "bench_lfr1k_r5.json"))
    assert len(recs) == 1 and recs[0]["seq"] == 5
    # non-bench files contribute nothing (the CPU-baseline cache)
    assert history.load_records(
        os.path.join(REPO, "BENCH_BASELINE.json")) == []
    assert history.load_records("/nonexistent/x.json") == []


def test_telemetry_columns_normalize():
    tel = {"compiles_cold": 24, "compiles_warm": 2,
           "host_syncs": {"total": 9, "round_stats": 4},
           "round_s": {"count": 4, "p50": 0.1, "p95": 0.4},
           "detect_call_s": {"count": 8, "p50": 0.2, "p95": 0.3}}
    rec = history._normalize(
        _driver_artifact(1, 50.0, telemetry=tel)["parsed"], "x.json", 1)
    assert rec["compiles_warm"] == 2
    assert rec["host_syncs_total"] == 13
    assert rec["round_p95_s"] == 0.4 and rec["detect_p95_s"] == 0.3


def test_committed_history_passes_the_gate():
    groups = history.build_history(BENCH)
    assert "lfr1k/louvain/np50" in groups
    assert history.check_history(groups) == []


def test_synthetic_throughput_regression_fails(tmp_path):
    paths = _write_series(tmp_path, [60.0, 65.0, 70.0, 9.0])
    problems = history.check_history(history.build_history(paths))
    assert len(problems) == 1 and "throughput" in problems[0]
    # the same collapse in the MIDDLE of the history is not a finding
    paths = _write_series(tmp_path, [60.0, 9.0, 65.0, 70.0])
    assert history.check_history(history.build_history(paths)) == []


def test_nmi_and_convergence_and_warm_compile_regressions(tmp_path):
    paths = _write_series(tmp_path, [60.0, 65.0, 70.0], nmi=0.70)
    probs = history.check_history(history.build_history(paths))
    assert any("NMI" in p for p in probs)

    paths = _write_series(tmp_path, [60.0, 65.0, 70.0], converged=False)
    probs = history.check_history(history.build_history(paths))
    assert any("no longer converges" in p for p in probs)

    paths = _write_series(tmp_path, [60.0, 65.0, 70.0],
                          telemetry={"compiles_warm": 3})
    probs = history.check_history(history.build_history(paths))
    assert any("warm-run compile" in p for p in probs)

    # no prior record carries a converged field at all: a non-converged
    # latest is not a regression against runs that never reported it
    paths = []
    for i, v in enumerate([60.0, 65.0], start=1):
        art = _driver_artifact(i, v)
        del art["parsed"]["converged"]
        p = tmp_path / f"BENCH_r{i:02d}.json"
        p.write_text(json.dumps(art))
        paths.append(str(p))
    p = tmp_path / "BENCH_r03.json"
    p.write_text(json.dumps(_driver_artifact(3, 70.0, converged=False)))
    probs = history.check_history(history.build_history(paths + [str(p)]))
    assert not any("converges" in x for x in probs)


def test_unsequenced_records_trend_but_never_gate(tmp_path):
    paths = _write_series(tmp_path, [60.0, 65.0, 70.0])
    adhoc = tmp_path / "bench_lfr1k_rerun.json"
    adhoc.write_text(json.dumps(_driver_artifact(1, 2.0)["parsed"]))
    groups = history.build_history(paths + [str(adhoc)])
    assert len(groups["lfr1k/louvain/np50"]) == 4
    assert history.check_history(groups) == []
    table = history.trend_table(groups)
    assert "bench_lfr1k_rerun.json" in table


def _run_report(*argv):
    return subprocess.run([sys.executable, *REPORT, *argv],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=120)


def test_bench_report_cli_check_passes_on_committed_history():
    res = _run_report("--check", "--quiet")
    assert res.returncode == 0, res.stderr
    assert "no regressions" in res.stderr


def test_bench_report_cli_flags_synthetic_regression(tmp_path):
    paths = _write_series(tmp_path, [60.0, 65.0, 9.0])
    res = _run_report("--check", *paths)
    assert res.returncode == 1
    assert "REGRESSION" in res.stderr
    # the trend report still prints for the operator
    assert "lfr1k/louvain/np50" in res.stdout
    # markdown mode renders tables
    res = _run_report("--markdown", *paths)
    assert res.returncode == 0 and "| seq |" in res.stdout


def test_bench_report_cli_no_records_is_an_error(tmp_path):
    empty = tmp_path / "BENCH_empty.json"
    empty.write_text("{}")
    res = _run_report(str(empty))
    assert res.returncode == 2


def _serve_load_artifact(p95=20.0, attainment=1.0, rejected=0,
                         ref_rps=2.0, mix=None):
    def point(rps, scale):
        met = int(round(30 * attainment))
        return {"rps": rps, "seconds": 8.0, "submitted": 30,
                "completed": 30 - rejected, "failed": 0, "stranded": 0,
                "rejected_429": rejected, "achieved_rps": rps * 0.97,
                "p50_ms": round(p95 * scale * 0.6, 3),
                "p95_ms": round(p95 * scale, 3),
                "p99_ms": round(p95 * scale * 1.4, 3),
                "slo": {"met": met, "missed": 30 - met,
                        "attainment": attainment},
                "phase_p95_ms": {"queue_wait": 0.5, "deque_wait": 1.0,
                                 "pack": 2.0, "device": p95 * scale * 0.8,
                                 "fanout": 0.3, "respond": 0.01},
                "compiles": 0}

    return {"metric": "serve_load_p95_ms", "config": "serve_load",
            "value": p95,
            "unit": f"p95 ms at {ref_rps:g} rps (open-loop poisson, "
                    f"bucket n64_e96, louvain n_p=4)",
            "seconds": 32.0, "converged": True, "n_chips": 1,
            "mesh": "1x1", "backend": "cpu",
            "telemetry": {"compiles_warm": 0,
                          "phase_consistency_frac": 0.0,
                          "serve_load": {"reference_rps": ref_rps,
                                         "slo_class": "interactive",
                                         "mix": mix,
                                         "queue_depth": 32,
                                         "max_batch": 4,
                                         "points": [point(ref_rps, 1.0),
                                                    point(8.0, 2.0)]}}}


def _write_serve_load(tmp_path, seq, **over):
    p = tmp_path / f"bench_serve_load_r{seq:02d}.json"
    p.write_text(json.dumps(_serve_load_artifact(**over)))
    return str(p)


def test_serve_load_normalizes_and_renders():
    path = os.path.join(REPO, "runs", "bench_serve_load_r09.json")
    recs = history.load_records(path)
    assert len(recs) == 1 and recs[0]["seq"] == 9
    assert recs[0]["config"] == "serve_load"
    sl = recs[0]["serve_load"]
    assert len(sl["points"]) >= 4
    assert all(p["p95_ms"] is not None for p in sl["points"])
    table = history.serve_load_table(history.build_history([path]))
    assert "latency vs RPS" in table
    assert "deque_wait_p95" in table and "slo_attain" in table


def test_check_serve_load_gates_tail_latency(tmp_path):
    # one committed curve: no trajectory, passes
    one = [_write_serve_load(tmp_path, 9)]
    assert history.check_serve_load(history.build_history(one)) == []
    # a stable next round passes; 2x+ p95 growth at the reference fails
    ok = one + [_write_serve_load(tmp_path, 10, p95=24.0)]
    assert history.check_serve_load(history.build_history(ok)) == []
    bad = one + [_write_serve_load(tmp_path, 10, p95=200.0)]
    probs = history.check_serve_load(history.build_history(bad))
    assert len(probs) == 1 and "tail-latency" in probs[0]
    # attainment collapse and 429 growth are their own findings
    bad = one + [_write_serve_load(tmp_path, 10, attainment=0.5)]
    probs = history.check_serve_load(history.build_history(bad))
    assert any("attainment" in p for p in probs)
    bad = one + [_write_serve_load(tmp_path, 10, rejected=15)]
    probs = history.check_serve_load(history.build_history(bad))
    assert any("429" in p for p in probs)
    # a sweep whose grid changed has no prior anchor
    moved = one + [_write_serve_load(tmp_path, 10, p95=200.0,
                                     ref_rps=8.0)]
    assert history.check_serve_load(history.build_history(moved)) == []
    # nor does one whose SLO-class mix changed
    mixed = one + [_write_serve_load(
        tmp_path, 10, p95=200.0, mix="interactive:0.5,batch:0.5")]
    assert history.check_serve_load(history.build_history(mixed)) == []
    # while a same-mix regression still gates
    same_mix = [_write_serve_load(tmp_path, 9,
                                  mix="interactive:0.5,batch:0.5"),
                _write_serve_load(tmp_path, 10, p95=200.0,
                                  mix="interactive:0.5,batch:0.5")]
    probs = history.check_serve_load(history.build_history(same_mix))
    assert len(probs) == 1 and "tail-latency" in probs[0]


def test_check_history_never_inverts_on_latency_artifacts(tmp_path):
    paths = [_write_serve_load(tmp_path, 9),
             _write_serve_load(tmp_path, 10, p95=2.0)]   # 10x better
    groups = history.build_history(paths)
    assert history.check_history(groups) == []
    assert history.check_serve_load(groups) == []
    art = _serve_load_artifact(p95=20.0)
    art["telemetry"]["compiles_warm"] = 3
    (tmp_path / "bench_serve_load_r11.json").write_text(json.dumps(art))
    groups = history.build_history(
        paths + [str(tmp_path / "bench_serve_load_r11.json")])
    probs = history.check_history(groups)
    assert any("warm-run compile" in p for p in probs)


def test_bench_report_cli_gates_serve_load_regression(tmp_path):
    paths = [_write_serve_load(tmp_path, 9),
             _write_serve_load(tmp_path, 10, p95=200.0)]
    res = _run_report("--check", *paths)
    assert res.returncode == 1
    assert "tail-latency" in res.stderr
    assert "latency vs RPS" in res.stdout
    res = _run_report(*[paths[0]])
    assert res.returncode == 0 and "deque_wait_p95" in res.stdout


def _footprint_artifact(surface=13280, budget=16384, ceiling=4194304,
                        peak=1 << 30):
    return {"tool": "fcheck-footprint", "version": 1,
            "config": {"hbm_bytes": 24 << 30},
            "surface_count": surface, "surface_budget": budget,
            "chip_ceiling_edges": ceiling, "max_pad_frac": 0.5,
            "gate": [{"kind": "batch", "bucket": "n256_e128",
                      "batch": 8, "mode": "warm", "peak_bytes": peak,
                      "arg_bytes": 1024, "out_bytes": 512}],
            "buckets": [{"bucket": "n256_e128", "n_class": 256,
                         "e_class": 128, "capacity": 272, "batch": 8,
                         "peak_bytes": peak, "solo_peak_bytes": peak // 8,
                         "arg_bytes": 1024, "out_bytes": 512,
                         "pad_frac": 0.31}]}


def test_load_footprints_normalizes_and_orders(tmp_path):
    a = tmp_path / "footprint_r08.json"
    b = tmp_path / "footprint_r09.json"
    a.write_text(json.dumps(_footprint_artifact()))
    b.write_text(json.dumps(_footprint_artifact(surface=13290)))
    junk = tmp_path / "footprint_rX.json"
    junk.write_text("{\"tool\": \"something-else\"}")
    fps = history.load_footprints([str(b), str(junk), str(a)])
    assert [f["seq"] for f in fps] == [8, 9]
    assert fps[0]["surface_count"] == 13280
    assert fps[1]["worst_peak_bytes"] == 1 << 30
    table = history.footprint_table(fps)
    assert "fcheck-footprint trend" in table and "n256_e128" in table


def test_check_footprints_flags_surface_growth(tmp_path):
    a = tmp_path / "footprint_r08.json"
    b = tmp_path / "footprint_r09.json"
    a.write_text(json.dumps(_footprint_artifact(surface=13280)))
    b.write_text(json.dumps(_footprint_artifact(surface=14000)))
    fps = history.load_footprints([str(a), str(b)])
    problems = history.check_footprints(fps)
    assert len(problems) == 1 and "13280 -> 14000" in problems[0]
    # equal or shrinking surface passes
    b.write_text(json.dumps(_footprint_artifact(surface=13280)))
    fps = history.load_footprints([str(a), str(b)])
    assert history.check_footprints(fps) == []
    # one artifact has no trajectory, but still fails past its own budget
    only = history.load_footprints([str(a)])
    assert history.check_footprints(only) == []
    a.write_text(json.dumps(_footprint_artifact(surface=20000)))
    assert "pinned budget" in history.check_footprints(
        history.load_footprints([str(a)]))[0]


def test_bench_report_cli_gates_footprint_growth(tmp_path):
    bench = _write_series(tmp_path, [60.0, 65.0, 70.0])
    (tmp_path / "footprint_r08.json").write_text(
        json.dumps(_footprint_artifact()))
    (tmp_path / "footprint_r09.json").write_text(
        json.dumps(_footprint_artifact(surface=14000)))
    paths = bench + [str(tmp_path / "footprint_r08.json"),
                     str(tmp_path / "footprint_r09.json")]
    res = _run_report("--check", *paths)
    assert res.returncode == 1
    assert "executable surface grew" in res.stderr
    assert "fcheck-footprint trend" in res.stdout
