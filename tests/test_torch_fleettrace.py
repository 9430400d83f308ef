"""The port's fctrace (obs/fleettrace.py and the router's trace path),
against the reference's.

* The reference's own fleettrace tests (``tests/test_fleettrace.py``),
  run against the port's modules: the exact fleet merge, down replicas
  and summed SLOs, proxy-overhead attribution, the clock-aligned
  incident merge, the ``render`` CLI with torch and jax poisoned,
  ``collect_bundles``' layout, a trace id across router and a port
  replica, the trace outside the content hash, ``/fleetz`` over a live
  port replica, the typed blocks with torch and jax poisoned, and the
  two ``check_fleet_latency`` tests, against the port's
  ``obs/history.py``.
* ``fleet_latency_block`` (bench.py serve_fleet's
  ``telemetry.fleet_latency`` block, the port's own function): on
  seeded replica and router registries, the merged p95s equal the
  reference's ``merge_snapshots`` on the same histograms, the block
  passes ``check_fleet_latency`` in both packages, and a down replica
  or a histogram missing from the fleet view is a finding.
* Cross-package parity on seeded inputs: ``proxy_overhead``,
  ``aggregate_fleet``, ``merged_timeline`` and ``render_timeline`` give
  equal JSON and text in both packages on the same registries and
  bundle directories.

Tolerance: exact.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from fastconsensus_tpu_torch.obs import fleettrace, latency

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- exact-merge aggregation ----------------------------------------------


def test_three_concurrent_registries_merge_bit_exact():
    regs = [latency.LatencyRegistry() for _ in range(3)]
    combined = latency.LatencyRegistry()
    lock = threading.Lock()
    rngs = [np.random.default_rng(seed) for seed in range(3)]

    def writer(i):
        for k in range(1500):
            v = float(rngs[i].lognormal(mean=-5.0, sigma=2.0))
            bucket = f"n64_e{96 + 32 * (k % 2)}"
            regs[i].hist("serve.e2e", bucket=bucket).record(v)
            with lock:
                combined.hist("serve.e2e", bucket=bucket).record(v)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fz = fleettrace.aggregate_fleet({
        f"r{i}": {"scope": "replica", "latency": regs[i].snapshot(),
                  "fcobs": {"counters": {}}} for i in range(3)})
    assert all(v["ok"] for v in fz["replicas"].values())
    merged = {(h["name"], tuple(sorted(h["tags"].items()))): h
              for h in fz["latency"]["histograms"]}
    ref = {(h["name"], tuple(sorted(h["tags"].items()))): h
           for h in combined.snapshot()["histograms"]}
    assert set(merged) == set(ref) and len(ref) == 2
    for key, want in ref.items():
        got = merged[key]
        assert got["sources"] == 3
        assert got["count"] == want["count"] == 2250
        assert got["buckets"] == want["buckets"]
        assert (got["min_s"], got["max_s"]) == (want["min_s"], want["max_s"])
        for q in ("p50_s", "p95_s", "p99_s"):
            assert got[q] == want[q], (key, q)


def test_aggregate_fleet_reports_down_replicas_and_sums_slo():
    r0 = latency.LatencyRegistry()
    r0.hist("serve.e2e", bucket="b").record(0.01)
    m0 = {"scope": "replica", "latency": dict(
        r0.snapshot(), slo={"interactive": {
            "met": 8, "missed": 2, "attainment": 0.8,
            "target_default_ms": 1000.0}}),
        "fcobs": {"counters": {"serve.jobs": 10, "flag": True}}}
    m1 = {"scope": "replica", "latency": {
        "histograms": [], "slo": {"interactive": {
            "met": 9, "missed": 1, "attainment": 0.9,
            "target_default_ms": 1000.0}}},
        "fcobs": {"counters": {"serve.jobs": 4}}}
    fz = fleettrace.aggregate_fleet({"a": m0, "b": m1, "dead": None})
    assert fz["scope"] == "fleet" and fz["schema"] == fleettrace.SCHEMA
    assert fz["replicas"]["dead"] == {"ok": False}
    assert fz["replicas"]["a"]["ok"] and \
        fz["replicas"]["a"]["scope"] == "replica"
    slo = fz["slo"]["interactive"]
    assert (slo["met"], slo["missed"]) == (17, 3)
    assert slo["attainment"] == pytest.approx(0.85)
    assert slo["target_default_ms"] == 1000.0
    assert fz["counters"]["serve.jobs"] == 14
    assert "flag" not in fz["counters"]


def test_proxy_overhead_attribution_per_replica():
    rl = latency.LatencyRegistry()
    for v in (0.001, 0.002, 0.004):
        rl.hist("router.phase.proxy", replica="r0").record(v)
    rl.hist("router.phase.proxy", replica="r1").record(0.5)
    rl.hist("router.phase.admit").record(0.0001)
    oh = fleettrace.proxy_overhead(rl.snapshot())
    assert set(oh) == {"r0", "r1"}
    assert oh["r0"]["count"] == 3 and oh["r1"]["count"] == 1
    assert oh["r1"]["p95_s"] >= 0.25


# -- incident merge -------------------------------------------------------


def _write_bundle(root, name, anchor_unix, anchor_mono, events,
                  manifest_only_anchor=False, no_anchor=False):
    d = os.path.join(root, name)
    os.makedirs(d)
    manifest = {"pid": 4242}
    flight = {"capacity": 2048, "n_events": len(events), "dropped": 0,
              "rings": [{"thread": "MainThread", "dropped": 0,
                         "events": events}]}
    if not no_anchor:
        if manifest_only_anchor:
            manifest.update(time_unix=anchor_unix, time_mono=anchor_mono)
        else:
            flight.update(time_unix=anchor_unix, time_mono=anchor_mono)
    with open(os.path.join(d, "MANIFEST.json"), "w") as fh:
        json.dump(manifest, fh)
    with open(os.path.join(d, "flight.json"), "w") as fh:
        json.dump(flight, fh)
    return d


def test_merged_timeline_aligns_clocks_dedups_and_filters(tmp_path):
    root = str(tmp_path)
    _write_bundle(root, "r0__fcflight_a", 2000.0, 1000.0, [
        {"ts": 1.0, "kind": "route", "job": "f1", "trace": "tr-1"},
        {"ts": 3.0, "kind": "proxy", "job": "f1", "trace": "tr-1"}])
    _write_bundle(root, "r0__fcflight_b", 2000.0, 1000.0, [
        {"ts": 1.0, "kind": "route", "job": "f1", "trace": "tr-1"}])
    _write_bundle(root, "r1__fcflight_c", 1500.0, 1000.0, [
        {"ts": 502.0, "kind": "admit", "job": "j1", "trace": "tr-1"},
        {"ts": 502.5, "kind": "admit", "job": "j2", "trace": "tr-2"}],
        manifest_only_anchor=True)
    _write_bundle(root, "r2__fcflight_d", 0.0, 0.0, [
        {"ts": 9.0, "kind": "finish", "job": "zz"}], no_anchor=True)
    tl = fleettrace.merged_timeline(root)
    assert tl["replicas"] == ["r0", "r1"]
    assert tl["skipped_bundles"] == ["r2__fcflight_d"]
    assert tl["n_events"] == 4
    walls = [e["t_wall"] for e in tl["events"]]
    assert walls == sorted(walls)
    assert [(e["replica"], e["kind"]) for e in tl["events"]] == [
        ("r0", "route"), ("r1", "admit"), ("r1", "admit"), ("r0", "proxy")]
    one = fleettrace.merged_timeline(root, trace="tr-1")
    assert one["n_events"] == 3
    assert {e["replica"] for e in one["events"]} == {"r0", "r1"}
    assert all(e["trace"] == "tr-1" for e in one["events"])
    text = fleettrace.render_timeline(one)
    assert "r0/MainThread: route" in text and "job=j1" in text


def test_fleettrace_cli_renders_with_torch_and_jax_poisoned(tmp_path):
    root = str(tmp_path / "collected")
    os.makedirs(root)
    _write_bundle(root, "r0__fcflight_a", 100.0, 0.0,
                  [{"ts": 1.0, "kind": "route", "job": "f1",
                    "trace": "tr-9"}])
    _write_bundle(root, "r1__fcflight_b", 100.0, 0.0,
                  [{"ts": 2.0, "kind": "finish", "job": "j1",
                    "trace": "tr-9"}])
    code = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['jax'] = None\n"
        "from fastconsensus_tpu_torch.obs import fleettrace\n"
        "rc = fleettrace.main(['render', sys.argv[1], '--json'])\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code, root], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    payload = json.loads(res.stdout)
    assert payload["tool"] == "fctrace-timeline"
    assert payload["replicas"] == ["r0", "r1"]
    assert payload["n_events"] == 2
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    res2 = subprocess.run([sys.executable, "-c", code, empty], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=60)
    assert res2.returncode == 2, res2.stdout + res2.stderr
    # the module's own entry point, as a user runs it
    res3 = subprocess.run(
        [sys.executable, "-m", "fastconsensus_tpu_torch.obs.fleettrace",
         "render", root, "--trace", "tr-9"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=60)
    assert res3.returncode == 0, res3.stderr
    assert "r1/MainThread: finish job=j1" in res3.stdout


def test_collect_bundles_lays_out_replica_tracks(tmp_path):
    from fastconsensus_tpu_torch.serve.fleet import FleetManager

    fleet = FleetManager(str(tmp_path / "fleet"))

    class _Stub:
        def __init__(self, dirs):
            self._dirs = dirs

        def bundles(self):
            return self._dirs

    src = tmp_path / "r0_flight"
    good = _write_bundle(str(src), "fcflight_good", 10.0, 0.0,
                         [{"ts": 0.5, "kind": "admit", "job": "j"}])
    partial = str(src / "fcflight_partial")
    os.makedirs(partial)
    fleet.replicas = {"r0": _Stub([good, partial])}
    dest = str(tmp_path / "collected")
    out = fleet.collect_bundles(dest_dir=dest, snapshot=False)
    assert [os.path.basename(p) for p in out["r0"]] == ["r0__fcflight_good"]
    assert os.path.isfile(os.path.join(dest, "r0__fcflight_good",
                                       "flight.json"))
    assert os.path.isdir(good)
    pairs = fleettrace.discover_bundles(dest)
    assert [(r, os.path.basename(d)) for r, d in pairs] == [
        ("r0", "r0__fcflight_good")]


# -- live trace propagation (router -> port replica) ----------------------


@pytest.fixture
def replica():
    """One loopback port replica with its worker NOT started."""
    from fastconsensus_tpu_torch.serve.server import (ConsensusService,
                                                      ServeConfig,
                                                      make_http_server)
    from fastconsensus_tpu_torch.serve.shaping import ShapingConfig

    svc = ConsensusService(ServeConfig(device="cpu", queue_depth=16,
                                       pin_sizing=False,
                                       shaping=ShapingConfig(shed=False)))
    httpd = make_http_server(svc, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield svc, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.queue.close()


def _submit_body(seed, trace=None):
    payload = {"edges": [[0, 1], [1, 2], [2, 0]], "n_nodes": 8,
               "algorithm": "lpm", "n_p": 2, "max_rounds": 2, "seed": seed}
    if trace is not None:
        payload["trace"] = trace
    return json.dumps(payload).encode("utf-8")


def test_trace_id_spans_router_and_replica(replica):
    from fastconsensus_tpu_torch.obs import flight as obs_flight
    from fastconsensus_tpu_torch.serve.router import FleetRouter

    svc, url = replica
    router = FleetRouter({"r0": url}, poll_s=60.0)
    router.poll_once()
    status, out, _ = router.submit(_submit_body(seed=1))
    assert status == 202, out
    trace = out["trace"]
    assert trace and trace.startswith("tr-")
    job = svc.queue.pop(timeout=5.0)
    assert job.spec.trace == trace
    assert job.describe()["trace"] == trace
    events = obs_flight.get_flight_recorder().events()
    kinds = {e["kind"] for e in events if e.get("trace") == trace}
    assert "route" in kinds and "admit" in kinds
    status, out2, _ = router.submit(_submit_body(seed=2),
                                    trace="tr-client-7")
    assert status == 202 and out2["trace"] == "tr-client-7"
    assert svc.queue.pop(timeout=5.0).spec.trace == "tr-client-7"
    status, out3, _ = router.submit(_submit_body(seed=3, trace="tr-body-8"))
    assert status == 202 and out3["trace"] == "tr-body-8"
    svc.queue.pop(timeout=5.0)


def test_trace_is_outside_the_content_hash(replica):
    from fastconsensus_tpu_torch.serve.client import ServeClient, ServeError

    svc, url = replica
    client = ServeClient(url, timeout=10.0)
    a = client._request("/submit", json.loads(
        _submit_body(seed=5, trace="tr-a").decode()))
    b = client._request("/submit", json.loads(
        _submit_body(seed=5, trace="tr-b").decode()))
    assert a["trace"] == "tr-a" and b["trace"] == "tr-b"
    assert a["content_hash"] == b["content_hash"]
    with pytest.raises(ServeError) as err:
        client._request("/submit", json.loads(
            _submit_body(seed=6, trace="x" * 200).decode()))
    assert err.value.status == 400
    for _ in range(2):
        svc.queue.pop(timeout=5.0)


def test_fleetz_scrapes_live_replica_and_merges_exactly(replica):
    import urllib.request

    from fastconsensus_tpu_torch.serve.router import FleetRouter

    svc, url = replica
    router = FleetRouter({"r0": url}, poll_s=60.0)
    router.poll_once()
    for seed in range(3):
        status, _, _ = router.submit(_submit_body(seed=seed + 10))
        assert status == 202
        svc.queue.pop(timeout=5.0)
    with urllib.request.urlopen(url + "/metricsz", timeout=10.0) as r:
        replica_m = json.loads(r.read())
    assert replica_m["scope"] == "replica"
    fz = router.fleetz()
    assert fz["scope"] == "fleet"
    assert fz["replicas"]["r0"]["ok"]
    assert fz["replicas"]["r0"]["scope"] == "replica"

    def counts(hists):
        return {(h["name"], tuple(sorted(
            (str(k), str(v)) for k, v in (h.get("tags") or {}).items()))):
            h["count"] for h in hists}

    assert counts(fz["latency"]["histograms"]) == counts(
        (replica_m.get("latency") or {}).get("histograms", ()))
    router_hists = {h["name"] for h in fz["router"]["latency"]["histograms"]}
    assert "router.phase.admit" in router_hists
    assert "router.phase.ring_lookup" in router_hists
    with urllib.request.urlopen(url + "/debugz/flight", timeout=10.0) as r:
        fl = json.loads(r.read())
    assert fl["scope"] == "replica"
    assert fl["flight"].get("time_unix") is not None
    assert fl["flight"].get("time_mono") is not None


def test_typed_fleet_blocks_parse_with_torch_and_jax_poisoned():
    canned_fleetz = {
        "schema": 1, "tool": "fctrace-fleetz", "scope": "fleet",
        "replicas": {"r0": {"ok": True, "scope": "replica",
                            "histograms": 2, "slo": {}},
                     "r1": {"ok": False}},
        "latency": {"histograms": [
            {"name": "serve.e2e", "tags": {"bucket": "n64_e96"},
             "sources": 2, "count": 10, "sum_s": 0.5, "min_s": 0.01,
             "max_s": 0.2, "p50_s": 0.03125, "p95_s": 0.25,
             "p99_s": 0.25, "buckets": {"-5": 10}}]},
        "slo": {"interactive": {"met": 9, "missed": 1, "attainment": 0.9,
                                "target_default_ms": 1000.0}},
        "counters": {"serve.jobs": 10},
        "router": {
            "latency": {"histograms": [
                {"name": "router.phase.admit", "tags": {}, "count": 10,
                 "sum_s": 0.001, "min_s": 0.0001, "max_s": 0.0002,
                 "p50_s": 0.0001, "p95_s": 0.0002, "p99_s": 0.0002,
                 "buckets": {"-13": 10}}]},
            "proxy_overhead": {"r0": {"count": 10, "sum_s": 0.02,
                                      "p50_s": 0.001, "p95_s": 0.003}}}}
    canned_timeline = {
        "schema": 1, "tool": "fctrace-timeline", "trace": "tr-1",
        "replicas": ["r0", "r1"], "n_events": 2,
        "events_per_replica": {"r0": 1, "r1": 1},
        "skipped_bundles": ["r2__fcflight_x"],
        "events": [
            {"t_wall": 1001.0, "replica": "r0", "thread": "t", "ts": 1.0,
             "kind": "route", "job": "f1", "trace": "tr-1"},
            {"t_wall": 1002.0, "replica": "r1", "thread": "t", "ts": 2.0,
             "kind": "admit", "job": "j1", "trace": "tr-1"}]}
    code = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['jax'] = None\n"
        "import json\n"
        "from fastconsensus_tpu_torch.serve.client import (FleetLatency,\n"
        "    TraceTimeline)\n"
        f"fz = json.loads({json.dumps(json.dumps(canned_fleetz))})\n"
        f"tl = json.loads({json.dumps(json.dumps(canned_timeline))})\n"
        "f = FleetLatency.from_payload(fz)\n"
        "assert f.scope == 'fleet'\n"
        "assert f.replicas_ok == {'r0': True, 'r1': False}\n"
        "assert f.replicas_down == ('r1',)\n"
        "h = f.histogram('serve.e2e', bucket='n64_e96')\n"
        "assert h is not None and h.count == 10\n"
        "assert f.histogram('serve.e2e', bucket='nope') is None\n"
        "assert f.slo[0].met == 9 and f.counters['serve.jobs'] == 10\n"
        "assert f.router_histograms[0].name == 'router.phase.admit'\n"
        "assert f.proxy_overhead['r0']['p95_s'] == 0.003\n"
        "t = TraceTimeline.from_payload(tl)\n"
        "assert t.trace == 'tr-1' and t.n_events == 2\n"
        "assert t.replicas == ('r0', 'r1')\n"
        "assert t.skipped_bundles == ('r2__fcflight_x',)\n"
        "assert [e['kind'] for e in t.for_replica('r1')] == ['admit']\n"
        "print('torch-free fleet parse ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "torch-free fleet parse ok" in res.stdout


# -- parity with the reference on seeded inputs ---------------------------


def _registries(seed, n_replicas=3):
    """Seeded latency snapshots of ``n_replicas`` replicas and a router,
    recorded through the port's registry (a plain data payload)."""
    rng = np.random.default_rng(seed)
    replicas = {}
    for i in range(n_replicas):
        reg = latency.LatencyRegistry()
        for _ in range(int(rng.integers(50, 400))):
            reg.hist("serve.e2e", bucket=f"n{64 * 2 ** int(rng.integers(3))}"
                     f"_e96").record(float(rng.lognormal(-4.0, 1.5)))
            reg.hist("serve.phase.device").record(
                float(rng.lognormal(-5.0, 1.0)))
        met, missed = (int(x) for x in rng.integers(0, 50, 2))
        snap = dict(reg.snapshot(), slo={
            "interactive": {"met": met, "missed": missed,
                            "attainment": met / max(met + missed, 1),
                            "target_default_ms": 1000.0},
            "batch": {"met": int(rng.integers(0, 9)), "missed": 0}})
        replicas[f"r{i}"] = {
            "scope": "replica", "latency": snap,
            "fcobs": {"counters": {"serve.jobs": int(rng.integers(100)),
                                   "serve.cache.hits": float(
                                       rng.integers(10)),
                                   "flag": bool(i % 2)}}}
    replicas["down"] = None
    router = latency.LatencyRegistry()
    for _ in range(200):
        router.hist("router.phase.proxy",
                    replica=f"r{int(rng.integers(n_replicas))}").record(
            float(rng.lognormal(-7.0, 1.0)))
        router.hist("router.phase.admit").record(
            float(rng.lognormal(-9.0, 0.5)))
    return replicas, router.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregation_equals_the_reference(seed):
    from fastconsensus_tpu.obs import fleettrace as ref

    replicas, router = _registries(seed)
    fleet = {"replicas": [{"name": "r0", "state": "up"}], "counters": {}}
    assert ref.proxy_overhead(router) == fleettrace.proxy_overhead(router)
    a = ref.aggregate_fleet(replicas, router_latency=router,
                            router_fleet=fleet)
    b = fleettrace.aggregate_fleet(replicas, router_latency=router,
                                   router_fleet=fleet)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert b["replicas"]["down"] == {"ok": False}
    assert len(b["latency"]["histograms"]) >= 2


def _random_bundles(root, seed):
    """Seeded collected-bundle tree: replicas with two snapshots of one
    ring (duplicates), distinct clock anchors, manifest-only anchors, an
    anchor-less bundle and a partial dump."""
    rng = np.random.default_rng(seed)
    traces = [f"tr-{i}" for i in range(4)]
    for r in range(3):
        anchor = float(rng.uniform(1e9, 1e9 + 1e4))
        mono = float(rng.uniform(0, 1e4))
        events = [{"ts": mono + float(rng.uniform(0, 30)),
                   "kind": ("route", "admit", "dispatch", "finish")[
                       int(rng.integers(4))],
                   "job": f"j{int(rng.integers(20))}",
                   "trace": traces[int(rng.integers(4))],
                   "bucket": "n64_e96"} for _ in range(40)]
        _write_bundle(root, f"r{r}__fcflight_{r}_a", anchor, mono, events,
                      manifest_only_anchor=r == 2)
        _write_bundle(root, f"r{r}__fcflight_{r}_b", anchor, mono,
                      events[:15])
    _write_bundle(root, "r9__fcflight_x", 0.0, 0.0,
                  [{"ts": 1.0, "kind": "finish", "job": "z"}],
                  no_anchor=True)
    os.makedirs(os.path.join(root, "r8__fcflight_partial"))
    return traces


@pytest.mark.parametrize("seed", [0, 1])
def test_incident_merge_equals_the_reference(tmp_path, seed):
    from fastconsensus_tpu.obs import fleettrace as ref

    root = str(tmp_path)
    traces = _random_bundles(root, seed)
    assert ref.discover_bundles(root) == fleettrace.discover_bundles(root)
    for _, d in fleettrace.discover_bundles(root):
        assert ref.clock_anchor(d) == fleettrace.clock_anchor(d)
    for trace in [None] + traces:
        a = ref.merged_timeline(root, trace=trace)
        b = fleettrace.merged_timeline(root, trace=trace)
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
        for tail in (None, 5):
            assert ref.render_timeline(a, tail=tail) == \
                fleettrace.render_timeline(b, tail=tail)
    full = fleettrace.merged_timeline(root)
    assert full["replicas"] == ["r0", "r1", "r2"]
    assert full["skipped_bundles"] == ["r9__fcflight_x"]
    assert full["n_events"] == 120    # the second snapshots deduplicated


# -- the fctrace gate (obs/history.py check_fleet_latency) ---------------


def _fl_rec(seq, fl):
    return {"seq": seq, "source": f"bench_serve_fleet_r{seq}.json",
            "fleet_latency": fl}


def _healthy_fl(**over):
    fl = {"replicas_scraped": 3, "replicas_down": [],
          "merge_exact": True,
          "router_phase_p95_ms": {"admit": 0.05, "ring_lookup": 0.01,
                                  "proxy": 2.0, "replay": None},
          "proxy_overhead_p95_ms": {"r0": 2.0, "r1": 2.5},
          "fleet_e2e_p95_ms": 40.0,
          "worst_replica_e2e_p95_ms": 45.0}
    fl.update(over)
    return fl


def test_check_fleet_latency_absolute_rules():
    from fastconsensus_tpu_torch.obs import history

    clean = {"c": [_fl_rec(18, _healthy_fl())]}
    assert history.check_fleet_latency(clean) == []

    down = {"c": [_fl_rec(18, _healthy_fl(replicas_down=["r2"]))]}
    assert any("could not scrape" in p
               for p in history.check_fleet_latency(down))

    inexact = {"c": [_fl_rec(18, _healthy_fl(merge_exact=False))]}
    assert any("inexact" in p
               for p in history.check_fleet_latency(inexact))

    # merged fleet p95 above the worst component: impossible for a
    # correct mixture quantile, so the gate calls the merge wrong
    broken = {"c": [_fl_rec(18, _healthy_fl(
        fleet_e2e_p95_ms=80.0, worst_replica_e2e_p95_ms=45.0))]}
    assert any("mixture quantile" in p
               for p in history.check_fleet_latency(broken))

    # pre-fctrace artifacts pass vacuously
    assert history.check_fleet_latency(
        {"c": [{"seq": 17, "source": "s", "fleet_latency": None}]}) == []


def test_check_fleet_latency_trajectory_rules():
    from fastconsensus_tpu_torch.obs import history

    hist = [_fl_rec(16, _healthy_fl()), _fl_rec(17, _healthy_fl())]
    ok = {"c": hist + [_fl_rec(18, _healthy_fl(
        fleet_e2e_p95_ms=60.0, worst_replica_e2e_p95_ms=62.0))]}
    assert history.check_fleet_latency(ok) == []

    # e2e p95 more than doubles the prior median: finding
    slow = {"c": hist + [_fl_rec(18, _healthy_fl(
        fleet_e2e_p95_ms=90.0, worst_replica_e2e_p95_ms=95.0))]}
    assert any("tail regressed" in p
               for p in history.check_fleet_latency(slow))

    # worst-replica proxy overhead grows past its own bound: finding
    hop = {"c": hist + [_fl_rec(18, _healthy_fl(
        proxy_overhead_p95_ms={"r0": 2.0, "r1": 9.0}))]}
    assert any("proxy overhead" in p
               for p in history.check_fleet_latency(hop))

    # only the NEWEST sequence is judged: an old bad record is history
    old_bad = {"c": [_fl_rec(16, _healthy_fl(merge_exact=False)),
                     _fl_rec(18, _healthy_fl())]}
    assert history.check_fleet_latency(old_bad) == []


def _seeded_fleet(seed):
    """Three replica registries and a router registry with seeded
    lognormal samples: the replicas' ``/metricsz`` latency blocks and the
    ``/fleetz`` payload over them."""
    rng = np.random.default_rng(seed)
    regs = {f"r{i}": latency.LatencyRegistry() for i in range(3)}
    router = latency.LatencyRegistry()
    for name, reg in regs.items():
        scale = float(rng.uniform(-4.0, -2.0))
        for k in range(300):
            reg.hist("serve.e2e", bucket=f"n64_e{96 + 32 * (k % 2)}") \
                .record(float(rng.lognormal(scale, 1.0)))
            reg.hist("serve.phase.device").record(
                float(rng.lognormal(scale - 1.0, 0.5)))
            router.hist("router.phase.proxy", replica=name).record(
                float(rng.lognormal(-6.0, 0.4)))
    for ph in ("admit", "ring_lookup"):
        for _ in range(200):
            router.hist(f"router.phase.{ph}").record(
                float(rng.lognormal(-9.0, 0.3)))
    metrics = {n: {"scope": "replica", "latency": r.snapshot(),
                   "fcobs": {"counters": {}}} for n, r in regs.items()}
    fz = fleettrace.aggregate_fleet(metrics,
                                    router_latency=router.snapshot())
    hists = {n: m["latency"]["histograms"] for n, m in metrics.items()}
    return fz, hists


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_latency_block_passes_both_gates(seed):
    from fastconsensus_tpu.obs import history as jhist
    from fastconsensus_tpu.obs import latency as jlat
    from fastconsensus_tpu_torch.obs import history

    fz, hists = _seeded_fleet(seed)
    block = fleettrace.fleet_latency_block(fz, hists)
    assert block["replicas_scraped"] == 3 and block["replicas_down"] == []
    assert block["merge_exact"] is True

    def p95_ms(rows):
        return round(jlat.merge_snapshots(rows)["p95_s"] * 1000.0, 3)

    e2e = [h for hs in hists.values() for h in hs if h["name"] == "serve.e2e"]
    assert block["fleet_e2e_p95_ms"] == p95_ms(e2e)
    assert block["worst_replica_e2e_p95_ms"] == max(
        p95_ms([h for h in hs if h["name"] == "serve.e2e"])
        for hs in hists.values())
    assert block["fleet_e2e_p95_ms"] <= block["worst_replica_e2e_p95_ms"]
    router = fz["router"]["latency"]["histograms"]
    assert block["router_phase_p95_ms"] == {
        "admit": p95_ms([h for h in router
                         if h["name"] == "router.phase.admit"]),
        "ring_lookup": p95_ms([h for h in router
                               if h["name"] == "router.phase.ring_lookup"]),
        "proxy": p95_ms([h for h in router
                         if h["name"] == "router.phase.proxy"]),
        "replay": None}
    assert sorted(block["proxy_overhead_p95_ms"]) == ["r0", "r1", "r2"]
    groups = {"fleet": [{"seq": 1, "source": "chip_smoke",
                         "fleet_latency": block}]}
    assert history.check_fleet_latency(groups) == \
        jhist.check_fleet_latency(groups) == []


def test_fleet_latency_block_names_a_down_replica_and_an_inexact_merge():
    from fastconsensus_tpu_torch.obs import history

    fz, hists = _seeded_fleet(3)
    metrics = {n: {"latency": {"histograms": hs}} for n, hs in hists.items()}
    metrics["r3"] = None
    down = fleettrace.aggregate_fleet(metrics)
    block = fleettrace.fleet_latency_block(down, hists)
    assert block["replicas_down"] == ["r3"]
    probs = history.check_fleet_latency(
        {"c": [{"seq": 1, "source": "s", "fleet_latency": block}]})
    assert any("could not scrape r3" in p for p in probs)
    # a replica's histograms that the fleet view lacks: inexact
    extra = dict(hists, r9=hists["r0"])
    block = fleettrace.fleet_latency_block(fz, extra)
    assert block["merge_exact"] is False
    probs = history.check_fleet_latency(
        {"c": [{"seq": 1, "source": "s", "fleet_latency": block}]})
    assert any("inexact" in p for p in probs)
