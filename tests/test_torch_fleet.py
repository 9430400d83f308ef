"""The port's fleet tier (serve/router.py, serve/fleet.py, the fleet half
of serve/client.py, analysis/footprint.py), against the reference's.

* The reference's own fleet tests (``tests/test_fleet.py``), run against
  the port's modules: the ring's join, exclusion, preview and
  cross-process determinism, ``route_key`` against the port's bucketer,
  torch- and jax-free imports, the client's retry, the cache-spill pins,
  EDF order and cordon routing through a router over a port replica.
* Cross-package parity on seeded inputs: ``route_key`` on 200 payloads,
  ``HashRing`` owners and moves on 2,000 keys, the ladder geometry
  (one definition, which ``sizing`` and the bucketer import) against the
  reference's two copies, the typed fleet views on canned and live payloads,
  and each package's ``FleetRouter`` in front of the same two stub
  replicas under one scripted sequence (up, one shedding, all shedding,
  one dead): the same replica for every submission, the same 429, the
  same ``serve.fleet.*`` counters.
* A mixed fleet: the port's router over one port replica and one
  reference replica; a karate job served by each in turn gives
  identical partitions (the two packages speak one wire).
* ``FleetManager`` on real port replicas (``--device cpu``): a SIGKILL,
  ``on_death`` and a resubmit answered from the inherited cache; and
  ``python -m fastconsensus_tpu_torch.serve.fleet`` up and drained on
  SIGTERM.

Tolerance: exact.
"""

import dataclasses
import hashlib
import json
import math
import os
import random
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(REPO, "fastconsensus_tpu_torch")
KARATE = os.path.join(REPO, "examples", "karate_club.txt")


def _keys(n):
    return [f"bucket-{i:04d}" for i in range(n)]


# -- HashRing (the reference's tests, on the port) ----------------------


def test_ring_join_moves_at_most_a_fair_share():
    from fastconsensus_tpu_torch.serve.router import DEFAULT_VNODES, HashRing

    members = ("r0", "r1", "r2")
    for n_keys in (120, 200, 256):
        keys = _keys(n_keys)
        ring = HashRing(members, vnodes=DEFAULT_VNODES)
        before = {k: ring.route(k) for k in keys}
        ring.add("r3")
        after = {k: ring.route(k) for k in keys}
        moved = {k for k in keys if before[k] != after[k]}
        assert len(moved) <= math.ceil(n_keys / (len(members) + 1))
        assert all(after[k] == "r3" for k in moved)


def test_ring_exclusion_rehomes_minimally_and_is_reversible():
    from fastconsensus_tpu_torch.serve.router import (HashRing,
                                                      NoEligibleReplica)

    ring = HashRing(("a", "b", "c"))
    keys = _keys(150)
    before = {k: ring.route(k) for k in keys}
    excluded = frozenset({"b"})
    for k in keys:
        owner = ring.route(k, excluded)
        assert owner != "b"
        if before[k] != "b":
            assert owner == before[k]
    assert all(ring.route(k) == before[k] for k in keys)
    with pytest.raises(NoEligibleReplica):
        ring.route("anything", frozenset({"a", "b", "c"}))


def test_ring_preview_owner_names_the_donor():
    from fastconsensus_tpu_torch.serve.router import HashRing

    ring = HashRing(("a", "b", "c"))
    keys = _keys(200)
    before = {k: ring.route(k) for k in keys}
    trial = HashRing(("a", "b", "c", "d"), vnodes=ring.vnodes)
    for k in keys:
        donor = ring.preview_owner(k, "d")
        assert donor == (before[k] if trial.route(k) == "d" else None)


def test_ring_placement_is_cross_process_deterministic():
    """Another process, another PYTHONHASHSEED, torch and jax poisoned:
    the same placements."""
    from fastconsensus_tpu_torch.serve.router import HashRing

    members = ("r0", "r1", "r2", "r3")
    keys = _keys(64)
    local = [HashRing(members).route(k) for k in keys]
    code = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['jax'] = None\n"
        "from fastconsensus_tpu_torch.serve.router import HashRing\n"
        f"ring = HashRing({members!r})\n"
        f"print(';'.join(ring.route(k) for k in {keys!r}))\n")
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED="77")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().split(";") == local


# -- route_key ------------------------------------------------------------


def test_route_key_matches_bucketer_grid_and_ignores_seed():
    from fastconsensus_tpu_torch.serve import bucketer
    from fastconsensus_tpu_torch.serve.router import route_key

    for n_nodes, n_edges in ((34, 78), (64, 96), (100, 500), (65, 193)):
        payload = {"edges": [[0, 1]] * n_edges, "n_nodes": n_nodes,
                   "algorithm": "louvain", "n_p": 4, "seed": 1}
        b = bucketer.bucket_for(n_nodes, n_edges)
        assert route_key(payload).startswith(b.key() + "|")
        assert route_key(payload) == route_key(dict(payload, seed=99))
    base = {"edges": [[0, 1]] * 64, "n_nodes": 34, "n_p": 4}
    assert route_key(base) != route_key(dict(base, n_p=8))
    assert route_key(base) != route_key(dict(base, tau=0.3))
    el = "# header\n0 1\n1 2\n\n2 3\n"
    assert route_key({"edgelist": el, "n_nodes": 34}) == \
        route_key({"edges": [[0, 1]] * 3, "n_nodes": 34})


def _boundary(rng):
    """A count on either side of a grid boundary 2^k or 3*2^k."""
    k = int(rng.integers(3, 14))
    b = 2 ** k if rng.random() < 0.5 else 3 * 2 ** (k - 1)
    return max(1, b + int(rng.integers(-1, 2)))


_CONFIG_VALUES = {
    "algorithm": ["louvain", "leiden", "lpm", "cnm", "infomap"],
    "n_p": [4, 8, 20, 50], "tau": [0.2, 0.3, 0.7], "delta": [0.02, 0.1],
    "max_rounds": [2, 16, 64], "gamma": [0.5, 1.0, 2.0],
    "auto_grow": [True, False], "warm_start": [True, False],
    "align_frac": [0.0, 0.5], "closure_sampler": ["sort", "scatter"],
    "closure_tau": [0.2, None]}


def _payloads(seed, n=200):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = ("edges", "edgelist", "parent")[i % 3]
        p = {}
        for field, values in _CONFIG_VALUES.items():
            if rng.random() < 0.4:
                p[field] = values[int(rng.integers(len(values)))]
        p["seed"] = int(rng.integers(1000))
        if rng.random() < 0.3:
            p["priority"] = int(rng.integers(3))
        if kind == "parent":
            p["parent"] = hashlib.sha1(str(i).encode()).hexdigest()[:24]
            p["adds"] = [[0, 1]]
            out.append(p)
            continue
        n_nodes, n_edges = _boundary(rng), _boundary(rng)
        p["n_nodes"] = n_nodes
        if kind == "edges":
            p["edges"] = [[0, 1]] * n_edges
        else:
            lines = ["# a comment"]
            for j in range(n_edges):
                lines.append("0 1")
                if j % 97 == 0:
                    lines += ["", "   # indented comment", "  "]
            p["edgelist"] = "\n".join(lines) + "\n"
        out.append((p, n_nodes, n_edges))
    return out


def test_route_key_equals_the_reference_on_seeded_payloads():
    from fastconsensus_tpu.serve import router as ref_router
    from fastconsensus_tpu_torch.serve import bucketer
    from fastconsensus_tpu_torch.serve import router as port_router

    kinds = set()
    for item in _payloads(seed=8):
        if isinstance(item, dict):
            key = port_router.route_key(item)
            assert key == f"delta|{item['parent']}"
            kinds.add("parent")
        else:
            p, n_nodes, n_edges = item
            key = port_router.route_key(p)
            prefix = bucketer.bucket_for(n_nodes, n_edges).key()
            assert key.split("|", 1)[0] == prefix, (key, n_nodes, n_edges)
            assert key == port_router.route_key(dict(p, seed=p["seed"] + 1))
            kinds.add("edgelist" if "edgelist" in p else "edges")
            item = p
        assert key == ref_router.route_key(item)
    assert kinds == {"edges", "edgelist", "parent"}


def test_hash_ring_equals_the_reference():
    """The same members and vnodes give the same owner for 2,000 keys,
    and the same moves on a join, an exclusion and its lifting."""
    from fastconsensus_tpu.serve import router as ref_router
    from fastconsensus_tpu_torch.serve import router as port_router

    rng = np.random.default_rng(3)
    keys = [f"n{int(rng.integers(64, 10 ** 6))}"
            f"_e{int(rng.integers(64, 10 ** 7))}"
            f"|n_p={int(rng.integers(1, 200))}" for _ in range(2000)]
    for members, vnodes in ((("r0", "r1"), 128), (("a", "b", "c"), 16),
                            (("r0", "r1", "r2", "r3", "r4"), 128)):
        seen = []
        for mod in (ref_router, port_router):
            ring = mod.HashRing(members, vnodes=vnodes)
            owners = [ring.route(k) for k in keys]
            excl = frozenset(members[1:2])
            cordoned = [ring.route(k, excl) for k in keys]
            lifted = [ring.route(k) for k in keys]
            donors = [ring.preview_owner(k, "new") for k in keys]
            ring.add("new")
            joined = [ring.route(k) for k in keys]
            moves = {
                "cordon": [i for i, (a, b) in enumerate(zip(owners, cordoned))
                           if a != b],
                "uncordon": [i for i, (a, b) in enumerate(zip(cordoned,
                                                              lifted))
                             if a != b],
                "join": [i for i, (a, b) in enumerate(zip(owners, joined))
                         if a != b]}
            assert lifted == owners
            assert 0 < len(moves["join"]) < len(keys)
            assert moves["uncordon"] == moves["cordon"]
            seen.append((owners, cordoned, donors, joined, moves))
        assert seen[0] == seen[1]


def test_grid_mirror_equals_the_ports_sizing():
    """One definition of the ladder geometry: sizing, the bucketer and
    the Louvain path flip take footprint's own objects, and its grid
    equals both of the reference's copies over a seeded sample."""
    from fastconsensus_tpu.analysis import footprint as jfootprint
    from fastconsensus_tpu.sizing import grid_up as jgrid_up
    from fastconsensus_tpu_torch import sizing
    from fastconsensus_tpu_torch.analysis import cost, footprint
    from fastconsensus_tpu_torch.models import louvain
    from fastconsensus_tpu_torch.serve import bucketer

    assert sizing.grid_up is footprint.grid_up
    assert bucketer.MIN_NODE_CLASS is footprint.MIN_NODE_CLASS
    assert bucketer.MIN_EDGE_CLASS is footprint.MIN_EDGE_CLASS
    assert bucketer.BATCH_LADDER is footprint.BATCH_RUNGS
    assert louvain.MATMUL_MAX_N is footprint.MATMUL_MAX_N
    assert cost.MATMUL_MAX_N is footprint.MATMUL_MAX_N
    rng = np.random.default_rng(11)
    sample = np.concatenate([rng.integers(0, 10 ** 6, 4000),
                             np.arange(0, 300)])
    for n in sample.tolist():
        for minimum in (1, 64):
            want = footprint.grid_up(n, minimum)
            assert want == jgrid_up(n, minimum) == jfootprint.grid_up(
                n, minimum), (n, minimum)
    assert (footprint.MIN_NODE_CLASS, footprint.MIN_EDGE_CLASS,
            footprint.BATCH_RUNGS, footprint.MATMUL_MAX_N) == (
        jfootprint.MIN_NODE_CLASS, jfootprint.MIN_EDGE_CLASS,
        jfootprint.BATCH_RUNGS, jfootprint.MATMUL_MAX_N)
    vals = footprint.grid_values(64, 10 ** 6)
    assert vals == jfootprint.grid_values(64, 10 ** 6)
    assert all(footprint.grid_up(v + 1) in vals for v in vals[:-1])


# -- torch- and jax-free tier ---------------------------------------------


_IMPORT_LINE = re.compile(r"^\s*(from|import)\s+fastconsensus_tpu(\W|$)")


def test_fleet_tier_imports_with_torch_and_jax_poisoned():
    code = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['jax'] = None\n"
        "from fastconsensus_tpu_torch.serve.router import (\n"
        "    FleetRouter, HashRing, route_key)\n"
        "from fastconsensus_tpu_torch.serve.fleet import FleetManager\n"
        "from fastconsensus_tpu_torch.serve import FleetManager as FM\n"
        "from fastconsensus_tpu_torch.serve.client import (\n"
        "    FleetLatency, FleetStats, ReplicaState, TraceTimeline)\n"
        "from fastconsensus_tpu_torch.obs import fleettrace\n"
        "from fastconsensus_tpu_torch.analysis import footprint\n"
        "assert FM is FleetManager\n"
        "fs = FleetStats.from_payload({\n"
        "    'replicas': [\n"
        "        {'name': 'a', 'url': 'http://h:1', 'state': 'up',\n"
        "         'queue_depth': 3, 'queue_max_depth': 64,\n"
        "         'watchdog_trips': 0},\n"
        "        {'name': 'b', 'url': 'http://h:2',\n"
        "         'state': 'cordoned', 'cordon_reason': 'trip',\n"
        "         'retry_after_hint_s': 1.5}],\n"
        "    'ring': {'members': ['a', 'b'], 'vnodes': 128},\n"
        "    'assignments': {'n64_e96|': 'a'},\n"
        "    'jobs_tracked': 7, 'jobs_in_flight': 2,\n"
        "    'content_hash_index': 5,\n"
        "    'counters': {'serve.fleet.cordons': 1}})\n"
        "assert [r.name for r in fs.up] == ['a']\n"
        "assert fs.replicas[1].cordoned\n"
        "assert fs.replicas[1].retry_after_hint_s == 1.5\n"
        "assert fs.ring_members == ('a', 'b') and fs.vnodes == 128\n"
        "assert fs.counters['serve.fleet.cordons'] == 1\n"
        "assert footprint.grid_up(65, 64) == 96\n"
        "print('fleet torch-free ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "fleet torch-free ok" in res.stdout


def test_no_port_module_imports_the_reference():
    offenders = []
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT_PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path, encoding="utf-8") as fh:
            for lineno, line in enumerate(fh, 1):
                if _IMPORT_LINE.match(line):
                    offenders.append(f"{path}:{lineno}: {line.strip()}")
    assert len(files) > 60
    assert not offenders, offenders


# -- ServeClient.retry --------------------------------------------------


def test_client_retry_honors_typed_hint_with_backoff_and_jitter():
    from fastconsensus_tpu_torch.serve.client import Backpressure, ServeClient

    client = ServeClient("http://127.0.0.1:1")   # never dialed
    sleeps = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise Backpressure(429, {"backpressure": True},
                               retry_after_s=2.0)
        return "served"

    out = client.retry(flaky, attempts=4, backoff=1.5, jitter_frac=0.1,
                       sleep=sleeps.append, rng=random.Random(7))
    assert out == "served" and calls["n"] == 3
    assert len(sleeps) == 2
    for attempt, s in enumerate(sleeps):
        base = 2.0 * (1.5 ** attempt)
        assert base <= s <= base * 1.1

    def always_shedding():
        raise Backpressure(429, {"backpressure": True, "shed": True},
                           retry_after_s=0.5)

    sleeps.clear()
    with pytest.raises(Backpressure):
        client.retry(always_shedding, attempts=3, sleep=sleeps.append,
                     rng=random.Random(7))
    assert len(sleeps) == 2
    with pytest.raises(ValueError):
        client.retry(flaky, attempts=0)
    with pytest.raises(ValueError):
        client.retry(flaky, backoff=0.5)


# -- ResultCache persistence pins ---------------------------------------


def _cacheable(seed):
    return {"partitions": [np.full(8, seed, dtype=np.int32)],
            "n_nodes": 8, "seed": seed}


def test_cache_spill_if_dirty_skips_clean_and_concurrent(tmp_path):
    from fastconsensus_tpu_torch.obs import counters as obs_counters
    from fastconsensus_tpu_torch.serve.cache import ResultCache

    path = str(tmp_path / "spill.npz")
    c = ResultCache(max_entries=8, ttl_seconds=600.0)
    c.put("h1", _cacheable(1))
    assert c.spill_if_dirty(path) == 1
    mtime = os.path.getmtime(path)
    assert c.spill_if_dirty(path) == 0
    assert os.path.getmtime(path) == mtime
    c.put("h2", _cacheable(2))
    base = obs_counters.get_registry().counters()
    assert c._spill_lock.acquire(blocking=False)
    try:
        assert c.spill_if_dirty(path) == -1
    finally:
        c._spill_lock.release()
    since = obs_counters.get_registry().counters_since(base)
    assert since.get("serve.cache.persist_concurrent_skip", 0) == 1
    assert c.spill_if_dirty(path) == 2
    heir = ResultCache(max_entries=8, ttl_seconds=600.0)
    assert heir.load(path) == 2
    assert heir.spill_if_dirty(str(tmp_path / "re.npz")) == 2


# -- the router over a live port replica ----------------------------------


def _serve(svc, make_http_server):
    httpd = make_http_server(svc, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture
def replica():
    """One loopback port replica with its worker NOT started, so queue
    contents are observable and deterministic."""
    from fastconsensus_tpu_torch.serve.server import (ConsensusService,
                                                      ServeConfig,
                                                      make_http_server)
    from fastconsensus_tpu_torch.serve.shaping import ShapingConfig

    svc = ConsensusService(ServeConfig(device="cpu", queue_depth=16,
                                       pin_sizing=False,
                                       shaping=ShapingConfig(shed=False)))
    httpd, url = _serve(svc, make_http_server)
    try:
        yield svc, url
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.queue.close()


def test_router_forwarding_preserves_edf_order(replica):
    from fastconsensus_tpu_torch.serve.jobs import (PRIORITY_BATCH,
                                                    PRIORITY_INTERACTIVE,
                                                    PRIORITY_NORMAL)
    from fastconsensus_tpu_torch.serve.router import FleetRouter

    svc, url = replica
    router = FleetRouter({"r0": url}, poll_s=60.0)
    router.poll_once()
    edges = [[i, (i + 1) % 12] for i in range(12)]
    submitted = []
    for seed, prio in enumerate((PRIORITY_BATCH, PRIORITY_NORMAL,
                                 PRIORITY_INTERACTIVE)):
        body = json.dumps({"edges": edges, "n_nodes": 12, "algorithm": "lpm",
                           "n_p": 2, "max_rounds": 2, "seed": seed,
                           "priority": prio}).encode("utf-8")
        status, out, _ = router.submit(body)
        assert status == 202, out
        assert out["fleet_replica"] == "r0"
        submitted.append((prio, out["job_id"]))
    pops = [svc.queue.pop(timeout=5.0) for _ in submitted]
    assert [j.spec.priority for j in pops] == sorted(p for p, _ in submitted)
    stats = router.fleet_stats()
    assert stats["jobs_tracked"] == 3
    assert set(stats["assignments"].values()) == {"r0"}


def test_metricsz_kernel_counts_survive_a_job_adding_shapes(replica,
                                                            monkeypatch):
    """/metricsz reads the launch counters while a worker may add a new
    row_totals shape; here every read of the key adds one, as a job
    landing mid-read would, and the endpoint still answers."""
    from collections import Counter

    from fastconsensus_tpu_torch.ops import row_kernels as rk

    shapes = Counter()

    class ShapeAddedMidRead(tuple):
        def __iter__(self):
            shapes[(len(shapes) + 1000, 8)] += 1
            return super().__iter__()

    shapes[ShapeAddedMidRead((64, 4))] += 3
    monkeypatch.setattr(rk, "ROW_TOTALS_SHAPES", shapes)
    _, url = replica
    for _ in range(3):
        with urllib.request.urlopen(url + "/metricsz", timeout=30) as r:
            assert r.status == 200
            got = json.loads(r.read())["kernels"]
        assert [64, 4, 3] in got["row_totals_shapes"]
        assert set(got["launches"]) == set(rk.LAUNCHES)
    assert len(shapes) == 4   # each read added one shape


def test_router_cordon_routes_around_dead_replica(replica):
    from fastconsensus_tpu_torch.serve.router import FleetRouter

    svc, url = replica
    router = FleetRouter({"live": url, "ghost": "http://127.0.0.1:9"},
                         poll_s=60.0)
    router.cordon("ghost", "test: known dead")
    for seed in range(6):
        body = json.dumps({"edges": [[0, 1], [1, 2]], "n_nodes": 8,
                           "algorithm": "lpm", "n_p": 2, "max_rounds": 2,
                           "seed": seed, "tau": seed / 10.0}).encode("utf-8")
        status, out, _ = router.submit(body)
        assert status == 202 and out["fleet_replica"] == "live"
    stats = router.fleet_stats()
    assert set(stats["assignments"].values()) == {"live"}
    assert {r["name"]: r["state"] for r in stats["replicas"]} == \
        {"live": "up", "ghost": "cordoned"}
    router.uncordon("ghost")
    assert {r["name"]: r["state"]
            for r in router.fleet_stats()["replicas"]}["ghost"] == "up"


# -- typed views: both packages parse the same payloads the same way ------


_CANNED_FLEETZ = {
    "schema": 1, "tool": "fctrace-fleetz", "scope": "fleet",
    "replicas": {"r0": {"ok": True, "scope": "replica", "histograms": 2,
                        "slo": {}}, "r1": {"ok": False}},
    "latency": {"histograms": [
        {"name": "serve.e2e", "tags": {"bucket": "n64_e96"}, "sources": 2,
         "count": 10, "sum_s": 0.5, "min_s": 0.01, "max_s": 0.2,
         "p50_s": 0.03125, "p95_s": 0.25, "p99_s": 0.25,
         "buckets": {"-5": 10}}]},
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

_CANNED_FLEET = {
    "replicas": [
        {"name": "a", "url": "http://h:1", "state": "up", "queue_depth": 3,
         "queue_max_depth": 64, "watchdog_trips": 0, "draining": False},
        {"name": "b", "url": "http://h:2", "state": "cordoned",
         "cordon_reason": "trip", "retry_after_hint_s": 1.5,
         "rehomed_keys": ["n64_e96|n_p=4"], "last_bundle": "/x"}],
    "ring": {"members": ["a", "b"], "vnodes": 128},
    "assignments": {"n64_e96|": "a"}, "jobs_tracked": 7,
    "jobs_in_flight": 2, "content_hash_index": 5,
    "counters": {"serve.fleet.cordons": 1}}

_CANNED_TIMELINE = {
    "schema": 1, "tool": "fctrace-timeline", "trace": "tr-1",
    "replicas": ["r0", "r1"], "n_events": 2,
    "events_per_replica": {"r0": 1, "r1": 1},
    "skipped_bundles": ["r2__fcflight_x"],
    "events": [
        {"t_wall": 1001.0, "replica": "r0", "thread": "t", "ts": 1.0,
         "kind": "route", "job": "f1", "trace": "tr-1"},
        {"t_wall": 1002.0, "replica": "r1", "thread": "t", "ts": 2.0,
         "kind": "admit", "job": "j1", "trace": "tr-1"}]}


def _views_equal(fleet, fleetz, timeline):
    from fastconsensus_tpu.serve import client as ref_client
    from fastconsensus_tpu_torch.serve import client as port_client

    for name, payload in (("FleetStats", fleet), ("FleetLatency", fleetz),
                          ("TraceTimeline", timeline)):
        a = getattr(ref_client, name).from_payload(payload)
        b = getattr(port_client, name).from_payload(payload)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
    for r in fleet["replicas"]:
        assert dataclasses.asdict(
            ref_client.ReplicaState.from_payload(r)) == \
            dataclasses.asdict(port_client.ReplicaState.from_payload(r))


def test_typed_fleet_views_equal_the_reference_on_canned_payloads():
    _views_equal(_CANNED_FLEET, _CANNED_FLEETZ, _CANNED_TIMELINE)
    from fastconsensus_tpu_torch.serve.client import (FleetLatency,
                                                      TraceTimeline)

    f = FleetLatency.from_payload(_CANNED_FLEETZ)
    assert f.replicas_down == ("r1",)
    assert f.histogram("serve.e2e", bucket="n64_e96").count == 10
    assert f.proxy_overhead["r0"]["p95_s"] == 0.003
    t = TraceTimeline.from_payload(_CANNED_TIMELINE)
    assert [e["kind"] for e in t.for_replica("r1")] == ["admit"]


def test_typed_fleet_views_equal_the_reference_on_a_live_port_router(
        replica):
    from fastconsensus_tpu_torch.serve.client import ServeClient
    from fastconsensus_tpu_torch.serve.router import (FleetRouter,
                                                      make_router_server)

    svc, url = replica
    router = FleetRouter({"r0": url, "ghost": "http://127.0.0.1:9"},
                         poll_s=60.0)
    router.poll_once()
    router.poll_once()     # two poll failures cordon the ghost
    httpd = make_router_server(router)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        client = ServeClient(f"http://127.0.0.1:{httpd.server_address[1]}",
                             timeout=10.0)
        for seed in range(2):
            client.submit(edges=[[0, 1], [1, 2], [2, 0]], n_nodes=8,
                          algorithm="lpm", n_p=2, max_rounds=2, seed=seed)
        fleet = client.healthz()["fleet"]
        fleetz = client._request("/fleetz")
        typed = client.fleet()
        assert typed.ring_members == ("r0", "ghost")
        assert [r.name for r in typed.up] == ["r0"]
        assert typed.jobs_tracked == 2
        assert client.fleetz().replicas_ok == {"ghost": False, "r0": True}
    finally:
        httpd.shutdown()
        httpd.server_close()
        for _ in range(2):
            svc.queue.pop(timeout=5.0)
    _views_equal(fleet, fleetz, _CANNED_TIMELINE)


# -- router decisions: both routers in front of the same stub replicas ----


class _StubReplica:
    """A stdlib replica stand-in with canned answers: ``mode`` "up" admits
    every submit (202, job ids in sequence), "shed" answers 429 with
    ``retry_after_s``; ``close()`` makes it dead."""

    def __init__(self, name):
        self.name = name
        self.mode = "up"
        self.retry_after = None
        self.seq = 0
        self.cached = set()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, code, payload, headers=None):
                body = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                if self.path == "/cachez":
                    stub.cached.add(json.loads(body)["content_hash"])
                    self._send(200, {"ok": True})
                    return
                if stub.mode == "shed":
                    self._send(429, {"error": "shedding",
                                     "backpressure": True, "shed": True,
                                     "retry_after_s": stub.retry_after},
                               {"Retry-After": "9"})
                    return
                stub.seq += 1
                h = hashlib.sha1(body).hexdigest()[:16]
                self._send(202, {"job_id": f"{stub.name}-j{stub.seq}",
                                 "state": "queued", "content_hash": h,
                                 "cached": h in stub.cached})
                stub.cached.add(h)

            def do_GET(self):
                p = self.path
                if p == "/healthz":
                    self._send(200, {"ok": True, "queue_depth": 0,
                                     "queue_max_depth": 64,
                                     "draining": False,
                                     "watchdog_trips": 0})
                elif p == "/metricsz":
                    self._send(200, {"scope": "replica", "shaping": {
                        "retry_after_hint_s": stub.retry_after},
                        "latency": {"histograms": [], "slo": {}},
                        "fcobs": {"counters": {"serve.jobs": stub.seq}}})
                elif p.startswith("/cachez/"):
                    h = p[len("/cachez/"):]
                    if h in stub.cached:
                        self._send(200, {"content_hash": h,
                                         "partitions": [[0, 0, 1]]})
                    else:
                        self._send(404, {"error": "no cached result"})
                elif p.startswith("/status/"):
                    self._send(200, {"job_id": p[8:], "state": "done"})
                elif p.startswith("/result/"):
                    self._send(200, {"job_id": p[8:], "state": "done",
                                     "partitions": [[0, 0, 1]],
                                     "cached": False})
                else:
                    self._send(404, {"error": "no such endpoint"})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None


def _stub_body(i, seed):
    return json.dumps({"edges": [[0, 1]] * (60 + 40 * (i % 6)),
                       "n_nodes": 34 + 30 * (i // 6), "algorithm": "lpm",
                       "n_p": 4, "seed": seed}).encode("utf-8")


def _scripted_fleet(pkg):
    """One scripted sequence through ``pkg``'s FleetRouter over two fresh
    stub replicas; returns every routing decision and the counters."""
    import importlib

    router_mod = importlib.import_module(f"{pkg}.serve.router")
    counters = importlib.import_module(f"{pkg}.obs.counters")
    stubs = {n: _StubReplica(n) for n in ("a", "b")}
    base = counters.get_registry().counters()
    router = router_mod.FleetRouter({n: s.url for n, s in stubs.items()},
                                    poll_s=60.0)
    log = []
    try:
        router.poll_once()
        ids = []
        for i in range(12):                      # both up
            status, out, _ = router.submit(_stub_body(i, seed=1))
            log.append(("up", i, status, out["fleet_replica"], out["job_id"],
                        out["cached"]))
            ids.append(out["job_id"])
        for fid in ids[:4]:
            status, out = router.result(fid)
            log.append(("result", fid, status, out["fleet_replica"]))
        stubs["a"].mode, stubs["a"].retry_after = "shed", 2.5
        router.poll_once()
        for i in range(12):                      # a sheds: walk to b
            seed = 1 if i % 2 else 2             # repeats: a cache fetch
            status, out, _ = router.submit(_stub_body(i, seed=seed))
            log.append(("a_sheds", i, status, out["fleet_replica"],
                        out["cached"]))
        stubs["b"].mode, stubs["b"].retry_after = "shed", 4.0
        for i in range(3):                       # everyone sheds
            status, out, headers = router.submit(_stub_body(i, seed=3))
            log.append(("all_shed", i, status, out, headers))
        stubs["a"].mode = "up"
        stubs["b"].close()                       # b dies
        router.poll_once()
        router.poll_once()
        for i in range(12):
            status, out, _ = router.submit(_stub_body(i, seed=4))
            log.append(("b_dead", i, status, out["fleet_replica"]))
        for fid in ids:
            status, out = router.result(fid)
            log.append(("after", fid, status, out["fleet_replica"],
                        out["fleet_replays"]))
        stats = router.fleet_stats()
        log.append(("replicas", [(r["name"], r["state"], r["cordon_reason"],
                                  sorted(r["rehomed_keys"]))
                                 for r in stats["replicas"]]))
        log.append(("assignments", sorted(stats["assignments"].items())))
    finally:
        router.stop()
        for s in stubs.values():
            s.close()
    since = counters.get_registry().counters_since(base)
    fleet_counters = {k: v for k, v in since.items()
                      if k.startswith("serve.fleet.")}
    return log, fleet_counters


def test_router_decisions_equal_the_reference_over_stub_replicas():
    ref_log, ref_counters = _scripted_fleet("fastconsensus_tpu")
    port_log, port_counters = _scripted_fleet("fastconsensus_tpu_torch")
    assert port_log == ref_log
    assert port_counters == ref_counters
    # the sequence exercised what it was written for
    homes = {e[1]: e[3] for e in port_log if e[0] == "up"}
    assert set(homes.values()) == {"a", "b"}
    assert all(e[3] == "b" for e in port_log if e[0] == "a_sheds")
    shed = [e for e in port_log if e[0] == "all_shed"]
    assert all(e[2] == 429 and e[3]["retry_after_s"] == 4.0 and
               e[4] == {"Retry-After": "4"} for e in shed)
    assert all(e[3] == "a" for e in port_log if e[0] == "b_dead")
    for key in ("serve.fleet.backpressure_hops", "serve.fleet.shed",
                "serve.fleet.cordons", "serve.fleet.replays",
                "serve.fleet.cache_fetch_hits", "serve.fleet.cache_seeded"):
        assert port_counters.get(key, 0) >= 1, key


# -- a mixed fleet: one port replica and one reference replica -----------


def test_mixed_fleet_serves_identical_partitions(karate_edges):
    from fastconsensus_tpu.serve import server as ref_server
    from fastconsensus_tpu_torch.serve import server as port_server
    from fastconsensus_tpu_torch.serve.client import ServeClient
    from fastconsensus_tpu_torch.serve.router import (FleetRouter,
                                                      make_router_server)

    edges, _, ids = karate_edges
    services, servers = {}, []
    for name, mod, cfg in (
            ("port", port_server, dict(device="cpu")),
            ("ref", ref_server, dict(devices=1))):
        svc = mod.ConsensusService(mod.ServeConfig(pin_sizing=False, **cfg))
        httpd, url = _serve(svc, mod.make_http_server)
        svc.start()
        services[name] = (svc, url)
        servers.append(httpd)
    router = FleetRouter({n: u for n, (_, u) in services.items()},
                         poll_s=60.0)
    router.poll_once()
    rhttpd = make_router_server(router)
    threading.Thread(target=rhttpd.serve_forever, daemon=True).start()
    client = ServeClient(f"http://127.0.0.1:{rhttpd.server_address[1]}",
                         timeout=30.0)
    results = {}
    try:
        for name, other in (("port", "ref"), ("ref", "port")):
            router.uncordon(name)
            router.cordon(other, "test: serve on the other replica")
            sub = client.submit(edges=edges.tolist(), n_nodes=len(ids),
                                algorithm="louvain", n_p=4, seed=5)
            assert sub["fleet_replica"] == name and not sub["cached"]
            results[name] = client.wait(sub["job_id"], timeout=300)
            assert results[name]["fleet_replica"] == name
    finally:
        rhttpd.shutdown()
        rhttpd.server_close()
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        for svc, _ in services.values():
            svc.drain(60)
    a, b = results["port"], results["ref"]
    assert (a["rounds"], a["converged"], a["bucket"]) == \
        (b["rounds"], b["converged"], b["bucket"])
    assert a["partitions"] == b["partitions"]
    assert len(a["partitions"]) == 4


# -- FleetManager on real port replicas (CPU) ---------------------------


def _wait(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.1)


def test_manager_kill_and_inherit_on_cpu_replicas(tmp_path, karate_edges):
    from fastconsensus_tpu_torch.obs import counters as obs_counters
    from fastconsensus_tpu_torch.serve.cache import ResultCache
    from fastconsensus_tpu_torch.serve.client import ServeClient
    from fastconsensus_tpu_torch.serve.fleet import FleetManager

    edges, _, ids = karate_edges
    base = obs_counters.get_registry().counters()
    fleet = FleetManager(str(tmp_path / "fleet"),
                         replica_args=("--device", "cpu"), cache_spill_s=0.5,
                         spawn_timeout_s=120.0)
    try:
        spawners = [threading.Thread(
            target=fleet.spawn, args=(n,),
            kwargs={"env_extra": {"PYTHONPATH": REPO}})
            for n in ("r0", "r1")]
        for t in spawners:
            t.start()
        for t in spawners:
            t.join(timeout=150)
        assert sorted(fleet.replicas) == ["r0", "r1"]
        client = ServeClient(fleet.start_router(), timeout=30.0)
        payload = dict(edges=edges.tolist(), n_nodes=len(ids),
                       algorithm="louvain", n_p=4, max_rounds=4, seed=2)
        sub = client.submit(**payload)
        first = client.wait(sub["job_id"], timeout=120)
        home = sub["fleet_replica"]
        other = ({"r0", "r1"} - {home}).pop()
        spill = fleet.replicas[home].cache_path

        def spilled():
            c = ResultCache(max_entries=8, ttl_seconds=600.0)
            return (os.path.exists(spill) and c.load(spill) >= 1
                    and sub["content_hash"] in c.keys())

        _wait(spilled, "the home replica's cache spill")
        assert fleet.kill(home, graceful=False) is None
        assert fleet.on_death(home) == other
        again = client.submit(**payload)
        assert again["cached"] and again["fleet_replica"] == other
        second = client.wait(again["job_id"], timeout=60)
        assert second["partitions"] == first["partitions"]
        assert second["compiles"] == 0
        since = obs_counters.get_registry().counters_since(base)
        assert since.get("serve.fleet.cache_inherited", 0) >= 1
        assert since.get("serve.fleet.cordons", 0) >= 1
    finally:
        codes = fleet.stop_all(graceful=True)
    assert codes.get(other) == 0, codes


def test_fleet_cli_comes_up_and_drains_on_sigterm(tmp_path):
    err = tmp_path / "fleet.err"
    env = dict(os.environ, PYTHONPATH=REPO)
    with open(err, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fastconsensus_tpu_torch.serve.fleet",
             "--replicas", "1", "--port", "0", "--workdir",
             str(tmp_path / "fleet"), "--replica-arg=--device",
             "--replica-arg=cpu"], cwd=tmp_path, env=env, stdout=fh,
            stderr=subprocess.STDOUT)
    try:
        def up():
            assert proc.poll() is None, err.read_text()
            return "routing 1 replica(s) at " in err.read_text()

        _wait(up, "the fleet to route", timeout=120)
        url = re.search(r"at (http://\S+)", err.read_text()).group(1)
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["ok"] and [rep["name"] for rep in
                                 health["fleet"]["replicas"]] == ["r0"]
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    assert rc == 0, err.read_text()
    assert "r0: exit 0" in err.read_text()


def test_manager_surfaces_a_replica_without_cuda(tmp_path):
    """Replicas serve on CUDA unless asked otherwise, and the manager adds
    no ``--device cpu`` of its own: a replica that sees no GPU exits 2
    and the spawn fails with its log's reason."""
    from fastconsensus_tpu_torch.serve.fleet import (FleetManager,
                                                     ReplicaSpawnError)

    fleet = FleetManager(str(tmp_path / "fleet"), spawn_timeout_s=120.0)
    with pytest.raises(ReplicaSpawnError, match=r"rc=2 .*CUDA"):
        fleet.spawn("r0", env_extra={"PYTHONPATH": REPO,
                                     "CUDA_VISIBLE_DEVICES": ""})
    assert fleet.replicas == {}
    assert fleet.router.ring.members() == []
