"""The serving tier's units, the PyTorch port against the JAX reference.

Each unit of numpy and threads runs through one test parametrised over
both packages (``pkg``): the same inputs, built with numpy from fixed
seeds, and the same expected outcomes, so that equal outcomes stand for
parity.  Where the two packages meet directly (content hashes, spilled
caches, cost priors) the test holds one against the other exactly.
Tolerance: exact everywhere.
"""

import dataclasses
import importlib
import threading

import numpy as np
import pytest
import torch

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

PKGS = ("fastconsensus_tpu", "fastconsensus_tpu_torch")


@pytest.fixture(params=PKGS, ids=["jax", "torch"])
def pkg(request):
    return request.param


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def ring_graph(n, chords=0, shift=7):
    idx = np.arange(n)
    edges = [np.stack([idx, (idx + 1) % n], 1)]
    if chords:
        c = np.arange(chords)
        edges.append(np.stack([c % n, (c + shift) % n], 1))
    return np.concatenate(edges).astype(np.int64)


def bucket_graphs():
    """Four distinct graphs of one bucket (n64_e96)."""
    return [(ring_graph(34, 40), 34),
            (ring_graph(40, 38, shift=5), 40),
            (ring_graph(33, 52, shift=13), 33),
            (ring_graph(36, 44, shift=11), 36)]


def make_spec(pkg, edges, n_nodes, priority=None, weights=None, **over):
    jobs = mod(pkg, "serve.jobs")
    kwargs = dict(algorithm="louvain", n_p=4, tau=0.2, delta=0.02,
                  max_rounds=2, seed=0)
    kwargs.update(over)
    return jobs.JobSpec(
        edges=np.asarray(edges, dtype=np.int64), n_nodes=n_nodes,
        config=mod(pkg, "consensus").ConsensusConfig(**kwargs),
        weights=weights,
        priority=jobs.PRIORITY_NORMAL if priority is None else priority)


# -- buckets and the batch ladder ---------------------------------------


def test_batch_ladder_and_bucket_keys(pkg):
    bucketer = mod(pkg, "serve.bucketer")
    shaping = mod(pkg, "serve.shaping")
    assert shaping.BATCH_LADDER == bucketer.BATCH_LADDER == (1, 2, 4, 8)
    assert [bucketer.batch_rung(n) for n in range(1, 10)] == \
        [1, 2, 2, 4, 4, 4, 4, 8, 8]
    for edges, n in bucket_graphs():
        spec = make_spec(pkg, edges, n)
        assert spec.bucket().key() == "n64_e96"
        assert bucketer.bucket_from_key("n64_e96") == spec.bucket()
    assert make_spec(pkg, ring_graph(200, 100), 200).bucket().key() == \
        "n256_e384"
    with pytest.raises(ValueError):
        bucketer.bucket_from_key("n65_e96")   # off the grid


# -- content addressing --------------------------------------------------


def content_cases(karate_edges):
    edges, _, ids = karate_edges
    rng = np.random.default_rng(7)
    w = rng.integers(1, 5, edges.shape[0]).astype(np.float32)
    ring = ring_graph(40, 38, shift=5)
    return {
        "karate": (edges, len(ids), None, {}),
        "karate_weighted_lpm": (edges, len(ids), w,
                                {"algorithm": "lpm", "tau": 0.8}),
        "ring_closure_tau": (ring, 40, None,
                             {"closure_tau": 0.2, "n_p": 20, "seed": 5}),
        "ring_leiden_gamma": (ring, 40, None,
                              {"algorithm": "leiden", "gamma": 0.5,
                               "warm_start": False, "max_rounds": 64}),
    }


@pytest.mark.parametrize("case", ["karate", "karate_weighted_lpm",
                                  "ring_closure_tau", "ring_leiden_gamma"])
def test_content_hash_and_group_equal_the_reference(karate_edges, case):
    """One request hashes the same in both packages (the cache interop
    rests on it), and so does its coalescing group."""
    edges, n, w, over = content_cases(karate_edges)[case]
    specs = [make_spec(p, edges, n, weights=w, **over) for p in PKGS]
    cfgs = [s.config for s in specs]
    assert dataclasses.astuple(cfgs[0]) == dataclasses.astuple(cfgs[1])
    hashes = [s.content_hash() for s in specs]
    assert hashes[0] == hashes[1]
    assert hashes[1] == mod(PKGS[1], "serve.jobs").content_hash(
        edges, n, cfgs[1], weights=w)
    assert specs[0].batch_group() == specs[1].batch_group()
    # order invariance, and any config field moves the address
    rng = np.random.default_rng(0)
    perm = rng.permutation(edges.shape[0])
    flipped = np.stack([edges[perm, 1], edges[perm, 0]], 1)
    shuffled = make_spec(PKGS[1], flipped, n,
                         weights=None if w is None else w[perm], **over)
    assert shuffled.content_hash() == hashes[1]
    assert make_spec(PKGS[1], edges, n, weights=w,
                     **dict(over, seed=99)).content_hash() != hashes[1]


def test_batch_group_excludes_seed_only(pkg):
    jobs = mod(pkg, "serve.jobs")
    edges, n = bucket_graphs()[0]
    g1 = jobs.Job(make_spec(pkg, edges, n, seed=1)).spec.batch_group()
    g2 = jobs.Job(make_spec(pkg, edges, n, seed=2)).spec.batch_group()
    assert g1 == g2
    assert jobs.Job(make_spec(pkg, edges, n, seed=1, n_p=8)) \
        .spec.batch_group() != g1
    assert jobs.Job(make_spec(pkg, ring_graph(200, 100), 200, seed=1)) \
        .spec.batch_group() != g1


# -- admission queue -----------------------------------------------------


def test_queue_rejects_when_full_and_when_closed(pkg, karate_edges):
    jobs = mod(pkg, "serve.jobs")
    queue = mod(pkg, "serve.queue")
    reg = mod(pkg, "obs.counters").get_registry()
    edges, _, ids = karate_edges
    base = reg.counters()
    q = queue.AdmissionQueue(max_depth=2)
    q.submit(jobs.Job(make_spec(pkg, edges, len(ids), seed=1)))
    q.submit(jobs.Job(make_spec(pkg, edges, len(ids), seed=2)))
    with pytest.raises(queue.QueueFull) as e:
        q.submit(jobs.Job(make_spec(pkg, edges, len(ids), seed=3)))
    assert (e.value.depth, e.value.max_depth, q.depth()) == (2, 2, 2)
    q.close()
    with pytest.raises(queue.QueueClosed):
        q.submit(jobs.Job(make_spec(pkg, edges, len(ids), seed=4)))
    since = reg.counters_since(base)
    assert since.get("serve.queue.rejected_full", 0) == 1
    assert since.get("serve.queue.rejected_draining", 0) == 1
    assert q.pop() is not None and q.pop() is not None
    assert q.pop() is None


def test_queue_priority_order_under_contention(pkg, karate_edges):
    jobs = mod(pkg, "serve.jobs")
    queue = mod(pkg, "serve.queue")
    edges, _, ids = karate_edges
    q = queue.AdmissionQueue(max_depth=64)
    prios = (jobs.PRIORITY_BATCH, jobs.PRIORITY_INTERACTIVE,
             jobs.PRIORITY_NORMAL)
    start = threading.Barrier(4)

    def submitter(tid):
        start.wait()
        for i in range(6):
            q.submit(jobs.Job(make_spec(pkg, edges, len(ids),
                                        seed=tid * 100 + i,
                                        priority=prios[(tid + i) % 3])))

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    popped = []
    while (job := q.pop(timeout=0.01)) is not None:
        popped.append(job)
    assert len(popped) == 24
    prios_out = [j.spec.priority for j in popped]
    assert prios_out == sorted(prios_out)


def test_pop_batch_coalesces_same_group_without_priority_starvation(pkg):
    jobs = mod(pkg, "serve.jobs")
    queue = mod(pkg, "serve.queue")
    graphs = bucket_graphs()
    q = queue.AdmissionQueue(max_depth=16)
    group = [jobs.Job(make_spec(pkg, e, n, seed=i,
                                priority=jobs.PRIORITY_BATCH))
             for i, (e, n) in enumerate(graphs)]
    other = jobs.Job(make_spec(pkg, ring_graph(200, 100), 200, seed=9,
                               priority=jobs.PRIORITY_INTERACTIVE))
    for j in group[:2]:
        q.submit(j)
    q.submit(other)
    for j in group[2:]:
        q.submit(j)

    def gk(job):
        return job.spec.batch_group()

    assert [j.job_id for j in q.pop_batch(8, gk)] == [other.job_id]
    assert [j.job_id for j in q.pop_batch(8, gk)] == \
        [j.job_id for j in group]
    for j in group:
        q.submit(j)
    assert len(q.pop_batch(2, gk)) == 2 and q.depth() == 2
    q.close()
    while q.pop_batch(8, gk) is not None:
        pass
    assert q.pop_batch(8, gk) is None


# -- result cache ----------------------------------------------------------


def test_cache_lru_and_ttl(pkg):
    cache = mod(pkg, "serve.cache")
    reg = mod(pkg, "obs.counters").get_registry()
    c = cache.ResultCache(max_entries=2, ttl_seconds=60.0)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)                   # evicts b, the least recently hit
    assert c.get("b") is None
    assert (c.get("a"), c.get("c"), len(c)) == (1, 3, 2)
    now = [0.0]
    c = cache.ResultCache(max_entries=4, ttl_seconds=10.0,
                          clock=lambda: now[0])
    base = reg.counters()
    c.put("k", "v")
    now[0] = 9.9
    assert c.get("k") == "v"
    now[0] = 10.1
    assert c.get("k") is None and len(c) == 0
    since = reg.counters_since(base)
    assert [since.get(f"serve.cache.{k}", 0)
            for k in ("expired", "hit", "miss")] == [1, 1, 1]


def test_cache_pins_survive_eviction(pkg):
    cache = mod(pkg, "serve.cache")
    c = cache.ResultCache(max_entries=1, ttl_seconds=60.0)
    c.put("parent", {"x": 1})
    assert c.pin("parent")
    c.put("other", {"x": 2})        # may not evict the pinned parent
    assert c.get("parent", count_miss=False) == {"x": 1}
    c.unpin("parent")
    c.put("third", {"x": 3})
    assert c.get("parent", count_miss=False) is None


def _result(key, seed):
    rng = np.random.default_rng(seed)
    return {"content_hash": key, "rounds": 3, "converged": True,
            "cached": False, "n_nodes": 5, "compiles": 0,
            "partitions": [rng.integers(0, 3, 5).astype(np.int32)
                           for _ in range(2)],
            "quality": {"final_agreement": 0.9},
            "graph": {"u": np.array([0, 1], dtype=np.int64),
                      "v": np.array([1, 2], dtype=np.int64),
                      "w": np.array([1.0, 2.5], dtype=np.float32)},
            "config": {"algorithm": "louvain", "n_p": 2}}


def test_cache_spill_and_reload(pkg, tmp_path):
    cache = mod(pkg, "serve.cache")
    now = [100.0]
    c = cache.ResultCache(max_entries=8, ttl_seconds=50.0,
                          clock=lambda: now[0])
    c.put("aaa", _result("aaa", 1))
    now[0] = 130.0
    c.put("bbb", _result("bbb", 2))
    c.put("skipme", "not-a-result-payload")
    path = str(tmp_path / "cache.npz")
    assert c.spill(path) == 2
    now2 = [7.0]
    c2 = cache.ResultCache(max_entries=8, ttl_seconds=50.0,
                           clock=lambda: now2[0])
    assert c2.load(path) == 2
    got = c2.get("aaa")
    assert got["rounds"] == 3 and got["converged"] is True
    assert np.array_equal(got["partitions"][0],
                          _result("aaa", 1)["partitions"][0])
    now2[0] = 28.0                  # "aaa" had 20 s left at the spill
    assert c2.get("aaa") is None and c2.get("bbb") is not None
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"garbage")
    assert cache.ResultCache(max_entries=8, ttl_seconds=50.0) \
        .load(str(bad)) == 0


@pytest.mark.parametrize("writer,reader", [(PKGS[1], PKGS[0]),
                                           (PKGS[0], PKGS[1])],
                         ids=["torch_to_jax", "jax_to_torch"])
def test_cache_spilled_by_one_package_loads_in_the_other(tmp_path, writer,
                                                         reader):
    path = str(tmp_path / "cache.npz")
    w = mod(writer, "serve.cache").ResultCache(max_entries=8)
    for i, key in enumerate(("k1", "k2", "k3")):
        w.put(key, _result(key, i))
    assert w.spill(path) == 3
    r = mod(reader, "serve.cache").ResultCache(max_entries=8)
    assert r.load(path) == 3
    for i, key in enumerate(("k1", "k2", "k3")):
        want, got = _result(key, i), r.get(key)
        for p, q in zip(want["partitions"], got["partitions"]):
            assert np.array_equal(p, q) and q.dtype == np.int32
        for f in ("u", "v", "w"):
            assert np.array_equal(want["graph"][f], got["graph"][f])
        assert got["config"] == want["config"]
        assert got["quality"] == want["quality"]


# -- scheduler -------------------------------------------------------------


class StubWorker:
    def __init__(self, idx, load=0, warm=(), cordoned=False):
        self.idx = idx
        self._load = load
        self.warm_buckets = set(warm)
        self.cordoned = cordoned

    def eligible(self, exclude=frozenset()):
        return not self.cordoned and self.idx not in exclude

    def load(self):
        return self._load

    def is_warm(self, bucket):
        return bucket in self.warm_buckets


def test_scheduler_sticky_spill_and_cordon(pkg):
    sched_mod = mod(pkg, "serve.scheduler")
    reg = mod(pkg, "obs.counters").get_registry()
    base = reg.counters()
    sched = sched_mod.StickyScheduler(spill_backlog=2)
    ws = [StubWorker(0), StubWorker(1), StubWorker(2)]
    assert sched.route("b1", ws).idx == 0
    ws[0]._load = 2
    assert sched.route("b1", ws).idx == 0       # at the threshold: sticky
    ws[0]._load, ws[1]._load = 3, 1
    assert sched.route("b1", ws).idx == 2       # past it: spill
    assert sched.affinity() == {"b1": 0}
    since = reg.counters_since(base)
    assert [since.get(f"serve.sched.{k}", 0)
            for k in ("assigns", "sticky_hits", "spills")] == [1, 1, 1]
    # spills prefer a worker that already ran the bucket
    sched = sched_mod.StickyScheduler(spill_backlog=0)
    ws = [StubWorker(0, load=5), StubWorker(1, load=3),
          StubWorker(2, load=4, warm=("b1",))]
    sched.route("b1", [ws[0]])
    assert sched.route("b1", ws).idx == 2
    # exclusion, re-homing off a cordoned home, and no eligible worker
    sched = sched_mod.StickyScheduler()
    ws = [StubWorker(0), StubWorker(1)]
    assert sched.route("b1", ws).idx == 0
    assert sched.route("b1", ws, exclude=frozenset({0})).idx == 1
    ws[0].cordoned = True
    assert sched.route("b1", ws).idx == 1
    assert sched.affinity() == {"b1": 1}
    ws[1].cordoned = True
    with pytest.raises(sched_mod.NoEligibleWorker):
        sched.route("b1", ws)


# -- shaping ------------------------------------------------------------


def test_shaper_holds_and_sheds_with_the_injected_prior(pkg):
    """A cold bucket's estimate is the injected prior; a rung that can
    fill inside the slack holds, one that cannot bypasses, and a job
    whose deadline the queued work provably overruns sheds."""
    shaping = mod(pkg, "serve.shaping")
    lat = mod(pkg, "obs.latency").LatencyRegistry()
    sh = shaping.TrafficShaper(
        shaping.ShapingConfig(max_hold_s=0.050, hold_margin=1.5),
        lat=lat, cost_prior=lambda b: 0.15 if b == "b" else None)
    est = sh.service_estimate("b", fallback=False)
    assert est == {"count": 0, "mean_s": 0.15, "p95_s": 0.15,
                   "prior": True}
    assert sh.service_estimate("cold", fallback=False) is None
    now = 1000.0
    for k in range(16):
        lat.arrivals.mark("b", at=now - 0.005 * (16 - k))   # 200/s
    d = sh.hold_decision("b", have=1, max_b=8, slack_s=10.0, now=now)
    assert d.reason == "hold" and d.target == 2
    assert d.hold_s == pytest.approx(1.5 / 200.0, rel=0.1)
    d = sh.hold_decision("b", have=1, max_b=8, slack_s=0.005, now=now)
    assert (d.hold_s, d.reason) == (0.0, "deadline")
    d = sh.hold_decision("cold", have=1, max_b=8, slack_s=10.0, now=now)
    assert (d.hold_s, d.reason) == (0.0, "fill_exceeds_slack")
    # 20 queued x 150 ms (the prior) cannot finish in 0.5 s
    reason = sh.should_shed("b", now + 0.5, depth=20, now=now)
    assert reason is not None and "deadline shed" in reason
    assert sh.should_shed("b", now + 60.0, depth=20, now=now) is None
    assert sh.should_shed("cold", now + 0.001, depth=50, now=now) is None
    assert sh.retry_after_s(20, "b") > 1.0


def test_cost_priors_equal_the_reference():
    jcost = mod(PKGS[0], "analysis.cost")
    tcost = mod(PKGS[1], "analysis.cost")
    keys = ["n64_e96", "n1024_e24576", "n12288_e65536", "n256_e384",
            "bogus", "solo:j1"]
    for key in keys:
        assert tcost.static_service_prior(key) == \
            jcost.static_service_prior(key)
        assert tcost.static_service_prior(key, n_p=4) == \
            jcost.static_service_prior(key, n_p=4)
        assert tcost.spill_weight(key) == jcost.spill_weight(key)
    for kind in ("rounds", "batch", "detect", "detect-batch", "tail",
                 "rounds[warm]"):
        for n, e in ((64, 96), (2048, 6144)):
            assert tcost.mirror_cost(kind, n, e, b=4, n_p=20) == \
                jcost.mirror_cost(kind, n, e, b=4, n_p=20)
    assert tcost.MachineModel() == tcost.MachineModel(4.0e11, 4.0e11,
                                                      5.0e-4)


# -- the compile guard's counterpart ------------------------------------


def test_compile_guard_counts_builds_on_its_thread():
    from fastconsensus_tpu_torch.analysis import CompileGuard
    from fastconsensus_tpu_torch.analysis.recompile_guard import (
        RecompileError, note_build)
    from fastconsensus_tpu_torch.obs.counters import ObsRegistry

    reg = ObsRegistry()
    with CompileGuard(registry=reg, counter="serve.xla_compiles",
                      thread_ident=threading.get_ident()) as g, \
            CompileGuard() as everyone:
        note_build("nvcc:row_totals")
        t = threading.Thread(target=note_build, args=("nvcc:other",))
        t.start()
        t.join()
    note_build("after")             # outside every guard: nobody counts
    assert (g.count, g.events) == (1, ["nvcc:row_totals"])
    assert everyone.count == 2
    assert reg.counters()["serve.xla_compiles"] == 1
    with pytest.raises(RecompileError):
        with CompileGuard(max_compiles=0):
            note_build("nvcc:row_totals")


def test_compile_guard_counts_a_host_library_build_not_a_load(
        tmp_path, monkeypatch):
    """The g++ build of the host C++ library counts once; loading the
    built library again counts nothing."""
    from fastconsensus_tpu_torch import native
    from fastconsensus_tpu_torch.analysis import CompileGuard

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native.reset()
    try:
        with CompileGuard(thread_ident=threading.get_ident()) as g:
            native.load()
        assert g.events == ["g++:fcnative"]
        native.reset()
        with CompileGuard() as g2:
            native.load()
        assert g2.count == 0
    finally:
        native.reset()


def test_fault_sites_name_the_port_modules():
    from fastconsensus_tpu_torch.serve import faultinject, pool

    site = "fastconsensus_tpu_torch.serve.pool:_Worker._run:RuntimeError"
    assert faultinject.parse_site_id(site) == (
        "fastconsensus_tpu_torch.serve.pool", "_Worker._run",
        "RuntimeError")
    orig = pool._Worker._run
    faultinject.install(site, count=1)
    try:
        assert pool._Worker._run is not orig
        with pytest.raises(RuntimeError, match="fault injected"):
            pool._Worker._run(None, [])
        assert faultinject.installed_sites() == [site]
    finally:
        assert faultinject.uninstall_all() == [site]
    assert pool._Worker._run is orig
    with pytest.raises(ValueError):
        faultinject.parse_site_id("no-colons")


# -- the hang watchdog ----------------------------------------------------


class StubLatency:
    def __init__(self, est):
        self.est = est

    def service_estimate(self, bucket=None, min_count=1):
        return self.est


def test_watchdog_trips_once_per_episode_with_its_guards(pkg):
    wd_mod = mod(pkg, "serve.watchdog")
    now = [0.0]
    est = {"count": 20, "mean_s": 0.05, "p95_s": 0.1}
    wd = wd_mod.HangWatchdog(
        StubLatency(est), wd_mod.WatchdogConfig(k=2.0, floor_s=1.0,
                                                min_history=8, poll_s=0.5),
        clock=lambda: now[0])
    wd.beat(0, "device", job="j1", bucket="n64_e96")
    assert wd.check(now=0.5) == []            # under the floor
    trips = wd.check(now=1.5)
    assert [(t["device"], t["job"], t["threshold_s"], t["elapsed_s"])
            for t in trips] == [(0, "j1", 1.0, 1.5)]
    assert wd.check(now=50.0) == [] and wd.trips() == 1
    wd.beat(0, "device_done")
    assert wd.suspects() == []
    # a cold dispatch (kernels to build) and other states never trip
    wd.beat(1, "device", job="cold", bucket="b", cold=True)
    wd.beat(2, "idle")
    assert wd.check(now=1e6) == []
    none = wd_mod.HangWatchdog(StubLatency(None), wd_mod.WatchdogConfig())
    none.beat(0, "device", job="j", bucket="b")
    assert none.check(now=1e6) == []          # no history, no verdict
    for bad in (dict(k=0.0), dict(floor_s=-1.0), dict(min_history=0),
                dict(poll_s=0.0)):
        with pytest.raises(ValueError):
            wd_mod.WatchdogConfig(**bad).validate()
