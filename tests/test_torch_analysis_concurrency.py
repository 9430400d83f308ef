"""The port's concurrency pass and its runtime half, the lock-order
recorder (``fastconsensus_tpu_torch/analysis/concurrency.py``,
``lockorder.py``).

* On the reference's fixtures (``tests/analysis_fixtures/``, plain
  Python) the port's pass gives exactly the reference's ``(rule, line,
  col)`` diagnostics and suppression counts, file by file and as one
  program; the expected counts are the reference's
  (``tests/test_analysis.py``).
* The port's own fixtures (``tests/torch_analysis_fixtures/``) fire each
  rule on the bad file and not on its clean twin, ``blocking-under-lock``
  on ``torch.cuda.synchronize()`` and ``.item()`` under a lock among
  them.
* The port's package has a non-empty, acyclic static lock graph keyed on
  the ``fastconsensus_tpu_torch`` root.
* Under ``lockorder.recording()``: the serving core's queue, cache and
  scheduler stressed by threads, and a ``ConsensusService`` on the CPU,
  each with a deadline on every join and on the drain, so a deadlock
  fails the test instead of hanging it; the observed graph is acyclic in
  union with the static one.  A forced inversion is caught, and the
  port's and the reference's recorders, active at once, each record
  only their own tree's locks.
"""

import _thread
import os
import threading
import time

import numpy as np
import pytest
import torch

from fastconsensus_tpu.analysis import concurrency as jconc
from fastconsensus_tpu.analysis import lockorder as jlock
from fastconsensus_tpu_torch.analysis import _module_name, lint_paths
from fastconsensus_tpu_torch.analysis import concurrency as tconc
from fastconsensus_tpu_torch.analysis import lockorder as tlock
from fastconsensus_tpu_torch.analysis import read_sources

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures")
FIXTURES = os.path.join(REPO, "tests", "torch_analysis_fixtures")
PKG = os.path.join(REPO, "fastconsensus_tpu_torch")
REF_PKG = os.path.join(REPO, "fastconsensus_tpu")

# the reference's pairs and counts (tests/test_analysis.py)
REF_CASES = [
    ("bad_guarded_field.py", "ok_guarded_field.py", "guarded-field", 1),
    ("bad_lock_order.py", "ok_lock_order.py", "lock-order", 1),
    ("bad_blocking_lock.py", "ok_blocking_lock.py",
     "blocking-under-lock", 4),
    ("bad_notify_outside.py", "ok_notify_inside.py",
     "notify-outside-lock", 1),
    ("bad_root_write.py", "ok_root_write.py", "unguarded-root-write", 2),
]
PORT_CASES = [
    ("bad_guarded_field.py", "ok_guarded_field.py", "guarded-field", 1),
    ("bad_lock_order.py", "ok_lock_order.py", "lock-order", 1),
    ("bad_blocking_sync.py", "ok_blocking_sync.py",
     "blocking-under-lock", 2),
    ("bad_notify_outside.py", "ok_notify_inside.py",
     "notify-outside-lock", 1),
    ("bad_root_write.py", "ok_root_write.py", "unguarded-root-write", 1),
]


def _key(diags):
    return sorted((d.rule, d.line, d.col) for d in diags)


def _read(path):
    with open(path, encoding="utf-8") as fh:
        return fh.read()


@pytest.mark.parametrize("bad,ok,rule,n_bad", REF_CASES,
                         ids=[c[2] for c in REF_CASES])
def test_reference_fixtures_give_the_reference_diagnostics(bad, ok, rule,
                                                           n_bad):
    for name in (bad, ok):
        path = os.path.join(REF_FIXTURES, name)
        src = {path: _read(path)}
        t_diags, t_supp = tconc.check_concurrency(src)
        j_diags, j_supp = jconc.check_concurrency(src)
        assert _key(t_diags) == _key(j_diags), name
        assert t_supp == j_supp, name
        hits = [d for d in t_diags if d.rule == rule]
        assert len(hits) == (n_bad if name == bad else 0), \
            [d.format() for d in t_diags]


def test_reference_fixture_set_as_one_program():
    sources = read_sources([REF_FIXTURES])
    t_diags, t_supp = tconc.check_concurrency(sources)
    j_diags, j_supp = jconc.check_concurrency(sources)
    assert _key(t_diags) == _key(j_diags) and t_supp == j_supp
    assert {d.rule for d in t_diags} == set(tconc.CONCURRENCY_RULES)
    assert tconc.static_lock_graph(sources) == \
        jconc.static_lock_graph(sources)
    assert tconc.lock_sites(sources) == jconc.lock_sites(sources)


@pytest.mark.parametrize("bad,ok,rule,n_bad", PORT_CASES,
                         ids=[c[2] for c in PORT_CASES])
def test_port_fixtures_fire_on_bad_only(bad, ok, rule, n_bad):
    hits = [d for d in lint_paths([os.path.join(FIXTURES, bad)]).diagnostics]
    assert [d.rule for d in hits] == [rule] * n_bad, \
        [d.format() for d in hits]
    assert not lint_paths([os.path.join(FIXTURES, ok)]).diagnostics


def test_blocking_table_names_the_torch_syncs():
    diags = lint_paths([os.path.join(FIXTURES,
                                     "bad_blocking_sync.py")]).diagnostics
    text = " ".join(d.message for d in diags)
    assert "torch.cuda.synchronize" in text or ".synchronize()" in text
    assert ".item()" in text
    # the reference's jax entries are gone, the device dispatch stays
    assert ("jax", "device_get") not in tconc._BLOCKING_QUALIFIED
    assert ("torch.cuda", "synchronize") in tconc._BLOCKING_QUALIFIED
    assert {"synchronize", "item", "tolist", "cpu", "numpy"} <= \
        tconc._BLOCKING_ATTRS
    assert tconc._DEVICE_DISPATCH == {"run_consensus",
                                      "run_consensus_batch"}


def test_module_names_key_on_the_port_root():
    path = os.path.join(PKG, "serve", "queue.py")
    assert _module_name(path) == "fastconsensus_tpu_torch.serve.queue"
    assert _module_name(os.path.join(PKG, "serve", "__init__.py")) == \
        "fastconsensus_tpu_torch.serve"
    # the reference's keying collapses the port's files onto bare stems
    from fastconsensus_tpu.analysis import _module_name as ref_name

    assert ref_name(path) == "queue"


def test_the_package_static_lock_graph_is_acyclic():
    sources = read_sources([PKG])
    graph = tconc.static_lock_graph(sources)
    assert graph, "expected at least one static lock-order edge"
    assert tconc.find_cycle(graph) is None, tconc.find_cycle(graph)
    assert all(a.startswith("fastconsensus_tpu_torch.") and
               b.startswith("fastconsensus_tpu_torch.") for a, b in graph)
    sites = tconc.lock_sites(sources)
    assert all(f.startswith(PKG + os.sep) for f, _ in sites)
    assert ("fastconsensus_tpu_torch.serve.queue.AdmissionQueue._cond",
            "fastconsensus_tpu_torch.obs.counters.ObsRegistry._lock") in graph


def test_find_cycle_detects_and_clears():
    assert tconc.find_cycle({("a", "b"), ("b", "c")}) is None
    cyc = tconc.find_cycle({("a", "b"), ("b", "c"), ("c", "a")})
    assert cyc is not None and set(cyc) == {"a", "b", "c"}
    assert tconc.find_cycle({("a", "a")}) == ["a"]


# -- the runtime half --------------------------------------------------


def _static():
    sources = read_sources([PKG])
    return tconc.lock_sites(sources), tconc.static_lock_graph(sources)


def _assert_consistent_with_static(rec):
    """Observed edges, mapped onto static lock keys, unioned with the
    static graph, must stay acyclic."""
    sites, static = _static()
    rec.assert_acyclic(extra_edges=static, sites=sites)
    return rec.named_edges(sites), static


def _ring(n, chords=0):
    idx = np.arange(n)
    edges = [np.stack([idx, (idx + 1) % n], 1)]
    if chords:
        c = np.arange(chords)
        edges.append(np.stack([c % n, (c + 7) % n], 1))
    return np.concatenate(edges).astype(np.int64)


def _spec(edges, n_nodes, **over):
    from fastconsensus_tpu_torch.consensus import ConsensusConfig
    from fastconsensus_tpu_torch.serve.jobs import JobSpec

    kwargs = dict(algorithm="louvain", n_p=4, tau=0.2, delta=0.02,
                  max_rounds=2, seed=0)
    kwargs.update(over)
    return JobSpec(edges=np.asarray(edges, dtype=np.int64),
                   n_nodes=n_nodes, config=ConsensusConfig(**kwargs))


def _join_all(threads, deadline):
    for t in threads:
        t.join(max(0.1, deadline - time.monotonic()))
    stuck = [t.name for t in threads if t.is_alive()]
    assert not stuck, f"deadlock watchdog: threads stuck: {stuck}"


@pytest.fixture
def port_lock_order():
    """The port's recorder from the environment: ``FCTPU_LOCK_ORDER=1``
    installs it for the test (``lockorder.maybe_install_from_env``, as
    the reference's conftest installs its own), whose observed graph must
    then be acyclic; unset, nothing is installed."""
    rec = tlock.maybe_install_from_env()
    try:
        yield rec
    finally:
        if rec is not None:
            tlock.uninstall()
    if rec is not None:
        rec.assert_acyclic()


@pytest.mark.usefixtures("port_lock_order")
def test_lock_order_stress_queue_cache_scheduler(monkeypatch):
    """Submitter threads hammer the port's AdmissionQueue while consumers
    pop_batch, probe the ResultCache and route through the
    StickyScheduler (the reference's tier-1 stress, on the port's
    classes)."""
    with tlock.recording() as rec:
        from fastconsensus_tpu_torch.obs import counters as obs_counters
        from fastconsensus_tpu_torch.serve.cache import ResultCache
        from fastconsensus_tpu_torch.serve.jobs import Job
        from fastconsensus_tpu_torch.serve.queue import AdmissionQueue
        from fastconsensus_tpu_torch.serve.scheduler import StickyScheduler

        # the process-global registry predates the recording block (its
        # lock is unwrapped); one built here records the edges into the
        # registry at its declaration site, as the static keys have them
        monkeypatch.setattr(obs_counters, "_REGISTRY",
                            obs_counters.ObsRegistry())
        queue = AdmissionQueue(max_depth=256)
        cache = ResultCache(max_entries=64)
        sched = StickyScheduler(spill_backlog=2)

        class _Stub:
            def __init__(self, idx):
                self.idx = idx
                self._lock = threading.Lock()
                self._warm = set()
                self._n = 0

            def eligible(self, exclude=frozenset()):
                return self.idx not in exclude

            def load(self):
                with self._lock:
                    return self._n

            def is_warm(self, bucket):
                with self._lock:
                    return bucket in self._warm

            def note(self, bucket):
                with self._lock:
                    self._warm.add(bucket)
                    self._n += 1

        workers = [_Stub(i) for i in range(4)]
        edges = _ring(24, 12)
        n_sub, per_thread = 6, 40
        errors = []

        def submitter(tid):
            try:
                for i in range(per_thread):
                    job = Job(_spec(edges, 24, seed=tid * 1000 + i))
                    queue.submit(job)
                    cache.get(job.key)           # miss probe
                    if i % 5 == 0:
                        cache.put(f"k{tid}:{i}", {"partitions": []})
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        def consumer():
            try:
                while True:
                    batch = queue.pop_batch(
                        4, group_key=lambda j: j.spec.batch_group())
                    if batch is None:
                        return
                    for job in batch:
                        w = sched.route(job.spec.bucket().key(), workers)
                        w.note(job.spec.bucket().key())
                        cache.get(job.key, count_miss=False)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        subs = [threading.Thread(target=submitter, args=(t,), daemon=True)
                for t in range(n_sub)]
        cons = [threading.Thread(target=consumer, daemon=True)
                for _ in range(2)]
        for t in cons + subs:
            t.start()
        deadline = time.monotonic() + 60.0      # the watchdog
        _join_all(subs, deadline)
        queue.close()
        _join_all(cons, deadline)
        assert not errors, errors
        assert sum(w._n for w in workers) == n_sub * per_thread

        rec.assert_acyclic()                    # observed graph alone
        observed, static = _assert_consistent_with_static(rec)
        assert observed, "recorder saw no nested acquisitions"
        # every observed lock is one the static pass declares
        sites, _ = _static()
        assert {a for a, _ in observed} | {b for _, b in observed} <= \
            set(sites.values())


@pytest.mark.usefixtures("port_lock_order")
def test_lock_order_stress_consensus_service_cpu(monkeypatch):
    """A ConsensusService on the CPU (two workers, batches of up to four)
    fed by submitter threads under the recorder: every job finishes, the
    drain returns within its deadline, and the observed graph, the
    queue -> worker edges the static pass cannot see among it, composes
    with the static one."""
    from fastconsensus_tpu_torch.serve.shaping import ShapingConfig

    with tlock.recording() as rec:
        from fastconsensus_tpu_torch.obs import counters as obs_counters
        from fastconsensus_tpu_torch.serve.server import (ConsensusService,
                                                          ServeConfig)

        monkeypatch.setattr(obs_counters, "_REGISTRY",
                            obs_counters.ObsRegistry())
        service = ConsensusService(ServeConfig(
            device="cpu", devices=2, queue_depth=64, max_batch=4,
            cache_entries=64, pin_sizing=False,
            shaping=ShapingConfig(shed=False))).start()
        edges_a, edges_b = _ring(40, 40), _ring(100, 60)
        errors, jobs = [], []
        jobs_lock = threading.Lock()

        def submitter(tid):
            try:
                for i in range(2):
                    big = tid % 2 == 0
                    job = service.submit(_spec(edges_b if big else edges_a,
                                               100 if big else 40,
                                               seed=tid * 100 + i))
                    with jobs_lock:
                        jobs.append(job)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        subs = [threading.Thread(target=submitter, args=(t,), daemon=True)
                for t in range(4)]
        try:
            for t in subs:
                t.start()
            _join_all(subs, time.monotonic() + 30.0)
            assert not errors, errors
        finally:
            drained = service.drain(timeout=90.0)
        assert drained, "pool drain watchdog expired (deadlock?)"
        bad = [(j.job_id, j.state, j.error) for j in jobs
               if j.state != "done"]
        assert len(jobs) == 8 and not bad, bad

        rec.assert_acyclic()
        observed, static = _assert_consistent_with_static(rec)
        # the queue reaches the workers' deques through a stored callable
        hidden = ("fastconsensus_tpu_torch.serve.queue.AdmissionQueue._cond",
                  "fastconsensus_tpu_torch.serve.pool._Worker._cond")
        assert hidden in observed and hidden not in static, observed


def test_forced_inversion_is_caught():
    """Two instances of one lock site taken nested (the
    two-workers-in-opposite-orders hazard), an inversion between two
    sites, and an observed edge against a static one: each is a cycle."""
    from fastconsensus_tpu_torch.serve.cache import ResultCache
    from fastconsensus_tpu_torch.serve.queue import AdmissionQueue

    with tlock.recording() as rec:
        a, b = ResultCache(), ResultCache()
        with a._lock:
            with b._lock:
                pass
    with pytest.raises(AssertionError, match="lock-order cycle"):
        rec.assert_acyclic()

    with tlock.recording() as rec:
        cache, queue = ResultCache(), AdmissionQueue(max_depth=4)
        with cache._lock:
            with queue._cond:
                pass
        rec.assert_acyclic()                    # one order alone is fine
        with queue._cond:
            with cache._lock:
                pass
    with pytest.raises(AssertionError, match="lock-order cycle"):
        rec.assert_acyclic()

    sites, static = _static()
    assert ("fastconsensus_tpu_torch.serve.cache.ResultCache._spill_lock",
            "fastconsensus_tpu_torch.serve.cache.ResultCache._lock") \
        in static
    with tlock.recording() as rec:
        cache = ResultCache()
        with cache._lock:                       # against the static order
            with cache._spill_lock:
                pass
    rec.assert_acyclic()
    with pytest.raises(AssertionError, match="lock-order cycle"):
        rec.assert_acyclic(extra_edges=static, sites=sites)


def test_port_and_reference_recorders_side_by_side():
    """The reference's recorder installed first (as FCTPU_LOCK_ORDER=1
    does under its test configuration), the port's on top: each tree's
    locks, made under its own recorder, record into that recorder only,
    and the factories unwind in order."""
    from fastconsensus_tpu.serve.cache import ResultCache as JCache
    from fastconsensus_tpu_torch.serve.cache import ResultCache as TCache

    real = (threading.Lock, threading.RLock, threading.Condition)
    assert tlock._REAL == {"Lock": _thread.allocate_lock,
                           "RLock": _thread.RLock}
    with jlock.recording() as jrec:
        jcache = JCache()
        ref_factories = (threading.Lock, threading.RLock,
                         threading.Condition)
        with tlock.recording() as trec:
            tcache = TCache()
            # the port's own lock is real under both patches
            assert type(tlock._REAL["Lock"]()) is type(_thread.allocate_lock())
            for cache in (tcache, jcache):
                with cache._spill_lock:
                    with cache._lock:
                        pass
        assert (threading.Lock, threading.RLock, threading.Condition) == \
            ref_factories
    assert (threading.Lock, threading.RLock, threading.Condition) == real

    t_files = {f for edge in trec.edges() for f, _ in edge}
    j_files = {f for edge in jrec.edges() for f, _ in edge}
    assert t_files == {os.path.join(PKG, "serve", "cache.py")}
    assert j_files == {os.path.join(REF_PKG, "serve", "cache.py")}
    # and the port's edge maps onto its static key
    sites, static = _static()
    assert trec.named_edges(sites) == {(
        "fastconsensus_tpu_torch.serve.cache.ResultCache._spill_lock",
        "fastconsensus_tpu_torch.serve.cache.ResultCache._lock")}
    trec.assert_acyclic(extra_edges=static, sites=sites)


def test_lock_order_env_hook_unset_installs_nothing(monkeypatch):
    """``maybe_install_from_env`` with FCTPU_LOCK_ORDER unset (or not
    "1"): None, and the factories are the ones found."""
    before = (threading.Lock, threading.RLock, threading.Condition)
    for value in (None, "0", "yes"):
        if value is None:
            monkeypatch.delenv("FCTPU_LOCK_ORDER", raising=False)
        else:
            monkeypatch.setenv("FCTPU_LOCK_ORDER", value)
        assert tlock.maybe_install_from_env() is None
        assert tlock._prev is None and tlock._recorder is None
        assert (threading.Lock, threading.RLock,
                threading.Condition) == before


def test_lock_order_env_hook_installs_beside_the_reference(monkeypatch):
    """FCTPU_LOCK_ORDER=1: the port's recorder installs on top of the
    reference's (which the reference's conftest installs from the same
    variable), records the port's locks only, and uninstalls back to the
    reference's factories, which unwind to the real ones."""
    from fastconsensus_tpu_torch.serve.cache import ResultCache as TCache

    monkeypatch.setenv("FCTPU_LOCK_ORDER", "1")
    real = (threading.Lock, threading.RLock, threading.Condition)
    with jlock.recording():
        ref = (threading.Lock, threading.RLock, threading.Condition)
        trec = tlock.maybe_install_from_env()
        try:
            assert trec is not None and trec is tlock._recorder
            assert threading.Lock is tlock._OURS["Lock"]
            tcache = TCache()
            with tcache._spill_lock:
                with tcache._lock:
                    pass
        finally:
            tlock.uninstall()
        assert tlock._prev is None and tlock._recorder is None
        assert (threading.Lock, threading.RLock,
                threading.Condition) == ref
    assert (threading.Lock, threading.RLock, threading.Condition) == real
    sites, static = _static()
    assert trec.named_edges(sites) == {(
        "fastconsensus_tpu_torch.serve.cache.ResultCache._spill_lock",
        "fastconsensus_tpu_torch.serve.cache.ResultCache._lock")}
    trec.assert_acyclic(extra_edges=static, sites=sites)
