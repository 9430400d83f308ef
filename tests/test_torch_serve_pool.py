"""fcpool on the port: sticky routing, failure isolation and backpressure
with k CPU workers (the CPU stand-in for k GPUs), as the reference's
``tests/test_pool.py`` holds its pool on fake XLA devices.

A worker is killed through ``serve/faultinject.py`` sites that name the
port's modules.  Tolerance: exact (device tags, states, counters).
"""

import threading
import time

import numpy as np
import pytest
import torch

from fastconsensus_tpu_torch.consensus import ConsensusConfig
from fastconsensus_tpu_torch.obs import counters as obs_counters
from fastconsensus_tpu_torch.serve import faultinject
from fastconsensus_tpu_torch.serve.jobs import JobSpec
from fastconsensus_tpu_torch.serve.queue import QueueFull
from fastconsensus_tpu_torch.serve.server import (ConsensusService,
                                                  ServeConfig)
from fastconsensus_tpu_torch.serve.shaping import ShapingConfig

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)


def ring_graph(n, chords=0, shift=7):
    idx = np.arange(n)
    edges = [np.stack([idx, (idx + 1) % n], 1)]
    if chords:
        c = np.arange(chords)
        edges.append(np.stack([c % n, (c + shift) % n], 1))
    return np.concatenate(edges).astype(np.int64)


def spec(edges, n_nodes, **over):
    kw = dict(algorithm="louvain", n_p=4, tau=0.2, delta=0.02,
              max_rounds=2, seed=0)
    kw.update(over)
    return JobSpec(edges=np.asarray(edges, dtype=np.int64),
                   n_nodes=n_nodes, config=ConsensusConfig(**kw))


def service(**over):
    cfg = dict(device="cpu", pin_sizing=False, queue_depth=16,
               shaping=ShapingConfig(shed=False))
    cfg.update(over)
    return ConsensusService(ServeConfig(**cfg)).start()


def wait(jobs, timeout=120.0):
    deadline = time.monotonic() + timeout
    for j in jobs:
        while j.state not in ("done", "failed"):
            assert time.monotonic() < deadline, j.describe()
            time.sleep(0.01)


@pytest.fixture
def heal_faults():
    yield
    faultinject.uninstall_all()


def test_cpu_workers_share_the_host_and_a_burst_lands_on_one():
    svc = service(devices=4)
    base = obs_counters.get_registry().counters()
    try:
        assert [w.device.type for w in svc.pool.workers] == ["cpu"] * 4
        assert [w.idx for w in svc.pool.workers] == [0, 1, 2, 3]
        jobs = [svc.submit(spec(ring_graph(40, 40), 40, seed=s))
                for s in range(1, 5)]
        wait(jobs)
        assert all(j.state == "done" for j in jobs), [j.error for j in jobs]
        homes = {j.device for j in jobs}
        assert len(homes) == 1, [j.describe() for j in jobs]
        home = homes.pop()
        assert svc.stats()["affinity"] == {"n64_e96": home}
        since = obs_counters.get_registry().counters_since(base)
        # the CPU builds no kernel: every worker's build count stays 0
        for w in svc.pool.workers:
            assert since.get(f"serve.device.{w.idx}.xla_compiles", 0) == 0
        devices = svc.device_stats()
        assert sum(d["jobs"] for d in devices.values()) == 4
        assert devices[str(home)]["jobs"] == 4
    finally:
        assert svc.drain(60)


def test_worker_killed_by_a_fault_requeues_with_exclusion_and_cordons(
        heal_faults):
    svc = service(devices=2)
    base = obs_counters.get_registry().counters()
    faultinject.install(
        "fastconsensus_tpu_torch.serve.pool:_Worker._run:RuntimeError",
        count=1)
    try:
        job = svc.submit(spec(ring_graph(12, 6), 12, seed=3))
        wait([job])
        assert job.state == "done", job.error
        assert job.device == 1 and job.excluded() == frozenset({0})
        assert job.describe()["requeues"] == 1
        stats = svc.stats()
        assert stats["cordoned_devices"] == [0]
        dead = next(w for w in stats["workers"] if w["device"] == 0)
        assert dead["cordoned"] and "fault injected" in dead["error"]
        since = obs_counters.get_registry().counters_since(base)
        assert since.get("serve.pool.worker_deaths", 0) == 1
        assert since.get("serve.device.0.deaths", 0) == 1
        assert since.get("serve.pool.requeued_jobs", 0) == 1
    finally:
        assert svc.drain(60)


def test_kernel_build_failure_fails_its_job_and_cordons_the_worker(
        heal_faults):
    """No fallback hides a kernel: the job whose kernels cannot build
    fails as itself, and its worker takes no more work."""
    svc = service(devices=2)
    faultinject.install(
        "fastconsensus_tpu_torch.serve.server:ConsensusService.run_spec:"
        "KernelBuildError", count=1)
    try:
        bad = svc.submit(spec(ring_graph(12, 6), 12, seed=5))
        wait([bad])
        assert bad.state == "failed"
        assert bad.error.startswith("KernelBuildError: fault injected")
        assert bad.describe()["requeues"] == 0
        assert svc.stats()["cordoned_devices"] == [0]
        good = svc.submit(spec(ring_graph(12, 6), 12, seed=6))
        wait([good])
        assert good.state == "done" and good.device == 1, good.error
    finally:
        assert svc.drain(60)


def test_job_that_cordons_every_worker_fails_as_itself(heal_faults):
    svc = service(devices=1)
    faultinject.install(
        "fastconsensus_tpu_torch.serve.pool:_Worker._run:RuntimeError",
        count=-1)
    try:
        job = svc.submit(spec(ring_graph(12, 6), 12, seed=4))
        wait([job])
        assert job.state == "failed"
        assert "no eligible worker" in job.error
    finally:
        svc.drain(30)


def test_backpressure_counts_worker_backlogs():
    """Jobs the dispatcher already moved into worker deques still count
    against the queue's depth bound."""
    svc = service(devices=2, queue_depth=1)
    entered, release = threading.Event(), threading.Event()
    for w in svc.pool.workers:
        orig = w._run

        def slow(batch, _orig=orig):
            entered.set()
            release.wait()
            _orig(batch)

        w._run = slow
    try:
        j1 = svc.submit(spec(ring_graph(40, 40), 40, seed=11))
        assert entered.wait(60), "no worker picked up the first job"
        j2 = svc.submit(spec(ring_graph(40, 40), 40, seed=12))
        deadline = time.monotonic() + 30
        while svc.pool.backlog() < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        with pytest.raises(QueueFull):
            svc.submit(spec(ring_graph(40, 40), 40, seed=13))
    finally:
        release.set()
        wait([j1, j2])
        assert svc.drain(60)
    assert j1.state == j2.state == "done", (j1.error, j2.error)


def test_busy_worker_recoalesces_a_deque_burst_into_one_batch():
    svc = service(devices=1, max_batch=4,
                  shaping=ShapingConfig(hold=False, shed=False))
    w = svc.pool.workers[0]
    entered, release = threading.Event(), threading.Event()
    orig = w._run

    def slow(batch):
        entered.set()
        release.wait()
        orig(batch)

    w._run = slow
    base = obs_counters.get_registry().counters()
    try:
        stall = svc.submit(spec(ring_graph(40, 40), 40, n_p=8, seed=90))
        assert entered.wait(60)
        burst = []
        for k, s in enumerate((91, 92, 93, 94), start=1):
            burst.append(svc.submit(spec(ring_graph(40, 40), 40, seed=s)))
            deadline = time.monotonic() + 30
            while svc.pool.backlog() < k:
                assert time.monotonic() < deadline
                time.sleep(0.005)
    finally:
        release.set()
    try:
        wait([stall] + burst)
        assert all(j.state == "done" for j in [stall] + burst)
        assert len({j.batch_id for j in burst}) == 1
        assert all(j.batch_size == 4 for j in burst)
        since = obs_counters.get_registry().counters_since(base)
        assert since.get("serve.pool.deque_coalesced", 0) == 3
        assert since.get("serve.batch.fallback_solo", 0) == 0
    finally:
        assert svc.drain(120)
