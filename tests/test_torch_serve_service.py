"""The serving tier's service paths, the PyTorch port against the JAX
reference on the CPU: a solo job (Louvain and LPM), a coalesced two-job
batch, and an fcdelta request.

The same numpy inputs go through the port's ``ConsensusService(device=
"cpu")`` and the reference's.  Tolerance: exact for partitions, rounds,
convergence, buckets and content hashes; the quality block's two float
metrics (agreement, modularity) are sums taken in another order than
JAX's, rtol 1e-5.  The delta request is held against the reference's
library path (``serve.delta`` + ``run_consensus(init_labels=,
active_mask=)``), not against its serving tests.
"""

import os
import subprocess
import sys
from collections import deque

import numpy as np
import pytest

from fastconsensus_tpu.consensus import ConsensusConfig as JConfig
from fastconsensus_tpu.consensus import run_consensus as jrun
from fastconsensus_tpu.models.registry import get_detector as jdetector
from fastconsensus_tpu.serve import bucketer as jb
from fastconsensus_tpu.serve import delta as jdelta
from fastconsensus_tpu.serve.jobs import Job as JJob
from fastconsensus_tpu.serve.jobs import JobSpec as JSpec
from fastconsensus_tpu.serve.server import ConsensusService as JService
from fastconsensus_tpu.serve.server import ServeConfig as JServeConfig
from fastconsensus_tpu_torch.consensus import ConsensusConfig
from fastconsensus_tpu_torch.serve.jobs import Job, JobSpec
from fastconsensus_tpu_torch.serve.server import (ConsensusService,
                                                  ServeConfig)
from fastconsensus_tpu_torch.serve.shaping import ShapingConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_SHED = ShapingConfig(shed=False)


def ring_graph(n, chords=0, shift=7):
    idx = np.arange(n)
    edges = [np.stack([idx, (idx + 1) % n], 1)]
    if chords:
        c = np.arange(chords)
        edges.append(np.stack([c % n, (c + shift) % n], 1))
    return np.concatenate(edges).astype(np.int64)


def specs(edges, n, **over):
    """The same request as a port spec and a reference spec."""
    kw = dict(algorithm="louvain", n_p=4, tau=0.2, delta=0.02,
              max_rounds=2, seed=0)
    kw.update(over)
    e = np.asarray(edges, dtype=np.int64)
    return (JobSpec(edges=e, n_nodes=n, config=ConsensusConfig(**kw)),
            JSpec(edges=e, n_nodes=n, config=JConfig(**kw)))


def port_service(**over):
    return ConsensusService(ServeConfig(device="cpu", pin_sizing=False,
                                        shaping=NO_SHED, **over))


def ref_service(**over):
    return JService(JServeConfig(pin_sizing=False, shaping=NO_SHED, **over))


def assert_same_result(t, j):
    for f in ("content_hash", "n_nodes", "rounds", "converged", "bucket"):
        assert t[f] == j[f], f
    assert len(t["partitions"]) == len(j["partitions"])
    for p, q in zip(t["partitions"], j["partitions"]):
        assert p.dtype == np.int32 and np.array_equal(p, np.asarray(q))
    tq, jq = t["quality"], j["quality"]
    assert set(tq) == set(jq)
    for k in tq:
        if isinstance(jq[k], float):
            assert tq[k] == pytest.approx(jq[k], rel=1e-5), k
        elif isinstance(jq[k], list):
            assert np.allclose(tq[k], jq[k], rtol=1e-5), k
        else:
            assert tq[k] == jq[k], k
    for f in ("u", "v"):
        assert np.array_equal(t["graph"][f], j["graph"][f])
    assert t["config"] == j["config"]


@pytest.mark.parametrize("alg", ["louvain", "lpm"])
def test_solo_job_equals_the_reference_service(karate_edges, alg):
    """Through the port's pool (submit, one CPU worker) against the
    reference's run_spec: the same result payload."""
    edges, _, ids = karate_edges
    tau = {"louvain": 0.2, "lpm": 0.8}[alg]
    tspec, jspec = specs(edges, len(ids), algorithm=alg, tau=tau, seed=7)
    want = ref_service().run_spec(jspec)
    svc = port_service().start()
    try:
        job = svc.submit(tspec)
        assert job.key == jspec.content_hash()
        svc_wait([job])
    finally:
        assert svc.drain(60)
    assert job.state == "done", job.error
    got = job.result
    assert got["compiles"] == 0 and got["device"] == 0
    assert got["tier"] == "chip" and not got["cached"]
    assert_same_result(got, want)
    # a repeat is a submit-time cache hit: no queue slot, no device
    again = svc.submit(tspec)
    assert again.state == "done" and again.result["cached"]


def svc_wait(jobs, timeout=120.0):
    import time

    deadline = time.monotonic() + timeout
    for j in jobs:
        while j.state not in ("done", "failed"):
            assert time.monotonic() < deadline, j.describe()
            time.sleep(0.01)


def test_batch_equals_solo_runs_and_the_reference_batch():
    """Two same-bucket jobs coalesced into one batched call: each equals
    its solo run on the port and the reference's batch."""
    graphs = [(ring_graph(34, 40), 34), (ring_graph(40, 38, shift=5), 40)]
    pairs = [specs(e, n, seed=50 + i) for i, (e, n) in enumerate(graphs)]
    solo = [port_service().run_spec(t) for t, _ in pairs]
    svc = port_service(max_batch=2)
    tjobs = [Job(t) for t, _ in pairs]
    svc._drain_group(deque(tjobs))
    jsvc = ref_service(max_batch=2)
    jjobs = [JJob(j) for _, j in pairs]
    jsvc._drain_group(deque(jjobs))
    counters = svc._reg.counters()
    assert counters.get("serve.batch.fallback_solo", 0) == 0
    for tj, jj, s in zip(tjobs, jjobs, solo):
        assert tj.state == jj.state == "done", (tj.error, jj.error)
        assert tj.batch_size == jj.batch_size == 2
        assert tj.result["batch_id"] == tjobs[0].result["batch_id"]
        assert_same_result(tj.result, jj.result)
        for p, q in zip(tj.result["partitions"], s["partitions"]):
            assert np.array_equal(p, q)
        assert (tj.result["rounds"], tj.result["converged"]) == \
            (s["rounds"], s["converged"])


def test_delta_request_equals_the_reference_library_path(karate_edges):
    """A delta against a cached converged parent is served incremental;
    its partitions equal the reference's library path with the same
    decision: apply_delta/neighborhood_mask, the child padded to its
    bucket, run_consensus(init_labels=, active_mask=)."""
    edges, _, ids = karate_edges
    n = len(ids)
    tspec, jspec = specs(edges, n, max_rounds=16, seed=3)
    svc = port_service()
    parent = svc.run_spec(tspec)
    jparent = ref_service().run_spec(jspec)
    assert parent["converged"]
    assert_same_result(parent, jparent)
    payload = {"parent": parent["content_hash"],
               "adds": [[0, 9], [5, 30]], "removes": [[0, 1]]}
    job = svc.submit_delta(payload)
    assert job.spec.delta["mode"] == "incremental", job.spec.delta
    svc._drain_group(deque([job]))
    assert job.state == "done", job.error
    got = job.result
    # the reference's library path, from the same parent
    adds, removes = jdelta.parse_delta(payload, n)
    pg = jparent["graph"]
    cu, cv, cw = jdelta.apply_delta(pg["u"], pg["v"], pg["w"], n, adds,
                                    removes)
    slab, bucket = jb.pad_to_bucket(np.stack([cu, cv], 1), n, cw)
    n_pad = slab.n_nodes
    init = np.empty((4, n_pad), dtype=np.int32)
    init[:, :n] = np.stack(jparent["partitions"])
    init[:, n:] = np.arange(n, n_pad, dtype=np.int32)
    act = np.zeros(n_pad, dtype=bool)
    act[:n] = jdelta.neighborhood_mask(cu, cv, n, adds, removes)
    cfg = JConfig(**jparent["config"])
    want = jrun(slab, jdetector("louvain"), cfg, n_closure=bucket.n_closure,
                init_labels=init, active_mask=act)
    assert got["rounds"] == want.rounds
    assert got["converged"] == want.converged
    assert got["bucket"]["key"] == bucket.key()
    assert len(got["partitions"]) == len(want.partitions)
    for p, q in zip(got["partitions"], want.partitions):
        _, compact = np.unique(np.asarray(q)[:n], return_inverse=True)
        assert np.array_equal(p, compact.astype(np.int32))
    # frozen vertices keep their parent labels (up to renumbering)
    frozen = ~act[:n]
    for p, q in zip(got["partitions"], parent["partitions"]):
        pairs = set(zip(p[frozen].tolist(), q[frozen].tolist()))
        assert len(pairs) == len({a for a, _ in pairs})
    assert got["content_hash"] == jdelta.delta_cache_key(
        got["content_hash"].split(":")[0], parent["content_hash"])


def test_pin_sizing_sets_the_reference_env_default(monkeypatch):
    """The reference's member-splitting pin is set; its fused-block pin
    has no counterpart and is left alone."""
    monkeypatch.delenv("FCTPU_DETECT_CALL_MEMBERS", raising=False)
    monkeypatch.delenv("FCTPU_ROUNDS_BLOCK", raising=False)
    svc = ConsensusService(ServeConfig(device="cpu")).start()
    try:
        assert os.environ["FCTPU_DETECT_CALL_MEMBERS"] == "0"
        assert "FCTPU_ROUNDS_BLOCK" not in os.environ
    finally:
        assert svc.drain(30)


def test_server_without_cuda_exits_2_with_the_reason(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, "-m", "fastconsensus_tpu_torch.serve", "--port",
         "0"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 2, proc.stderr
    assert "CUDA is not available" in proc.stderr
    assert "--device cpu" in proc.stderr


def test_unported_mesh_tier_knobs_raise():
    """The footprint-derived ceiling (``--chip-max-edges auto``) and its
    budget (``--hbm-bytes``) need the memory model that is not ported
    yet: each exits 2 naming where it is scheduled, never ignored."""
    for flags in (["--chip-max-edges", "auto"],
                  ["--chip-max-edges", "4096", "--hbm-bytes", "1000000"]):
        proc = subprocess.run(
            [sys.executable, "-m", "fastconsensus_tpu_torch.serve",
             "--device", "cpu", "--huge-devices", "1"] + flags, cwd=REPO,
            capture_output=True, text=True, timeout=60)
        assert proc.returncode == 2
        assert "needs the footprint memory model" in proc.stderr
        assert "Queue 1 item 4" in proc.stderr
