"""The serving tier's mesh group (the "huge" tier) on the port, on the
CPU: ``MeshWorker``, the pool's routing past ``chip_max_edges``, the
server's solo-only dispatch on it and the serve CLI's flags.

A ``device="cpu"`` service with ``devices=4`` runs four workers sharing
the host, the last ``huge_devices`` of them as one mesh group, as the
reference's tests run its pool on 8 forced CPU devices.  Tolerance:
exact (partitions, tiers, routes, exit codes and messages).
"""

import json
import re
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from fastconsensus_tpu.consensus import ConsensusConfig as JConfig
from fastconsensus_tpu.serve.jobs import JobSpec as JSpec
from fastconsensus_tpu.serve.server import ConsensusService as JService
from fastconsensus_tpu.serve.server import ServeConfig as JServeConfig
from fastconsensus_tpu_torch.consensus import ConsensusConfig, run_consensus
from fastconsensus_tpu_torch.models.registry import get_detector
from fastconsensus_tpu_torch.serve import bucketer
from fastconsensus_tpu_torch.serve.__main__ import main as serve_main
from fastconsensus_tpu_torch.serve.jobs import JobSpec
from fastconsensus_tpu_torch.serve.server import (ConsensusService,
                                                  ServeConfig,
                                                  validate_warm_specs)
from fastconsensus_tpu_torch.serve.shaping import ShapingConfig, \
    TrafficShaper

REPO = Path(__file__).resolve().parent.parent
NO_SHED = ShapingConfig(shed=False)
HUGE = dict(queue_depth=8, pin_sizing=False, devices=4, huge_devices=2,
            chip_max_edges=96)


def ring_graph(n, chords=0, shift=7):
    idx = np.arange(n)
    edges = [np.stack([idx, (idx + 1) % n], 1)]
    if chords:
        c = np.arange(chords)
        edges.append(np.stack([c % n, (c + shift) % n], 1))
    return np.concatenate(edges).astype(np.int64)


def config_kw(**over):
    kw = dict(algorithm="louvain", n_p=4, tau=0.2, delta=0.02,
              max_rounds=2, seed=0)
    kw.update(over)
    return kw


def wait(jobs, timeout=180.0):
    deadline = time.monotonic() + timeout
    for j in jobs:
        while j.state not in ("done", "failed"):
            assert time.monotonic() < deadline, j.describe()
            time.sleep(0.02)


def compact(raw, n):
    _, c = np.unique(np.asarray(raw)[:n], return_inverse=True)
    return c.astype(np.int32)


def test_huge_bucket_routes_to_mesh_and_matches_solo_bitwise():
    """The reference's test of the same name, on the port: a graph past
    the single-chip bucket ceiling runs edge-sharded on the reserved
    mesh group, with partitions equal to the unsharded run's."""
    edges = ring_graph(100, chords=60)   # 160 canonical edges: n128_e192
    kw = config_kw(seed=5, closure_sampler="scatter")
    spec = JobSpec(edges=edges, n_nodes=100, config=ConsensusConfig(**kw))
    assert spec.bucket().key() == "n128_e192"
    svc = ConsensusService(ServeConfig(device="cpu", shaping=NO_SHED,
                                       **HUGE)).start()
    try:
        job = svc.submit(spec)
        small = svc.submit(JobSpec(edges=ring_graph(30), n_nodes=30,
                                   config=ConsensusConfig(**kw)))
        wait([job, small])
        assert job.state == "done", job.error
        assert job.result["tier"] == "mesh"
        assert small.result["tier"] == "chip" and small.device in (0, 1)
        mesh_worker = svc.pool.mesh_workers[0]
        assert job.device == mesh_worker.idx == 2
        assert len(mesh_worker.devices) == 2
        assert mesh_worker.mesh.shape == {"p": 1, "e": 2}
        wstats = [w for w in svc.stats()["workers"] if w["kind"] == "mesh"]
        assert wstats and wstats[0]["buckets"] == {"n128_e192": 1}
        assert wstats[0]["mesh_devices"] == [2, 3]
        assert len(svc.pool.chip_workers) == 2
    finally:
        assert svc.drain(120)
    slab, bucket = bucketer.pad_to_bucket(edges, 100, device="cpu")
    ref = run_consensus(slab, get_detector("louvain"), spec.config,
                        n_closure=bucket.n_closure)
    assert job.result["rounds"] == ref.rounds
    for served, raw in zip(job.result["partitions"], ref.partitions):
        np.testing.assert_array_equal(served, compact(raw, 100))


def test_chip_ceiling_requires_huge_tier():
    svc = ConsensusService(ServeConfig(device="cpu", pin_sizing=False,
                                       devices=4, chip_max_edges=96))
    with pytest.raises(ValueError, match="chip_max_edges needs a huge "
                                         "tier: set huge_devices >= 1"):
        svc.start()
    # ...and the mirror: a huge tier with no ceiling is unreachable
    svc = ConsensusService(ServeConfig(device="cpu", pin_sizing=False,
                                       devices=4, huge_devices=2))
    with pytest.raises(ValueError, match="huge_devices reserves a mesh "
                                         "group nothing can reach"):
        svc.start()
    # a group must leave a serving chip: one device (the one-GPU case)
    # cannot hold a huge tier beside it
    for devices, huge in ((1, 1), (4, 4), (4, -1)):
        svc = ConsensusService(ServeConfig(
            device="cpu", pin_sizing=False, devices=devices,
            huge_devices=huge, chip_max_edges=96))
        with pytest.raises(ValueError, match=f"huge_devices={huge} must "
                                             f"leave at least one serving "
                                             f"chip \\(devices={devices}\\)"):
            svc.start()


def test_config_errors_match_the_reference():
    """Each refusal of the pool and of the warm-spec check carries the
    reference's words (its service on the suite's 8 CPU devices)."""
    cases = [dict(devices=4, chip_max_edges=96),
             dict(devices=4, huge_devices=2),
             dict(devices=4, huge_devices=4, chip_max_edges=96),
             dict(devices=4, huge_devices=2, chip_max_edges=96,
                  prewarm=("n128_e192",))]
    for over in cases:
        errs = []
        for svc in (ConsensusService(ServeConfig(device="cpu",
                                                 pin_sizing=False, **over)),
                    JService(JServeConfig(pin_sizing=False, **over))):
            with pytest.raises(ValueError) as err:
                svc.start()
            errs.append(str(err.value))
        if "prewarm" in over:
            # the tail names what each package would have warmed
            assert errs[0].split("; its traffic")[0] == \
                errs[1].split("; its traffic")[0]
        else:
            assert errs[0] == errs[1], over


def test_served_mesh_partitions_equal_the_reference_service():
    edges = ring_graph(100, chords=60)
    kw = config_kw(seed=3)
    results = []
    for svc, spec in (
            (ConsensusService(ServeConfig(device="cpu", shaping=NO_SHED,
                                          **HUGE)),
             JobSpec(edges=edges, n_nodes=100,
                     config=ConsensusConfig(**kw))),
            (JService(JServeConfig(shaping=NO_SHED, **HUGE)),
             JSpec(edges=edges, n_nodes=100, config=JConfig(**kw)))):
        svc.start()
        try:
            job = svc.submit(spec)
            wait([job])
            assert job.state == "done", job.error
            results.append(job.result)
        finally:
            assert svc.drain(120)
    t, j = results
    assert t["tier"] == j["tier"] == "mesh"
    for f in ("content_hash", "rounds", "converged", "bucket", "device"):
        assert t[f] == j[f], f
    for p, q in zip(t["partitions"], j["partitions"]):
        np.testing.assert_array_equal(p, np.asarray(q))


def test_mesh_worker_runs_solo_and_warms_solo():
    """Two same-bucket huge jobs never batch on the mesh worker, a warm
    spec for a huge bucket is refused at start, and the shaper never
    holds a huge bucket."""
    cfg = ServeConfig(device="cpu", shaping=NO_SHED, max_batch=4, **HUGE)
    with pytest.raises(ValueError, match="exceeds the single-chip "
                                         "ceiling"):
        validate_warm_specs(ServeConfig(prewarm=("n128_e192",),
                                        chip_max_edges=96))
    svc = ConsensusService(cfg).start()
    try:
        edges = ring_graph(100, chords=60)
        jobs = [svc.submit(JobSpec(edges=edges, n_nodes=100,
                                   config=ConsensusConfig(**config_kw(
                                       seed=s)))) for s in (1, 2)]
        wait(jobs)
        assert all(j.state == "done" and j.result["tier"] == "mesh"
                   for j in jobs)
        assert all(j.result.get("batch_size") is None for j in jobs)
        assert svc.shaper.runs_solo("n128_e192")
        assert not svc.shaper.runs_solo("n64_e96")
        hold = svc.shaper.hold_decision("n128_e192", have=1, max_b=4,
                                        slack_s=10.0)
        assert (hold.hold_s, hold.reason) == (0.0, "solo_tier")
    finally:
        assert svc.drain(120)
    shaper = TrafficShaper(ShapingConfig())
    assert not shaper.runs_solo("n128_e192")
    hold = shaper.hold_decision("n64_e96", have=1, max_b=4, slack_s=10.0,
                                blocks_solo=True)
    assert (hold.hold_s, hold.reason) == (0.0, "blocks_solo_tier")


def test_huge_delta_falls_back_to_a_full_run():
    from fastconsensus_tpu_torch.serve.delta import DeltaPolicy

    d = DeltaPolicy().decide(1, 160, {"partitions": [0] * 4,
                                      "converged": True},
                             ConsensusConfig(n_p=4), "n128_e192",
                             "n128_e192", True, huge=True)
    assert d.mode == "fallback" and d.reason == "huge_tier"


@pytest.mark.parametrize("argv,words", [
    (["--chip-max-edges", "96"], "--chip-max-edges needs --huge-devices"),
    (["--huge-devices", "1"], "--huge-devices without --chip-max-edges"),
    (["--huge-devices", "1", "--chip-max-edges", "lots"],
     "--chip-max-edges 'lots': expected an integer or 'auto'"),
    (["--huge-devices", "1", "--chip-max-edges", "auto"],
     "--chip-max-edges auto needs the footprint memory model"),
    (["--huge-devices", "1", "--chip-max-edges", "96", "--hbm-bytes",
      "1000000"], "--hbm-bytes needs the footprint memory model"),
    (["--device", "cpu", "--devices", "1", "--huge-devices", "1",
      "--chip-max-edges", "96"], "must leave at least one serving chip"),
])
def test_serve_cli_mesh_flags_exit_2(capsys, argv, words):
    assert serve_main(argv + ["--port", "0", "--quiet"]) == 2
    assert words in capsys.readouterr().err


def test_serve_cli_starts_a_mesh_group():
    proc = subprocess.Popen(
        [sys.executable, "-m", "fastconsensus_tpu_torch.serve", "--device",
         "cpu", "--devices", "3", "--huge-devices", "2",
         "--chip-max-edges", "96", "--port", "0"],
        cwd=REPO, stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stderr.readline()
            lines.append(line)
            if "listening on" in line or not line:
                break
        assert any("worker pool: 1 chip worker(s) + 1 mesh group of 2 "
                   "device(s) (huge tier, bucket ceiling 96 edges) on cpu"
                   in ln for ln in lines), lines
        # /healthz answers once the server serves, after its SIGTERM
        # handler is installed
        url = re.search(r"listening on (http://\S+)", lines[-1]).group(1)
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            workers = json.load(r)["workers"]
        assert [w["kind"] for w in workers] == ["chip", "mesh"]
        assert workers[1]["mesh_devices"] == [1, 2]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
