"""The port's serving wire, against the reference's on the CPU.

* A live loopback port server after one real job (in a fresh process,
  as the reference's server for the same traffic): every field of
  ``/metricsz``, ``/healthz``, ``/status`` and ``/debugz/slowest`` is
  consumed by the port's typed client parsers (the reference's golden
  check, ``tests/test_wire_schema.py``), and the parsers run in a
  subprocess where ``torch`` and ``jax`` are both poisoned.
* The same traffic on a reference server: every block and field it
  emits is present on the port's, except the counters the port's
  docstrings list as having no counterpart.
* ``cli.py --server`` (torch and jax poisoned) against a port server
  subprocess writes the tree of the served computation byte for byte:
  the reference's ``run_spec`` result for the same request, written by
  the reference's ``write_partition_dirs``.  SIGTERM drains and spills
  the cache; a restart on the same ``--cache-file`` answers the repeat
  from the cache with 0 compiles and the same bytes.

Tolerance: exact.
"""

import filecmp
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
import urllib.request

import pytest
import torch

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KARATE = os.path.join(REPO, "examples", "karate_club.txt")

# Reference counters with no counterpart on the port (obs/__init__.py and
# analysis/recompile_guard.py): XLA executables, the fused round block
# and its readback.  The port reads its stats once a round instead
# (host_sync.round_stats).
NO_COUNTERPART = ("engine.setup_executables", "host_sync.block_stats",
                  "rounds_block.seconds")
# Build counters: present once a build ran.  The reference's fire when
# its job compiles; the port on the CPU builds no kernel, so its stay
# absent.
BUILD_COUNTERS = ("serve.xla_compiles", "serve.device.0.xla_compiles")


# One live server after one real job, in a fresh process so that its
# process-wide registries (counters, latency histograms) hold this
# traffic alone: argv is the package, the output path and the JSON of
# the ServeConfig fields.  The job's SLO target is an hour, which it
# cannot miss within the script's time limit: which ``serve.slo.*``
# counters exist (met or missed) then does not depend on how loaded the
# host is.
_SNAPSHOT = textwrap.dedent("""\
    import importlib
    import json
    import sys
    import threading

    pkg, out, cfg = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    server = importlib.import_module(pkg + ".serve.server")
    client_mod = importlib.import_module(pkg + ".serve.client")
    io = importlib.import_module(pkg + ".utils.io")
    edges, _, ids = io.read_edgelist(sys.argv[4])
    svc = server.ConsensusService(server.ServeConfig(
        queue_depth=4, pin_sizing=False, **cfg))
    httpd = server.make_http_server(svc, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    svc.start()
    client = client_mod.ServeClient(
        "http://127.0.0.1:%d" % httpd.server_address[1], timeout=30.0)
    sub = client.submit(edges=edges.tolist(), n_nodes=len(ids),
                        algorithm="lpm", n_p=4, delta=0.1, max_rounds=2,
                        seed=1, slo_target_ms=3_600_000.0)
    client.wait(sub["job_id"], timeout=300)
    snaps = {"healthz": client.healthz(), "metricsz": client.metricsz(),
             "status": client.status(sub["job_id"]),
             "slowest": client._request("/debugz/slowest")}
    httpd.shutdown()
    httpd.server_close()
    assert svc.drain(60)
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(snaps, fh)
    """)


def live_snapshots(pkg, tmp_path_factory, **cfg):
    out = tmp_path_factory.mktemp("wire") / f"{pkg}.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _SNAPSHOT, pkg, str(out), json.dumps(cfg),
         KARATE], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def port_snaps(tmp_path_factory):
    return live_snapshots("fastconsensus_tpu_torch", tmp_path_factory,
                          device="cpu")


@pytest.fixture(scope="module")
def ref_snaps(tmp_path_factory):
    return live_snapshots("fastconsensus_tpu", tmp_path_factory, devices=1)


def test_snapshots_carry_the_full_observability_surface(port_snaps):
    m = port_snaps["metricsz"]
    assert port_snaps["healthz"]["workers"]
    assert m["scope"] == "replica"
    assert m["latency"]["histograms"] and m["latency"]["slo"]
    assert m["fcobs"]["counters"]["serve.jobs.completed"] == 1
    assert m["devices"]["0"]["jobs"] == 1
    assert port_snaps["status"]["timing"] is not None
    assert port_snaps["status"]["quality"] is not None
    assert port_snaps["slowest"]["slowest"]


_VALIDATOR = textwrap.dedent("""\
    import json
    import sys

    sys.modules["torch"] = None   # any torch import now raises
    sys.modules["jax"] = None     # ...and any jax import

    snap_path, keys_path, repo = sys.argv[1:4]
    sys.path.insert(0, repo)
    with open(snap_path, encoding="utf-8") as fh:
        snaps = json.load(fh)
    with open(keys_path, encoding="utf-8") as fh:
        parser_keys = {k: set(v) for k, v in json.load(fh).items()}

    from fastconsensus_tpu_torch.serve import client as sc

    def field_for_field(cls_name, payload):
        extra = sorted(set(payload) - parser_keys[cls_name])
        assert not extra, f"{cls_name} drops live field(s) {extra}"

    h = snaps["healthz"]
    for w in h["workers"]:
        sc.WorkerState.from_payload(w)
        field_for_field("WorkerState", w)
    m = snaps["metricsz"]
    lat = m["latency"]
    for row in lat["histograms"]:
        sc.PhaseLatency.from_payload(row)
        field_for_field("PhaseLatency", row)
    for name, row in (lat.get("slo") or {}).items():
        sc.SloStats.from_payload(name, row)
        field_for_field("SloStats", row)
    shaping = m["shaping"]
    sc.ShapingStats.from_payload(shaping)
    field_for_field("ShapingStats", shaping)
    field_for_field("ShapingStats", shaping.get("counters") or {})
    st = snaps["status"]
    sc.JobTiming.from_payload(st["timing"])
    field_for_field("JobTiming", st["timing"])
    sc.JobQuality.from_payload(st["quality"])
    field_for_field("JobQuality", st["quality"])
    for row in snaps["slowest"]["slowest"]:
        sc.SlowJobExemplar.from_payload(row)
        field_for_field("SlowJobExemplar", row)
    assert "torch" not in [m for m in sys.modules if sys.modules[m]]
    print("wire schema golden: ok")
    """)


def test_typed_parsers_consume_live_payloads_torch_and_jax_free(
        port_snaps, tmp_path):
    from fastconsensus_tpu.analysis import contracts

    cpath = os.path.join(REPO, "fastconsensus_tpu_torch", "serve",
                         "client.py")
    with open(cpath, encoding="utf-8") as fh:
        facts = contracts._scan_module(cpath, fh.read())
    keys = {cls: sorted(k) for cls, (_, k) in facts.parsers.items()}
    assert {"WorkerState", "PhaseLatency", "SloStats", "ShapingStats",
            "JobTiming", "JobQuality", "SlowJobExemplar"} <= set(keys)
    snap_path = tmp_path / "snaps.json"
    snap_path.write_text(json.dumps(port_snaps))
    keys_path = tmp_path / "keys.json"
    keys_path.write_text(json.dumps(keys))
    proc = subprocess.run(
        [sys.executable, "-c", _VALIDATOR, str(snap_path), str(keys_path),
         REPO], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "wire schema golden: ok" in proc.stdout


def key_paths(d, pre=""):
    out = set()
    if isinstance(d, dict):
        for k, v in d.items():
            out.add(f"{pre}/{k}")
            out |= key_paths(v, f"{pre}/{k}")
    return out


@pytest.mark.parametrize("endpoint", ["healthz", "metricsz", "status",
                                      "slowest"])
def test_port_emits_every_reference_field(port_snaps, ref_snaps, endpoint):
    port, ref = key_paths(port_snaps[endpoint]), key_paths(ref_snaps[endpoint])
    missing = set()
    for path in ref - port:
        parts = path.split("/")
        if endpoint == "metricsz" and parts[1] == "fcobs" and \
                parts[3] in NO_COUNTERPART + BUILD_COUNTERS:
            continue
        # a cold job's (one that compiled) estimate falls back to the
        # static prior and says so; the port's CPU jobs are never cold
        if path.startswith("/shaping/estimates/") and \
                parts[-1] == "prior":
            continue
        missing.add(path)
    assert not missing, sorted(missing)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_server(tmp_path, port, cache):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "fastconsensus_tpu_torch.serve", "--device",
         "cpu", "--port", str(port), "--max-batch", "4", "--cache-file",
         str(cache)], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + 120
    while True:
        assert proc.poll() is None, proc.stdout.read()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                if json.loads(r.read())["ok"]:
                    return proc
        except OSError:
            pass
        assert time.monotonic() < deadline, "server never came up"
        time.sleep(0.2)


_THIN_CLI = textwrap.dedent("""\
    import runpy
    import sys

    sys.modules["torch"] = None
    sys.modules["jax"] = None
    sys.argv = ["cli"] + sys.argv[1:]
    runpy.run_module("fastconsensus_tpu_torch.cli", run_name="__main__")
    """)


def _thin_cli(tmp_path, url, out, alg):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", _THIN_CLI, "-f", KARATE, "-np", "20",
         "--alg", alg, "--server", url, "--out-dir", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not (cmp.left_only or cmp.right_only or cmp.diff_files), \
        (cmp.left_only, cmp.right_only, cmp.diff_files)
    for sub in cmp.common_dirs:
        _same_tree(os.path.join(a, sub), os.path.join(b, sub))
    for name in cmp.common_files:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def _reference_tree(out, alg, karate_edges):
    """What the server computes for the CLI's request, by the reference:
    its run_spec (the bucketed solo path), written as its CLI writes."""
    import numpy as np

    from fastconsensus_tpu.cli import DEFAULT_TAU
    from fastconsensus_tpu.consensus import ConsensusConfig
    from fastconsensus_tpu.serve.jobs import JobSpec
    from fastconsensus_tpu.serve.server import ConsensusService, ServeConfig
    from fastconsensus_tpu.utils.io import write_partition_dirs

    edges, _, ids = karate_edges
    tau = DEFAULT_TAU[alg]
    cfg = ConsensusConfig(algorithm=alg, n_p=20, tau=tau, delta=0.02,
                          max_rounds=64, seed=0)
    res = ConsensusService(ServeConfig(pin_sizing=False)).run_spec(
        JobSpec(edges=np.asarray(edges), n_nodes=len(ids), config=cfg))
    suffix = f"t{tau}_d0.02_np20"
    write_partition_dirs(os.path.join(out, f"out_partitions_{suffix}"),
                         os.path.join(out, f"memberships_{suffix}"),
                         res["partitions"], ids)


def test_cli_server_trees_and_a_cache_restart(tmp_path, karate_edges):
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    cache = tmp_path / "C.npz"
    proc = _start_server(tmp_path, port, cache)
    try:
        for alg in ("louvain", "lpm"):
            run = _thin_cli(tmp_path, url, tmp_path / f"served_{alg}", alg)
            assert run.returncode == 0, run.stderr
            assert "served from bucket n64_e96" in run.stderr
            _reference_tree(tmp_path / f"ref_{alg}", alg, karate_edges)
            _same_tree(tmp_path / f"served_{alg}", tmp_path / f"ref_{alg}")
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out
    assert "drained cleanly" in out and cache.exists()
    proc = _start_server(tmp_path, port, cache)
    try:
        again = _thin_cli(tmp_path, url, tmp_path / "again", "louvain")
        assert again.returncode == 0, again.stderr
        assert "served from cache, 0 compiles" in again.stderr
        _same_tree(tmp_path / "again", tmp_path / "served_louvain")
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=120)
    assert proc.returncode == 0
