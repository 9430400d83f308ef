"""The device mesh of the PyTorch port (``parallel/``,
``ops/sharded_tail.py``, ``run_consensus(mesh=)``) on the CPU: against
the JAX reference on its 8-device virtual CPU mesh (``tests/conftest.py``)
and against the port's own unsharded run.

The port's mesh is a grid of ``torch.device("cpu")`` entries here, as the
reference's is 8 forced CPU devices.  Tolerance: exact for the slab,
partitions, rounds and every integer stat; the two float quality stats
(``agreement``, ``member_modularity``) sum in shard order and in another
order than JAX's, rtol 1e-5.
"""

import functools
import json
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastconsensus_tpu import parallel as jpar
from fastconsensus_tpu.consensus import ConsensusConfig as JConfig
from fastconsensus_tpu.consensus import run_consensus as jrun
from fastconsensus_tpu.graph import pack_edges as jpack
from fastconsensus_tpu.models.registry import get_detector as jdetector
from fastconsensus_tpu.ops import sharded_tail as jstail
from fastconsensus_tpu.utils.synth import planted_partition
from fastconsensus_tpu_torch import interop, parallel
from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                               _cache_fingerprint,
                                               run_consensus)
from fastconsensus_tpu_torch.engine import consensus_tail
from fastconsensus_tpu_torch.graph import pack_edges
from fastconsensus_tpu_torch.models.registry import get_detector
from fastconsensus_tpu_torch.obs import counters as obs_counters
from fastconsensus_tpu_torch.ops.sharded_tail import sharded_consensus_tail

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU8 = [torch.device("cpu")] * 8
INT_FIELDS = ("converged", "n_alive", "n_unconverged", "n_closure_added",
              "n_repaired", "n_dropped", "n_overflow", "n_hub_overflow",
              "n_agg_overflow", "cold", "n_w_zero", "n_w_full",
              "n_frontier", "labels_changed")
FLOAT_FIELDS = ("agreement", "member_modularity")


def port_slab(js):
    return interop.slab_from_arrays(
        np.asarray(js.src), np.asarray(js.dst), np.asarray(js.weight),
        np.asarray(js.alive), n_nodes=js.n_nodes, d_cap=js.d_cap,
        cap_hint=js.cap_hint, d_hyb=js.d_hyb, hub_cap=js.hub_cap,
        agg_cap=js.agg_cap, device="cpu")


def cpu_mesh(p, e):
    return parallel.make_mesh(ensemble=p, edge=e, devices=CPU8)


def hybrid_graph(n=2000):
    """Planted communities plus grafted hubs (carries hybrid sizing)."""
    rng = np.random.default_rng(11)
    edges, _ = planted_partition(n, 10, 0.06, 0.0008, seed=4)
    hubs = rng.choice(n, 8, replace=False)
    extra = np.array([[h, int(o)] for h in hubs
                      for o in rng.choice(n, 120, replace=False)
                      if int(o) != h])
    return np.vstack([edges, extra])


def assert_same_runs(a, b):
    """Two port runs: equal partitions, rounds, integer history and the
    slab over the shorter capacity (the rest dead)."""
    assert a.rounds == b.rounds and a.converged == b.converged
    np.testing.assert_array_equal(np.stack(a.partitions),
                                  np.stack(b.partitions))
    for x, y in zip(a.history, b.history):
        for k in ("n_alive", "n_unconverged", "n_closure_added",
                  "n_repaired", "n_dropped", "n_overflow", "n_hub_overflow",
                  "n_agg_overflow", "n_w_zero", "n_w_full", "n_frontier",
                  "labels_changed_by_member", "cold"):
            assert x[k] == y[k], k
    c = min(a.graph.capacity, b.graph.capacity)
    for name in ("src", "dst", "weight", "alive"):
        assert torch.equal(getattr(a.graph, name)[:c],
                           getattr(b.graph, name)[:c]), name
    for g in (a.graph, b.graph):
        assert not g.alive[c:].any()


# -- (a) the layout against the reference --------------------------------


@pytest.mark.parametrize("ensemble,edge", [(None, 1), (None, 2), (2, 4),
                                           (8, 1), (1, 4), (3, 2)])
def test_make_mesh_shapes_match_reference(ensemble, edge):
    jm = jpar.make_mesh(ensemble=ensemble, edge=edge)
    tm = parallel.make_mesh(ensemble=ensemble, edge=edge, devices=CPU8)
    assert dict(tm.shape) == dict(jm.shape)
    assert tuple(tm.shape) == tuple(jm.axis_names)
    for p in (1, 3, 8, 9, 17):
        assert parallel.pad_n_p(p, tm) == jpar.pad_n_p(p, jm)


@pytest.mark.parametrize("ensemble,edge", [(8, 2), (None, 3), (5, 2)])
def test_make_mesh_refusals_match_reference(ensemble, edge):
    with pytest.raises(ValueError) as jerr:
        jpar.make_mesh(ensemble=ensemble, edge=edge)
    with pytest.raises(ValueError) as terr:
        parallel.make_mesh(ensemble=ensemble, edge=edge, devices=CPU8)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("edge", [1, 2, 4, 8])
def test_shard_slab_matches_reference(karate_slab, edge):
    jm = jpar.make_mesh(ensemble=8 // edge, edge=edge)
    js = jpar.shard_slab(karate_slab, jm)
    ts = parallel.shard_slab(port_slab(karate_slab), cpu_mesh(8 // edge,
                                                              edge))
    assert ts.capacity == js.capacity and ts.capacity % edge == 0
    assert len(ts.chunks) == edge
    cap_l = ts.capacity // edge
    for s, chunk in enumerate(ts.chunks):
        assert chunk.capacity == cap_l
        for f in ("n_nodes", "d_cap", "cap_hint", "d_hyb", "hub_cap",
                  "agg_cap"):
            assert getattr(chunk, f) == getattr(js, f), f
        for name in ("src", "dst", "weight", "alive"):
            np.testing.assert_array_equal(
                getattr(chunk, name).numpy(),
                np.asarray(getattr(js, name))[s * cap_l:(s + 1) * cap_l])
    assert int(ts.num_alive()) == int(js.num_alive())
    np.testing.assert_array_equal(ts.degrees().numpy(),
                                  np.asarray(js.degrees()))
    whole = parallel.gather_slab(ts)
    np.testing.assert_array_equal(whole.alive.numpy(), np.asarray(js.alive))


def test_keys_and_labels_split_along_the_ensemble_axis():
    mesh = cpu_mesh(4, 2)
    keys = torch.arange(16).reshape(8, 2)
    blocks = parallel.shard_keys(keys, mesh)
    assert [b.tolist() for b in blocks] == \
        [keys[2 * i:2 * i + 2].tolist() for i in range(4)]
    assert parallel.shard_labels(blocks, mesh) == blocks
    assert torch.equal(parallel.gather_labels(blocks), keys)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.shard_keys(keys[:6], mesh)
    reps = parallel.replicate_slab(parallel.shard_slab(
        pack_edges(np.array([[0, 1], [1, 2]]), 3, device="cpu"), mesh), mesh)
    assert len(reps) == 4 and all(r.src is reps[0].src for r in reps)


# -- (b) the sharded tail against the reference's ------------------------


@pytest.mark.parametrize("ensemble,edge", [(8, 1), (4, 2), (2, 4)])
@pytest.mark.parametrize("closure_tau", [None, 0.5])
def test_sharded_tail_matches_reference(karate_slab, ensemble, edge,
                                        closure_tau):
    n_p, n = 8, karate_slab.n_nodes
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 3, (n_p, n)).astype(np.int32)
    prev = rng.integers(0, 3, (n_p, n)).astype(np.int32)
    labels[:, 0] = np.arange(n_p) + 10   # isolates node 0: repair runs
    key = jax.random.key(9)
    js = karate_slab.with_weights(jnp.where(karate_slab.alive, 1.0, 0.0))
    jm = jpar.make_mesh(ensemble=ensemble, edge=edge)
    jslab, jst = jax.jit(functools.partial(
        jstail.sharded_consensus_tail, n_p=n_p, tau=0.5, delta=0.02,
        n_closure=78, mesh=jm, closure_tau=closure_tau))(
        jpar.shard_slab(js, jm), jnp.asarray(labels), key,
        prev_labels=jnp.asarray(prev))
    mesh = cpu_mesh(ensemble, edge)
    tslab, tst = sharded_consensus_tail(
        parallel.shard_slab(port_slab(js), mesh),
        torch.as_tensor(labels, dtype=torch.int64),
        interop.key_from_data(np.asarray(jax.random.key_data(key)),
                              device="cpu"),
        n_p, 0.5, 0.02, 78, mesh, closure_tau=closure_tau,
        prev_labels=torch.as_tensor(prev, dtype=torch.int64))
    assert int(jst.n_closure_added) > 0 and int(jst.n_repaired) > 0
    whole = parallel.gather_slab(tslab)
    for name in ("src", "dst", "weight", "alive"):
        np.testing.assert_array_equal(getattr(whole, name).numpy(),
                                      np.asarray(getattr(jslab, name)))
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)), rtol=1e-5)


@pytest.mark.parametrize("ensemble,edge", [(1, 1), (2, 2), (1, 4), (8, 1)])
def test_sharded_tail_equals_unsharded_scatter_tail(ensemble, edge):
    """Hybrid sizing (both gates), repeated rows of labels, the first
    round's singleton churn baseline: bit for bit the unsharded tail."""
    n = 2000
    slab = pack_edges(hybrid_graph(n), n, device="cpu")
    slab = slab.with_weights(torch.where(slab.alive, 1.0, 0.0))
    rng = np.random.default_rng(5)
    labels = torch.as_tensor(rng.integers(0, 12, (8, n)))
    key = interop.key_from_data([0, 17], device="cpu")
    ref, rst = consensus_tail(slab, labels, key, 8, 0.2, 0.02, 9000,
                              closure_tau=0.2, sampler="scatter")
    mesh = cpu_mesh(ensemble, edge)
    out, st = sharded_consensus_tail(parallel.shard_slab(slab, mesh),
                                     labels, key, 8, 0.2, 0.02, 9000, mesh,
                                     closure_tau=0.2)
    whole = parallel.gather_slab(out)
    c = ref.capacity
    for name in ("src", "dst", "weight", "alive"):
        assert torch.equal(getattr(whole, name)[:c], getattr(ref, name))
    assert int(rst.n_closure_added) > 0 and int(rst.n_hub_overflow) >= 0
    for f in INT_FIELDS:
        assert torch.equal(getattr(st, f), getattr(rst, f)), f
    for f in FLOAT_FIELDS:
        torch.testing.assert_close(getattr(st, f), getattr(rst, f),
                                   rtol=1e-5, atol=0)


# -- (c) whole runs against the reference --------------------------------


@pytest.mark.parametrize("alg", ["lpm", "louvain"])
@pytest.mark.parametrize("ensemble,edge", [(8, 1), (4, 2)])
def test_run_consensus_on_mesh_matches_reference(monkeypatch, karate_slab,
                                                 alg, ensemble, edge):
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "1")
    cfg = dict(algorithm=alg, n_p=8, tau=0.5, delta=0.1, seed=7,
               max_rounds=4)
    jres = jrun(karate_slab, jdetector(alg), JConfig(**cfg),
                mesh=jpar.make_mesh(ensemble=ensemble, edge=edge))
    tres = run_consensus(port_slab(karate_slab), get_detector(alg),
                         ConsensusConfig(**cfg),
                         mesh=cpu_mesh(ensemble, edge))
    assert tres.rounds == jres.rounds and tres.converged == jres.converged
    np.testing.assert_array_equal(np.stack(tres.partitions),
                                  np.stack(jres.partitions))
    np.testing.assert_array_equal(tres.graph.alive.numpy(),
                                  np.asarray(jres.graph.alive))
    for a, b in zip(tres.history, jres.history):
        assert a["n_alive"] == b["n_alive"]
        assert a["capacity"] == b["capacity"]
        assert a["labels_changed_by_member"] == b["labels_changed_by_member"]


# -- (d)-(f) mesh runs against the port's unsharded run -------------------


@pytest.mark.parametrize("ensemble,edge", [(2, 2), (1, 4)])
def test_mesh_run_equals_unsharded_on_hybrid_rows(monkeypatch, ensemble,
                                                  edge):
    """Forced hybrid rows: the plain ``row_totals`` runs in every
    ensemble shard's detection."""
    from fastconsensus_tpu_torch.ops import row_kernels as rk

    monkeypatch.setenv("FCTPU_MOVE_PATH", "hybrid")
    n = 2000
    slab = pack_edges(hybrid_graph(n), n, device="cpu")
    assert slab.d_hyb > 0 and slab.hub_cap > 0
    cfg = ConsensusConfig(n_p=4, tau=0.2, delta=0.02, max_rounds=2, seed=1,
                          closure_tau=0.2, closure_sampler="scatter")
    det = get_detector("louvain")
    calls = []
    monkeypatch.setattr(rk, "row_totals_plain", lambda *a, _f=rk.
                        row_totals_plain: calls.append(1) or _f(*a))
    base = run_consensus(slab, det, cfg)
    n_base = len(calls)
    sharded = run_consensus(slab, det, cfg, mesh=cpu_mesh(ensemble, edge))
    assert n_base > 0 and len(calls) > n_base
    assert_same_runs(sharded, base)


def test_auto_grow_replay_under_mesh_equals_unsharded():
    edges, _ = planted_partition(300, 6, 0.3, 0.02, seed=4)
    n_edges = int(pack_edges(edges, 300, device="cpu").num_alive())
    slab = pack_edges(edges, 300, capacity=n_edges + 10, device="cpu")
    cfg = ConsensusConfig(n_p=8, tau=0.2, delta=0.02, max_rounds=3,
                          seed=5, closure_sampler="scatter")
    reg = obs_counters.get_registry()
    before = reg.counters().get("slab.regrow_events", 0)
    base = run_consensus(slab, get_detector("louvain"), cfg)
    mid = reg.counters().get("slab.regrow_events", 0)
    sharded = run_consensus(slab, get_detector("louvain"), cfg,
                            mesh=cpu_mesh(2, 2))
    after = reg.counters().get("slab.regrow_events", 0)
    assert mid > before and after > mid
    assert sharded.graph.capacity > slab.capacity
    assert_same_runs(sharded, base)


def test_detect_cache_under_mesh(tmp_path, monkeypatch):
    """As the reference's test_detect_cache_recovery_under_mesh: chunks
    persisted, read back on retry, the same result; and the
    fingerprint holds the mesh's shape."""
    edges, _ = planted_partition(300, 6, 0.3, 0.02, seed=4)
    slab = pack_edges(edges, 300, device="cpu")
    det = get_detector("lpm")
    mesh = cpu_mesh(4, 2)
    monkeypatch.setenv("FCTPU_DETECT_CALL_MEMBERS", "6")  # rounds up to 8
    cfg = ConsensusConfig(algorithm="lpm", n_p=16, tau=0.5, delta=0.02,
                          max_rounds=3, seed=5)
    d = tmp_path / "cache"
    reg = obs_counters.get_registry()
    first = run_consensus(slab, det, cfg, mesh=mesh, detect_cache_dir=str(d))
    files = sorted(p.name for p in d.iterdir() if p.suffix == ".npy")
    assert files and all(re.search(r"_c[01]\.npy$", f) for f in files)
    assert np.load(d / files[0]).shape == (8, 300)
    cached = reg.counters().get("detect.chunks_cached", 0)
    second = run_consensus(slab, det, cfg, mesh=mesh,
                           detect_cache_dir=str(d))
    assert reg.counters().get("detect.chunks_cached", 0) - cached == \
        len(files)
    assert_same_runs(second, first)
    assert_same_runs(first, run_consensus(slab, det, cfg, mesh=mesh))
    fps = {_cache_fingerprint(cfg, slab, True, "scatter", m)
           for m in (None, mesh, cpu_mesh(8, 1), cpu_mesh(2, 4))}
    assert len(fps) == 4


def test_detect_cache_files_under_mesh_match_reference(tmp_path,
                                                      monkeypatch):
    """The reference's mesh run with a detect cache and the port's on the
    same mesh shape write the same ``sizing.json`` (run fingerprint,
    members rounded up to tile the "p" axis) and the same chunk files."""
    monkeypatch.setenv("FCTPU_DETECT_CALL_MEMBERS", "3")
    edges, _ = planted_partition(120, 4, 0.4, 0.03, seed=6)
    kw = dict(algorithm="lpm", n_p=8, tau=0.5, delta=0.02, max_rounds=2,
              seed=1)
    ref = jrun(jpack(edges, 120), jdetector("lpm"), JConfig(**kw),
               mesh=jpar.make_mesh(ensemble=4, edge=2),
               detect_cache_dir=str(tmp_path / "ref"))
    port = run_consensus(pack_edges(edges, 120, device="cpu"),
                         get_detector("lpm"), ConsensusConfig(**kw),
                         mesh=cpu_mesh(4, 2),
                         detect_cache_dir=str(tmp_path / "port"))
    a = json.loads((tmp_path / "port" / "sizing.json").read_text())
    assert a == json.loads((tmp_path / "ref" / "sizing.json").read_text())
    assert a["members"] == 4
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ref").iterdir())
    for name in names:
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                          np.load(tmp_path / "ref" / name))
    np.testing.assert_array_equal(np.stack(port.partitions),
                                  np.stack(ref.partitions))


def test_checkpoint_resume_under_mesh(tmp_path):
    """A mesh run checkpointed at round 2 resumes to round 4 on the mesh
    and unsharded, both equal to the uninterrupted run (the checkpoint
    holds the gathered slab and labels)."""
    edges, _ = planted_partition(300, 6, 0.3, 0.02, seed=4)
    slab = pack_edges(edges, 300, device="cpu")
    det = get_detector("louvain")
    mesh = cpu_mesh(2, 2)
    cfg = dict(n_p=8, seed=3, delta=0.0, closure_sampler="scatter")
    full = run_consensus(slab, det, ConsensusConfig(max_rounds=4, **cfg),
                         mesh=mesh)
    ck = str(tmp_path / "ck.npz")
    run_consensus(slab, det, ConsensusConfig(max_rounds=2, **cfg), mesh=mesh,
                  checkpoint_path=ck)
    for i, m in enumerate((mesh, None)):
        copy = str(tmp_path / f"ck{i}.npz")   # each resume writes on
        shutil.copy(ck, copy)
        res = run_consensus(slab, det, ConsensusConfig(max_rounds=4, **cfg),
                            mesh=m, checkpoint_path=copy, resume=True)
        assert res.rounds == 4 and len(res.history) == 4
        assert_same_runs(res, full)


# -- (g) the refusals -----------------------------------------------------


def test_mesh_refusals(karate_slab):
    slab = port_slab(karate_slab)
    det = get_detector("louvain")
    mesh = cpu_mesh(8, 1)
    with pytest.raises(ValueError, match="not divisible by the mesh "
                                         "ensemble axis"):
        run_consensus(slab, det, ConsensusConfig(n_p=10), mesh=mesh)
    with pytest.raises(ValueError, match="closure_sampler='csr' is "
                                         "incompatible with a mesh"):
        run_consensus(slab, det, ConsensusConfig(n_p=8,
                                                 closure_sampler="csr"),
                      mesh=mesh)
    with pytest.raises(ValueError, match="init_labels is not supported "
                                         "with a mesh"):
        run_consensus(slab, det, ConsensusConfig(n_p=8), mesh=mesh,
                      init_labels=np.zeros((8, slab.n_nodes), np.int32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            parallel.make_mesh()


def test_mesh_modules_import_neither_jax_nor_the_reference():
    """The mesh modules, and the rank worker of the multi-process tests
    (each rank imports the port only)."""
    pkg = REPO / "fastconsensus_tpu_torch"
    paths = sorted((pkg / "parallel").glob("*.py")) + \
        [pkg / "ops" / "sharded_tail.py",
         REPO / "tests" / "torch_mp_worker.py"]
    assert len(paths) == 5
    for path in paths:
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path
        assert not re.search(r"^\s*(import|from)\s+fastconsensus_tpu\b",
                             text, re.M), path
        assert "fastconsensus_tpu." not in text, path
