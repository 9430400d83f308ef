"""The fused round block against the JAX package's, on the CPU: the
port's block and the JAX package's fused run (``FCTPU_ROUNDS_BLOCK=8``
on both sides) on karate, a forced-hybrid planted graph and LPM, the
host C++ detectors (CNM, Infomap) solo and batched, and fcdelta through
the block; and the port's lexsort ``insert_edges``
against the reference's.

Partitions, integer history fields and the slab are exact; the two float
round metrics sum in another order: rtol 1e-5, as
``test_torch_consensus.py`` holds them.  Inputs are built with numpy
from fixed seeds.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from fastconsensus_tpu.consensus import ConsensusConfig as JConfig
from fastconsensus_tpu.consensus import run_consensus as jrun
from fastconsensus_tpu.graph import pack_edges as jpack
from fastconsensus_tpu.models.registry import get_detector as jdetector
from fastconsensus_tpu.obs import counters as jcounters
from fastconsensus_tpu.utils.synth import planted_partition
from fastconsensus_tpu_torch import interop
from fastconsensus_tpu_torch.consensus import ConsensusConfig, run_consensus
from fastconsensus_tpu_torch.graph import pack_edges
from fastconsensus_tpu_torch.models.registry import get_detector
from fastconsensus_tpu_torch.obs import counters as tcounters
from fastconsensus_tpu_torch.ops import consensus_ops as cops
from fastconsensus_tpu_torch.utils.io import read_edgelist

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

KARATE = Path(__file__).resolve().parent.parent / "examples" / \
    "karate_club.txt"


def _karate():
    edges, _, ids = read_edgelist(str(KARATE))
    return np.asarray(edges), len(ids)


def _blocks_run(reg):
    return reg.counters().get("host_sync.block_stats", 0)


def _port(monkeypatch, block, slab, alg, cfg, **kw):
    """The port's run at FCTPU_ROUNDS_BLOCK=block and the blocks it ran."""
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", str(block))
    reg = tcounters.get_registry()
    before = _blocks_run(reg)
    res = run_consensus(slab, get_detector(alg), ConsensusConfig(
        algorithm=alg, **cfg), **kw)
    return res, _blocks_run(reg) - before


def _assert_identical(a, b):
    """Partitions, every history field and the final slab, exactly."""
    assert a.rounds == b.rounds and a.converged == b.converged
    assert a.history == b.history
    np.testing.assert_array_equal(np.stack(a.partitions),
                                  np.stack(b.partitions))
    for f in ("src", "dst", "weight", "alive"):
        assert torch.equal(getattr(a.graph, f), getattr(b.graph, f)), f


def _compare_to_jax(jres, tres, capacity=True):
    """As ``test_torch_consensus._compare_runs``; ``capacity=False``
    leaves out the slab's capacity (the history field and the dead tail
    past the smaller one)."""
    assert tres.rounds == jres.rounds
    assert tres.converged == jres.converged
    for a, b in zip(tres.history, jres.history):
        for k, v in b.items():
            if k == "capacity" and not capacity:
                continue
            if k in ("agreement", "modularity_mean"):
                assert a[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
            elif k == "modularity_by_member":
                np.testing.assert_allclose(a[k], v, rtol=1e-5, atol=1e-6)
            else:
                assert a[k] == v, k
    np.testing.assert_array_equal(np.stack(tres.partitions),
                                  np.stack(jres.partitions))
    cap = min(tres.graph.capacity, jres.graph.capacity)
    for name in ("src", "dst", "weight", "alive"):
        t = getattr(tres.graph, name).numpy()
        j = np.asarray(getattr(jres.graph, name))
        if capacity:
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_array_equal(t[:cap], j[:cap])
    if not capacity:
        assert not np.asarray(jres.graph.alive)[cap:].any()
        assert not tres.graph.alive[cap:].any()


def _hybrid_graph(n):
    """Planted communities plus grafted hubs (carries hybrid sizing)."""
    rng = np.random.default_rng(11)
    edges, _ = planted_partition(n, 10, 0.06, 0.0008, seed=4)
    hubs = rng.choice(n, 8, replace=False)
    extra = np.array([[h, int(o)] for h in hubs
                      for o in rng.choice(n, 120, replace=False)
                      if int(o) != h])
    return np.vstack([edges, extra]), n


@pytest.mark.parametrize("case", ["karate_louvain", "hybrid_louvain",
                                  "planted_lpm", "karate_leiden",
                                  "hybrid_leiden"])
def test_block_matches_jax_block(monkeypatch, case):
    """The port's block against the JAX package's fused run; Leiden's on
    karate (matmul sweeps) and on forced hybrid rows (its refinement
    through row_totals rows, the aggregate level hashed), where the JAX
    package fuses every detector whose round is one call."""
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "8")
    monkeypatch.setenv("FCTPU_DETECT_CALL_MEMBERS", "0")
    if case == "karate_louvain":
        (edges, n), alg = _karate(), "louvain"
        cfg = dict(n_p=6, tau=0.2, delta=0.02, max_rounds=4, seed=2)
    elif case == "karate_leiden":
        (edges, n), alg = _karate(), "leiden"
        cfg = dict(n_p=4, tau=0.2, delta=0.0, max_rounds=4, seed=2)
    elif case == "hybrid_leiden":
        monkeypatch.setenv("FCTPU_MOVE_PATH", "hybrid")
        (edges, n), alg = _hybrid_graph(600), "leiden"
        cfg = dict(n_p=3, tau=0.2, delta=0.02, max_rounds=3, seed=1,
                   closure_tau=0.2)
    elif case == "hybrid_louvain":
        monkeypatch.setenv("FCTPU_MOVE_PATH", "hybrid")
        (edges, n), alg = _hybrid_graph(600), "louvain"
        cfg = dict(n_p=4, tau=0.2, delta=0.02, max_rounds=3, seed=1,
                   closure_tau=0.2)
    else:
        edges, _ = planted_partition(120, 4, 0.4, 0.06, seed=9)
        n, alg = 120, "lpm"
        cfg = dict(n_p=6, tau=0.5, delta=0.02, max_rounds=5, seed=3)
    js = jpack(edges, n)
    if case == "hybrid_louvain":
        assert js.d_hyb > 0 and js.hub_cap > 0
    jreg = jcounters.get_registry()
    j0 = _blocks_run(jreg)
    jres = jrun(js, jdetector(alg), JConfig(algorithm=alg, **cfg))
    assert _blocks_run(jreg) > j0, "the JAX package ran no fused block"
    tslab = interop.slab_from_arrays(
        np.asarray(js.src), np.asarray(js.dst), np.asarray(js.weight),
        np.asarray(js.alive), n_nodes=js.n_nodes, d_cap=js.d_cap,
        cap_hint=js.cap_hint, d_hyb=js.d_hyb, hub_cap=js.hub_cap,
        agg_cap=js.agg_cap, device="cpu")
    treg = tcounters.get_registry()
    t0 = _blocks_run(treg)
    tres = run_consensus(tslab, get_detector(alg),
                         ConsensusConfig(algorithm=alg, **cfg))
    assert _blocks_run(treg) > t0
    _compare_to_jax(jres, tres)


def _ring(n, chords, shift):
    idx = np.arange(n)
    c = np.arange(chords)
    return np.concatenate([np.stack([idx, (idx + 1) % n], 1),
                           np.stack([c % n, (c + shift) % n], 1)])


@pytest.mark.parametrize("alg", ["louvain", "lpm", "leiden"])
@pytest.mark.parametrize("mode", ["warm", "scratch"])
def test_batch_block_matches_jax_batch(monkeypatch, alg, mode):
    """The port's blocked ``run_consensus_batch`` against the JAX
    package's (which blocks at 8 by default) on three seeded graphs of
    one bucket, n_p 3, and against the port's one batched round a host
    step: partitions, rounds, convergence, splits and the integer
    history exactly, the float round metrics at rtol 1e-5."""
    from fastconsensus_tpu.consensus import run_consensus_batch as jbatch
    from fastconsensus_tpu.serve import bucketer as jb
    from fastconsensus_tpu_torch import engine
    from fastconsensus_tpu_torch.consensus import run_consensus_batch
    from fastconsensus_tpu_torch.serve import bucketer as tb

    monkeypatch.setenv("FCTPU_DETECT_CALL_MEMBERS", "0")
    graphs = [(_ring(34, 40, 7), 34), (_ring(40, 38, 5), 40),
              (_ring(36, 44, 11), 36)]
    seeds = [11, 22, 33]
    cfg = dict(algorithm=alg, n_p=3, tau=0.2, delta=0.02,
               max_rounds=4 if mode == "warm" else 3, seed=0,
               warm_start=mode == "warm")
    padded = [tb.pad_to_bucket(e, n, device="cpu") for e, n in graphs]
    slabs, nc = [s for s, _ in padded], padded[0][1].n_closure
    jres = jbatch([jb.pad_to_bucket(e, n)[0] for e, n in graphs],
                  jdetector(alg), JConfig(**cfg), n_closure=nc, seeds=seeds)
    runs, calls = {}, []
    run = engine.BatchBlock.run

    def counted(self, *a, **k):
        calls.append(a)
        return run(self, *a, **k)

    monkeypatch.setattr(engine.BatchBlock, "run", counted)
    for block in (8, 1):
        monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", str(block))
        n_calls = len(calls)
        runs[block] = run_consensus_batch(
            slabs, get_detector(alg), ConsensusConfig(**cfg), n_closure=nc,
            seeds=seeds)
        assert (len(calls) > n_calls) == (block == 8)
    tres = runs[8]
    assert tres.splits == {} and len(jres) == len(tres)
    for t, j, one in zip(tres, jres, runs[1]):
        _compare_to_jax(j, t)
        _assert_identical(t, one)


def _email_standin():
    """bench.py's emailEu stand-in (planted, n 1,005, 42 blocks)."""
    from fastconsensus_tpu_torch.utils import synth

    sizes = synth.heterogeneous_sizes(1005, 42, 0.85)
    edges, _ = synth.planted_partition(1005, 42, 0.6, 0.02, seed=42,
                                       sizes=sizes)
    return np.asarray(edges), 1005


@pytest.mark.parametrize("alg,graph", [("cnm", "karate"),
                                       ("cnm", "emailEu"),
                                       ("infomap", "karate")])
def test_host_detector_block_matches_jax_block(monkeypatch, alg, graph):
    """The host C++ detectors in the blocks: the port's blocked run
    (``engine.HostDetect``) against the JAX package's fused run, which
    reaches the same C++ through ``jax.pure_callback`` inside its jitted
    block.  Tolerance: partitions, the integer history and the slab
    exactly, the float round metrics at rtol 1e-5 (their sums run in
    another order)."""
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "8")
    monkeypatch.setenv("FCTPU_DETECT_CALL_MEMBERS", "0")
    edges, n = _karate() if graph == "karate" else _email_standin()
    cfg = dict(n_p=6 if graph == "karate" else 4,
               tau=0.7 if alg == "cnm" else 0.6,
               delta=0.02 if graph == "karate" else 0.0,
               max_rounds=4, seed=2)
    js = jpack(edges, n)
    jreg = jcounters.get_registry()
    j0 = _blocks_run(jreg)
    jres = jrun(js, jdetector(alg), JConfig(algorithm=alg, **cfg))
    assert _blocks_run(jreg) > j0, "the JAX package ran no fused block"
    treg = tcounters.get_registry()
    t0 = _blocks_run(treg)
    tres = run_consensus(pack_edges(edges, n, device="cpu"),
                         get_detector(alg),
                         ConsensusConfig(algorithm=alg, **cfg))
    assert _blocks_run(treg) > t0
    _compare_to_jax(jres, tres)


@pytest.mark.parametrize("alg", ["cnm", "infomap"])
def test_host_detector_batch_block_matches_jax_batch(monkeypatch, alg):
    """The port's blocked ``run_consensus_batch`` of a host detector
    against the JAX package's batch (which blocks at 8 by default and
    runs its ``pure_callback`` once a job, in job order,
    ``vmap_method="sequential"``) on three seeded graphs of one bucket,
    n_p 3: partitions, rounds, convergence, splits and the integer
    history exactly, the float round metrics at rtol 1e-5."""
    from fastconsensus_tpu.consensus import run_consensus_batch as jbatch
    from fastconsensus_tpu.serve import bucketer as jb
    from fastconsensus_tpu_torch import engine
    from fastconsensus_tpu_torch.consensus import run_consensus_batch
    from fastconsensus_tpu_torch.serve import bucketer as tb

    monkeypatch.setenv("FCTPU_DETECT_CALL_MEMBERS", "0")
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "8")
    graphs = [(_ring(34, 40, 7), 34), (_ring(40, 38, 5), 40),
              (_ring(36, 44, 11), 36)]
    seeds = [11, 22, 33]
    cfg = dict(algorithm=alg, n_p=3, tau=0.5, delta=0.0, max_rounds=4,
               seed=0)
    padded = [tb.pad_to_bucket(e, n, device="cpu") for e, n in graphs]
    slabs, nc = [s for s, _ in padded], padded[0][1].n_closure
    jres = jbatch([jb.pad_to_bucket(e, n)[0] for e, n in graphs],
                  jdetector(alg), JConfig(**cfg), n_closure=nc, seeds=seeds)
    calls = []
    run = engine.BatchBlock.run

    def counted(self, *a, **k):
        calls.append(a)
        return run(self, *a, **k)

    monkeypatch.setattr(engine.BatchBlock, "run", counted)
    tres = run_consensus_batch(slabs, get_detector(alg),
                               ConsensusConfig(**cfg), n_closure=nc,
                               seeds=seeds)
    assert calls and tres.splits == {} and len(jres) == len(tres)
    for t, j in zip(tres, jres):
        _compare_to_jax(j, t)


def test_block_growth_inside_a_block_against_jax(monkeypatch):
    """The slab saturates in round 3, inside a block.  The port's block
    stops before a round that drops survivors and grows the slab that
    round started from, as one round a host step does; the JAX package's
    block replays the whole block from its start on a slab grown by the
    block's largest drop, so its history records another capacity for
    the block's rounds (and its slab has a longer dead tail).  The rest
    is the same, and the port's block is the JAX package's one round a
    host step exactly."""
    monkeypatch.setenv("FCTPU_DETECT_CALL_MEMBERS", "0")
    edges, _ = planted_partition(150, 5, 0.3, 0.05, seed=4)
    cfg = dict(n_p=6, tau=0.05, delta=0.02, max_rounds=6, seed=1)
    js = jpack(edges, 150, capacity=1700)
    tres, blocks = _port(monkeypatch, 8, pack_edges(
        edges, 150, capacity=1700, device="cpu"), "louvain", cfg)
    assert blocks > 0
    caps = [h["capacity"] for h in tres.history]
    assert caps[0] == 1700 and len(set(caps)) > 1, caps
    jfused = jrun(js, jdetector("louvain"), JConfig(**cfg))
    _compare_to_jax(jfused, tres, capacity=False)
    assert [h["capacity"] for h in jfused.history] != caps
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "1")
    _compare_to_jax(jrun(js, jdetector("louvain"), JConfig(**cfg)), tres)


def test_block_incremental_matches_per_round_and_jax(monkeypatch):
    """fcdelta through the block: ``init_labels`` and ``active_mask``
    (round 0 warm, in the block), block = per-round = the JAX package."""
    from fastconsensus_tpu_torch.serve import delta as td
    from fastconsensus_tpu_torch.serve.jobs import canonical_edges

    edges, n = _karate()
    cfg = dict(n_p=4, tau=0.2, delta=0.02, max_rounds=3, seed=3)
    u, v, _ = canonical_edges(edges, n)
    rng = np.random.default_rng(3)
    removes = np.stack([u, v], 1)[rng.choice(len(u), 1, replace=False)]
    adds, removes = td.parse_delta({"adds": [], "removes":
                                    removes.tolist()}, n)
    cu, cv, _ = td.apply_delta(u, v, None, n, adds, removes)
    active = td.neighborhood_mask(cu, cv, n, adds, removes)
    assert 0 < active.sum() < n
    parent, _ = _port(monkeypatch, 1, pack_edges(np.stack([u, v], 1), n,
                                                 device="cpu"),
                      "louvain", dict(cfg, max_rounds=1))
    init = np.stack(parent.partitions)
    child = np.stack([cu, cv], 1)
    kw = dict(init_labels=init, active_mask=active)
    fused, blocks = _port(monkeypatch, 8, pack_edges(child, n, device="cpu"),
                          "louvain", cfg, **kw)
    single, _ = _port(monkeypatch, 1, pack_edges(child, n, device="cpu"),
                      "louvain", cfg, **kw)
    assert blocks > 0 and not fused.history[0]["cold"]
    _assert_identical(fused, single)
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "8")
    monkeypatch.setenv("FCTPU_DETECT_CALL_MEMBERS", "0")
    jres = jrun(jpack(child, n), jdetector("louvain"), JConfig(**cfg), **kw)
    _compare_to_jax(jres, fused)
    frozen = ~active
    for i, p in enumerate(fused.partitions):
        np.testing.assert_array_equal(p[frozen], init[i][frozen])


def test_insert_edges_lexsort_matches_reference():
    """The reference's exact insert (its lexsort), on seeded random
    candidates with duplicates and pairs already in the slab, into a
    slab with free slots and into a full one."""
    from fastconsensus_tpu.graph import GraphSlab as JSlab
    from fastconsensus_tpu.ops.consensus_ops import insert_edges as jinsert
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    n, cap, k = 40, 64, 50
    for n_dead in (10, 0):
        u = rng.integers(0, n - 1, cap)
        v = u + rng.integers(1, n - u)
        w = rng.integers(1, 5, cap).astype(np.float32)
        alive = np.ones(cap, bool)
        alive[rng.choice(cap, n_dead, replace=False)] = False
        cu = rng.integers(0, n - 1, k)
        cv = cu + rng.integers(1, n - cu)
        cu[:5], cv[:5] = u[:5], v[:5]            # already in the slab
        cu[5:10], cv[5:10] = cu[10:15], cv[10:15]  # duplicates
        cw = rng.integers(1, 5, k).astype(np.float32)
        cvalid = rng.random(k) < 0.9
        js = JSlab(src=jnp.asarray(u, jnp.int32), dst=jnp.asarray(v, jnp.int32),
                   weight=jnp.asarray(w), alive=jnp.asarray(alive),
                   n_nodes=n)
        jslab, jdrop = jinsert(js, jnp.asarray(cu, jnp.int32),
                               jnp.asarray(cv, jnp.int32), jnp.asarray(cw),
                               jnp.asarray(cvalid))
        ts = interop.slab_from_arrays(u, v, w, alive, n_nodes=n,
                                      device="cpu")
        tslab, tdrop = cops.insert_edges(
            ts, torch.as_tensor(cu), torch.as_tensor(cv),
            torch.as_tensor(cw), torch.as_tensor(cvalid))
        assert int(tdrop) == int(jdrop)
        if n_dead == 0:
            assert int(tdrop) > 0
        for f in ("src", "dst", "weight", "alive"):
            np.testing.assert_array_equal(getattr(tslab, f).numpy(),
                                          np.asarray(getattr(jslab, f)))


@pytest.mark.parametrize("unique_new", [False, True])
def test_insert_edges_hash_scattered_free_slots_matches_reference(
        unique_new):
    """The hash insert into a full slab with dead slots scattered through
    it, more survivors than free slots: the reference's fill order and
    dropped count (with and without ``unique_new``)."""
    from fastconsensus_tpu.ops.consensus_ops import \
        insert_edges_hash as jinsert
    import jax.numpy as jnp

    edges, _ = planted_partition(200, 4, 0.3, 0.02, seed=0)
    js = jpack(edges, 200, capacity=edges.shape[0])
    rng = np.random.default_rng(1)
    alive = np.asarray(js.alive).copy()
    alive[rng.choice(js.capacity, 12, replace=False)] = False
    js = js.with_weights(js.weight, jnp.asarray(alive))
    k = 60
    u = rng.integers(0, 100, k)
    v = u + rng.integers(1, 100, k)
    w = rng.integers(1, 6, k).astype(np.float32)
    valid = rng.random(k) < 0.9
    if unique_new:
        first = np.unique(u * 1000 + v, return_index=True)[1]
        valid &= np.isin(np.arange(k), first)
    jslab, jdrop = jinsert(js, jnp.asarray(u, jnp.int32),
                           jnp.asarray(v, jnp.int32), jnp.asarray(w),
                           jnp.asarray(valid), unique_new=unique_new)
    ts = interop.slab_from_arrays(
        np.asarray(js.src), np.asarray(js.dst), np.asarray(js.weight),
        alive, n_nodes=200, d_cap=js.d_cap, cap_hint=js.cap_hint,
        d_hyb=js.d_hyb, hub_cap=js.hub_cap, agg_cap=js.agg_cap,
        device="cpu")
    tslab, tdrop = cops.insert_edges_hash(
        ts, torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(w),
        torch.as_tensor(valid), unique_new=unique_new)
    assert int(tdrop) == int(jdrop) > 0
    for f in ("src", "dst", "weight", "alive"):
        np.testing.assert_array_equal(getattr(tslab, f).numpy(),
                                      np.asarray(getattr(jslab, f)))
