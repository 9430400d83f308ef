"""The fused round block (``engine.RoundsBlock``) on the CPU: the port's
block against the port's one round a host step, and each capture-safe
piece against its eager twin (``test_torch_blocks_jax.py`` holds the
block against the JAX package's).

A block runs its rounds through the capture-safe variants
(``ops/capture.py``): static shapes, no host read, device-side branches
computed and selected.  Everything here is exact: partitions, every
history field, the final slab.  Inputs are built with numpy from fixed
seeds.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fastconsensus_tpu.utils.synth import planted_partition
from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                               rounds_block_size,
                                               run_consensus)
from fastconsensus_tpu_torch.engine import consensus_round
from fastconsensus_tpu_torch.graph import pack_edges
from fastconsensus_tpu_torch.models import louvain, lpm
from fastconsensus_tpu_torch.models.registry import get_detector
from fastconsensus_tpu_torch.obs import counters as tcounters
from fastconsensus_tpu_torch.ops import capture
from fastconsensus_tpu_torch.utils import prng
from fastconsensus_tpu_torch.utils.io import read_edgelist

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
KARATE = REPO / "examples" / "karate_club.txt"


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
    assert a.graph.capacity == b.graph.capacity
    assert (a.graph.d_cap, a.graph.d_hyb, a.graph.hub_cap,
            a.graph.agg_cap) == (b.graph.d_cap, b.graph.d_hyb,
                                 b.graph.hub_cap, b.graph.agg_cap)


# -- the port's block against its one round a host step -----------------


def test_block_matches_per_round_lpm(monkeypatch):
    """The reference's test_fused_rounds_match_single_rounds, on its graph
    with more edges between the blocks (p_out 0.06): at its 0.02 the run
    converges in its first round, which the port runs alone."""
    edges, _ = planted_partition(120, 4, 0.4, 0.06, seed=9)
    cfg = dict(n_p=6, tau=0.5, delta=0.02, max_rounds=5, seed=3)
    slab = pack_edges(edges, 120, device="cpu")
    fused, blocks = _port(monkeypatch, 8, slab, "lpm", cfg)
    single, none = _port(monkeypatch, 1, slab, "lpm", cfg)
    assert blocks > 0 and none == 0
    _assert_identical(fused, single)


def test_block_matches_per_round_aligned(monkeypatch):
    """The reference's test_fused_rounds_match_single_rounds_aligned: the
    block re-derives endgame alignment from its own stats."""
    edges, _ = planted_partition(150, 5, 0.4, 0.02, seed=9)
    cfg = dict(n_p=8, tau=0.2, delta=0.0, max_rounds=6, seed=3,
               align_frac=0.5)
    slab = pack_edges(edges, 150, device="cpu")
    fused, blocks = _port(monkeypatch, 8, slab, "louvain", cfg)
    assert blocks > 0
    assert any(h["n_unconverged"] <= 0.5 * h["n_alive"]
               for h in fused.history[:-1]), "alignment never engaged"
    single, _ = _port(monkeypatch, 1, slab, "louvain", cfg)
    _assert_identical(fused, single)


def test_block_budget_regrowth_matches_per_round(monkeypatch):
    """The reference's test_budget_regrowth_fused_matches_single: the
    block stops at the starved round, so the dense budget is re-derived
    at the same round."""
    edges, _ = planted_partition(200, 4, 0.3, 0.02, seed=2)
    slab = pack_edges(edges, 200, device="cpu")
    starved = dataclasses.replace(slab, d_cap=8, d_hyb=0, hub_cap=0)
    cfg = dict(n_p=8, tau=0.5, delta=0.02, max_rounds=4, seed=3)
    fused, blocks = _port(monkeypatch, 8, starved, "lpm", cfg)
    single, _ = _port(monkeypatch, 1, starved, "lpm", cfg)
    assert blocks > 0
    assert any(h["n_overflow"] > 0 for h in fused.history)
    assert fused.graph.d_cap > 8 and fused.graph.d_cap == single.graph.d_cap
    _assert_identical(fused, single)
    # the re-derivation round: the first round after the starved one runs
    # with complete rows in both
    starved_at = [h["round"] for h in fused.history if h["n_overflow"] > 0]
    assert starved_at == [h["round"] for h in single.history
                          if h["n_overflow"] > 0]


def test_block_stops_at_starved_budgets_inside_a_block(monkeypatch):
    """Dense rows too narrow for a densifying graph starve in round 3, the
    block's third: the block stops after it, and run_consensus re-derives
    the width before the round after, as one round a host step does."""
    monkeypatch.setenv("FCTPU_MOVE_PATH", "dense")
    edges, _ = planted_partition(150, 5, 0.3, 0.05, seed=4)
    slab = pack_edges(edges, 150, capacity=4000, device="cpu")
    narrow = dataclasses.replace(slab, d_cap=20, d_hyb=0, hub_cap=0)
    cfg = dict(n_p=6, tau=0.05, delta=0.02, max_rounds=6, seed=1)
    fused, blocks = _port(monkeypatch, 8, narrow, "louvain", cfg)
    single, _ = _port(monkeypatch, 1, narrow, "louvain", cfg)
    assert blocks >= 2
    fired = [h["round"] for h in single.history
             if h["n_overflow"] * 8 > 150 * 20]
    assert fired and fired[0] >= 3, fired
    assert fused.graph.d_cap > 20
    _assert_identical(fused, single)


def test_block_auto_grow_mid_block_matches_per_round(monkeypatch):
    """A round inside a block drops survivors: the block stops before it,
    run_consensus grows the slab that round started from and runs it
    again, as it does one round a step.  The graph densifies under a low tau
    (closure adds edges every round), so a slab with room for the first
    rounds saturates in round 3, the block's third."""
    edges, _ = planted_partition(150, 5, 0.3, 0.05, seed=4)
    slab = pack_edges(edges, 150, capacity=1700, device="cpu")
    cfg = dict(n_p=6, tau=0.05, delta=0.02, max_rounds=6, seed=1)
    fused, blocks = _port(monkeypatch, 8, slab, "louvain", cfg)
    single, _ = _port(monkeypatch, 1, slab, "louvain", cfg)
    assert blocks > 0
    caps = [h["capacity"] for h in single.history]
    grew_at = [i for i in range(1, len(caps)) if caps[i] > caps[i - 1]]
    assert caps[0] == 1700 and grew_at and grew_at[0] >= 2, caps
    _assert_identical(fused, single)


def test_block_without_warm_start_matches_per_round(monkeypatch):
    """warm_start off: every round cold, every round in the block."""
    edges, n = _karate()
    slab = pack_edges(edges, n, device="cpu")
    cfg = dict(n_p=4, tau=0.2, delta=0.02, max_rounds=3, seed=5,
               warm_start=False)
    fused, blocks = _port(monkeypatch, 8, slab, "lpm", cfg)
    single, _ = _port(monkeypatch, 1, slab, "lpm", cfg)
    assert blocks > 0 and all(h["cold"] for h in fused.history)
    _assert_identical(fused, single)


@pytest.mark.parametrize("graph", ["karate", "hybrid"])
def test_block_matches_per_round_leiden(monkeypatch, graph):
    """Leiden's warm variant in the block: karate on the matmul sweep, a
    forced-hybrid planted graph (row_totals rows in the move phase and
    the refinement, the hashed aggregate level)."""
    if graph == "karate":
        edges, n = _karate()
        cfg = dict(n_p=4, tau=0.2, delta=0.02, max_rounds=4, seed=2)
    else:
        monkeypatch.setenv("FCTPU_MOVE_PATH", "hybrid")
        edges, n = _hybrid_graph(600)
        cfg = dict(n_p=3, tau=0.2, delta=0.02, max_rounds=3, seed=1,
                   closure_tau=0.2)
    slab = pack_edges(edges, n, device="cpu")
    fused, blocks = _port(monkeypatch, 8, slab, "leiden", cfg)
    single, none = _port(monkeypatch, 1, slab, "leiden", cfg)
    assert blocks > 0 and none == 0 and fused.rounds >= 2
    _assert_identical(fused, single)


def test_leiden_variants_block_and_refresh_stays_out():
    """Leiden carries ``supports_block`` on the detector and its warm
    variant; the refresh variant (a re-detection from singletons) never
    runs in a block."""
    det = get_detector("leiden")
    assert det.supports_block and det.warm_variant.supports_block
    assert not getattr(det.refresh_variant, "supports_block", False)


# -- the batched block ---------------------------------------------------


def _ring(n, chords, shift):
    idx = np.arange(n)
    c = np.arange(chords)
    return np.concatenate([np.stack([idx, (idx + 1) % n], 1),
                           np.stack([c % n, (c + shift) % n], 1)])


_RINGS = [(_ring(34, 40, 7), 34), (_ring(40, 38, 5), 40),
          (_ring(33, 52, 13), 33), (_ring(36, 44, 11), 36)]


def _bucket_jobs(k=4):
    """Up to four distinct graphs of one bucket (n64_e96)."""
    from fastconsensus_tpu_torch.serve import bucketer

    graphs = _RINGS[:k]
    padded = [bucketer.pad_to_bucket(e, n, device="cpu") for e, n in graphs]
    return [s for s, _ in padded], padded[0][1].n_closure


def _batch_runs(monkeypatch, block, slabs, alg, cfg, n_closure, seeds):
    """The port's batch at FCTPU_ROUNDS_BLOCK=block and the batched
    blocks it ran."""
    from fastconsensus_tpu_torch import engine
    from fastconsensus_tpu_torch.consensus import run_consensus_batch

    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", str(block))
    calls = []
    run = engine.BatchBlock.run

    def counted(self, *a, **k):
        calls.append(a[4])
        return run(self, *a, **k)

    monkeypatch.setattr(engine.BatchBlock, "run", counted)
    res = run_consensus_batch(slabs, get_detector(alg), ConsensusConfig(
        algorithm=alg, **cfg), n_closure=n_closure, seeds=seeds)
    monkeypatch.setattr(engine.BatchBlock, "run", run)
    return res, calls


def _starved_jobs(kind):
    """Four bucket jobs, one of which saturates its slab (``grow``) or
    re-derives its budgets (``budget``) within a few rounds."""
    if kind == "grow":
        # at 124 slots only the fourth job's closure overflows
        slabs = []
        for e, _ in _RINGS:
            t = pack_edges(e, 40, capacity=124, device="cpu")
            slabs.append(dataclasses.replace(t, d_cap=0, d_hyb=0,
                                             hub_cap=0, cap_hint=124,
                                             agg_cap=8192))
        return slabs, 96
    slabs, nc = _bucket_jobs()
    # at agg_cap 76 the budgets fire for jobs whose alive edges pass 95
    return [dataclasses.replace(s, agg_cap=76) for s in slabs], nc


@pytest.mark.parametrize("case", ["warm", "scratch", "leiden", "lpm",
                                  "grow_split", "budget_split"])
def test_batch_block_matches_per_round_and_solo(monkeypatch, case):
    """The blocked batch equals one batched round a host step and each
    job's solo run: partitions, rounds, history, slab and splits.  Warm:
    stagnation refreshes (a masked round between blocks, which ends a
    block for every job) and convergence mid-block; scratch: warm start
    off; a job that saturates its slab, and jobs whose budgets are
    re-derived, split off to solo runs after their block."""
    alg = case if case in ("leiden", "lpm") else "louvain"
    seeds = [11, 22, 33, 44]
    cfg = dict(n_p=4, tau=0.2, delta=0.02, max_rounds=10, seed=0)
    slabs, nc = _bucket_jobs()
    if case == "scratch":
        cfg.update(max_rounds=3, warm_start=False)
    elif case == "lpm":
        slabs, seeds = slabs[:2], seeds[:2]
        cfg.update(n_p=3, max_rounds=4)
    elif case.endswith("_split"):
        slabs, nc = _starved_jobs(case.split("_")[0])
        seeds = [1, 2, 3, 4] if case == "grow_split" else seeds
        cfg.update(max_rounds=4 if case == "grow_split" else 6)
    blocked, calls = _batch_runs(monkeypatch, 8, slabs, alg, cfg, nc, seeds)
    single, none = _batch_runs(monkeypatch, 1, slabs, alg, cfg, nc, seeds)
    assert calls and not none
    assert blocked.splits == single.splits
    if case == "grow_split":
        assert list(blocked.splits) == [3]
        assert blocked.splits[3].startswith("slab saturated at round")
    if case == "budget_split":
        assert sorted(blocked.splits) == [1, 3]
    if case == "warm":
        assert any(h["cold"] for r in blocked for h in r.history[1:]), \
            "no stagnation refresh"
        # a job converged inside a block while another went on
        assert len({r.rounds for r in blocked}) > 1
    for i, (a, b) in enumerate(zip(blocked, single)):
        _assert_identical(a, b)
        solo = run_consensus(slabs[i], get_detector(alg), ConsensusConfig(
            algorithm=alg, **cfg), key=prng.key(seeds[i], "cpu"),
            n_closure=nc)
        _assert_identical(a, solo)


@pytest.mark.parametrize("setting,cpu,cuda", [
    (None, 1, 1), ("1", 1, 1), ("4", 4, 4), ("20", 8, 8), ("auto", 1, 8)])
def test_batch_block_size_setting(monkeypatch, setting, cpu, cuda):
    """The batch reads FCTPU_ROUNDS_BLOCK as the solo driver does;
    ``auto`` is the reference's batch default of 8 on the card."""
    from fastconsensus_tpu_torch.consensus import batch_block_size

    if setting is None:
        monkeypatch.delenv("FCTPU_ROUNDS_BLOCK", raising=False)
    else:
        monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", setting)
    assert batch_block_size(torch.device("cpu")) == cpu
    assert batch_block_size(torch.device("cuda")) == cuda


def test_consensus_batch_block_one_round_equals_batch_round():
    """One round of ``engine.consensus_batch_block`` is
    ``consensus_batch_round`` at the same keys: slabs, labels and every
    stats field."""
    from fastconsensus_tpu_torch import policy
    from fastconsensus_tpu_torch.engine import (consensus_batch_block,
                                                consensus_batch_round,
                                                stats_to_host)

    slabs, nc = _bucket_jobs(2)
    slabs = [s.with_weights(torch.where(s.alive, 1.0, 0.0)) for s in slabs]
    n_p, det = 3, get_detector("louvain").warm_variant
    keys = [prng.key(s, "cpu") for s in (5, 6)]
    labels = [torch.arange(slabs[0].n_nodes).expand(n_p, -1)] * 2
    got = consensus_batch_block(slabs, keys, labels, [1, 1], [1, 1],
                                [False, False], [policy.INITIAL] * 2, True,
                                [(-1, -1, -1)] * 2, det, n_p, 0.2, 0.02, nc,
                                warm=True)
    want = consensus_batch_round(
        slabs, [prng.stream(k, prng.STREAM_ROUND, 1) for k in keys], det,
        n_p, 0.2, 0.02, nc, labels, [False, False], labels)
    assert got.done == [1, 1] and got.grow == [False, False]
    for j, (slab, lab, st) in enumerate(want):
        for f in ("src", "dst", "weight", "alive"):
            assert torch.equal(getattr(got.slabs[j], f), getattr(slab, f))
        assert torch.equal(got.labels[j], lab)
        host = stats_to_host([st])[0]._replace(cold=False)
        for a, b in zip(got.stats[j][0], host):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_batch_in_member_chunks_runs_no_block(monkeypatch):
    """A stacked stream in more than one member chunk takes no batched
    block (the solo driver's rule), and gives the same results."""
    slabs, nc = _bucket_jobs(2)
    cfg = dict(n_p=3, tau=0.2, delta=0.02, max_rounds=3, seed=0)
    want, calls = _batch_runs(monkeypatch, 8, slabs, "louvain", cfg, nc,
                              [1, 2])
    monkeypatch.setenv("FCTPU_ENSEMBLE_CHUNK", "2")
    got, none = _batch_runs(monkeypatch, 8, slabs, "louvain", cfg, nc,
                            [1, 2])
    assert calls and not none
    for a, b in zip(got, want):
        _assert_identical(a, b)


def test_stack_slabs_into_static_buffers():
    """``stack_slabs(out=)`` writes into a block's buffers in place (the
    addresses a captured graph reads) and refuses other statics;
    ``unstack_slab(copy=True)`` outlives the next write."""
    from fastconsensus_tpu_torch.graph import stack_slabs, unstack_slab

    slabs, _ = _bucket_jobs(3)
    buf = stack_slabs(slabs)
    ptrs = [getattr(buf, f).data_ptr() for f in ("src", "dst", "weight",
                                                  "alive")]
    kept = unstack_slab(buf, 0, copy=True)
    view = unstack_slab(buf, 0)
    out = stack_slabs(slabs[::-1], out=buf)
    assert out is buf and ptrs == [getattr(buf, f).data_ptr() for f in
                                   ("src", "dst", "weight", "alive")]
    for f in ("src", "dst", "weight", "alive"):
        assert torch.equal(getattr(kept, f), getattr(slabs[0], f))
        assert torch.equal(getattr(view, f), getattr(slabs[2], f))
    with pytest.raises(ValueError, match="cannot stack"):
        stack_slabs(slabs[:2], out=buf)


def test_stacked_members_take_their_rows_with_no_host_read(monkeypatch):
    """``members_of`` with the graphs' host ids picks the matmul rows
    with no read back, the same rows as the read-back form."""
    from fastconsensus_tpu_torch.graph import stack_slabs
    from fastconsensus_tpu_torch.models.louvain import Prepared

    prep = Prepared(stack_slabs(_bucket_jobs(3)[0]))
    graph_of = torch.arange(3).repeat_interleave(2)
    want = prep.members_of(graph_of).w_rows
    _refuse_host_reads(monkeypatch)
    got = prep.members_of(graph_of, np.repeat(np.arange(3), 2)).w_rows
    monkeypatch.undo()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("setting,cpu,cuda", [
    (None, 1, 1), ("1", 1, 1), ("8", 8, 8), ("20", 8, 8), ("0", 1, 1),
    ("auto", 1, None), (" AUTO ", 1, None)])
def test_rounds_block_size_setting(monkeypatch, setting, cpu, cuda):
    """Unset is one round a host step; an integer is clamped to 1..8;
    ``auto`` leaves the size to the first round's time on the card and is
    one round a step elsewhere."""
    if setting is None:
        monkeypatch.delenv("FCTPU_ROUNDS_BLOCK", raising=False)
    else:
        monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", setting)
    assert rounds_block_size(torch.device("cpu")) == cpu
    assert rounds_block_size(torch.device("cuda")) == cuda


def test_unset_block_size_runs_one_round_a_step(monkeypatch):
    """A run with FCTPU_ROUNDS_BLOCK unset takes no block."""
    monkeypatch.delenv("FCTPU_ROUNDS_BLOCK", raising=False)
    edges, n = _karate()
    reg = tcounters.get_registry()
    before = _blocks_run(reg)
    res = run_consensus(pack_edges(edges, n, device="cpu"),
                        get_detector("lpm"), ConsensusConfig(
                            algorithm="lpm", n_p=4, max_rounds=3, seed=5))
    assert res.rounds > 1 and _blocks_run(reg) == before


# -- each capture-safe piece against its eager twin ---------------------


def _hybrid_graph(n):
    """Planted communities plus grafted hubs (carries hybrid sizing)."""
    rng = np.random.default_rng(11)
    edges, _ = planted_partition(n, 10, 0.06, 0.0008, seed=4)
    hubs = rng.choice(n, 8, replace=False)
    extra = np.array([[h, int(o)] for h in hubs
                      for o in rng.choice(n, 120, replace=False)
                      if int(o) != h])
    return np.vstack([edges, extra]), n


def _planted_slab(n=200, seed=0, **kw):
    edges, _ = planted_partition(n, 4, 0.3, 0.02, seed=seed)
    return pack_edges(edges, n, device="cpu", **kw)


@pytest.mark.parametrize("path,theta,singleton_only", [
    ("matmul", 0.0, False), ("dense", 0.0, False), ("hybrid", 0.0, False),
    ("hash", 0.0, False), ("matmul", 0.3, True), ("dense", 0.3, True)])
def test_local_move_masked_matches_subset(monkeypatch, path, theta,
                                          singleton_only):
    """Every member sweeping (a stopped member keeps its labels) against
    the eager loop over the members still moving."""
    monkeypatch.setenv("FCTPU_MOVE_PATH", path)
    slab = _planted_slab(seed=3)
    if path == "hybrid":
        edges, n = _hybrid_graph(600)
        slab = pack_edges(edges, n, device="cpu")
        assert slab.d_hyb > 0
    slab = slab.with_weights(torch.where(slab.alive, 3.0, 0.0))
    keys = prng.partition_keys(prng.key(4, "cpu"), 5)
    kw = dict(max_sweeps=10, theta=theta, singleton_only=singleton_only,
              stop_frac=0.02)
    eager = louvain.local_move(slab, keys, **kw)
    with capture.capture_safe():
        safe = louvain.local_move(slab, keys, **kw)
    assert torch.equal(eager, safe)


def test_lpm_loop_masked_matches_subset():
    slab = _planted_slab(seed=5)
    keys = prng.partition_keys(prng.key(6, "cpu"), 5)
    prep = lpm.Prepared(slab)
    eager = lpm.lpm_members(prep, keys, max_iters=20)
    with capture.capture_safe():
        safe = lpm.lpm_members(lpm.Prepared(slab), keys, max_iters=20)
    assert torch.equal(eager, safe)


@pytest.mark.parametrize("path", ["dense", "hybrid"])
def test_prepared_without_overflow_carries_all_false_coin_rows(monkeypatch,
                                                              path):
    """No row overflows: ``Prepared`` carries an all-false ``coin_rows``
    tensor (no host read decides it), and the swap-breaking moves are
    those of no coin rows at all."""
    monkeypatch.setenv("FCTPU_MOVE_PATH", path)
    edges, n = _hybrid_graph(600)
    slab = pack_edges(edges, n, device="cpu")
    prep = louvain.Prepared(slab)
    assert prep.coin_rows is not None and not bool(prep.coin_rows.any())
    key = prng.key(2, "cpu")[None].expand(3, 2)
    want = torch.as_tensor(np.random.default_rng(0).random((3, n)) < 0.5)
    a = louvain._swap_break(key, slab, want, prep.adj, prep.hyb, None)
    b = louvain._swap_break(key, slab, want, prep.adj, prep.hyb,
                            prep.coin_rows)
    assert torch.equal(a, b)


# -- a capture-safe round makes no host read ------------------------------


class _NoHostRead(torch.utils._python_dispatch.TorchDispatchMode):
    """Raise on any op that reads a tensor's value to the host or sizes
    its output from the data."""

    BANNED = ("_local_scalar_dense", "nonzero", "masked_select", "item",
              "_unique2", "unique_consecutive", "unique_dim")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.BANNED:
            raise AssertionError(f"host read in a capture-safe round: "
                                 f"{name}")
        return func(*args, **(kwargs or {}))


def _refuse_host_reads(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("host read in a capture-safe round")

    for name in ("item", "__bool__", "tolist", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)


def _stacked_round_makes_no_host_read(monkeypatch):
    """One guarded round of a batched block (three karate-bucket jobs,
    Louvain's warm variant on the matmul sweep) with every host read
    refused, against the same round run unrefused."""
    from fastconsensus_tpu_torch import policy
    from fastconsensus_tpu_torch.engine import BatchBlock
    from fastconsensus_tpu_torch.serve import bucketer

    edges, n = _karate()
    graphs = [(edges, n), (edges[1:], n), (edges[:-3], n)]
    padded = [bucketer.pad_to_bucket(e, k, device="cpu") for e, k in graphs]
    slabs = [s.with_weights(torch.where(s.alive, 1.0, 0.0))
             for s, _ in padded]
    n_p, b = 4, len(slabs)
    det = get_detector("louvain").warm_variant
    labels = [torch.arange(slabs[0].n_nodes).expand(n_p, -1)] * b
    keys = [prng.key(s, "cpu") for s in (3, 4, 5)]
    args = (slabs, keys, labels, [2, 2, 2], [1, 1, 0], [True, False, True],
            [policy.INITIAL] * b, True, [(-1, -1, -1)] * b)

    def block():
        return BatchBlock(slabs[0], b, det, n_p, 0.2, 0.02,
                          padded[0][1].n_closure, warm=True, align_frac=1.0)

    want = block()
    want.load(*args)
    with capture.capture_safe():
        want._step()
    got = block()
    got.load(*args)
    _refuse_host_reads(monkeypatch)
    with _NoHostRead(), capture.capture_safe():
        got._step()
    monkeypatch.undo()
    assert got.i.tolist() == [1, 1, 0]
    for x, y in zip(got._state() + list(got.tmp),
                    want._state() + list(want.tmp)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("alg,path", [("louvain", "matmul"),
                                      ("louvain", "hybrid"),
                                      ("lpm", "dense"),
                                      ("leiden", "matmul"),
                                      ("leiden", "hybrid"),
                                      ("louvain", "matmul-stacked")])
def test_capture_safe_round_makes_no_host_read(monkeypatch, alg, path):
    if path.endswith("-stacked"):
        monkeypatch.setenv("FCTPU_MOVE_PATH", path.split("-")[0])
        _stacked_round_makes_no_host_read(monkeypatch)
        return
    monkeypatch.setenv("FCTPU_MOVE_PATH", path)
    if path == "hybrid":
        edges, n = _hybrid_graph(600)
    else:
        edges, n = _karate()
    slab = pack_edges(edges, n, device="cpu")
    slab = slab.with_weights(torch.where(slab.alive, 1.0, 0.0))
    n_p = 4
    det = get_detector(alg)
    det = getattr(det, "warm_variant", None) or det
    labels = torch.arange(n).expand(n_p, n)
    key = prng.stream(prng.key(3, "cpu"), prng.STREAM_ROUND, 2)
    align = torch.ones((), dtype=torch.bool)

    def one_round():
        with capture.capture_safe():
            return consensus_round(slab, key, det, n_p, 0.2, 0.02,
                                   n_closure, init_labels=labels,
                                   align=align,
                                   prev_labels=labels,
                                   active=torch.ones(n, dtype=torch.bool))

    n_closure = int(slab.num_alive()) // 4
    want = one_round()   # first use: lazy imports and caches
    _refuse_host_reads(monkeypatch)
    with _NoHostRead(), capture.capture_safe():
        got = consensus_round(slab, key, det, n_p, 0.2, 0.02, n_closure,
                              init_labels=labels, align=align,
                              prev_labels=labels,
                              active=torch.ones(n, dtype=torch.bool))
    monkeypatch.undo()
    assert torch.equal(got[1], want[1])
    for f in ("src", "dst", "weight", "alive"):
        assert torch.equal(getattr(got[0], f), getattr(want[0], f))


# -- the shape helper ------------------------------------------------------


def test_first_hash_build_imports_no_sympy():
    """``torch.broadcast_shapes`` imports sympy at its first call, a
    host stall of seconds; the hash build and the slab's member shape
    use a plain helper."""
    code = (
        "import sys, torch\n"
        "from fastconsensus_tpu_torch.ops import segment as seg\n"
        "from fastconsensus_tpu_torch.graph import pack_edges\n"
        "import numpy as np\n"
        "assert 'sympy' not in sys.modules, 'sympy at import'\n"
        "n = torch.arange(6); lab = torch.arange(6) % 3\n"
        "seg.build_hash_totals(n, lab, torch.ones(6), n >= 0, 64)\n"
        "s = pack_edges(np.array([[0, 1], [1, 2]]), 3, device='cpu')\n"
        "assert s.batch == ()\n"
        "assert 'sympy' not in sys.modules, 'sympy at first use'\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_broadcast_shape_matches_torch():
    from fastconsensus_tpu_torch.utils.shapes import broadcast_shape

    for shapes in [((3, 1), (1, 4)), ((), (2, 3)), ((5,), (4, 1)),
                   ((2, 1, 3), (4, 3)), ((7,),)]:
        assert broadcast_shape(*shapes) == torch.broadcast_shapes(*shapes)
    with pytest.raises(ValueError):
        broadcast_shape((3,), (4,))


# -- the host detectors (CNM, Infomap) in the blocks ----------------------
#
# On the CPU a block's host step calls the detector itself, job by job
# (``engine.HostDetect``, the plain version of the host node the card's
# graph holds); a round that does not go (a stopped block, a frozen job)
# detects nothing.  Exact, as above.


def _email_standin():
    """bench.py's emailEu stand-in (planted, n 1,005, 42 blocks)."""
    from fastconsensus_tpu_torch.utils import synth

    sizes = synth.heterogeneous_sizes(1005, 42, 0.85)
    edges, _ = synth.planted_partition(1005, 42, 0.6, 0.02, seed=42,
                                       sizes=sizes)
    return np.asarray(edges), 1005


def _host_calls(reg):
    return reg.counters().get("engine.host_detect.calls", 0)


@pytest.mark.parametrize("alg", ["cnm", "infomap"])
@pytest.mark.parametrize("graph", ["karate", "emailEu"])
def test_host_detector_block_matches_per_round(monkeypatch, alg, graph):
    """CNM and Infomap through ``run_consensus`` at FCTPU_ROUNDS_BLOCK=8
    against one round a host step: partitions, history and slab exactly.
    The block's host step runs once a round and not on the steps after
    the run converged (karate converges inside its first block, the
    stand-in runs six rounds at delta 0)."""
    edges, n = _karate() if graph == "karate" else _email_standin()
    slab = pack_edges(edges, n, device="cpu")
    cfg = dict(n_p=4 if graph == "emailEu" else 6,
               tau=0.7 if alg == "cnm" else 0.6,
               delta=0.0 if graph == "emailEu" else 0.02, seed=1,
               max_rounds=6)
    reg = tcounters.get_registry()
    calls0 = _host_calls(reg)
    blocked, n_blocks = _port(monkeypatch, 8, slab, alg, cfg)
    calls = _host_calls(reg) - calls0
    single, none = _port(monkeypatch, 1, slab, alg, cfg)
    assert n_blocks >= 1 and none == 0
    assert calls == blocked.rounds
    if graph == "karate":
        assert blocked.converged and blocked.rounds < cfg["max_rounds"]
    _assert_identical(blocked, single)


def _random_jobs():
    """Four seeded random graphs of one bucket (n64_e96)."""
    from fastconsensus_tpu_torch.serve import bucketer

    graphs = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        pairs = set()
        while len(pairs) < 90:
            u, v = rng.integers(0, 40, 2)
            if u != v:
                pairs.add((min(u, v), max(u, v)))
        graphs.append((np.array(sorted(pairs)), 40))
    padded = [bucketer.pad_to_bucket(e, n, device="cpu") for e, n in graphs]
    return [s for s, _ in padded], padded[0][1].n_closure


@pytest.mark.parametrize("alg", ["cnm", "infomap"])
def test_host_detector_batch_block_matches_per_round_and_solo(monkeypatch,
                                                              alg):
    """CNM and Infomap through ``run_consensus_batch`` at
    FCTPU_ROUNDS_BLOCK=8: one batched block, bitwise equal to one batched
    round a host step and to each job's solo run, the host step run once a
    batched round.  Infomap's jobs converge at rounds 1 to 4, so its later
    rounds run beside frozen jobs (CNM's all converge at round 2; the
    engine-level test below freezes its jobs)."""
    seeds = [11, 22, 33, 44]
    cfg = dict(n_p=4, tau=0.5, delta=0.0, max_rounds=5, seed=0)
    slabs, nc = _random_jobs()
    reg = tcounters.get_registry()
    calls0 = _host_calls(reg)
    blocked, calls = _batch_runs(monkeypatch, 8, slabs, alg, cfg, nc, seeds)
    host = _host_calls(reg) - calls0
    single, none = _batch_runs(monkeypatch, 1, slabs, alg, cfg, nc, seeds)
    assert len(calls) == 1 and not none
    assert blocked.splits == single.splits == {}
    rounds = [r.rounds for r in blocked]
    if alg == "infomap":
        assert rounds == [1, 2, 3, 4]
    assert host == max(rounds)
    for i, (a, b) in enumerate(zip(blocked, single)):
        _assert_identical(a, b)
        solo = run_consensus(slabs[i], get_detector(alg), ConsensusConfig(
            algorithm=alg, **cfg), key=prng.key(seeds[i], "cpu"),
            n_closure=nc)
        _assert_identical(a, solo)


def test_host_detector_batch_block_frozen_jobs_keep_their_state():
    """One batched block of CNM jobs run for 2, 0, 1 and 2 rounds
    (``max_iters``): each job equals its own rounds run eagerly one at a
    time (slab, labels and every stats field), a job given no rounds keeps
    its slab and labels, and the host step runs once a round that any
    job runs."""
    from fastconsensus_tpu_torch import engine, policy
    from fastconsensus_tpu_torch.engine import (consensus_batch_block,
                                                stats_to_host)

    slabs, nc = _random_jobs()
    slabs = [s.with_weights(torch.where(s.alive, 1.0, 0.0)) for s in slabs]
    n_p, tau, delta = 4, 0.5, 0.0
    det = get_detector("cnm")
    keys = [prng.key(s, "cpu") for s in (3, 4, 5, 6)]
    sing = torch.arange(slabs[0].n_nodes).expand(n_p, -1)
    iters = [2, 0, 1, 2]
    steps = []
    orig = engine.HostDetect.__call__

    def counted(self, k, runs):
        steps.append(runs.tolist())
        return orig(self, k, runs)

    engine.HostDetect.__call__ = counted
    try:
        res = consensus_batch_block(
            slabs, keys, [sing] * 4, [0] * 4, iters, [False] * 4,
            [policy.INITIAL] * 4, False, [(-1, -1, -1)] * 4, det, n_p, tau,
            delta, nc, warm=False)
    finally:
        engine.HostDetect.__call__ = orig
    assert steps == [[True, False, True, True], [True, False, False, True]]
    for j in range(4):
        slab, lab, want = slabs[j], sing, []
        for r in range(iters[j]):
            slab, lab, st = consensus_round(
                slab, prng.stream(keys[j], prng.STREAM_ROUND, r), det, n_p,
                tau, delta, nc, prev_labels=lab)
            want.append(stats_to_host([st])[0])
            if bool(st.converged):
                break
        assert res.done[j] == len(want)
        assert torch.equal(res.labels[j], lab)
        for f in ("src", "dst", "weight", "alive"):
            assert torch.equal(getattr(res.slabs[j], f), getattr(slab, f))
        for got, st in zip(res.stats[j], want):
            # a block without warm start marks each round cold, as the
            # driver records a round without warm start
            assert got.cold
            for x, y in zip(got._replace(cold=0), st._replace(cold=0)):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("alg", ["cnm", "infomap"])
def test_host_detect_entry_matches_the_detector(alg):
    """The C entry the card's host node calls (``fc_host_detect``), run
    here on staged buffers of two jobs: a job whose flag is set gets
    exactly the detector's labels from its slab and keys (alive slots
    compacted in slot order, seeds from the key words), a job whose flag
    is clear keeps its labels, and the counts follow."""
    from fastconsensus_tpu_torch import native
    from fastconsensus_tpu_torch.serve import bucketer

    n_p = 3
    padded = [bucketer.pad_to_bucket(e, n, device="cpu")
              for e, n in _RINGS[:2]]
    slabs = [s for s, _ in padded]
    # a dead slot among the live ones: compaction must skip it
    alive = slabs[0].alive.clone()
    alive[3] = False
    slabs[0] = dataclasses.replace(slabs[0], alive=alive)
    keys = torch.cat([prng.partition_keys(prng.key(s, "cpu"), n_p)
                      for s in (5, 6)])
    fields = [torch.stack([getattr(s, f) for s in slabs]).contiguous()
              for f in ("src", "dst", "weight", "alive")]
    b, cap = fields[0].shape
    n = slabs[0].n_nodes
    labels = np.full((b, n_p, n), -7, dtype=np.int32)
    runs = np.array([True, False])
    keys_np = keys.numpy().copy()
    host = [f.numpy() for f in fields]
    args = native.HostDetectArgs(
        detector=native.HOST_DETECTORS[f"{alg}_labels"], n_jobs=b,
        n_nodes=n, n_p=n_p, capacity=cap, key_words=keys.shape[1],
        src=host[0].ctypes.data, dst=host[1].ctypes.data,
        weight=host[2].ctypes.data, alive=host[3].ctypes.data,
        keys=keys_np.ctypes.data, runs=runs.ctypes.data,
        labels=labels.ctypes.data, calls=0, detections=0)
    native.host_detect(args)
    want = get_detector(alg)(slabs[0], keys[:n_p])
    np.testing.assert_array_equal(labels[0], want.numpy())
    assert (labels[1] == -7).all()
    assert (args.calls, args.detections) == (1, 1)
    runs[:] = False
    native.host_detect(args)
    assert (args.calls, args.detections) == (1, 1)
    np.testing.assert_array_equal(labels[0], want.numpy())


def test_host_detector_block_runs_no_warm_rounds():
    """A host detector has no warm variant: its block refuses one."""
    from fastconsensus_tpu_torch.engine import RoundsBlock

    edges, n = _karate()
    slab = pack_edges(edges, n, device="cpu")
    with pytest.raises(ValueError, match="no warm rounds"):
        RoundsBlock(slab, get_detector("cnm"), 4, 0.7, 0.02, 16, warm=True)


def test_no_host_read_admits_only_staged_buffers():
    """The capture's host-read guard lets a copy into a staging buffer
    registered for the capture through (it reaches the copy itself, which
    fails on the meta tensor standing in for the card's) and refuses
    every other copy to the host, a view of a registered buffer too."""
    from fastconsensus_tpu_torch.ops.capture import (CaptureError,
                                                     _NoHostRead)

    src = torch.empty(8, dtype=torch.int64, device="meta")
    staged = torch.zeros(8, dtype=torch.int64)
    other = torch.zeros(8, dtype=torch.int64)
    capture._local.staging = {staged.data_ptr(): staged.numel() * 8}
    try:
        with _NoHostRead():
            with pytest.raises(CaptureError, match="host read"):
                other.copy_(src)
            with pytest.raises(CaptureError, match="host read"):
                staged[:4].copy_(src[:4])
            with pytest.raises((NotImplementedError, RuntimeError)) as e:
                staged.copy_(src)
            assert not isinstance(e.value, CaptureError)
    finally:
        capture._local.staging = None
