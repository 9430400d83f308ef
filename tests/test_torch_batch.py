"""The cross-graph batch (``run_consensus_batch``) and its shape buckets:
the PyTorch port against the JAX reference, on the CPU.

Inputs are built with numpy from fixed seeds and fed to both packages.
Tolerance: exact for every bucket, slab field, label, partition and
integer round statistic, and for the port's batch against its own solo
runs (whole history included); the two float round metrics (member
modularity, agreement) are sums taken in another order than JAX's, rtol
1e-5 against the reference, as in ``test_torch_consensus.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from fastconsensus_tpu.consensus import ConsensusConfig as JConfig
from fastconsensus_tpu.consensus import run_consensus as jsolo
from fastconsensus_tpu.consensus import run_consensus_batch as jbatch
from fastconsensus_tpu.graph import stack_slabs as jstack
from fastconsensus_tpu.models.registry import get_detector as jdetector
from fastconsensus_tpu.serve import bucketer as jb
from fastconsensus_tpu.serve.jobs import canonical_edges as jcanonical
from fastconsensus_tpu.sizing import grid_up as jgrid_up
from fastconsensus_tpu_torch import sizing
from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                               run_consensus,
                                               run_consensus_batch)
from fastconsensus_tpu_torch.graph import (pack_edges, stack_slabs,
                                           unstack_slab)
from fastconsensus_tpu_torch.models.registry import get_detector
from fastconsensus_tpu_torch.serve import bucketer as tb
from fastconsensus_tpu_torch.serve.jobs import canonical_edges
from fastconsensus_tpu_torch.utils import prng

FIELDS = ("src", "dst", "weight", "alive")
STATICS = ("n_nodes", "capacity", "d_cap", "cap_hint", "d_hyb", "hub_cap",
           "agg_cap")


def ring_graph(n, chords=0, shift=7):
    idx = np.arange(n)
    edges = [np.stack([idx, (idx + 1) % n], 1)]
    if chords:
        c = np.arange(chords)
        edges.append(np.stack([c % n, (c + shift) % n], 1))
    return np.concatenate(edges).astype(np.int64)


def bucket_graphs():
    """Four distinct graphs of one bucket (n64_e96) with different edge
    counts (68 / 78 / 66 / 72 canonical edges), as the reference's
    batch tests use."""
    return [(ring_graph(34, 40), 34),
            (ring_graph(40, 38, shift=5), 40),
            (ring_graph(33, 52, shift=13), 33),
            (ring_graph(36, 44, shift=11), 36)]


def assert_slab_equal(ts, js, statics=STATICS):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    for f in statics:
        assert getattr(ts, f) == getattr(js, f), f


# -- numpy and slab helpers ---------------------------------------------


def test_grid_up_matches_reference():
    for n in list(range(0, 200)) + [1005, 10000, 58712, 2 ** 20 + 1]:
        for minimum in (1, 64):
            assert sizing.grid_up(n, minimum) == jgrid_up(n, minimum), n


def test_canonical_edges_matches_reference():
    rng = np.random.default_rng(4)
    edges = rng.integers(0, 40, (300, 2))      # self-loops and duplicates
    w = rng.random(300).astype(np.float32)
    for weights in (None, w):
        got = canonical_edges(edges, 40, weights)
        want = jcanonical(edges, 40, weights)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype


def test_bucket_for_and_keys_match_reference():
    for n, e in [(1, 1), (34, 78), (64, 65), (1005, 20000), (10000, 58712),
                 (12289, 98305)]:
        assert dataclasses.astuple(tb.bucket_for(n, e)) == \
            dataclasses.astuple(jb.bucket_for(n, e))
        t, j = tb.bucket_for(n, e), jb.bucket_for(n, e)
        assert (t.capacity, t.agg_cap, t.n_closure, t.key(), t.describe()) \
            == (j.capacity, j.agg_cap, j.n_closure, j.key(), j.describe())
        assert tb.bucket_from_key(t.key()) == t
    for args in [(0, 5, None, None), (100, 50, 64, None),
                 (10, 500, None, 100)]:
        with pytest.raises(ValueError) as te:
            tb.bucket_for(*args)
        with pytest.raises(ValueError) as je:
            jb.bucket_for(*args)
        assert str(te.value) == str(je.value)
        assert (te.type is tb.BucketTooLarge) == \
            (je.type is jb.BucketTooLarge)
    for key in ("n64", "x64_e96", "n65_e96"):
        with pytest.raises(ValueError) as te:
            tb.bucket_from_key(key)
        with pytest.raises(ValueError) as je:
            jb.bucket_from_key(key)
        assert str(te.value) == str(je.value)
    assert tb.BATCH_LADDER == jb.BATCH_LADDER
    assert [tb.batch_rung(n) for n in range(12)] == \
        [jb.batch_rung(n) for n in range(12)]
    bucket = tb.bucket_for(200, 300)
    for variant in (0, 3):
        np.testing.assert_array_equal(
            tb.probe_edges(bucket, variant),
            jb.probe_edges(jb.bucket_for(200, 300), variant))


@pytest.mark.parametrize("weighted", [False, True])
def test_pad_to_bucket_matches_reference(weighted):
    for i, (edges, n) in enumerate(bucket_graphs()):
        w = None
        if weighted:
            w = np.random.default_rng(i).integers(
                1, 5, edges.shape[0]).astype(np.float32)
        ts, tbk = tb.pad_to_bucket(edges, n, weights=w, device="cpu")
        js, jbk = jb.pad_to_bucket(edges, n, weights=w)
        assert tbk.key() == jbk.key() == "n64_e96"
        assert_slab_equal(ts, js)
        assert (ts.d_cap, ts.d_hyb, ts.hub_cap) == (0, 0, 0)
        assert ts.cap_hint == tbk.capacity and ts.agg_cap == tbk.agg_cap
    bad = np.array([1.0, np.nan], np.float32)
    with pytest.raises(ValueError, match="non-finite edge weights"):
        tb.pad_to_bucket(np.array([[0, 1], [1, 2]]), 3, weights=bad,
                         device="cpu")


def test_stack_slabs_matches_reference_and_unstacks():
    graphs = bucket_graphs()
    ts = [tb.pad_to_bucket(e, n, device="cpu")[0] for e, n in graphs]
    js = [jb.pad_to_bucket(e, n)[0] for e, n in graphs]
    st, sj = stack_slabs(ts), jstack(js)
    assert st.src.shape == (4, ts[0].capacity) and tuple(st.batch) == (4,)
    # the reference's stacked slab reads its capacity off the leading
    # axis (4); the port's stays the slots of each graph
    assert st.capacity == ts[0].capacity
    assert_slab_equal(st, sj, [f for f in STATICS if f != "capacity"])
    for b, s in enumerate(ts):
        u = unstack_slab(st, b)
        assert_slab_equal(u, js[b])
        assert u.batch == torch.Size([])
    # differing statics: the same error text as the reference's
    other_t = pack_edges(graphs[0][0], 34, device="cpu")
    from fastconsensus_tpu.graph import pack_edges as jpack
    other_j = jpack(graphs[0][0], 34)
    with pytest.raises(ValueError) as te:
        stack_slabs([ts[0], other_t])
    with pytest.raises(ValueError) as je:
        jstack([js[0], other_j])
    assert str(te.value) == str(je.value)
    assert "differing static shapes" in str(te.value)
    with pytest.raises(ValueError) as te:
        stack_slabs([])
    with pytest.raises(ValueError) as je:
        jstack([])
    assert str(te.value) == str(je.value)


# -- detection on a graph-stacked slab ----------------------------------


def _stack_inputs(big: bool):
    """Bucketed graphs with different edge counts: the four rings (the
    matmul sweep) or two 1,100-node graphs (the hash sweep)."""
    if not big:
        return [tb.pad_to_bucket(e, n, device="cpu")[0]
                for e, n in bucket_graphs()]
    rng = np.random.default_rng(8)
    slabs = []
    for extra in (0, 150):
        e = ring_graph(1100, 1100, shift=9)
        e = np.vstack([e, rng.integers(0, 1100, (200 + extra, 2))])
        slabs.append(tb.pad_to_bucket(e, 1100, device="cpu")[0])
    return slabs


@pytest.mark.parametrize("big", [False, True], ids=["matmul", "hash"])
@pytest.mark.parametrize("alg", ["louvain", "leiden", "lpm"])
def test_stacked_detection_equals_per_graph(monkeypatch, alg, big):
    """One detection stream over B graphs gives each graph's members the
    labels of detecting that graph alone: each member's strengths, 2m
    and rows are its own graph's.  Member chunks of 3 straddle graphs.
    Exact."""
    from fastconsensus_tpu_torch.models.louvain import select_move_path

    monkeypatch.setenv("FCTPU_ENSEMBLE_CHUNK", "3")
    slabs = _stack_inputs(big)
    assert select_move_path(slabs[0]) == ("hash" if big else "matmul")
    assert len({int(s.num_alive()) for s in slabs}) == len(slabs)
    det = get_detector(alg)
    n_p = 2 if big else 4
    keys = [prng.partition_keys(prng.key(7 + b, "cpu"), n_p)
            for b in range(len(slabs))]
    # warm-started members on the small graphs, cold ones on the large
    init = None
    if not big:
        rng = np.random.default_rng(2)
        init = [torch.as_tensor(rng.integers(0, 5, (n_p, slabs[0].n_nodes)))
                for _ in slabs]
    got = det(stack_slabs(slabs), torch.cat(keys),
              None if init is None else torch.cat(init))
    for b, s in enumerate(slabs):
        want = det(s, keys[b], None if init is None else init[b])
        assert torch.equal(got[b * n_p:(b + 1) * n_p], want), b


def test_stacked_lpm_dense_rows_equal_per_graph(monkeypatch):
    """LPM's dense vote (slabs that carry a row width) on a stacked slab:
    the member-batched rows' ``take`` keeps each member's own rows."""
    monkeypatch.setenv("FCTPU_ENSEMBLE_CHUNK", "3")
    slabs = []
    for e, n in bucket_graphs():
        s = pack_edges(e, 40, capacity=200, device="cpu")
        slabs.append(dataclasses.replace(s, d_cap=16, d_hyb=0, hub_cap=0,
                                         cap_hint=200, agg_cap=0))
    det = get_detector("lpm")
    keys = [prng.partition_keys(prng.key(b, "cpu"), 4) for b in range(4)]
    got = det(stack_slabs(slabs), torch.cat(keys))
    for b, s in enumerate(slabs):
        assert torch.equal(got[b * 4:(b + 1) * 4], det(s, keys[b]))


def test_stacked_matmul_members_share_their_graphs_matrix():
    """On the matmul sweep the members of a stacked slab read their
    graph's dense matrix by view (one ``[N, N]`` per graph, not per
    member); what is copied per member is counted for the chunk budget."""
    from fastconsensus_tpu_torch.models.louvain import Prepared

    slabs = _stack_inputs(False)
    prep = Prepared(stack_slabs(slabs))
    assert prep.path == "matmul" and prep.W.shape[0] == 4
    graph_of = torch.arange(4).repeat_interleave(3)
    p = prep.members_of(graph_of)
    assert p.W.data_ptr() == prep.W.data_ptr() and p.W.shape[0] == 4
    assert p.w_rows.tolist() == graph_of.tolist()
    assert p.slab.src.shape == (12, slabs[0].capacity)
    q = p.take(torch.tensor([0, 4, 5, 11]))
    assert q.W.data_ptr() == prep.W.data_ptr()
    assert q.w_rows.tolist() == [0, 1, 1, 3]
    # int64 src and dst, float32 weight, bool alive; 2m and strengths
    n, cap = slabs[0].n_nodes, slabs[0].capacity
    assert prep.member_copy_bytes() == 21 * cap + 4 + 4 * n


# -- run_consensus_batch ----------------------------------------------


def _compare_to_reference(tres, jres):
    assert tres.rounds == jres.rounds
    assert tres.converged == jres.converged
    assert len(tres.history) == len(jres.history)
    for a, b in zip(tres.history, jres.history):
        assert a.keys() == b.keys()
        for k, v in b.items():
            if k in ("agreement", "modularity_mean"):
                assert a[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
            elif k == "modularity_by_member":
                np.testing.assert_allclose(a[k], v, rtol=1e-5, atol=1e-6)
            else:
                assert a[k] == v, k
    np.testing.assert_array_equal(np.stack(tres.partitions),
                                  np.stack(jres.partitions))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tres.graph, f).numpy(),
                                      np.asarray(getattr(jres.graph, f)))


def _compare_exact(a, b):
    assert (a.rounds, a.converged, a.history) == \
        (b.rounds, b.converged, b.history)
    for p, q in zip(a.partitions, b.partitions):
        np.testing.assert_array_equal(p, q)
    for f in FIELDS:
        assert torch.equal(getattr(a.graph, f), getattr(b.graph, f)), f


@pytest.mark.parametrize("case", ["warm", "scratch", "no_rounds"])
def test_batch_matches_reference_and_solo(monkeypatch, case):
    """Every job of a batch equals JAX's batch and the port's own solo
    run at the same seed.  Warm: the four rings, n_p 4, 10 rounds, with
    stagnation refreshes, convergence at different rounds and no split.
    Scratch (warm start off): two graphs, 3 rounds.  No rounds
    (max_rounds 0): the final re-detection follows the solo driver's
    rule (the full-sweep detector, since no round ran), so each job
    equals JAX's solo run; JAX's batch driver runs the warm variant
    there, which the port's batch does not follow."""
    monkeypatch.setenv("FCTPU_DETECT_CALL_MEMBERS", "0")
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "8")
    graphs = bucket_graphs()
    cfg = dict(algorithm="louvain", n_p=4, tau=0.2, delta=0.02,
               max_rounds=10, seed=0)
    seeds = [11, 22, 33, 44]
    if case == "scratch":
        graphs, seeds = graphs[:2], [5, 6]
        cfg.update(max_rounds=3, warm_start=False)
    if case == "no_rounds":
        graphs, seeds = graphs[:2], [5, 6]
        cfg.update(max_rounds=0)
    padded = [tb.pad_to_bucket(e, n, device="cpu") for e, n in graphs]
    slabs = [s for s, _ in padded]
    nc = padded[0][1].n_closure
    jslabs = [jb.pad_to_bucket(e, n)[0] for e, n in graphs]
    if case == "no_rounds":
        jres = [jsolo(s, jdetector("louvain"), JConfig(**cfg),
                      key=jax.random.key(sd), n_closure=nc)
                for s, sd in zip(jslabs, seeds)]
    else:
        jres = jbatch(jslabs, jdetector("louvain"), JConfig(**cfg),
                      n_closure=nc, seeds=seeds)
    det = get_detector("louvain")
    tres = run_consensus_batch(slabs, det, ConsensusConfig(**cfg),
                               n_closure=nc, seeds=seeds)
    assert tres.splits == {}
    for i, (t, j) in enumerate(zip(tres, jres)):
        _compare_to_reference(t, j)
        solo = run_consensus(slabs[i], det, ConsensusConfig(**cfg),
                             key=prng.key(seeds[i], "cpu"), n_closure=nc)
        _compare_exact(t, solo)
    if case == "warm":
        assert len({t.rounds for t in tres}) > 1
        assert any(h["cold"] for t in tres for h in t.history[1:]), \
            "no stagnation refresh ran batched"


def test_batch_forced_split_equals_solo(caplog):
    """A capacity too small for one job's closure: its round drops edges,
    so it splits off and re-runs alone (growing its slab); the others
    stay batched.  Every result still equals its solo run, exactly."""
    # at 124 slots only the fourth job's closure overflows in 4 rounds
    # (at 100 all four do, at 132 none)
    slabs = []
    for e, n in bucket_graphs():
        s = pack_edges(e, 40, capacity=124, device="cpu")
        slabs.append(dataclasses.replace(s, d_cap=0, d_hyb=0, hub_cap=0,
                                         cap_hint=124, agg_cap=8192))
    cfg = ConsensusConfig(algorithm="louvain", n_p=4, tau=0.2, delta=0.02,
                          max_rounds=4, seed=0)
    det = get_detector("louvain")
    seeds = [1, 2, 3, 4]
    with caplog.at_level("INFO", logger="fastconsensus_tpu_torch"):
        res = run_consensus_batch(slabs, det, cfg, n_closure=96,
                                  seeds=seeds)
    assert list(res.splits) == [3]
    assert res.splits[3].startswith("slab saturated at round")
    assert "batch job 3 split off to solo" in caplog.text
    assert res[3].graph.capacity > 124
    assert all(r.graph.capacity == 124 for r in res[:3])
    for i, s in enumerate(slabs):
        solo = run_consensus(s, det, cfg, key=prng.key(seeds[i], "cpu"),
                             n_closure=96)
        _compare_exact(res[i], solo)


def test_batch_budget_split_equals_solo(caplog):
    """Aggregate budgets too small for some jobs' live edges: after a
    round whose alive edges pass 5/4 of ``agg_cap`` the solo driver
    re-derives the budgets (new statics, so the job leaves the bucket
    and re-runs alone); the other jobs stay batched.  Every result equals
    its solo run, exactly."""
    # at agg_cap 76 the budgets fire for jobs whose alive edges pass 95
    # (the second and fourth, after round 1)
    slabs = [dataclasses.replace(tb.pad_to_bucket(e, n, device="cpu")[0],
                                 agg_cap=76) for e, n in bucket_graphs()]
    cfg = ConsensusConfig(algorithm="louvain", n_p=4, tau=0.2, delta=0.02,
                          max_rounds=6, seed=0)
    det = get_detector("louvain")
    seeds = [11, 22, 33, 44]
    with caplog.at_level("INFO", logger="fastconsensus_tpu_torch"):
        res = run_consensus_batch(slabs, det, cfg, n_closure=96,
                                  seeds=seeds)
    assert sorted(res.splits) == [1, 3], res.splits
    assert all(why.startswith("budget re-derivation after round")
               for why in res.splits.values())
    assert "move-candidate budgets starved" in caplog.text
    for i, s in enumerate(slabs):
        solo = run_consensus(s, det, cfg, key=prng.key(seeds[i], "cpu"),
                             n_closure=96)
        _compare_exact(res[i], solo)
        assert (i in res.splits) == any(
            h["n_alive"] * 4 > 76 * 5 for h in solo.history)


def test_batch_argument_errors_match_reference():
    """Each argument error the reference raises, with its message."""
    graphs = bucket_graphs()[:2]
    ts = [tb.pad_to_bucket(e, n, device="cpu")[0] for e, n in graphs]
    js = [jb.pad_to_bucket(e, n)[0] for e, n in graphs]
    tcfg, jcfg = ConsensusConfig(n_p=2, max_rounds=1), JConfig(n_p=2,
                                                                max_rounds=1)
    cases = [
        (dict(slabs=[]), dict(slabs=[])),
        (dict(seeds=[1, 2], keys=[prng.key(1, "cpu")] * 2),
         dict(seeds=[1, 2], keys=[jax.random.key(1)] * 2)),
        (dict(seeds=[1]), dict(seeds=[1])),
        (dict(keys=[prng.key(1, "cpu")]), dict(keys=[jax.random.key(1)])),
    ]
    for tkw, jkw in cases:
        with pytest.raises(ValueError) as te:
            run_consensus_batch(tkw.pop("slabs", ts), get_detector("louvain"),
                                tcfg, n_closure=96, **tkw)
        with pytest.raises(ValueError) as je:
            jbatch(jkw.pop("slabs", js), jdetector("louvain"), jcfg,
                   n_closure=96, **jkw)
        assert str(te.value) == str(je.value)
    with pytest.raises(TypeError, match="n_closure"):
        run_consensus_batch(ts, get_detector("louvain"), tcfg)


def test_batch_runs_on_the_slabs_device():
    """The slabs come from ``pad_to_bucket``, which puts them on the card
    unless the caller names another device and never falls back."""
    e, n = bucket_graphs()[0]
    if torch.cuda.is_available():
        assert tb.pad_to_bucket(e, n)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tb.pad_to_bucket(e, n)
