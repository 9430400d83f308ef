"""The port's slab packing, growth and sizing equal the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastconsensus_tpu import graph as jgraph
from fastconsensus_tpu.utils.synth import planted_partition
from fastconsensus_tpu_torch import graph as tgraph

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

STATICS = ("n_nodes", "d_cap", "cap_hint", "d_hyb", "hub_cap", "agg_cap",
           "capacity")


def assert_same_slab(t, j):
    for name in STATICS:
        assert getattr(t, name) == getattr(j, name), name
    for name in ("src", "dst", "weight", "alive"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    np.testing.assert_array_equal(t.degrees().numpy(), np.asarray(j.degrees()))
    np.testing.assert_array_equal(t.strengths().numpy(),
                                  np.asarray(j.strengths()))
    for a, b in zip(t.directed(), j.directed()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def graphs(karate_edges):
    edges, _, ids = karate_edges
    planted, _ = planted_partition(500, 5, 0.2, 0.01, seed=1)
    rng = np.random.default_rng(0)
    # duplicates, reversed duplicates and self-loops exercise dedup
    messy = np.vstack([planted, planted[:50, ::-1], [[3, 3], [7, 7]]])
    weights = rng.integers(1, 5, messy.shape[0]).astype(np.float32)
    return [(edges, len(ids), None, None), (planted, 500, None, None),
            (messy, 500, weights, None), (planted, 500, None, 9000)]


@pytest.mark.parametrize("case", range(4))
def test_pack_edges_identical(karate_edges, case):
    edges, n, w, cap = graphs(karate_edges)[case]
    assert_same_slab(tgraph.pack_edges(edges, n, weights=w, capacity=cap,
                                       device="cpu"),
                     jgraph.pack_edges(edges, n, weights=w, capacity=cap))


@pytest.mark.parametrize("extra", [0, 1, 100])
def test_grow_slab_identical(karate_edges, extra):
    edges, _, ids = karate_edges
    j = jgraph.pack_edges(edges, len(ids))
    t = tgraph.pack_edges(edges, len(ids), device="cpu")
    assert_same_slab(tgraph.grow_slab(t, t.capacity + extra),
                     jgraph.grow_slab(j, j.capacity + extra))
    with pytest.raises(ValueError):
        tgraph.grow_slab(t, t.capacity - 1)


def test_with_weights(karate_edges):
    edges, _, ids = karate_edges
    j = jgraph.pack_edges(edges, len(ids))
    t = tgraph.pack_edges(edges, len(ids), device="cpu")
    w = np.arange(j.capacity, dtype=np.float32)
    alive = np.asarray(j.alive).copy()
    alive[::3] = False
    jt = j.with_weights(jnp.asarray(w), jnp.asarray(alive))
    tt = t.with_weights(torch.as_tensor(w), torch.as_tensor(alive))
    assert_same_slab(tt, jt)


@pytest.mark.parametrize("seed", range(6))
def test_sizing_rules_identical(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 5000))
    deg = rng.zipf(1.6 + seed / 10, n).clip(0, 3000).astype(np.int64)
    e = int(deg.sum() // 2)
    assert tgraph.derive_dense_sizing(deg, n) == \
        jgraph.derive_dense_sizing(deg, n)
    assert tgraph.derive_hybrid_sizing(deg, n, e) == \
        jgraph.derive_hybrid_sizing(deg, n, e)
    assert tgraph.derive_agg_sizing(e) == jgraph.derive_agg_sizing(e)


@pytest.mark.parametrize("agg_cap", ["below", "above"])
def test_compact_alive_identical(agg_cap):
    """compact_alive, per member, against the reference's on each
    member's slab: slots, weights and alive count (a cap below the alive
    count drops the tail)."""
    planted, _ = planted_partition(300, 4, 0.2, 0.02, seed=3)
    j = jgraph.pack_edges(planted, 300)
    rng = np.random.default_rng(1)
    alive = np.stack([np.asarray(j.alive) & (rng.random(j.capacity) < p)
                      for p in (0.5, 0.9, 1.0)])
    w = rng.integers(1, 9, j.capacity).astype(np.float32)
    t = tgraph.pack_edges(planted, 300, device="cpu").with_weights(
        torch.as_tensor(w), torch.as_tensor(alive))
    n_alive = alive.sum(axis=1)
    cap = int(n_alive.min()) - 7 if agg_cap == "below" else \
        int(n_alive.max()) + 64
    got = tgraph.compact_alive(t, cap)
    assert got.batch == (3,) and got.capacity == cap
    for i in range(3):
        ji = jgraph.compact_alive(
            j.with_weights(jnp.asarray(w), jnp.asarray(alive[i])), cap)
        for name in ("src", "dst", "weight", "alive"):
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(),
                                          np.asarray(getattr(ji, name)))
        for name in STATICS:
            assert getattr(got, name) == getattr(ji, name), name
        np.testing.assert_array_equal(got.degrees()[i].numpy(),
                                      np.asarray(ji.degrees()))
        np.testing.assert_array_equal(got.strengths()[i].numpy(),
                                      np.asarray(ji.strengths()))


def test_batched_slab_reductions_keep_self_loop_convention():
    """Member-batched slabs (aggregate graphs carry self-loops): degrees
    and strengths count a self-loop twice, 2m is per member, as the
    reference's reductions on each member's slab."""
    rng = np.random.default_rng(2)
    cap, n = 64, 12
    src = rng.integers(0, n, (2, cap))
    dst = np.where(rng.random((2, cap)) < 0.2, src,
                   rng.integers(0, n, (2, cap)))
    w = rng.integers(1, 30, (2, cap)).astype(np.float32)
    alive = rng.random((2, cap)) < 0.8
    t = tgraph.GraphSlab(src=torch.as_tensor(src), dst=torch.as_tensor(dst),
                         weight=torch.as_tensor(w),
                         alive=torch.as_tensor(alive), n_nodes=n)
    for i in range(2):
        j = jgraph.GraphSlab(src=jnp.asarray(src[i], jnp.int32),
                             dst=jnp.asarray(dst[i], jnp.int32),
                             weight=jnp.asarray(w[i]),
                             alive=jnp.asarray(alive[i]), n_nodes=n)
        np.testing.assert_array_equal(t.degrees()[i].numpy(),
                                      np.asarray(j.degrees()))
        np.testing.assert_array_equal(t.strengths()[i].numpy(),
                                      np.asarray(j.strengths()))
        for a, b in zip(t.directed(), j.directed()):
            np.testing.assert_array_equal(a[i].numpy(), np.asarray(b))
        _, _, wd, ad = j.directed()
        assert float(t.total_weight()[i]) == float(
            jnp.sum(jnp.where(ad, wd, 0.0)))
    assert t.take(torch.tensor([1])).batch == (1,)


def test_lfr10k_file():
    """The committed lfr10k graph (``synth.lfr_graph(10000, 0.5,
    seed=42)``): 10,000 nodes, 58,712 unique edges, no self-loops."""
    from pathlib import Path

    z = np.load(Path(__file__).resolve().parent.parent / "bench_data" /
                "lfr10k.npz")
    edges, labels = z["edges"], z["labels"]
    assert labels.shape == (10_000,) and edges.shape == (58_712, 2)
    assert edges.min() >= 0 and edges.max() < 10_000
    assert (edges[:, 0] != edges[:, 1]).all()
    canon = np.sort(edges, axis=1)
    assert np.unique(canon, axis=0).shape[0] == 58_712
    assert len(np.unique(labels)) == 106


@pytest.mark.parametrize("sized", [False, True])
def test_planted_partition_copy_identical(sized):
    """The port's copy of the generator draws the reference's graph; the
    sized case is bench.py's email-Eu-core stand-in (n 1,005, 42 blocks,
    size_alpha 0.85, seed 42: 24,288 edges)."""
    from fastconsensus_tpu_torch.utils import synth as tsynth

    if sized:
        sizes = tsynth.heterogeneous_sizes(1005, 42, 0.85)
        w = np.arange(1, 43, dtype=float) ** -0.85   # bench.py:make_graph
        ref = np.maximum((w / w.sum() * 1005).astype(np.int64), 2)
        while ref.sum() > 1005:
            ref[np.argmax(ref)] -= 1
        while ref.sum() < 1005:
            ref[np.argmin(ref)] += 1
        np.testing.assert_array_equal(sizes, ref)
        args = (1005, 42, 0.6, 0.02)
        kw = dict(seed=42, sizes=sizes)
    else:
        args, kw = (500, 5, 0.2, 0.01), dict(seed=1)
    got = tsynth.planted_partition(*args, **kw)
    want = planted_partition(*args, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if sized:
        assert got[0].shape == (24_288, 2)
        assert tgraph.pack_edges(got[0], 1005, device="cpu").d_cap == 176
