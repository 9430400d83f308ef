"""The port's public names against the reference's: the top level's
``host_edges`` and ``__version__``, ``graph.to_networkx`` /
``from_networkx``, ``utils.metrics.modularity`` / ``map_equation`` and
``utils.synth.lfr_graph``, each on the same seeded inputs in both
packages.

Tolerances: labels, edges, weights and integer results are compared
exactly; ``modularity`` and ``map_equation`` are the same float64 host
sums in the same order, so they are compared exactly too."""

import sys

import numpy as np
import pytest
import torch

import fastconsensus_tpu as jpkg
import fastconsensus_tpu_torch as tpkg
from fastconsensus_tpu import graph as jgraph
from fastconsensus_tpu.utils import metrics as jmetrics
from fastconsensus_tpu.utils import synth as jsynth
from fastconsensus_tpu_torch import graph as tgraph
from fastconsensus_tpu_torch.utils import metrics as tmetrics
from fastconsensus_tpu_torch.utils import synth as tsynth

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)


def _weighted_graph(seed):
    edges, labels = jsynth.planted_partition(300, 6, 0.15, 0.01, seed=seed)
    rng = np.random.default_rng(seed)
    weights = rng.integers(1, 6, edges.shape[0]).astype(np.float32)
    return edges, labels, weights


def _thresholded_pair(seed):
    """The same slab in both packages with a seeded third of its slots
    killed, so the alive mask matters to the readback."""
    edges, _, weights = _weighted_graph(seed)
    j = jgraph.pack_edges(edges, 300, weights=weights)
    t = tgraph.pack_edges(edges, 300, weights=weights, device="cpu")
    kill = np.random.default_rng(seed + 1).random(t.capacity) < 0.33
    alive = np.asarray(j.alive) & ~kill
    j = j.with_weights(j.weight, alive=jgraph.jnp.asarray(alive))
    t = t.with_weights(t.weight, alive=torch.from_numpy(alive))
    return j, t


def test_version_and_all_match_the_reference():
    assert tpkg.__version__ == jpkg.__version__ == "0.1.0"
    assert set(jpkg.__all__) <= set(tpkg.__all__)
    for name in tpkg.__all__:
        assert getattr(tpkg, name) is not None, name
    assert tpkg.host_edges is tgraph.host_edges
    with pytest.raises(AttributeError):
        tpkg.no_such_name


@pytest.mark.parametrize("seed", [0, 3])
def test_host_edges_equal_reference(seed):
    j, t = _thresholded_pair(seed)
    for a, b in zip(tpkg.host_edges(t), jpkg.host_edges(j)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("seed", [0, 3])
def test_to_networkx_equals_reference(seed):
    j, t = _thresholded_pair(seed)
    gt, gj = tgraph.to_networkx(t), jgraph.to_networkx(j)
    assert sorted(gt.nodes()) == sorted(gj.nodes())
    assert sorted(gt.edges(data="weight")) == sorted(gj.edges(data="weight"))


def test_from_networkx_equals_reference():
    import networkx as nx

    g = nx.relabel_nodes(nx.karate_club_graph(),
                         {i: f"v{i:02d}" for i in range(34)})
    for k, (a, b) in enumerate(g.edges()):
        g.edges[a, b]["weight"] = float(1 + k % 4)
    j = jgraph.from_networkx(g, capacity=200)
    t = tgraph.from_networkx(g, capacity=200, device="cpu")
    for name in ("n_nodes", "capacity", "d_cap", "cap_hint", "d_hyb",
                 "hub_cap", "agg_cap"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("src", "dst", "weight", "alive"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    # the round trip keeps every alive edge and its weight
    back = tgraph.to_networkx(t)
    assert back.number_of_edges() == g.number_of_edges()


def test_missing_networkx_raises_import_error_naming_it(monkeypatch):
    t = tgraph.pack_edges(np.array([[0, 1]]), 2, device="cpu")
    monkeypatch.setitem(sys.modules, "networkx", None)
    for call in (lambda: tgraph.to_networkx(t),
                 lambda: tsynth.lfr_graph(100, 0.3)):
        with pytest.raises(ImportError, match="networkx"):
            call()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fn", ["modularity", "map_equation"])
def test_quality_metrics_equal_reference(fn, seed):
    edges, labels, weights = _weighted_graph(seed)
    rng = np.random.default_rng(seed + 10)
    noisy = np.where(rng.random(labels.shape[0]) < 0.2,
                     rng.integers(0, 6, labels.shape[0]), labels)
    for lab, w in ((labels, weights), (noisy, weights), (noisy, None)):
        w = np.ones(edges.shape[0]) if w is None else w
        args = (edges[:, 0], edges[:, 1], w, lab)
        got = getattr(tmetrics, fn)(*args)
        want = getattr(jmetrics, fn)(*args)
        assert isinstance(got, float)
        assert got == want, (fn, got, want)


@pytest.mark.parametrize("fn", ["modularity", "map_equation"])
def test_quality_metrics_on_an_empty_graph(fn):
    empty = np.zeros(0, dtype=np.int64)
    args = (empty, empty, np.zeros(0), np.zeros(3, dtype=np.int64))
    assert getattr(tmetrics, fn)(*args) == getattr(jmetrics, fn)(*args) == 0


def test_lfr_graph_equals_reference():
    te, tl = tsynth.lfr_graph(1000, 0.5, seed=42)
    je, jl = jsynth.lfr_graph(1000, 0.5, seed=42)
    assert te.dtype == je.dtype == np.int64
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tl, jl)


def test_lfr_graph_retries_on_successive_seeds(monkeypatch):
    """Both packages retry a failing seed with seed + 1, then give up
    with the same RuntimeError."""
    import networkx as nx

    real = nx.LFR_benchmark_graph
    seen = []

    def flaky(*args, seed=None, **kw):
        seen.append(seed)
        if seed < 8:
            raise nx.ExceededMaxIterations("no convergence")
        return real(*args, seed=seed, **kw)

    monkeypatch.setattr(nx, "LFR_benchmark_graph", flaky)
    got = tsynth.lfr_graph(250, 0.3, seed=7)
    t_seen, seen[:] = list(seen), []
    want = jsynth.lfr_graph(250, 0.3, seed=7)
    assert t_seen == seen == [7, 8]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for mod in (tsynth, jsynth):
        with pytest.raises(RuntimeError, match="after 2 seeds"):
            mod.lfr_graph(250, 0.3, seed=0, max_tries=2)
