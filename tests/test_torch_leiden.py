"""Leiden parity: the PyTorch port against the JAX reference, on the CPU.

The refinement's theta scoring, the singleton-only move rule, the
per-member masked and aggregate slabs and the whole detector must give
the reference's labels.  Theta refinement adds Gumbel noise whose logs
the port takes in float64 (``segment.gumbel_from_uniform``): within ~1e-6
of the reference's float32 logs, which flips a choice only between two
noised scores that close; no test graph here meets one, so every
comparison is exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastconsensus_tpu.graph import compact_alive as jcompact
from fastconsensus_tpu.graph import pack_edges as jpack
from fastconsensus_tpu.models import leiden as jld
from fastconsensus_tpu.models import louvain as jlv
from fastconsensus_tpu.ops import dense_adj as jda
from fastconsensus_tpu.ops import segment as jseg
from fastconsensus_tpu.utils.synth import planted_partition
from fastconsensus_tpu_torch import interop
from fastconsensus_tpu_torch.graph import compact_alive
from fastconsensus_tpu_torch.models import leiden as tld
from fastconsensus_tpu_torch.models import louvain as tlv

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)


def port_slab(js):
    return interop.slab_from_arrays(
        np.asarray(js.src), np.asarray(js.dst), np.asarray(js.weight),
        np.asarray(js.alive), n_nodes=js.n_nodes, d_cap=js.d_cap,
        cap_hint=js.cap_hint, d_hyb=js.d_hyb, hub_cap=js.hub_cap,
        agg_cap=js.agg_cap, device="cpu")


def port_keys(keys):
    return torch.stack([
        interop.key_from_data(np.asarray(jax.random.key_data(k)),
                              device="cpu") for k in keys])


def ring_of_cliques(n_cliques=4, k=5):
    edges = []
    for c in range(n_cliques):
        base = c * k
        for a in range(k):
            for b in range(a + 1, k):
                edges.append([base + a, base + b])
        edges.append([base, ((c + 1) % n_cliques) * k])
    return np.array(edges), n_cliques * k, np.repeat(np.arange(n_cliques), k)


def skewed_graph(n=600, seed=5):
    """Planted communities plus six grafted hubs: carries dense AND hybrid
    sizing, so every move path can be forced on it."""
    rng = np.random.default_rng(0)
    edges, truth = planted_partition(n, 6, 0.12, 0.004, seed=seed)
    hubs = rng.choice(n, 6, replace=False)
    extra = np.array([[h, int(o)] for h in hubs
                      for o in rng.choice(n, n // 4, replace=False)
                      if int(o) != h])
    return np.vstack([edges, extra]), truth


def planted_hybrid(n=2000):
    """Planted communities plus eight grafted hubs (hybrid sizing)."""
    rng = np.random.default_rng(11)
    edges, truth = planted_partition(n, 10, 0.06, 0.0008, seed=4)
    hubs = rng.choice(n, 8, replace=False)
    extra = np.array([[h, int(o)] for h in hubs
                      for o in rng.choice(n, 120, replace=False)
                      if int(o) != h])
    return np.vstack([edges, extra]), truth


@pytest.fixture(scope="module")
def skewed():
    edges, truth = skewed_graph()
    js = jpack(edges, 600)
    assert js.d_cap > 0 and js.d_hyb > 0 and js.hub_cap > 0
    return js, port_slab(js), truth


def _reference_step(path, js, labels, key, theta):
    strength = js.strengths()
    _, _, wd, ad = js.directed()
    m2 = jnp.maximum(jnp.sum(jnp.where(ad, wd, 0.0)), 1e-9)
    lab = jnp.asarray(labels, jnp.int32)
    n = js.n_nodes
    if path == "matmul":
        return jlv._move_step_matmul(jlv._dense_weights(js), lab, key, m2,
                                     strength, 1.0, theta)
    if path == "dense":
        return jlv._move_step_dense(jda.build_dense_adjacency(js), js, lab,
                                    key, m2, strength, 1.0, theta)
    if path == "hybrid":
        return jlv._move_step_hybrid(
            jda.build_hybrid(js), js, lab, key, m2, strength,
            jseg.hash_buckets_for(js.hub_cap + n), 1.0, theta)
    if path == "hash":
        return jlv._move_step_hash(js, lab, key, m2, strength,
                                   jseg.hash_buckets_for(2 * js.cap_hint + n),
                                   1.0, theta)
    return jlv._move_step(js, lab, key, m2, 1.0, theta)


_reference_step_jit = jax.jit(_reference_step, static_argnums=(0, 4))

PATHS = ["matmul", "dense", "hybrid", "hash", "runs"]


@pytest.mark.parametrize("theta", [0.0, 0.01])
@pytest.mark.parametrize("path", PATHS)
def test_move_step_matches_reference(monkeypatch, skewed, path, theta):
    """Every lowering, the sorted-run oracle included, with Louvain's
    scoring (theta 0) and the refinement's (theta > 0)."""
    js, ts, truth = skewed
    monkeypatch.setenv("FCTPU_MOVE_PATH", path)
    prep = tlv.Prepared(ts, theta=theta)
    assert prep.path == jlv.select_move_path(js) == path
    rng = np.random.default_rng(1)
    n = js.n_nodes
    labels = np.stack([np.where(rng.random(n) < 0.3, truth * 7,
                                np.arange(n)) for _ in range(3)]
                      ).astype(np.int32)
    keys = [jax.random.key(s) for s in range(3)]
    got_b, got_w = prep.step(torch.as_tensor(labels, dtype=torch.int64),
                             port_keys(keys))
    for i in range(3):
        b, w = _reference_step_jit(path, js, labels[i], keys[i], theta)
        np.testing.assert_array_equal(got_b[i].numpy(), np.asarray(b))
        np.testing.assert_array_equal(got_w[i].numpy(), np.asarray(w))
        assert 0 < int(np.asarray(w).sum()) <= n


def _hub_to_row_comm(js, truth):
    """Communities under which the largest hub keeps fewer intra edges
    than d_hyb: a hub of the full slab, a row node of the masked one."""
    hub = int(np.argmax(np.asarray(js.degrees())))
    nbrs = np.concatenate([np.asarray(js.dst)[np.asarray(js.src) == hub],
                           np.asarray(js.src)[np.asarray(js.dst) == hub]])
    comm = truth.copy() + 10
    comm[hub] = 0
    comm[nbrs[:js.d_hyb // 2]] = 0
    return comm


@pytest.mark.parametrize("theta", [0.01, 0.0])
@pytest.mark.parametrize("path", PATHS)
def test_refine_matches_reference(monkeypatch, skewed, path, theta):
    """refine on per-member masked slabs: labels equal the reference's,
    member by member, on every lowering.  On the hybrid path one member's
    mask turns the largest hub into a row node (its own hub split)."""
    js, ts, truth = skewed
    monkeypatch.setenv("FCTPU_MOVE_PATH", path)
    n = js.n_nodes
    rng = np.random.default_rng(2)
    comms = np.stack([truth, _hub_to_row_comm(js, truth),
                      rng.integers(0, 4, n)]).astype(np.int32)
    keys = [jax.random.key(s + 20) for s in range(3)]
    got = tld.refine(ts, torch.as_tensor(comms, dtype=torch.int64),
                     port_keys(keys), max_sweeps=6, theta=theta)
    ref = jax.jit(lambda c, k: jld.refine(js, c, k, max_sweeps=6,
                                          theta=theta))
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.asarray(ref(comms[i], keys[i])))
        # refinement never crosses the constraining partition
        for g in np.unique(got[i].numpy()):
            assert len(np.unique(comms[i][got[i].numpy() == g])) == 1
    if path == "hybrid":
        alive = (np.asarray(js.alive) &
                 (comms[1][np.asarray(js.src)] ==
                  comms[1][np.asarray(js.dst)]))
        hub = int(np.argmax(np.asarray(js.degrees())))
        masked = js.with_weights(js.weight, jnp.asarray(alive))
        assert bool(jda.build_hybrid(js).is_hub[hub])
        assert not bool(jda.build_hybrid(masked).is_hub[hub])


def test_refine_fused_matches_reference(monkeypatch, skewed):
    """Greedy refinement (theta 0, the warm and refresh variants) on the
    opt-in fused dense sweep, with per-member rows."""
    js, ts, truth = skewed
    monkeypatch.setenv("FCTPU_MOVE_PATH", "dense")
    monkeypatch.setenv("FCTPU_FUSED", "1")
    comms = np.stack([truth, truth % 2]).astype(np.int32)
    keys = [jax.random.key(s + 30) for s in range(2)]
    masked = dataclasses.replace(ts, alive=ts.alive & torch.as_tensor(
        comms[:, np.asarray(js.src)] == comms[:, np.asarray(js.dst)]))
    assert tlv.Prepared(masked).fused is not None
    got = tld.refine(ts, torch.as_tensor(comms, dtype=torch.int64),
                     port_keys(keys), max_sweeps=6, theta=0.0)
    ref = jax.jit(lambda c, k: jld.refine(js, c, k, max_sweeps=6,
                                          theta=0.0))
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.asarray(ref(comms[i], keys[i])))


def test_refinement_connectivity():
    """Refined groups induce connected subgraphs (the property Leiden is
    named for), and equal the reference's, on an LFR-1k graph."""
    import networkx as nx

    from fastconsensus_tpu.utils.synth import lfr_graph

    edges, _ = lfr_graph(1000, 0.4, seed=7)
    js = jpack(edges, 1000)
    ts = port_slab(js)
    g = nx.Graph()
    g.add_nodes_from(range(1000))
    g.add_edges_from(edges.tolist())
    k0s, k1s = [], []
    for s in range(3):
        k0, k1 = jax.random.split(jax.random.key(s))
        k0s.append(k0)
        k1s.append(k1)
    comm = tlv.local_move(ts, port_keys(k0s))
    refined = tld.refine(ts, comm, port_keys(k1s))
    for s in range(3):
        jc = jlv.local_move(js, k0s[s])
        np.testing.assert_array_equal(comm[s].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(
            refined[s].numpy(), np.asarray(jld.refine(js, jc, k1s[s])))
        lab = refined[s].numpy()
        for c in np.unique(lab):
            members = np.nonzero(lab == c)[0]
            if len(members) > 1:
                assert nx.is_connected(g.subgraph(members.tolist())), \
                    f"refined group {c} disconnected (seed {s})"


@pytest.mark.parametrize("compact", [None, "below", "above"])
def test_aggregate_matches_reference(skewed, compact):
    """Per-member aggregate slabs, slot for slot with weights, then
    compacted with agg_cap below and above the alive count."""
    js, ts, truth = skewed
    rng = np.random.default_rng(3)
    labels = np.stack([truth, rng.integers(0, 40, 600),
                       np.arange(600)]).astype(np.int32)
    js = js.with_weights(jnp.where(js.alive, jnp.asarray(
        rng.integers(1, 7, js.capacity), jnp.float32), 0.0))
    ts = port_slab(js)
    got = tlv.aggregate(ts, torch.as_tensor(labels, dtype=torch.int64))
    assert got.batch == (3,) and got.d_cap == got.d_hyb == 0
    n_alive = [int(a) for a in got.num_alive()]
    cap = {None: 0, "below": min(n_alive) - 5,
           "above": max(n_alive) + 100}[compact]
    if compact:
        got = compact_alive(got, cap)
    for i in range(3):
        ja = jlv.aggregate(js, jnp.asarray(labels[i]))
        if compact:
            ja = jcompact(ja, cap)
        for name in ("src", "dst", "weight", "alive"):
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(),
                                          np.asarray(getattr(ja, name)))
        for name in ("capacity", "cap_hint", "agg_cap", "hub_cap"):
            assert getattr(got, name) == getattr(ja, name)
        np.testing.assert_array_equal(got.strengths()[i].numpy(),
                                      np.asarray(ja.strengths()))


def test_modularity_levels_matches_reference(karate_slab):
    ts = port_slab(karate_slab)
    keys = [jax.random.key(s) for s in range(3)]
    got = tlv.modularity_levels(ts, port_keys(keys), 3)
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(
            got[i].numpy(),
            np.asarray(jlv.modularity_levels(karate_slab, k, 3)))


@pytest.mark.parametrize("graph", ["ring", "karate", "planted_hybrid"])
def test_leiden_single_matches_reference(monkeypatch, karate_slab, graph):
    from fastconsensus_tpu_torch.utils.metrics import nmi

    if graph == "ring":
        edges, n, truth = ring_of_cliques()
        js = jpack(edges, n)
    elif graph == "karate":
        js, truth = karate_slab, None
    else:
        monkeypatch.setenv("FCTPU_MOVE_PATH", "hybrid")
        edges, truth = planted_hybrid()
        js = jpack(edges, 2000)
        assert jlv.select_move_path(js) == "hybrid"
    ts = port_slab(js)
    keys = [jax.random.key(s) for s in (5, 6)]
    got = tld.leiden_members(tlv.Prepared(ts), port_keys(keys))
    ref = jax.jit(jld.leiden_single)
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref(js, k)))
    one = tld.leiden_single(ts, port_keys(keys[:1])[0])
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())
    if graph == "ring":
        assert nmi(got[0].numpy(), truth) == 1.0
    if graph == "planted_hybrid":
        assert min(nmi(g.numpy(), truth) for g in got) > 0.9


def test_make_leiden_variants_and_chunking(monkeypatch, karate_slab):
    """The detector and its theta-0 warm and refresh variants equal the
    reference's; member chunking does not change labels."""
    from fastconsensus_tpu.models.registry import get_detector as jdet

    ts = port_slab(karate_slab)
    jkeys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.key(1), jnp.arange(5, dtype=jnp.uint32))
    keys = interop.key_from_data(np.asarray(jax.random.key_data(jkeys)),
                                 device="cpu")
    init = np.random.default_rng(4).integers(0, 34, (5, 34)).astype(np.int32)
    det, jd = tld.make_leiden(), jdet("leiden")
    assert det.supports_align and det.supports_init
    for name in (None, "warm_variant", "refresh_variant"):
        d = getattr(det, name) if name else det
        j = getattr(jd, name) if name else jd
        got = d(ts, keys, torch.as_tensor(init))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(j(karate_slab, jkeys,
                                      init_labels=jnp.asarray(init))))
    monkeypatch.setenv("FCTPU_ENSEMBLE_CHUNK", "2")
    np.testing.assert_array_equal(tld.make_leiden()(ts, keys).numpy(),
                                  det(ts, keys).numpy())


def test_member_bytes_counts_per_member_slabs():
    """Leiden's chunk sizing counts the masked and aggregate slabs on top
    of a Louvain sweep, so it runs fewer members at once."""
    from fastconsensus_tpu_torch.sizing import members_per_call

    edges, _ = planted_hybrid()
    ts = port_slab(jpack(edges, 2000))
    assert tld.member_bytes(ts) > tlv.sweep_temp_bytes(ts)
    assert members_per_call(ts, 10_000, tld.member_bytes) < \
        members_per_call(ts, 10_000)
