"""Louvain parity: the PyTorch port against the JAX reference, on the CPU.

Each move step must pick the same ``(best, want)`` as the reference's on
the same labels and key, and ``local_move`` must reach identical labels.
The reference runs its CPU default (the sort lowering of
``row_label_totals``); the port runs the plain version of its
``row_totals`` kernel — an unordered candidate set with exact integer
totals, so the results agree exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastconsensus_tpu.graph import pack_edges as jpack
from fastconsensus_tpu.models import louvain as jlv
from fastconsensus_tpu.ops import dense_adj as jda
from fastconsensus_tpu.ops import segment as jseg
from fastconsensus_tpu.utils.synth import planted_partition
from fastconsensus_tpu_torch import interop
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


def port_key(k):
    return interop.key_from_data(np.asarray(jax.random.key_data(k)),
                               device="cpu")


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


@pytest.fixture(scope="module")
def skewed():
    edges, truth = skewed_graph()
    js = jpack(edges, 600)
    assert js.d_cap > 0 and js.d_hyb > 0 and js.hub_cap > 0
    return js, port_slab(js), truth


@pytest.fixture(scope="module")
def heavy(skewed):
    """The skewed graph with every weight 16: gains scale by 16 and the
    jitter by 1/16, so the jitter sits within an ulp or two of the gains
    and float32 rounding alone decides many ties."""
    js, _, truth = skewed
    w = np.full(js.capacity, 16)
    js = js.with_weights(jnp.where(js.alive, jnp.asarray(w, jnp.float32),
                                   0.0))
    return js, port_slab(js), truth


@functools.partial(jax.jit, static_argnames=("path", "fused"))
def _reference_step_jit(js, labels, key, path, fused):
    return _reference_step(path, js, labels, key, fused)


def _reference_step(path, js, labels, key, fused):
    strength = js.strengths()
    _, _, wd, ad = js.directed()
    m2 = jnp.maximum(jnp.sum(jnp.where(ad, wd, 0.0)), 1e-9)
    lab = jnp.asarray(labels, jnp.int32)
    n = js.n_nodes
    if path == "matmul":
        return jlv._move_step_matmul(jlv._dense_weights(js), lab, key, m2,
                                     strength)
    if path == "dense" and fused:
        fr = jlv._FusedRows(js, jda.build_dense_adjacency(js), strength, m2,
                            1.0)
        return jlv._move_step_dense_fused(fr, lab, key, strength)
    if path == "dense":
        return jlv._move_step_dense(jda.build_dense_adjacency(js), js, lab,
                                    key, m2, strength)
    if path == "hybrid":
        return jlv._move_step_hybrid(
            jda.build_hybrid(js), js, lab, key, m2, strength,
            jseg.hash_buckets_for(js.hub_cap + n))
    return jlv._move_step_hash(js, lab, key, m2, strength,
                               jseg.hash_buckets_for(2 * js.cap_hint + n))


@pytest.mark.parametrize("graph", ["skewed", "heavy"])
@pytest.mark.parametrize("path,fused", [("matmul", False), ("dense", False),
                                        ("dense", True), ("hybrid", False),
                                        ("hash", False)])
def test_move_step_matches_reference(monkeypatch, request, graph, path,
                                     fused):
    js, ts, truth = request.getfixturevalue(graph)
    monkeypatch.setenv("FCTPU_MOVE_PATH", path)
    monkeypatch.setenv("FCTPU_FUSED", "1" if fused else "0")
    assert tlv.select_move_path(ts) == jlv.select_move_path(js) == path
    prep = tlv.Prepared(ts)
    assert (prep.fused is not None) == fused
    rng = np.random.default_rng(1)
    n = js.n_nodes
    labels, keys = [], []
    for s in range(3):
        # mostly singletons: many exactly tied candidates
        lab = np.where(rng.random(n) < 0.2, truth * 7,
                       np.arange(n)).astype(np.int32)
        labels.append(lab)
        keys.append(jax.random.key(s))
    got_b, got_w = prep.step(
        torch.as_tensor(np.stack(labels), dtype=torch.int64),
        torch.stack([port_key(k) for k in keys]))
    for i in range(3):
        b, w = _reference_step_jit(js, labels[i], keys[i], path, fused)
        np.testing.assert_array_equal(got_b[i].numpy(), np.asarray(b))
        np.testing.assert_array_equal(got_w[i].numpy(), np.asarray(w))
        assert 0 < int(np.asarray(w).sum()) < n


def test_local_move_karate_identical(karate_slab):
    ts = port_slab(karate_slab)
    keys = [jax.random.key(s) for s in range(4)]
    want = np.stack([np.asarray(jlv.local_move(karate_slab, k))
                     for k in keys])
    got = tlv.local_move(ts, torch.stack([port_key(k) for k in keys]))
    np.testing.assert_array_equal(got.numpy(), want)
    # and through the compacting single-member API
    one = tlv.louvain_single(ts, port_key(keys[0]))
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jlv.louvain_single(karate_slab, keys[0])))


@pytest.mark.parametrize("path", ["hybrid", "dense"])
def test_local_move_forced_path_identical(monkeypatch, skewed, path):
    js, ts, _ = skewed
    monkeypatch.setenv("FCTPU_MOVE_PATH", path)
    keys = [jax.random.key(s) for s in (3, 4)]
    init = np.random.default_rng(2).integers(0, 600, (2, 600)).astype(
        np.int32)
    want = np.stack([
        np.asarray(jlv.local_move(js, k, init_labels=jnp.asarray(init[i]),
                                  max_sweeps=12))
        for i, k in enumerate(keys)])
    got = tlv.local_move(ts, torch.stack([port_key(k) for k in keys]),
                         init_labels=torch.as_tensor(init),
                         max_sweeps=12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_detector_chunking_does_not_change_labels(monkeypatch, karate_slab):
    ts = port_slab(karate_slab)
    keys = torch.stack([port_key(jax.random.key(s)) for s in range(5)])
    whole = tlv.make_louvain()(ts, keys)
    monkeypatch.setenv("FCTPU_ENSEMBLE_CHUNK", "2")
    chunked = tlv.make_louvain()(ts, keys)
    np.testing.assert_array_equal(whole.numpy(), chunked.numpy())


def test_select_move_path_forced_fallbacks(monkeypatch):
    import dataclasses

    from fastconsensus_tpu_torch.graph import pack_edges

    slab = pack_edges(np.array([[0, 1], [1, 2], [2, 3]]), 4, device="cpu")
    assert tlv.select_move_path(slab) == "matmul"
    nocap = dataclasses.replace(slab, d_cap=0)
    monkeypatch.setenv("FCTPU_MOVE_PATH", "dense")
    assert tlv.select_move_path(nocap) == "runs"
    # the forced fallback now runs the sorted-run oracle
    assert tlv.Prepared(nocap).path == "runs"
    monkeypatch.setenv("FCTPU_MOVE_PATH", "hash")
    assert tlv.select_move_path(nocap) == "hash"
