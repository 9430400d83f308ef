"""Segment, dense-row and consensus ops of the port against the reference:
all exact (integer-valued float sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastconsensus_tpu.graph import pack_edges as jpack
from fastconsensus_tpu.ops import consensus_ops as jcops
from fastconsensus_tpu.ops import dense_adj as jda
from fastconsensus_tpu.ops import segment as jseg
from fastconsensus_tpu.utils.synth import planted_partition
from fastconsensus_tpu_torch import interop
from fastconsensus_tpu_torch.ops import consensus_ops as tcops
from fastconsensus_tpu_torch.ops import dense_adj as tda
from fastconsensus_tpu_torch.ops import segment as tseg


def port_slab(js):
    return interop.slab_from_arrays(
        np.asarray(js.src), np.asarray(js.dst), np.asarray(js.weight),
        np.asarray(js.alive), n_nodes=js.n_nodes, d_cap=js.d_cap,
        cap_hint=js.cap_hint, d_hyb=js.d_hyb, hub_cap=js.hub_cap,
        agg_cap=js.agg_cap, device="cpu")


def port_key(k):
    return interop.key_from_data(np.asarray(jax.random.key_data(k)),
                               device="cpu")


def T(a, dtype=None):
    a = np.asarray(a)
    if dtype is None and a.dtype.kind in "iu":
        dtype = torch.int64
    return torch.as_tensor(a, dtype=dtype)


def eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.fixture(scope="module")
def planted():
    rng = np.random.default_rng(0)
    edges, truth = planted_partition(400, 4, 0.1, 0.005, seed=2)
    hubs = rng.choice(400, 4, replace=False)
    extra = np.array([[h, int(o)] for h in hubs
                      for o in rng.choice(400, 80, replace=False)
                      if int(o) != h])
    js = jpack(np.vstack([edges, extra]), 400)
    return js, port_slab(js), truth


# --- segment -----------------------------------------------------------------

@pytest.mark.parametrize("n_buckets", [1 << 4, 1 << 16])
def test_hash_tables(n_buckets):
    rng = np.random.default_rng(1)
    e = 300
    node = rng.integers(0, 40, e).astype(np.int32)
    label = rng.integers(-2, 17, e).astype(np.int32)
    value = rng.integers(0, 5, e).astype(np.float32)
    valid = rng.random(e) < 0.8
    jt = jseg.build_hash_totals(jnp.asarray(node), jnp.asarray(label),
                                jnp.asarray(value), jnp.asarray(valid),
                                n_buckets)
    tt = tseg.build_hash_totals(T(node), T(label), T(value), T(valid),
                                n_buckets)
    eq(tt.t1, jt.t1)
    eq(tt.t2, jt.t2)
    eq(tseg.lookup_hash_totals(tt, T(node), T(label)),
       jseg.lookup_hash_totals(jt, jnp.asarray(node), jnp.asarray(label)))
    # a leading member batch hashes each row as its own table
    lab2 = np.stack([label, label[::-1]])
    tb = tseg.build_hash_totals(T(node), T(lab2), T(value), T(valid),
                                n_buckets)
    for i in range(2):
        ji = jseg.build_hash_totals(jnp.asarray(node), jnp.asarray(lab2[i]),
                                    jnp.asarray(value), jnp.asarray(valid),
                                    n_buckets)
        eq(tb.t1[i], ji.t1)


def test_hash_buckets_for():
    for k in (0, 1, 3, 1000, 123457):
        assert tseg.hash_buckets_for(k) == jseg.hash_buckets_for(k)
    assert tseg.hash_buckets_for(100, cap=64) == 64


@pytest.mark.parametrize("ties", [False, True])
def test_argmax_label_variants(ties):
    rng = np.random.default_rng(2)
    e, n = 500, 40
    node = rng.integers(0, n, e).astype(np.int32)
    label = rng.integers(0, 17, e).astype(np.int32)
    score = (rng.integers(0, 3, e) if ties else rng.normal(size=e)
             ).astype(np.float32)
    valid = rng.random(e) < 0.8
    valid[node == 5] = False             # a node with no valid entry
    args = (jnp.asarray(node), jnp.asarray(score), jnp.asarray(label),
            jnp.asarray(valid), n)
    targs = (T(node), T(score), T(label), T(valid), n)
    for jf, tf in ((jseg.scatter_argmax_label, tseg.scatter_argmax_label),
                   (jseg.argmax_label_per_node, tseg.argmax_label_per_node)):
        for a, b in zip(tf(*targs), jf(*args)):
            eq(a, b)


def test_pair_jitter_and_batched_keys():
    rng = np.random.default_rng(3)
    node = rng.integers(0, 1000, (7, 5)).astype(np.int32)
    label = rng.integers(0, 1000, (7, 5)).astype(np.int32)
    keys = [jax.random.key(s) for s in range(3)]
    scale = np.float32(0.25) / np.float32(777.0)
    got = tseg.pair_jitter(torch.stack([port_key(k) for k in keys]),
                           T(node), T(label)[None], torch.tensor(scale))
    for i, k in enumerate(keys):
        eq(got[i], jseg.pair_jitter(k, jnp.asarray(node), jnp.asarray(label),
                                    jnp.float32(scale)))


def test_compact_labels():
    rng = np.random.default_rng(4)
    labels = rng.integers(-1, 50, (3, 50)).astype(np.int32)
    got = tseg.compact_labels(T(labels), 50)
    for i in range(3):
        eq(got[i], jseg.compact_labels(jnp.asarray(labels[i]), 50))


@pytest.mark.parametrize("case", ["random", "padded", "masked", "batched"])
def test_node_label_runs(case):
    """The sorted-run reduction, run for run: nodes, labels, totals and
    validity exactly as the reference's lexsort gives them."""
    rng = np.random.default_rng(6)
    e, n = 400, 30
    node = rng.integers(0, n, e).astype(np.int32)
    label = rng.integers(0, 12, e).astype(np.int32)
    value = rng.integers(0, 6, e).astype(np.float32)
    valid = np.ones(e, bool)
    if case == "padded":               # a dead tail, as a slab's slots
        valid[e // 2:] = False
        node[e // 2:] = 0
    if case == "masked":
        valid = rng.random(e) < 0.6
        node[~valid] = rng.integers(0, 10 * n, int((~valid).sum()))
    ref = jax.jit(jseg.node_label_runs, static_argnums=4)
    if case != "batched":
        got = tseg.node_label_runs(T(node), T(label), T(value), T(valid), n)
        for a, b in zip(got, ref(node, label, value, valid, n)):
            eq(a, b)
        return
    labels = np.stack([label, label[::-1], label % 3])
    valids = rng.random((3, e)) < 0.7
    got = tseg.node_label_runs(T(node), T(labels), T(value), T(valids), n)
    for i in range(3):
        for a, b in zip(got, ref(node, labels[i], value, valids[i], n)):
            eq(a[i], b)


def test_gumbel_from_uniform_within_band():
    """Float64 logs rounded to float32 at each step: within 2e-6 of the
    reference's float32 logs (XLA:CPU's log is not correctly rounded)."""
    rng = np.random.default_rng(7)
    u = (rng.integers(0, 1 << 24, 200_000) / float(1 << 24)).astype(
        np.float32)
    u[:4] = [0.0, 1e-8, 1.0 - 2.0 ** -24, 0.5]
    got = tseg.gumbel_from_uniform(T(u)).numpy()
    want = np.asarray(jax.jit(jseg.gumbel_from_uniform)(jnp.asarray(u)))
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    print(f"gumbel: max abs diff {diff.max():.3g}, "
          f"{int((diff > 0).sum())} of {u.size} differ")
    assert np.isfinite(got).all() and diff.max() <= 2e-6
    # the clamp's bounds round to the reference's float32 bounds
    eq(tseg.gumbel_from_uniform(T(u[:3])), np.asarray(
        jseg.gumbel_from_uniform(jnp.asarray(u[:3]))))


def test_uniform_jitter():
    keys = [jax.random.key(s) for s in range(3)]
    got = tseg.uniform_jitter(torch.stack([port_key(k) for k in keys]),
                              (5, 7), 0.5)
    for i, k in enumerate(keys):
        eq(got[i], jseg.uniform_jitter(k, (5, 7), 0.5))


# --- dense rows ----------------------------------------------------------------

def test_dense_and_hybrid_adjacency(planted):
    js, ts, _ = planted
    dense = jax.jit(jda.build_dense_adjacency, static_argnums=1)
    for width in (js.d_cap, 8):          # 8 overflows the hub rows
        ja, ta = dense(js, width), tda.build_dense_adjacency(ts, width)
        for a, b in zip(ta, ja):
            eq(a, b)
    jh, th = jax.jit(jda.build_hybrid)(js), tda.build_hybrid(ts)
    for a, b in zip(th.adj, jh.adj):
        eq(a, b)
    for f in ("is_hub", "hsrc", "hdst", "hw", "hvalid", "n_hub_overflow"):
        eq(getattr(th, f), getattr(jh, f))


def test_masked_hybrid_takes_hubs_from_masked_degrees(planted):
    """Per-member masked slabs (Leiden's refinement): each member's rows,
    hub split and hub prefix equal the reference's build on that member's
    masked slab, and a hub of the full slab can be a row node there."""
    import dataclasses

    js, ts, truth = planted
    n = js.n_nodes
    src, dst = np.asarray(js.src), np.asarray(js.dst)
    hub = int(np.argmax(np.asarray(js.degrees())))
    assert bool(np.asarray(jda.build_hybrid(js).is_hub)[hub])
    comm = np.stack([truth, np.where(np.arange(n) == hub, 999, truth)])
    alive = np.asarray(js.alive) & (comm[:, src] == comm[:, dst])
    tm = dataclasses.replace(ts, alive=T(alive))
    th, td = tda.build_hybrid(tm), tda.build_dense_adjacency(tm)
    assert not bool(th.is_hub[1, hub])
    for i in range(2):
        jm = js.with_weights(js.weight, jnp.asarray(alive[i]))
        jh = jax.jit(jda.build_hybrid)(jm)
        for a, b in zip(th.adj, jh.adj):
            eq(a[i], b)
        for f in ("is_hub", "hsrc", "hdst", "hw", "hvalid", "n_hub_overflow"):
            eq(getattr(th, f)[i], getattr(jh, f))
        for a, b in zip(td, jax.jit(jda.build_dense_adjacency)(jm)):
            eq(a[i], b)


def test_row_label_rank_is_sorted_position(planted):
    """``rank``: each slot's position in its row sorted by label (the
    reference's CPU slot order), so head i of the port sits where the
    reference's sorted row holds the same label."""
    js, ts, truth = planted
    rng = np.random.default_rng(8)
    labels = np.where(rng.random((2, 400)) < 0.5, truth * 3,
                      rng.integers(0, 400, (2, 400))).astype(np.int32)
    tot, rank = tda.row_label_totals(tda.build_dense_adjacency(ts),
                                     T(labels), rank=True)
    ref = jax.jit(lambda a, lab: jda.row_label_totals(a, lab,
                                                      use_pallas=False))
    adj_j = jda.build_dense_adjacency(js)
    for m in range(2):
        tj = ref(adj_j, jnp.asarray(labels[m]))
        head = tot.is_head[m].numpy()
        r, c = np.nonzero(head)
        pos = rank[m].numpy()[r, c]
        assert np.asarray(tj.is_head)[r, pos].all()
        eq(T(np.asarray(tj.label)[r, pos]), tot.label[m].numpy()[r, c])
        eq(T(np.asarray(tj.total)[r, pos]), tot.total[m].numpy()[r, c])


def candidate_set(label, total, head):
    """(row, label) keys of the head slots in sorted order, with totals."""
    r, c = np.nonzero(head)
    key = r.astype(np.int64) * 2 ** 32 + label[r, c]
    order = np.argsort(key)
    return key[order], total[r, c][order]


def test_row_label_totals_candidate_sets(planted):
    """Same candidate set per row as the reference's sort lowering (slot
    order differs), and the same best candidate."""
    js, ts, truth = planted
    rng = np.random.default_rng(5)
    labels = np.where(rng.random((2, 400)) < 0.5, truth * 3,
                      rng.integers(0, 400, (2, 400))).astype(np.int32)
    adj_j = jda.build_dense_adjacency(js)
    tot_t = tda.row_label_totals(tda.build_dense_adjacency(ts), T(labels))
    ref = jax.jit(lambda a, lab: jda.row_label_totals(a, lab,
                                                      use_pallas=False))
    for m in range(2):
        tot_j = ref(adj_j, jnp.asarray(labels[m]))
        for a, b in zip(candidate_set(*(x[m].numpy() for x in tot_t)),
                        candidate_set(*(np.asarray(x) for x in tot_j))):
            np.testing.assert_array_equal(a, b)
        # integer scores: many exact ties between distinct candidates
        sj = jnp.where(tot_j.is_head, tot_j.total, -jnp.inf)
        st = torch.where(tot_t.is_head[m], tot_t.total[m], float("-inf"))
        jb = jax.jit(jda.best_candidate)(tot_j, sj, jnp.asarray(labels[m]))
        tb = tda.best_candidate(tda.RowTotals(*(x[m] for x in tot_t)), st,
                                T(labels[m]))
        eq(tb[0], jb[0])
        eq(tb[1], jb[1])


# --- consensus ops -----------------------------------------------------------

def test_weights_threshold_convergence(planted):
    js, ts, _ = planted
    rng = np.random.default_rng(6)
    n_p = 7
    labels = rng.integers(0, 3, (n_p, 400)).astype(np.int32)
    jc = jcops.comembership_counts(jnp.asarray(labels), js.src, js.dst)
    tc = tcops.comembership_counts(T(labels), ts.src, ts.dst)
    eq(tc, jc)
    js2 = js.with_weights(jnp.where(js.alive & (jnp.arange(js.capacity) % 5
                                                == 0), 7.0, js.weight))
    ts2 = port_slab(js2)
    ju, tu = jcops.update_weights(js2, jc, n_p), \
        tcops.update_weights(ts2, tc, n_p)
    eq(tu.weight, ju.weight)
    for tau in (0.2, 0.3, 0.8):
        jt, tt = jcops.threshold_weights(ju, tau, n_p), \
            tcops.threshold_weights(tu, tau, n_p)
        eq(tt.weight, jt.weight)
        eq(tt.alive, jt.alive)
        for delta in (0.0, 0.02, 0.5):
            for a, b in zip(tcops.convergence_stats(tt, n_p, delta),
                            jcops.convergence_stats(jt, n_p, delta)):
                assert int(a) == int(b)


@pytest.mark.parametrize("seed", range(3))
def test_csr_and_wedges(planted, seed):
    js, ts, _ = planted
    jcsr, tcsr = jcops.build_csr(js), tcops.build_csr(ts)
    eq(tcsr.offsets, jcsr.offsets)
    eq(tcsr.neighbors, jcsr.neighbors)
    key = jax.random.key(seed)
    wedges = jax.jit(jcops.sample_wedges, static_argnums=(2, 3))
    for a, b in zip(tcops.sample_wedges(port_key(key), tcsr, 400, 3000),
                    wedges(key, jcsr, 400, 3000)):
        eq(a, b)


@pytest.mark.parametrize("graph,seed,n_samples,group_elems", [
    # n_samples % N != 0 (a partial last draw), one batch group
    ("karate", 0, 100, 32_000_000),
    ("karate", 1, 1000, 32_000_000),
    # the group cap cut low: karate in groups of 2 draws (300 samples are
    # 9 draws, so the last group is padded with one draw outside the
    # window), the planted slab (capacity 5,106) in groups of 1
    ("karate", 2, 300, 700),
    ("planted", 3, 3001, 10_000),
    ("planted", 4, 4000, 32_000_000),
])
def test_sample_wedges_scatter(karate_slab, planted, monkeypatch, graph,
                               seed, n_samples, group_elems):
    """Bit-equal to the reference's; the group size only batches draws."""
    js, ts = (karate_slab, port_slab(karate_slab)) if graph == "karate" \
        else planted[:2]
    assert n_samples % js.n_nodes != 0 or graph == "planted"
    monkeypatch.setattr(tcops, "SCATTER_GROUP_ELEMS", group_elems)
    draws = -(-n_samples // js.n_nodes)
    group = min(draws, max(1, group_elems // max(2 * ts.capacity,
                                                 js.n_nodes + 1)))
    assert (group < draws) == (group_elems < 32_000_000)
    key = jax.random.key(seed)
    got = tcops.sample_wedges_scatter(port_key(key), ts, n_samples)
    want = jcops.sample_wedges_scatter(key, js, n_samples)
    for a, b in zip(got, want):
        eq(a, b)
    assert 0 < int(got[2].sum()) < n_samples


def test_sample_wedges_scatter_rejects_int32_overflow(karate_slab):
    ts = port_slab(karate_slab)
    key = port_key(jax.random.key(0))
    with pytest.raises(ValueError, match="exceeds int32 indexing"):
        tcops.sample_wedges_scatter(key, ts, 2 ** 31)
    u, v, ok = tcops.sample_wedges_scatter(key, ts, 0)
    assert u.shape == v.shape == ok.shape == (0,)


@pytest.mark.parametrize("tight", [False, True])
def test_insert_edges_hash(planted, tight):
    """Duplicates, candidates already present, hash-colliding candidates and
    (tight) too few free slots."""
    js, ts, _ = planted
    if not tight:
        from fastconsensus_tpu.graph import grow_slab

        js = grow_slab(js, js.capacity + 8000)
        ts = port_slab(js)
    else:
        js = jpack(np.stack([np.asarray(js.src)[np.asarray(js.alive)],
                             np.asarray(js.dst)[np.asarray(js.alive)]], 1),
                   400, capacity=int(js.num_alive()) + 100)
        ts = port_slab(js)
    rng = np.random.default_rng(7)
    k = 6000
    u = rng.integers(0, 400, k)
    v = rng.integers(0, 400, k)
    u[:300], v[:300] = np.asarray(js.src)[:300], np.asarray(js.dst)[:300]
    u[-500:], v[-500:] = u[1000:1500], v[1000:1500]      # duplicates
    cu, cv = np.minimum(u, v).astype(np.int32), np.maximum(u, v).astype(
        np.int32)
    cw = rng.integers(0, 9, k).astype(np.float32)
    valid = (cu != cv) & (rng.random(k) < 0.95)
    jslab, jd = jax.jit(jcops.insert_edges_hash)(
        js, jnp.asarray(cu), jnp.asarray(cv), jnp.asarray(cw),
        jnp.asarray(valid))
    tslab, td = tcops.insert_edges_hash(ts, T(cu), T(cv), T(cw), T(valid))
    assert int(td) == int(jd)
    assert (int(jd) > 0) == tight
    for name in ("src", "dst", "weight", "alive"):
        eq(getattr(tslab, name), getattr(jslab, name))


def test_singleton_candidates(planted):
    js, ts, _ = planted
    # kill every edge of a few nodes (and make two of them mutual partners)
    alive = np.asarray(js.alive).copy()
    src, dst = np.asarray(js.src), np.asarray(js.dst)
    for node in (3, 17, 250):
        alive &= ~((src == node) | (dst == node))
    w = np.where(alive, 2.0, 0.0).astype(np.float32)
    w[:40] = 5.0
    jprev = js.with_weights(jnp.asarray(np.where(np.asarray(js.alive), w + 1,
                                                 0.0).astype(np.float32)))
    jcur = js.with_weights(jnp.asarray(w), jnp.asarray(alive))
    got = tcops.singleton_candidates(port_slab(jcur), port_slab(jprev))
    want = jcops.singleton_candidates(jcur, jprev)
    for a, b in zip(got, want):
        eq(a, b)
    assert int(np.asarray(want[3]).sum()) == 3
