"""Label propagation parity: the PyTorch port against the JAX reference,
on the CPU.

Both vote lowerings must give the reference's labels: the sorted-run vote
(``d_cap = 0``) and the dense-row vote through ``row_totals``.  The dense
vote's tie-break noise is drawn per row position, and the reference's CPU
lowering sorts each row by label; the port keeps slot order, so it gives
each candidate the draw of its rank in the sorted row.  Totals are
integers, so rows with tied totals are where a wrong draw would show.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastconsensus_tpu.graph import pack_edges as jpack
from fastconsensus_tpu.models import lpm as jlpm
from fastconsensus_tpu.ops import dense_adj as jda
from fastconsensus_tpu.utils.synth import planted_partition
from fastconsensus_tpu_torch import interop
from fastconsensus_tpu_torch.models import lpm as tlpm
from fastconsensus_tpu_torch.ops import dense_adj as tda
from fastconsensus_tpu_torch.ops import segment as tseg

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


def two_cliques(k=6):
    edges = []
    for a in range(k):
        for b in range(a + 1, k):
            edges.append([a, b])
            edges.append([k + a, k + b])
    edges.append([0, k])
    return np.array(edges), 2 * k


def graph(name, karate_slab):
    if name == "karate":
        return karate_slab
    if name == "two_cliques":
        edges, n = two_cliques()
        return jpack(edges, n)
    edges, _ = planted_partition(2000, 20, 0.1, 0.001, seed=6)
    return jpack(edges, 2000)


def runs_only(js):
    return dataclasses.replace(js, d_cap=0)


@pytest.mark.parametrize("lowering", ["dense", "runs"])
@pytest.mark.parametrize("name", ["karate", "planted2k"])
def test_vote_step_matches_reference(karate_slab, name, lowering):
    """One vote round from labels with few distinct values, so many rows
    hold candidates with tied totals."""
    js = graph(name, karate_slab)
    if lowering == "runs":
        js = runs_only(js)
    ts = port_slab(js)
    n = js.n_nodes
    rng = np.random.default_rng(3)
    labels = np.stack([rng.integers(0, k, n) for k in (3, 7, n)]
                      ).astype(np.int32)
    keys = [jax.random.key(s) for s in range(3)]
    prep = tlpm.Prepared(ts)
    assert (prep.adj is not None) == (lowering == "dense")
    got, got_n = prep.step(torch.as_tensor(labels, dtype=torch.int64),
                           port_keys(keys), 0.7)
    if lowering == "dense":
        adj = jda.build_dense_adjacency(js)
        ref = jax.jit(lambda lab, k: jlpm._vote_step_dense(adj, lab, k, 0.7))
    else:
        ref = jax.jit(lambda lab, k: jlpm._vote_step(js, lab, k, 0.7))
    for i in range(3):
        lab, n_want = ref(jnp.asarray(labels[i]), keys[i])
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(lab))
        assert int(got_n[i]) == int(n_want) > 0


def test_dense_vote_tie_breaks_follow_sorted_rows(karate_slab):
    """Rows whose best totals tie: the winner is the one the reference's
    sorted row draws the larger jitter for; slot-order draws would pick
    differently on some of these rows."""
    ts = port_slab(karate_slab)
    adj = tda.build_dense_adjacency(ts)
    labels = torch.as_tensor(np.arange(34) % 2, dtype=torch.int64)[None]
    labels = labels.expand(8, 34).clone()
    keys = port_keys([jax.random.key(s) for s in range(8)])
    tot, rank = tda.row_label_totals(adj, labels, rank=True)
    top = torch.where(tot.is_head & (tot.total > 0), tot.total, -1.0)
    tied = ((top == top.max(dim=2, keepdim=True).values) &
            (top > 0)).sum(dim=2) > 1
    assert int(tied.sum()) > 0
    got, _ = tlpm._vote_step_dense(adj, labels, keys, 1.0)
    jadj = jda.build_dense_adjacency(karate_slab)
    slot_order = 0
    for i in range(8):
        k = jax.random.key(i)
        lab, _ = jlpm._vote_step_dense(jadj, jnp.asarray(labels[i]), k, 1.0)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(lab))
        # the same vote with the draws taken in slot order
        jit = tseg.uniform_jitter(keys[i:i + 1], (34, adj.nbr.shape[1] + 1),
                                  0.5)
        score = torch.where(tot.is_head[i:i + 1] & (tot.total[i:i + 1] > 0),
                            tot.total[i:i + 1] + jit, float("-inf"))
        naive, _ = tda.best_candidate(
            tda.RowTotals(*(x[i:i + 1] for x in tot)), score, labels[i:i + 1])
        slot_order += int((naive[0] != got[i]).sum())
    assert slot_order > 0


@pytest.mark.parametrize("lowering", ["dense", "runs"])
@pytest.mark.parametrize("name", ["karate", "two_cliques", "planted2k"])
def test_lpm_single_matches_reference(karate_slab, name, lowering):
    js = graph(name, karate_slab)
    if lowering == "runs":
        js = runs_only(js)
    assert (js.d_cap > 0) == (lowering == "dense")
    ts = port_slab(js)
    keys = [jax.random.key(s) for s in (0, 1)]
    got = tlpm.lpm_members(tlpm.Prepared(ts), port_keys(keys))
    ref = jax.jit(jlpm.lpm_single)
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref(js, k)))
    one = tlpm.lpm_single(ts, port_keys(keys[:1])[0])
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())
    if name == "two_cliques":
        lab = got[0].numpy()
        assert len(set(lab[:6])) == len(set(lab[6:])) == 1
        assert lab[0] != lab[6]


def test_make_lpm_ensemble_matches_reference(monkeypatch, karate_slab):
    ts = port_slab(karate_slab)
    jkeys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.key(1), jnp.arange(8, dtype=jnp.uint32))
    keys = interop.key_from_data(np.asarray(jax.random.key_data(jkeys)),
                                 device="cpu")
    init = np.random.default_rng(5).integers(0, 34, (8, 34)).astype(np.int32)
    det = tlpm.make_lpm()
    assert not getattr(det, "supports_align", False) and det.supports_init
    want = np.asarray(jlpm.make_lpm()(karate_slab, jkeys,
                                      init_labels=jnp.asarray(init)))
    got = det(ts, keys, torch.as_tensor(init))
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setenv("FCTPU_ENSEMBLE_CHUNK", "3")
    np.testing.assert_array_equal(
        tlpm.make_lpm()(ts, keys, torch.as_tensor(init)).numpy(), want)
