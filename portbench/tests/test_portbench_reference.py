"""The plain reference on its own: the tail check holds the port's tail
and catches each broken rule; the move-gain judge passes a plain Louvain
and fails partitions that are not."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import jobs
from portbench.reference import louvain, tail


def lfr(seed, n=300):
    return jobs.lfr_graph(n, 12, 30, 2, 1, 10, 40, 0.5, jobs.rng(seed, 2))


def graph(seed=3, n=300):
    edges, truth = lfr(seed, n)
    e = torch.as_tensor(edges)
    return e[:, 0], e[:, 1], torch.ones(e.shape[0]), truth


def port_tail(seed, n_p=8, tau=0.2, closure_tau=0.2):
    """One round of the port on a planted graph: its tail's inputs and
    output, as the benchmark's tap records them."""
    from fastconsensus_tpu_torch.engine import consensus_round
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.utils import prng

    edges, _ = lfr(seed)
    slab = pack_edges(edges, 300, device="cpu")
    slab = slab.with_weights(torch.where(slab.alive, 1.0, 0.0))
    out, labels, stats = consensus_round(
        slab, prng.key(seed, "cpu"), get_detector("louvain"), n_p, tau, 0.02,
        int(slab.num_alive()), closure_tau=closure_tau)
    return slab, labels, out, int(stats.n_dropped)


def edges(s):
    return tail.edges_of(s.src, s.dst, s.weight, s.alive, s.n_nodes)


@pytest.mark.parametrize("seed", [1, 2])
def test_the_ports_tail_keeps_every_rule(seed):
    s_in, labels, s_out, dropped = port_tail(seed)
    got = tail.check(edges(s_in), labels, edges(s_out), 8, 0.2, 0.02, 0.2,
                     dropped)
    assert got["faults"] == 0
    assert got["closed"] > 0


def _broken(s, **kw):
    return dataclasses.replace(s, **kw)


@pytest.mark.parametrize("how", ["weight", "kept_dropped", "stray_edge",
                                 "other_labels", "tau", "closure_tau"])
def test_each_broken_rule_is_caught(how):
    s_in, labels, s_out, dropped = port_tail(
        1, closure_tau=None if how == "closure_tau" else 0.2)
    tau, closure_tau = 0.2, 0.2
    if how == "weight":
        i = int(torch.nonzero(s_out.alive)[0])
        w = s_out.weight.clone()
        w[i] += 1
        s_out = _broken(s_out, weight=w)
    elif how == "kept_dropped":
        i = int(torch.nonzero(s_out.alive)[0])
        a = s_out.alive.clone()
        a[i] = False
        s_out = _broken(s_out, alive=a)
    elif how == "stray_edge":
        i = int(torch.nonzero(~s_out.alive)[0])
        src, dst = s_out.src.clone(), s_out.dst.clone()
        w, a = s_out.weight.clone(), s_out.alive.clone()
        src[i], dst[i], w[i], a[i] = 0, 299, 8.0, True
        s_out = _broken(s_out, src=src, dst=dst, weight=w, alive=a)
    elif how == "other_labels":
        labels = labels.clone()
        labels[0] = torch.arange(300)   # a member of singletons
    elif how == "tau":
        tau = 0.5
    got = tail.check(edges(s_in), labels, edges(s_out), 8, tau, 0.02,
                     closure_tau, dropped)
    assert got["faults"] > 0


def test_a_plain_louvain_passes_the_judge():
    u, v, w, truth = graph()
    lab = louvain.louvain(u, v, w, 300, members=4, max_sweeps=64, seed=1)
    assert float(louvain.unstable_share(u, v, w, 300, lab).max()) <= 0.02
    sing = torch.arange(300).expand(1, 300)
    assert float(louvain.unstable_share(u, v, w, 300, sing)[0]) > 0.9
    gen = torch.Generator().manual_seed(0)
    shuffled = lab[:1, torch.randperm(300, generator=gen)]
    assert float(louvain.unstable_share(u, v, w, 300, shuffled)[0]) > 0.5


def test_move_gains_agree_with_the_modularity_change():
    u, v, w, truth = graph(seed=4, n=120)
    lab = torch.as_tensor(truth)[None]
    best, bg, stay, k = louvain.move_gains(u, v, w, 120, lab)

    def q(labels):
        a = torch.cat([u, v])
        b = torch.cat([v, u])
        ww = torch.cat([w, w]).double()
        m2 = ww.sum()
        kk = torch.zeros(120, dtype=torch.float64).index_add_(0, a, ww)
        same = (labels[a] == labels[b]).double()
        sig = torch.zeros(200, dtype=torch.float64).index_add_(0, labels, kk)
        return float((ww * same).sum() / m2 - (sig ** 2).sum() / m2 ** 2)

    base = torch.as_tensor(truth)
    for i in np.flatnonzero(best[0].numpy() >= 0)[:10]:
        moved = base.clone()
        moved[i] = best[0, i]
        # gain difference * 2 / 2m is the modularity change of the move
        want = 2 * float(bg[0, i] - stay[0, i]) / float(k.sum())
        assert q(moved) - q(base) == pytest.approx(want, abs=1e-12)
