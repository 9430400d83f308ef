"""The benchmark's LFR generator keeps the source's shape, and its frozen
copies agree with the program's originals on small inputs: NMI and the
row_totals bound."""

import json

import numpy as np
import pytest

import chip_smoke
from conftest import ROOT
from fastconsensus_tpu_torch.utils import metrics
from portbench import jobs, roofline
from portbench.reference.nmi import nmi


LFR1K = json.loads((ROOT / "portbench" / "configs" /
                    "lfr1k-louvain.json").read_text())


@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 + 5])
def test_lfr_graph_has_the_source_shape(seed):
    g = LFR1K["graph"]
    edges, truth = jobs.lfr_graph(
        g["n"], g["mean_degree"], g["max_degree"], g["degree_exponent"],
        g["community_exponent"], g["min_community"], g["max_community"],
        g["mu"], jobs.rng(seed, 2))
    n = g["n"]
    assert truth.shape == (n,)
    assert (edges[:, 0] < edges[:, 1]).all()
    assert jobs.canonical_count(edges) == edges.shape[0]
    deg = np.bincount(edges.ravel(), minlength=n)
    assert 18.5 < deg.mean() <= 20.5 and deg.max() <= 50 and deg.min() > 0
    sizes = np.bincount(truth)
    assert sizes.min() >= 10 and sizes.max() <= 50
    cross = truth[edges[:, 0]] != truth[edges[:, 1]]
    mixing = np.bincount(edges[cross].ravel(), minlength=n) / deg
    assert abs(mixing.mean() - g["mu"]) < 0.03


def test_lfr_degrees_keep_the_mean():
    k = jobs.lfr_degrees(np.random.default_rng(3), 200_000, 20, 50, 2)
    assert abs(k.mean() - 20) < 0.1
    assert k.max() <= 50 and k.sum() % 2 == 0


def test_lfr_sizes_hold_every_node():
    s = jobs.lfr_sizes(np.random.default_rng(4), 1000, 10, 50, 1)
    assert s.sum() == 1000 and s.min() >= 10 and s.max() <= 50


def test_batch_graphs_all_fall_in_the_bucket():
    t = jobs.Traffic(LFR1K, {"batch": 8, "bucket": "n1024_e12288",
                             "pool_batches": 2}, 2 ** 31 + 12345)
    counts = [jobs.canonical_count(g.edges) for g in t.graphs(0)]
    assert all(8_192 < m <= 12_288 for m in counts)
    # the same seed gives the same inputs; another seed other ones
    again = jobs.Traffic(LFR1K, t.mix, 2 ** 31 + 12345).graphs(0)
    assert all(np.array_equal(a.edges, b.edges)
               for a, b in zip(t.graphs(0), again))
    other = jobs.Traffic(LFR1K, t.mix, 7).graphs(0)
    assert not np.array_equal(other[0].edges, t.graphs(0)[0].edges)
    assert t.key_seeds(3) == jobs.Traffic(LFR1K, t.mix, 2 ** 31 + 12345
                                          ).key_seeds(3)
    assert t.key_seeds(3) != jobs.Traffic(LFR1K, t.mix, 7).key_seeds(3)
    assert all(0 <= s < 2 ** 31 for s in t.key_seeds(0))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_nmi_matches_the_program(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 7, 500)
    b = np.where(rng.random(500) < 0.7, a, rng.integers(0, 9, 500))
    assert nmi(a, b) == metrics.nmi(a, b)
    assert nmi(a, a) == 1.0


@pytest.mark.parametrize("rows,d", [(1_300_000, 17), (400_000, 9),
                                    (10_000, 1025)])
def test_row_totals_bound_matches_the_release_check(rows, d):
    ms, by = chip_smoke.row_totals_bound(rows, d)
    assert by == "bytes"
    assert roofline.row_totals_bound_s(rows, d) * 1e3 == pytest.approx(ms)
    assert roofline.row_totals_bound_total_s({(rows, d): 3}) == \
        pytest.approx(3 * ms / 1e3)


def test_grid_matches_the_bucketer():
    from fastconsensus_tpu_torch.serve.bucketer import bucket_for

    for n, e in ((1000, 9_700), (300, 1_700), (10_000, 58_712)):
        b = bucket_for(n, e)
        assert (jobs.grid_up(n), jobs.grid_up(e)) == (b.n_class, b.e_class)
