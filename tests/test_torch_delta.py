"""fcdelta, incremental consensus from a parent run's partitions: the
PyTorch port against the JAX reference, on the CPU.

The numpy half (delta parsing, the child graph, the frontier mask, the
warm-start policy) is compared output for output and error message for
error message.  The engine half calls both packages'
``run_consensus(init_labels=, active_mask=)`` directly at a fixed
``max_rounds``, so nothing depends on convergence.  Inputs are built
with numpy from fixed seeds.  Tolerance: exact for partitions, labels and
integer round statistics; the two float round metrics rtol 1e-5, as in
``test_torch_consensus.py``.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from fastconsensus_tpu.consensus import ConsensusConfig as JConfig
from fastconsensus_tpu.consensus import run_consensus as jrun
from fastconsensus_tpu.graph import pack_edges as jpack
from fastconsensus_tpu.models.registry import get_detector as jdetector
from fastconsensus_tpu.serve import delta as jd
from fastconsensus_tpu.utils.io import read_edgelist
from fastconsensus_tpu.utils.synth import planted_partition
from fastconsensus_tpu_torch import interop
from fastconsensus_tpu_torch.consensus import ConsensusConfig, run_consensus
from fastconsensus_tpu_torch.engine import consensus_round
from fastconsensus_tpu_torch.graph import pack_edges
from fastconsensus_tpu_torch.models.registry import get_detector
from fastconsensus_tpu_torch.serve import delta as td
from fastconsensus_tpu_torch.serve.jobs import canonical_edges
from fastconsensus_tpu_torch.utils import prng

KARATE = Path(__file__).resolve().parent.parent / "examples" / \
    "karate_club.txt"


def same_outcome(fn_t, fn_j):
    """Run the port's and the reference's call; both must return equal
    values or raise the same error type with the same message."""
    try:
        got = fn_t()
    except Exception as e:        # compared with the reference's below
        with pytest.raises(Exception) as je:
            fn_j()
        assert type(e).__name__ == je.type.__name__
        assert str(e) == str(je.value)
        return None
    want = fn_j()
    return got, want


def assert_same_arrays(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


# -- the numpy half -----------------------------------------------------

PAIRS = [
    ([[3, 7], [1, 0], [9, 2]], "adds"),
    ([[2, 9], [7, 3], [0, 1]], "adds"),
    (None, "adds"), ([], "removes"),
    ([[0, 1], [5, 5]], "adds"), ([[0, 99]], "removes"),
    ([[0, 1], [2, 3], [1, 0]], "adds"), ([[1, 2, 3]], "adds"),
    ([["x", 2]], "adds"), ("nope", "adds"),
]


@pytest.mark.parametrize("raw,field", PAIRS)
def test_parse_edge_pairs_matches_reference(raw, field):
    out = same_outcome(lambda: td.parse_edge_pairs(raw, field, 16),
                       lambda: jd.parse_edge_pairs(raw, field, 16))
    if out is not None:
        assert_same_arrays([out[0]], [out[1]])


@pytest.mark.parametrize("payload", [
    {}, {"adds": [[0, 1]], "removes": [[1, 0]]},
    {"adds": [[0, 1]], "removes": [[2, 3]]},
    {"adds": [[4, 1], [0, 2]]}, {"removes": [[5, 6]]}])
def test_parse_delta_matches_reference(payload):
    out = same_outcome(lambda: td.parse_delta(payload, 16),
                       lambda: jd.parse_delta(payload, 16))
    if out is not None:
        assert_same_arrays(*out)


def _path():
    return np.array([0, 1, 2], np.int64), np.array([1, 2, 3], np.int64)


@pytest.mark.parametrize("weights,adds,removes", [
    (None, [[0, 3]], [[1, 2]]),
    ([2.0, 3.0, 4.0], [[0, 3]], [[1, 2]]),
    (None, [], [[0, 2]]),            # remove an absent edge
    (None, [[1, 2]], []),            # add a present edge
])
def test_apply_delta_matches_reference(weights, adds, removes):
    u, v = _path()
    w = None if weights is None else np.asarray(weights, np.float32)
    a = td.parse_edge_pairs(adds, "adds", 4)
    r = td.parse_edge_pairs(removes, "removes", 4)
    out = same_outcome(lambda: td.apply_delta(u, v, w, 4, a, r),
                       lambda: jd.apply_delta(u, v, w, 4, a, r))
    if out is not None:
        assert_same_arrays(*out)


def test_apply_delta_refuses_an_empty_graph_as_reference():
    a = td.parse_edge_pairs([], "adds", 4)
    r = td.parse_edge_pairs([[0, 1]], "removes", 4)
    one = np.array([0], np.int64), np.array([1], np.int64)
    assert same_outcome(lambda: td.apply_delta(*one, None, 4, a, r),
                        lambda: jd.apply_delta(*one, None, 4, a, r)) is None


def _random_delta(u, v, n, k, seed):
    """k removed edges of (u, v) and k absent pairs, from a seed."""
    rng = np.random.default_rng(seed)
    rem = np.stack([u, v], 1)[rng.choice(u.shape[0], k, replace=False)]
    have = set((u * n + v).tolist())
    adds = []
    while len(adds) < k:
        a, b = sorted(int(x) for x in rng.integers(0, n, 2))
        if a != b and a * n + b not in have:
            have.add(a * n + b)
            adds.append([a, b])
    return td.parse_delta({"adds": adds, "removes": rem.tolist()}, n)


def test_neighborhood_mask_matches_reference():
    idx = np.arange(8)
    u, v = np.minimum(idx, (idx + 1) % 8), np.maximum(idx, (idx + 1) % 8)
    adds = td.parse_edge_pairs([[0, 1]], "adds", 8)
    none = td.parse_edge_pairs([], "removes", 8)
    mask = td.neighborhood_mask(u, v, 8, adds, none)
    np.testing.assert_array_equal(mask, jd.neighborhood_mask(u, v, 8, adds,
                                                             none))
    assert set(np.flatnonzero(mask).tolist()) == {0, 1, 2, 7}
    edges, _ = planted_partition(300, 6, 0.2, 0.01, seed=3)
    pu, pv, _ = canonical_edges(edges, 300)
    adds, removes = _random_delta(pu, pv, 300, 6, seed=4)
    cu, cv, _ = td.apply_delta(pu, pv, None, 300, adds, removes)
    assert_same_arrays(
        [cu, cv, td.neighborhood_mask(cu, cv, 300, adds, removes)],
        [*jd.apply_delta(pu, pv, None, 300, adds, removes)[:2],
         jd.neighborhood_mask(cu, cv, 300, adds, removes)])


def _good_parent(n_p=4):
    return {"partitions": [[0, 0, 1]] * n_p, "converged": True,
            "quality": {"final_agreement": 0.9, "final_churn_frac": 0.1}}


POLICY_CASES = {
    "incremental": {},
    "detector_no_warm": dict(warm_capable=False),
    "huge_tier": dict(huge=True),
    "delta_too_large": dict(n_changed=11),
    "bucket_boundary": dict(child_bucket_key="n64_e128"),
    "ensemble_mismatch": dict(parent=dict(_good_parent(), partitions=[[0]])),
    "parent_unconverged": dict(parent=dict(_good_parent(), converged=False)),
    "parent_quality_missing": dict(parent=dict(_good_parent(), quality=None)),
    "low_parent_agreement": dict(parent=dict(
        _good_parent(), quality={"final_agreement": 0.2,
                                 "final_churn_frac": 0.1})),
    "high_parent_churn": dict(parent=dict(
        _good_parent(), quality={"final_agreement": 0.9,
                                 "final_churn_frac": 0.9})),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_delta_policy_decides_as_reference(case):
    ok = dict(n_changed=1, n_parent_edges=100, parent=_good_parent(),
              parent_bucket_key="n64_e96", child_bucket_key="n64_e96",
              warm_capable=True)
    kw = dict(ok, **POLICY_CASES[case])
    got = td.DeltaPolicy().decide(config=ConsensusConfig(n_p=4), **kw)
    want = jd.DeltaPolicy().decide(config=JConfig(n_p=4), **kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.reason == (None if case == "incremental" else case)
    assert td.describe_payload("p" * 32, got, 3, 2) == \
        jd.describe_payload("p" * 32, want, 3, 2)


def test_delta_cache_key_matches_reference():
    key = td.delta_cache_key("c" * 32, "p" * 32)
    assert key == jd.delta_cache_key("c" * 32, "p" * 32)
    assert key.startswith("c" * 32 + ":delta:") and key.endswith("p" * 16)
    assert issubclass(td.DeltaError, ValueError)
    assert issubclass(td.ParentNotCached, Exception)


# -- the engine half ----------------------------------------------------


def _karate():
    edges, _, ids = read_edgelist(str(KARATE))
    return np.asarray(edges), len(ids)


def _planted_hybrid():
    """A planted 5k-node graph with ten grafted hubs: hybrid sizing."""
    rng = np.random.default_rng(11)
    edges, _ = planted_partition(5000, 40, 0.08, 0.0004, seed=7)
    hubs = rng.choice(5000, 10, replace=False)
    extra = np.array([[h, int(o)] for h in hubs
                      for o in rng.choice(5000, 600, replace=False)
                      if int(o) != h])
    return np.vstack([edges, extra]), 5000


def _incremental_inputs(edges, n, k, cfg):
    """A one-round parent run's partitions on the graph, the child graph
    after k removed and k added edges, and its frontier mask."""
    u, v, _ = canonical_edges(edges, n)
    adds, removes = _random_delta(u, v, n, k, seed=5)
    cu, cv, _ = td.apply_delta(u, v, None, n, adds, removes)
    active = td.neighborhood_mask(cu, cv, n, adds, removes)
    parent = run_consensus(pack_edges(np.stack([u, v], 1), n, device="cpu"),
                           get_detector("louvain"),
                           ConsensusConfig(**dict(cfg, max_rounds=1)))
    return np.stack([cu, cv], 1), np.stack(parent.partitions), active


@pytest.mark.parametrize("graph", ["karate", "planted_hybrid"])
def test_incremental_run_matches_reference(monkeypatch, graph):
    """``run_consensus(init_labels=, active_mask=)`` on the child graph:
    partitions, rounds and history equal to the reference's; round 0
    warm; every frozen vertex keeps its parent label in every member,
    through the final re-detection."""
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "1")
    if graph == "karate":
        edges, n = _karate()
        k, cfg = 2, dict(n_p=4, tau=0.2, delta=0.02, max_rounds=3, seed=3)
    else:
        monkeypatch.setenv("FCTPU_MOVE_PATH", "hybrid")
        edges, n = _planted_hybrid()
        k, cfg = 10, dict(n_p=4, tau=0.2, delta=0.02, max_rounds=3, seed=1,
                          closure_tau=0.2)
    child, init, active = _incremental_inputs(edges, n, k, cfg)
    assert 0 < active.sum() < n
    js = jpack(child, n)
    if graph != "karate":
        assert js.d_hyb > 0 and js.hub_cap > 0
    jres = jrun(js, jdetector("louvain"), JConfig(**cfg), init_labels=init,
                active_mask=active)
    tres = run_consensus(pack_edges(child, n, device="cpu"),
                         get_detector("louvain"), ConsensusConfig(**cfg),
                         init_labels=init, active_mask=active)
    assert tres.rounds == jres.rounds == 3
    assert not tres.history[0]["cold"]
    for a, b in zip(tres.history, jres.history):
        for key, want in b.items():
            if key in ("agreement", "modularity_mean"):
                assert a[key] == pytest.approx(want, rel=1e-5, abs=1e-6)
            elif key == "modularity_by_member":
                np.testing.assert_allclose(a[key], want, rtol=1e-5,
                                           atol=1e-6)
            else:
                assert a[key] == want, key
    np.testing.assert_array_equal(np.stack(tres.partitions),
                                  np.stack(jres.partitions))
    frozen = ~active
    for i, p in enumerate(tres.partitions):
        np.testing.assert_array_equal(p[frozen], init[i][frozen])


def _error_cases(init, active, n_p, n):
    """(port call kwargs, reference call kwargs, config overrides): each
    validation error of the fcdelta entry."""
    bad_init = init[:, :-1]
    return {
        "active_without_init": (dict(active_mask=active), {}),
        "not_warm": (dict(init_labels=init), dict(warm_start=False)),
        "checkpoint": (dict(init_labels=init, checkpoint_path="x.npz"), {}),
        "resume": (dict(init_labels=init, resume=True), {}),
        "init_shape": (dict(init_labels=bad_init), {}),
        "active_shape": (dict(init_labels=init, active_mask=active[:-1]),
                         {}),
    }


@pytest.mark.parametrize("case", ["active_without_init", "not_warm",
                                  "checkpoint", "resume", "init_shape",
                                  "active_shape", "no_supports_init"])
def test_incremental_validation_errors_match_reference(karate_slab, case):
    """Each validation error, raised before any device work, with the
    reference's message."""
    n, n_p = karate_slab.n_nodes, 4
    init = np.zeros((n_p, n), np.int32)
    active = np.ones(n, bool)
    tslab = interop.slab_from_arrays(
        np.asarray(karate_slab.src), np.asarray(karate_slab.dst),
        np.asarray(karate_slab.weight), np.asarray(karate_slab.alive),
        n_nodes=n, device="cpu")
    tdet, jdet = get_detector("louvain"), jdetector("louvain")
    if case == "no_supports_init":
        kw, over = dict(init_labels=init), {}
        tdet = lambda slab, keys, init_labels=None: None      # noqa: E731
        jdet = lambda slab, keys, init_labels=None: None      # noqa: E731
    else:
        kw, over = _error_cases(init, active, n_p, n)[case]
    cfg = dict(n_p=n_p, max_rounds=1, **over)
    with pytest.raises(ValueError) as te:
        run_consensus(tslab, tdet, ConsensusConfig(**cfg), **kw)
    with pytest.raises(ValueError) as je:
        jrun(karate_slab, jdet, JConfig(**cfg), **kw)
    assert str(te.value) == str(je.value)


def test_round_active_mask_needs_prev_labels_and_none_is_identity(
        karate_slab):
    slab = interop.slab_from_arrays(
        np.asarray(karate_slab.src), np.asarray(karate_slab.dst),
        np.where(np.asarray(karate_slab.alive), 1.0, 0.0),
        np.asarray(karate_slab.alive), n_nodes=karate_slab.n_nodes,
        device="cpu")
    det, n = get_detector("louvain"), slab.n_nodes
    key = prng.key(4, "cpu")
    args = (slab, key, det, 4, 0.2, 0.02, 78)
    with pytest.raises(ValueError, match="active mask requires prev_labels"):
        consensus_round(*args, active=torch.ones(n, dtype=torch.bool))
    prev = torch.arange(n).expand(4, n)
    _, plain, _ = consensus_round(*args, prev_labels=prev)
    _, all_on, _ = consensus_round(*args, prev_labels=prev,
                                   active=torch.ones(n, dtype=torch.bool))
    assert torch.equal(plain, all_on)
    mask = torch.arange(n) % 2 == 0
    _, half, _ = consensus_round(*args, prev_labels=prev, active=mask)
    assert torch.equal(half[:, mask], plain[:, mask])
    assert torch.equal(half[:, ~mask], prev[:, ~mask])
