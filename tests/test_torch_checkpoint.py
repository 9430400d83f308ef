"""Checkpoint / resume of the port against the JAX package, on the CPU.

Both packages write the same ``.npz`` format, so a checkpoint written by
either resumes in the other, and a resumed run lands on the uninterrupted
run's partitions, graph and integer history exactly.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from fastconsensus_tpu.consensus import ConsensusConfig as JConfig
from fastconsensus_tpu.consensus import run_consensus as jrun
from fastconsensus_tpu.graph import pack_edges as jpack
from fastconsensus_tpu.models.registry import get_detector as jdetector
from fastconsensus_tpu.utils import checkpoint as jckpt
from fastconsensus_tpu.utils.synth import planted_partition
from fastconsensus_tpu_torch.consensus import ConsensusConfig, run_consensus
from fastconsensus_tpu_torch.graph import pack_edges
from fastconsensus_tpu_torch.models.registry import get_detector
from fastconsensus_tpu_torch.utils import checkpoint as ckpt
from fastconsensus_tpu_torch.utils import prng

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

INT_KEYS = ("round", "n_alive", "n_unconverged", "n_closure_added",
            "n_repaired", "n_dropped", "n_overflow", "n_hub_overflow",
            "n_agg_overflow", "cold", "capacity", "n_w_zero", "n_w_full",
            "n_frontier", "labels_changed", "labels_changed_by_member")


@pytest.fixture(autouse=True)
def _one_round_per_call(monkeypatch):
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "1")


def planted():
    edges, _ = planted_partition(120, 4, 0.35, 0.02, seed=8)
    return edges, 120


def hub_graph():
    """Planted communities plus three hubs: packs with hybrid sizing."""
    n = 1400
    edges, _ = planted_partition(n, 8, 0.02, 0.001, seed=5)
    rng = np.random.default_rng(5)
    hubs = []
    for h in range(3):
        nbrs = rng.choice(n, size=900, replace=False)
        nbrs = nbrs[nbrs != h]
        hubs.append(np.stack([np.full(nbrs.size, h), nbrs], 1))
    return np.vstack([edges] + hubs), n


def run_port(edges, n, cfg, capacity=None, **kw):
    slab = pack_edges(edges, n, capacity=capacity, device="cpu")
    return run_consensus(slab, get_detector(cfg["algorithm"]),
                         ConsensusConfig(**cfg), **kw)


def run_ref(edges, n, cfg, capacity=None, **kw):
    return jrun(jpack(edges, n, capacity=capacity),
                jdetector(cfg["algorithm"]), JConfig(**cfg), **kw)


def same_run(a, b):
    assert a.rounds == b.rounds and a.converged == b.converged
    assert [[h[k] for k in INT_KEYS] for h in a.history] == \
        [[h[k] for k in INT_KEYS] for h in b.history]
    np.testing.assert_array_equal(np.stack(a.partitions),
                                  np.stack(b.partitions))
    for name in ("src", "dst", "weight", "alive"):
        x, y = getattr(a.graph, name), getattr(b.graph, name)
        np.testing.assert_array_equal(
            x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x),
            y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y))


def test_checkpoint_roundtrip_and_file_layout(tmp_path):
    edges, n = planted()
    slab = pack_edges(edges, n, device="cpu")
    path = str(tmp_path / "state.npz")
    key_data = prng.key_data(prng.key(7, "cpu"))
    labels = torch.arange(2 * n).reshape(2, n) % 5
    history = [{"round": 1, "n_alive": 3}]
    ckpt.save_checkpoint(path, slab, 1, key_data, history,
                         extra={"alg": "lpm"}, labels=labels)
    with np.load(path) as z:
        assert z.files == ["src", "dst", "weight", "alive", "key_data",
                           "meta", "labels"]
        assert [z[f].dtype for f in z.files] == [
            np.int32, np.int32, np.float32, bool, np.uint32, np.uint8,
            np.int32]
        meta = json.loads(bytes(z["meta"]).decode())
    assert meta["version"] == 2 and "telemetry" not in meta
    slab2, rounds, kd, hist, extra = ckpt.load_checkpoint(path, device="cpu")
    assert rounds == 1 and hist == history
    np.testing.assert_array_equal(kd, key_data)
    assert torch.equal(extra.pop("_labels"), labels)
    assert extra == {"alg": "lpm"}
    for name in ("src", "dst", "weight", "alive"):
        a, b = getattr(slab2, name), getattr(slab, name)
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (slab2.n_nodes, slab2.d_cap, slab2.cap_hint, slab2.d_hyb,
            slab2.hub_cap, slab2.agg_cap) == (
        slab.n_nodes, slab.d_cap, slab.cap_hint, slab.d_hyb, slab.hub_cap,
        slab.agg_cap)


@pytest.mark.parametrize("alg,tau,sampler", [
    ("louvain", 0.2, "auto"),     # warm: labels ride in the checkpoint
    ("lpm", 0.5, "scatter"),
    ("cnm", 0.7, "auto"),         # host detector: every round cold
])
def test_resume_matches_uninterrupted_runs(tmp_path, alg, tau, sampler):
    """Port resume == the port's uninterrupted run == the reference's."""
    edges, n = planted()
    cfg = dict(algorithm=alg, n_p=8, tau=tau, delta=0.0, max_rounds=3,
               seed=3, closure_sampler=sampler)
    ref = run_ref(edges, n, cfg)
    full = run_port(edges, n, cfg)
    path = str(tmp_path / "ck.npz")
    run_port(edges, n, dict(cfg, max_rounds=1), checkpoint_path=path)
    resumed = run_port(edges, n, cfg, checkpoint_path=path, resume=True)
    assert len(ref.history) >= 1
    same_run(full, ref)
    same_run(resumed, ref)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_resume_across_packages(tmp_path, writer):
    """A checkpoint written by one package resumes in the other to the
    uninterrupted run, and the reference's loader reads the port's file."""
    edges, n = planted()
    cfg = dict(algorithm="louvain", n_p=6, tau=0.2, delta=0.0,
               max_rounds=3, seed=5)
    ref = run_ref(edges, n, cfg)
    path = str(tmp_path / "ck.npz")
    if writer == "reference":
        run_ref(edges, n, dict(cfg, max_rounds=1), checkpoint_path=path)
        resumed = run_port(edges, n, cfg, checkpoint_path=path, resume=True)
    else:
        run_port(edges, n, dict(cfg, max_rounds=1), checkpoint_path=path)
        jslab, rounds, kd, hist, extra = jckpt.load_checkpoint(path)
        pslab, prounds, pkd, phist, pextra = ckpt.load_checkpoint(
            path, device="cpu")
        assert rounds == prounds == 1 and hist == phist
        np.testing.assert_array_equal(kd, np.asarray(
            jax.random.key_data(jax.random.key(5))))
        assert np.asarray(jslab.src).dtype == np.int32
        np.testing.assert_array_equal(np.asarray(jslab.alive),
                                      pslab.alive.numpy())
        np.testing.assert_array_equal(extra["_labels"],
                                      pextra["_labels"].numpy())
        assert extra["member_seconds"] is None
        assert extra["closure_sampler"] == "csr"
        resumed = run_ref(edges, n, cfg, checkpoint_path=path, resume=True)
    same_run(resumed, ref)


def test_hybrid_resume_parity_keeps_sizing(tmp_path, monkeypatch):
    """Resume on a hub-heavy slab: the hybrid sizing survives the round
    trip and the resumed run equals the uninterrupted one."""
    from fastconsensus_tpu_torch.models.louvain import select_move_path

    monkeypatch.setenv("FCTPU_MOVE_PATH", "hybrid")
    edges, n = hub_graph()
    cfg = dict(algorithm="louvain", n_p=4, tau=0.2, delta=0.02,
               max_rounds=2, seed=1)
    slab = pack_edges(edges, n, device="cpu")
    assert slab.d_hyb > 0 and slab.hub_cap > 0
    path = str(tmp_path / "ck.npz")
    run_port(edges, n, dict(cfg, max_rounds=1), checkpoint_path=path)
    loaded = ckpt.load_checkpoint(path, device="cpu")[0]
    assert (loaded.d_hyb, loaded.hub_cap) == (slab.d_hyb, slab.hub_cap)
    assert select_move_path(loaded) == "hybrid"
    resumed = run_port(edges, n, cfg, checkpoint_path=path, resume=True)
    same_run(resumed, run_port(edges, n, cfg))


def test_legacy_v1_checkpoint_migrates_hybrid_sizing(tmp_path):
    edges, n = hub_graph()
    cfg = dict(algorithm="louvain", n_p=4, tau=0.2, delta=0.02,
               max_rounds=1, seed=1)
    path = str(tmp_path / "ck.npz")
    run_port(edges, n, cfg, checkpoint_path=path)
    with np.load(path) as z:
        arrays = {name: z[name].copy() for name in z.files}
    meta = json.loads(bytes(arrays["meta"]).decode())
    meta["version"] = 1
    del meta["d_hyb"], meta["hub_cap"]
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    loaded, _, _, _, extra = ckpt.load_checkpoint(path, device="cpu")
    assert extra.get("_legacy_v1") and loaded.d_hyb == 0
    resumed = run_port(edges, n, dict(cfg, max_rounds=2),
                       checkpoint_path=path, resume=True)
    assert resumed.graph.d_hyb > 0 and resumed.graph.hub_cap > 0


def _rewrite_extra(path, **changes):
    with np.load(path) as z:
        arrays = {name: z[name].copy() for name in z.files}
    meta = json.loads(bytes(arrays["meta"]).decode())
    for k, v in changes.items():
        if v is KeyError:
            del meta["extra"][k]
        else:
            meta["extra"][k] = v
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def test_pre_knob_checkpoints_migrate(tmp_path):
    """A file without ``closure_sampler`` continues with the scatter
    sampler under "auto" (and refuses "csr"); one without ``closure_tau``
    resumes only without a bar, naming the migration."""
    edges, n = planted()
    cfg = dict(algorithm="lpm", n_p=8, tau=0.5, delta=0.0, max_rounds=2,
               seed=3)
    path = str(tmp_path / "ck.npz")
    run_port(edges, n, dict(cfg, max_rounds=1, closure_sampler="scatter"),
             checkpoint_path=path)
    _rewrite_extra(path, closure_sampler=KeyError, closure_tau=KeyError)
    resumed = run_port(edges, n, cfg, checkpoint_path=path, resume=True)
    same_run(resumed, run_port(edges, n, dict(cfg,
                                              closure_sampler="scatter")))
    run_port(edges, n, dict(cfg, max_rounds=1, closure_sampler="scatter"),
             checkpoint_path=path)
    _rewrite_extra(path, closure_sampler=KeyError, closure_tau=KeyError)
    with pytest.raises(ValueError, match="different run configuration"):
        run_port(edges, n, dict(cfg, closure_sampler="csr"),
                 checkpoint_path=path, resume=True)
    with pytest.raises(ValueError, match="predates the closure_tau knob"):
        run_port(edges, n, dict(cfg, closure_tau=0.5),
                 checkpoint_path=path, resume=True)


@pytest.mark.parametrize("change", [
    dict(n_p=4), dict(tau=0.6), dict(delta=0.1), dict(algorithm="leiden"),
    dict(gamma=0.5), dict(warm_start=False), dict(align_frac=0.5),
    dict(closure_sampler="scatter"), dict(closure_tau=0.5), "graph"])
def test_resume_rejects_mismatched_config(tmp_path, change):
    edges, n = planted()
    cfg = dict(algorithm="louvain", n_p=8, tau=0.5, delta=0.0,
               max_rounds=1, seed=3)
    path = str(tmp_path / "ck.npz")
    run_port(edges, n, cfg, checkpoint_path=path)
    if change == "graph":
        edges, n = np.vstack([edges, [[120, 0]]]), 121
        change = {}
    bad = dict(cfg, max_rounds=2, **change)
    with pytest.raises(ValueError, match="closure_tau|different run"):
        run_port(edges, n, bad, checkpoint_path=path, resume=True)


def test_resume_after_convergence_is_a_noop(tmp_path):
    edges, n = planted()
    cfg = dict(algorithm="louvain", n_p=8, tau=0.5, delta=1.0,
               max_rounds=4, seed=3)       # delta 1: converges in round 1
    path = str(tmp_path / "ck.npz")
    first = run_port(edges, n, cfg, checkpoint_path=path)
    assert first.converged and first.rounds == 1
    stamp = os.stat(path).st_mtime_ns
    again = run_port(edges, n, cfg, checkpoint_path=path, resume=True)
    same_run(again, first)
    assert os.stat(path).st_mtime_ns == stamp   # no round ran, no save


def test_resume_keeps_grown_capacity_and_honours_a_larger_pack(tmp_path):
    """Capacity that auto-grew before the checkpoint survives it; a larger
    fresh pack grows the resumed slab; both equal the uninterrupted run."""
    edges, n = planted()
    cfg = dict(algorithm="louvain", n_p=6, tau=0.2, delta=0.0,
               max_rounds=3, seed=2)
    cap = int(pack_edges(edges, n, device="cpu").num_alive()) + 8
    full = run_port(edges, n, cfg, capacity=cap)
    assert full.history[0]["capacity"] > cap      # round 1 grew the slab
    same_run(full, run_ref(edges, n, cfg, capacity=cap))
    path = str(tmp_path / "ck.npz")
    run_port(edges, n, dict(cfg, max_rounds=1), capacity=cap,
             checkpoint_path=path)
    grown = ckpt.load_checkpoint(path, device="cpu")[0].capacity
    assert grown == full.history[0]["capacity"]
    same_run(run_port(edges, n, cfg, capacity=cap, checkpoint_path=path,
                      resume=True), full)
    bigger = run_port(edges, n, cfg, capacity=grown + 100,
                      checkpoint_path=path, resume=True)
    assert bigger.graph.capacity >= grown + 100
    np.testing.assert_array_equal(np.stack(bigger.partitions),
                                  np.stack(full.partitions))


def test_checkpoint_every_saves_every_kth_round_and_on_convergence(
        tmp_path, monkeypatch):
    saved = []
    save = ckpt.save_checkpoint

    def spy(path, slab, rounds_done, *a, **k):
        saved.append((rounds_done, k["extra"]["converged"]))
        save(path, slab, rounds_done, *a, **k)

    monkeypatch.setattr(ckpt, "save_checkpoint", spy)
    edges, n = planted()
    cfg = dict(algorithm="louvain", n_p=8, tau=0.2, delta=0.0,
               max_rounds=4, seed=3)
    path = str(tmp_path / "ck.npz")
    res = run_port(edges, n, cfg, checkpoint_path=path, checkpoint_every=2)
    assert res.converged and res.rounds == 3
    assert saved == [(2, False), (3, True)]
    assert ckpt.load_checkpoint(path, device="cpu")[1] == 3
