"""Whole-run parity: the PyTorch port's consensus tail, driver and CLI
against the JAX reference, on the CPU.

Both packages draw every random number from the same threefry key tree,
so the same seed gives identical labels, partitions and per-round integer
history.  The two float metrics of a round (member modularity, agreement)
are sums taken in another order: rtol 1e-5.
"""

import filecmp
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastconsensus_tpu.consensus import ConsensusConfig as JConfig
from fastconsensus_tpu.consensus import run_consensus as jrun
from fastconsensus_tpu.engine import consensus_tail as jtail
from fastconsensus_tpu.graph import pack_edges as jpack
from fastconsensus_tpu.models.registry import get_detector as jdetector
from fastconsensus_tpu.utils.synth import planted_partition
from fastconsensus_tpu_torch import interop
from fastconsensus_tpu_torch.consensus import ConsensusConfig, run_consensus
from fastconsensus_tpu_torch.engine import consensus_tail
from fastconsensus_tpu_torch.models.registry import get_detector

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
KARATE = REPO / "examples" / "karate_club.txt"

INT_FIELDS = ("n_alive", "n_unconverged", "n_closure_added", "n_repaired",
              "n_dropped", "n_overflow", "n_hub_overflow", "n_agg_overflow",
              "n_w_zero", "n_w_full", "n_frontier")
FLOAT_FIELDS = ("member_modularity", "agreement")


def port_slab(js):
    return interop.slab_from_arrays(
        np.asarray(js.src), np.asarray(js.dst), np.asarray(js.weight),
        np.asarray(js.alive), n_nodes=js.n_nodes, d_cap=js.d_cap,
        cap_hint=js.cap_hint, d_hyb=js.d_hyb, hub_cap=js.hub_cap,
        agg_cap=js.agg_cap, device="cpu")


def hybrid_graph(n=2000):
    """Planted communities plus grafted hubs (carries hybrid sizing)."""
    rng = np.random.default_rng(11)
    edges, truth = planted_partition(n, 10, 0.06, 0.0008, seed=4)
    hubs = rng.choice(n, 8, replace=False)
    extra = np.array([[h, int(o)] for h in hubs
                      for o in rng.choice(n, 120, replace=False)
                      if int(o) != h])
    return np.vstack([edges, extra]), truth


@pytest.mark.parametrize("closure_tau", [None, 0.5])
def test_consensus_tail_matches_reference(karate_slab, closure_tau):
    n_p, n = 6, karate_slab.n_nodes
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 3, (n_p, n)).astype(np.int32)
    prev = rng.integers(0, 3, (n_p, n)).astype(np.int32)
    # isolated-node repair needs edges that thresholding kills
    labels[:, 0] = np.arange(n_p) + 10
    key = jax.random.key(9)
    js = karate_slab.with_weights(jnp.where(karate_slab.alive, 1.0, 0.0))
    jslab, jst = jax.jit(
        lambda s, l, k, p: jtail(s, l, k, n_p, 0.5, 0.02, 78,
                                 sampler="csr", closure_tau=closure_tau,
                                 prev_labels=p))(js, jnp.asarray(labels), key,
                                                 jnp.asarray(prev))
    tslab, tst = consensus_tail(
        port_slab(js), torch.as_tensor(labels, dtype=torch.int64),
        interop.key_from_data(np.asarray(jax.random.key_data(key)),
                              device="cpu"), n_p,
        0.5, 0.02, 78, closure_tau=closure_tau,
        prev_labels=torch.as_tensor(prev, dtype=torch.int64))
    for f in INT_FIELDS + ("converged",):
        assert int(getattr(tst, f)) == int(getattr(jst, f)), f
    np.testing.assert_array_equal(tst.labels_changed.numpy(),
                                  np.asarray(jst.labels_changed))
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)), rtol=1e-5)
    assert int(jst.n_closure_added) > 0 and int(jst.n_repaired) > 0
    for name in ("src", "dst", "weight", "alive"):
        np.testing.assert_array_equal(getattr(tslab, name).numpy(),
                                      np.asarray(getattr(jslab, name)))


def _compare_runs(jres, tres):
    assert tres.rounds == jres.rounds
    assert tres.converged == jres.converged
    for a, b in zip(tres.history, jres.history):
        for k, v in b.items():
            if k in ("agreement", "modularity_mean"):
                assert a[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
            elif k == "modularity_by_member":
                np.testing.assert_allclose(a[k], v, rtol=1e-5, atol=1e-6)
            else:
                assert a[k] == v, k
    np.testing.assert_array_equal(np.stack(tres.partitions),
                                  np.stack(jres.partitions))
    for name in ("src", "dst", "weight", "alive"):
        np.testing.assert_array_equal(
            getattr(tres.graph, name).numpy(),
            np.asarray(getattr(jres.graph, name)))


def test_run_consensus_karate_identical(monkeypatch, karate_slab):
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "1")   # one round per call
    # the CLI test's settings, so the two share the reference's executables
    cfg = dict(n_p=6, tau=0.2, delta=0.02, max_rounds=3, seed=2)
    jres = jrun(karate_slab, jdetector("louvain"), JConfig(**cfg))
    tres = run_consensus(port_slab(karate_slab), get_detector("louvain"),
                         ConsensusConfig(**cfg))
    assert len(jres.history) >= 2
    _compare_runs(jres, tres)


def test_run_consensus_forced_hybrid_identical(monkeypatch):
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "1")
    monkeypatch.setenv("FCTPU_MOVE_PATH", "hybrid")
    edges, truth = hybrid_graph()
    js = jpack(edges, 2000)
    assert js.d_hyb > 0 and js.hub_cap > 0
    cfg = dict(n_p=4, tau=0.2, delta=0.02, max_rounds=2, seed=1,
               closure_tau=0.2)
    jres = jrun(js, jdetector("louvain"), JConfig(**cfg))
    tres = run_consensus(port_slab(js), get_detector("louvain"),
                         ConsensusConfig(**cfg))
    _compare_runs(jres, tres)
    from fastconsensus_tpu_torch.utils.metrics import nmi
    assert np.mean([nmi(p, truth) for p in tres.partitions]) > 0.9


def test_cli_output_trees_byte_identical(monkeypatch, tmp_path):
    from fastconsensus_tpu import cli as jcli
    from fastconsensus_tpu_torch import cli as tcli

    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "1")
    args = ["-f", str(KARATE), "-np", "6", "--max-rounds", "3", "--seed",
            "2", "--quiet"]
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    assert jcli.main(args + ["--out-dir", str(tmp_path / "ref")]) == 0
    assert tcli.main(args + ["--out-dir", str(tmp_path / "port"),
                             "--device", "cpu"]) == 0
    trees = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert trees == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(trees) == 2
    for tree in trees:
        files = sorted(os.listdir(tmp_path / "ref" / tree))
        assert len(files) == 6
        match, mismatch, errors = filecmp.cmpfiles(
            tmp_path / "ref" / tree, tmp_path / "port" / tree, files,
            shallow=False)
        assert mismatch == [] and errors == [], (tree, mismatch, errors)


TAU = {"lpm": 0.8, "leiden": 0.2, "cnm": 0.7, "infomap": 0.6}


@pytest.mark.parametrize("alg", ["lpm", "leiden", "cnm", "infomap"])
def test_run_consensus_karate_identical_by_alg(monkeypatch, karate_slab,
                                               alg):
    """LPM (no key alignment), Leiden (theta refinement cold, greedy warm
    and refresh variants) and the host C++ detectors CNM and Infomap (no
    warm start: every round cold) through the same driver."""
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "1")
    cfg = dict(algorithm=alg, n_p=6, tau=TAU[alg], delta=0.02, max_rounds=3,
               seed=2)
    jres = jrun(karate_slab, jdetector(alg), JConfig(**cfg))
    tres = run_consensus(port_slab(karate_slab), get_detector(alg),
                         ConsensusConfig(**cfg))
    assert len(jres.history) >= 1
    _compare_runs(jres, tres)


@pytest.mark.parametrize("alg", ["lpm", "leiden", "cnm", "infomap"])
def test_cli_output_trees_byte_identical_by_alg(monkeypatch, tmp_path, alg):
    compare_cli_trees(monkeypatch, tmp_path, ["--alg", alg])


@pytest.mark.parametrize("flags", [
    ["--closure-sampler", "scatter"],
    ["-g", "0.5"],
    ["--alg", "leiden", "-g", "0.5"],
    ["--alg", "cnm", "-g", "0.5"],          # ignored with a warning
    # at the CLI's default n_p and rounds, closure grows a 100-slot slab
    # in round 5; without growth an 85-slot one drops candidates
    ["-np", "20", "--max-rounds", "64", "--seed", "0", "--capacity", "100"],
    ["-np", "20", "--max-rounds", "64", "--seed", "0", "--no-grow",
     "--capacity", "85"],
    ["--align-frac", "0"],
    ["--cold-detect"],
], ids=["scatter", "gamma", "leiden_gamma", "cnm_gamma", "capacity",
        "no_grow", "align_frac_0", "cold_detect"])
def test_cli_flags_byte_identical(monkeypatch, tmp_path, flags):
    compare_cli_trees(monkeypatch, tmp_path, flags)


def compare_cli_trees(monkeypatch, tmp_path, flags):
    from fastconsensus_tpu import cli as jcli
    from fastconsensus_tpu_torch import cli as tcli

    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "1")
    args = ["-f", str(KARATE), "-np", "6", "--max-rounds", "3", "--seed",
            "2", "--quiet"] + flags
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    assert jcli.main(args + ["--out-dir", str(tmp_path / "ref")]) == 0
    assert tcli.main(args + ["--out-dir", str(tmp_path / "port"),
                             "--device", "cpu"]) == 0
    trees = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert trees == sorted(p.name for p in (tmp_path / "port").iterdir())
    n_p = tcli.build_parser().parse_args(args).n_p
    for tree in trees:
        files = sorted(os.listdir(tmp_path / "ref" / tree))
        assert len(files) == n_p
        match, mismatch, errors = filecmp.cmpfiles(
            tmp_path / "ref" / tree, tmp_path / "port" / tree, files,
            shallow=False)
        assert mismatch == [] and errors == [], (tree, mismatch, errors)


def test_cli_run_flags_take_effect(monkeypatch):
    """The flag cases above change the run: growth, drops, the scatter
    sampler's other wedges, the ignored gamma (fast_consensus takes the
    same fields)."""
    from fastconsensus_tpu_torch.consensus import fast_consensus
    from fastconsensus_tpu_torch.utils.io import read_edgelist

    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "1")
    edges, _, ids = read_edgelist(str(KARATE))
    run = dict(n_p=6, max_rounds=3, seed=2, device="cpu")
    base = fast_consensus(edges, len(ids), **run)
    grown = fast_consensus(edges, len(ids), capacity=100, n_p=20, seed=0,
                           device="cpu")
    assert grown.history[-1]["capacity"] > 100
    dropped = fast_consensus(edges, len(ids), capacity=85, auto_grow=False,
                             n_p=20, seed=0, device="cpu")
    assert sum(h["n_dropped"] for h in dropped.history) > 0
    assert dropped.graph.capacity == 85
    scatter = fast_consensus(edges, len(ids), closure_sampler="scatter",
                             **run)
    assert [h["n_closure_added"] for h in scatter.history] != \
        [h["n_closure_added"] for h in base.history]
    with pytest.warns(UserWarning, match="gamma=0.5 ignored"):
        cnm = fast_consensus(edges, len(ids), algorithm="cnm", tau=0.7,
                             gamma=0.5, **run)
    assert all(h["cold"] for h in cnm.history)


def test_cli_rejects_unported_algorithm_and_missing_cuda(tmp_path, capsys,
                                                         monkeypatch):
    """Every algorithm is ported now: an unknown ``--alg`` exits 2, and a
    host detector whose C++ does not build exits 2 with the compiler's
    error (no fallback); without CUDA the default device exits 2."""
    from fastconsensus_tpu_torch import cli as tcli
    from fastconsensus_tpu_torch import native
    from fastconsensus_tpu_torch.models import registry

    with pytest.raises(SystemExit) as exc:
        tcli.main(["-f", str(KARATE), "--alg", "walktrap", "--device",
                   "cpu", "--out-dir", str(tmp_path)])
    assert exc.value.code == 2
    assert "invalid choice: 'walktrap'" in capsys.readouterr().err
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'fake-cxx: cannot build' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.reset()
    registry._get_cached.cache_clear()
    try:
        rc = tcli.main(["-f", str(KARATE), "--alg", "cnm", "--device", "cpu",
                        "--out-dir", str(tmp_path)])
        err = capsys.readouterr().err
        assert rc == 2 and "fake-cxx: cannot build" in err, err
        assert not any(p.name.startswith("out_partitions")
                       for p in tmp_path.iterdir())
    finally:
        monkeypatch.undo()
        native.reset()
    if not torch.cuda.is_available():
        rc = tcli.main(["-f", str(KARATE), "--out-dir", str(tmp_path)])
        assert rc == 2 and "CUDA is not available" in capsys.readouterr().err


@pytest.mark.parametrize("alg", ["louvain", "leiden"])
def test_run_consensus_scatter_sampler_identical(monkeypatch, karate_slab,
                                                 alg):
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "1")
    cfg = dict(algorithm=alg, n_p=6, tau=0.2, delta=0.02, max_rounds=3,
               seed=4, closure_sampler="scatter")
    jres = jrun(karate_slab, jdetector(alg), JConfig(**cfg))
    tres = run_consensus(port_slab(karate_slab), get_detector(alg),
                         ConsensusConfig(**cfg))
    assert sum(h["n_closure_added"] for h in jres.history) > 0
    _compare_runs(jres, tres)


def test_entry_points_default_to_cuda():
    from fastconsensus_tpu_torch.consensus import fast_consensus
    from fastconsensus_tpu_torch.utils.env import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fast_consensus(np.array([[0, 1], [1, 2]]), 3, n_p=2)


def _builders():
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.utils import prng

    edges = np.array([[0, 1], [1, 2]])
    z = np.zeros(4)
    return {
        "pack_edges": lambda **d: pack_edges(edges, 3, **d).src,
        "prng.key": lambda **d: prng.key(3, **d),
        "prng.wrap_key_data": lambda **d: prng.wrap_key_data([0, 3], **d),
        "slab_from_arrays": lambda **d: interop.slab_from_arrays(
            z, z, z, z, n_nodes=3, **d).src,
        "key_from_data": lambda **d: interop.key_from_data([0, 3], **d),
        "labels_from_numpy": lambda **d: interop.labels_from_numpy(z, **d),
    }


@pytest.mark.parametrize("name", sorted(_builders()))
def test_builders_default_to_cuda(name):
    """Every function that puts state on a device puts it on the card
    unless the caller names another device, and never falls back."""
    build = _builders()[name]
    assert build(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


def test_package_imports_neither_jax_nor_the_reference():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fastconsensus_tpu'] = None\n"
        "import fastconsensus_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for path in (REPO / "fastconsensus_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "fastconsensus_tpu." not in text, path
        assert "import jax" not in text, path
