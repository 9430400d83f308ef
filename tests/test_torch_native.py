"""The port's host C++ (its own copy of the detectors and the edgelist
parser) against the JAX package's build of the same sources, on the CPU.

Both packages hand the C++ the same alive edges and the same 64-bit member
seeds, so CNM and Infomap labels must be identical, and the detectors
returned by the registries must give identical ensembles from the same
keys.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fastconsensus_tpu import native as jnative
from fastconsensus_tpu.graph import pack_edges as jpack
from fastconsensus_tpu.models import cnm as jcnm_mod
from fastconsensus_tpu.models.registry import get_detector as jdetector
from fastconsensus_tpu.utils.synth import planted_partition
from fastconsensus_tpu_torch import interop, native
from fastconsensus_tpu_torch.models import cnm as tcnm_mod
from fastconsensus_tpu_torch.models import registry
from fastconsensus_tpu_torch.models.registry import get_detector
from fastconsensus_tpu_torch.utils import io

REPO = Path(__file__).resolve().parent.parent
KARATE = REPO / "examples" / "karate_club.txt"


def graph(name, karate_edges):
    if name == "karate":
        edges, _, ids = karate_edges
        return edges, len(ids)
    edges, _ = planted_partition(300, 6, 0.3, 0.01, seed=2)
    return edges, 300


def test_port_builds_its_own_sources():
    assert native.SRC_DIR == REPO / "fastconsensus_tpu_torch" / "native" / \
        "src"
    for name in native.SOURCES + native.HEADERS:
        assert (native.SRC_DIR / name).read_bytes() == \
            (REPO / "fastconsensus_tpu" / "native" / "src" /
             name).read_bytes(), name
    assert native.available()
    assert native.lib_path().parent == REPO / "fastconsensus_tpu_torch" / \
        "_build"
    assert native.lib_path().exists()


@pytest.mark.parametrize("fn", ["cnm_labels", "infomap_labels"])
@pytest.mark.parametrize("name", ["karate", "planted"])
def test_host_labels_match_reference(karate_edges, fn, name):
    edges, n = graph(name, karate_edges)
    seeds = np.array([0, 7, 2 ** 40 + 3, 2 ** 63 + 11], dtype=np.uint64)
    w = np.random.default_rng(0).integers(1, 5, edges.shape[0]).astype(
        np.float32)
    for weight in (None, w):
        got = getattr(native, fn)(edges[:, 0], edges[:, 1], weight, n, seeds)
        want = getattr(jnative, fn)(edges[:, 0], edges[:, 1], weight, n,
                                    seeds)
        assert got.dtype == np.int32 and got.shape == (4, n)
        np.testing.assert_array_equal(got, want)


def test_seed_words_match_reference():
    """Each member's 64-bit seed from its key's uint32 words: the port's
    int64-held words against the reference's callback inputs, with high
    bits set in both words."""
    keys = jax.random.split(jax.random.key(12345), 64)
    words = np.asarray(jcnm_mod._seeds_from_keys(keys)).astype(np.uint64)
    want = (words[:, 0] << np.uint64(32)) | words[:, -1]
    tkeys = interop.key_from_data(np.asarray(jax.random.key_data(keys)),
                                  device="cpu")
    got = tcnm_mod.seeds_from_keys(tkeys)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    assert (got >= np.uint64(2 ** 63)).any() and (words[:, 1] >=
                                                   2 ** 31).any()


@pytest.mark.parametrize("alg", ["cnm", "infomap"])
@pytest.mark.parametrize("name", ["karate", "planted"])
def test_detector_matches_reference(karate_edges, alg, name):
    """The registry detector on a slab (dead slots, closure-added edges,
    count weights) against the reference's ``pure_callback`` detector."""
    edges, n = graph(name, karate_edges)
    js = jpack(edges, n)
    rng = np.random.default_rng(4)
    alive = np.asarray(js.alive) & (rng.random(js.capacity) < 0.9)
    weight = np.where(alive, rng.integers(1, 9, js.capacity), 0).astype(
        np.float32)
    js = js.with_weights(jax.numpy.asarray(weight),
                         alive=jax.numpy.asarray(alive))
    keys = jax.random.split(jax.random.key(3), 6)
    want = np.asarray(jax.jit(jdetector(alg))(js, keys))
    ts = interop.slab_from_arrays(
        np.asarray(js.src), np.asarray(js.dst), weight, alive, n_nodes=n,
        device="cpu")
    tkeys = interop.key_from_data(np.asarray(jax.random.key_data(keys)),
                                  device="cpu")
    got = get_detector(alg)(ts, tkeys)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # initial labels are ignored: the host detectors always start cold
    again = get_detector(alg)(ts, tkeys, torch.zeros_like(got))
    assert torch.equal(again, got)


def test_host_detectors_are_seed_deterministic():
    """Two members with one seed agree, whatever thread runs each."""
    edges, _ = planted_partition(300, 6, 0.3, 0.01, seed=2)
    s = np.array([42] * 9, dtype=np.uint64)
    for fn in (native.cnm_labels, native.infomap_labels):
        out = fn(edges[:, 0], edges[:, 1], None, 300, s)
        assert all(np.array_equal(out[0], row) for row in out[1:])


@pytest.mark.parametrize("text,weighted", [
    ("# comment\n1 2\n2 3 0.5\n\n3 9\n", True),
    ("0 1\n1 2\n", False),
    ("10 20\n20 30\n30 10\n40 10 2.5\n", True),
])
def test_parse_edgelist_agrees_with_python_reader(tmp_path, text, weighted):
    path = tmp_path / "g.txt"
    path.write_text(text)
    u, v, w = native.parse_edgelist(str(path))
    ju, jv, jw = jnative.parse_edgelist(str(path))
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(v, jv)
    assert (w is None) == (jw is None) == (not weighted)
    if weighted:
        np.testing.assert_array_equal(w, jw)
    assert native.loaded()   # so read_edgelist takes the native parser
    fast = io.read_edgelist(str(path))
    slow = io.read_edgelist_python(str(path))
    for a, b in zip(fast, slow):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_parse_edgelist_on_karate_and_rejects(tmp_path):
    edges, weights, ids = io.read_edgelist(str(KARATE))
    assert edges.shape == (78, 2) and weights is None and len(ids) == 34
    u, v, _ = native.parse_edgelist(str(KARATE))
    np.testing.assert_array_equal(np.stack([u, v], 1), ids[edges])
    bad = tmp_path / "bad.txt"
    bad.write_text("0 1\n2\n")
    with pytest.raises(ValueError):
        native.parse_edgelist(str(bad))
    # the Python reader re-reads what the fast parser rejects and names
    # the line
    with pytest.raises(ValueError, match=":2:"):
        io.read_edgelist(str(bad))


@pytest.fixture
def broken_build(tmp_path, monkeypatch):
    """Point the native build at a compiler that fails with a message."""
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'fake-cxx: sources refused' >&2\n"
                    "exit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.reset()
    yield
    monkeypatch.undo()
    native.reset()


def test_build_failure_raises_with_compiler_error(broken_build):
    assert not native.available()
    with pytest.raises(native.NativeBuildError, match="sources refused"):
        native.cnm_labels([0], [1], None, 2, [1])
    registry._get_cached.cache_clear()
    with pytest.raises(NotImplementedError, match="exit 3"):
        get_detector("infomap")
    # the edgelist reader does not need the library
    edges, _, _ = io.read_edgelist(str(KARATE))
    assert edges.shape == (78, 2)


def test_reading_an_edgelist_builds_nothing(tmp_path, monkeypatch):
    """A device-only run reads its input without a host compiler: the
    reader uses the native parser only once a host detector loaded it."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.reset()
    try:
        edges, _, ids = io.read_edgelist(str(KARATE))
        assert not native.loaded() and not (tmp_path / "build").exists()
        assert edges.shape == (78, 2) and len(ids) == 34
    finally:
        monkeypatch.undo()
        native.reset()


def test_build_key_covers_sources_compiler_and_flags(monkeypatch):
    base = native.lib_path()
    monkeypatch.setattr(native, "CXX", "clang++")
    assert native.lib_path() != base
    monkeypatch.undo()
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-g"])
    assert native.lib_path() != base
    assert native.lib_path().name.startswith("libfcnative_")


def test_host_labels_validate_edges_before_the_call():
    with pytest.raises(ValueError, match="outside 0..2"):
        native.cnm_labels([0, 5], [1, 2], None, 3, [1])
    with pytest.raises(ValueError, match="equal-length"):
        native.infomap_labels([0, 1], [1], None, 3, [1])
    out = native.cnm_labels(np.zeros(0), np.zeros(0), None, 3, [1, 2])
    assert out.shape == (2, 3)
