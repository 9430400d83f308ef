"""The port's elastic recovery against the JAX package, on the CPU: the
persisted detect chunks (``engine._detect_chunked``), the run fingerprint
and adopted chunk sizing (``sizing.json``), and a run that fails inside a
round and restarts from its checkpoint and chunk cache."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from fastconsensus_tpu.consensus import ConsensusConfig as JConfig
from fastconsensus_tpu.consensus import _detect_chunked as j_detect_chunked
from fastconsensus_tpu.consensus import run_consensus as jrun
from fastconsensus_tpu.graph import pack_edges as jpack
from fastconsensus_tpu.models.registry import get_detector as jdetector
from fastconsensus_tpu.utils import prng as jprng
from fastconsensus_tpu.utils.io import read_edgelist
from fastconsensus_tpu.utils.synth import planted_partition
from fastconsensus_tpu_torch import sizing
from fastconsensus_tpu_torch.consensus import ConsensusConfig, run_consensus
from fastconsensus_tpu_torch.engine import _detect_chunked
from fastconsensus_tpu_torch.graph import pack_edges
from fastconsensus_tpu_torch.models.registry import get_detector
from fastconsensus_tpu_torch.obs import get_registry
from fastconsensus_tpu_torch.utils import prng

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

KARATE = os.path.join(os.path.dirname(__file__), "..", "examples",
                      "karate_club.txt")
INT_KEYS = ("round", "n_alive", "n_unconverged", "n_closure_added",
            "n_repaired", "n_dropped", "cold", "capacity", "labels_changed",
            "labels_changed_by_member")


@pytest.fixture(autouse=True)
def _small_cpu_runs(monkeypatch):
    """One round per host step in the reference."""
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "1")
    monkeypatch.delenv("FCTPU_DETECT_CALL_MEMBERS", raising=False)


def planted80():
    edges, _ = planted_partition(80, 4, 0.5, 0.05, seed=2)
    return edges, 80


def test_detect_chunk_cache_resume(tmp_path):
    """The reference's case on the port: chunks persisted by an
    interrupted call are read back (a poisoned chunk proves the cache
    path), the others identical."""
    edges, n = planted80()
    slab = pack_edges(edges, n, device="cpu")
    det = get_detector("lpm")
    keys = prng.partition_keys(prng.key(5, "cpu"), 9)
    d = str(tmp_path)
    a = _detect_chunked(det, slab, keys, 4, cache_dir=d, cache_tag="t")
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["t_c0.npy", "t_c1.npy", "t_c2.npy"], files
    poisoned = np.load(tmp_path / "t_c1.npy")
    np.save(tmp_path / "t_c1", poisoned * 0 + 7)
    b = _detect_chunked(det, slab, keys, 4, cache_dir=d, cache_tag="t")
    assert a.shape == b.shape == (9, n) and b.dtype == torch.int64
    assert torch.equal(b[4:8], torch.full((4, n), 7))
    assert torch.equal(a[:4], b[:4]) and torch.equal(a[8:], b[8:])
    # a chunk of another shape is refused with the reference's message
    np.save(tmp_path / "t_c2", poisoned[:3])
    with pytest.raises(ValueError, match="stale detect-chunk cache .*"
                                         "expected \\(4, 80\\) int32"):
        _detect_chunked(det, slab, keys, 4, cache_dir=d, cache_tag="t")


def test_chunk_files_bit_equal_to_reference(tmp_path):
    """Same keys, same chunk files: LPM on the planted 80-node graph, 9
    keys in chunks of 4, the last chunk padded with the last key's rows."""
    edges, n = planted80()
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    port = _detect_chunked(get_detector("lpm"),
                           pack_edges(edges, n, device="cpu"),
                           prng.partition_keys(prng.key(5, "cpu"), 9), 4,
                           cache_dir=str(tmp_path / "port"), cache_tag="t")
    ref = j_detect_chunked(jdetector("lpm"), jpack(edges, n),
                           jprng.partition_keys(jax.random.key(5), 9), 4,
                           cache_dir=str(tmp_path / "ref"), cache_tag="t")
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    for i in range(3):
        a = np.load(tmp_path / "port" / f"t_c{i}.npy")
        b = np.load(tmp_path / "ref" / f"t_c{i}.npy")
        assert a.dtype == b.dtype == np.int32 and a.shape == (4, n)
        np.testing.assert_array_equal(a, b)
    last = np.load(tmp_path / "port" / "t_c2.npy")
    assert (last == last[0]).all()      # rows 8, 8, 8, 8


def test_no_cache_calls_the_detector_once_a_round():
    """Without a cache dir the driver calls the detector as before: one
    call a round and one final call, no chunk loop."""
    edges, n = planted80()
    base = get_detector("lpm")
    calls = []

    def det(slab, keys, init=None):
        calls.append(keys.shape[0])
        return base(slab, keys, init)

    det.supports_init = True
    res = run_consensus(pack_edges(edges, n, device="cpu"), det,
                        ConsensusConfig(algorithm="lpm", n_p=6, tau=0.5,
                                        delta=0.0, max_rounds=2, seed=3))
    assert calls == [6] * (res.rounds + 1)


def _karate():
    edges, _, ids = read_edgelist(KARATE)
    return edges, len(ids)


def test_fingerprint_and_sizing_file_match_reference(tmp_path, monkeypatch):
    """The reference's run_consensus(detect_cache_dir=) on karate writes a
    ``sizing.json`` whose run fingerprint the port's run writes too;
    pinned chunking gives the same chunk file names; both runs give the
    same partitions and history."""
    monkeypatch.setenv("FCTPU_DETECT_CALL_MEMBERS", "3")
    edges, n = _karate()
    kw = dict(algorithm="louvain", n_p=6, tau=0.2, delta=0.02,
              max_rounds=2, seed=0)
    ref = jrun(jpack(edges, n), jdetector("louvain"), JConfig(**kw),
               detect_cache_dir=str(tmp_path / "ref"))
    port = run_consensus(pack_edges(edges, n, device="cpu"),
                         get_detector("louvain"), ConsensusConfig(**kw),
                         detect_cache_dir=str(tmp_path / "port"))
    a = json.loads((tmp_path / "port" / "sizing.json").read_text())
    b = json.loads((tmp_path / "ref" / "sizing.json").read_text())
    assert a == b == sizing.read_sizing(str(tmp_path / "port"))
    assert a["members"] == 3
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert len([x for x in names if x.endswith(".npy")]) == \
        2 * (port.rounds + 1)
    np.testing.assert_array_equal(np.stack(port.partitions),
                                  np.stack(ref.partitions))
    assert [[h[k] for k in INT_KEYS] for h in port.history] == \
        [[h[k] for k in INT_KEYS] for h in ref.history]


def test_restart_adopts_the_recorded_chunking(tmp_path, monkeypatch):
    """A restart reuses the chunking the killed run recorded in
    ``sizing.json`` (its own sizing would pick whole-ensemble calls on
    this small graph), so it writes no new chunk files."""
    edges, n = planted80()
    cfg = ConsensusConfig(algorithm="lpm", n_p=8, tau=0.5, delta=0.0,
                          max_rounds=2, seed=3)
    cache = tmp_path / "cache"
    monkeypatch.setenv("FCTPU_DETECT_CALL_MEMBERS", "4")
    first = run_consensus(pack_edges(edges, n, device="cpu"),
                          get_detector("lpm"), cfg,
                          detect_cache_dir=str(cache))
    files = sorted(p.name for p in cache.iterdir())
    assert any(f.endswith("_c1.npy") for f in files)
    monkeypatch.delenv("FCTPU_DETECT_CALL_MEMBERS")
    reg = get_registry()
    reg.reset()
    again = run_consensus(pack_edges(edges, n, device="cpu"),
                          get_detector("lpm"), cfg,
                          detect_cache_dir=str(cache))
    assert sorted(p.name for p in cache.iterdir()) == files
    assert reg.counters().get("detect.chunks", 0) == 0
    assert reg.counters()["detect.chunks_cached"] == \
        2 * (first.rounds + 1)
    np.testing.assert_array_equal(np.stack(first.partitions),
                                  np.stack(again.partitions))


class Crash(RuntimeError):
    pass


@pytest.mark.parametrize("fail_at", [5, 9])
def test_restart_after_a_failure_equals_uninterrupted_and_reference(
        tmp_path, monkeypatch, fail_at):
    """A run that raises after chunk ``k`` of round ``r`` (``fail_at``
    counts chunk calls, 3 a round: round 1 fails after its first chunk,
    round 2 after its second), resumed from its checkpoint and chunk
    cache, equals an uninterrupted run and the reference's run: the
    partitions and history; the resumed process reads the chunks the
    failed one finished."""
    monkeypatch.setenv("FCTPU_DETECT_CALL_MEMBERS", "2")
    edges, n = planted80()
    kw = dict(algorithm="lpm", n_p=6, tau=0.5, delta=0.0, max_rounds=3,
              seed=3)
    cfg = ConsensusConfig(**kw)
    base = get_detector("lpm")
    calls = []

    def flaky(slab, keys, init=None):
        calls.append(1)
        if len(calls) == fail_at:
            raise Crash(f"chunk call {fail_at}")
        return base(slab, keys, init)

    flaky.supports_init = True
    flaky.member_bytes = base.member_bytes
    ck, cache = str(tmp_path / "ck.npz"), str(tmp_path / "cache")
    with pytest.raises(Crash):
        run_consensus(pack_edges(edges, n, device="cpu"), flaky, cfg,
                      checkpoint_path=ck, resume=True,
                      detect_cache_dir=cache)
    reg = get_registry()
    reg.reset()
    resumed = run_consensus(pack_edges(edges, n, device="cpu"), base, cfg,
                            checkpoint_path=ck, resume=True,
                            detect_cache_dir=cache)
    assert reg.counters()["detect.chunks_cached"] == (fail_at - 1) % 3
    assert reg.counters()["rounds.total"] == resumed.rounds
    whole = run_consensus(pack_edges(edges, n, device="cpu"), base, cfg)
    ref = jrun(jpack(edges, n), jdetector("lpm"), JConfig(**kw))
    for other in (whole, ref):
        assert resumed.rounds == other.rounds
        np.testing.assert_array_equal(np.stack(resumed.partitions),
                                      np.stack(other.partitions))
        assert [[h[k] for k in INT_KEYS] for h in resumed.history] == \
            [[h[k] for k in INT_KEYS] for h in other.history]
