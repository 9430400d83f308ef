"""Checks that need the card: each CUDA kernel against its plain version,
and a consensus run on the GPU against the same run on the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports neither JAX nor the reference package, so it also runs on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from fastconsensus_tpu_torch.ops import row_kernels as rk

pytestmark = pytest.mark.cuda

SENT = rk.SENTINEL


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def random_rows(rng, n, d, n_labels):
    lab = rng.integers(0, n_labels, (n, d)).astype(np.int32)
    lab[rng.random((n, d)) < 0.25] = SENT
    w = rng.integers(1, 9, (n, d)).astype(np.float32)
    w[lab == SENT] = 0.0
    return lab, w


CUT = rk.FLAT_MAX_D


def edge_rows(lab, w):
    """Rows 0-3 as the regimes' edge cases: only SENTINEL, one repeated
    label, labels near the top of int32, and labels that differ only
    above bit 25 (one group of the sorted rows' 32-bit keys)."""
    d = lab.shape[1]
    lab[0], w[0] = SENT, 0.0
    lab[1], w[1] = 7, np.arange(1, d + 1) % 5 + 1
    lab[2] = 2 ** 31 - 2 - np.arange(d) % 3
    lab[2, ::4] = SENT
    w[2] = np.where(lab[2] == SENT, 0.0, 3.0)
    lab[3] = 5 + (np.arange(d) * 7 % 4) * 2 ** 25
    lab[3, 1::5] = SENT
    w[3] = np.where(lab[3] == SENT, 0.0, np.arange(d) % 3 + 1)


# widths on both sides of 32 lanes, of the flat chunks (9 and 17 slots)
# and of the flat/sorted cut-over, the main path's widths (9, 17, 25);
# at least 514 random rows, a count that leaves the last flat tile (64 to
# 256 rows) or sort block of 8 rows ragged at every width here that has
# more than one row in a block
@pytest.mark.parametrize("d", [1, 2, 9, 10, 17, 25, 31, 32, 33, CUT - 1, CUT,
                               CUT + 1, 128, 1025])
def test_row_totals_kernel_matches_plain(card, d):
    n = max(514, 2 * max(1, 4096 // d) + 3)
    lab, w = random_rows(np.random.default_rng(d), n, d, d // 3 + 2)
    edge_rows(lab, w)
    lab_c, w_c = torch.as_tensor(lab, device=card), torch.as_tensor(
        w, device=card)
    rk.reset_launches()
    total, head = rk.row_totals(lab_c, w_c)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["row_totals"] == 1
    assert rk.ROW_TOTALS_SHAPES == {(n, d): 1}
    p_total, p_head = rk.row_totals_plain(lab_c, w_c)
    assert torch.equal(total, p_total) and torch.equal(head, p_head)
    # views that start off a 16-byte boundary
    total, head = rk.row_totals(lab_c[1:], w_c[1:])
    assert torch.equal(total, p_total[1:]) and torch.equal(head, p_head[1:])


def test_row_totals_kernel_refuses_rows_past_sort_max(card):
    lab = torch.full((2, 2049), 3, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="CUDA error"):
        rk.row_totals(lab, torch.ones(lab.shape, device=card))


@pytest.mark.parametrize("d", [17, CUT, CUT + 1, 1025])
def test_row_totals_kernel_is_deterministic_fold(card, d):
    """Non-integer weights: every launch gives the same bits, those of the
    left fold in ascending slot order, in both regimes."""
    rng = np.random.default_rng(100 + d)
    lab, w = random_rows(rng, 3 * max(1, 4096 // d) + 1, d, d // 3 + 2)
    w = np.where(lab == SENT, 0.0, rng.random(lab.shape) * 3).astype(
        np.float32)
    lab_c, w_c = torch.as_tensor(lab, device=card), torch.as_tensor(
        w, device=card)
    first, _ = rk.row_totals(lab_c, w_c)
    again, _ = rk.row_totals(lab_c, w_c)
    assert torch.equal(first, again)
    assert torch.equal(first, rk.row_totals_fold(lab_c, w_c))


@pytest.mark.parametrize("d_self", [8, 20, CUT - 1, CUT, 200])
@pytest.mark.parametrize("seed", range(3))
def test_fused_move_rows_kernel_matches_plain(card, seed, d_self):
    rng = np.random.default_rng(seed)
    n = 500
    d = d_self + 1
    lab = rng.integers(0, 40, (n, d)).astype(np.int32)
    lab[rng.random((n, d)) < 0.3] = SENT
    lab[:, d_self] = rng.integers(0, 40, n)
    w = rng.integers(1, 9, (n, d)).astype(np.float32)
    w[lab == SENT] = 0.0
    w[:, d_self] = 0.0
    m2 = np.float32(rng.integers(1000, 200000))
    strength = rng.integers(1, 60, n).astype(np.float32)
    scal = np.zeros((n, 8), np.float32)
    scal[:, 0], scal[:, 1] = strength, strength / m2
    scal[:, 2], scal[:, 3] = np.float32(0.25) / m2, np.float32(0.5) / m2
    scal[:, 4], scal[:, 5] = float(rng.integers(0, 1 << 24)), np.arange(n)
    sig = rng.integers(0, 3000, (n, d)).astype(np.float32)
    args = [torch.as_tensor(a, device=card) for a in (lab, w, sig, scal)]
    best, want = rk.fused_move_rows(*args, d_self)
    p_best, p_want = rk.fused_move_rows_plain(*args, d_self)
    assert torch.equal(best, p_best) and torch.equal(want, p_want)
    assert 0 < int(want.sum()) < n


def lpm_rows(device, graph):
    """Dense rows the LPM vote gives ``row_totals`` ([M * N, D + 1] with
    the own-label slot), from two members' labels after three votes:
    the emailEu stand-in's rows (D = 177) or lfr10k's (D = 657)."""
    from pathlib import Path

    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.models import lpm
    from fastconsensus_tpu_torch.ops import dense_adj as da
    from fastconsensus_tpu_torch.utils import prng, synth

    if graph == "emaileu":
        sizes = synth.heterogeneous_sizes(1005, 42, 0.85)
        edges, _ = synth.planted_partition(1005, 42, 0.6, 0.02, seed=42,
                                           sizes=sizes)
        n = 1005
    else:
        z = np.load(Path(__file__).resolve().parent.parent / "bench_data" /
                    "lfr10k.npz")
        edges, n = z["edges"], 10_000
    slab = pack_edges(edges, n, device=device)
    keys = prng.partition_keys(prng.key(3, device), 2)
    labels = lpm.lpm_members(lpm.Prepared(slab), keys, max_iters=3)
    adj = da.build_dense_adjacency(slab)
    lab = torch.where(adj.valid, da.row_gather(labels, adj.nbr), SENT)
    lab = torch.cat([lab, labels[:, :, None]], dim=2).to(torch.int32)
    w = torch.cat([torch.where(adj.valid, adj.w, 0.0),
                   adj.w.new_zeros((n, 1))], dim=1).expand(2, n, -1)
    d1 = slab.d_cap + 1
    return lab.reshape(2 * n, d1).contiguous(), \
        w.reshape(2 * n, d1).contiguous()


@pytest.mark.parametrize("graph,d", [("emaileu", 177), ("lfr10k", 657)])
def test_row_totals_kernel_on_lpm_rows(card, graph, d):
    """The sorted regime at the LPM paths' widths, on real vote rows."""
    lab, w = lpm_rows(card, graph)
    assert lab.shape[1] == d
    total, head = rk.row_totals_cuda(lab, w)
    torch.cuda.synchronize()
    p_total, p_head = rk.row_totals_plain(lab, w)
    assert torch.equal(total, p_total) and torch.equal(head, p_head)


@pytest.mark.parametrize("alg", ["lpm", "leiden"])
def test_lpm_and_leiden_on_card_equal_cpu(card, alg):
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.models.registry import get_detector

    rng = np.random.default_rng(6)
    n = 1500
    truth = rng.integers(0, 10, n)
    src, dst = rng.integers(0, n, (2, 30000))
    keep = (truth[src] == truth[dst]) | (rng.random(30000) < 0.03)
    edges = np.stack([src[keep], dst[keep]], 1)
    cfg = ConsensusConfig(algorithm=alg, n_p=4, max_rounds=2, seed=5,
                          tau={"lpm": 0.8, "leiden": 0.2}[alg])
    runs = []
    for dev in ("cpu", card):
        rk.reset_launches()
        runs.append(run_consensus(pack_edges(edges, n, device=dev),
                                  get_detector(alg), cfg))
    assert rk.LAUNCHES["row_totals"] > 0
    cpu, gpu = runs
    np.testing.assert_array_equal(np.stack(gpu.partitions),
                                  np.stack(cpu.partitions))
    assert [h["n_unconverged"] for h in gpu.history] == \
        [h["n_unconverged"] for h in cpu.history]


@pytest.mark.parametrize("path", ["hybrid", "dense"])
def test_consensus_on_card_equals_cpu(card, monkeypatch, path):
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.models.registry import get_detector

    rng = np.random.default_rng(4)
    n = 1500
    truth = rng.integers(0, 10, n)
    src, dst = rng.integers(0, n, (2, 40000))
    keep = (truth[src] == truth[dst]) | (rng.random(40000) < 0.05)
    hubs = np.repeat(rng.choice(n, 5, replace=False), 300)
    edges = np.concatenate([np.stack([src[keep], dst[keep]], 1),
                            np.stack([hubs, rng.integers(0, n, 1500)], 1)])
    monkeypatch.setenv("FCTPU_MOVE_PATH", path)
    cfg = ConsensusConfig(n_p=4, max_rounds=3, seed=5)
    runs = []
    for dev in ("cpu", card):
        rk.reset_launches()
        runs.append(run_consensus(pack_edges(edges, n, device=dev),
                                  get_detector("louvain"), cfg))
    assert rk.LAUNCHES["row_totals"] > 0
    cpu, gpu = runs
    np.testing.assert_array_equal(np.stack(gpu.partitions),
                                  np.stack(cpu.partitions))
    for a, b in zip(gpu.history, cpu.history):
        assert a["n_unconverged"] == b["n_unconverged"]
        assert a["n_alive"] == b["n_alive"]


def test_mesh_on_card_equals_unsharded_run(card, monkeypatch):
    """A (p=1, e=2) mesh listing the card twice (and, on a machine with
    two or more GPUs, (1, k) and (2, k // 2) meshes over distinct
    ordinals) against the unsharded scatter run: the shards' kernels
    launch on their tensors' device."""
    from fastconsensus_tpu_torch import parallel
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.models.registry import get_detector

    edges, n = _planted(7)
    monkeypatch.setenv("FCTPU_MOVE_PATH", "hybrid")
    cfg = ConsensusConfig(n_p=4, max_rounds=3, seed=5,
                          closure_sampler="scatter")
    det = get_detector("louvain")
    base = run_consensus(pack_edges(edges, n, device=card), det, cfg)
    meshes = [parallel.make_mesh(1, 2, devices=[torch.device("cuda", 0)] * 2)]
    k = torch.cuda.device_count()
    if k >= 2:
        # distinct ordinals: the (2, k // 2) mesh's second ensemble shard
        # detects on a card that is not the current device
        meshes += [parallel.make_mesh(1, k), parallel.make_mesh(2, k // 2)]
    for mesh in meshes:
        rk.reset_launches()
        res = run_consensus(pack_edges(edges, n, device=card), det, cfg,
                            mesh=mesh)
        assert rk.LAUNCHES["row_totals"] > 0
        assert res.rounds == base.rounds
        np.testing.assert_array_equal(np.stack(res.partitions),
                                      np.stack(base.partitions))
        c = base.graph.capacity
        for name in ("src", "dst", "weight", "alive"):
            assert torch.equal(getattr(res.graph, name)[:c].cpu(),
                               getattr(base.graph, name).cpu())


def _planted(seed, n=1500, m=30000, p_out=0.03):
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 10, n)
    src, dst = rng.integers(0, n, (2, m))
    keep = (truth[src] == truth[dst]) | (rng.random(m) < p_out)
    return np.stack([src[keep], dst[keep]], 1), n


def test_scatter_sampler_on_card_equals_cpu(card):
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.ops import consensus_ops as cops
    from fastconsensus_tpu_torch.utils import prng

    edges, n = _planted(7)
    got = []
    for dev in ("cpu", card):
        slab = pack_edges(edges, n, device=dev)
        got.append(cops.sample_wedges_scatter(prng.key(3, dev), slab, 7001))
    for a, b in zip(*got):
        assert b.device.type == "cuda"
        assert torch.equal(a, b.cpu())
    assert int(got[0][2].sum()) > 0


@pytest.mark.parametrize("alg", ["cnm", "infomap"])
def test_host_detectors_on_card_equal_cpu(card, alg):
    """The host C++ detectors take a slab on the card and put the labels
    back there; whole runs (the tail on each device) are identical."""
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.utils import prng

    edges, n = _planted(8)
    det = get_detector(alg)
    keys = prng.partition_keys(prng.key(1, card), 4)
    labels = det(pack_edges(edges, n, device=card), keys)
    assert labels.device.type == "cuda" and labels.dtype == torch.int64
    assert torch.equal(labels.cpu(), det(pack_edges(edges, n, device="cpu"),
                                         keys.cpu()))
    cfg = ConsensusConfig(algorithm=alg, n_p=4, max_rounds=2, seed=5,
                          delta=0.0, tau={"cnm": 0.7, "infomap": 0.6}[alg])
    cpu, gpu = (run_consensus(pack_edges(edges, n, device=dev), det, cfg)
                for dev in ("cpu", card))
    np.testing.assert_array_equal(np.stack(gpu.partitions),
                                  np.stack(cpu.partitions))
    assert [h["n_alive"] for h in gpu.history] == \
        [h["n_alive"] for h in cpu.history]


def test_checkpoint_written_on_card_resumes_on_cpu(card, tmp_path):
    """A run checkpointed on the card resumes on the CPU to the same
    partitions as the uninterrupted card run (and the file holds int32
    indices whatever device wrote it)."""
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.models.registry import get_detector

    edges, n = _planted(9)
    cfg = dict(n_p=4, tau=0.2, delta=0.0, seed=2)
    full = run_consensus(pack_edges(edges, n, device=card),
                         get_detector("louvain"),
                         ConsensusConfig(max_rounds=3, **cfg))
    path = str(tmp_path / "ck.npz")
    run_consensus(pack_edges(edges, n, device=card), get_detector("louvain"),
                  ConsensusConfig(max_rounds=1, **cfg), checkpoint_path=path)
    with np.load(path) as z:
        assert z["src"].dtype == np.int32 and z["labels"].dtype == np.int32
    resumed = run_consensus(pack_edges(edges, n, device="cpu"),
                            get_detector("louvain"),
                            ConsensusConfig(max_rounds=3, **cfg),
                            checkpoint_path=path, resume=True)
    np.testing.assert_array_equal(np.stack(resumed.partitions),
                                  np.stack(full.partitions))
    assert [h["n_alive"] for h in resumed.history] == \
        [h["n_alive"] for h in full.history]


def test_batch_on_card_equals_solo_card_runs(card):
    """A B = 2 batch of two bucketed graphs (the hash sweep: 1,536-node
    bucket) on the card: each job equals its solo card run, history and
    final slab included."""
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus,
                                                   run_consensus_batch)
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.serve import bucketer
    from fastconsensus_tpu_torch.utils import prng

    padded = [bucketer.pad_to_bucket(*_planted(s, n=1100, m=9000),
                                     device=card) for s in (10, 11)]
    assert len({b.key() for _, b in padded}) == 1
    slabs, nc = [s for s, _ in padded], padded[0][1].n_closure
    det = get_detector("louvain")
    cfg = ConsensusConfig(n_p=4, tau=0.2, delta=0.02, max_rounds=4)
    res = run_consensus_batch(slabs, det, cfg, n_closure=nc, seeds=[3, 4])
    assert res.splits == {}
    for i, (slab, seed) in enumerate(zip(slabs, (3, 4))):
        solo = run_consensus(slab, det, cfg, key=prng.key(seed, card),
                             n_closure=nc)
        assert res[i].history == solo.history
        np.testing.assert_array_equal(np.stack(res[i].partitions),
                                      np.stack(solo.partitions))
        for f in ("src", "dst", "weight", "alive"):
            assert torch.equal(getattr(res[i].graph, f),
                               getattr(solo.graph, f))


def test_incremental_run_on_card_equals_cpu(card):
    """``run_consensus(init_labels=, active_mask=)`` on the card and on the
    CPU: identical partitions and integer history, frozen vertices at
    their parent labels."""
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.serve import delta
    from fastconsensus_tpu_torch.serve.jobs import canonical_edges

    edges, n = _planted(12)
    u, v, _ = canonical_edges(edges, n)
    cfg = ConsensusConfig(n_p=4, tau=0.2, delta=0.02, max_rounds=3, seed=6)
    det = get_detector("louvain")
    parent = run_consensus(pack_edges(np.stack([u, v], 1), n, device=card),
                           det, cfg)
    adds = delta.parse_edge_pairs([[0, 700], [5, 900]], "adds", n)
    removes = np.stack([u[:2], v[:2]], 1)
    cu, cv, _ = delta.apply_delta(u, v, None, n, adds, removes)
    active = delta.neighborhood_mask(cu, cv, n, adds, removes)
    init = np.stack(parent.partitions)
    runs = [run_consensus(pack_edges(np.stack([cu, cv], 1), n, device=dev),
                          det, cfg, init_labels=init, active_mask=active)
            for dev in ("cpu", card)]
    np.testing.assert_array_equal(np.stack(runs[1].partitions),
                                  np.stack(runs[0].partitions))
    ints = [k for k in runs[0].history[0] if k not in
            ("agreement", "modularity_mean", "modularity_by_member")]
    assert [[h[k] for k in ints] for h in runs[1].history] == \
        [[h[k] for k in ints] for h in runs[0].history]
    assert 0 < active.sum() < n
    for i, p in enumerate(runs[1].partitions):
        np.testing.assert_array_equal(p[~active], init[i][~active])


def test_device_memory_reads_the_allocator(card):
    """obs.counters.device_memory on the card: torch.cuda.memory_stats'
    keys with the reference's three headline keys taken from them."""
    from fastconsensus_tpu_torch.obs import counters

    keep = torch.empty(1 << 20, dtype=torch.uint8, device=card)
    stats = counters.device_memory()
    raw = torch.cuda.memory_stats(card)
    assert stats["bytes_in_use"] == raw["allocated_bytes.all.current"] > 0
    assert stats["peak_bytes_in_use"] == raw["allocated_bytes.all.peak"]
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
    assert stats["bytes_limit"] == torch.cuda.mem_get_info(card)[1]
    assert set(raw) - set(stats) <= {k for k, v in raw.items()
                                     if not isinstance(v, (int, float))}
    del keep


def test_profiler_session_sees_a_row_totals_launch(card, tmp_path):
    """A ProfilerSession around one row_totals launch yields a trace with
    a device track, in which the kernel appears under its own symbol."""
    from fastconsensus_tpu_torch.obs import device

    lab, w = random_rows(np.random.default_rng(9), 4096, 17, 5)
    lab, w = torch.as_tensor(lab, device=card), torch.as_tensor(w,
                                                                device=card)
    rk.row_totals_cuda(lab, w)               # loaded before the session
    torch.cuda.synchronize()
    with device.ProfilerSession(str(tmp_path), card) as sess:
        rk.row_totals_cuda(lab, w)
        torch.cuda.synchronize()
    assert sess.trace_path is not None
    events = device.load_trace_events(sess.trace_path)
    assert device._has_device_track(events)
    assert any(e.get("cat") == "kernel" and "row_totals" in e["name"]
               for e in events)


def test_service_on_card_equals_cpu_service(card):
    """The serving tier on the card: a solo job and a coalesced two-job
    batch through ``ConsensusService(device="cuda")`` give the CPU
    service's results (same buckets, partitions, rounds)."""
    from collections import deque

    from fastconsensus_tpu_torch.consensus import ConsensusConfig
    from fastconsensus_tpu_torch.serve.jobs import Job, JobSpec
    from fastconsensus_tpu_torch.serve.server import (ConsensusService,
                                                      ServeConfig)

    def ring(n, chords, shift):
        idx = np.arange(n)
        c = np.arange(chords)
        return np.concatenate([np.stack([idx, (idx + 1) % n], 1),
                               np.stack([c % n, (c + shift) % n], 1)])

    graphs = [(ring(34, 40, 7), 34), (ring(40, 38, 5), 40)]
    specs = [JobSpec(edges=e, n_nodes=n, config=ConsensusConfig(
        n_p=4, max_rounds=4, seed=20 + i))
        for i, (e, n) in enumerate(graphs)]
    out = {}
    for dev in ("cpu", "cuda"):
        svc = ConsensusService(ServeConfig(device=dev, pin_sizing=False,
                                           max_batch=2))
        solo = svc.run_spec(specs[0])
        svc.cache._entries.clear()
        jobs = [Job(s) for s in specs]
        svc._drain_group(deque(jobs))
        assert all(j.state == "done" for j in jobs), [j.error for j in jobs]
        assert [j.batch_size for j in jobs] == [2, 2]
        out[dev] = [solo] + [j.result for j in jobs]
    for c, g in zip(out["cpu"], out["cuda"]):
        assert (g["bucket"], g["rounds"], g["converged"]) == \
            (c["bucket"], c["rounds"], c["converged"])
        np.testing.assert_array_equal(np.stack(g["partitions"]),
                                      np.stack(c["partitions"]))
    np.testing.assert_array_equal(np.stack(out["cuda"][0]["partitions"]),
                                  np.stack(out["cuda"][1]["partitions"]))


def test_huge_tier_on_distinct_gpus_equals_the_unsharded_run(card):
    """The huge tier on real ordinals: a service over every GPU with all
    but the first as the mesh group serves a graph past the ceiling on
    the group (edge-sharded across distinct cards) and a small one on
    the chip worker, each equal to its unsharded run on the card.  Needs
    two or more GPUs: one card cannot hold the tier beside a serving
    card (the pool refuses it)."""
    import time

    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.serve import bucketer
    from fastconsensus_tpu_torch.serve.jobs import JobSpec
    from fastconsensus_tpu_torch.serve.server import (ConsensusService,
                                                      ServeConfig)

    k = torch.cuda.device_count()
    if k < 2:
        with pytest.raises(ValueError, match="must leave at least one "
                                             "serving chip"):
            ConsensusService(ServeConfig(
                pin_sizing=False, huge_devices=1,
                chip_max_edges=96)).start()
        pytest.skip("the huge tier on distinct GPUs needs two or more")
    edges, n = _planted(9, n=600, m=6000)
    small = np.stack([np.arange(30), (np.arange(30) + 1) % 30], 1)
    # the mesh path samples wedges with the scatter sampler: so does
    # the unsharded run it is held to
    cfg = ConsensusConfig(n_p=4, max_rounds=3, seed=2,
                          closure_sampler="scatter")
    svc = ConsensusService(ServeConfig(pin_sizing=False, devices=k,
                                       huge_devices=k - 1,
                                       chip_max_edges=96)).start()
    try:
        jobs = [svc.submit(JobSpec(edges=e, n_nodes=m, config=cfg))
                for e, m in ((edges, n), (small, 30))]
        deadline = time.monotonic() + 300
        while any(j.state not in ("done", "failed") for j in jobs):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert [j.state for j in jobs] == ["done", "done"], \
            [j.error for j in jobs]
        assert [j.result["tier"] for j in jobs] == ["mesh", "chip"]
        assert svc.pool.mesh_workers[0].mesh.shape == {"p": 1, "e": k - 1}
    finally:
        assert svc.drain(120)
    for job, (e, m) in zip(jobs, ((edges, n), (small, 30))):
        slab, bucket = bucketer.pad_to_bucket(e, m, device=card)
        ref = run_consensus(slab, get_detector("louvain"), cfg,
                            n_closure=bucket.n_closure)
        assert job.result["rounds"] == ref.rounds
        for served, raw in zip(job.result["partitions"], ref.partitions):
            _, c = np.unique(np.asarray(raw)[:m], return_inverse=True)
            np.testing.assert_array_equal(served, c.astype(np.int32))


def test_two_replica_fleet_on_card_serves_the_bucketed_run(card, tmp_path):
    """Two ``python -m fastconsensus_tpu_torch.serve`` replicas sharing the
    card behind the fleet router: karate through the router equals the
    library's bucketed run on the card (``pad_to_bucket`` +
    ``run_consensus``), and each replica serves on CUDA."""
    import os
    import threading

    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.serve import bucketer
    from fastconsensus_tpu_torch.serve.client import ServeClient
    from fastconsensus_tpu_torch.serve.fleet import FleetManager
    from fastconsensus_tpu_torch.utils.io import read_edgelist

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    edges, _, ids = read_edgelist(os.path.join(repo, "examples",
                                               "karate_club.txt"))
    fleet = FleetManager(str(tmp_path / "fleet"), cache_spill_s=None,
                         replica_args=("--max-batch", "4"))
    try:
        spawns = [threading.Thread(target=fleet.spawn, args=(n,), kwargs={
            "env_extra": {"PYTHONPATH": repo}}) for n in ("r0", "r1")]
        for t in spawns:
            t.start()
        for t in spawns:
            t.join(timeout=300)
        assert sorted(fleet.replicas) == ["r0", "r1"]
        client = ServeClient(fleet.start_router(), timeout=60.0)
        res = client.run(edges.tolist(), n_nodes=len(ids), algorithm="louvain",
                         n_p=4, tau=0.2, delta=0.02, max_rounds=8, seed=0,
                         timeout=300)
        # the allocator block is reported only by a worker on CUDA
        mem = [s.get("memory") for r in fleet.replicas.values()
               for s in ServeClient(r.base_url).metricsz()["devices"]
               .values()]
    finally:
        codes = fleet.stop_all(graceful=True)
    assert codes == {"r0": 0, "r1": 0}
    assert all(m is not None and m["bytes_limit"] > 0 for m in mem), mem
    slab, bucket = bucketer.pad_to_bucket(edges, len(ids), device="cuda")
    lib = run_consensus(slab, get_detector("louvain"), ConsensusConfig(
        n_p=4, tau=0.2, delta=0.02, max_rounds=8, seed=0),
        n_closure=bucket.n_closure)
    want = [np.unique(np.asarray(p)[:len(ids)], return_inverse=True)[1]
            for p in lib.partitions]
    assert res["rounds"] == lib.rounds
    np.testing.assert_array_equal(np.asarray(res["partitions"]),
                                  np.stack(want))


def test_footprint_model_bounds_a_detect_call_on_card(card):
    """The footprint model (a) of one ``detect`` at a small bucket on
    hybrid rows is at least the peak the card allocates for it over the
    baseline taken before its arguments (and at most twice it)."""
    import dataclasses

    from fastconsensus_tpu_torch.analysis import entrypoints as ep
    from fastconsensus_tpu_torch.graph import (derive_agg_sizing,
                                               derive_dense_sizing,
                                               derive_hybrid_sizing)
    from fastconsensus_tpu_torch.models.louvain import make_louvain
    from fastconsensus_tpu_torch.serve import bucketer
    from fastconsensus_tpu_torch.utils import prng
    from fastconsensus_tpu_torch.utils.synth import planted_partition

    rng = np.random.default_rng(5)
    edges, _ = planted_partition(3000, 30, 0.03, 0.0005, seed=5)
    hubs = [(h, v) for h in range(6)
            for v in rng.choice(np.arange(6, 3000), 700, replace=False)]
    host, bucket = bucketer.pad_to_bucket(
        np.concatenate([edges, hubs]), 3000, device="cpu")
    deg = host.degrees().numpy()
    alive = int(host.num_alive())
    d_hyb, hub_cap = derive_hybrid_sizing(deg, host.n_nodes, alive)
    host = host.with_statics(d_cap=derive_dense_sizing(deg, host.n_nodes),
                             d_hyb=d_hyb, hub_cap=hub_cap,
                             agg_cap=derive_agg_sizing(alive))
    assert ep.path_of(host) == "hybrid"
    n_p = 8
    det = make_louvain(max_sweeps=4).warm_variant
    keys = prng.partition_keys(prng.key(3, card), n_p)
    sing = torch.arange(host.n_nodes).expand(n_p, host.n_nodes).clone()

    def args():
        slab = dataclasses.replace(host, **{
            f: getattr(host, f).to(card)
            for f in ("src", "dst", "weight", "alive")})
        return slab, sing.to(card)

    slab, init = args()
    det(slab, keys, init)             # warm-up: builds, cuBLAS, caches
    del slab, init
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    slab, init = args()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = det(slab, keys, init)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    model = ep.slab_peak_bytes("detect", slab, n_p=n_p)["peak"]
    assert out.shape == (n_p, host.n_nodes)
    assert peak <= model <= 2 * peak, (peak, model)


def test_captured_if_nodes_replay_as_eager(card):
    """ops/capture.py's conditional nodes: a captured step with nested
    device-side branches and a row_totals launch, replayed, computes
    what the same step computes eagerly (branches selected), and the
    replayed launches reach the counters."""
    from fastconsensus_tpu_torch.ops import capture

    rng = np.random.default_rng(2)
    lab, w = random_rows(rng, 600, 17, 6)
    lab, w = torch.as_tensor(lab, device=card), torch.as_tensor(w,
                                                                device=card)
    pred = torch.zeros((), dtype=torch.bool, device=card)
    inner = torch.zeros((), dtype=torch.bool, device=card)
    out = torch.zeros(600, 17, device=card)
    count = torch.zeros((), dtype=torch.int64, device=card)

    def step():
        def body():
            total, _ = rk.row_totals(lab, w)
            c = count.clone()
            capture.when(inner, lambda: [c + 10], [c])
            return [out + total, c + 1]
        capture.when(pred, body, [out, count])

    def eager(p, q):
        out.zero_()
        count.zero_()
        pred.fill_(p)
        inner.fill_(q)
        step()
        return out.clone(), int(count)

    want = {(p, q): eager(p, q) for p in (False, True) for q in (False, True)}
    rk.reset_launches()
    graph = capture.CapturedStep(step, card)
    try:
        assert rk.LAUNCHES["row_totals"] == 0    # a capture launches nothing
        for (p, q), (w_out, w_count) in want.items():
            out.zero_()
            count.zero_()
            pred.fill_(p)
            inner.fill_(q)
            graph.replay()
            assert torch.equal(out, w_out) and int(count) == w_count
        rk.fold_device_counts(card, rk.device_counts(card).cpu().numpy())
        assert rk.LAUNCHES["row_totals"] == 2     # the two replays with pred
        assert rk.ROW_TOTALS_SHAPES[(600, 17)] == 2
    finally:
        graph.close()


@pytest.mark.parametrize("what", ["sync", "item", "to_host", "python"])
def test_failed_capture_raises_and_leaves_the_card_usable(card, what):
    """A host read, a device synchronize or a Python error inside a
    captured IF body raises (no fallback), and the card stays usable: a
    device synchronize and a later capture work, and the capture's guard
    on ``torch.cuda.synchronize`` is gone once it ends."""
    from fastconsensus_tpu_torch.ops import capture

    sync = torch.cuda.synchronize
    x = torch.zeros(4, device=card)
    pred = torch.ones((), dtype=torch.bool, device=card)

    def bad():
        def inner():
            if what == "sync":
                torch.cuda.synchronize()
            elif what == "item":
                bool(x.sum() > 0)
            elif what == "to_host":
                x.cpu()
            else:
                raise ValueError("an error in the body")
            return [x + 1]

        capture.when(pred, lambda: (capture.when(pred, inner, [x]),
                                    [x + 2])[1], [x])

    with pytest.raises((capture.CaptureError, ValueError)):
        capture.CapturedStep(bad, card)
    assert torch.cuda.synchronize is sync
    torch.cuda.synchronize()
    good = capture.CapturedStep(
        lambda: capture.when(pred, lambda: [x + 1], [x]), card)
    try:
        x.zero_()
        good.replay()
        good.replay()
        assert x.tolist() == [2.0] * 4
    finally:
        good.close()


@pytest.mark.parametrize("alg,path", [("louvain", "hybrid"), ("lpm", "dense")])
def test_fused_block_on_card_equals_eager_rounds(card, monkeypatch, alg,
                                                 path):
    """The fused round block (captured once, replayed a round at a time)
    against one round a host step on the card, exactly, and against the
    block on the CPU (partitions and integer history); row_totals
    launched at the same widths as many times."""
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.utils.synth import planted_partition

    edges, _ = planted_partition(1500, 10, 0.03, 0.002, seed=4)
    monkeypatch.setenv("FCTPU_MOVE_PATH", path)
    cfg = ConsensusConfig(algorithm=alg, n_p=4, max_rounds=4, seed=5,
                          tau=0.2 if alg == "louvain" else 0.8)
    runs, widths = {}, {}
    for dev, block in ((card, "8"), (card, "1"), ("cpu", "8")):
        monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", block)
        rk.reset_launches()
        runs[(str(dev), block)] = run_consensus(
            pack_edges(edges, 1500, device=dev), get_detector(alg), cfg)
        widths[(str(dev), block)] = {
            d: sum(c for (_, dd), c in rk.ROW_TOTALS_SHAPES.items()
                   if dd == d) for (_, d) in rk.ROW_TOTALS_SHAPES}
    fused, single, cpu = (runs[(str(card), "8")], runs[(str(card), "1")],
                          runs[("cpu", "8")])
    assert fused.history == single.history
    np.testing.assert_array_equal(np.stack(fused.partitions),
                                  np.stack(single.partitions))
    for f in ("src", "dst", "weight", "alive"):
        assert torch.equal(getattr(fused.graph, f), getattr(single.graph, f))
    assert widths[(str(card), "8")] == widths[(str(card), "1")]
    assert sum(widths[(str(card), "8")].values()) > 0
    np.testing.assert_array_equal(np.stack(fused.partitions),
                                  np.stack(cpu.partitions))
    ints = ("n_alive", "n_unconverged", "n_closure_added", "n_repaired",
            "capacity", "labels_changed", "cold")
    assert [[h[k] for k in ints] for h in fused.history] == \
        [[h[k] for k in ints] for h in cpu.history]


@pytest.mark.parametrize("alg", ["louvain", "leiden"])
def test_batch_block_on_card_equals_batched_rounds(card, monkeypatch, alg):
    """The batched block (one graph captured for the run) against one
    batched round a host step on the card, exactly, splits included,
    and against the blocked batch on the CPU (partitions and integer
    history); row_totals launched at the same widths as many times."""
    import dataclasses

    from fastconsensus_tpu_torch import engine
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus_batch)
    from fastconsensus_tpu_torch.graph import (derive_agg_sizing,
                                               hub_cap_for, pack_edges)
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.utils.synth import planted_partition

    packs = [pack_edges(planted_partition(1500, 10, 0.03, 0.002, seed=s)[0],
                        1500, device="cpu") for s in (4, 5, 6)]
    cap = 3 * max(int(p.num_alive()) for p in packs)
    statics = dict(d_cap=0, cap_hint=cap, d_hyb=max(p.d_hyb for p in packs),
                   hub_cap=hub_cap_for(2 * cap),
                   agg_cap=derive_agg_sizing(cap))

    def slabs(dev):
        return [dataclasses.replace(p, **{f: torch.cat([
            getattr(p, f), getattr(p, f).new_zeros(cap - p.capacity)]).to(
                dev) for f in ("src", "dst", "weight", "alive")}, **statics)
            for p in packs]

    monkeypatch.setenv("FCTPU_MOVE_PATH", "hybrid")
    cfg = ConsensusConfig(algorithm=alg, n_p=4, max_rounds=4, delta=0.0)
    captures = []
    capture = engine.BatchBlock._capture

    def counted(self):
        captures.append(self)
        capture(self)

    monkeypatch.setattr(engine.BatchBlock, "_capture", counted)
    runs, widths = {}, {}
    for dev, block in ((card, "8"), (card, "1"), ("cpu", "8")):
        monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", block)
        rk.reset_launches()
        runs[(str(dev), block)] = run_consensus_batch(
            slabs(dev), get_detector(alg), cfg,
            n_closure=max(int(p.num_alive()) for p in packs),
            seeds=[1, 2, 3])
        widths[(str(dev), block)] = {
            d: sum(c for (_, dd), c in rk.ROW_TOTALS_SHAPES.items()
                   if dd == d) for (_, d) in rk.ROW_TOTALS_SHAPES}
    fused, single, cpu = (runs[(str(card), "8")], runs[(str(card), "1")],
                          runs[("cpu", "8")])
    assert len(captures) == 1
    assert fused.splits == single.splits == cpu.splits
    for a, b, c in zip(fused, single, cpu):
        assert a.history == b.history
        np.testing.assert_array_equal(np.stack(a.partitions),
                                      np.stack(b.partitions))
        np.testing.assert_array_equal(np.stack(a.partitions),
                                      np.stack(c.partitions))
        for f in ("src", "dst", "weight", "alive"):
            assert torch.equal(getattr(a.graph, f), getattr(b.graph, f))
    assert widths[(str(card), "8")] == widths[(str(card), "1")]
    assert sum(widths[(str(card), "8")].values()) > 0


def test_staging_exemption_admits_only_registered_buffers(card):
    """A captured step may copy into a pinned staging buffer it registers
    (``capture.stage_to_host``); the copy replays as a copy node.  Any
    other copy to the host, into another pinned buffer or a slice of a
    registered one, still raises ``CaptureError``, and the card stays
    usable after."""
    from fastconsensus_tpu_torch.ops import capture

    d = torch.arange(8, device=card)
    staged = torch.zeros(8, dtype=torch.int64, pin_memory=True)
    other = torch.zeros(8, dtype=torch.int64, pin_memory=True)
    step = capture.CapturedStep(lambda: capture.stage_to_host(staged, d * 2),
                                card)
    try:
        assert staged.tolist() == [0] * 8          # the capture ran nothing
        step.replay()
        torch.cuda.synchronize()
        assert staged.tolist() == list(range(0, 16, 2))
    finally:
        step.close()
    for bad in (lambda: other.copy_(d, non_blocking=True),
                lambda: (capture.stage_to_host(staged, d),
                         staged[:4].copy_(d[:4], non_blocking=True)),
                lambda: d.cpu()):
        with pytest.raises(capture.CaptureError, match="host read"):
            capture.CapturedStep(bad, card)
    torch.cuda.synchronize()


def test_host_node_replays_the_c_function(card):
    """A host node (``capture.host_node``) runs ``fc_host_detect`` at
    every replay, in stream order between the staging copies and the
    copy back: one captured CNM detection of two jobs, the second
    frozen, against the detector run eagerly."""
    import dataclasses

    from fastconsensus_tpu_torch.engine import HostDetect
    from fastconsensus_tpu_torch.graph import pack_edges, unstack_slab
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.ops import capture
    from fastconsensus_tpu_torch.utils import prng
    from fastconsensus_tpu_torch.utils.synth import planted_partition

    edges, _ = planted_partition(300, 6, 0.3, 0.01, seed=2)
    slab = pack_edges(edges, 300, device=card)
    det = get_detector("cnm")
    fields = [getattr(slab, f).unsqueeze(0).repeat(2, 1).contiguous()
              for f in ("src", "dst", "weight", "alive")]
    stacked = dataclasses.replace(slab, src=fields[0], dst=fields[1],
                                  weight=fields[2], alive=fields[3])
    host = HostDetect(det, [unstack_slab(stacked, j) for j in range(2)],
                      fields, 4)
    keys = prng.partition_keys(prng.key(7, card), 8)
    runs = torch.tensor([True, False], device=card)
    step = capture.CapturedStep(lambda: host(keys, runs), card)
    try:
        assert host.calls == 0
        step.replay()
        torch.cuda.synchronize()
        assert host.calls == 1 and host.args.detections == 1
        assert torch.equal(host.labels[0], det(slab, keys[:4]))
        assert not host.labels[1].any()
        runs.fill_(False)
        step.replay()
        torch.cuda.synchronize()
        assert host.calls == 1
    finally:
        step.close()
        host.close()
    with pytest.raises(RuntimeError, match="after close"):
        host(keys, runs)


@pytest.mark.parametrize("alg", ["cnm", "infomap"])
def test_captured_host_detector_block_equals_eager_rounds(card, monkeypatch,
                                                          alg):
    """CNM and Infomap in the fused round block on the card (the host
    C++ as a host node of the captured round) against one round a host
    step on the card, exactly, and against the block on the CPU
    (partitions and integer history); one capture, one host-node
    detection a round."""
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.obs import counters
    from fastconsensus_tpu_torch.utils.synth import planted_partition

    edges, _ = planted_partition(800, 16, 0.2, 0.01, seed=3)
    cfg = ConsensusConfig(algorithm=alg, n_p=4, max_rounds=4, delta=0.0,
                          tau=0.7 if alg == "cnm" else 0.6, seed=1)
    reg = counters.get_registry()
    runs, since = {}, {}
    for dev, block in ((card, "8"), (card, "1"), ("cpu", "8")):
        monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", block)
        base = reg.counters()
        runs[(str(dev), block)] = run_consensus(
            pack_edges(edges, 800, device=dev), get_detector(alg), cfg)
        since[(str(dev), block)] = reg.counters_since(base)
    fused, single, cpu = (runs[(str(card), "8")], runs[(str(card), "1")],
                          runs[("cpu", "8")])
    on_card = since[(str(card), "8")]
    assert on_card.get("engine.setup_executables", 0) == 1
    assert on_card.get("engine.host_detect.calls", 0) == fused.rounds
    assert fused.history == single.history
    np.testing.assert_array_equal(np.stack(fused.partitions),
                                  np.stack(single.partitions))
    for f in ("src", "dst", "weight", "alive"):
        assert torch.equal(getattr(fused.graph, f), getattr(single.graph, f))
    np.testing.assert_array_equal(np.stack(fused.partitions),
                                  np.stack(cpu.partitions))
    ints = ("n_alive", "n_unconverged", "n_closure_added", "n_repaired",
            "capacity", "labels_changed", "cold")
    assert [[h[k] for k in ints] for h in fused.history] == \
        [[h[k] for k in ints] for h in cpu.history]


def test_first_cublas_call_of_a_process_may_be_captured(card):
    """A capture may hold the process's first matrix product (a batched
    block without warm start captures before any eager round): the step
    makes cuBLAS's handle before it captures."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import torch\n"
        "from fastconsensus_tpu_torch.ops import capture\n"
        "dev = torch.device('cuda', 0)\n"
        "a = torch.ones(64, 64, device=dev)\n"
        "out = torch.zeros(64, 64, device=dev)\n"
        "s = capture.CapturedStep(lambda: torch.matmul(a, a, out=out), dev)\n"
        "s.replay()\n"
        "torch.cuda.synchronize()\n"
        "print(float(out[0, 0]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "64.0"
