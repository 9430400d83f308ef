"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as a release check runs it

Phases (any failure exits non-zero without the final line):

1. build     compile both CUDA kernels (one nvcc per source, in parallel)
             and the host C++; time the native and the Python edgelist
             readers on lfr100k written as text
2. kernels   each kernel against its plain PyTorch version on the card,
             bit for bit, and timed (CUDA events, median of 25 runs);
             row_totals at the lfr100k shape, the run's later widths 9
             and 25, two wide shapes and the widths around its
             flat/sorted cut-over, and with non-integer weights against
             the left fold in slot order (two launches)
3. karate    the port's CLI on the karate club graph with --alg louvain
             (matmul sweep path), leiden and lpm: 20 valid partitions each
4. gpu_cpu   one planted 5k-node graph through the hybrid path on the card
             and on the CPU with louvain and leiden, and through the
             sorted-run vote (d_cap 0) with lpm; louvain with the scatter
             wedge sampler; cnm and infomap (n_p=8, at most 2 rounds,
             delta 0) on the emailEu stand-in: identical partitions and
             integer round histories
5. fused     the opt-in fused dense sweep (FCTPU_FUSED=1) end to end
6. lfr100k   the planted100k stress configuration of bench.py on
             bench_data/lfr100k.npz: louvain, n_p=200, tau=0.2,
             delta=0.02, max_rounds=8, closure_tau=0.2; afterwards
             row_totals at every shape the run launched it at, checked
             as in phase 2 and timed, and the device memory of one group
             of the scatter wedge sampler at its element cap, on the
             slab at the run's largest capacity
7. leiden_lfr10k  bench.py's lfr10k configuration on
             bench_data/lfr10k.npz: leiden, n_p=100, tau=0.2, delta=0.02,
             max_rounds=16 (--leiden-rounds), closure_tau=0.2; per-round
             peak memory and n_agg_overflow; row_totals per shape as in 6
8. lpm_emaileu  bench.py's emailEu stand-in (planted, n 1,005, 42 blocks of
             size_alpha 0.85, p_in 0.6, p_out 0.02, seed 42): lpm, n_p=50,
             tau=0.8, delta=0.02; the dense vote's rows are 177 slots, the
             kernel's sorted regime; row_totals per shape as in 6, and the
             vote's sorted-rank step timed at the run's shape
9. cnm_emaileu  the CLI with --alg cnm (host C++ detection, the tail on
             the card) on the emailEu stand-in: n_p=50, tau=0.7,
             delta=0.02, seed 0; rounds, wall, host C++ seconds and tail
             seconds per round, peak memory, member NMI to the planted
             labels
10. infomap_lfr10k  the same with --alg infomap on bench_data/lfr10k.npz:
             n_p=50, tau=0.6, delta=0.02, max_rounds=8; both cells are
             run once more on the CPU and must give identical partitions,
             round histories and output trees
11. resume   the CLI with --checkpoint/--resume: Louvain, n_p=8, forced
             hybrid rows on gpu_cpu's planted 5k graph; 4 rounds
             uninterrupted against 2 rounds resumed to 4, and against a
             card resume of a checkpoint the CPU wrote: equal partitions,
             histories and output trees
12. delta    fcdelta on bench_data/lfr10k.npz (louvain, n_p=20, tau=0.2,
             delta=0.02, seed 0, at most 16 rounds): a parent run, a child
             graph with a seeded 1% edge delta (serve/delta.py), the
             incremental run from the parent's partitions with the
             vertices outside the delta's neighborhood frozen (at most 4
             rounds), a from-scratch run on the child,
             and the incremental run again on the CPU: identical
             partitions and integer history, frozen vertices at their
             parent labels; row_totals per shape as in 6
13. batch    run_consensus_batch on two batches of B=4 same-bucket jobs
             (louvain, n_p=20, tau=0.2, delta=0.02, closure_tau=0.2, seeds
             11/22/33/44, at most 16 rounds): A, four emailEu stand-ins
             (graph seeds 42-45, the matmul sweep); B, lfr10k and three
             children of seeded 2% edge deltas (the hash sweep); each job
             equal to its solo run on the card; the bucket, batch wall,
             solo walls, peak device memory of the batch and of the
             largest solo run, splits and rounds printed

Kernel launch counters are reset just before phases 5-8, 11, 12 (its
incremental card run) and 13 and read just after: phases 6-8, 11 and 12
must launch ``row_totals``, phase 5 ``fused_move_rows``; phase 13's
bucketed slabs take the matmul and hash sweeps, which launch no kernel
of the port (a job split off to a solo run may).  The second-to-last
lines are the kernels' JSON record and the card's name and power limit;
the last line is the device record.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"
DEVICE = "cuda"

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and FP32
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def reset_peak() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def read_peak():
    """Peak allocated device bytes since :func:`reset_peak` (None off
    the card)."""
    import torch

    return torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None


def median_ms(fn, runs: int = 25) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_FP32_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def planted_graph(n: int, n_comm: int, p_in: float, p_out: float, seed: int,
                  hubs: int = 0, hub_degree: int = 0):
    """Planted-partition (SBM) edges with optional grafted hubs, from a
    seed, in numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    truth = np.sort(rng.integers(0, n_comm, n))
    m_in = int(p_in * sum(int(c) * (int(c) - 1) // 2
                          for c in np.bincount(truth)))
    m_out = int(p_out * n * (n - 1) / 2)
    src, dst = [], []
    starts = np.searchsorted(truth, np.arange(n_comm + 1))
    sizes = np.diff(starts)
    comm = rng.choice(n_comm, m_in, p=sizes * (sizes - 1) /
                      (sizes * (sizes - 1)).sum())
    src.append(starts[comm] + (rng.random(m_in) * sizes[comm]).astype(int))
    dst.append(starts[comm] + (rng.random(m_in) * sizes[comm]).astype(int))
    src.append(rng.integers(0, n, m_out))
    dst.append(rng.integers(0, n, m_out))
    for h in rng.choice(n, hubs, replace=False):
        others = rng.choice(n, hub_degree, replace=False)
        src.append(np.full(hub_degree, h))
        dst.append(others)
    edges = np.stack([np.concatenate(src), np.concatenate(dst)], 1)
    return edges[edges[:, 0] != edges[:, 1]], truth


def random_rows(rng, r: int, d: int):
    """Padded rows on the device: labels in [0, d // 3), a fifth of the
    slots SENTINEL (weight 0), integer weights in [1, 200)."""
    import numpy as np
    import torch

    from fastconsensus_tpu_torch.ops import row_kernels as rk

    lab = rng.integers(0, max(2, d // 3), (r, d)).astype(np.int32)
    lab[rng.random((r, d)) < 0.2] = rk.SENTINEL
    w = rng.integers(1, 200, (r, d)).astype(np.float32)
    w[lab == rk.SENTINEL] = 0.0
    return torch.as_tensor(lab).to(DEVICE), torch.as_tensor(w).to(DEVICE)


def row_totals_bound(r: int, d: int):
    """Least time of row_totals on [r, d]: read lab and w, write total and
    head (13 B a slot); its least work, a sort of each row's labels and a
    sum over its runs, D*log2(D) operations a row."""
    return bound_ms(r * d * 13.0, r * d * math.log2(max(d, 2)))


def check_row_totals(lab, w) -> float:
    """Hold the row_totals kernel on ``lab``, ``w`` bit for bit against
    its plain version, and with non-integer weights against the left fold
    in ascending slot order, the same bits on two launches.  Returns the
    max abs error (0.0); raises PhaseError on any difference."""
    import torch

    from fastconsensus_tpu_torch.ops import row_kernels as rk

    r, d = lab.shape
    t, h = rk.row_totals_cuda(lab, w)
    sync()
    pt, ph = rk.row_totals_plain(lab, w)
    err = float((t - pt).abs().max())
    bad = int((h != ph).sum())
    check(err == 0.0 and bad == 0,
          f"row_totals [{r}, {d}]: max_abs_err {err}, {bad} head mismatches")
    del t, h, pt, ph
    wf = torch.where(lab == rk.SENTINEL, 0.0, w * 0.0137 + 0.3).contiguous()
    f1, _ = rk.row_totals_cuda(lab, wf)
    f2, _ = rk.row_totals_cuda(lab, wf)
    sync()
    check(torch.equal(f1, f2), f"row_totals [{r}, {d}]: two launches differ")
    check(torch.equal(f1, rk.row_totals_fold(lab, wf)),
          f"row_totals [{r}, {d}]: non-integer totals differ from the fold")
    return err


def check_and_time_shapes(shapes, seed: int):
    """``row_totals`` at each shape a run gave it, on random rows (the flat
    regime's work does not depend on the labels; the sorted regime's
    varies little with them): exact against the plain version, and timed;
    time lost there is launches x (ms - bound)."""
    import numpy as np

    from fastconsensus_tpu_torch.ops import row_kernels as rk

    rng = np.random.default_rng(seed)
    per_shape = []
    for (r, d), count in sorted(shapes.items()):
        lab_c, w_c = random_rows(rng, r, d)
        check_row_totals(lab_c, w_c)
        ms = median_ms(lambda: rk.row_totals_cuda(lab_c, w_c))
        plain = median_ms(lambda: rk.row_totals_plain(lab_c, w_c), runs=5)
        b, _ = row_totals_bound(r, d)
        per_shape.append(dict(rows=r, d=d, launches=count, ms=ms,
                              plain_ms=plain, bound_ms=b,
                              lost_ms=count * (ms - b)))
        log(f"  row_totals at [{r}, {d}]: exact; {count} launches, "
            f"{ms:.4f} ms (plain {plain:.3f} ms), bound {b:.4f} ms, lost "
            f"{count * (ms - b):.1f} ms")
        del lab_c, w_c
    return per_shape


# ---------------------------------------------------------------------------

def phase_build(state):
    import numpy as np

    from fastconsensus_tpu_torch import native
    from fastconsensus_tpu_torch.ops import row_kernels as rk
    from fastconsensus_tpu_torch.utils import io

    t0 = time.perf_counter()
    info = rk.build()
    state["build_s"] = time.perf_counter() - t0
    for name, rec in info.items():
        ptx = " | ".join(line.strip() for line in rec["ptxas"].splitlines()
                         if "registers" in line or "spill" in line)
        log(f"build {name}: {rec['seconds']:.2f}s cached={rec['cached']} "
            f"{ptx}")
    log(f"build: {state['build_s']:.2f}s for {len(info)} kernels")
    # the host C++ (CNM, Infomap, the edgelist parser), and the two
    # edgelist readers on the largest graph the phases read, as text
    t0 = time.perf_counter()
    native.load()
    cxx_s = time.perf_counter() - t0
    path = _write_edgelist(np.load(ROOT / "bench_data" / "lfr100k.npz")
                           ["edges"], OUT / "lfr100k.txt")
    t0 = time.perf_counter()
    fast = io.read_edgelist(str(path))
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = io.read_edgelist_python(str(path))
    slow_s = time.perf_counter() - t0
    check(all(np.array_equal(a, b) for a, b in zip(fast, slow)
              if b is not None), "edgelist readers disagree")
    log(f"build: host C++ {cxx_s:.2f}s ({native.lib_path().name}); "
        f"lfr100k as text ({path.stat().st_size} bytes, "
        f"{fast[0].shape[0]} edges): native reader {fast_s:.4f}s, Python "
        f"reader {slow_s:.4f}s, equal; host cores {os.cpu_count()}")


def phase_kernels(state):
    import numpy as np
    import torch

    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.models import louvain as lv
    from fastconsensus_tpu_torch.ops import dense_adj as da
    from fastconsensus_tpu_torch.ops import row_kernels as rk
    from fastconsensus_tpu_torch.sizing import members_per_call
    from fastconsensus_tpu_torch.utils import prng

    rk.reset_launches()
    rows = {}
    rng = np.random.default_rng(0)
    # (width, members, rows per member): the shape the lfr100k main path
    # gives the kernel in its first sweeps (hybrid rows of d_hyb + 1 slots,
    # one member chunk of 100k rows each), the run's later hybrid widths
    # (d_hyb re-derived to 8 and 24) at the row counts it launches them at
    # most, a mid width, and the widest dense row the slab sizing allows
    data = np.load(ROOT / "bench_data" / "lfr100k.npz")
    big = pack_edges(data["edges"], int(data["labels"].shape[0]),
                     device=DEVICE)
    check(lv.select_move_path(big) == "hybrid", "lfr100k is not hybrid")
    main_shape = (big.d_hyb + 1, members_per_call(big, state["n_p"]),
                  big.n_nodes)
    shapes = [main_shape, (9, 4, 100_000), (25, 12, 100_000)]
    shapes += state.get("extra_widths",
                        [(128, 8, 20_000), (1025, 2, 5_000)])
    # the LPM dense vote's sorted-regime widths: the emailEu stand-in's
    # rows (d_cap 176) at n_p 50, and lfr10k's (d_cap 656) for 8 members
    shapes += state.get("lpm_widths", [(177, 50, 1005), (657, 8, 10_000)])
    # the last flat width, the first sorted one and the one before
    cut = rk.FLAT_MAX_D
    shapes += state.get("cut_widths", [(cut - 1, 1, 60_000),
                                       (cut, 1, 60_000),
                                       (cut + 1, 1, 60_000)])
    for d, m, n in shapes:
        lab_c, w_c = random_rows(rng, m * n, d)
        err = check_row_totals(lab_c, w_c)
        r = m * n
        ms = median_ms(lambda: rk.row_totals(lab_c, w_c))
        plain = median_ms(lambda: rk.row_totals_plain(lab_c, w_c),
                          runs=21)
        b, by = row_totals_bound(r, d)
        rows.setdefault("row_totals", []).append(dict(
            d=d, rows=r, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=b, bound_by=by))
        log(f"kernel row_totals [{r}, {d}] "
            f"({'flat' if d <= cut else 'sorted'}): exact, deterministic "
            f"fold; {ms:.4f} ms (plain {plain:.3f} ms, bound {b:.4f} ms by "
            f"{by}, {b / ms:.1%} of it)")
        del lab_c, w_c

    # fused_move_rows on the rows of a real dense-path slab
    edges, _ = planted_graph(5000, 50, 0.2, 0.0005, seed=3)
    slab = pack_edges(edges, 5000, device=DEVICE)
    check(slab.d_cap > 0, "fused check: the slab carries no dense sizing")

    strength = slab.strengths()
    m2 = slab.total_weight().clamp(min=1e-9)
    fused = lv._FusedRows(slab, da.build_dense_adjacency(slab), strength, m2,
                          1.0)
    m = 8
    labels = torch.as_tensor(rng.integers(0, 5000, (m, 5000))).to(DEVICE)
    keys = prng.partition_keys(prng.key(5, DEVICE), m)
    n, d1 = fused.nbr.shape
    lab = torch.where(fused.valid, labels[:, fused.nbr], da.SENTINEL)
    sigma = lv._sigma_tot(strength, labels, n)
    sig = lv._gather_rows(sigma, lab.clamp(0, n - 1))
    scal = fused.scal_base.expand(m, n, 8).clone()
    scal[:, :, 4] = (prng.bits(keys, ()) & 0xFFFFFF).to(torch.float32)[:, None]
    args = (lab.to(torch.int32).view(m * n, d1).contiguous(),
            fused.w.expand(m, n, d1).reshape(m * n, d1),
            sig.reshape(m * n, d1).contiguous(), scal.view(m * n, 8))
    b_k, w_k = rk.fused_move_rows(*args, fused.d_self)
    sync()
    b_p, w_p = rk.fused_move_rows_plain(*args, fused.d_self)
    err = float((b_k - b_p).abs().max())
    bad = int((w_k != w_p).sum())
    check(err == 0.0 and bad == 0,
          f"fused_move_rows: best max_abs_err {err}, {bad} want mismatches")
    check(0 < int(w_k.sum()) < m * n, "fused_move_rows: degenerate wants")
    r = m * n
    ms = median_ms(lambda: rk.fused_move_rows(*args, fused.d_self))
    plain = median_ms(lambda: rk.fused_move_rows_plain(*args, fused.d_self),
                      runs=21)
    # least work: the row totals as above plus ~20 operations a slot for
    # gain, jitter and the masked argmax
    bb, by = bound_ms(r * d1 * 12.0 + r * 32.0 + r * 5.0,
                      r * d1 * (math.log2(d1) + 20.0))
    rows["fused_move_rows"] = [dict(d=d1, rows=r, max_abs_err=err, ms=ms,
                                    plain_ms=plain, bound_ms=bb,
                                    bound_by=by)]
    log(f"kernel fused_move_rows [{r}, {d1}]: exact; {ms:.4f} ms (plain "
        f"{plain:.3f} ms, bound {bb:.4f} ms by {by}, {bb / ms:.1%} of it)")
    state["kernel_rows"] = rows


def _valid_partition_tree(out_dir: Path, n_p: int, n_nodes: int,
                          ids) -> None:
    trees = sorted(p.name for p in out_dir.iterdir())
    part = [t for t in trees if t.startswith("out_partitions_")]
    mem = [t for t in trees if t.startswith("memberships_")]
    check(len(part) == 1 and len(mem) == 1, f"output trees: {trees}")
    for i in range(1, n_p + 1):
        seen = []
        for line in (out_dir / part[0] / str(i)).read_text().splitlines():
            seen.extend(int(x) for x in line.split())
        check(sorted(seen) == sorted(ids),
              f"partition {i} does not cover every node exactly once")
        lines = (out_dir / mem[0] / str(i - 1)).read_text().splitlines()
        check(len(lines) == n_nodes, f"memberships {i - 1}: {len(lines)} lines")


def phase_karate(state):
    import shutil

    from fastconsensus_tpu_torch import cli
    from fastconsensus_tpu_torch.utils.io import read_edgelist

    _, _, ids = read_edgelist(str(ROOT / "examples" / "karate_club.txt"))
    for alg in ("louvain", "leiden", "lpm"):
        out = OUT / "karate" / alg
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        t0 = time.perf_counter()
        rc = cli.main(["-f", str(ROOT / "examples" / "karate_club.txt"),
                       "-np", "20", "--alg", alg, "--out-dir", str(out),
                       "--quiet", "--device", DEVICE])
        check(rc == 0, f"karate CLI --alg {alg} exit {rc}")
        _valid_partition_tree(out, 20, len(ids), [int(x) for x in ids])
        log(f"karate CLI --alg {alg} on {DEVICE}: 20 valid partitions in "
            f"{time.perf_counter() - t0:.2f}s")


def _run(edges, n, device, alg="louvain", no_rows=False, peaks=None,
         run_kw=None, **cfg):
    """One consensus run: ``(result, wall s, per-round s)``.  ``no_rows``
    packs without a row width (d_cap 0); ``peaks`` collects each round's
    peak device memory; ``run_kw`` passes on to ``run_consensus``."""
    import dataclasses

    import torch

    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.models.registry import get_detector

    slab = pack_edges(edges, n, device=device)
    if no_rows:
        slab = dataclasses.replace(slab, d_cap=0)
    stamps = []

    def on_round(entry):
        stamps.append(time.perf_counter())
        if peaks is not None and DEVICE == "cuda":
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()

    if peaks is not None and DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    res = run_consensus(slab, get_detector(alg),
                        ConsensusConfig(algorithm=alg, **cfg),
                        on_round=on_round, **(run_kw or {}))
    sync()
    wall = time.perf_counter() - t0
    per_round = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    return res, wall, per_round


def phase_gpu_cpu(state):
    import numpy as np

    from fastconsensus_tpu_torch.utils.metrics import nmi

    edges, truth = planted_graph(5000, 40, 0.08, 0.0004, seed=7, hubs=10,
                                 hub_degree=600)
    email, email_truth = cell_inputs("cnm_emaileu", state)[:2]
    ints = ("n_alive", "n_unconverged", "n_closure_added", "n_repaired",
            "n_hub_overflow", "n_agg_overflow", "capacity", "labels_changed")
    # (algorithm, graph, how it runs, run settings): louvain and leiden on
    # the forced hybrid path, lpm packed without rows (the sorted-run
    # vote), louvain with the scatter wedge sampler, and the host C++
    # detectors (the tail on each device)
    planted5k = ("5k planted", edges, truth)
    emaileu = ("emailEu stand-in", email, email_truth)
    for alg, (gname, g_edges, g_truth), how, cfg in (
            ("louvain", planted5k, "hybrid",
             dict(n_p=4, tau=0.2, max_rounds=3)),
            ("leiden", planted5k, "hybrid",
             dict(n_p=4, tau=0.2, max_rounds=2)),
            ("lpm", planted5k, "runs", dict(n_p=4, tau=0.8, max_rounds=2)),
            ("louvain", planted5k, "hybrid, scatter sampler",
             dict(n_p=4, tau=0.2, max_rounds=3, closure_sampler="scatter")),
            # delta 0, so that a round with unconverged edges closes
            # triangles (Infomap's first); CNM's members agree at once
            ("cnm", emaileu, "host",
             dict(n_p=8, tau=0.7, max_rounds=2, delta=0.0)),
            ("infomap", emaileu, "host",
             dict(n_p=8, tau=0.6, max_rounds=2, delta=0.0))):
        cfg = dict(dict(delta=0.02, seed=11), **cfg)
        n = int(g_truth.shape[0])
        if how.startswith("hybrid"):
            os.environ["FCTPU_MOVE_PATH"] = "hybrid"
        try:
            g, g_s, _ = _run(g_edges, n, DEVICE, alg, how == "runs", **cfg)
            c, c_s, _ = _run(g_edges, n, "cpu", alg, how == "runs", **cfg)
        finally:
            os.environ.pop("FCTPU_MOVE_PATH", None)
        agree = [nmi(a, b) for a, b in zip(g.partitions, c.partitions)]
        same = [bool(np.array_equal(a, b)) for a, b in
                zip(g.partitions, c.partitions)]
        log(f"gpu vs cpu ({alg}, {gname}, {how}, n_p={cfg['n_p']}, "
            f"delta={cfg['delta']}, {g.rounds} rounds, closure "
            f"{[h['n_closure_added'] for h in g.history]}): per-member NMI "
            f"{[round(a, 6) for a in agree]}, identical {same}; {DEVICE} "
            f"{g_s:.2f}s, cpu {c_s:.2f}s; NMI to truth "
            f"{np.mean([nmi(p, g_truth) for p in g.partitions]):.4f}")
        check(min(agree) >= 0.99,
              f"{alg} gpu/cpu agreement {min(agree)} < 0.99")
        check(all(same), f"{alg} ({how}) gpu/cpu partitions differ")
        check([[h[k] for k in ints] for h in g.history] ==
              [[h[k] for k in ints] for h in c.history],
              f"{alg} gpu/cpu round histories differ")


def phase_fused(state):
    from fastconsensus_tpu_torch.ops import row_kernels as rk
    from fastconsensus_tpu_torch.utils.metrics import nmi

    edges, truth = planted_graph(5000, 50, 0.2, 0.0005, seed=3)
    os.environ["FCTPU_MOVE_PATH"] = "dense"
    os.environ["FCTPU_FUSED"] = "1"
    try:
        rk.reset_launches()
        res, wall, _ = _run(edges, 5000, DEVICE, n_p=8, tau=0.2, delta=0.02,
                            max_rounds=2, seed=2)
        launches = dict(rk.LAUNCHES)
    finally:
        del os.environ["FCTPU_MOVE_PATH"], os.environ["FCTPU_FUSED"]
    q = sum(nmi(p, truth) for p in res.partitions) / len(res.partitions)
    log(f"fused dense path (5k planted, n_p=8, {res.rounds} rounds): "
        f"{wall:.2f}s, NMI to truth {q:.4f}, launches {launches}")
    check(launches["fused_move_rows"] > 0,
          "fused path never launched fused_move_rows")
    state["launches_fused"] = launches


def cell_inputs(name: str, state):
    """``(edges, truth labels, algorithm, run settings)`` of a main-path
    cell: bench.py's planted100k (lfr100k), lfr10k and emailEu configs."""
    import numpy as np

    from fastconsensus_tpu_torch.utils import synth

    if name in ("lpm_emaileu", "cnm_emaileu"):
        sizes = synth.heterogeneous_sizes(1005, 42, 0.85)
        edges, truth = synth.planted_partition(1005, 42, 0.6, 0.02, seed=42,
                                               sizes=sizes)
        if name == "cnm_emaileu":
            return edges, truth, "cnm", dict(
                n_p=state.get("cnm_n_p", 50), tau=0.7, delta=0.02, seed=0,
                max_rounds=64)
        return edges, truth, "lpm", dict(n_p=state.get("lpm_n_p", 50),
                                         tau=0.8, delta=0.02, seed=0)
    data = np.load(ROOT / "bench_data" / f"{name.split('_')[-1]}.npz")
    edges, truth = data["edges"], data["labels"]
    if name == "infomap_lfr10k":
        return edges, truth, "infomap", dict(
            n_p=state.get("infomap_n_p", 50), tau=0.6, delta=0.02, seed=0,
            max_rounds=8)
    if name == "leiden_lfr10k":
        return edges, truth, "leiden", dict(
            n_p=state.get("leiden_n_p", 100), tau=0.2, delta=0.02,
            max_rounds=state["leiden_rounds"], seed=0, closure_tau=0.2)
    if state.get("nodes"):       # rehearsal only: a prefix of the graph
        edges = edges[(edges < state["nodes"]).all(axis=1)]
        truth = truth[:state["nodes"]]
    return edges, truth, "louvain", dict(
        n_p=state["n_p"], tau=0.2, delta=0.02,
        max_rounds=state["max_rounds"], seed=0, closure_tau=0.2)


def phase_lfr100k(state):
    import numpy as np
    import torch

    from fastconsensus_tpu_torch.ops import row_kernels as rk
    from fastconsensus_tpu_torch.utils.metrics import nmi

    edges, truth, _, cfg = cell_inputs("lfr100k", state)
    n = int(truth.shape[0])
    n_p = state["n_p"]
    if n_p != 200:
        log(f"lfr100k: n_p cut 200 -> {n_p} to fit the time limit")
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rk.reset_launches()
    res, wall, per_round = _run(edges, n, DEVICE, **cfg)
    launches = dict(rk.LAUNCHES)
    shapes = dict(rk.ROW_TOTALS_SHAPES)
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
    scores = [nmi(p, truth) for p in res.partitions]
    digest = hashlib.sha1(np.stack(res.partitions).astype(np.int64)
                          .tobytes()).hexdigest()[:16]
    for h in res.history:
        log(f"  round {h['round']}: {h['n_alive']} alive, "
            f"{h['n_unconverged']} unconverged, cold={h['cold']}, "
            f"overflow {h['n_overflow']}/{h['n_hub_overflow']}, capacity "
            f"{h['capacity']}")
    log(f"lfr100k: N={n} E={edges.shape[0]} n_p={n_p} rounds={res.rounds} "
        f"converged={res.converged} wall={wall:.2f}s per_round="
        f"{[round(x, 3) for x in per_round]} nmi_mean={np.mean(scores):.4f} "
        f"nmi_min={min(scores):.4f} max_memory_allocated={peak} "
        f"partitions/s={n_p / wall:.3f} launches={launches} "
        f"row_totals_launches_by_shape={sorted(shapes.items())} "
        f"partitions_sha1={digest}")
    check(launches["row_totals"] > 0, "lfr100k never launched row_totals")
    per_shape = check_and_time_shapes(shapes, seed=1)
    check(len(res.partitions) == n_p and all(
        p.shape == (n,) for p in res.partitions), "partition shapes")
    state.setdefault("main_paths", {})["lfr100k"] = dict(
        launches=launches["row_totals"], by_shape=per_shape)
    state["lfr100k"] = dict(rounds=res.rounds, converged=res.converged,
                            wall_s=wall, per_round_s=per_round,
                            nmi_mean=float(np.mean(scores)),
                            max_memory_allocated=peak)
    if DEVICE == "cuda":
        _scatter_group_peak(edges, n, max(h["capacity"] for h in res.history))


def _scatter_group_peak(edges, n, capacity):
    """Device memory of one group of the scatter wedge sampler at its
    element cap, on lfr100k packed at the run's largest capacity: the
    peak allocated over the resident slab, and the group's time."""
    import torch

    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.ops import consensus_ops as cops
    from fastconsensus_tpu_torch.utils import prng

    slab = pack_edges(edges, n, capacity=capacity, device=DEVICE)
    srcd, dstd, _, ad = slab.directed()
    valid_e = ad & (srcd != dstd)
    group = max(1, cops.SCATTER_GROUP_ELEMS // max(2 * capacity, n + 1))
    key = prng.key(3, device=DEVICE)
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = cops.partner_draw_batches(key, srcd, dstd, valid_e, n, capacity,
                                    group * n)
    sync()
    secs = time.perf_counter() - t0
    extra = torch.cuda.max_memory_allocated() - base
    elems = group * 2 * capacity
    check(out[0].shape == (group * n,), "scatter sampler output shape")
    log(f"scatter sampler at the group cap: lfr100k, capacity {capacity}, "
        f"{group} draws a group = {elems} priority elements "
        f"(cap {cops.SCATTER_GROUP_ELEMS}); peak {extra} bytes over the "
        f"resident slab ({extra / elems:.2f} bytes an element), "
        f"{secs:.4f}s")


def _main_path_run(state, name):
    """Drive one cell's consensus run with the launch counters reset just
    before and read just after; log what a user would see and the
    per-round memory and aggregate overflow; check and time each kernel
    shape."""
    import numpy as np
    import torch

    from fastconsensus_tpu_torch.ops import row_kernels as rk
    from fastconsensus_tpu_torch.utils.metrics import nmi

    edges, truth, alg, cfg = cell_inputs(name, state)
    n = int(truth.shape[0])
    peaks = []
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rk.reset_launches()
    res, wall, per_round = _run(edges, n, DEVICE, alg, peaks=peaks, **cfg)
    launches = dict(rk.LAUNCHES)
    shapes = dict(rk.ROW_TOTALS_SHAPES)
    final_peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" \
        else None
    scores = [nmi(p, truth) for p in res.partitions]
    for i, h in enumerate(res.history):
        log(f"  round {h['round']}: {h['n_alive']} alive, "
            f"{h['n_unconverged']} unconverged, cold={h['cold']}, overflow "
            f"{h['n_overflow']}/{h['n_hub_overflow']}, n_agg_overflow "
            f"{h['n_agg_overflow']}, capacity {h['capacity']}, "
            f"{per_round[i]:.3f}s, max_memory_allocated "
            f"{peaks[i] if i < len(peaks) else None}")
    log(f"{name}: {alg} N={n} E={edges.shape[0]} n_p={cfg['n_p']} "
        f"rounds={res.rounds} converged={res.converged} wall={wall:.2f}s "
        f"per_round={[round(x, 3) for x in per_round]} "
        f"final_detect_s={wall - sum(per_round):.3f} "
        f"nmi_mean={np.mean(scores):.4f} nmi_min={min(scores):.4f} "
        f"max_memory_allocated={max(peaks + [final_peak or 0])} "
        f"launches={launches} "
        f"row_totals_launches_by_shape={sorted(shapes.items())}")
    log(f"{name}: member NMI to the file's labels "
        f"{[round(x, 4) for x in scores]}")
    check(launches["row_totals"] > 0, f"{name} never launched row_totals")
    check(len(res.partitions) == cfg["n_p"] and all(
        p.shape == (n,) and p.min() >= 0 for p in res.partitions),
        f"{name}: partition shapes")
    per_shape = check_and_time_shapes(shapes, seed=2)
    state.setdefault("main_paths", {})[name] = dict(
        launches=launches["row_totals"], by_shape=per_shape)
    return res, wall, shapes


def phase_leiden_lfr10k(state):
    rounds = state["leiden_rounds"]
    if rounds != 16:
        log(f"leiden_lfr10k: max_rounds cut 16 -> {rounds} to fit the time "
            f"limit")
    _main_path_run(state, "leiden_lfr10k")


def phase_lpm_emaileu(state):
    import numpy as np

    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.ops import dense_adj as da

    edges = cell_inputs("lpm_emaileu", state)[0]
    d_cap = pack_edges(edges, 1005, device="cpu").d_cap
    check(d_cap == 176, f"emailEu stand-in d_cap {d_cap}, expected 176")
    _, _, shapes = _main_path_run(state, "lpm_emaileu")
    # the vote's sorted-rank step (the JAX CPU tie-break order) at the
    # run's widest shape, on random rows, beside the kernel there
    r, d = max(shapes, key=lambda rd: rd[0] * rd[1])
    lab, w = random_rows(np.random.default_rng(3), r, d)
    ms = median_ms(lambda: da.sorted_rank(lab))
    kernel_ms = median_ms(lambda: da.row_kernels.row_totals_cuda(lab, w))
    log(f"lpm_emaileu: sorted-rank step at [{r}, {d}]: {ms:.4f} ms "
        f"(row_totals there {kernel_ms:.4f} ms)")
    state["rank_ms"] = dict(rows=r, d=d, ms=ms, row_totals_ms=kernel_ms)


def _write_edgelist(edges, path: Path) -> Path:
    import numpy as np

    np.savetxt(path, np.asarray(edges, dtype=np.int64), fmt="%d")
    return path


def _cli_run(args, alg):
    """The port's CLI on ``args``, as a user runs it, with the consensus
    result it computed captured and two layers timed: the host C++ call of
    each detection (cnm, infomap) and each consensus tail, both
    synchronized.  Returns ``(result, wall s, host s per call, tail s per
    call)``."""
    from fastconsensus_tpu_torch import cli, consensus, engine, native

    host_s, tail_s, results = [], [], []

    def timed(calls, fn):
        def wrapper(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            calls.append(time.perf_counter() - t0)
            return out
        return wrapper

    def capture(fn):
        def wrapper(*a, **k):
            results.append(fn(*a, **k))
            return results[-1]
        return wrapper

    host_fn = {"cnm": "cnm_labels", "infomap": "infomap_labels"}.get(alg)
    saved = [(consensus, "run_consensus"), (engine, "consensus_tail")]
    saved += [(native, host_fn)] if host_fn else []
    saved = [(m, a, getattr(m, a)) for m, a in saved]
    consensus.run_consensus = capture(saved[0][2])
    engine.consensus_tail = timed(tail_s, saved[1][2])
    if host_fn:
        setattr(native, host_fn, timed(host_s, saved[2][2]))
    sync()
    t0 = time.perf_counter()
    try:
        rc = cli.main([str(a) for a in args])
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
    sync()
    wall = time.perf_counter() - t0
    check(rc == 0 and len(results) == 1, f"CLI {args}: exit {rc}")
    return results[0], wall, host_s, tail_s


def _check_same_run(what, a, a_out, b, b_out):
    """Two CLI runs gave equal partitions, integer round histories and
    output trees."""
    import filecmp

    import numpy as np

    ints = ("round", "n_alive", "n_unconverged", "n_closure_added",
            "n_repaired", "n_dropped", "n_hub_overflow", "cold", "capacity",
            "labels_changed")
    check(a.rounds == b.rounds and np.array_equal(
        np.stack(a.partitions), np.stack(b.partitions)),
        f"{what}: partitions differ")
    check([[h[k] for k in ints] for h in a.history] ==
          [[h[k] for k in ints] for h in b.history],
          f"{what}: round histories differ")
    for tree in sorted(p.name for p in a_out.iterdir()):
        files = sorted(q.name for q in (a_out / tree).iterdir())
        _, bad, err = filecmp.cmpfiles(a_out / tree, b_out / tree, files,
                                       shallow=False)
        check(not bad and not err, f"{what}: {tree} differs")


def _host_detector_cell(state, name):
    """One CLI run of a host C++ detector's cell on the card, and the
    same run on the CPU, which must agree with it exactly."""
    import shutil

    import numpy as np
    import torch

    from fastconsensus_tpu_torch.utils.metrics import nmi

    edges, truth, alg, cfg = cell_inputs(name, state)
    out, cpu_out = OUT / name, OUT / f"{name}_cpu"
    for d in (out, cpu_out):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    path = _write_edgelist(edges, OUT / f"{name}.txt")
    ids = np.unique(edges)
    log(f"{name}: graph N={truth.shape[0]} ({ids.size} in the edgelist) "
        f"E={edges.shape[0]}; CLI --alg {alg} -np {cfg['n_p']} -t "
        f"{cfg['tau']} -d {cfg['delta']} --seed {cfg['seed']} --max-rounds "
        f"{cfg['max_rounds']} on {DEVICE}; host cores {os.cpu_count()}")
    args = ["-f", path, "--alg", alg, "-np", cfg["n_p"], "-t", cfg["tau"],
            "-d", cfg["delta"], "--seed", cfg["seed"], "--max-rounds",
            cfg["max_rounds"], "--quiet"]
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res, wall, host_s, tail_s = _cli_run(
        args + ["--out-dir", out, "--device", DEVICE], alg)
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
    cpu_res, cpu_wall, _, _ = _cli_run(
        args + ["--out-dir", cpu_out, "--device", "cpu"], alg)
    _check_same_run(f"{name}: {DEVICE} against the CPU", res, out, cpu_res,
                    cpu_out)
    log(f"{name}: the same run on the CPU ({cpu_wall:.2f}s): identical "
        f"partitions, round histories and output trees")
    _valid_partition_tree(out, cfg["n_p"], ids.size, [int(x) for x in ids])
    # a round that saturates the slab is replayed: detection and tail again
    replays = len(tail_s) - res.rounds
    check(len(host_s) == len(tail_s) + 1 and replays >= 0,
          f"{name}: {len(host_s)} host calls, {len(tail_s)} tails for "
          f"{res.rounds} rounds")
    check(len(res.partitions) == cfg["n_p"] and all(
        p.shape == (ids.size,) and p.min() >= 0 for p in res.partitions),
        f"{name}: partition shapes")
    scores = [nmi(p, truth[ids]) for p in res.partitions]
    for i, h in enumerate(res.history):
        times = (f", host C++ {host_s[i]:.3f}s, tail on {DEVICE} "
                 f"{tail_s[i]:.4f}s" if replays == 0 else "")
        log(f"  round {h['round']}: {h['n_alive']} alive, "
            f"{h['n_unconverged']} unconverged, +{h['n_closure_added']} "
            f"closure, capacity {h['capacity']}{times}")
    log(f"{name}: {alg} rounds={res.rounds} replays={replays} "
        f"converged={res.converged} "
        f"wall={wall:.2f}s host_cxx_s_per_round="
        f"{[round(x, 3) for x in host_s[:-1]]} final_host_cxx_s="
        f"{host_s[-1]:.3f} host_cxx_s_total={sum(host_s):.3f} "
        f"tail_s_per_round={[round(x, 4) for x in tail_s]} "
        f"tail_s_total={sum(tail_s):.4f} max_memory_allocated={peak} "
        f"nmi_mean={np.mean(scores):.4f} nmi_min={min(scores):.4f}")
    check(all(math.isfinite(x) for x in scores), f"{name}: NMI not finite")
    state.setdefault("host_cells", {})[name] = dict(
        rounds=res.rounds, converged=res.converged, wall_s=wall,
        host_s=host_s, tail_s=tail_s, max_memory_allocated=peak,
        nmi_mean=float(np.mean(scores)))


def phase_cnm_emaileu(state):
    _host_detector_cell(state, "cnm_emaileu")


def phase_infomap_lfr10k(state):
    _host_detector_cell(state, "infomap_lfr10k")


def phase_resume(state):
    """``--checkpoint`` / ``--resume`` through the CLI on the card: an
    uninterrupted 4-round run against 2 rounds resumed to 4, and against
    a card resume of the CPU's 2-round checkpoint."""
    import shutil

    from fastconsensus_tpu_torch.ops import row_kernels as rk

    edges, _ = planted_graph(5000, 40, 0.08, 0.0004, seed=7, hubs=10,
                             hub_degree=600)
    base = OUT / "resume"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    path = _write_edgelist(edges, base / "planted5k.txt")
    log(f"resume: 5k planted (E={edges.shape[0]}), louvain, n_p 8, seed 11, "
        f"forced hybrid rows, checkpoint every round")

    def cli(tag, rounds, ck, device=DEVICE, resume=False):
        out = base / tag
        out.mkdir()
        args = ["-f", path, "--alg", "louvain", "-np", 8, "--seed", 11,
                "--max-rounds", rounds, "--checkpoint", base / ck,
                "--out-dir", out, "--quiet", "--device", device]
        res, wall, _, _ = _cli_run(args + (["--resume"] if resume else []),
                                   "louvain")
        log(f"resume: {tag} on {device}: {res.rounds} rounds, "
            f"{wall:.2f}s")
        return res, out

    os.environ["FCTPU_MOVE_PATH"] = "hybrid"
    try:
        rk.reset_launches()
        full, full_out = cli("full", 4, "full.npz")
        cli("first_half", 2, "half.npz")
        resumed, resumed_out = cli("resumed", 4, "half.npz", resume=True)
        launches = dict(rk.LAUNCHES)
        shapes = dict(rk.ROW_TOTALS_SHAPES)
        cli("cpu_half", 2, "cpu.npz", device="cpu")
        rk.reset_launches()
        from_cpu, from_cpu_out = cli("from_cpu", 4, "cpu.npz", resume=True)
        launches_cpu = dict(rk.LAUNCHES)
    finally:
        os.environ.pop("FCTPU_MOVE_PATH", None)
    for tag, res, out in (("resumed", resumed, resumed_out),
                          ("from_cpu", from_cpu, from_cpu_out)):
        _check_same_run(f"resume: {tag} against the uninterrupted run",
                        full, full_out, res, out)
    log(f"resume: uninterrupted {full.rounds} rounds == 2 + resumed == CPU "
        f"2 + card resumed: partitions, histories and output trees equal; "
        f"launches {launches} (from the CPU checkpoint {launches_cpu})")
    check(launches["row_totals"] > 0 and launches_cpu["row_totals"] > 0,
          "resume never launched row_totals")
    per_shape = check_and_time_shapes(shapes, seed=4)
    state.setdefault("main_paths", {})["resume"] = dict(
        launches=launches["row_totals"], by_shape=per_shape)


def _delta_child(u, v, n: int, frac: float, seed: int):
    """A seeded edge delta of ``frac`` of the parent's canonical edges
    (half removed, as many absent pairs added) applied through the port's
    ``serve/delta.py``: ``(child u, child v, adds, removes)``."""
    import numpy as np

    from fastconsensus_tpu_torch.serve import delta

    rng = np.random.default_rng(seed)
    k = int(round(frac / 2 * u.shape[0]))
    gone = rng.choice(u.shape[0], k, replace=False)
    have = set((u * n + v).tolist())
    adds = []
    while len(adds) < k:
        a, b = sorted(int(x) for x in rng.integers(0, n, 2))
        if a != b and a * n + b not in have:
            have.add(a * n + b)
            adds.append([a, b])
    adds, removes = delta.parse_delta(
        {"adds": adds, "removes": np.stack([u[gone], v[gone]], 1).tolist()},
        n)
    cu, cv, _ = delta.apply_delta(u, v, None, n, adds, removes)
    return cu, cv, adds, removes


HISTORY_INTS = ("round", "n_alive", "n_unconverged", "n_closure_added",
                "n_repaired", "n_dropped", "n_overflow", "n_hub_overflow",
                "n_agg_overflow", "cold", "capacity", "n_w_zero", "n_w_full",
                "n_frontier", "labels_changed", "labels_changed_by_member")


def phase_delta(state):
    """fcdelta on lfr10k: a parent run, a child graph with a seeded 1%
    edge delta, and the incremental run from the parent's partitions
    with the vertices outside the delta's neighborhood frozen, against a
    from-scratch run on the child and the incremental run on the CPU."""
    import numpy as np

    from fastconsensus_tpu_torch.ops import row_kernels as rk
    from fastconsensus_tpu_torch.serve import delta
    from fastconsensus_tpu_torch.serve.jobs import canonical_edges
    from fastconsensus_tpu_torch.utils.metrics import nmi

    data = np.load(ROOT / "bench_data" / "lfr10k.npz")
    edges, truth = data["edges"], data["labels"]
    n = int(truth.shape[0])
    # bench.py's lfr10k cell runs at most 16 rounds; the incremental runs
    # stop at delta_rounds: frozen vertices keep the parent members'
    # labels, so the edges among them on which those members disagree
    # never converge (and the CPU rerun sets the budget)
    cfg = dict(n_p=state.get("delta_n_p", 20), tau=0.2, delta=0.02, seed=0,
               max_rounds=16)
    inc_cfg = dict(cfg, max_rounds=state.get("delta_rounds", 4))
    u, v, _ = canonical_edges(edges, n)
    log(f"delta: lfr10k N={n} E={u.shape[0]}, louvain n_p={cfg['n_p']} "
        f"tau 0.2 delta 0.02 seed 0; parent and from-scratch runs up to 16 "
        f"rounds, incremental runs {inc_cfg['max_rounds']}")
    parent, parent_s, _ = _run(np.stack([u, v], 1), n, DEVICE, **cfg)
    cu, cv, adds, removes = _delta_child(u, v, n, 0.01, seed=1)
    active = delta.neighborhood_mask(cu, cv, n, adds, removes)
    init = np.stack(parent.partitions)
    child = np.stack([cu, cv], 1)
    log(f"delta: child E={cu.shape[0]} (-{removes.shape[0]} "
        f"+{adds.shape[0]} edges), active share {active.mean():.4f} "
        f"({int(active.sum())} of {n} vertices)")
    inc_kw = dict(init_labels=init, active_mask=active)
    rk.reset_launches()
    inc, inc_s, _ = _run(child, n, DEVICE, run_kw=inc_kw, **inc_cfg)
    launches = dict(rk.LAUNCHES)
    shapes = dict(rk.ROW_TOTALS_SHAPES)
    full, full_s, _ = _run(child, n, DEVICE, **cfg)
    cpu, cpu_s, _ = _run(child, n, "cpu", run_kw=inc_kw, **inc_cfg)
    check(inc.rounds == cpu.rounds and np.array_equal(
        np.stack(inc.partitions), np.stack(cpu.partitions)),
        f"delta: {DEVICE} and CPU incremental partitions differ")
    check([[h[k] for k in HISTORY_INTS] for h in inc.history] ==
          [[h[k] for k in HISTORY_INTS] for h in cpu.history],
          f"delta: {DEVICE} and CPU incremental histories differ")
    frozen = ~active
    check(all(np.array_equal(p[frozen], init[i][frozen])
              for i, p in enumerate(inc.partitions)),
          "delta: a frozen vertex left its parent label")
    check(not inc.history[0]["cold"], "delta: round 0 ran cold")
    vs_full = [nmi(a, b) for a, b in zip(inc.partitions, full.partitions)]
    to_truth = [float(np.mean([nmi(p, truth) for p in r.partitions]))
                for r in (parent, inc, full)]
    for h in inc.history:
        log(f"  incremental round {h['round']}: {h['n_alive']} alive, "
            f"{h['n_unconverged']} unconverged, frontier {h['n_frontier']}, "
            f"capacity {h['capacity']}")
    runs = (parent, inc, full)
    log(f"delta: converged parent/incremental/from scratch "
        f"{[r.converged for r in runs]}, cold rounds "
        f"{[[h['round'] for h in r.history if h['cold']] for r in runs]}")
    log(f"delta: rounds parent {parent.rounds} / incremental {inc.rounds} / "
        f"from scratch {full.rounds} / CPU incremental {cpu.rounds}; wall "
        f"parent {parent_s:.2f}s, incremental {inc_s:.2f}s, from scratch "
        f"{full_s:.2f}s, CPU incremental {cpu_s:.2f}s; member NMI "
        f"incremental vs from scratch mean {np.mean(vs_full):.4f} min "
        f"{min(vs_full):.4f}; NMI to the file's labels parent/incremental/"
        f"from scratch {[round(x, 4) for x in to_truth]}; card == CPU "
        f"(partitions, integer history); frozen vertices kept their parent "
        f"labels; launches {launches} "
        f"row_totals_launches_by_shape={sorted(shapes.items())}")
    check(launches["row_totals"] > 0, "delta never launched row_totals")
    per_shape = check_and_time_shapes(shapes, seed=5)
    state.setdefault("main_paths", {})["delta"] = dict(
        launches=launches["row_totals"], by_shape=per_shape)


def _batch_graphs(name: str):
    """The four graphs of a batch: ``[(edges, n)]``."""
    import numpy as np

    from fastconsensus_tpu_torch.serve.jobs import canonical_edges
    from fastconsensus_tpu_torch.utils import synth

    if name == "A":
        # bench.py's emailEu stand-in at graph seeds 42-45
        sizes = synth.heterogeneous_sizes(1005, 42, 0.85)
        return [(synth.planted_partition(1005, 42, 0.6, 0.02, seed=s,
                                         sizes=sizes)[0], 1005)
                for s in (42, 43, 44, 45)]
    data = np.load(ROOT / "bench_data" / "lfr10k.npz")
    n = int(data["labels"].shape[0])
    u, v, _ = canonical_edges(data["edges"], n)
    out = [(np.stack([u, v], 1), n)]
    for seed in (1, 2, 3):
        cu, cv, _, _ = _delta_child(u, v, n, 0.02, seed)
        out.append((np.stack([cu, cv], 1), n))
    return out


def _device_busy(fn):
    """``fn()`` under torch.profiler, tracing the card only: ``(wall s,
    device busy s, kernels)``; busy is the union of the kernels'
    intervals (None when the profiler shows no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall, (_busy_us(events) / 1e6 if events else None), len(events)


def _busy_us(events) -> float:
    """Microseconds during which at least one of the kernel ``events``
    ran (the union of their intervals)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def phase_batch(state):
    """``run_consensus_batch``: two batches of four same-bucket jobs (B =
    4, a rung of the batch ladder), each job against the same job run
    alone on the card.  A: four emailEu stand-ins (the matmul sweep);
    B: lfr10k and three children of it (the hash sweep)."""
    import numpy as np
    import torch

    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus,
                                                   run_consensus_batch)
    from fastconsensus_tpu_torch.models.louvain import select_move_path
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.ops import row_kernels as rk
    from fastconsensus_tpu_torch.serve import bucketer
    from fastconsensus_tpu_torch.utils import prng

    seeds = [11, 22, 33, 44]
    cfg = ConsensusConfig(algorithm="louvain",
                          n_p=state.get("batch_n_p", 20), tau=0.2,
                          delta=0.02, closure_tau=0.2,
                          max_rounds=state.get("batch_rounds", 16))
    det = get_detector("louvain")
    check(len(seeds) in bucketer.BATCH_LADDER, "B is not a ladder rung")
    for name in ("A", "B"):
        padded = [bucketer.pad_to_bucket(e, n, device=DEVICE)
                  for e, n in _batch_graphs(name)]
        slabs = [s for s, _ in padded]
        keys = {b.key() for _, b in padded}
        check(len(keys) == 1, f"batch {name}: graphs in buckets {keys}")
        bucket = padded[0][1]
        path = select_move_path(slabs[0])
        rk.reset_launches()
        reset_peak()
        sync()
        t0 = time.perf_counter()
        res = run_consensus_batch(slabs, det, cfg,
                                  n_closure=bucket.n_closure, seeds=seeds)
        sync()
        wall = time.perf_counter() - t0
        peak = read_peak()
        launches = dict(rk.LAUNCHES)
        shapes = dict(rk.ROW_TOTALS_SHAPES)
        solo_s, solo_peak = [], []
        for i, slab in enumerate(slabs):
            reset_peak()
            sync()
            t0 = time.perf_counter()
            solo = run_consensus(slab, det, cfg,
                                 key=prng.key(seeds[i], DEVICE),
                                 n_closure=bucket.n_closure)
            sync()
            solo_s.append(time.perf_counter() - t0)
            solo_peak.append(read_peak())
            got = res[i]
            check(got.rounds == solo.rounds and
                  got.converged == solo.converged,
                  f"batch {name} job {i}: rounds/convergence differ")
            check(got.history == solo.history,
                  f"batch {name} job {i}: history differs from its solo run")
            check(np.array_equal(np.stack(got.partitions),
                                 np.stack(solo.partitions)),
                  f"batch {name} job {i}: partitions differ from its solo "
                  f"run")
            check(all(torch.equal(getattr(got.graph, f),
                                  getattr(solo.graph, f))
                      for f in ("src", "dst", "weight", "alive")),
                  f"batch {name} job {i}: final slab differs")
        rounds = [r.rounds for r in res]
        alive = [[h["n_alive"] for h in r.history] for r in res]
        resident = sum(t.numel() * t.element_size() for s in slabs
                       for t in (s.src, s.dst, s.weight, s.alive))
        log(f"batch {name}: bucket {bucket.key()} (capacity "
            f"{bucket.capacity}, L {bucket.n_closure}, {path} sweep), B=4, "
            f"n_p={cfg.n_p}, seeds {seeds}; batch wall {wall:.2f}s, sum of "
            f"the four solo walls {sum(solo_s):.2f}s "
            f"{[round(x, 2) for x in solo_s]}; max_memory_allocated batch "
            f"{peak}, solo runs {solo_peak} (the four padded slabs, "
            f"{resident} bytes, resident throughout); splits "
            f"{len(res.splits)} {res.splits}; rounds {rounds}; converged "
            f"{[r.converged for r in res]}; peak alive edges "
            f"{[max(a) if a else 0 for a in alive]}; launches {launches}; "
            f"every job == its solo run on {DEVICE} (partitions, history, "
            f"final slab)")
        if launches["row_totals"]:
            # a job split off to a solo run may re-derive hybrid rows
            log(f"batch {name}: row_totals_launches_by_shape="
                f"{sorted(shapes.items())}")
            state.setdefault("main_paths", {})[f"batch_{name}"] = dict(
                launches=launches["row_totals"],
                by_shape=check_and_time_shapes(shapes, seed=6))
        if name == "A" and DEVICE == "cuda":
            # the device's busy share of the batch against the four solo
            # runs, traced again (batch A is short, so the trace is cheap)
            b_wall, b_busy, b_n = _device_busy(lambda: run_consensus_batch(
                slabs, det, cfg, n_closure=bucket.n_closure, seeds=seeds))
            s_wall, s_busy, s_n = _device_busy(lambda: [run_consensus(
                slab, det, cfg, key=prng.key(sd, DEVICE),
                n_closure=bucket.n_closure)
                for slab, sd in zip(slabs, seeds)])
            if b_busy is None or s_busy is None:
                log("batch A: the profiler showed no device time; idle "
                    "share not measured")
            else:
                log(f"batch A under torch.profiler (card only): batch wall "
                    f"{b_wall:.3f}s, device busy {b_busy:.3f}s, idle "
                    f"{1 - b_busy / b_wall:.1%}, {b_n} kernels; four solo "
                    f"runs wall {s_wall:.3f}s, busy {s_busy:.3f}s, idle "
                    f"{1 - s_busy / s_wall:.1%}, {s_n} kernels")


def phase_profile(state):
    """Not a default phase: one cell's consensus run (``--profile-cell``,
    default lfr100k; ``--n-p``, ``--max-rounds`` or ``--leiden-rounds``)
    under torch.profiler, printing the device time by kernel and the
    share of the wall during which the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastconsensus_tpu_torch import engine, native
    from fastconsensus_tpu_torch.models import leiden, louvain, lpm

    cell = state.get("profile_cell", "lfr100k")
    edges, truth, alg, cfg = cell_inputs(cell, state)
    det_mod, det_fn = {"louvain": (louvain, "louvain_members"),
                       "leiden": (leiden, "leiden_members"),
                       "lpm": (lpm, "lpm_members"),
                       "cnm": (native, "cnm_labels"),
                       "infomap": (native, "infomap_labels")}[alg]
    calls = {"detect": [], "tail": []}

    def timed(layer, fn):
        def wrapper(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            calls[layer].append((t0, time.perf_counter() - t0))
            return out
        return wrapper

    saved = (getattr(det_mod, det_fn), engine.consensus_tail)
    setattr(det_mod, det_fn, timed("detect", saved[0]))
    engine.consensus_tail = timed("tail", engine.consensus_tail)
    sync()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res, wall, per_round = _run(edges, int(truth.shape[0]), DEVICE,
                                        alg, **cfg)
            t_end = time.perf_counter()
    finally:
        setattr(det_mod, det_fn, saved[0])
        engine.consensus_tail = saved[1]
    # the final re-detection is everything after the last round's stamp
    final_s = wall - sum(per_round)
    last_stamp = t_end - final_s
    layer_s = {"detect": sum(dt for t, dt in calls["detect"]
                             if t < last_stamp),
               "tail": sum(dt for _, dt in calls["tail"]),
               "final_detect": final_s}
    log(f"profile {cell}: host seconds by layer {layer_s}")
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(events)
    own = sum(e.time_range.end - e.time_range.start for e in events
              if "row_totals_" in e.name)
    log(f"profile: row_totals kernels' device time {own / 1e6:.3f}s "
        f"({own / max(busy, 1e-9):.2%} of device busy time)")
    log(f"profile: rounds={res.rounds} wall={wall:.2f}s per_round="
        f"{[round(x, 3) for x in per_round]} device_busy={busy / 1e6:.2f}s "
        f"({busy / 1e6 / wall:.1%} of wall), {len(events)} kernels")
    table = prof.key_averages().table(sort_by="device_time_total",
                                      row_limit=25)
    (OUT / f"profile_table_{cell}.txt").write_text(table)
    log(table)


def kernels_line(state) -> str:
    paths = state.get("main_paths", {})
    fused = state.get("launches_fused", {})
    rows = state["kernel_rows"]
    src = "fastconsensus_tpu_torch/ops/csrc"
    out = []
    for name, replaces, launches, counted_on in (
            ("row_totals", "fastconsensus_tpu/ops/pallas_kernels.py:179",
             sum(p["launches"] for p in paths.values()),
             "+".join(paths) or "none"),
            ("fused_move_rows", "fastconsensus_tpu/ops/pallas_kernels.py:136",
             fused.get("fused_move_rows", 0), "fused dense path")):
        first = rows[name][0]
        out.append({
            "name": name, "route": "cuda", "source": f"{src}/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "shape": [first["rows"], first["d"]],
            "launches_counted_on": counted_on,
            "launches_by_path": ({k: {"launches": p["launches"],
                                      "by_shape": p["by_shape"]}
                                  for k, p in paths.items()}
                                 if name == "row_totals" else {}),
            "other_shapes": [{k: r[k] for k in ("rows", "d", "ms", "plain_ms",
                                                "bound_ms", "bound_by")}
                             for r in rows[name][1:]]})
    return json.dumps({"kernels": out})


def smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


PHASES = {"build": phase_build, "kernels": phase_kernels,
          "karate": phase_karate, "gpu_cpu": phase_gpu_cpu,
          "fused": phase_fused, "lfr100k": phase_lfr100k,
          "leiden_lfr10k": phase_leiden_lfr10k,
          "lpm_emaileu": phase_lpm_emaileu,
          "cnm_emaileu": phase_cnm_emaileu,
          "infomap_lfr10k": phase_infomap_lfr10k, "resume": phase_resume,
          "delta": phase_delta, "batch": phase_batch}
EXTRA_PHASES = {"profile": phase_profile}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help=f"comma list of {', '.join(PHASES)} (default: all) "
                        f"and the optional {', '.join(EXTRA_PHASES)}")
    p.add_argument("--n-p", type=int, default=200)
    p.add_argument("--max-rounds", type=int, default=8)
    p.add_argument("--leiden-rounds", type=int, default=16,
                   help="leiden_lfr10k's max_rounds (default 16, "
                        "bench.py's)")
    p.add_argument("--profile-cell", default="lfr100k",
                   choices=("lfr100k", "leiden_lfr10k", "lpm_emaileu",
                            "cnm_emaileu", "infomap_lfr10k"),
                   help="the cell phase profile runs")
    args = p.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: PyTorch missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import fastconsensus_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    state = {"n_p": args.n_p, "max_rounds": args.max_rounds,
             "leiden_rounds": args.leiden_rounds,
             "profile_cell": args.profile_cell}
    phases = [s for s in args.phases.split(",") if s]
    t_all = time.perf_counter()
    for name in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            {**PHASES, **EXTRA_PHASES}[name](state)
        except Exception as e:  # a failed phase ends the run, non-zero
            import traceback

            traceback.print_exc()
            print(f"chip_smoke: phase {name} FAILED: {e}", file=sys.stderr)
            return 1
        log(f"== phase {name} ok in {time.perf_counter() - t0:.2f}s")
    log(f"total {time.perf_counter() - t_all:.2f}s")
    if "kernels" in phases:
        log(kernels_line(state))
    log(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
