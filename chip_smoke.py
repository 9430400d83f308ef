"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as a release check runs it

Phases (any failure exits non-zero without the final line):

1. build     compile both CUDA kernels (one nvcc per source, in parallel)
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
             sorted-run vote (d_cap 0) with lpm: equal integer round
             histories, per-member agreement NMI >= 0.99
5. fused     the opt-in fused dense sweep (FCTPU_FUSED=1) end to end
6. lfr100k   the planted100k stress configuration of bench.py on
             bench_data/lfr100k.npz: louvain, n_p=200, tau=0.2,
             delta=0.02, max_rounds=8, closure_tau=0.2; afterwards
             row_totals at every shape the run launched it at, checked
             as in phase 2 and timed
7. leiden_lfr10k  bench.py's lfr10k configuration on
             bench_data/lfr10k.npz: leiden, n_p=100, tau=0.2, delta=0.02,
             max_rounds=16 (--leiden-rounds), closure_tau=0.2; per-round
             peak memory and n_agg_overflow; row_totals per shape as in 6
8. lpm_emaileu  bench.py's emailEu stand-in (planted, n 1,005, 42 blocks of
             size_alpha 0.85, p_in 0.6, p_out 0.02, seed 42): lpm, n_p=50,
             tau=0.8, delta=0.02; the dense vote's rows are 177 slots, the
             kernel's sorted regime; row_totals per shape as in 6, and the
             vote's sorted-rank step timed at the run's shape

Kernel launch counters are reset just before phases 5-8 and read just
after: phases 6-8 must launch ``row_totals``, phase 5 ``fused_move_rows``.
The second-to-last lines are the kernels' JSON record and the card's name
and power limit; the last line is the device record.
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
    from fastconsensus_tpu_torch.ops import row_kernels as rk

    t0 = time.perf_counter()
    info = rk.build()
    state["build_s"] = time.perf_counter() - t0
    for name, rec in info.items():
        ptx = " | ".join(line.strip() for line in rec["ptxas"].splitlines()
                         if "registers" in line or "spill" in line)
        log(f"build {name}: {rec['seconds']:.2f}s cached={rec['cached']} "
            f"{ptx}")
    log(f"build: {state['build_s']:.2f}s for {len(info)} kernels")


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
         **cfg):
    """One consensus run: ``(result, wall s, per-round s)``.  ``no_rows``
    packs without a row width (d_cap 0); ``peaks`` collects each round's
    peak device memory."""
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
                        on_round=on_round)
    sync()
    wall = time.perf_counter() - t0
    per_round = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    return res, wall, per_round


def phase_gpu_cpu(state):
    import numpy as np

    from fastconsensus_tpu_torch.utils.metrics import nmi

    edges, truth = planted_graph(5000, 40, 0.08, 0.0004, seed=7, hubs=10,
                                 hub_degree=600)
    ints = ("n_alive", "n_unconverged", "n_closure_added", "n_repaired",
            "n_hub_overflow", "n_agg_overflow", "capacity", "labels_changed")
    # (algorithm, how it runs, run settings): louvain and leiden on the
    # forced hybrid path, lpm packed without rows (the sorted-run vote)
    for alg, how, cfg in (
            ("louvain", "hybrid", dict(n_p=4, tau=0.2, max_rounds=3)),
            ("leiden", "hybrid", dict(n_p=4, tau=0.2, max_rounds=2)),
            ("lpm", "runs", dict(n_p=4, tau=0.8, max_rounds=2))):
        cfg = dict(cfg, delta=0.02, seed=11)
        if how == "hybrid":
            os.environ["FCTPU_MOVE_PATH"] = "hybrid"
        try:
            g, g_s, _ = _run(edges, 5000, DEVICE, alg, how == "runs", **cfg)
            c, c_s, _ = _run(edges, 5000, "cpu", alg, how == "runs", **cfg)
        finally:
            os.environ.pop("FCTPU_MOVE_PATH", None)
        agree = [nmi(a, b) for a, b in zip(g.partitions, c.partitions)]
        same = [bool(np.array_equal(a, b)) for a, b in
                zip(g.partitions, c.partitions)]
        log(f"gpu vs cpu ({alg}, 5k planted, {how}, n_p=4, {g.rounds} "
            f"rounds): per-member NMI {[round(a, 6) for a in agree]}, "
            f"identical {same}; {DEVICE} {g_s:.2f}s, cpu {c_s:.2f}s; NMI to "
            f"truth {np.mean([nmi(p, truth) for p in g.partitions]):.4f}")
        check(min(agree) >= 0.99,
              f"{alg} gpu/cpu agreement {min(agree)} < 0.99")
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

    if name == "lpm_emaileu":
        sizes = synth.heterogeneous_sizes(1005, 42, 0.85)
        edges, truth = synth.planted_partition(1005, 42, 0.6, 0.02, seed=42,
                                               sizes=sizes)
        return edges, truth, "lpm", dict(n_p=state.get("lpm_n_p", 50),
                                         tau=0.8, delta=0.02, seed=0)
    data = np.load(ROOT / "bench_data" / f"{name.split('_')[-1]}.npz")
    edges, truth = data["edges"], data["labels"]
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


def phase_profile(state):
    """Not a default phase: one cell's consensus run (``--profile-cell``,
    default lfr100k; ``--n-p``, ``--max-rounds`` or ``--leiden-rounds``)
    under torch.profiler, printing the device time by kernel and the
    share of the wall during which the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastconsensus_tpu_torch import engine
    from fastconsensus_tpu_torch.models import leiden, louvain, lpm

    cell = state.get("profile_cell", "lfr100k")
    edges, truth, alg, cfg = cell_inputs(cell, state)
    det_mod, det_fn = {"louvain": (louvain, "louvain_members"),
                       "leiden": (leiden, "leiden_members"),
                       "lpm": (lpm, "lpm_members")}[alg]
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
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:            # union of kernel intervals, microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    own = sum(e.time_range.end - e.time_range.start for e in events
              if "row_totals_" in e.name)
    log(f"profile: row_totals kernels' device time {own / 1e6:.3f}s "
        f"({own / max(busy, 1e-9):.2%} of device busy time)")
    log(f"profile: rounds={res.rounds} wall={wall:.2f}s per_round="
        f"{[round(x, 3) for x in per_round]} device_busy={busy / 1e6:.2f}s "
        f"({busy / 1e6 / wall:.1%} of wall), {len(spans)} kernels")
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
          "lpm_emaileu": phase_lpm_emaileu}
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
                   choices=("lfr100k", "leiden_lfr10k", "lpm_emaileu"),
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
