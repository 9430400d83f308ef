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
3. karate    the port's CLI on the karate club graph (matmul sweep path)
4. gpu_cpu   one planted 5k-node graph through the hybrid path on the card
             and on the CPU: per-member agreement must reach NMI 0.99
5. fused     the opt-in fused dense sweep (FCTPU_FUSED=1) end to end
6. lfr100k   the planted100k stress configuration of bench.py on
             bench_data/lfr100k.npz: louvain, n_p=200, tau=0.2,
             delta=0.02, max_rounds=8, closure_tau=0.2; afterwards
             row_totals at every shape the run launched it at, checked
             as in phase 2 and timed

Kernel launch counters are reset just before phases 5 and 6 and read just
after: phase 6 must launch ``row_totals``, phase 5 ``fused_move_rows``.
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

    out = OUT / "karate"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    rc = cli.main(["-f", str(ROOT / "examples" / "karate_club.txt"), "-np",
                   "20", "--out-dir", str(out), "--quiet", "--device",
                   DEVICE])
    check(rc == 0, f"karate CLI exit {rc}")
    _, _, ids = read_edgelist(str(ROOT / "examples" / "karate_club.txt"))
    _valid_partition_tree(out, 20, len(ids), [int(x) for x in ids])
    log(f"karate CLI on {DEVICE}: 20 valid partitions in "
        f"{time.perf_counter() - t0:.2f}s")


def _run(edges, n, device, **cfg):
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.models.registry import get_detector

    slab = pack_edges(edges, n, device=device)
    stamps = []
    sync()
    t0 = time.perf_counter()
    res = run_consensus(slab, get_detector("louvain"),
                        ConsensusConfig(**cfg),
                        on_round=lambda e: stamps.append(time.perf_counter()))
    sync()
    wall = time.perf_counter() - t0
    per_round = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    return res, wall, per_round


def phase_gpu_cpu(state):
    import numpy as np

    from fastconsensus_tpu_torch.utils.metrics import nmi

    edges, truth = planted_graph(5000, 40, 0.08, 0.0004, seed=7, hubs=10,
                                 hub_degree=600)
    os.environ["FCTPU_MOVE_PATH"] = "hybrid"
    try:
        cfg = dict(n_p=4, tau=0.2, delta=0.02, max_rounds=3, seed=11)
        g, g_s, _ = _run(edges, 5000, DEVICE, **cfg)
        c, c_s, _ = _run(edges, 5000, "cpu", **cfg)
    finally:
        del os.environ["FCTPU_MOVE_PATH"]
    agree = [nmi(a, b) for a, b in zip(g.partitions, c.partitions)]
    same = [bool(np.array_equal(a, b)) for a, b in
            zip(g.partitions, c.partitions)]
    log(f"gpu vs cpu (5k planted, hybrid, n_p=4, {g.rounds} rounds): "
        f"per-member NMI {[round(a, 6) for a in agree]}, identical {same}; "
        f"{DEVICE} {g_s:.2f}s, cpu {c_s:.2f}s; NMI to truth "
        f"{np.mean([nmi(p, truth) for p in g.partitions]):.4f}")
    check(min(agree) >= 0.99, f"gpu/cpu agreement {min(agree)} < 0.99")
    ints = ("n_alive", "n_unconverged", "n_closure_added", "n_repaired",
            "n_hub_overflow", "capacity", "labels_changed")
    check([[h[k] for k in ints] for h in g.history] ==
          [[h[k] for k in ints] for h in c.history],
          "gpu/cpu round histories differ")


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


def phase_lfr100k(state):
    import numpy as np
    import torch

    from fastconsensus_tpu_torch.ops import row_kernels as rk
    from fastconsensus_tpu_torch.utils.metrics import nmi

    data = np.load(ROOT / "bench_data" / "lfr100k.npz")
    edges, truth = data["edges"], data["labels"]
    n = int(truth.shape[0])
    n_p = state["n_p"]
    if state.get("nodes"):       # rehearsal only: a prefix of the graph
        n = state["nodes"]
        edges = edges[(edges < n).all(axis=1)]
        truth = truth[:n]
    if n_p != 200:
        log(f"lfr100k: n_p cut 200 -> {n_p} to fit the time limit")
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rk.reset_launches()
    res, wall, per_round = _run(
        edges, n, DEVICE, n_p=n_p, tau=0.2, delta=0.02,
        max_rounds=state["max_rounds"], seed=0, closure_tau=0.2)
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
    # the kernel at each shape the run gave it, on random rows (the flat
    # regime's work does not depend on the labels): exact against the
    # plain version, and timed; time lost there is launches x (ms - bound)
    rng = np.random.default_rng(1)
    per_shape = []
    for (r, d), count in sorted(shapes.items()):
        lab_c, w_c = random_rows(rng, r, d)
        check_row_totals(lab_c, w_c)
        ms = median_ms(lambda: rk.row_totals_cuda(lab_c, w_c))
        b, _ = row_totals_bound(r, d)
        per_shape.append(dict(rows=r, d=d, launches=count, ms=ms,
                              bound_ms=b, lost_ms=count * (ms - b)))
        log(f"  row_totals at [{r}, {d}]: exact; {count} launches, "
            f"{ms:.4f} ms, bound {b:.4f} ms, lost {count * (ms - b):.1f} ms")
        del lab_c, w_c
    check(len(res.partitions) == n_p and all(
        p.shape == (n,) for p in res.partitions), "partition shapes")
    state["launches_main"] = launches
    state["row_shapes_seen"] = per_shape
    state["lfr100k"] = dict(rounds=res.rounds, converged=res.converged,
                            wall_s=wall, per_round_s=per_round,
                            nmi_mean=float(np.mean(scores)),
                            max_memory_allocated=peak)


def phase_profile(state):
    """Not a default phase: one lfr100k consensus run (``--max-rounds``,
    ``--n-p``) under torch.profiler, printing the device time by kernel
    and the share of the wall during which the device was busy."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastconsensus_tpu_torch import engine
    from fastconsensus_tpu_torch.models import louvain as lv

    data = np.load(ROOT / "bench_data" / "lfr100k.npz")
    edges, truth = data["edges"], data["labels"]
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

    saved = (lv.louvain_members, engine.consensus_tail)
    lv.louvain_members = timed("detect", lv.louvain_members)
    engine.consensus_tail = timed("tail", engine.consensus_tail)
    sync()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res, wall, per_round = _run(
                edges, int(truth.shape[0]), DEVICE, n_p=state["n_p"],
                tau=0.2, delta=0.02, max_rounds=state["max_rounds"], seed=0,
                closure_tau=0.2)
            t_end = time.perf_counter()
    finally:
        lv.louvain_members, engine.consensus_tail = saved
    # the final re-detection is everything after the last round's stamp
    final_s = wall - sum(per_round)
    last_stamp = t_end - final_s
    layer_s = {"detect": sum(dt for t, dt in calls["detect"]
                             if t < last_stamp),
               "tail": sum(dt for _, dt in calls["tail"]),
               "final_detect": final_s}
    log(f"profile: host seconds by layer {layer_s}")
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
    (OUT / "profile_table.txt").write_text(table)
    log(table)


def kernels_line(state) -> str:
    main = state.get("launches_main", {})
    fused = state.get("launches_fused", {})
    rows = state["kernel_rows"]
    src = "fastconsensus_tpu_torch/ops/csrc"
    out = []
    for name, replaces, launches, counted_on in (
            ("row_totals", "fastconsensus_tpu/ops/pallas_kernels.py:179",
             main.get("row_totals", 0), "lfr100k"),
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
            "launches_by_shape": (state.get("row_shapes_seen", [])
                                  if name == "row_totals" else []),
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
          "fused": phase_fused, "lfr100k": phase_lfr100k}
EXTRA_PHASES = {"profile": phase_profile}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help=f"comma list of {', '.join(PHASES)} (default: all) "
                        f"and the optional {', '.join(EXTRA_PHASES)}")
    p.add_argument("--n-p", type=int, default=200)
    p.add_argument("--max-rounds", type=int, default=8)
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
    state = {"n_p": args.n_p, "max_rounds": args.max_rounds}
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
