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
3. memory    each sweep path's per-member memory model against the card:
             one detect call of 8 members (4 sweeps) after a one-member
             warm-up; the matmul sweep on the emailEu stand-in, the dense,
             hybrid and hash sweeps, Leiden (hybrid rows) on gpu_cpu's
             planted 5k graph, the hybrid sweep on lfr100k as phase 7
             packs it, and the LPM dense vote on the emailEu stand-in:
             the peak over the baseline a member must be at most the
             model, and the model at most twice it
4. karate    the port's CLI on the karate club graph with --alg louvain
             (matmul sweep path), leiden and lpm: 20 valid partitions each
5. gpu_cpu   one planted 5k-node graph through the hybrid path on the card
             and on the CPU with louvain and leiden, and through the
             sorted-run vote (d_cap 0) with lpm; louvain with the scatter
             wedge sampler; cnm and infomap (n_p=8, at most 2 rounds,
             delta 0) on the emailEu stand-in: identical partitions and
             integer round histories
6. fused     the opt-in fused dense sweep (FCTPU_FUSED=1) end to end
6a. blocks   fused round blocks against one round a host step, each case
             at FCTPU_ROUNDS_BLOCK=8 and =1: partitions, history, slab
             (and a batch's splits) bitwise equal, kernel launches at
             each width equal (a block's sweep runs every member, so its
             shapes are the stream's rows).  Solo runs (engine.
             RoundsBlock: one round captured into a CUDA graph, replayed
             round after round, one stats readback a block): lfr10k
             (louvain, n_p 20, tau 0.2, delta 0.02, seed 0, at most 8
             rounds, cut from 16 to fit the time limit: hybrid rows
             through row_totals), the emailEu
             stand-in (lpm_emaileu's settings), karate (louvain, n_p 20,
             the matmul sweep), fused's planted 5k graph (FCTPU_FUSED=1,
             4 rounds: fused_move_rows in the graph) and Leiden on
             karate, the emailEu stand-in (n_p 20) and the planted 5k
             graph on forced hybrid rows (n_p 8; each at delta 0, at
             most 6 rounds), and the host C++ detectors CNM and Infomap
             on the emailEu stand-in (n_p 8, delta 0, at most 6 rounds;
             the C++ a host node of the captured round, one run a round
             that detects).  Batches (run_consensus_batch through
             engine.BatchBlock, one graph captured a run): batch A (four
             emailEu stand-ins, B 4, the matmul sweep), four seeded
             planted 5k graphs on forced hybrid rows with Louvain and
             with Leiden (n_p 8, delta 0, 6 rounds), and batch B
             (lfr10k and three children: the hash sweep, every job split
             off to a solo run at its saturating round); A and B at
             phase batch's settings (at most 6 rounds); CNM over batch A
             (n_p 8, delta 0, 3 rounds: one host-node run a batched
             round, for every job it runs), and
             FCTPU_ENSEMBLE_BUDGET_MB=24576 where a stream would take
             more than one member chunk.  Karate's and CNM's blocks on
             the card against their blocks on the CPU (partitions, slab,
             integer history); per run the wall, rounds, blocks, captures
             and their seconds, host-node runs, batch.blocks and the
             batched blocks, host
             syncs by tag, the device's busy share (nvidia-smi's
             utilization.gpu sampled every 50 ms) and the peak memory
             allocated and reserved
7. lfr100k   the planted100k stress configuration of bench.py on
             bench_data/lfr100k.npz: louvain, n_p=200, tau=0.2,
             delta=0.02, closure_tau=0.2, at 3 rounds (bench.py runs
             8: cut to keep the release check within its time limit;
             rounds 2 and 3 re-derive the budgets); afterwards
             row_totals at every shape the run launched it at, checked
             as in phase 2 and timed, and the device memory of one group
             of the scatter wedge sampler at its element cap, on the
             slab at the run's largest capacity
8. mesh      lfr100k through run_consensus(mesh=): louvain, the scatter
             wedge sampler, seed 0, tau 0.2, delta 0.02 (the CLI's),
             n_p 8, 2 rounds, a warm-up run, then unsharded and on a
             (p=2, e=2) and a (p=1, e=4) mesh that list this card 4
             times (a (p=1, e=count) and a (p=2, e=count/2) mesh over
             distinct GPUs too where the machine has two or more);
             partitions, rounds, integer round stats and the gathered
             slab over the unsharded capacity bitwise equal; each
             layout's wall, peak device memory (per card) and row_totals
             launches by shape; each sharded run must launch row_totals;
             row_totals per shape as in 7
9. multiprocess  lfr100k through run_consensus(mesh=) run SPMD by 4
             rank processes of this script on this one card, joined by
             parallel.initialize_multihost(backend="gloo") (NCCL cannot
             put two ranks on one GPU), each rank owning one mesh cell:
             phase 8's settings in layouts (p=2, e=2) and (p=1, e=4);
             every rank's partitions, rounds, integer round stats and
             gathered slab bitwise equal to phase 8's unsharded run; each
             rank's wall, peak device memory, seconds in detection and in
             the collectives (its slowest four printed) and row_totals
             launches, and every rank that detects must launch
             row_totals; row_totals per shape as in 7.  Beside it, two ranks asking for NCCL on
             this one card must be refused by name; where the machine has
             two or more cards, one rank per card over NCCL instead
10. leiden_lfr10k  bench.py's lfr10k configuration on
             bench_data/lfr10k.npz: leiden, n_p=100, tau=0.2, delta=0.02,
             max_rounds=6 (--leiden-rounds; bench.py's 16, cut to fit
             the time limit; round 5 grows the slab), closure_tau=0.2;
             per-round peak memory and n_agg_overflow; row_totals per
             shape as in 7
11. lpm_emaileu  bench.py's emailEu stand-in (planted, n 1,005, 42 blocks of
             size_alpha 0.85, p_in 0.6, p_out 0.02, seed 42): lpm, n_p=50,
             tau=0.8, delta=0.02; the dense vote's rows are 177 slots, the
             kernel's sorted regime; row_totals per shape as in 7, and the
             vote's sorted-rank step timed at the run's shape
12. cnm_emaileu  the CLI with --alg cnm (host C++ detection, the tail on
             the card) on the emailEu stand-in: n_p=50, tau=0.7,
             delta=0.02, seed 0; rounds, wall, host C++ seconds and tail
             seconds per round, peak memory, member NMI to the planted
             labels
13. infomap_lfr10k  the same with --alg infomap on bench_data/lfr10k.npz:
             n_p=50, tau=0.6, delta=0.02, max_rounds=8; both cells are
             run once more on the CPU and must give identical partitions,
             round histories and output trees
14. resume   the CLI with --checkpoint/--resume: Louvain, n_p=8, forced
             hybrid rows on gpu_cpu's planted 5k graph; 4 rounds
             uninterrupted against 2 rounds resumed to 4, and against a
             card resume of a checkpoint the CPU wrote: equal partitions,
             histories and output trees
15. recovery  the CLI with --checkpoint --resume --detect-cache
             --trace-jsonl --trace --dump-on-signal on resume's graph and
             settings, FCTPU_DETECT_CALL_MEMBERS=2: killed (SIGQUIT: a
             fcflight bundle naming the cache; then SIGKILL) once round
             2's second chunk is on disk, restarted under
             fastconsensus_tpu_torch.utils.supervise: output trees equal
             to an uninterrupted run's, cached chunks reused; row_totals
             per shape as in 7
16. trace    the CLI on the same graph, 2 rounds, with the tracer off,
             on (--trace), and on with --profile-dir: the Perfetto file's
             fcobs spans in order, its device track, the row_totals
             kernel events inside the run's spans, the JSONL counters and
             the device-memory gauge against max_memory_allocated; the
             three walls printed
17. delta    fcdelta on bench_data/lfr10k.npz (louvain, n_p=20, tau=0.2,
             delta=0.02, seed 0, at most 16 rounds): a parent run, a child
             graph with a seeded 1% edge delta (serve/delta.py), the
             incremental run from the parent's partitions with the
             vertices outside the delta's neighborhood frozen (at most 4
             rounds), a from-scratch run on the child,
             and the incremental run again on the CPU: identical
             partitions and integer history, frozen vertices at their
             parent labels; row_totals per shape as in 7
18. batch    run_consensus_batch on two batches of B=4 same-bucket jobs
             (louvain, n_p=20, tau=0.2, delta=0.02, closure_tau=0.2, seeds
             11/22/33/44, at most 6 rounds, cut from 16 to fit the time
             limit): A, four emailEu stand-ins
             (graph seeds 42-45, the matmul sweep); B, lfr10k and three
             children of seeded 2% edge deltas (the hash sweep); each job
             equal to its solo run on the card; the bucket, batch wall,
             solo walls, peak device memory of the batch and of the
             largest solo run, splits and rounds printed; batch A's peak
             within the member budget plus the slabs
19. serve    the serving tier.  A, in this process: a ConsensusService
             on the card (one worker, max_batch 4) behind its HTTP front
             end; lfr10k as a solo job (louvain, n_p=20, tau=0.2,
             delta=0.02, seed 0, at most 16 rounds, phase 17's parent),
             batch A's four jobs (phase 18) submitted concurrently while
             it runs, which must coalesce into one rung-4 batch with no
             solo fallback, phase 17's 1% delta against the lfr10k job
             (served incremental), and the lfr10k job again (a
             submit-time cache hit: no launch, 0 compiles); the solo job
             equal to run_consensus on its bucket slab, each batch job to
             its solo run (phase 18's when it ran), the delta to the
             library path (serve/delta.py + run_consensus(init_labels=,
             active_mask=)); the live /metricsz held to the committed
             contract inventory (analysis/contracts.assert_covered, every
             metric name a writer the static pass knows); per job the
             queue wait, device and total
             milliseconds, rung and compiles, each bucket's cost prior
             beside its device time, the delta's wall beside the lfr10k
             job's, the cache hit's latency, the peak device memory;
             row_totals per shape as in 7; all of A under the lock-order
             recorder (analysis/lockorder.py, installed before the
             service is built), the observed edges counted and those the
             static graph (analysis/concurrency.py) lacks printed, their
             union with the static graph acyclic.  B, the entry points in
             subprocesses: python -m fastconsensus_tpu_torch.serve
             --max-batch 4 --cache-file, cli.py --server on karate for
             louvain and lpm (each tree byte-identical to the tree of
             the same bucketed run by the library, pad_to_bucket +
             run_consensus), SIGTERM (drain, cache spill, exit 0), a
             restart on the same cache file answering the louvain repeat
             from the cache with 0 compiles and the same bytes; each
             server's /metricsz held to the contract inventory before
             it drains
20. fleet    the fleet tier (serve/fleet.py, serve/router.py, in this
             process) over two python -m fastconsensus_tpu_torch.serve
             --max-batch 4 replicas sharing the card (spawned together,
             each's seconds to a healthy /healthz): through the router,
             karate with louvain and lpm (n_p 20, phase 19 B's), lfr10k
             (phase 17's parent), batch A's four jobs (phase 18's),
             which share a route key and must coalesce into one rung-4
             batch on the ring's home for it, queued behind a running
             job there, and phase 17's 1% delta (routed on its parent,
             under the default DeltaPolicy; the decision and whether the
             parent was fetched across replicas printed); per job the
             replica, route key and timing block; every replica 0
             builds; row_totals launches summed over the replicas'
             /metricsz, per shape as in 7; each replica's device memory,
             the card's used memory and the router's proxy overhead per
             replica (/fleetz); every replica's and the router's
             /metricsz held to the contract inventory, and the
             telemetry.fleet_latency block (obs/fleettrace.
             fleet_latency_block, bench.py's shape) built from the /fleetz
             scrape, printed and held to obs/history.check_fleet_latency
             (every replica scraped, an exact merge, the fleet p95 no
             higher than the worst replica's).  Then SIGKILL of the karate louvain
             group's home once its spill file holds what it served,
             on_death, and the resubmit answered from the successor's
             inherited cache (kill-to-answer seconds); add_replica("r2")
             (its /metricsz held to the contract inventory)
             with prewarm shipping, armed with the drain-time spill fault
             (FCTPU_FAULT_INJECT ...ResultCache.spill:OSError, count 1;
             a site analysis/fault_inventory.json lists, absorbed by
             ConsensusService.drain);
             every job resubmitted, each a cache hit with the same bytes;
             collect_bundles (the killed replica's included) plus the
             router's own bundle, and fleettrace render holding the
             lfr10k trace id on the router's and a replica's track; the
             drain (every live replica exits 0, the armed fault logged);
             every routed result equal to its library run on the card
             (solo and karate jobs pad_to_bucket + run_consensus, batch
             jobs their solo runs, the delta the library path under the
             replica's decision); the phase's wall
21. footprint the footprint memory model (analysis/entrypoints.py)
             against the card: each serving kind's model at the job's
             own packed slab within [1, 2]x of the peak allocated over
             the baseline taken before its arguments (after a warm-up
             call), and the bucket's worst case at least the model:
             batch A's four jobs (one warm batch round and the batched
             final detect, B = 4, n_p 20, the matmul sweep), lfr10k's
             bucket solo (detect, tail, one round; n_p 20) and lfr100k's
             (detect, one chunk of 8 members, 4 sweeps), both on hybrid
             rows re-derived from the degrees as a served run re-derives
             them; max_memory_reserved printed.  F5, a block's graph
             pools: one RoundsBlock (lfr10k's bucket, block 8, one
             capture) and one BatchBlock (batch A, B 4, block 8), each
             from an emptied cache and followed, while its pools are
             held, by one eager round: the blocked model (eager cache,
             graph pool, body pool) within [1, 2]x of
             max_memory_reserved over the baseline, the reserved bytes
             printed by pool and stream.  The serve defaults'
             chip ceilings at the card's memory and at a budget that
             fits lfr10k's bucket and not lfr100k's, unblocked and at
             FCTPU_ROUNDS_BLOCK=8 (never higher); the server's
             --chip-max-edges auto (covering the whole ladder at the
             card's memory: exit 2, as the reference's) and an
             over-ceiling explicit --chip-max-edges (exit 2), in
             process; with two or more devices, python -m
             fastconsensus_tpu_torch.serve --huge-devices 1
             --chip-max-edges auto --hbm-bytes B starting on the
             derived ceiling and draining on SIGTERM

Kernel launch counters are reset just before phases 6-7, each of phase
6a's runs, each of
phase 8's runs and of phase 9's rank runs, phases 10-11, 14, 15 (its
uninterrupted run), 16 (its profiled run), 17 (its incremental card
run), 18, 19 (its part A) and 21 (its lfr10k and lfr100k parts) and read
just after: phases 7, 10-11, 14-17, 19 and 21, phase 8's sharded runs
and phase 9's detecting ranks must launch ``row_totals``, phase 6
``fused_move_rows``; phase 18's bucketed slabs
take the matmul and hash sweeps, which launch no kernel of the port (a
job split off to a solo run may); phase 19's lfr10k jobs
start on the hash sweep and take hybrid rows once their budgets are
re-derived.  Phase 20's replicas launch ``row_totals`` in their own
processes, fresh ones, and report their counts in ``/metricsz``
(``kernels``); phase 20 sums them over the replicas after its routed
traffic and must find launches.  The second-to-last
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


# the serve counters phase serve's part A prints (a module constant, so
# that the contract pass resolves each name this file reads)
SERVE_SHOWN = ("batch.coalesced", "batch.occupancy", "batch.fallback_solo",
               "pool.deque_coalesced", "queue.coalesced_pops",
               "xla_compiles")


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def contract_check(state, what: str, snapshot) -> int:
    """Hold one live /metricsz snapshot to the committed fcheck-contract
    inventory (analysis/contract_inventory.json): every metric name in
    it must be covered by a writer template the static pass found.  A
    missing inventory or a stray name fails the phase."""
    from fastconsensus_tpu_torch.analysis import contracts

    t0 = time.perf_counter()
    if "contract_inventory" not in state:
        state["contract_inventory"] = contracts.load_inventory(str(
            ROOT / "fastconsensus_tpu_torch" / "analysis" /
            "contract_inventory.json"))
    try:
        n = contracts.assert_covered(snapshot, state["contract_inventory"])
    except AssertionError as e:
        raise PhaseError(f"{what}: {e}") from None
    dt = time.perf_counter() - t0
    state["contract_s"] = state.get("contract_s", 0.0) + dt
    log(f"{what}: {n} live metric names, each covered by the contract "
        f"inventory ({dt * 1e3:.2f} ms)")
    return n


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
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from fastconsensus_tpu_torch import native
    from fastconsensus_tpu_torch.ops import row_kernels as rk
    from fastconsensus_tpu_torch.utils import io

    def load_native():
        t0 = time.perf_counter()
        native.load()
        return time.perf_counter() - t0

    # the host C++ (CNM, Infomap, the edgelist parser) compiles beside
    # the kernels' nvcc processes
    with ThreadPoolExecutor(1) as pool:
        cxx = pool.submit(load_native)
        t0 = time.perf_counter()
        info = rk.build()
        state["build_s"] = time.perf_counter() - t0
        cxx_s = cxx.result()
    for name, rec in info.items():
        ptx = " | ".join(line.strip() for line in rec["ptxas"].splitlines()
                         if "registers" in line or "spill" in line)
        log(f"build {name}: {rec['seconds']:.2f}s cached={rec['cached']} "
            f"{ptx}")
    log(f"build: {state['build_s']:.2f}s for {len(info)} kernels")
    # the two edgelist readers on the largest graph the phases read, as
    # text
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
    log(f"build: host C++ {cxx_s:.2f}s beside the kernels "
        f"({native.lib_path().name}); "
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


# Member budget of the block cases whose stacked (or Leiden) detection
# exceeds the default 2048 MiB: a block runs only where the whole stream
# is one member chunk, so these cases widen it (both block sizes alike)
BLOCK_BUDGET = {"FCTPU_ENSEMBLE_BUDGET_MB": "24576"}
# The detectors that run as host C++ (a host node in a captured block).
HOST_ALGS = ("cnm", "infomap")


def _block_cases(state):
    """Phase blocks' solo runs: (name, edges, n, algorithm, environment,
    run settings)."""
    import numpy as np

    from fastconsensus_tpu_torch.utils.io import read_edgelist

    data = np.load(ROOT / "bench_data" / "lfr10k.npz")
    email, email_truth, _, email_cfg = cell_inputs("lpm_emaileu", state)
    k_edges, _, k_ids = read_edgelist(str(ROOT / "examples" /
                                          "karate_club.txt"))
    p_edges, _ = planted_graph(5000, 50, 0.2, 0.0005, seed=3)
    n_email = int(email_truth.shape[0])
    leiden_n_p = state.get("blocks_leiden_n_p", 20)
    return [
        ("lfr10k", data["edges"], int(data["labels"].shape[0]), "louvain",
         {}, dict(n_p=state.get("blocks_n_p", 20), tau=0.2, delta=0.02,
                  seed=0, max_rounds=8)),
        ("emailEu stand-in", email, n_email, "lpm", {}, email_cfg),
        ("karate", k_edges, len(k_ids), "louvain", {},
         dict(n_p=20, tau=0.2, delta=0.02, seed=0)),
        ("5k planted, fused", p_edges, 5000, "louvain",
         {"FCTPU_MOVE_PATH": "dense", "FCTPU_FUSED": "1"},
         dict(n_p=8, tau=0.2, delta=0.02, max_rounds=4, seed=2)),
        # Leiden at delta 0, so that its runs go on past their first
        # warm rounds (at 0.02 each converged in one or two)
        ("leiden karate", k_edges, len(k_ids), "leiden", {},
         dict(n_p=20, tau=0.2, delta=0.0, seed=0, max_rounds=6)),
        ("leiden emailEu stand-in", email, n_email, "leiden",
         dict(BLOCK_BUDGET), dict(n_p=leiden_n_p, tau=0.2, delta=0.0,
                                  seed=0, max_rounds=6, closure_tau=0.2)),
        ("leiden 5k planted, hybrid", p_edges, 5000, "leiden",
         {"FCTPU_MOVE_PATH": "hybrid"},
         dict(n_p=8, tau=0.2, delta=0.0, max_rounds=6, seed=2)),
        # the host C++ detectors: the block's host node runs the C++ at
        # each round (cnm_emaileu's and infomap_lfr10k's tau, delta 0)
        ("cnm emailEu stand-in", email, n_email, "cnm", {},
         dict(n_p=8, tau=0.7, delta=0.0, seed=0, max_rounds=6)),
        ("infomap emailEu stand-in", email, n_email, "infomap", {},
         dict(n_p=8, tau=0.6, delta=0.0, seed=0, max_rounds=6))]


def _planted_batch(device, n: int = 5000, n_comm: int = 50,
                   p_out: float = 0.0005):
    """Four seeded planted graphs (5k nodes) packed to one set of
    statics, as one bucket: ``(slabs, n_closure)``.  The slabs have room
    for closure (three slots an edge) and budgets that do not starve in
    a few rounds (no dense rows, a hub prefix and an aggregate the size
    of the slab), so no job splits off and the batch stays in its
    block; the hybrid rows are the widest of the four graphs' own."""
    import dataclasses

    import torch

    from fastconsensus_tpu_torch.graph import (derive_agg_sizing,
                                               hub_cap_for, pack_edges)

    packs = [pack_edges(planted_graph(n, n_comm, 0.2, p_out, seed=s)[0],
                        n, device="cpu") for s in (3, 4, 5, 6)]
    n_edges = [int(p.num_alive()) for p in packs]
    cap = 3 * max(n_edges)
    statics = dict(d_cap=0, cap_hint=cap,
                   d_hyb=max(p.d_hyb for p in packs),
                   hub_cap=hub_cap_for(2 * cap),
                   agg_cap=derive_agg_sizing(cap))
    slabs = []
    for p in packs:
        def ext(t, pad=cap - p.capacity):
            return torch.cat([t, t.new_zeros(pad)]).to(device)

        slabs.append(dataclasses.replace(
            p, src=ext(p.src), dst=ext(p.dst), weight=ext(p.weight),
            alive=ext(p.alive), **statics))
    return slabs, max(n_edges)


def _batch_block_cases(state):
    """Phase blocks' batches: (name, slabs, n_closure, algorithm,
    environment, run settings)."""
    from fastconsensus_tpu_torch.serve import bucketer

    out = []
    cfg = dict(_batch_cfg(state),
               max_rounds=state.get("blocks_batch_rounds", 6))
    hybrid = dict(BLOCK_BUDGET, FCTPU_MOVE_PATH="hybrid")
    planted_cfg = dict(n_p=state.get("blocks_batch_n_p", 8), tau=0.2,
                       delta=0.0, max_rounds=6)
    cnm_cfg = dict(n_p=8, tau=0.7, delta=0.0, max_rounds=3)
    for name, alg, env, run_cfg in (
            ("batch A", "louvain", dict(BLOCK_BUDGET), cfg),
            ("planted batch", "louvain", hybrid, planted_cfg),
            ("planted batch", "leiden", hybrid, planted_cfg),
            ("batch B", "louvain", dict(BLOCK_BUDGET), cfg),
            ("batch A", "cnm", {}, cnm_cfg)):
        if name.startswith("planted"):
            slabs, n_closure = _planted_batch(DEVICE)
        else:
            padded = [bucketer.pad_to_bucket(e, n, device=DEVICE)
                      for e, n in _batch_graphs(name[-1])]
            check(len({b.key() for _, b in padded}) == 1,
                  f"blocks {name}: graphs in several buckets")
            slabs, n_closure = [s for s, _ in padded], padded[0][1].n_closure
        out.append((f"{name} ({alg})", slabs, n_closure, alg, env, run_cfg))
    return out


def phase_blocks(state):
    """The fused round blocks against one round a host step: each case at
    FCTPU_ROUNDS_BLOCK=8 and =1, bitwise equal (partitions, history,
    slab, and for a batch the splits) with equal kernel launches by
    width; karate's block also against its block on the CPU.  Solo runs
    through engine.RoundsBlock (Louvain, LPM, Leiden), batches through
    engine.BatchBlock (one captured graph a batch run)."""
    import numpy as np
    import torch

    from fastconsensus_tpu_torch import engine
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus_batch)
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.obs import counters as obs_counters
    from fastconsensus_tpu_torch.ops import row_kernels as rk

    reg = obs_counters.get_registry()
    batch_calls = {"run": 0, "capture": 0}
    orig = engine.BatchBlock.run, engine.BatchBlock._capture

    def counted(key, fn):
        def wrapper(self, *a, **k):
            batch_calls[key] += 1
            return fn(self, *a, **k)
        return wrapper

    def one(call, env, block, device=DEVICE):
        saved = {k: os.environ.get(k) for k in
                 list(env) + ["FCTPU_ROUNDS_BLOCK"]}
        os.environ.update(env, FCTPU_ROUNDS_BLOCK=str(block))
        base = reg.counters()
        cap_n = len(reg.series("engine.setup_executables.seconds"))
        calls0 = dict(batch_calls)
        rk.reset_launches()
        if device == DEVICE == "cuda":
            # earlier runs' closed graphs leave their pools in the cache:
            # hand them back, so that the reserved peak is this run's
            torch.cuda.empty_cache()
        reset_peak()
        out = []
        try:
            if device == DEVICE == "cuda":
                wall, busy, n_k = _device_utilization(
                    lambda: out.append(call(device)))
            else:
                t0 = time.perf_counter()
                out.append(call(device))
                wall, busy, n_k = time.perf_counter() - t0, None, 0
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        since = reg.counters_since(base)
        syncs = {k[len("host_sync."):]: v for k, v in sorted(since.items())
                 if k.startswith("host_sync.") and k != "host_sync.total"}
        cap_s = reg.series("engine.setup_executables.seconds")[cap_n:]
        return dict(res=out[0], wall=wall, busy=busy, kernels=n_k,
                    peak=read_peak(), syncs=syncs,
                    reserved=torch.cuda.max_memory_reserved()
                    if device == DEVICE == "cuda" else None,
                    blocks=since.get("host_sync.block_stats", 0),
                    batch_blocks=since.get("batch.blocks", 0),
                    batch_runs=batch_calls["run"] - calls0["run"],
                    batch_captures=batch_calls["capture"] -
                    calls0["capture"],
                    captures=since.get("engine.setup_executables", 0),
                    host_calls=since.get("engine.host_detect.calls", 0),
                    capture_s=sum(cap_s), launches=dict(rk.LAUNCHES),
                    shapes=dict(rk.ROW_TOTALS_SHAPES))

    # the history's float fields sum in the device's order: the card
    # and the CPU agree on the rest
    floats = ("agreement", "modularity_mean", "modularity_by_member")

    def same(a, b, exact=True) -> bool:
        ga, gb = a.graph, b.graph
        ha, hb = a.history, b.history
        if not exact:
            ha, hb = ([{k: v for k, v in h.items() if k not in floats}
                       for h in hist] for hist in (ha, hb))
        return (len(a.partitions) == len(b.partitions) and
                all(np.array_equal(x, y)
                    for x, y in zip(a.partitions, b.partitions)) and
                ha == hb and a.rounds == b.rounds and
                all(bool((getattr(ga, f).cpu() == getattr(gb, f).cpu()
                          ).all()) and getattr(ga, f).shape ==
                    getattr(gb, f).shape
                    for f in ("src", "dst", "weight", "alive")))

    def report(name, alg, n_p, runs):
        for b, m in runs.items():
            busy = "not measured (nvidia-smi gave no sample)" \
                if m["busy"] is None else \
                f"{m['busy']:.1%} (utilization.gpu, mean of {m['kernels']} " \
                f"50 ms samples)"
            peak = "n/a" if m["peak"] is None else \
                f"{m['peak'] / 2 ** 20:.1f} MiB (reserved " \
                f"{m['reserved'] / 2 ** 20:.1f} MiB)"
            res = m["res"]
            rounds = [r.rounds for r in res] if isinstance(res, list) \
                else res.rounds
            batch = "" if not isinstance(res, list) else \
                f"splits {res.splits}, batch.blocks {m['batch_blocks']}, " \
                f"{m['batch_runs']} batched blocks, {m['batch_captures']} " \
                f"batch captures, "
            log(f"blocks {name} ({alg}, n_p={n_p}, "
                f"FCTPU_ROUNDS_BLOCK={b}): wall {m['wall']:.3f}s, "
                f"{rounds} rounds, {batch}{m['blocks']} solo blocks, "
                f"{m['captures']} captures in {m['capture_s']:.3f}s, "
                f"{m['host_calls']} host-node runs, host "
                f"syncs {m['syncs']}, device busy {busy}, peak {peak}, "
                f"launches {m['launches']}, row_totals by shape "
                f"{m['shapes']}")

    def same_launches(name, a, b):
        # a block's sweep runs every member (a stopped one keeps its
        # labels), the eager sweep only those still moving: the same
        # launches at each width, over all the stream's rows
        widths = [{d: sum(c for (_, dd), c in m["shapes"].items()
                          if dd == d) for (_, d) in m["shapes"]}
                  for m in (a, b)]
        check(widths[0] == widths[1] and a["launches"] == b["launches"],
              f"blocks {name}: launches differ: block 8 {a['launches']} "
              f"{a['shapes']}, block 1 {b['launches']} {b['shapes']}")

    t_phase = time.perf_counter()
    timings = state.setdefault("blocks_cases", {})
    for name, edges, n, alg, env, cfg in _block_cases(state):
        t_case = time.perf_counter()

        def call(device, edges=edges, n=n, alg=alg, cfg=cfg):
            return _run(edges, n, device, alg, **cfg)[0]

        runs = {b: one(call, env, b) for b in (8, 1)}
        report(name, alg, cfg["n_p"], runs)
        a, b = runs[8], runs[1]
        check(same(a["res"], b["res"]),
              f"blocks {name}: the block-8 run differs from the block-1 "
              f"run")
        same_launches(name, a, b)
        check(a["blocks"] > 0 and a["captures"] > 0 and b["blocks"] == 0,
              f"blocks {name}: the block-8 run ran {a['blocks']} blocks "
              f"({a['captures']} captures), the block-1 run "
              f"{b['blocks']}")
        if name in ("lfr10k", "leiden 5k planted, hybrid"):
            check(a["launches"]["row_totals"] > 0,
                  f"blocks {name}: row_totals never launched")
        if "fused" in name:
            check(a["launches"]["fused_move_rows"] > 0,
                  "blocks fused: fused_move_rows never launched")
        if alg in HOST_ALGS:
            # one host-node run a round that detects; none a step after
            # the run converged, and none one round a host step
            check(a["host_calls"] == a["res"].rounds and
                  b["host_calls"] == 0,
                  f"blocks {name}: {a['host_calls']} host-node runs for "
                  f"{a['res'].rounds} rounds at block 8, "
                  f"{b['host_calls']} at block 1")
        if name == "cnm emailEu stand-in":
            c = one(call, env, 8, device="cpu")
            check(same(a["res"], c["res"], exact=False),
                  f"blocks {name}: the card's block differs from the "
                  f"port's CPU run")
            log(f"blocks {name}: the card's block-8 run equals the port's "
                f"CPU run (block 8) in partitions, slab and integer "
                f"history; float fields equal: "
                f"{same(a['res'], c['res'])} ({c['wall']:.2f}s on the "
                f"CPU)")
        if name == "karate":
            c = one(call, env, 8, device="cpu")
            check(same(a["res"], c["res"], exact=False),
                  "blocks karate: the card's block differs from the CPU's")
            gap = max((abs(x - y) for ha, hc in zip(a["res"].history,
                                                     c["res"].history)
                       for k in floats for x, y in zip(
                           np.ravel(ha[k]), np.ravel(hc[k]))), default=0.0)
            log(f"blocks karate: the card's block-8 run equals the CPU's "
                f"in partitions, slab and integer history (float fields "
                f"within {gap:.3g}; {c['blocks']} blocks, {c['wall']:.2f}s "
                f"on the CPU)")
        timings[name] = time.perf_counter() - t_case
        log(f"blocks {name}: equal, {timings[name]:.2f}s")
    engine.BatchBlock.run = counted("run", orig[0])
    engine.BatchBlock._capture = counted("capture", orig[1])
    try:
        for name, slabs, n_closure, alg, env, cfg in \
                _batch_block_cases(state):
            t_case = time.perf_counter()
            det = get_detector(alg)
            config = ConsensusConfig(algorithm=alg, **cfg)

            def call(device, slabs=slabs, n_closure=n_closure, det=det,
                     config=config):
                return run_consensus_batch(slabs, det, config,
                                           n_closure=n_closure,
                                           seeds=BATCH_SEEDS)

            runs = {b: one(call, env, b) for b in (8, 1)}
            report(name, alg, cfg["n_p"], runs)
            a, b = runs[8], runs[1]
            check(a["res"].splits == b["res"].splits and
                  all(same(x, y) for x, y in zip(a["res"], b["res"])),
                  f"blocks {name}: the block-8 batch differs from the "
                  f"block-1 batch")
            same_launches(name, a, b)
            check(a["batch_runs"] > 0 and b["batch_runs"] == 0,
                  f"blocks {name}: the block-8 batch ran {a['batch_runs']} "
                  f"batched blocks, the block-1 batch {b['batch_runs']}")
            check(a["batch_captures"] <= 1,
                  f"blocks {name}: {a['batch_captures']} captures of the "
                  f"batched round in one run")
            if "planted" in name:
                check(a["launches"]["row_totals"] > 0,
                      f"blocks {name}: row_totals never launched")
            if alg in HOST_ALGS:
                # one host-node run a batched round, for every job it runs
                want = max(r.rounds for r in a["res"])
                check(not a["res"].splits and a["host_calls"] == want and
                      b["host_calls"] == 0,
                      f"blocks {name}: {a['host_calls']} host-node runs for "
                      f"{want} batched rounds, splits {a['res'].splits}")
            timings[name] = time.perf_counter() - t_case
            log(f"blocks {name}: equal, {timings[name]:.2f}s")
    finally:
        engine.BatchBlock.run, engine.BatchBlock._capture = orig
    log(f"blocks: every case bitwise equal between block 8 and block 1 in "
        f"{time.perf_counter() - t_phase:.2f}s")
    # the closed graphs' pools stay in the allocator's cache: hand them
    # back before the phases that measure memory
    torch.cuda.empty_cache()


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
    if state["max_rounds"] != 8:
        log(f"lfr100k: max_rounds cut 8 -> {state['max_rounds']} to fit "
            f"the time limit")
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
    out = cops.partner_draw_batches(key, [srcd], [dstd], [valid_e], n,
                                    capacity, group * n,
                                    cops.scatter_argmax_shards)
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


def phase_mesh(state):
    """lfr100k through ``run_consensus(mesh=)``: louvain with the scatter
    sampler, seed 0, the CLI's tau and delta, n_p 8, 2 rounds; unsharded,
    on a (p=2, e=2) mesh and on a (p=1, e=4) mesh (the MeshWorker's
    layout), each mesh listing this card 4 times, after an unsharded
    warm-up run.  Partitions, rounds,
    integer round stats and the gathered slab over the unsharded capacity
    equal across the three; each sharded run launches row_totals; every
    launched shape checked and timed."""
    import numpy as np
    import torch

    from fastconsensus_tpu_torch import parallel
    from fastconsensus_tpu_torch.ops import row_kernels as rk

    edges, truth, _, _ = cell_inputs("lfr100k", state)
    n = int(truth.shape[0])
    cfg = dict(n_p=state.get("mesh_n_p", 8), tau=0.2, delta=0.02, seed=0,
               max_rounds=state.get("mesh_rounds", 2),
               closure_sampler="scatter")
    log(f"mesh: lfr100k N={n} E={edges.shape[0]}, louvain n_p={cfg['n_p']} "
        f"max_rounds={cfg['max_rounds']} (cut from bench.py's n_p 200 and "
        f"8 rounds to fit the time limit), scatter sampler, seed 0")
    card = torch.device(DEVICE, 0) if DEVICE == "cuda" \
        else torch.device("cpu")
    layouts = [("unsharded", None),
               ("p2_e2", parallel.make_mesh(2, 2, devices=[card] * 4)),
               ("p1_e4", parallel.make_mesh(1, 4, devices=[card] * 4))]
    if DEVICE == "cuda" and torch.cuda.device_count() >= 2:
        # over distinct ordinals: (1, k) as MeshWorker builds it, and
        # (2, k // 2), whose second ensemble shard detects (and launches
        # row_totals) on a card that is not the current device
        k = torch.cuda.device_count()
        gpus = [torch.device("cuda", i) for i in range(k)]
        layouts += [(f"p1_e{k}_distinct", parallel.make_mesh(
                        1, k, devices=gpus)),
                    (f"p2_e{k // 2}_distinct", parallel.make_mesh(
                        2, k // 2, devices=gpus))]
    else:
        log("mesh: the runs over distinct GPUs did not happen: this "
            "machine has one card")
    # a warm-up run first: the first run in a process pays the
    # allocator's and the kernels' first use, which no layout should
    _, wall, _ = _run(edges, n, DEVICE, **cfg)
    log(f"mesh: warm-up run (unsharded, not compared) {wall:.2f}s")
    runs = {}
    shapes_all = {}
    cards = range(torch.cuda.device_count() if DEVICE == "cuda" else 0)
    for name, mesh in layouts:
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)
        rk.reset_launches()
        res, wall, per_round = _run(edges, n, DEVICE,
                                    run_kw={"mesh": mesh}, **cfg)
        launches = rk.LAUNCHES["row_totals"]
        shapes = dict(rk.ROW_TOTALS_SHAPES)
        for s, c in shapes.items():
            shapes_all[s] = shapes_all.get(s, 0) + c
        by_card = [torch.cuda.max_memory_allocated(i) for i in cards]
        peak = max(by_card) if by_card else None
        runs[name] = res
        log(f"mesh {name}: shape {None if mesh is None else mesh.shape} "
            f"rounds={res.rounds} converged={res.converged} "
            f"wall={wall:.2f}s per_round={[round(x, 3) for x in per_round]} "
            f"max_memory_allocated={peak} by_card={by_card} "
            f"row_totals_launches={launches} "
            f"by_shape={sorted(shapes.items())} capacity="
            f"{res.graph.capacity}")
        if mesh is not None:
            check(launches > 0, f"mesh {name} never launched row_totals")
        state.setdefault("mesh", {})[name] = dict(
            wall_s=wall, per_round_s=per_round, max_memory_allocated=peak,
            row_totals_launches=launches)
    base = runs["unsharded"]
    c = base.graph.capacity
    for name, res in runs.items():
        check(res.rounds == base.rounds and res.converged == base.converged,
              f"mesh {name}: rounds {res.rounds} != {base.rounds}")
        check(np.array_equal(np.stack(res.partitions),
                             np.stack(base.partitions)),
              f"mesh {name}: partitions differ from the unsharded run's")
        check(len(res.history) == len(base.history) and all(
            a[k] == b[k] for a, b in zip(res.history, base.history)
            # a mesh pads the capacity to a multiple of its edge axis
            for k in HISTORY_INTS if k != "capacity"),
            f"mesh {name}: integer round stats differ")
        g = res.graph
        check(all(torch.equal(getattr(g, f)[:c].to(card),
                              getattr(base.graph, f))
                  for f in ("src", "dst", "weight", "alive"))
              and not bool(g.alive[c:].any()),
              f"mesh {name}: the gathered slab differs")
    log(f"mesh: {len(runs)} layouts bitwise equal (partitions, rounds, "
        f"integer stats, slab over {c} slots)")
    state["mesh_unsharded"] = _host_result(base)
    log(f"mesh: {smi_line()}")
    per_shape = check_and_time_shapes(shapes_all, seed=4)
    state.setdefault("main_paths", {})["mesh"] = dict(
        launches=sum(shapes_all.values()), by_shape=per_shape)


def _host_result(res) -> dict:
    """A consensus result's partitions, rounds, history and gathered
    slab, on the host."""
    import numpy as np

    g = res.graph
    return dict(partitions=np.stack(res.partitions), rounds=res.rounds,
                converged=res.converged, history=res.history,
                **{f: getattr(g, f).cpu().numpy()
                   for f in ("src", "dst", "weight", "alive")})


def _check_same_result(what, got, base):
    """``got`` against ``base`` (host results): partitions, rounds,
    integer round stats and the slab over ``base``'s capacity, bitwise;
    the slots past it dead."""
    import numpy as np

    check(int(got["rounds"]) == base["rounds"] and
          bool(got["converged"]) == base["converged"],
          f"{what}: rounds {got['rounds']} != {base['rounds']}")
    check(np.array_equal(got["partitions"], base["partitions"]),
          f"{what}: partitions differ from the unsharded run's")
    check(len(got["history"]) == len(base["history"]) and all(
        a[k] == b[k] for a, b in zip(got["history"], base["history"])
        for k in HISTORY_INTS if k != "capacity"),
        f"{what}: integer round stats differ")
    c = base["src"].shape[0]
    check(all(np.array_equal(got[f][:c], base[f])
              for f in ("src", "dst", "weight", "alive"))
          and not got["alive"][c:].any(), f"{what}: the gathered slab differs")


MP_LAYOUTS = (("p2_e2", (2, 2)), ("p1_e4", (1, 4)))
MP_RANK_TIMEOUT_S = 300.0


def _mp_launch(tag, world, backend, layouts, state, cfg):
    """Start ``world`` ranks of this script (``--mp-spec``), joined by a
    file rendezvous under OUT: ``(procs, spec dir)``."""
    d = OUT / f"mp_{tag}"
    if d.exists():
        for f in d.iterdir():
            f.unlink()
    d.mkdir(parents=True, exist_ok=True)
    spec = dict(world=world, backend=backend, device=DEVICE,
                init=f"file://{d / 'rendezvous'}", out=str(d), cfg=cfg,
                layouts=layouts, nodes=state.get("nodes"))
    (d / "spec.json").write_text(json.dumps(spec))
    procs = []
    for r in range(world):
        with open(d / f"rank{r}.log", "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--mp-spec",
                 str(d / "spec.json"), "--mp-rank", str(r)],
                cwd=str(ROOT), stdout=fh, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONUNBUFFERED="1")))
    return procs, d


def _mp_wait(what, procs, d, t0, expect_rc=0):
    """Every rank's exit within MP_RANK_TIMEOUT_S of ``t0``, each with
    ``expect_rc``; a rank that times out is killed with the others and
    fails the phase, naming it."""
    bad = []
    for r, p in enumerate(procs):
        try:
            rc = p.wait(timeout=max(1.0, MP_RANK_TIMEOUT_S -
                                    (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            bad.append(f"rank {r} timed out after {MP_RANK_TIMEOUT_S:.0f}s")
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
            continue
        if rc != expect_rc:
            bad.append(f"rank {r} exited {rc}")
    if bad:
        tails = "\n".join(f"--- rank {r}: " + (d / f"rank{r}.log")
                          .read_text()[-2000:] for r in range(len(procs)))
        raise PhaseError(f"{what}: {'; '.join(bad)}\n{tails}")


def _mp_load(d, name, rank):
    """A rank's result, read and then deleted (a slab a rank: they would
    overflow chiprun_out/)."""
    import numpy as np

    path = d / f"{name}_r{rank}.npz"
    with np.load(path) as z:
        out = dict(z)
    path.unlink()
    out["history"] = json.loads(bytes(out["history"]).decode())
    out["shapes"] = {(int(r), int(w)): int(c) for r, w, c in out["shapes"]}
    return out


def phase_multiprocess(state):
    """lfr100k through ``run_consensus(mesh=)`` run SPMD by 4 rank
    processes on this one card over ``gloo``, each owning one cell, in
    layouts (p=2, e=2) and (p=1, e=4), with phase mesh's settings: every
    rank's result bitwise equal to phase mesh's unsharded run (run here
    when mesh did not run); each rank's wall, peak memory and launches;
    every detecting rank must launch row_totals; the launched shapes
    checked and timed.  Two ranks asking for NCCL on one card must be
    refused naming it; with two or more cards, one rank per card over
    NCCL runs (p=1, e=count) as well."""
    import torch

    edges, truth, _, _ = cell_inputs("lfr100k", state)
    n = int(truth.shape[0])
    cfg = dict(n_p=state.get("mesh_n_p", 8), tau=0.2, delta=0.02, seed=0,
               max_rounds=state.get("mesh_rounds", 2),
               closure_sampler="scatter")
    if "mesh_unsharded" not in state:
        res, wall, _ = _run(edges, n, DEVICE, **cfg)
        log(f"multiprocess: the unsharded run (phase mesh did not run) "
            f"{wall:.2f}s")
        state["mesh_unsharded"] = _host_result(res)
    base = state["mesh_unsharded"]
    cards = torch.cuda.device_count() if DEVICE == "cuda" else 0
    log("multiprocess: 4 ranks on this one card over backend='gloo', "
        "passed explicitly: NCCL refuses two ranks on one GPU, and gloo "
        "carries the collectives through the host; lfr100k "
        f"N={n} E={edges.shape[0]}, louvain n_p={cfg['n_p']} "
        f"max_rounds={cfg['max_rounds']}, scatter sampler, seed 0")
    t0 = time.perf_counter()
    launches = [("gloo", 4, "gloo", MP_LAYOUTS, 0)]
    if cards >= 2:
        launches.append(("nccl", cards, "nccl",
                         ((f"p1_e{cards}_nccl", (1, cards)),), 0))
    elif DEVICE == "cuda":
        # two ranks on one card under NCCL: each must refuse by name
        launches.append(("nccl_refused", 2, "nccl", (), 3))
    started = [(tag, world, layouts, rc) + _mp_launch(
                   tag, world, backend, layouts, state, cfg)
               for tag, world, backend, layouts, rc in launches]
    if cards < 2:
        log("multiprocess: one rank per card over NCCL did not happen: "
            "this machine has one card")
    for tag, world, layouts, rc, procs, d in started:
        _mp_wait(f"multiprocess {tag}", procs, d, t0, expect_rc=rc)
    log(f"multiprocess: every launch ended in {time.perf_counter() - t0:.2f}s"
        f" (rank start-up included)")
    for tag, world, layouts, rc, procs, d in started:
        for r in range(world):
            for line in (d / f"rank{r}.log").read_text().splitlines():
                if line.startswith(f"rank {r}: "):
                    log(f"multiprocess {tag} {line}")
    shapes_all = {}
    total = 0
    for tag, world, layouts, rc, procs, d in started:
        if rc:
            msgs = [(d / f"rank{r}.log").read_text() for r in range(world)]
            check(all("backend 'nccl' cannot serve" in m for m in msgs),
                  f"multiprocess {tag}: a rank was not refused by name")
            log(f"multiprocess {tag}: both ranks refused: " + next(
                line for line in msgs[0].splitlines()
                if "backend 'nccl' cannot serve" in line).strip())
            continue
        for name, (p, e) in layouts:
            for r in range(world):
                got = _mp_load(d, name, r)
                what = f"multiprocess {tag} {name} rank {r}"
                _check_same_result(what, got, base)
                detects = bool(len(got["local_blocks"]))
                launched = int(got["launches"])
                log(f"{what}: blocks {got['local_blocks'].tolist()} chunks "
                    f"{got['local_chunks'].tolist()} "
                    f"join={float(got['join_s']):.2f}s "
                    f"wall={float(got['wall_s']):.2f}s per_round="
                    f"{[round(float(x), 3) for x in got['per_round_s']]} "
                    f"max_memory_allocated={int(got['peak'])} "
                    f"detect_s={float(got['detect_s']):.2f} "
                    f"collectives={int(got['coll_calls'])} in "
                    f"{float(got['coll_s']):.2f}s "
                    f"row_totals_launches={launched} "
                    f"by_shape={sorted(got['shapes'].items())}")
                if DEVICE == "cuda" and detects:
                    check(launched > 0, f"{what} detects but never launched "
                                        f"row_totals")
                total += launched
                for s, c in got["shapes"].items():
                    shapes_all[s] = shapes_all.get(s, 0) + c
                state.setdefault("multiprocess", {})[f"{tag}_{name}_r{r}"] = \
                    dict(wall_s=float(got["wall_s"]),
                         max_memory_allocated=int(got["peak"]),
                         row_totals_launches=launched)
    log(f"multiprocess: every rank of every layout bitwise equal to the "
        f"unsharded run (partitions, rounds, integer stats, slab over "
        f"{base['src'].shape[0]} slots)")
    log(f"multiprocess: {smi_line()}")
    if DEVICE == "cuda":
        check(total > 0, "multiprocess never launched row_totals")
    per_shape = check_and_time_shapes(shapes_all, seed=5)
    state.setdefault("main_paths", {})["multiprocess"] = dict(
        launches=total, by_shape=per_shape)


def mp_rank_main(spec_path: str, rank: int) -> int:
    """One rank of phase multiprocess: join the group, run each layout
    of the spec, write its result to ``{name}_r{rank}.npz``.  A refused
    join exits 3."""
    global DEVICE
    import numpy as np
    import torch

    from fastconsensus_tpu_torch import consensus, parallel
    from fastconsensus_tpu_torch.ops import row_kernels as rk
    from fastconsensus_tpu_torch.parallel import collectives as coll

    spent = {"detect_s": 0.0, "coll_s": 0.0, "coll_calls": 0}
    slowest = []

    def timed(fn, key, calls=None):
        """``fn`` adding its seconds to ``spent[key]`` (host clock, after a
        sync: the collectives and the detection block on the card); with
        ``calls``, the slowest calls' seconds and shapes kept."""
        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            dt = time.perf_counter() - t
            spent[key] += dt
            if calls:
                spent[calls] += 1
                slowest.append((dt, spent[calls], list(out[0].shape),
                                str(out[0].dtype)))
                slowest.sort(reverse=True)
                del slowest[4:]
            return out
        return call

    # where a rank's wall goes: every exchange between processes passes
    # through gather_shards, every detection through _detect_chunked
    coll.gather_shards = timed(coll.gather_shards, "coll_s", "coll_calls")
    consensus._detect_chunked = timed(consensus._detect_chunked, "detect_s")
    spec = json.loads(Path(spec_path).read_text())
    DEVICE = spec["device"]
    t0 = time.perf_counter()
    try:
        parallel.initialize_multihost(spec["init"], spec["world"], rank,
                                      backend=spec["backend"])
    except RuntimeError as e:
        if "backend 'nccl' cannot serve" not in str(e):
            raise
        print(f"rank {rank}: {e}", flush=True)
        return 3
    join_s = time.perf_counter() - t0
    try:
        edges, truth, _, _ = cell_inputs("lfr100k", {
            "n_p": spec["cfg"]["n_p"], "max_rounds": spec["cfg"]
            ["max_rounds"], "nodes": spec["nodes"]})
        n = int(truth.shape[0])
        card = torch.device("cuda", torch.cuda.current_device()) \
            if DEVICE == "cuda" else torch.device("cpu")
        for name, (p, e) in spec["layouts"]:
            mesh = parallel.make_mesh(p, e, devices=[card])
            reset_peak()
            rk.reset_launches()
            spent.update(detect_s=0.0, coll_s=0.0, coll_calls=0)
            slowest.clear()
            res, wall, per_round = _run(edges, n, DEVICE,
                                        run_kw={"mesh": mesh}, **spec["cfg"])
            launched = rk.LAUNCHES["row_totals"]
            shapes = sorted(rk.ROW_TOTALS_SHAPES.items())
            peak = read_peak()
            host = _host_result(res)
            host["history"] = np.frombuffer(
                json.dumps(host["history"]).encode(), np.uint8)
            np.savez(Path(spec["out"]) / f"{name}_r{rank}.npz", **host,
                     wall_s=wall, per_round_s=np.asarray(per_round),
                     join_s=join_s, peak=-1 if peak is None else peak,
                     **spent,
                     launches=launched,
                     shapes=np.asarray([(r, d, c) for (r, d), c in shapes],
                                       np.int64).reshape(-1, 3),
                     local_blocks=np.asarray(mesh.local_blocks(), np.int64),
                     local_chunks=np.asarray(mesh.local_chunks(), np.int64))
            print(f"rank {rank}: {name} wall {wall:.2f}s; slowest "
                  f"collectives (s, call, shape, dtype) "
                  f"{[(round(t, 4), c, sh, dt) for t, c, sh, dt in slowest]}",
                  flush=True)
    finally:
        parallel.shutdown_multihost()
    return 0


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


def _cli_run(args, alg, timings=None):
    """The port's CLI on ``args``, as a user runs it, with the consensus
    result it computed captured and two layers timed: the host C++ call of
    each detection (cnm, infomap) and each consensus tail, both
    synchronized.  Returns ``(result, wall s, host s per call, tail s per
    call)``; ``timings`` (a dict) receives ``run_s``, the synchronized
    seconds of ``run_consensus`` alone."""
    from fastconsensus_tpu_torch import cli, consensus, engine, native

    host_s, tail_s, results = [], [], []

    def timed(calls, fn):
        import torch

        def wrapper(*a, **k):
            if DEVICE == "cuda" and torch.cuda.is_current_stream_capturing():
                # a fused block's tail being captured: no sync, no time
                return fn(*a, **k)
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            calls.append(time.perf_counter() - t0)
            return out
        return wrapper

    def capture(fn):
        def wrapper(*a, **k):
            sync()
            t0 = time.perf_counter()
            results.append(fn(*a, **k))
            sync()
            if timings is not None:
                timings["run_s"] = time.perf_counter() - t0
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
    _check_same_trees(what, a_out, b_out)


def _check_same_trees(what, a_out, b_out):
    """The output trees under two --out-dir directories are equal."""
    import filecmp

    trees = sorted(p.name for p in a_out.iterdir())
    check(trees and trees == sorted(p.name for p in b_out.iterdir()),
          f"{what}: output trees {trees}")
    for tree in trees:
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

def _wait_for(what, cond, proc=None, timeout: float = 300.0):
    """Poll ``cond()`` until true; fail if ``proc`` exits first."""
    t_end = time.monotonic() + timeout
    while not cond():
        check(proc is None or proc.poll() is None,
              f"{what}: the run exited ({proc.returncode if proc else ''}) "
              f"first")
        check(time.monotonic() < t_end, f"{what}: timed out")
        time.sleep(0.01)


def phase_recovery(state):
    """Elastic recovery through the CLI on the card: Louvain, n_p 8, seed
    11, forced hybrid rows on gpu_cpu's planted 5k graph, 4 rounds,
    FCTPU_DETECT_CALL_MEMBERS=2.  A process run with --checkpoint
    --resume --detect-cache --trace-jsonl --trace --dump-on-signal is sent
    SIGQUIT once round 2's second chunk is on disk (a fcflight bundle
    must name its detect cache), then SIGKILL; the same command restarted
    under the supervisor must reuse cached chunks and write the output
    trees of an uninterrupted run.  Before it, the uninterrupted run and
    the same run with a fresh chunk cache at the default chunking run
    here: the cache's cost a detection."""
    import json as _json
    import shutil
    import signal

    from fastconsensus_tpu_torch.obs import postmortem
    from fastconsensus_tpu_torch.ops import row_kernels as rk

    edges, _ = planted_graph(5000, 40, 0.08, 0.0004, seed=7, hubs=10,
                             hub_degree=600)
    base = OUT / "recovery"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    path = _write_edgelist(edges, base / "planted5k.txt")
    run_args = ["-f", path, "--alg", "louvain", "-np", 8, "--seed", 11,
                "--max-rounds", 4, "--quiet", "--device", DEVICE]
    knobs = {"FCTPU_MOVE_PATH": "hybrid", "FCTPU_DETECT_CALL_MEMBERS": "2"}
    cache, flight = base / "cache", base / "fcflight"
    trace = base / "trace.json"
    cmd = [sys.executable, "-m", "fastconsensus_tpu_torch.cli"] + [
        str(a) for a in run_args + [
            "--out-dir", base / "out", "--checkpoint", base / "ck.npz",
            "--resume", "--detect-cache", cache, "--trace-jsonl",
            base / "rounds.jsonl", "--trace", trace, "--dump-on-signal"]]
    env = dict(os.environ, **knobs, FCTPU_FLIGHT_DIR=str(flight))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    for d in ("out", "full", "cached"):
        (base / d).mkdir()
    os.environ.update(knobs)
    try:
        rk.reset_launches()
        full, full_s, _, _ = _cli_run(
            run_args + ["--out-dir", base / "full"], "louvain")
        launches = dict(rk.LAUNCHES)
        shapes = dict(rk.ROW_TOTALS_SHAPES)
        # the cache's own cost: the driver's default chunking
        os.environ.pop("FCTPU_DETECT_CALL_MEMBERS")
        _, cached_s, _, _ = _cli_run(
            run_args + ["--out-dir", base / "cached", "--detect-cache",
                        base / "cache_fresh"], "louvain")
    finally:
        for k in knobs:
            os.environ.pop(k, None)
    t0 = time.perf_counter()
    with open(base / "killed.log", "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                stdout=subprocess.DEVNULL, stderr=err)
        try:
            _wait_for("round 0's first chunk",
                      lambda: any(cache.glob("*_r0_c0.npy")), proc)
            first_chunk_s = time.perf_counter() - t0
            _wait_for("round 2's second chunk",
                      lambda: any(cache.glob("*_r2_c1.npy")), proc)
            proc.send_signal(signal.SIGQUIT)
            _wait_for("the fcflight bundle",
                      lambda: postmortem.list_bundles(str(flight)), proc,
                      timeout=60)
        finally:
            proc.kill()
            proc.wait()
    killed_s = time.perf_counter() - t0
    check(launches["row_totals"] > 0, "recovery never launched row_totals")
    _check_same_trees("recovery: the cached run against the uninterrupted "
                      "run", base / "full", base / "cached")
    bundle = Path(postmortem.list_bundles(str(flight))[0])
    named = _json.loads((bundle / "run.json").read_text())["detect_cache"]
    check(named == str(cache), f"bundle names detect_cache {named!r}")
    on_disk = sorted(p.name for p in cache.glob("*.npy"))
    sup = [sys.executable, "-m", "fastconsensus_tpu_torch.utils.supervise",
           "--progress", str(base / "rounds.jsonl"), "--poll-seconds",
           "0.5", "--recover-seconds", "0", "--rotate", str(trace),
           "--rotate", f"{trace}.jsonl", "--"] + cmd
    t0 = time.perf_counter()
    out = subprocess.run(sup, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    restart_s = time.perf_counter() - t0
    (base / "restart.log").write_text(out.stdout + out.stderr)
    check(out.returncode == 0, f"supervised restart exit {out.returncode}")
    _check_same_trees("recovery: restart against the uninterrupted run",
                      base / "full", base / "out")
    lines = [_json.loads(x) for x in
             Path(f"{trace}.jsonl").read_text().splitlines()]
    counters = [x for x in lines if x.get("kind") == "counters"][-1][
        "counters"]
    check(counters.get("detect.chunks_cached", 0) >= 1,
          f"the restart loaded no cached chunk: {counters}")
    log(f"recovery: uninterrupted {full.rounds} rounds in {full_s:.2f}s, "
        f"with the chunk cache (default chunks) {cached_s:.2f}s, "
        f"{(cached_s - full_s) / (full.rounds + 1) * 1e3:.1f} ms a "
        f"detection; killed (SIGQUIT, bundle {bundle.name} naming the "
        f"cache, then SIGKILL) after {killed_s:.2f}s (its first chunk on "
        f"disk at {first_chunk_s:.2f}s) with {len(on_disk)} chunk files on "
        f"disk; supervised restart {restart_s:.2f}s: detect.chunks "
        f"{counters.get('detect.chunks', 0)}, detect.chunks_cached "
        f"{counters['detect.chunks_cached']}, rounds.total "
        f"{counters.get('rounds.total')}; output trees equal; launches "
        f"{launches} (uninterrupted run)")
    state["recovery"] = dict(full_s=full_s, cached_s=cached_s,
                             killed_s=killed_s, restart_s=restart_s,
                             cached_chunks=counters["detect.chunks_cached"])
    state.setdefault("main_paths", {})["recovery"] = dict(
        launches=launches["row_totals"],
        by_shape=check_and_time_shapes(shapes, seed=7))


def _timed_calls(spots, sink):
    """Patch each ``(owner, attribute)`` callable in ``spots`` so its
    calls add their seconds to ``sink[attribute]``; returns the
    ``ExitStack`` that restores them."""
    import contextlib
    from unittest import mock

    def timed(name, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                sink[name] = sink.get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    stack = contextlib.ExitStack()
    for owner, attr in spots:
        stack.enter_context(mock.patch.object(
            owner, attr, timed(attr, getattr(owner, attr))))
    return stack


def phase_trace(state):
    """fcobs on the card through the CLI: the planted 5k graph (forced
    hybrid rows), Louvain, n_p 8, 2 rounds, with the tracer disabled,
    enabled (--trace), and enabled with --profile-dir: the Perfetto
    file's spans, its device track and where row_totals ran, the JSONL
    counters and the device-memory gauge."""
    import json as _json
    import shutil

    import torch

    from fastconsensus_tpu_torch.obs import device as obs_device
    from fastconsensus_tpu_torch.obs import export as obs_export
    from fastconsensus_tpu_torch.ops import row_kernels as rk

    edges, _ = planted_graph(5000, 40, 0.08, 0.0004, seed=7, hubs=10,
                             hub_degree=600)
    base = OUT / "trace"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    path = _write_edgelist(edges, base / "planted5k.txt")
    run_args = ["-f", path, "--alg", "louvain", "-np", 8, "--seed", 11,
                "--max-rounds", 2, "--quiet", "--device", DEVICE]
    trace = base / "t.json"
    walls, runs = {}, {}
    os.environ["FCTPU_MOVE_PATH"] = "hybrid"
    try:
        # off and on in turns, then the profiled run
        for tag, extra in (("disabled", []),
                           ("enabled", ["--trace", base / "e.json"]),
                           ("enabled2", ["--trace", base / "e.json"]),
                           ("disabled2", []),
                           ("profiled", ["--trace", trace, "--profile-dir",
                                         base / "prof"])):
            (base / tag).mkdir()
            if tag == "profiled":
                rk.reset_launches()
                reset_peak()
            runs[tag] = {}
            # the profiled run's export, step by step
            spots = [(torch.profiler.profile, "__exit__"),
                     (torch.profiler.profile, "export_chrome_trace"),
                     (obs_device, "load_trace_events"),
                     (obs_device, "finalize_merge"),
                     (obs_export, "write_perfetto_blob")]
            export_s = {}
            with _timed_calls(spots if tag == "profiled" else [], export_s):
                res, walls[tag], _, _ = _cli_run(
                    run_args + ["--out-dir", base / tag] + extra, "louvain",
                    runs[tag])
        launches = dict(rk.LAUNCHES)
        shapes = dict(rk.ROW_TOTALS_SHAPES)
        peak = read_peak()
    finally:
        os.environ.pop("FCTPU_MOVE_PATH", None)
    check(launches["row_totals"] > 0, "trace run never launched row_totals")
    blob = _json.loads(trace.read_text())
    fc = [e for e in blob["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "fcobs"]
    check([e["ts"] for e in fc] == sorted(e["ts"] for e in fc),
          "fcobs spans out of ts order")
    first = {}
    for e in fc:
        first.setdefault(e["name"], e["ts"])
    want = ["round", "detect", "tail", "final_detect"]
    check(all(n in first for n in want) and
          [first[n] for n in want] == sorted(first[n] for n in want),
          f"fcobs spans {sorted(first)}: expected {want} in ts order")
    attrib = blob["otherData"]["device_attribution"]
    check(attrib.get("device_track") is True,
          f"the profiled trace has no device track: {attrib}")
    lo = min(e["ts"] for e in fc)
    hi = max(e["ts"] + e["dur"] for e in fc)
    kern = [e for e in blob["traceEvents"] if e.get("cat") == "kernel" and
            "row_totals" in str(e.get("name", ""))]
    check(kern, "no row_totals kernel event in the profiled trace")
    k_lo = min(e["ts"] for e in kern)
    k_hi = max(e["ts"] + e.get("dur", 0) for e in kern)
    check(lo - 5e4 <= k_lo and k_hi <= hi + 5e4,
          f"row_totals events [{k_lo}, {k_hi}] us outside the run's spans "
          f"[{lo}, {hi}] us by more than 50 ms")
    lines = [_json.loads(x) for x in
             Path(f"{trace}.jsonl").read_text().splitlines()]
    counters = [x for x in lines if x.get("kind") == "counters"][-1]
    check(counters["counters"].get("rounds.total") == res.rounds,
          f"rounds.total {counters['counters'].get('rounds.total')} != "
          f"{res.rounds}")
    gauge = blob["otherData"]["counters"]["gauges"].get(
        "device_mem.peak_bytes_in_use")
    check(DEVICE != "cuda" or gauge == peak,
          f"device_mem.peak_bytes_in_use {gauge} != max_memory_allocated "
          f"{peak}")
    run_s = {k: v["run_s"] for k, v in runs.items()}
    log(f"trace: {res.rounds} rounds; run_consensus wall in turns: tracer "
        f"disabled {run_s['disabled']:.3f}s, enabled "
        f"{run_s['enabled']:.3f}s, enabled {run_s['enabled2']:.3f}s, "
        f"disabled {run_s['disabled2']:.3f}s; enabled with --profile-dir "
        f"{run_s['profiled']:.3f}s (CLI walls, export included: "
        f"{', '.join(f'{walls[t]:.3f}s' for t in runs)}); "
        f"{len(fc)} fcobs spans, {len(kern)} row_totals kernel events in "
        f"[{(k_lo - lo) / 1e3:.1f}, {(k_hi - lo) / 1e3:.1f}] ms of the "
        f"spans' [0, {(hi - lo) / 1e3:.1f}] ms; device_attribution "
        f"{attrib}; device_mem.peak_bytes_in_use {gauge} == "
        f"max_memory_allocated {peak}; launches {launches}")
    log(f"trace: the profiled run's export, seconds: profiler stop "
        f"{export_s.get('__exit__', 0):.3f}, export_chrome_trace "
        f"{export_s.get('export_chrome_trace', 0):.3f}, merge "
        f"{export_s.get('finalize_merge', 0):.3f} (of it loading the "
        f"profiler's file {export_s.get('load_trace_events', 0):.3f}), "
        f"writing the Perfetto file "
        f"{export_s.get('write_perfetto_blob', 0):.3f}")
    state["trace_walls"] = dict(cli=walls, run=run_s, export=export_s)
    # the profiler's trace and the merged file run to hundreds of MB
    shutil.rmtree(base / "prof")
    trace.unlink()
    state.setdefault("main_paths", {})["trace"] = dict(
        launches=launches["row_totals"],
        by_shape=check_and_time_shapes(shapes, seed=8))



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


BATCH_SEEDS = [11, 22, 33, 44]


def _batch_cfg(state) -> dict:
    """The ConsensusConfig fields of phase batch's jobs (and of phase
    serve's batch A), seeds apart."""
    return dict(n_p=state.get("batch_n_p", 20), tau=0.2, delta=0.02,
                closure_tau=0.2, max_rounds=state.get("batch_rounds", 6))


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
    intervals (None when the profiler shows no device time).  The
    intervals come from the profiler's raw records: building its event
    tree (``prof.events()``) over the ~0.2 M kernels of a batch run
    takes tens of seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == cuda]
    return wall, (_busy(spans) / 1e9 if spans else None), len(spans)


def _device_utilization(fn):
    """``fn()`` with ``nvidia-smi`` sampling the card's utilization.gpu
    every 50 ms (the share of each of NVML's sample periods, 1/6 s
    to 1 s, in which a kernel ran): ``(wall s, mean utilization in [0, 1]
    or None, samples)``.  A profiler trace would give the busy share
    exactly, but collecting the ~0.4 M kernel records of an lfr10k run
    takes it tens of seconds."""
    import statistics

    sync()
    try:
        proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-i", "0", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        proc = None
    try:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    finally:
        out = ""
        if proc is not None:
            proc.terminate()
            try:
                out, _ = proc.communicate(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
    samples = [float(x) for x in out.split() if x.strip().isdigit()]
    return wall, (statistics.fmean(samples) / 100 if samples else None), \
        len(samples)


def _busy(spans) -> float:
    """The time during which at least one kernel ran: the length of the
    union of the ``(start, end)`` intervals ``spans``, in their unit."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def phase_memory(state):
    """Each sweep path's memory model against the card: one detect call
    of M members (one chunk), after a one-member warm-up that leaves the
    device's persistent buffers in the baseline; the peak allocated over
    the baseline, per member, must not exceed the model, which must not
    exceed twice it."""
    import dataclasses

    import torch

    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.models import leiden as ld
    from fastconsensus_tpu_torch.models import louvain as lv
    from fastconsensus_tpu_torch.models import lpm
    from fastconsensus_tpu_torch.utils import prng

    m, sweeps = 8, 4
    planted = planted_graph(5000, 40, 0.08, 0.0004, seed=7, hubs=10,
                            hub_degree=600)[0]
    email = cell_inputs("lpm_emaileu", state)[0]
    lfr_edges, lfr_truth = cell_inputs("lfr100k", state)[:2]
    p5k = pack_edges(planted, 5000, device=DEVICE)
    louvain = lv.make_louvain(max_sweeps=sweeps)
    cases = (
        ("matmul", "emailEu stand-in", None,
         pack_edges(email, 1005, device=DEVICE), louvain,
         lv.sweep_temp_bytes),
        ("dense", "5k planted", "dense", p5k, louvain, lv.sweep_temp_bytes),
        ("hybrid", "5k planted", "hybrid", p5k, louvain,
         lv.sweep_temp_bytes),
        ("lfr100k", "lfr100k", None,
         pack_edges(lfr_edges, int(lfr_truth.shape[0]), device=DEVICE),
         louvain, lv.sweep_temp_bytes),
        ("hash", "5k planted, budgets zeroed", None,
         dataclasses.replace(p5k, d_cap=0, d_hyb=0, hub_cap=0), louvain,
         lv.sweep_temp_bytes),
        ("leiden", "5k planted, hybrid rows", "hybrid", p5k,
         ld.make_leiden(max_sweeps=2 * sweeps), ld.member_bytes),
        ("lpm dense vote", "emailEu stand-in", None,
         pack_edges(email, 1005, device=DEVICE),
         lpm.make_lpm(max_iters=sweeps), lpm.member_bytes))
    keys = prng.partition_keys(prng.key(5, DEVICE), m)
    rows = []
    os.environ["FCTPU_ENSEMBLE_CHUNK"] = str(m)
    try:
        for name, graph, forced, slab, det, model_fn in cases:
            if forced:
                os.environ["FCTPU_MOVE_PATH"] = forced
            try:
                path = "dense vote" if model_fn is lpm.member_bytes \
                    else lv.select_move_path(slab)
                model = model_fn(slab)
                det(slab, keys[:1])
                sync()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = det(slab, keys)
                sync()
                secs = time.perf_counter() - t0
                per = (torch.cuda.max_memory_allocated() - base) / m
                del out
            finally:
                os.environ.pop("FCTPU_MOVE_PATH", None)
            log(f"memory {name} ({graph}, {path}, N {slab.n_nodes}, "
                f"capacity {slab.capacity}, d_cap {slab.d_cap}, d_hyb "
                f"{slab.d_hyb}, hub_cap {slab.hub_cap}): {m} members, peak "
                f"over the baseline {per:.0f} bytes a member, model "
                f"{model} ({model / per:.3f}x), {secs:.3f}s")
            rows.append(dict(name=name, path=path, members=m,
                             per_member=per, model=model))
    finally:
        os.environ.pop("FCTPU_ENSEMBLE_CHUNK", None)
    state["memory"] = rows
    bad = [r["name"] for r in rows
           if not r["per_member"] <= r["model"] <= 2 * r["per_member"]]
    check(not bad, f"memory model outside [peak, 2 x peak] for {bad}")


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

    seeds = BATCH_SEEDS
    cfg = ConsensusConfig(algorithm="louvain", **_batch_cfg(state))
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
        solo_s, solo_peak, solo_runs = [], [], []
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
            solo_runs.append((solo.rounds, solo.partitions))
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
        if name == "A":
            # phase serve's batch A jobs are held against these
            state["batch_A_solo"] = {"cfg": _batch_cfg(state),
                                     "runs": solo_runs}
        if name == "A" and DEVICE == "cuda":
            # member chunks within the ensemble budget: the peak is the
            # budget plus the slabs (the padded four and their stack)
            budget = int(os.environ.get("FCTPU_ENSEMBLE_BUDGET_MB", 2048))
            limit = (budget << 20) + 2 * resident
            log(f"batch A: peak {peak} bytes against the {budget} MiB "
                f"member budget plus the slabs twice, {limit} bytes")
            check(peak <= limit, f"batch A peak {peak} > {limit}")
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
            t0 = time.perf_counter()
            b_wall, b_busy, b_n = _device_busy(lambda: run_consensus_batch(
                slabs, det, cfg, n_closure=bucket.n_closure, seeds=seeds))
            s_wall, s_busy, s_n = _device_busy(lambda: [run_consensus(
                slab, det, cfg, key=prng.key(sd, DEVICE),
                n_closure=bucket.n_closure)
                for slab, sd in zip(slabs, seeds)])
            trace_s = time.perf_counter() - t0
            if b_busy is None or s_busy is None:
                log("batch A: the profiler showed no device time; idle "
                    "share not measured")
            else:
                log(f"batch A under torch.profiler (card only): batch wall "
                    f"{b_wall:.3f}s, device busy {b_busy:.3f}s, idle "
                    f"{1 - b_busy / b_wall:.1%}, {b_n} kernels; four solo "
                    f"runs wall {s_wall:.3f}s, busy {s_busy:.3f}s, idle "
                    f"{1 - s_busy / s_wall:.1%}, {s_n} kernels; both "
                    f"traces with their reading {trace_s:.2f}s")


def _served_partitions(partitions, n: int):
    """A run's partitions as the server returns them: the bucket's padding
    nodes sliced off, ids recompacted."""
    import numpy as np

    out = []
    for p in partitions:
        _, compact = np.unique(np.asarray(p)[:n], return_inverse=True)
        out.append(compact.astype(np.int32))
    return out


def _same_partitions(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def _batch_a_solo_runs(state):
    """Batch A's four jobs, each run alone on its bucket slab under its
    own seed on the card, as ``[(rounds, served partitions)]``: phase
    batch's runs when it ran with the same settings, else run here and
    kept in ``state`` for the next phase."""
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.serve import bucketer
    from fastconsensus_tpu_torch.utils import prng

    batch_cfg = _batch_cfg(state)
    graphs = _batch_graphs("A")
    solo_ref = state.get("batch_A_solo")
    if solo_ref is None or solo_ref["cfg"] != batch_cfg:
        det = get_detector("louvain")
        runs = []
        for (e, n), sd in zip(graphs, BATCH_SEEDS):
            slab, bucket = bucketer.pad_to_bucket(e, n, device=DEVICE)
            r = run_consensus(slab, det, ConsensusConfig(seed=sd,
                                                         **batch_cfg),
                              key=prng.key(sd, DEVICE),
                              n_closure=bucket.n_closure)
            runs.append((r.rounds, r.partitions))
        solo_ref = state["batch_A_solo"] = {"cfg": batch_cfg, "runs": runs}
    return [(r, _served_partitions(p, n))
            for (r, p), (_, n) in zip(solo_ref["runs"], graphs)]


def _delta_library_run(cfg, child_u, child_v, n: int, parent_partitions,
                       adds, removes, incremental: bool, weights=None):
    """A delta by the library path (``serve/delta.py`` + run_consensus)
    on the card: the child's bucket slab and, under an incremental
    decision, the parent's partitions as initial labels (each padding
    node its own singleton) and the delta's neighbourhood as the active
    mask.  Returns the run and the active share (None for a full run)."""
    import numpy as np

    from fastconsensus_tpu_torch.consensus import run_consensus
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.serve import bucketer, delta

    slab, bucket = bucketer.pad_to_bucket(np.stack([child_u, child_v], 1),
                                          n, weights, device=DEVICE)
    kw, share = {}, None
    if incremental:
        parts = np.asarray(parent_partitions, dtype=np.int32)
        init = np.empty((parts.shape[0], slab.n_nodes), dtype=np.int32)
        init[:, :n] = parts
        init[:, n:] = np.arange(n, slab.n_nodes, dtype=np.int32)
        act = np.zeros(slab.n_nodes, dtype=bool)
        act[:n] = delta.neighborhood_mask(child_u, child_v, n, adds, removes)
        kw = dict(init_labels=init, active_mask=act)
        share = float(act[:n].mean())
    run = run_consensus(slab, get_detector(cfg.algorithm), cfg,
                        n_closure=bucket.n_closure, **kw)
    return run, share


def _job_line(name, job, prior=None) -> str:
    t = job.timing() or {}
    ph = t.get("phases_ms", {})
    r = job.result or {}
    wait = sum(ph.get(k, 0.0) for k in ("queue_wait", "hold", "dispatch",
                                         "deque_wait"))
    line = (f"  {name}: {job.job_id} {job.state}, bucket "
            f"{(r.get('bucket') or {}).get('key')}, rung {job.batch_size}, "
            f"rounds {r.get('rounds')}, converged {r.get('converged')}, "
            f"compiles {r.get('compiles')}; queue wait {wait:.1f} ms, "
            f"device {ph.get('device', 0.0):.1f} ms, total "
            f"{t.get('e2e_ms', 0.0):.1f} ms")
    if prior is not None:
        line += f"; cost prior of the bucket {prior * 1e3:.1f} ms"
    return line


def _serve_part_b(state):
    """The entry points: ``python -m fastconsensus_tpu_torch.serve`` and
    ``cli.py --server``, in subprocesses."""
    import shutil
    import signal
    import socket
    import urllib.request

    from fastconsensus_tpu_torch.cli import DEFAULT_TAU
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.serve import bucketer
    from fastconsensus_tpu_torch.serve.client import ServeClient
    from fastconsensus_tpu_torch.utils.io import (read_edgelist,
                                                  write_partition_dirs)

    root = OUT / "serve"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cache = root / "C.npz"
    server_log = root / "server.log"
    karate = ROOT / "examples" / "karate_club.txt"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def start():
        t0 = time.perf_counter()
        with open(server_log, "a") as fh:
            proc = subprocess.Popen(
                [sys.executable, "-m", "fastconsensus_tpu_torch.serve",
                 "--port", str(port), "--max-batch", "4", "--cache-file",
                 str(cache), "--device", DEVICE], cwd=root, env=env,
                stdout=fh, stderr=subprocess.STDOUT)

        def up():
            try:
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=2) as r:
                    return json.loads(r.read())["ok"]
            except OSError:
                return False

        _wait_for("serve: server start", up, proc, timeout=120)
        return proc, time.perf_counter() - t0

    def stop(proc):
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
        out = server_log.read_text()
        check(proc.returncode == 0,
              f"serve: the server exited {proc.returncode} on SIGTERM:\n"
              f"{out[-2000:]}")
        return out

    def thin_cli(alg, out):
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "fastconsensus_tpu_torch.cli", "-f",
             str(karate), "-np", "20", "--alg", alg, "--server", url,
             "--out-dir", str(out)], cwd=root, env=env,
            capture_output=True, text=True, timeout=300)
        check(run.returncode == 0,
              f"serve: cli --server --alg {alg} exit {run.returncode}: "
              f"{run.stderr[-2000:]}")
        return run.stderr.strip().splitlines()[0], time.perf_counter() - t0

    edges, _, ids = read_edgelist(str(karate))
    proc, up_s = start()
    try:
        walls = {}
        for alg in ("louvain", "lpm"):
            msg, walls[alg] = thin_cli(alg, root / f"served_{alg}")
            log(f"serve B: cli --server --alg {alg}: {msg} "
                f"({walls[alg]:.2f}s with process start)")
            # the library path the server's solo job computes, on the card
            slab, bucket = bucketer.pad_to_bucket(edges, len(ids),
                                                  device=DEVICE)
            cfg = ConsensusConfig(algorithm=alg, n_p=20,
                                  tau=DEFAULT_TAU[alg], delta=0.02,
                                  max_rounds=64, seed=0)
            res = run_consensus(slab, get_detector(alg), cfg,
                                n_closure=bucket.n_closure)
            state.setdefault("bucketed_runs", {})[f"karate {alg}"] = (
                cfg, res.rounds, _served_partitions(res.partitions,
                                                    len(ids)))
            ref = root / f"library_{alg}"
            suffix = f"t{cfg.tau}_d{cfg.delta}_np{cfg.n_p}"
            write_partition_dirs(
                str(ref / f"out_partitions_{suffix}"),
                str(ref / f"memberships_{suffix}"),
                _served_partitions(res.partitions, len(ids)), ids)
            _check_same_trees(f"serve B: --server --alg {alg}",
                              root / f"served_{alg}", ref)
        contract_check(state, "serve B: the server's /metricsz",
                       ServeClient(url).metricsz())
    finally:
        out = stop(proc)
    check("drained cleanly" in out and cache.exists(),
          f"serve: no clean drain or no cache spill:\n{out[-2000:]}")
    log(f"serve B: server up in {up_s:.2f}s; SIGTERM drained, exit 0, "
        f"cache spilled to C.npz ({cache.stat().st_size} bytes)")
    proc, up_s = start()
    try:
        msg, wall = thin_cli("louvain", root / "again")
        check("served from cache, 0 compiles" in msg,
              f"serve: the repeat after a restart was not a cache hit: "
              f"{msg}")
        _check_same_trees("serve B: repeat after restart",
                          root / "again", root / "served_louvain")
        contract_check(state, "serve B: the restarted server's /metricsz",
                       ServeClient(url).metricsz())
    finally:
        stop(proc)
    log(f"serve B: restarted in {up_s:.2f}s on the same --cache-file; the "
        f"repeat louvain request: {msg} ({wall:.2f}s with process start, "
        f"against {walls['louvain']:.2f}s first), tree byte-identical")


def phase_serve(state):
    """The serving tier on the card.  A: a ConsensusService in this
    process (HTTP front end on a thread): lfr10k as a solo job, batch A's
    four emailEu stand-ins coalesced into one rung-4 batch while it runs,
    a 1% delta against it, and its repeat from the cache; row_totals per
    shape.  A runs under the lock-order recorder (analysis/lockorder.py):
    the acquisition order observed on the card's dispatch threads must
    be acyclic in union with the static lock graph.  B: the entry points
    in subprocesses (see _serve_part_b)."""
    import threading

    import numpy as np

    from fastconsensus_tpu_torch.analysis import (concurrency, cost,
                                                  lockorder, read_sources)
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.obs import counters as obs_counters
    from fastconsensus_tpu_torch.ops import row_kernels as rk
    from fastconsensus_tpu_torch.serve import bucketer, delta
    from fastconsensus_tpu_torch.serve.client import ServeClient
    from fastconsensus_tpu_torch.serve.jobs import JobSpec, canonical_edges
    from fastconsensus_tpu_torch.serve.server import (ConsensusService,
                                                      ServeConfig,
                                                      make_http_server)
    from fastconsensus_tpu_torch.serve.shaping import ShapingConfig

    n_p = state.get("serve_n_p", 20)
    rounds = state.get("serve_rounds", 16)
    data = np.load(ROOT / "bench_data" / "lfr10k.npz")
    n10k = int(data["labels"].shape[0])
    u, v, _ = canonical_edges(data["edges"], n10k)
    solo_cfg = ConsensusConfig(n_p=n_p, tau=0.2, delta=0.02, seed=0,
                               max_rounds=rounds)
    solo_spec = JobSpec(edges=np.stack([u, v], 1), n_nodes=n10k,
                        config=solo_cfg)
    batch_cfg = _batch_cfg(state)
    seeds = BATCH_SEEDS
    graphs = _batch_graphs("A")
    batch_specs = [JobSpec(edges=e, n_nodes=n, config=ConsensusConfig(
        seed=s, **batch_cfg)) for (e, n), s in zip(graphs, seeds)]
    saved_env = os.environ.get("FCTPU_DETECT_CALL_MEMBERS")
    # The service runs under the port's lock-order recorder, installed
    # before it is built so that its locks are wrapped at creation; a
    # registry made here records the edges into it too (the process's
    # own predates the recording, so its lock is unwrapped).
    with lockorder.recording() as rec:
        saved_reg = obs_counters._REGISTRY
        obs_counters._REGISTRY = obs_counters.ObsRegistry()
        # Two operator knobs differ from the defaults.  The cost prior is
        # the reference's CPU envelope (analysis/cost.py): it puts batch
        # A's bucket at ~100 s a job and would shed the batch at submit,
        # so this part admits without shedding (a card-calibrated prior
        # is future work).  The lfr10k parent converges on a cold
        # stagnation refresh, whose relabelling reads as a final churn of
        # ~1.0 against the default 0.75 ceiling (DeltaPolicy.
        # max_parent_churn), though its members agree at 0.98; the
        # ceiling is lifted so the delta runs incremental, the path this
        # phase drives.
        svc = ConsensusService(ServeConfig(
            device=DEVICE, max_batch=4, shaping=ShapingConfig(shed=False),
            delta_policy=delta.DeltaPolicy(max_parent_churn=1.0)))
        httpd = make_http_server(svc, "127.0.0.1", 0)
        http = threading.Thread(target=httpd.serve_forever, daemon=True)
        http.start()
        client = ServeClient(f"http://127.0.0.1:{httpd.server_address[1]}")
        svc.start()
        try:
            rk.reset_launches()
            reset_peak()
            t0 = time.perf_counter()
            solo = svc.submit(solo_spec)
            _wait_for("serve: the solo job starts",
                      lambda: solo.state != "queued", timeout=60)
            batch = [None] * 4

            def submit(i):
                batch[i] = svc.submit(batch_specs[i])

            threads = [threading.Thread(target=submit, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            check(solo.state == "running",
                  "serve: the solo job finished before the batch was queued")
            _wait_for("serve: solo and batch jobs",
                      lambda: all(j.state in ("done", "failed")
                                  for j in [solo] + batch), timeout=600)
            check(all(j.state == "done" for j in [solo] + batch),
                  f"serve: failed jobs {[j.error for j in [solo] + batch]}")
            q = solo.result["quality"]
            log(f"serve A: the lfr10k job converged "
                f"{solo.result['converged']} "
                f"in {solo.result['rounds']} rounds; final agreement "
                f"{q['final_agreement']}, churn {q['final_churn_frac']}")
            child_u, child_v, adds, removes = _delta_child(u, v, n10k, 0.01,
                                                           seed=1)
            td = time.perf_counter()
            dj = svc.submit_delta({"parent": solo.key, "adds": adds.tolist(),
                                   "removes": removes.tolist()})
            check(dj.spec.delta["mode"] == "incremental",
                  f"serve: the delta was not served incremental: "
                  f"{dj.spec.delta}")
            _wait_for("serve: the delta job",
                      lambda: dj.state in ("done", "failed"), timeout=300)
            delta_wall = time.perf_counter() - td
            check(dj.state == "done", f"serve: delta job failed: {dj.error}")
            part_a_s = time.perf_counter() - t0
            peak = read_peak()
            launches = dict(rk.LAUNCHES)
            shapes = dict(rk.ROW_TOTALS_SHAPES)
            before = dict(rk.LAUNCHES)
            th = time.perf_counter()
            again = svc.submit(solo_spec)
            hit_ms = (time.perf_counter() - th) * 1e3
            check(again.state == "done" and again.result["cached"] and
                  again.result["compiles"] == 0 and
                  dict(rk.LAUNCHES) == before,
                  "serve: the repeat was not a submit-time cache hit")
            metrics = client.metricsz()
            counters = metrics["fcobs"]["counters"]
        finally:
            httpd.shutdown()
            httpd.server_close()
            drained = svc.drain(120)
            if saved_env is None:
                os.environ.pop("FCTPU_DETECT_CALL_MEMBERS", None)
            else:
                os.environ["FCTPU_DETECT_CALL_MEMBERS"] = saved_env
            obs_counters._REGISTRY = saved_reg
    check(drained, "serve: part A did not drain")
    contract_check(state, "serve A: /metricsz", metrics)
    # the observed lock order, in union with the static graph, is acyclic
    pkg = ROOT / "fastconsensus_tpu_torch"
    t_static = time.perf_counter()
    static_pass = concurrency.ConcurrencyAnalyzer(read_sources([str(pkg)]))
    static_pass.run()
    sites, static = static_pass.lock_sites, set(static_pass.edges)
    t_static = time.perf_counter() - t_static
    observed = rec.named_edges(sites)
    unseen = sorted(observed - static)
    log(f"serve A: lock order recorded on the {DEVICE} service's threads: "
        f"{len(observed)} observed edge(s), {len(unseen)} not in the "
        f"static graph's {len(static)} (its pass {t_static:.2f}s): "
        f"{unseen}")
    check(observed, "serve: the recorder saw no nested acquisition")
    try:
        rec.assert_acyclic(extra_edges=static, sites=sites)
    except AssertionError as e:
        check(False, f"serve: {e}")
    # coalescing: one rung-4 batch, and no failed batch hidden behind the
    # whole-batch solo fallback
    ids = {j.batch_id for j in batch}
    check(len(ids) == 1 and None not in ids and
          all(j.batch_size == 4 for j in batch),
          f"serve: batch A did not coalesce into one rung-4 batch: "
          f"{[(j.batch_id, j.batch_size) for j in batch]}")
    check(counters.get("serve.batch.coalesced", 0) >= 1 and
          counters.get("serve.batch.occupancy", 0) >= 4 and
          counters.get("serve.batch.fallback_solo", 0) == 0,
          f"serve: batch counters {counters}")
    bucket = solo_spec.bucket()
    prior = {j.job_id: cost.static_service_prior(
        j.spec.bucket().key(), n_p=j.spec.config.n_p)
        for j in [solo] + batch + [dj]}
    log(f"serve A: lfr10k solo job, batch A x4 and a 1% delta in "
        f"{part_a_s:.2f}s on one {DEVICE} worker; peak device memory "
        f"{peak} bytes")
    log(_job_line("lfr10k solo", solo, prior[solo.job_id]))
    for i, j in enumerate(batch):
        log(_job_line(f"batch A job {i} (seed {seeds[i]})", j,
                      prior[j.job_id]))
    log(_job_line("delta", dj, prior[dj.job_id]))
    d_info = dj.spec.delta
    d_rounds = dj.result["rounds"]
    log(f"serve A: delta {d_info['n_adds']} adds / {d_info['n_removes']} "
        f"removes, delta_frac {d_info['delta_frac']}, {d_rounds} rounds; "
        f"wall {delta_wall:.2f}s (submit to done) against the lfr10k "
        f"job's {solo.timing()['e2e_ms'] / 1e3:.2f}s; cache hit answered "
        f"at submit in {hit_ms:.3f} ms, no launch, compiles 0")
    log("serve A: counters " + ", ".join(
        f"{k} {counters.get('serve.' + k, 0)}" for k in SERVE_SHOWN) +
        f"; launches {launches} "
        f"row_totals_launches_by_shape={sorted(shapes.items())}")
    # each served result against its library counterpart on the card
    det = get_detector("louvain")
    slab, bucket = bucketer.pad_to_bucket(solo_spec.edges, n10k,
                                          device=DEVICE)
    lib = run_consensus(slab, det, solo_cfg, n_closure=bucket.n_closure)
    check(solo.result["rounds"] == lib.rounds and _same_partitions(
        solo.result["partitions"], _served_partitions(lib.partitions, n10k)),
        "serve: the solo job differs from run_consensus on its slab")
    # phase fleet serves the same request and is held against this run
    state.setdefault("bucketed_runs", {})["lfr10k"] = (
        solo_cfg, lib.rounds, _served_partitions(lib.partitions, n10k))
    from_batch = (state.get("batch_A_solo") or {}).get("cfg") == batch_cfg
    for i, (j, (r_rounds, r_parts)) in enumerate(
            zip(batch, _batch_a_solo_runs(state))):
        check(j.result["rounds"] == r_rounds and _same_partitions(
            j.result["partitions"], r_parts),
            f"serve: batch job {i} differs from its solo run")
    # the delta by the library path, with the server's decision
    pu = solo.result["graph"]["u"]
    pv = solo.result["graph"]["v"]
    a2, r2 = delta.parse_delta({"adds": adds.tolist(),
                                "removes": removes.tolist()}, n10k)
    cu, cv, cw = delta.apply_delta(pu, pv, None, n10k, a2, r2)
    check(np.array_equal(cu, child_u) and np.array_equal(cv, child_v),
          "serve: the child graph differs")
    inc, share = _delta_library_run(solo_cfg, cu, cv, n10k,
                                    solo.result["partitions"], a2, r2,
                                    incremental=True, weights=cw)
    check(dj.result["rounds"] == inc.rounds and _same_partitions(
        dj.result["partitions"], _served_partitions(inc.partitions, n10k)),
        "serve: the delta job differs from the library path")
    log(f"serve A: lfr10k == run_consensus on its bucket slab "
        f"({bucket.key()}); every batch job == its solo run"
        f"{' (phase batch)' if from_batch else ''}; the delta "
        f"== the library path (active share {share:.4f}); "
        f"prior vs device: " + ", ".join(
            f"{j.spec.bucket().key()} {prior[j.job_id] * 1e3:.1f} ms / "
            f"{j.timing()['phases_ms']['device']:.1f} ms"
            for j in (solo, batch[0], dj)))
    check(launches["row_totals"] > 0, "serve never launched row_totals")
    state.setdefault("main_paths", {})["serve"] = dict(
        launches=launches["row_totals"],
        by_shape=check_and_time_shapes(shapes, seed=7))
    _serve_part_b(state)


def _fleet_job_line(name, res, key) -> str:
    """One routed job: the replica that answered, its route key and the
    replica's timing block (queue wait, device and total milliseconds)."""
    t = res.get("timing") or {}
    ph = t.get("phases_ms", {})
    wait = sum(ph.get(k, 0.0) for k in ("queue_wait", "hold", "dispatch",
                                         "deque_wait"))
    return (f"  {name}: replica {res.get('fleet_replica')}, route key "
            f"{key}; bucket {(res.get('bucket') or {}).get('key')}, rounds "
            f"{res.get('rounds')}, cached {res.get('cached')}, compiles "
            f"{res.get('compiles')}; queue wait {wait:.1f} ms, device "
            f"{ph.get('device', 0.0):.1f} ms, total "
            f"{t.get('e2e_ms', 0.0):.1f} ms")


def phase_fleet(state):
    """The fleet tier on the card: two ``python -m
    fastconsensus_tpu_torch.serve`` replicas sharing the card behind the
    router (serve/router.py, serve/fleet.py), both in this process."""
    import shutil
    import threading

    import numpy as np
    import torch

    from fastconsensus_tpu_torch.cli import DEFAULT_TAU
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.obs import counters as obs_counters
    from fastconsensus_tpu_torch.obs import history, postmortem
    from fastconsensus_tpu_torch.obs.fleettrace import (REPLICA_SEP,
                                                        fleet_latency_block,
                                                        proxy_overhead)
    from fastconsensus_tpu_torch.serve import bucketer
    from fastconsensus_tpu_torch.serve.cache import ResultCache
    from fastconsensus_tpu_torch.serve.client import ServeClient
    from fastconsensus_tpu_torch.serve.fleet import FleetManager
    from fastconsensus_tpu_torch.serve.jobs import canonical_edges
    from fastconsensus_tpu_torch.serve.router import route_key
    from fastconsensus_tpu_torch.utils.io import read_edgelist

    t_phase = time.perf_counter()
    root = OUT / "fleet"
    shutil.rmtree(root, ignore_errors=True)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()   # this process's cached blocks
    n_p = state.get("fleet_n_p", 20)
    rounds = state.get("fleet_rounds", 16)
    reg = obs_counters.get_registry()
    base = reg.counters()
    # The replicas admit without shedding and warm joiners cheaply: the
    # cost prior is the reference's CPU envelope (phase serve), which
    # would shed batch A at submit, and a joiner's prewarm probes only
    # need to touch its buckets (n_p 4, 2 rounds).
    fleet = FleetManager(str(root), cache_spill_s=1.0, replica_args=(
        "--max-batch", "4", "--device", DEVICE, "--no-shed",
        "--warm-config", json.dumps({"n_p": 4, "max_rounds": 2})))
    env = {"PYTHONPATH": str(ROOT)}
    drain = "fastconsensus_tpu_torch.serve.cache:ResultCache.spill:OSError"
    # the armed site is one the fault pass inventories, with the drain as
    # the boundary it claims absorbs the fault
    inventory = json.loads((ROOT / "fastconsensus_tpu_torch" / "analysis" /
                            "fault_inventory.json").read_text())
    site = {s["site_id"]: s for s in inventory["sites"]}.get(drain)
    absorber = "fastconsensus_tpu_torch.serve.server.ConsensusService.drain"
    check(site is not None and site["injectable"] and
          absorber in site["boundary"],
          f"fleet: {drain} is not inventoried as absorbed by {absorber}: "
          f"{site}")
    log(f"fleet: {drain} is in analysis/fault_inventory.json ({site['kind']}"
        f" at cache.py lines {site['lines']}), claimed absorbed by "
        f"{site['boundary']}")
    try:
        spawn_s = {}

        def spawn(name):
            t0 = time.perf_counter()
            fleet.spawn(name, env_extra=env)
            spawn_s[name] = time.perf_counter() - t0

        threads = [threading.Thread(target=spawn, args=(n,))
                   for n in ("r0", "r1")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        check(sorted(fleet.replicas) == ["r0", "r1"],
              f"fleet: spawn failed ({sorted(fleet.replicas)}); see "
              f"{root}/*.log")
        url = fleet.start_router()
        client = ServeClient(url, timeout=60.0)
        log(f"fleet: r0 healthy in {spawn_s['r0']:.2f}s, r1 in "
            f"{spawn_s['r1']:.2f}s (spawned together, sharing {DEVICE}); "
            f"router at {url}")

        # -- routed traffic --------------------------------------------
        kedges, _, kids = read_edgelist(str(ROOT / "examples" /
                                            "karate_club.txt"))
        jobs = {}      # name -> (payload, submit answer, result)

        def submit(name, payload):
            jobs[name] = [payload, client.submit(**payload), None]

        def wait(name):
            jobs[name][2] = client.wait(jobs[name][1]["job_id"],
                                        timeout=600)
            return jobs[name][2]

        for alg in ("louvain", "lpm"):
            submit(f"karate {alg}", dict(
                edges=kedges.tolist(), n_nodes=len(kids), algorithm=alg,
                n_p=20, tau=DEFAULT_TAU[alg], delta=0.02, max_rounds=64,
                seed=0))
        data = np.load(ROOT / "bench_data" / "lfr10k.npz")
        n10k = int(data["labels"].shape[0])
        u, v, _ = canonical_edges(data["edges"], n10k)
        solo_kw = dict(n_p=n_p, tau=0.2, delta=0.02, seed=0,
                       max_rounds=rounds)
        batch_cfg = _batch_cfg(state)
        graphs = _batch_graphs("A")
        batch_payloads = [dict(edges=e.tolist(), n_nodes=n, seed=s,
                               algorithm="louvain", **batch_cfg)
                          for (e, n), s in zip(graphs, BATCH_SEEDS)]
        lfr_payload = dict(edges=np.stack([u, v], 1).tolist(),
                           n_nodes=n10k, algorithm="louvain", **solo_kw)
        ring = fleet.router.ring
        home_a = ring.route(route_key(batch_payloads[0]))
        check(len({route_key(p) for p in batch_payloads}) == 1,
              "fleet: batch A's jobs have different route keys")
        # batch A must queue behind a running job of its home replica to
        # coalesce (phase serve queues it behind the lfr10k job): the
        # lfr10k job when both groups share a home, else a fifth job of
        # batch A's group
        blocker = "lfr10k"
        if ring.route(route_key(lfr_payload)) != home_a:
            blocker = "batch A blocker"
            submit(blocker, dict(batch_payloads[0], seed=55))
        submit("lfr10k", lfr_payload)
        _wait_for("fleet: the blocking job starts", lambda: client.status(
            jobs[blocker][1]["job_id"])["state"] != "queued", timeout=120)
        burst = [threading.Thread(target=submit, args=(f"batch A {i}", p))
                 for i, p in enumerate(batch_payloads)]
        for t in burst:
            t.start()
        for t in burst:
            t.join()
        check(client.status(jobs[blocker][1]["job_id"])["state"] ==
              "running", "fleet: the blocking job finished before batch A "
                         "was queued")
        for name in list(jobs):
            wait(name)
        lfr = jobs["lfr10k"]
        child_u, child_v, adds, removes = _delta_child(u, v, n10k, 0.01,
                                                       seed=1)
        before = reg.counters()
        jobs["delta"] = [None, client.submit_delta(
            lfr[1]["content_hash"], adds=adds, removes=removes), None]
        dres = wait("delta")
        prefetched = reg.counters_since(before).get(
            "serve.fleet.delta_parent_prefetch", 0)
        d_info = dres["delta"]
        log(f"fleet: delta {d_info['n_adds']} adds / {d_info['n_removes']} "
            f"removes against the lfr10k job on {lfr[2]['fleet_replica']}: "
            f"policy decision {d_info['mode']} ({d_info.get('reason')}), "
            f"served by {dres['fleet_replica']}; parent fetched across "
            f"replicas: {'yes' if prefetched else 'no'} "
            f"(serve.fleet.delta_parent_prefetch +{prefetched})")
        keys = {name: (f"delta|{lfr[1]['content_hash']}"
                       if name == "delta" else route_key(j[0]))
                for name, j in jobs.items()}
        log("fleet: routed jobs (replica, route key, timing):")
        for name, (_, _, res) in jobs.items():
            log(_fleet_job_line(name, res, keys[name]))
        status = [client.status(jobs[f"batch A {i}"][1]["job_id"])
                  for i in range(4)]
        check(len({s["batch_id"] for s in status}) == 1 and
              None not in {s["batch_id"] for s in status} and
              all(s["batch_size"] == 4 for s in status) and
              {jobs[f"batch A {i}"][2]["fleet_replica"]
               for i in range(4)} == {home_a},
              f"fleet: batch A did not coalesce into one rung-4 batch on "
              f"{home_a}: "
              f"{[(s['batch_id'], s['batch_size']) for s in status]}")
        replica_m = {n: ServeClient(r.base_url).metricsz()
                     for n, r in fleet.replicas.items()}
        coalesced = replica_m[home_a]["fcobs"]["counters"].get(
            "serve.batch.coalesced", 0)
        check(coalesced >= 1, f"fleet: {home_a} counted no coalesced batch")
        for name, m in replica_m.items():
            contract_check(state, f"fleet: {name}'s /metricsz", m)
            c = m["fcobs"]["counters"]
            check(c.get("serve.xla_compiles", 0) == 0,
                  f"fleet: {name} built kernels "
                  f"({c.get('serve.xla_compiles')})")
            mem = {d: s.get("memory") for d, s in m["devices"].items()}
            log(f"fleet: {name}: jobs completed "
                f"{c.get('serve.jobs.completed', 0)}, builds 0, device "
                f"memory {mem}")
        # row_totals launches inside the replicas (each counts its own
        # since it started: the counts were 0 before this traffic); on the
        # CPU the wrapper runs the plain version and launches nothing
        launches, shapes = 0, {}
        for m in replica_m.values():
            launches += m["kernels"]["launches"]["row_totals"]
            for r, d, k in m["kernels"]["row_totals_shapes"]:
                shapes[(r, d)] = shapes.get((r, d), 0) + k
        log(f"fleet: row_totals launches in the replicas {launches} "
            f"row_totals_launches_by_shape={sorted(shapes.items())}")
        if DEVICE == "cuda":
            check(launches > 0, "fleet: no replica launched row_totals")
            state.setdefault("main_paths", {})["fleet"] = dict(
                launches=launches,
                by_shape=check_and_time_shapes(shapes, seed=8))
        log(f"fleet: batch A on {home_a}: one rung-4 batch "
            f"{status[0]['batch_id']}, serve.batch.coalesced {coalesced}; "
            f"blocked behind the {blocker} job")
        if DEVICE == "cuda":
            free, total = torch.cuda.mem_get_info()
            log(f"fleet: card memory in use with both replicas up "
                f"{total - free} of {total} bytes (this process reserves "
                f"{torch.cuda.memory_reserved()})")
        fz = client._request("/fleetz")
        over = proxy_overhead((fz.get("router") or {}).get("latency"))
        log("fleet: router proxy overhead per replica " + ", ".join(
            f"{n}: {o['count']} hops, p50 {o['p50_s'] * 1e3:.3f} ms, "
            f"p95 {o['p95_s'] * 1e3:.3f} ms" for n, o in sorted(over.items())))
        # bench.py serve_fleet's telemetry.fleet_latency block from this
        # scrape, the replicas' own histograms scraped after it with no
        # traffic between, held to the reference's gate
        t_fl = time.perf_counter()
        rep_hists = {n: (ServeClient(r.base_url).metricsz().get("latency")
                         or {}).get("histograms") or []
                     for n, r in fleet.replicas.items()}
        block = fleet_latency_block(fz, rep_hists)
        findings = history.check_fleet_latency({"fleet": [
            {"seq": 1, "source": "chip_smoke", "fleet_latency": block}]})
        state["contract_s"] = (state.get("contract_s", 0.0) +
                               time.perf_counter() - t_fl)
        log("fleet: telemetry.fleet_latency " + json.dumps(block,
                                                          sort_keys=True))
        check(block["replicas_scraped"] == len(fleet.replicas) and
              not findings, f"fleet: check_fleet_latency on the /fleetz "
                            f"block: {findings}")
        contract_check(state, "fleet: the router's /metricsz",
                       client.metricsz())

        # -- kill and inherit ------------------------------------------
        victim = jobs["karate louvain"][2]["fleet_replica"]
        held = [j[1]["content_hash"] for j in jobs.values()
                if j[2]["fleet_replica"] == victim]

        def spilled():
            c = ResultCache(max_entries=1024, ttl_seconds=3600.0)
            path = fleet.replicas[victim].cache_path
            return (os.path.exists(path) and c.load(path) > 0 and
                    set(held) <= set(c.keys()))

        _wait_for("fleet: the victim's cache spill", spilled, timeout=30)
        fleet.snapshot_bundles()   # every replica's flight, the victim's too
        t_kill = time.perf_counter()
        fleet.kill(victim, graceful=False)
        heir = fleet.on_death(victim)
        t_sub = time.perf_counter()
        again = client.submit(**jobs["karate louvain"][0])
        hit = client.wait(again["job_id"], timeout=60)
        answer_ms = (time.perf_counter() - t_sub) * 1e3
        kill_s = time.perf_counter() - t_kill
        since = reg.counters_since(base)
        check(again["cached"] and again["fleet_replica"] == heir and
              hit["partitions"] == jobs["karate louvain"][2]["partitions"]
              and hit["compiles"] == 0,
              f"fleet: the resubmit after the kill was not a cache hit on "
              f"{heir}: {again}")
        check(since.get("serve.fleet.cache_inherited", 0) >= 1 and
              since.get("serve.fleet.rehomed_buckets", 0) >= 1,
              f"fleet: counters after the kill {since}")
        log(f"fleet: SIGKILL {victim}, on_death -> {heir} inherited "
            f"{since['serve.fleet.cache_inherited']} cached result(s), "
            f"{since['serve.fleet.rehomed_buckets']} group(s) re-homed; the "
            f"karate louvain resubmit answered from {heir}'s cache at submit "
            f"(same bytes, compiles 0) in {answer_ms:.1f} ms (submit and "
            f"result through the router), {kill_s:.3f}s after the kill")

        # -- join ----------------------------------------------------------
        t0 = time.perf_counter()
        before = reg.counters()
        # r2 alone exports its fcobs trace at drain: its final counters
        # line is where the armed spill fault must be counted
        r2_trace = root / "r2_trace"
        fleet.replica_args += ("--trace-dir", str(r2_trace))
        fleet.add_replica("r2", env_extra=dict(
            env, FCTPU_FAULT_INJECT=drain, FCTPU_FAULT_INJECT_COUNT="1"))
        join_s = time.perf_counter() - t0
        shipped = reg.counters_since(before)
        check(shipped.get("serve.fleet.prewarm_shipped", 0) >= 1,
              "fleet: the joiner was not prewarmed by prewarm shipping")
        m2 = ServeClient(fleet.replicas["r2"].base_url).metricsz()
        contract_check(state, "fleet: r2's /metricsz", m2)
        c2 = m2["fcobs"]["counters"]
        check(c2.get("serve.xla_compiles", 0) == 0 and
              c2.get("serve.prewarm.compiles", 0) == 0,
              f"fleet: the joiner built kernels {c2}")
        log(f"fleet: r2 joined in {join_s:.2f}s, warm "
            f"{fleet.replicas['r2'].warm}, "
            f"{shipped.get('serve.fleet.cache_shipped', 0)} cached result(s) "
            f"shipped; armed with {drain} (count 1)")
        answered = {}
        for name, (payload, sub, res) in jobs.items():
            if name == "delta":
                sub2 = client.submit_delta(lfr[1]["content_hash"], adds=adds,
                                           removes=removes)
            else:
                sub2 = client.submit(**payload)
            res2 = client.wait(sub2["job_id"], timeout=60)
            check(sub2["cached"] and res2["partitions"] == res["partitions"],
                  f"fleet: the resubmit of {name} after the join was not a "
                  f"cache hit with the same bytes: {sub2}")
            answered[name] = sub2["fleet_replica"]
        log(f"fleet: every job resubmitted after the join answered from a "
            f"cache with the same bytes: {answered}")

        # -- bundles ----------------------------------------------------
        collected = root / "collected"
        bundles = fleet.collect_bundles(str(collected))
        check(bundles.get(victim), f"fleet: no bundle of the killed {victim}")
        mine = postmortem.write_bundle("fleet", base_dir=str(root / "router"))
        shutil.copytree(mine, collected / f"router{REPLICA_SEP}"
                                          f"{os.path.basename(mine)}")
        trace = lfr[1]["trace"]
        render = subprocess.run(
            [sys.executable, "-m", "fastconsensus_tpu_torch.obs.fleettrace",
             "render", str(collected), "--trace", trace, "--json"],
            cwd=ROOT, capture_output=True, text=True, timeout=120,
            env=dict(os.environ, **env))
        check(render.returncode == 0, f"fleet: fleettrace render exit "
                                      f"{render.returncode}: {render.stderr}")
        tl = json.loads(render.stdout)
        tracks = set(tl["replicas"])
        check("router" in tracks and tracks & set(fleet.replicas),
              f"fleet: the lfr10k trace {trace} is not on the router's and "
              f"a replica's track: {tl['events_per_replica']}")
        log(f"fleet: collected {sum(len(b) for b in bundles.values())} "
            f"replica bundles {({n: len(b) for n, b in bundles.items()})} "
            f"and the router's; fleettrace render --trace {trace}: "
            f"{tl['n_events']} events on {tl['events_per_replica']}")
    finally:
        # -- drill and drain ------------------------------------------
        t0 = time.perf_counter()
        codes = fleet.stop_all(graceful=True)
        drain_s = time.perf_counter() - t0
    live = {n: c for n, c in codes.items() if n != victim}
    check(all(c == 0 for c in live.values()),
          f"fleet: a replica did not drain cleanly: {codes}")
    r2_log = (root / "r2.log").read_text()
    check("fcfault: injecting OSError" in r2_log and
          "cache spill failed; draining anyway" in r2_log,
          f"fleet: the armed drain-time spill fault did not fire: "
          f"{r2_log[-2000:]}")
    lines = (r2_trace / "fcserve_trace.json.jsonl").read_text().splitlines()
    final = [rec for rec in map(json.loads, lines)
             if rec.get("kind") == "counters"][-1]["counters"]
    failed = final.get("serve.cache.persist_write_failed", 0)
    check(failed >= 1, f"fleet: r2 did not count the injected spill fault: "
                       f"{final}")
    log(f"fleet: drained in {drain_s:.2f}s, exit codes {codes}; r2 absorbed "
        f"the injected spill OSError (logged; its drain-time counters show "
        f"serve.cache.persist_write_failed {failed}) and exited 0")
    for spill in root.glob("*_cache.npz"):   # MBs each, checked above
        spill.unlink()

    # -- each routed result against the library on this card ------------
    # phase serve's bucketed library runs of the same requests, when it
    # ran with the same settings; else run them here
    bucketed = state.get("bucketed_runs", {})
    reused = []

    def library(name, edges, n, cfg):
        if name in bucketed and bucketed[name][0] == cfg:
            reused.append(name)
            return bucketed[name][1:]
        slab, bucket = bucketer.pad_to_bucket(edges, n, device=DEVICE)
        r = run_consensus(slab, get_detector(cfg.algorithm), cfg,
                          n_closure=bucket.n_closure)
        return r.rounds, _served_partitions(r.partitions, n)

    solo_cfg = ConsensusConfig(**solo_kw)
    for name, edges, n, cfg in [
            (f"karate {alg}", kedges, len(kids), ConsensusConfig(
                algorithm=alg, n_p=20, tau=DEFAULT_TAU[alg], delta=0.02,
                max_rounds=64, seed=0)) for alg in ("louvain", "lpm")] + [
            ("lfr10k", np.stack([u, v], 1), n10k, solo_cfg)]:
        lib_rounds, lib_parts = library(name, edges, n, cfg)
        check(jobs[name][2]["rounds"] == lib_rounds and _same_partitions(
            jobs[name][2]["partitions"], lib_parts),
            f"fleet: {name} differs from its bucketed library run")
    from_batch = (state.get("batch_A_solo") or {}).get("cfg") == batch_cfg
    for i, (r_rounds, r_parts) in enumerate(_batch_a_solo_runs(state)):
        res = jobs[f"batch A {i}"][2]
        check(res["rounds"] == r_rounds and _same_partitions(
            res["partitions"], r_parts),
            f"fleet: batch A job {i} differs from its solo run")
    dlib, _ = _delta_library_run(solo_cfg, child_u, child_v, n10k,
                                 lfr[2]["partitions"], adds, removes,
                                 incremental=d_info["mode"] == "incremental")
    check(dres["rounds"] == dlib.rounds and _same_partitions(
        dres["partitions"], _served_partitions(dlib.partitions, n10k)),
        f"fleet: the delta ({d_info['mode']}) differs from the library path")
    log(f"fleet: karate louvain/lpm, lfr10k, batch A x4 and the delta "
        f"({d_info['mode']}) each == the library on {DEVICE} (pad_to_bucket "
        f"+ run_consensus; batch jobs == their solo runs; reused from "
        f"phases serve and batch: {reused}"
        f"{' and batch A' if from_batch else ''})")
    wall = time.perf_counter() - t_phase
    log(f"fleet: phase wall {wall:.2f}s")


def _to_device(slab):
    """A host slab's copy on the card (statics kept)."""
    import dataclasses

    return dataclasses.replace(
        slab, **{f: getattr(slab, f).to(DEVICE)
                 for f in ("src", "dst", "weight", "alive")})


def _rederived(slab):
    """``slab`` with its row budgets re-derived from its degrees, as
    ``run_consensus`` re-derives them once a bucketed job's budgets
    starve (``consensus._JobPolicy.regrow_budgets``)."""
    import numpy as np

    from fastconsensus_tpu_torch.graph import (derive_agg_sizing,
                                               derive_dense_sizing,
                                               derive_hybrid_sizing)

    deg = slab.degrees().cpu().numpy().astype(np.int64)
    n_alive = int(slab.num_alive())
    d_hyb, hub_cap = derive_hybrid_sizing(deg, slab.n_nodes, n_alive)
    return slab.with_statics(d_cap=derive_dense_sizing(deg, slab.n_nodes),
                             d_hyb=d_hyb, hub_cap=hub_cap,
                             agg_cap=derive_agg_sizing(n_alive))


def _held_peak(make_args, call):
    """``call(*make_args())`` once to warm up (the card's persistent
    buffers join the baseline), then measured: ``(peak allocated bytes
    over the baseline taken before the arguments were made, peak
    reserved bytes)``, so the arguments count, as the model counts them.
    ``(None, None)`` off the card."""
    import torch

    out = call(*make_args())
    del out
    sync()
    if DEVICE != "cuda":
        return None, None
    base = torch.cuda.memory_allocated()
    args = make_args()
    sync()
    torch.cuda.reset_peak_memory_stats()
    out = call(*args)
    sync()
    peak = torch.cuda.max_memory_allocated() - base
    reserved = torch.cuda.max_memory_reserved()
    del out, args
    return peak, reserved


def _pool_breakdown(step) -> dict:
    """The card's reserved bytes by the allocator's pool, as
    ``torch.cuda.memory_snapshot`` lists its segments: ``graph`` (the
    captured graph's own pool), ``body/i`` (its IF bodies' pool, one
    entry a stream: one stream a nesting depth, the capture stream's
    among them) and ``other`` (the eager pool, and pools of closed graphs
    that a library keeps alive); MiB."""
    import torch

    graph, body = tuple(step.graph.pool()), tuple(step._body_pool)
    out: dict = {}
    streams: dict = {}
    for seg in torch.cuda.memory_snapshot():
        pid = tuple(seg.get("segment_pool_id") or (0, 0))
        if pid == body:
            key = streams.setdefault(seg["stream"], f"body/{len(streams)}")
        else:
            key = "graph" if pid == graph else "other"
        out[key] = out.get(key, 0) + seg["total_size"]
    return {k: round(v / 2 ** 20, 1) for k, v in sorted(out.items())}


def _pool_case(job, kind, slab, bucket, b, n_p, env, make, block, eager):
    """F5, one case of phase footprint: from an emptied cache, ``block``
    (one block of 8 rounds: one capture and its replays) and then, while
    its graph's pools are held, ``eager`` (one eager round, as a
    stagnation refresh runs between blocks), on the arguments ``make()``
    builds.  The card's ``max_memory_reserved`` over the baseline against
    the blocked footprint model (``eager_cache`` + ``graph_pool`` +
    ``body_pool``), which must be at least it and at most twice it."""
    import torch

    from fastconsensus_tpu_torch.analysis import entrypoints as ep

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        torch.cuda.empty_cache()
        sync()
        torch.cuda.reset_peak_memory_stats()
        base_r = torch.cuda.memory_reserved()
        base_a = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        args = make()
        runner, res = block(*args)
        sync()
        pools = _pool_breakdown(runner.step)
        eager(*args)
        sync()
        reserved = torch.cuda.max_memory_reserved() - base_r
        allocated = torch.cuda.max_memory_allocated() - base_a
        runner.close()
        secs = time.perf_counter() - t0
        terms = ep.peak_terms(kind, slab, b=b, n_p=n_p,
                              n_closure=bucket.n_closure, blocked=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del args
    done = res.done
    mib = {k: round(terms[k] / 2 ** 20, 1)
           for k in ("eager_cache", "graph_pool", "body_pool", "peak")}
    log(f"footprint F5 {kind} block ({job}, bucket {bucket.key()}, B {b}, "
        f"n_p {n_p}, {ep.path_of(slab)} sweep, block 8: rounds done "
        f"{done}, then one eager round): max_memory_reserved over the "
        f"baseline {reserved / 2 ** 20:.1f} MiB (allocated "
        f"{allocated / 2 ** 20:.1f} MiB); model {mib} MiB "
        f"({terms['peak'] / reserved:.3f}x); the block's reserved MiB by "
        f"pool and stream {pools}; {secs:.2f}s")
    check(reserved <= terms["peak"] <= 2 * reserved,
          f"F5 {kind} ({job}): model {terms['peak']} outside [reserved, 2 "
          f"x reserved] for reserved {reserved}")
    return dict(job=job, kind=kind, bucket=bucket.key(), b=b,
                reserved=reserved, allocated=allocated, model=terms["peak"],
                eager_cache=terms["eager_cache"],
                graph_pool=terms["graph_pool"],
                body_pool=terms["body_pool"], pools=pools)


def phase_footprint(state):
    """The footprint memory model against the card.  Each kind's model
    at the job's own packed slab (``analysis/entrypoints.slab_peak_bytes``)
    is held within [1, 2]x of the peak allocated over the baseline of
    that part of a served job, run through the library at its bucket,
    and the bucket's worst case (``serving_peak_bytes``) must be at
    least it: batch A's four jobs (``batch`` and ``detect-batch``, the
    matmul sweep, B = 4), lfr10k's bucket solo (``rounds``, ``tail``,
    ``detect``) and lfr100k's (``detect``, one chunk of 8 members, 4
    sweeps), both with their hybrid rows re-derived as a served run
    re-derives them, which launches ``row_totals``.  Then the serve
    defaults' chip ceilings at the card's memory and at a budget that
    fits lfr10k's bucket but not lfr100k's, and the server's
    ``--chip-max-edges auto`` / ``--hbm-bytes`` outcomes."""
    import signal
    import socket

    import numpy as np
    import torch

    from fastconsensus_tpu_torch.analysis import entrypoints as ep
    from fastconsensus_tpu_torch.analysis import footprint as fp
    from fastconsensus_tpu_torch.engine import (consensus_batch_round,
                                                consensus_round,
                                                consensus_tail,
                                                detect_stacked, round_keys)
    from fastconsensus_tpu_torch.graph import stack_slabs
    from fastconsensus_tpu_torch.models.louvain import make_louvain
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.ops import row_kernels as rk
    from fastconsensus_tpu_torch.serve import bucketer
    from fastconsensus_tpu_torch.serve.__main__ import main as serve_main
    from fastconsensus_tpu_torch.serve.server import ServeConfig
    from fastconsensus_tpu_torch.utils import prng

    t_phase = time.perf_counter()
    n_p = state.get("footprint_n_p", 20)
    tau, delta, ctau = 0.2, 0.02, 0.2
    warm = get_detector("louvain").warm_variant
    rows = []

    def held(job, kind, bucket, slab, b, members, make_args, call):
        model = ep.slab_peak_bytes(kind, slab, b=b, mode="warm",
                                   n_p=members, n_closure=bucket.n_closure)
        worst = ep.serving_peak_bytes(kind, bucket.n_class, bucket.e_class,
                                      b=b, mode="warm", n_p=members)
        t0 = time.perf_counter()
        peak, reserved = _held_peak(make_args, call)
        secs = time.perf_counter() - t0
        ratio = "n/a" if peak is None else f"{model['peak'] / peak:.3f}"
        log(f"footprint {kind} ({job}, bucket {bucket.key()}, B {b}, n_p "
            f"{members}, {model['path']} sweep, d_hyb {slab.d_hyb}, "
            f"hub_cap {slab.hub_cap}, chunk {model['chunk']}): peak over "
            f"the baseline {peak} bytes, max_memory_reserved {reserved}, "
            f"model {model['peak']} ({ratio}x), bucket worst case "
            f"{worst['peak']} ({worst['path']} sweep), {secs:.2f}s")
        rows.append(dict(job=job, kind=kind, bucket=bucket.key(), b=b,
                         peak=peak, reserved=reserved, model=model["peak"],
                         worst=worst["peak"], path=model["path"],
                         chunk=model["chunk"]))
        check(worst["peak"] >= model["peak"],
              f"{kind} ({job}): bucket worst case {worst['peak']} < the "
              f"model at the job's slab {model['peak']}")
        return model

    # batch A: four emailEu stand-ins in one bucket, B = 4, warm round
    pads = [bucketer.pad_to_bucket(e, n, device="cpu")
            for e, n in _batch_graphs("A")]
    check(len({b.key() for _, b in pads}) == 1, "batch A: several buckets")
    bucket_a, slabs_a = pads[0][1], [s for s, _ in pads]
    sing_a = torch.arange(bucket_a.n_class).expand(
        n_p, bucket_a.n_class).clone()
    keys_a = [prng.key(s, DEVICE) for s in BATCH_SEEDS]
    round_a = [prng.stream(k, prng.STREAM_ROUND, 0) for k in keys_a]
    final_a = torch.cat([prng.partition_keys(
        prng.stream(k, prng.STREAM_FINAL), n_p) for k in keys_a])
    held("batch A", "batch", bucket_a, slabs_a[0], 4, n_p,
         lambda: ([_to_device(s) for s in slabs_a],
                  [sing_a.to(DEVICE) for _ in slabs_a]),
         lambda slabs, labs: consensus_batch_round(
             slabs, round_a, warm, n_p, tau, delta, bucket_a.n_closure,
             labs, [False] * 4, labs, closure_tau=ctau))
    held("batch A", "detect-batch", bucket_a, slabs_a[0], 4, n_p,
         lambda: ([_to_device(s) for s in slabs_a],
                  torch.cat([sing_a] * 4).to(DEVICE)),
         lambda slabs, init: detect_stacked(warm, stack_slabs(slabs),
                                            final_a, init))

    # lfr10k's and lfr100k's buckets on their re-derived hybrid rows
    rk.reset_launches()
    data = np.load(ROOT / "bench_data" / "lfr10k.npz")
    slab10, bucket10 = bucketer.pad_to_bucket(
        data["edges"], int(data["labels"].shape[0]), device="cpu")
    slab10 = _rederived(slab10)
    check(ep.path_of(slab10) == "hybrid", "lfr10k: not on hybrid rows")
    n10 = slab10.n_nodes
    sing10 = torch.arange(n10).expand(n_p, n10).clone()
    key10 = prng.key(0, DEVICE)
    keys10, k_closure = round_keys(key10, n_p)
    lab10 = warm(_to_device(slab10), keys10, sing10.to(DEVICE)).cpu()
    held("lfr10k", "detect", bucket10, slab10, 1, n_p,
         lambda: (_to_device(slab10), sing10.to(DEVICE)),
         lambda s, init: warm(s, keys10, init))
    held("lfr10k", "tail", bucket10, slab10, 1, n_p,
         lambda: (_to_device(slab10), lab10.to(DEVICE), sing10.to(DEVICE)),
         lambda s, lab, prev: consensus_tail(
             s, lab, k_closure, n_p, tau, delta, bucket10.n_closure,
             closure_tau=ctau, prev_labels=prev))
    held("lfr10k", "rounds", bucket10, slab10, 1, n_p,
         lambda: (_to_device(slab10), sing10.to(DEVICE)),
         lambda s, lab: consensus_round(
             s, key10, warm, n_p, tau, delta, bucket10.n_closure,
             init_labels=lab, closure_tau=ctau, prev_labels=lab))
    edges100, truth100 = cell_inputs("lfr100k", state)[:2]
    slab100, bucket100 = bucketer.pad_to_bucket(
        edges100, int(truth100.shape[0]), device="cpu")
    slab100 = _rederived(slab100)
    check(ep.path_of(slab100) == "hybrid", "lfr100k: not on hybrid rows")
    m100 = 8
    sing100 = torch.arange(slab100.n_nodes).expand(
        m100, slab100.n_nodes).clone()
    keys100 = prng.partition_keys(prng.key(5, DEVICE), m100)
    det4 = make_louvain(max_sweeps=4).warm_variant
    model100 = held("lfr100k", "detect", bucket100, slab100, 1, m100,
                    lambda: (_to_device(slab100), sing100.to(DEVICE)),
                    lambda s, init: det4(s, keys100, init))
    check(model100["chunk"] == m100,
          f"lfr100k: {m100} members in chunks of {model100['chunk']}")
    launches = rk.LAUNCHES["row_totals"]
    shapes = dict(rk.ROW_TOTALS_SHAPES)
    log(f"footprint: row_totals launches {launches}, by shape "
        f"{sorted(shapes.items())}")
    check(launches > 0, "footprint: the hybrid rows never launched "
                        "row_totals")
    state.setdefault("main_paths", {})["footprint"] = dict(
        launches=launches, by_shape=check_and_time_shapes(shapes, seed=8))
    state["footprint"] = rows
    if DEVICE == "cuda":
        bad = [f"{r['kind']} ({r['job']})" for r in rows
               if not r["peak"] <= r["model"] <= 2 * r["peak"]]
        check(not bad, f"footprint model outside [peak, 2 x peak] for "
                       f"{bad}")

    # F5: a fused block's graph pools against the blocked model, block 8
    from fastconsensus_tpu_torch import engine, policy

    cold = get_detector("louvain")

    def solo_block(s, lab):
        runner = engine.RoundsBlock(s, warm, n_p, tau, delta,
                                    bucket10.n_closure, True,
                                    closure_tau=ctau)
        return runner, runner.run(s, key10, lab, 1, 8, False,
                                  policy.INITIAL, False, (-1, -1, -1), 0)

    def solo_eager(s, lab):
        consensus_round(s, prng.stream(key10, prng.STREAM_ROUND, 9), cold,
                        n_p, tau, delta, bucket10.n_closure,
                        init_labels=sing10.to(DEVICE), closure_tau=ctau,
                        prev_labels=lab)

    def batch_block(slabs, labs):
        runner = engine.BatchBlock(slabs[0], 4, warm, n_p, tau, delta,
                                   bucket_a.n_closure, True,
                                   closure_tau=ctau)
        return runner, runner.run(slabs, keys_a, labs, [1] * 4, [8] * 4,
                                  [False] * 4, [policy.INITIAL] * 4, False,
                                  [(-1, -1, -1)] * 4)

    def batch_eager(slabs, labs):
        consensus_batch_round(slabs, round_a, cold, n_p, tau, delta,
                              bucket_a.n_closure, labs, [False] * 4, labs,
                              closure_tau=ctau)

    pool_rows = []
    if DEVICE == "cuda":
        pool_rows.append(_pool_case(
            "lfr10k", "rounds", slab10, bucket10, 1, n_p, {},
            lambda: (_to_device(slab10), lab10.to(DEVICE)), solo_block,
            solo_eager))
        # a batched block runs only as one member chunk (phase blocks)
        pool_rows.append(_pool_case(
            "batch A", "batch", slabs_a[0], bucket_a, 4, n_p,
            dict(BLOCK_BUDGET),
            lambda: ([_to_device(s) for s in slabs_a],
                     [sing_a.to(DEVICE) for _ in slabs_a]), batch_block,
            batch_eager))
    state["footprint_pools"] = pool_rows

    # the serve defaults' chip ceilings
    d = ServeConfig()
    spec = fp.SurfaceSpec(max_nodes=d.max_nodes, max_edges=d.max_edges,
                          max_batch=d.max_batch, n_p=n_p)
    card = torch.cuda.get_device_properties(0).total_memory \
        if DEVICE == "cuda" else fp.CHIP_HBM_BYTES_DEFAULT
    t0 = time.perf_counter()
    at_card = fp.derive_chip_ceiling(card, spec)
    card_s = time.perf_counter() - t0
    small = max(p for e in fp.edge_classes(spec)
                if e <= bucket10.e_class
                and (p := fp.edge_class_peak(e, spec)) is not None)
    at_small = fp.derive_chip_ceiling(small, spec)
    log(f"footprint: chip ceiling of the serve defaults (max_nodes "
        f"{d.max_nodes}, max_edges {d.max_edges}, max_batch "
        f"{d.max_batch}, n_p {n_p}) at the card's {card} bytes: "
        f"{at_card} edges ({card_s:.2f}s); at {small} bytes: {at_small} "
        f"edges (lfr10k's bucket {bucket10.key()} fits, lfr100k's "
        f"{bucket100.key()} does not)")
    check(at_small is not None and
          bucket10.e_class <= at_small < bucket100.e_class,
          f"ceiling {at_small} at {small} bytes does not split lfr10k's "
          f"and lfr100k's buckets")
    # under FCTPU_ROUNDS_BLOCK=8 the model prices the blocks' graph pools
    os.environ["FCTPU_ROUNDS_BLOCK"] = "8"
    try:
        t0 = time.perf_counter()
        blocked = (fp.derive_chip_ceiling(card, spec),
                   fp.derive_chip_ceiling(small, spec))
        blocked_s = time.perf_counter() - t0
    finally:
        os.environ.pop("FCTPU_ROUNDS_BLOCK", None)
    log(f"footprint: chip ceilings at FCTPU_ROUNDS_BLOCK=8: {blocked[0]} "
        f"edges at the card's memory, {blocked[1]} at {small} bytes "
        f"({blocked_s:.2f}s)")
    check(all(x is None or (y is not None and x <= y)
              for x, y in zip(blocked, (at_card, at_small))),
          f"a blocked ceiling {blocked} above the unblocked "
          f"{(at_card, at_small)}")
    state["footprint_ceilings"] = dict(card=card, at_card=at_card,
                                       small=small, at_small=at_small)

    # the server's flags, as the reference's server answers them
    def serve_rc(args):
        import contextlib
        import io

        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = serve_main(["--device", DEVICE, "--port", "0",
                             "--huge-devices", "1", "--quiet",
                             "--warm-config", json.dumps({"n_p": n_p})]
                            + args)
        return rc, err.getvalue()

    top = fp.grid_up(d.max_edges, fp.MIN_EDGE_CLASS)
    if at_card is not None and at_card >= top:
        rc, err = serve_rc(["--chip-max-edges", "auto"])
        log(f"footprint: serve --huge-devices 1 --chip-max-edges auto: "
            f"exit {rc}: {err.strip()[:200]}")
        check(rc == 2 and "covers every admissible bucket" in err,
              f"auto at the card's memory: exit {rc}: {err}")
    over = fp.grid_up(at_small + 1, fp.MIN_EDGE_CLASS)
    rc, err = serve_rc(["--chip-max-edges", str(over), "--hbm-bytes",
                        str(small)])
    log(f"footprint: serve --chip-max-edges {over} --hbm-bytes {small}: "
        f"exit {rc}: {err.strip()[:200]}")
    check(rc == 2 and "exceeds the derived single-chip ceiling" in err,
          f"an over-ceiling --chip-max-edges: exit {rc}: {err}")
    if DEVICE == "cuda" and torch.cuda.device_count() >= 2:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        server_log = OUT / "footprint_server.log"
        with open(server_log, "w") as fh:
            proc = subprocess.Popen(
                [sys.executable, "-m", "fastconsensus_tpu_torch.serve",
                 "--port", str(port), "--huge-devices", "1",
                 "--chip-max-edges", "auto", "--hbm-bytes", str(small),
                 "--warm-config", json.dumps({"n_p": n_p})],
                cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                stdout=fh, stderr=subprocess.STDOUT)
        try:
            _wait_for("footprint: server start",
                      lambda: "listening on" in server_log.read_text(),
                      proc, timeout=120)
        finally:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=120)
        text = server_log.read_text()
        log(f"footprint: serve --chip-max-edges auto --hbm-bytes {small}: "
            f"{[ln for ln in text.splitlines() if 'auto ->' in ln]}, "
            f"exit {proc.returncode} on SIGTERM")
        check(f"--chip-max-edges auto -> {at_small} edges" in text and
              proc.returncode == 0, f"auto server:\n{text[-2000:]}")
    else:
        log("footprint: the server with the huge tier needs a second "
            "device; skipped on this machine")
    log(f"footprint: phase body {time.perf_counter() - t_phase:.2f}s")


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
    busy = _busy([(e.time_range.start, e.time_range.end)
                     for e in events])
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
          "memory": phase_memory, "karate": phase_karate,
          "gpu_cpu": phase_gpu_cpu,
          "fused": phase_fused, "blocks": phase_blocks,
          "lfr100k": phase_lfr100k,
          "mesh": phase_mesh, "multiprocess": phase_multiprocess,
          "leiden_lfr10k": phase_leiden_lfr10k,
          "lpm_emaileu": phase_lpm_emaileu,
          "cnm_emaileu": phase_cnm_emaileu,
          "infomap_lfr10k": phase_infomap_lfr10k, "resume": phase_resume,
          "recovery": phase_recovery, "trace": phase_trace,
          "delta": phase_delta, "batch": phase_batch, "serve": phase_serve,
          "fleet": phase_fleet, "footprint": phase_footprint}
EXTRA_PHASES = {"profile": phase_profile}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help=f"comma list of {', '.join(PHASES)} (default: all) "
                        f"and the optional {', '.join(EXTRA_PHASES)}")
    p.add_argument("--n-p", type=int, default=200)
    # lfr100k's rounds: bench.py's 8, cut to 3 to keep the release check
    # within its time limit
    p.add_argument("--max-rounds", type=int, default=3)
    p.add_argument("--leiden-rounds", type=int, default=6,
                   help="leiden_lfr10k's max_rounds (default 6; bench.py's "
                        "16, cut to fit the time limit)")
    p.add_argument("--profile-cell", default="lfr100k",
                   choices=("lfr100k", "leiden_lfr10k", "lpm_emaileu",
                            "cnm_emaileu", "infomap_lfr10k"),
                   help="the cell phase profile runs")
    p.add_argument("--mp-spec", help=argparse.SUPPRESS)
    p.add_argument("--mp-rank", type=int, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.mp_spec:    # one rank of phase multiprocess, on its device
        sys.path.insert(0, str(ROOT))
        return mp_rank_main(args.mp_spec, args.mp_rank)
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
    if "contract_s" in state:
        log(f"contract checks (inventory load, assert_covered, the "
            f"fleet_latency block and its gate) {state['contract_s']:.4f}s")
    if "kernels" in phases:
        log(kernels_line(state))
    log(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
