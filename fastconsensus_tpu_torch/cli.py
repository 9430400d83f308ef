"""Command-line interface of the PyTorch port, flag-compatible with the
reference's for the flags it supports.

    python -m fastconsensus_tpu_torch.cli -f edgelist.txt --alg louvain -np 50

Flags as in the reference: ``-f -np -t -d --alg -g --seed --max-rounds
--capacity --no-grow --align-frac --closure-sampler --closure-tau
--cold-detect --out-dir --quiet --checkpoint --resume``, plus ``--device``
(default ``cuda``; the run fails rather than fall back when CUDA is
missing).  All five detectors run: louvain, lpm and leiden on the device,
cnm and infomap as host C++ with the consensus tail on the device.  Output
trees are the reference's: ``out_partitions_t{t}_d{d}_np{np}/{1..n_p}``
and ``memberships_t{t}_d{d}_np{np}/{0..n_p-1}``.  Not ported yet:
``--detect-cache``, ``--trace``, ``--trace-jsonl``, ``--profile-dir``,
``--dump-on-signal`` and ``--server``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

DEFAULT_TAU = {"louvain": 0.2, "cnm": 0.7, "infomap": 0.6, "lpm": 0.8,
               "leiden": 0.2}
ALGORITHMS = ("louvain", "lpm", "cnm", "infomap", "leiden")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fastconsensus-tpu-torch",
        description="Fast consensus clustering on an NVIDIA GPU "
                    "(Tandon et al. 2019, arXiv:1902.04014).")
    p.add_argument("-f", metavar="filename", type=str, required=True,
                   help="edgelist file: 'u v' or 'u v w' per line")
    p.add_argument("-np", dest="n_p", metavar="n_p", type=int, default=20,
                   help="number of input partitions (default: 20)")
    p.add_argument("-t", dest="tau", metavar="tau", type=float, default=None,
                   help="threshold for filtering weak edges "
                        "(default: per-algorithm table)")
    p.add_argument("-d", dest="delta", metavar="delta", type=float,
                   default=0.02, help="convergence parameter (default: 0.02)")
    p.add_argument("--alg", metavar="alg", type=str, default="louvain",
                   choices=ALGORITHMS,
                   help=f"one of {', '.join(ALGORITHMS)} (cnm and infomap "
                        f"detect on the host, in C++ built at first use)")
    p.add_argument("-g", dest="gamma", metavar="gamma", type=float,
                   default=1.0,
                   help="resolution parameter for modularity detectors "
                        "(louvain, leiden; ignored with a warning for the "
                        "others)")
    p.add_argument("--seed", type=int, default=0,
                   help="PRNG seed for the whole run (default: 0)")
    p.add_argument("--max-rounds", type=int, default=64,
                   help="safety cap on consensus rounds (default: 64)")
    p.add_argument("--capacity", type=int, default=None, metavar="E_CAP",
                   help="initial edge-slab capacity (default: 2*E+16). The "
                        "slab self-sizes: a saturated round grows it and "
                        "replays; pre-sizing here skips those replays on "
                        "dense consensus graphs. On --resume the "
                        "checkpoint's (possibly auto-grown) capacity wins "
                        "unless this asks for more")
    p.add_argument("--no-grow", action="store_true",
                   help="disable slab self-sizing; saturated rounds drop "
                        "closure candidates with a reported count")
    p.add_argument("--align-frac", type=float, default=None,
                   metavar="FRAC",
                   help="unconverged-edge fraction below which detection "
                        "rounds share one PRNG key across ensemble members "
                        "(endgame tie-break alignment; 0 disables, 1 aligns "
                        "every warm round; default: engine default)")
    p.add_argument("--closure-sampler", type=str, default="auto",
                   choices=("auto", "csr", "scatter"),
                   help="triadic-closure wedge sampler: csr (argsort of the "
                        "edges, uniform anchors), scatter (sort-free "
                        "partner draws), or auto (default: csr)")
    p.add_argument("--closure-tau", type=float, default=None,
                   metavar="FRAC",
                   help="minimum co-membership fraction for a triadic-"
                        "closure insert (default: no bar)")
    p.add_argument("--cold-detect", action="store_true",
                   help="disable warm-started detection (every round "
                        "re-derives partitions from singletons)")
    p.add_argument("--out-dir", type=str, default=".",
                   help="directory to create output trees in (default: .)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-round progress lines")
    p.add_argument("--checkpoint", type=str, default=None, metavar="PATH",
                   help="persist consensus state to PATH after every round")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    return p


def check_arguments(args) -> Optional[str]:
    if not 0.0 <= args.delta <= 1.0:
        return f"delta {args.delta} out of range; allowed values are 0..1"
    if not 0.0 <= args.tau <= 1.0:
        return f"tau {args.tau} out of range; allowed values are 0..1"
    if args.n_p < 1:
        return f"np {args.n_p} out of range; need at least 1 partition"
    if args.max_rounds < 1:
        return "max-rounds must be >= 1"
    if args.closure_tau is not None and not 0.0 <= args.closure_tau <= 1.0:
        return (f"closure-tau {args.closure_tau} out of range; allowed "
                f"values are 0..1")
    if args.align_frac is not None and not 0.0 <= args.align_frac <= 1.0:
        return (f"align-frac {args.align_frac} out of range; allowed "
                f"values are 0..1")
    return None


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.tau is None:
        args.tau = DEFAULT_TAU[args.alg]
    err = check_arguments(args)
    if err:
        print(err, file=sys.stderr)
        return 2

    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.models.registry import (get_detector,
                                                         supports_param)
    from fastconsensus_tpu_torch.utils.env import resolve_device
    from fastconsensus_tpu_torch.utils.io import (read_edgelist,
                                                  write_partition_dirs)

    try:
        device = resolve_device(args.device)
        if args.gamma != 1.0 and not supports_param(args.alg, "gamma"):
            print(f"warning: -g {args.gamma} ignored for --alg {args.alg} "
                  f"(resolution applies to modularity detectors)",
                  file=sys.stderr)
            # an ignored gamma must not enter checkpoint fingerprints
            args.gamma = 1.0
        detector = get_detector(args.alg, gamma=args.gamma)
    except (RuntimeError, ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        edges, _, original_ids = read_edgelist(args.f)
    except (OSError, ValueError) as e:
        print(f"error reading {args.f}: {e}", file=sys.stderr)
        return 2
    try:
        slab = pack_edges(edges, n_nodes=len(original_ids),
                          capacity=args.capacity, device=device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    extra_cfg = {}
    if args.align_frac is not None:
        extra_cfg["align_frac"] = args.align_frac
    cfg = ConsensusConfig(algorithm=args.alg, n_p=args.n_p, tau=args.tau,
                          delta=args.delta, max_rounds=args.max_rounds,
                          seed=args.seed, gamma=args.gamma,
                          auto_grow=not args.no_grow,
                          warm_start=not args.cold_detect,
                          closure_sampler=args.closure_sampler,
                          closure_tau=args.closure_tau, **extra_cfg)
    t0 = time.perf_counter()
    try:
        result = run_consensus(slab, detector, cfg,
                               checkpoint_path=args.checkpoint,
                               resume=args.resume)
    except ValueError as e:
        # a checkpoint written by another configuration: an operator error
        print(f"error: {e}", file=sys.stderr)
        return 2
    elapsed = time.perf_counter() - t0
    if not args.quiet:
        for h in result.history:
            dropped = (f", {h['n_dropped']} dropped (capacity; rerun "
                       f"without --no-grow)" if h["n_dropped"] else "")
            print(f"round {h['round']}: {h['n_alive']} edges, "
                  f"{h['n_unconverged']} unconverged, "
                  f"+{h['n_closure_added']} closure, "
                  f"+{h['n_repaired']} repaired{dropped}", file=sys.stderr)
        state = "converged" if result.converged else \
            f"max_rounds={cfg.max_rounds} reached"
        print(f"{state} after {result.rounds} round(s) in {elapsed:.2f}s "
              f"on {device}", file=sys.stderr)
    suffix = f"t{args.tau}_d{args.delta}_np{args.n_p}"
    out_dir = os.path.join(args.out_dir, f"out_partitions_{suffix}")
    mem_dir = os.path.join(args.out_dir, f"memberships_{suffix}")
    write_partition_dirs(out_dir, mem_dir, result.partitions, original_ids)
    if not args.quiet:
        print(f"wrote {len(result.partitions)} partitions to {out_dir} "
              f"and {mem_dir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
