"""Bench-history trend report + regression gate (``obs/history.py``).

    python -m fastconsensus_tpu_torch.obs.bench_report             # text
    python -m fastconsensus_tpu_torch.obs.bench_report --markdown  # md
    python -m fastconsensus_tpu_torch.obs.bench_report --check     # gate:
                                                  # exit 1 on a regression

With no paths, ingests the committed history: ``BENCH_*.json`` at the
repo root plus ``runs/bench_*.json``, with ``runs/footprint_r*.json`` and
``runs/cost_r*.json`` for the fcheck views.  Files that are not bench
records are skipped silently; explicit paths restrict the set.
``--check`` judges the newest sequenced artifact per config against the
median of its predecessors (``--max-drop-frac``, ``--nmi-drop``; the
rules are ``obs/history.py``'s) and exits 1 with one line per finding, 2
when no record was found.

``--check`` first validates every metric key this gate reads against the
committed fcheck-contract inventory
(``fastconsensus_tpu_torch/analysis/contract_inventory.json``): a gate
reading a renamed counter is vacuously green forever, so phantom keys
fail fast with exit 2.  Both modules it loads are stdlib only, so the
report runs where ``torch`` is absent.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List, Optional

from fastconsensus_tpu_torch.obs import history

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
INVENTORY = os.path.join(PKG, "analysis", "contract_inventory.json")


def default_paths() -> List[str]:
    return sorted(glob.glob(os.path.join(REPO, "BENCH_*.json"))) + \
        sorted(glob.glob(os.path.join(REPO, "runs", "bench_*.json")))


def default_footprint_paths() -> List[str]:
    return sorted(glob.glob(os.path.join(REPO, "runs",
                                         "footprint_r*.json")))


def default_cost_paths() -> List[str]:
    return sorted(glob.glob(os.path.join(REPO, "runs", "cost_r*.json")))


def _phantom_reads(inventory: str) -> int:
    """The fcheck-contract fast-fail: 0 when every read of the gate
    modules has a writer in ``inventory``, else 2 after naming them."""
    from fastconsensus_tpu_torch.analysis import contracts

    phantom = []
    for mod in (os.path.abspath(history.__file__),
                os.path.abspath(__file__)):
        phantom += [(mod, name, line) for name, line in
                    contracts.phantom_reads_for(mod, inventory)]
    if not phantom:
        return 0
    print(f"bench_report: {len(phantom)} gate read(s) name a metric the "
          f"contract inventory knows no writer for — the gate would be "
          f"vacuously green:", file=sys.stderr)
    for mod, name, line in phantom:
        print(f"  PHANTOM: {os.path.relpath(mod, REPO)}:{line}: '{name}'",
              file=sys.stderr)
    return 2


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m fastconsensus_tpu_torch.obs.bench_report",
        description="fcobs bench-history trend report / regression gate")
    p.add_argument("paths", nargs="*",
                   help="bench artifact files (default: the committed "
                        "BENCH_*.json + runs/bench_*.json history)")
    p.add_argument("--check", action="store_true",
                   help="regression gate: exit 1 when the newest "
                        "sequenced record regresses vs its history")
    p.add_argument("--max-drop-frac", type=float,
                   default=history.DEFAULT_MAX_DROP_FRAC, metavar="FRAC",
                   help="throughput-drop fraction vs the prior median "
                        "that counts as a regression (default: "
                        f"{history.DEFAULT_MAX_DROP_FRAC})")
    p.add_argument("--nmi-drop", type=float,
                   default=history.DEFAULT_NMI_DROP, metavar="D",
                   help="NMI drop below the prior median that counts as "
                        f"a regression (default: {history.DEFAULT_NMI_DROP})")
    p.add_argument("--markdown", action="store_true",
                   help="emit the trend report as markdown tables")
    p.add_argument("--inventory", metavar="PATH", default=INVENTORY,
                   help="fcheck-contract inventory artifact; with "
                        "--check, every metric key this gate reads is "
                        "validated against it at startup so a renamed "
                        "counter fails fast instead of gating "
                        "vacuously (pass an empty string to skip)")
    p.add_argument("--quiet", action="store_true",
                   help="with --check: print findings only, no report")
    args = p.parse_args(argv)

    if not 0.0 < args.max_drop_frac <= 1.0:
        p.error(f"--max-drop-frac {args.max_drop_frac} out of range "
                f"(0, 1]")
    if args.check and args.inventory:
        if not os.path.isfile(args.inventory):
            print(f"bench_report: no contract inventory at "
                  f"{args.inventory}; skipping the phantom-key check",
                  file=sys.stderr)
        elif _phantom_reads(args.inventory):
            return 2
    paths = args.paths or default_paths()
    groups = history.build_history(paths)
    if not groups:
        print("no bench records found in "
              f"{len(paths)} file(s)", file=sys.stderr)
        return 2
    # explicit paths restrict the fcheck artifacts too; by default, the
    # committed runs/footprint_r*.json and runs/cost_r*.json
    footprints = history.load_footprints(
        args.paths or default_footprint_paths())
    costs = history.load_costs(args.paths or default_cost_paths())
    if not args.quiet:
        print(history.trend_table(groups, markdown=args.markdown))
        for table in (
                history.device_table(groups, markdown=args.markdown),
                history.serve_load_table(groups, markdown=args.markdown),
                history.serve_fleet_table(groups, markdown=args.markdown),
                history.quality_table(groups, markdown=args.markdown),
                history.footprint_table(footprints, markdown=args.markdown),
                history.cost_table(costs, markdown=args.markdown)):
            if table:
                print()
                print(table)
    if not args.check:
        return 0
    problems = history.check_history(groups,
                                     max_drop_frac=args.max_drop_frac,
                                     nmi_drop=args.nmi_drop)
    problems += history.check_serve_load(groups)
    problems += history.check_serve_fleet(groups)
    problems += history.check_delta(groups)
    problems += history.check_fleet_latency(groups)
    problems += history.check_quality(groups)
    problems += history.check_flight(groups)
    problems += history.check_footprints(footprints)
    problems += history.check_costs(costs)
    problems += history.check_cost_calibration(costs, groups)
    n_recs = sum(len(r) for r in groups.values())
    if problems:
        print(f"\nbench_report: {len(problems)} regression finding(s) "
              f"over {n_recs} record(s):", file=sys.stderr)
        for prob in problems:
            print(f"  REGRESSION: {prob}", file=sys.stderr)
        return 1
    print(f"\nbench_report: no regressions across {len(groups)} "
          f"config(s) / {n_recs} record(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
