"""CLI: ``python -m fastconsensus_tpu_torch.analysis [paths...]``.

The port's fcheck, with the reference's exit codes: 0 clean, 1
diagnostics, 2 internal or usage error.  With no paths it scans the
port's own package.

Every scanned path goes through the source passes (``lint_paths``: the
AST lint, concurrency and fault flow).  The footprint pass
(``analysis/footprint.py``: the surface count, padding waste and the
``peak-bytes`` memory model) and the cost pass (``analysis/cost.py``)
read the scanned paths for ``FOOTPRINT_SPEC`` / ``COST_SPEC`` fixture
postures; a scan of the package (no paths, or a path inside it)
evaluates the default serving posture instead, with the report's full
tables and the derived chip ceiling, at the memory of the card the port
is built for (``footprint.H100_HBM_BYTES``) unless ``--hbm-bytes`` says
otherwise.

The name-contract pass (``analysis/contracts.py``) runs inside the
source passes: in repo mode on a scan of the package, in fixture mode on
``CONTRACT_SPEC`` files.  ``--emit-inventory PATH`` writes its
writer/reader inventory (committed as
``analysis/contract_inventory.json``, the static half of the live
``/metricsz`` cross-check) and ``--emit-appendix`` prints the package's
``COUNTERS.md`` and exits.

Of the reference's other rules, the jit-only lint rules and the jaxpr
audit have no counterpart in eager PyTorch (their ids exit 2, "not
applicable").
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import replace as dataclasses_replace
from typing import List, Optional

# The reference's rule ids that guard tracing and Pallas hazards eager
# PyTorch does not have.
NOT_APPLICABLE_PREFIXES = ("jaxpr-", "trace-error")
NOT_APPLICABLE_RULES = (
    "traced-branch", "retrace-risk", "weak-static-arg",
    "kernel-tracer-closure", "module-jnp-const", "mesh-axis")

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inside_package(paths: List[str]) -> bool:
    for p in paths:
        ap = os.path.abspath(p)
        if ap == PKG_DIR or ap.startswith(PKG_DIR + os.sep) or \
                PKG_DIR.startswith(ap + os.sep):
            return True
    return False


def _write(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(text)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fastconsensus_tpu_torch.analysis",
        description="fcheck for the PyTorch port: the AST lint, "
                    "concurrency, fault-flow and name-contract passes over "
                    "the sources, and the footprint and cost passes over "
                    "the serving posture")
    parser.add_argument("paths", nargs="*",
                        help="files or directories to scan (default: the "
                             "fastconsensus_tpu_torch package)")
    parser.add_argument("--json", metavar="PATH", default=None,
                        help="write the machine-readable report here")
    parser.add_argument("--only", default=None, metavar="RULE[,RULE...]",
                        help="keep only these rule ids (comma-separated)")
    parser.add_argument("--footprint", dest="footprint",
                        action="store_true", default=None,
                        help="force the footprint and cost passes on")
    parser.add_argument("--no-footprint", dest="footprint",
                        action="store_false",
                        help="skip the footprint and cost passes")
    parser.add_argument("--hbm-bytes", type=int, default=None,
                        metavar="BYTES",
                        help="per-card memory budget of the peak-bytes rule "
                             "(default: footprint.H100_HBM_BYTES on the "
                             "package's posture, a fixture's own or "
                             "footprint.CHIP_HBM_BYTES_DEFAULT otherwise)")
    parser.add_argument("--surface-budget", type=int, default=None,
                        metavar="N",
                        help="executable-count budget of the surface-count "
                             "rule (default footprint."
                             "SURFACE_BUDGET_DEFAULT)")
    parser.add_argument("--pad-waste-frac", type=float, default=None,
                        metavar="FRAC",
                        help="padding-waste threshold (default footprint."
                             "PAD_WASTE_FRAC_DEFAULT)")
    parser.add_argument("--footprint-out", metavar="PATH", default=None,
                        help="also write the footprint block alone")
    parser.add_argument("--waste-budget", type=float, default=None,
                        metavar="FRAC",
                        help="cost-dead-compute threshold (default cost."
                             "WASTE_BUDGET_DEFAULT)")
    parser.add_argument("--cost-out", metavar="PATH", default=None,
                        help="also write the cost block alone")
    parser.add_argument("--emit-fault-inventory", metavar="PATH",
                        default=None,
                        help="write the injection-site inventory: every "
                             "raise site in the package's serve/ and the "
                             "boundary the fault pass claims absorbs it "
                             "(committed as analysis/fault_inventory."
                             "json; serve/faultinject.py arms its sites)")
    parser.add_argument("--emit-inventory", metavar="PATH", default=None,
                        help="write the fcheck-contract writer/reader "
                             "inventory (committed as analysis/"
                             "contract_inventory.json: the static half of "
                             "the live /metricsz cross-check and the "
                             "source of COUNTERS.md); needs a package scan")
    parser.add_argument("--emit-appendix", action="store_true",
                        help="print the package's COUNTERS.md, generated "
                             "from the inventory, and exit (redirect it "
                             "into fastconsensus_tpu_torch/COUNTERS.md)")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress per-diagnostic output")
    args = parser.parse_args(argv)

    from fastconsensus_tpu_torch.analysis import cost as costmod
    from fastconsensus_tpu_torch.analysis import footprint as fpmod
    from fastconsensus_tpu_torch.analysis import lint_paths
    from fastconsensus_tpu_torch.analysis.astlint import ASTLINT_RULES
    from fastconsensus_tpu_torch.analysis.concurrency import \
        CONCURRENCY_RULES
    from fastconsensus_tpu_torch.analysis.contracts import CONTRACT_RULES
    from fastconsensus_tpu_torch.analysis.diagnostics import Report
    from fastconsensus_tpu_torch.analysis.faults import FAULT_RULES

    known = set(ASTLINT_RULES) | set(CONCURRENCY_RULES) | \
        set(FAULT_RULES) | set(fpmod.FOOTPRINT_RULES) | \
        set(costmod.COST_RULES) | set(CONTRACT_RULES)
    only = None
    if args.only:
        only = {r.strip() for r in args.only.split(",") if r.strip()}
        eager = {r for r in only if r in NOT_APPLICABLE_RULES
                 or r.startswith(NOT_APPLICABLE_PREFIXES)}
        if eager:
            print(f"fcheck: rule id(s) {', '.join(sorted(eager))} are not "
                  f"applicable to eager PyTorch: they guard jit tracing "
                  f"and Pallas lowering, which the port does not use; "
                  f"known rules: {', '.join(sorted(known))}",
                  file=sys.stderr)
            return 2
        unknown = only - known
        if unknown:
            # a typo'd --only would make the gate vacuously green
            print(f"fcheck: unknown rule id(s) in --only: "
                  f"{', '.join(sorted(unknown))}; known rules: "
                  f"{', '.join(sorted(known))}", file=sys.stderr)
            return 2

    package = not args.paths
    paths = args.paths or [PKG_DIR]
    report = Report()
    try:
        lint_paths(paths, report)
        fp_specs = fpmod.find_specs(paths)
        cost_specs = costmod.find_specs(paths)
    except OSError as e:
        print(f"fcheck: cannot read {e.filename or e}: {e.strerror or e}",
              file=sys.stderr)
        return 2
    except ValueError as e:
        # a malformed fixture posture must fail loudly, not evaluate the
        # defaults
        print(f"fcheck: {e}", file=sys.stderr)
        return 2
    run = args.footprint is not False
    # the default posture: on a scan of the package, or when forced on
    default = _inside_package(paths) or args.footprint is True
    full = package and only is None

    passes = (
        (fpmod, fp_specs, {"hbm_bytes": args.hbm_bytes,
                           "surface_budget": args.surface_budget,
                           "pad_waste_frac": args.pad_waste_frac},
         fpmod.SurfaceSpec(hbm_bytes=fpmod.H100_HBM_BYTES), "footprint"),
        (costmod, cost_specs, {"waste_budget": args.waste_budget},
         costmod.CostSpec(), "cost"))
    for mod, fixture_specs, overrides, default_spec, name in passes:
        rules = set(getattr(mod, f"{name.upper()}_RULES"))
        sel = rules if only is None else only & rules
        if not run or not sel:
            continue
        specs = fixture_specs or ([default_spec] if default else [])
        overrides = {k: v for k, v in overrides.items() if v is not None}
        try:
            for spec in specs:
                spec = dataclasses_replace(spec, **overrides)
                if name == "footprint":
                    diags, block = mod.evaluate(spec, rules=sel,
                                                with_table=full,
                                                with_ceiling=full)
                else:
                    diags, block = mod.evaluate(spec, rules=sel,
                                                with_table=full)
                report.extend(diags)
                if not fixture_specs:
                    setattr(report, name, block)
        except Exception as e:  # noqa: BLE001 — exit 2, never crash
            print(f"fcheck: {name} pass failed to run: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            return 2

    if only is not None:
        report.diagnostics = [d for d in report.diagnostics
                              if d.rule in only]
    for path, block, name in ((args.footprint_out, report.footprint,
                               "footprint"),
                              (args.cost_out, report.cost, "cost")):
        if path:
            if block is None:
                print(f"fcheck: --{name}-out needs the {name} pass on the "
                      f"default posture (no fixture specs, a {name} rule "
                      f"selected)", file=sys.stderr)
                return 2
            _write(path, json.dumps(block, indent=2, sort_keys=True) + "\n")
    if args.emit_fault_inventory:
        from fastconsensus_tpu_torch.analysis import faults

        try:
            inventory = faults.fault_inventory_from_paths(paths)
        except (ValueError, OSError) as e:
            print(f"fcheck: {e}", file=sys.stderr)
            return 2
        _write(args.emit_fault_inventory,
               json.dumps(inventory, indent=2, sort_keys=True) + "\n")
    if args.emit_inventory or args.emit_appendix:
        from fastconsensus_tpu_torch.analysis import contracts

        try:
            inventory = contracts.inventory_from_paths(paths)
        except (ValueError, OSError) as e:
            print(f"fcheck: {e}", file=sys.stderr)
            return 2
        if args.emit_inventory:
            _write(args.emit_inventory,
                   json.dumps(inventory, indent=2, sort_keys=True) + "\n")
        if args.emit_appendix:
            # generator mode, not a gate: a test holds COUNTERS.md to it
            sys.stdout.write(contracts.render_counters_doc(inventory))
            return 0
    if args.json:
        _write(args.json, report.to_json())
    if not args.quiet:
        print(report.format_human())
    return 1 if report.diagnostics else 0


if __name__ == "__main__":
    sys.exit(main())
