"""CLI: ``python -m fastconsensus_tpu_torch.analysis [paths...]``.

The port's fcheck: the footprint pass (``analysis/footprint.py``: the
surface count, padding waste and the ``peak-bytes`` memory model) and
the cost pass (``analysis/cost.py``), with the reference's flags for
them and its exit codes: 0 clean, 1 diagnostics, 2 internal error.

The scanned paths are read for ``FOOTPRINT_SPEC`` / ``COST_SPEC``
fixture postures (``tests/analysis_fixtures/``); with none, the passes
evaluate the default serving posture, and with no paths at all they do
so with the report's full tables and the derived chip ceiling.  The
reference's other passes (the AST lint, concurrency, lock order, fault
flow, name contracts and the jaxpr audit) are not ported: a rule id of
theirs exits 2 (ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import replace as dataclasses_replace
from typing import List, Optional

# The rule ids of the reference's passes the port has not ported.
NOT_PORTED_PREFIXES = ("jaxpr-", "trace-error")
NOT_PORTED_RULES = (
    # astlint
    "key-reuse", "traced-branch", "retrace-risk", "weak-static-arg",
    "f64-dtype", "sync-in-loop", "kernel-tracer-closure",
    "module-jnp-const", "mesh-axis", "syntax-error",
    # concurrency (lock order among them)
    "guarded-field", "lock-order", "blocking-under-lock",
    "notify-outside-lock", "unguarded-root-write",
    # fault flow
    "escape-thread-root", "swallowed-error", "unmapped-http-error",
    "resource-leak",
    # name contracts
    "phantom-reader", "schema-drift", "dead-counter", "event-vocab",
    "doc-drift")


def _write(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(text)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fastconsensus_tpu_torch.analysis",
        description="fcheck for the PyTorch port: the footprint and cost "
                    "passes over the serving posture")
    parser.add_argument("paths", nargs="*",
                        help="files or directories holding FOOTPRINT_SPEC "
                             "/ COST_SPEC fixture postures (default: the "
                             "default serving posture, full report)")
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
                             "(default footprint.CHIP_HBM_BYTES_DEFAULT)")
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
    parser.add_argument("--quiet", action="store_true",
                        help="suppress per-diagnostic output")
    args = parser.parse_args(argv)

    from fastconsensus_tpu_torch.analysis import cost as costmod
    from fastconsensus_tpu_torch.analysis import footprint as fpmod
    from fastconsensus_tpu_torch.analysis.diagnostics import Report

    known = set(fpmod.FOOTPRINT_RULES) | set(costmod.COST_RULES)
    only = None
    if args.only:
        only = {r.strip() for r in args.only.split(",") if r.strip()}
        later = {r for r in only if r in NOT_PORTED_RULES
                 or r.startswith(NOT_PORTED_PREFIXES)}
        if later:
            print(f"fcheck: rule id(s) {', '.join(sorted(later))} belong "
                  f"to the reference's passes the port has not ported "
                  f"(ROADMAP.md, Queue 1 item 4); ported rules: "
                  f"{', '.join(sorted(known))}", file=sys.stderr)
            return 2
        unknown = only - known
        if unknown:
            # a typo'd --only would make the gate vacuously green
            print(f"fcheck: unknown rule id(s) in --only: "
                  f"{', '.join(sorted(unknown))}; known rules: "
                  f"{', '.join(sorted(known))}", file=sys.stderr)
            return 2

    report = Report()
    try:
        report.n_files = len(fpmod.source_files(args.paths))
        fp_specs = fpmod.find_specs(args.paths)
        cost_specs = costmod.find_specs(args.paths)
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
    # with paths, the passes run on their fixture postures (or, when a
    # path names none, on the default posture only if forced on)
    default = not args.paths or args.footprint is True
    full = not args.paths and only is None

    passes = (
        (fpmod, fp_specs, {"hbm_bytes": args.hbm_bytes,
                           "surface_budget": args.surface_budget,
                           "pad_waste_frac": args.pad_waste_frac},
         fpmod.SurfaceSpec, "footprint"),
        (costmod, cost_specs, {"waste_budget": args.waste_budget},
         costmod.CostSpec, "cost"))
    for mod, fixture_specs, overrides, spec_cls, name in passes:
        rules = set(getattr(mod, f"{name.upper()}_RULES"))
        sel = rules if only is None else only & rules
        if not run or not sel:
            continue
        specs = fixture_specs or ([spec_cls()] if default else [])
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
    if args.json:
        _write(args.json, report.to_json())
    if not args.quiet:
        print(report.format_human())
    return 1 if report.diagnostics else 0


if __name__ == "__main__":
    sys.exit(main())
