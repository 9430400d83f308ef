"""Shared diagnostic model for the fcheck static-analysis suite.

Every layer (AST lint, jaxpr audit, recompile guard) reports through one
:class:`Diagnostic` record so the CLI can merge them into a single
machine-readable JSON report plus ``file:line``-style human output.

Suppression: a line carrying ``# fcheck: ok=<rule>[,<rule>...]`` (or the
line directly above it) suppresses those rules there.  ``# fcheck: ok``
with no rule list suppresses everything on that line.  Pragmas are how
deliberate violations stay deliberate — each one should carry a reason in
the trailing comment text, and the JSON report counts them so CI can spot
pragma creep.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Tuple

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"

_PRAGMA_RE = re.compile(r"#\s*fcheck:\s*ok(?:\s*=\s*([A-Za-z0-9_,\- ]+))?")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: ``rule`` is a stable kebab-case id, ``line`` 1-based."""

    rule: str
    message: str
    file: str = "<memory>"
    line: int = 0
    col: int = 0
    severity: str = SEVERITY_ERROR

    def format(self) -> str:
        loc = f"{self.file}:{self.line}:{self.col}" if self.line else self.file
        return f"{loc}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def parse_pragmas(source: str) -> Dict[int, Optional[Tuple[str, ...]]]:
    """Map line number -> suppressed rule names (None = all rules).

    A trailing pragma suppresses its own line.  A comment-only pragma
    line suppresses the next *code* line (further comment/blank lines in
    between stay covered too, so multi-line reason comments work).
    """
    lines = source.splitlines()
    out: Dict[int, Optional[Tuple[str, ...]]] = {}

    def add(ln: int, rules: Optional[Tuple[str, ...]]) -> None:
        if rules is None or out.get(ln, ()) is None:
            out[ln] = None
        else:
            out[ln] = tuple(out.get(ln, ())) + rules

    for i, text in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        rules: Optional[Tuple[str, ...]] = None
        if m.group(1):
            rules = tuple(r.strip() for r in m.group(1).split(",")
                          if r.strip())
        add(i, rules)
        if text.strip().startswith("#"):
            # standalone pragma comment: cover through the next code line
            j = i + 1
            while j <= len(lines):
                add(j, rules)
                stripped = lines[j - 1].strip()
                if stripped and not stripped.startswith("#"):
                    break
                j += 1
    return out


def apply_pragmas(diags: List[Diagnostic], source: str
                  ) -> Tuple[List[Diagnostic], int]:
    """Drop suppressed diagnostics; returns (kept, n_suppressed)."""
    pragmas = parse_pragmas(source)
    kept: List[Diagnostic] = []
    suppressed = 0
    for d in diags:
        rules = pragmas.get(d.line, ())
        if rules is None or (rules and d.rule in rules):
            suppressed += 1
        else:
            kept.append(d)
    return kept, suppressed


@dataclasses.dataclass
class Report:
    """Aggregated result of one analyzer invocation."""

    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)
    n_files: int = 0
    n_suppressed: int = 0
    # per-entry-point jaxpr audit summaries (entrypoint -> primitive
    # counts, plus the liveness-sweep "peak_bytes" entry)
    jaxpr_summary: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    # the footprint block (analysis/footprint.py module docstring
    # documents the schema); None when the footprint pass did not run
    footprint: Optional[dict] = None
    # the compute-cost block (analysis/cost.py module docstring
    # documents the schema); None when the cost pass did not run
    cost: Optional[dict] = None

    def extend(self, diags: List[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    @property
    def n_errors(self) -> int:
        return sum(1 for d in self.diagnostics
                   if d.severity == SEVERITY_ERROR)

    def to_json(self) -> str:
        return json.dumps({
            "tool": "fcheck",
            "version": 1,
            "n_files": self.n_files,
            "n_diagnostics": len(self.diagnostics),
            "n_errors": self.n_errors,
            "n_suppressed": self.n_suppressed,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "jaxpr_entry_points": self.jaxpr_summary,
            "footprint": self.footprint,
            "cost": self.cost,
        }, indent=2, sort_keys=True)

    def format_human(self) -> str:
        lines = [d.format() for d in sorted(
            self.diagnostics, key=lambda d: (d.file, d.line, d.col))]
        lines.append(
            f"fcheck: {len(self.diagnostics)} finding(s) "
            f"({self.n_errors} error) in {self.n_files} file(s), "
            f"{self.n_suppressed} suppressed by pragma, "
            f"{len(self.jaxpr_summary)} jaxpr entry point(s) audited")
        if self.footprint is not None:
            fp = self.footprint
            ceil = fp.get("chip_ceiling_edges")
            lines.append(
                f"fcheck-footprint: {fp.get('surface_count')} surface "
                f"executable(s) (budget {fp.get('surface_budget')}), "
                f"max pad {fp.get('max_pad_frac'):.0%}, "
                f"chip ceiling "
                f"{ceil if ceil is not None else 'n/a'} edges")
        if self.cost is not None:
            dc = self.cost.get("dead_compute") or {}
            cal = self.cost.get("calibration") or {}
            lines.append(
                f"fcheck-cost: dead-compute "
                f"{dc.get('run_dead_frac', 0.0):.0%} of run FLOPs at "
                f"{dc.get('bucket', 'n/a')} "
                f"(budget {dc.get('waste_budget', 0.0):.0%}), "
                f"{len(self.cost.get('gate') or [])} gate row(s), "
                f"calibration "
                f"{cal.get('est_device_ms', 'n/a')} ms device est")
        return "\n".join(lines)
