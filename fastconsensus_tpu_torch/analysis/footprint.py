"""fcheck-footprint for the port: the bucket ladder's geometry, its
executable-surface and padding rules, and the device-memory model of
every bucket behind ``serve --chip-max-edges auto`` / ``--hbm-bytes``.

Counterpart of the reference's ``fastconsensus_tpu/analysis/footprint.py``.

1. **Ladder geometry** (torch-free): ``grid_up``, the class floors and
   the batch rungs.  The fleet router (``serve/router.py``) derives a
   submission's route key from the same ``{2^k, 3*2^k}`` grid the
   replica pads onto, and a router host must never pay a torch import,
   so this module holds the one definition: ``sizing.grid_up``,
   ``serve/bucketer.py``'s class floors and batch ladder and
   ``models/louvain.py``'s path flip are imported from here.
2. **Surface enumeration and padding** (torch-free, as the reference's):
   every bucket a serving posture admits times the reference's
   executable kinds (``surface-count``), and each bucket's worst-case
   padding (``padding-waste``).  For equal postures the counts,
   fractions and diagnostics equal the reference's.
3. **The peak model** (imports torch for shapes only): the reference
   sweeps the liveness of each traced serving executable
   (``peak_live_bytes`` over a jaxpr); the port is eager, so the rule
   ``peak-bytes`` prices :func:`analysis.entrypoints.serving_peak_bytes`,
   a byte model of the port's own tensors at each part of a served job.
   It is the counterpart of the reference's ``jaxpr-peak-bytes``, and a
   fixture posture naming that rule selects it.  :func:`derive_chip_ceiling`
   feeds it back into serving, as the reference's does.

**Report schema** (the ``footprint`` block of ``python -m
fastconsensus_tpu_torch.analysis --json``), the reference's::

    {
      "tool": "fcheck-footprint", "version": 1,
      "config":  {max_nodes, max_edges, max_batch, n_p, algorithm,
                  hbm_bytes, surface_budget, pad_waste_frac},
      "surface_count": <int>, "surface_budget": <int>,
      "chip_ceiling_edges": <int|null>, "max_pad_frac": <float>,
      "gate": [ {kind, bucket, n_class, e_class, batch, mode, peak_bytes,
                 arg_bytes, out_bytes} ... ],
      "buckets": [ {bucket, n_class, e_class, capacity, batch,
                    peak_bytes, solo_peak_bytes, arg_bytes, out_bytes,
                    pad_frac} ... ]
    }
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from fastconsensus_tpu_torch.analysis.diagnostics import Diagnostic

# Floors keep tiny graphs (karate-sized probes) in one bucket.
MIN_NODE_CLASS = 64
MIN_EDGE_CLASS = 64
# Batch widths a server coalesces same-bucket jobs into (B = 1 is the
# solo path); powers of two cap the split overhead at one extra
# sub-batch per burst.
BATCH_RUNGS = (1, 2, 4, 8)
# The matmul/hash detection-path flip (models/louvain.py).
MATMUL_MAX_N = 1024

# The reference's pinned budgets: a synthetic per-chip byte budget for a
# posture with no card to read (24 GiB), the enumerated-executable
# budget, and the worst-case padding fraction a {2^k, 3*2^k} ladder
# passes (its classes are at most 3/2 apart).
CHIP_HBM_BYTES_DEFAULT = 24 << 30
SURFACE_BUDGET_DEFAULT = 16384
PAD_WASTE_FRAC_DEFAULT = 0.55
# The card the port is built for, an H100 80GB HBM3: the total_memory
# torch reports for it.  The CLI's scan of the package prices the
# default serving posture at it; a fixture posture keeps the synthetic
# budget above unless it names its own.
H100_HBM_BYTES = 85_017_493_504

FOOTPRINT_RULES = ("peak-bytes", "surface-count", "padding-waste")
# A fixture posture written for the reference names its rules; the
# port's counterpart of each.
REFERENCE_RULES = {"jaxpr-peak-bytes": "peak-bytes"}

# The reference's executable kinds per bucket: the solo set (the rounds
# block warm and from scratch, the tail, the final detect) and, per
# batch rung > 1, the three batch-block modes and the batched detect.
SOLO_KINDS = ("rounds[warm]", "rounds[scratch]", "tail", "detect")
BATCH_MODES = ("warm", "cold", "scratch")
KINDS_PER_RUNG = len(BATCH_MODES) + 1


def grid_up(n: int, minimum: int = 1) -> int:
    """Smallest value >= n on the coarse {2^k, 3*2^k} grid (1, 2, 3, 4,
    6, 8, 12, 16, 24, 32, 48, 64, ...), the reference's rule.  The shape
    buckets (``serve/bucketer.py``) pad every graph's node and edge counts
    up to it; successive classes are at most 4/3 apart."""
    n = max(int(n), int(minimum), 1)
    p = 1
    while p < n:
        p *= 2
    q = (3 * p) // 4
    return q if p >= 4 and q >= n else p


def grid_values(lo: int, hi: int) -> List[int]:
    """Every grid class in [grid_up(lo), grid_up(hi)], ascending."""
    lo, hi = grid_up(lo), grid_up(hi)
    out, v = [], lo
    while v <= hi:
        out.append(v)
        v = grid_up(v + 1)
    return out


def prev_class(c: int, minimum: int) -> Optional[int]:
    """The grid class directly below ``c``, or None at the floor: a 2^k
    class sits above 3c/4, a 3*2^k class above 2c/3 (below 4, steps of
    1)."""
    if c <= minimum:
        return None
    if c < 4:
        prev = c - 1
    elif c & (c - 1) == 0:
        prev = (3 * c) // 4
    else:
        prev = (2 * c) // 3
    return max(prev, minimum)


def bucket_capacity(e_class: int) -> int:
    """``serve.bucketer.Bucket.capacity``: pack_edges' default headroom."""
    return 2 * e_class + 16


def bucket_agg_cap(e_class: int) -> int:
    """``serve.bucketer.Bucket.agg_cap`` (``graph.derive_agg_sizing`` of
    the capacity)."""
    cap = bucket_capacity(e_class)
    want = cap + cap // 8 + 1024
    return ((want + 4095) // 4096) * 4096


def bucket_bytes(n_class: int, e_class: int) -> int:
    """The reference's payload-scale proxy of one bucket, used by the
    padding rule only: 13 bytes an edge slot and 8 a node."""
    return 13 * bucket_capacity(e_class) + 8 * n_class


@dataclasses.dataclass(frozen=True)
class SurfaceSpec:
    """One serving posture: what the analyzer enumerates and budgets.
    Defaults are ``serve.server.ServeConfig``'s admission bounds and
    batch ladder and the default ensemble width."""

    max_nodes: int = 1 << 20
    max_edges: int = 1 << 22
    max_batch: int = 8
    n_p: int = 20
    algorithm: str = "louvain"
    hbm_bytes: int = CHIP_HBM_BYTES_DEFAULT
    surface_budget: int = SURFACE_BUDGET_DEFAULT
    pad_waste_frac: float = PAD_WASTE_FRAC_DEFAULT
    # explicit edge ladder for the padding rule (fixture mode)
    grid: Optional[Tuple[int, ...]] = None
    # restrict evaluation to these rules (fixture mode; None = all)
    rules: Optional[Tuple[str, ...]] = None
    origin: str = "<defaults>"
    origin_line: int = 0
    # the device the served runs take: FCTPU_ROUNDS_BLOCK=auto blocks
    # them only on the card (entrypoints.rounds_blocked)
    device: str = "cuda"

    _KEYS = ("max_nodes", "max_edges", "max_batch", "n_p", "algorithm",
             "hbm_bytes", "surface_budget", "pad_waste_frac", "grid",
             "rules")

    @classmethod
    def from_mapping(cls, d: Dict, origin: str = "<spec>",
                     origin_line: int = 0) -> "SurfaceSpec":
        unknown = set(d) - set(cls._KEYS)
        if unknown:
            raise ValueError(
                f"{origin}: unknown FOOTPRINT_SPEC key(s) "
                f"{sorted(unknown)}; known: {list(cls._KEYS)}")
        kw = dict(d)
        for k in ("grid", "rules"):
            if kw.get(k) is not None:
                kw[k] = tuple(kw[k])
        if kw.get("rules"):
            kw["rules"] = tuple(REFERENCE_RULES.get(r, r)
                                for r in kw["rules"])
            bad = set(kw["rules"]) - set(FOOTPRINT_RULES)
            if bad:
                raise ValueError(
                    f"{origin}: FOOTPRINT_SPEC rules {sorted(bad)} are "
                    f"not footprint rules {list(FOOTPRINT_RULES)}")
        return cls(origin=origin, origin_line=origin_line, **kw)

    def wants(self, rule: str) -> bool:
        return self.rules is None or rule in self.rules


def source_files(paths: Iterable[str]) -> List[str]:
    """The ``.py`` files under ``paths``, in walk order."""
    import os

    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", "build"))
                files.extend(os.path.join(root, f) for f in sorted(names)
                             if f.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    return files


def find_literals(paths: Iterable[str], name: str
                  ) -> List[Tuple[str, int, Dict]]:
    """``(file, line, dict)`` of every module-level ``name = {...}``
    literal in the sources under ``paths``.  A non-literal or non-dict
    value raises ValueError: a typo'd fixture must not silently
    evaluate the defaults."""
    import ast

    out = []
    for f in source_files(paths):
        try:
            with open(f, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=f)
        # fcheck: ok=swallowed-error (unreadable/unparsable files are the
        # lint's finding, syntax-error; the spec scan skips them)
        except (OSError, SyntaxError):
            continue
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name
                    for t in node.targets):
                d = ast.literal_eval(node.value)
                if not isinstance(d, dict):
                    raise ValueError(
                        f"{f}:{node.lineno}: {name} must be a dict literal")
                out.append((f, node.lineno, d))
    return out


def find_specs(paths: Iterable[str]) -> List[SurfaceSpec]:
    """Module-level ``FOOTPRINT_SPEC = {...}`` literals in the scanned
    sources (fixture mode)."""
    return [SurfaceSpec.from_mapping(d, origin=f, origin_line=line)
            for f, line, d in find_literals(paths, "FOOTPRINT_SPEC")]


# --------------------------------------------------------------------
# Surface enumeration and padding (torch-free)
# --------------------------------------------------------------------


def node_classes(spec: SurfaceSpec) -> List[int]:
    return grid_values(MIN_NODE_CLASS, spec.max_nodes)


def edge_classes(spec: SurfaceSpec) -> List[int]:
    return grid_values(MIN_EDGE_CLASS, spec.max_edges)


def min_member(c: int, minimum: int) -> int:
    """Smallest raw value that lands in class ``c``."""
    prev = prev_class(c, minimum)
    return 1 if prev is None else prev + 1


def reachable(n_class: int, e_class: int, spec: SurfaceSpec) -> bool:
    """Whether some admissible graph lands in bucket (n_class, e_class):
    a simple graph on ``n <= max_nodes`` nodes carries at most
    ``n(n-1)/2`` edges."""
    n_hi = min(n_class, spec.max_nodes)
    if grid_up(n_hi, MIN_NODE_CLASS) != n_class:
        return False
    e_lo = min_member(e_class, MIN_EDGE_CLASS)
    return e_lo <= min(spec.max_edges, n_hi * (n_hi - 1) // 2)


def surface_buckets(spec: SurfaceSpec) -> List[Tuple[int, int]]:
    return [(n, e) for n in node_classes(spec) for e in edge_classes(spec)
            if reachable(n, e, spec)]


def batch_rungs(max_batch: int) -> List[int]:
    return [b for b in BATCH_RUNGS if b <= max(int(max_batch), 1)]


def executables_per_bucket(spec: SurfaceSpec) -> int:
    """The reference's executable kinds one served bucket implies: the
    solo set plus KINDS_PER_RUNG per batch rung > 1."""
    n_rungs = len([b for b in batch_rungs(spec.max_batch) if b > 1])
    return len(SOLO_KINDS) + KINDS_PER_RUNG * n_rungs


def surface_count(spec: SurfaceSpec) -> int:
    return len(surface_buckets(spec)) * executables_per_bucket(spec)


def check_surface(spec: SurfaceSpec) -> List[Diagnostic]:
    count = surface_count(spec)
    if count <= spec.surface_budget:
        return []
    n_buckets = len(surface_buckets(spec))
    return [Diagnostic(
        rule="surface-count", file=spec.origin, line=spec.origin_line,
        message=f"the serving posture (max_nodes={spec.max_nodes}, "
                f"max_edges={spec.max_edges}, max_batch={spec.max_batch})"
                f" implies {count} compiled executables ({n_buckets} "
                f"reachable buckets x {executables_per_bucket(spec)} "
                f"kinds) > budget {spec.surface_budget}: a static-arg "
                f"axis or ladder change exploded the compile surface "
                f"(the static complement of CompileGuard)")]


def pad_fraction(n_class: int, e_class: int) -> Optional[float]:
    """Worst-case pad bytes / payload bytes of one bucket (its smallest
    member); None for floor buckets, which trade small-graph padding for
    one shared tiny-graph bucket."""
    if n_class <= MIN_NODE_CLASS or e_class <= MIN_EDGE_CLASS:
        return None
    n_min = min_member(n_class, MIN_NODE_CLASS)
    e_min = min_member(e_class, MIN_EDGE_CLASS)
    payload = bucket_bytes(n_min, e_min)
    return (bucket_bytes(n_class, e_class) - payload) / payload


def _grid_pad_fractions(grid: Sequence[int]) -> List[Tuple[int, float]]:
    """(class, worst pad fraction) per non-floor class of an explicit
    edge ladder (the fixture-mode ``grid``)."""
    out = []
    for prev, cur in zip(grid, grid[1:]):
        payload = bucket_bytes(MIN_NODE_CLASS, prev + 1)
        waste = (bucket_bytes(MIN_NODE_CLASS, cur) - payload) / payload
        out.append((cur, waste))
    return out


def max_pad_fraction(spec: SurfaceSpec) -> float:
    if spec.grid is not None:
        fracs = [w for _, w in _grid_pad_fractions(spec.grid)]
    else:
        fracs = [f for n, e in surface_buckets(spec)
                 if (f := pad_fraction(n, e)) is not None]
    return max(fracs, default=0.0)


def check_padding(spec: SurfaceSpec) -> List[Diagnostic]:
    if spec.grid is not None:
        worst = [(f"e{c}", w) for c, w in _grid_pad_fractions(spec.grid)
                 if w > spec.pad_waste_frac]
    else:
        worst = [(f"n{n}_e{e}", f) for n, e in surface_buckets(spec)
                 if (f := pad_fraction(n, e)) is not None
                 and f > spec.pad_waste_frac]
    return [Diagnostic(
        rule="padding-waste", file=spec.origin, line=spec.origin_line,
        message=f"bucket {key}: worst-case member pads "
                f"{frac:.0%} of its payload "
                f"(> {spec.pad_waste_frac:.0%}): the ladder's "
                f"class spacing broke the {{2^k, 3*2^k}} waste "
                f"bound (~50%)")
        for key, frac in worst[:8]]   # cap the flood; one is fatal


# --------------------------------------------------------------------
# The peak model (analysis/entrypoints.py prices each kind)
# --------------------------------------------------------------------


def _peak(kind: str, n_class: int, e_class: int, b: int, mode: str,
          spec: SurfaceSpec) -> Dict:
    from fastconsensus_tpu_torch.analysis.entrypoints import \
        serving_peak_bytes

    return serving_peak_bytes(kind, n_class, e_class, b=b, mode=mode,
                              n_p=spec.n_p, algorithm=spec.algorithm,
                              device=spec.device)


def _row(kind: str, n_class: int, e_class: int, b: int, mode: str,
         spec: SurfaceSpec) -> Dict:
    res = _peak(kind, n_class, e_class, b, mode, spec)
    return {"kind": kind, "bucket": f"n{n_class}_e{e_class}",
            "n_class": n_class, "e_class": e_class, "batch": b,
            "mode": mode, "peak_bytes": res["peak"],
            "arg_bytes": res["arg_bytes"], "out_bytes": res["out_bytes"]}


def _max_reachable_e(n_class: int, spec: SurfaceSpec) -> Optional[int]:
    cands = [e for e in edge_classes(spec) if reachable(n_class, e, spec)]
    return max(cands, default=None)


def _rep_kinds(spec: SurfaceSpec) -> List[Tuple[str, int, str]]:
    """The kinds the gate scans with: the warm batch round and the
    batched final detect at the top rung (solo equivalents when
    batching is off)."""
    top = batch_rungs(spec.max_batch)[-1]
    if top > 1:
        return [("batch", top, "warm"), ("detect-batch", top, "-")]
    return [("rounds", 1, "warm"), ("detect", 1, "-")]


def _worst_n_rows(e_class: int, spec: SurfaceSpec) -> List[int]:
    """The node classes the gate prices per edge class: the
    densest-connected posture (n = 2e) and the isolated-node-padded one
    (n = max_nodes)."""
    rows = {grid_up(min(2 * e_class, spec.max_nodes), MIN_NODE_CLASS),
            grid_up(spec.max_nodes, MIN_NODE_CLASS)}
    return sorted(n for n in rows if reachable(n, e_class, spec))


def scan_rows(spec: SurfaceSpec, stop_over_budget: int = 0) -> List[Dict]:
    """Representative-kind peaks per (edge class x worst node row),
    ascending in edge class; ``stop_over_budget`` > 0 stops after that
    many over-budget rows."""
    rows: List[Dict] = []
    over = 0
    for e_class in edge_classes(spec):
        for n_class in _worst_n_rows(e_class, spec):
            for kind, b, mode in _rep_kinds(spec):
                row = _row(kind, n_class, e_class, b, mode, spec)
                rows.append(row)
                if row["peak_bytes"] > spec.hbm_bytes:
                    over += 1
                    if stop_over_budget and over >= stop_over_budget:
                        return rows
    return rows


def _all_kind_rows(n_class: int, e_class: int, spec: SurfaceSpec
                   ) -> List[Dict]:
    """Every kind this bucket runs, priced."""
    top_rung = batch_rungs(spec.max_batch)[-1]
    return [_row(kind, n_class, e_class, b, mode, spec)
            for kind, b, mode in (
                [("rounds", 1, "warm"), ("rounds", 1, "scratch"),
                 ("tail", 1, "-"), ("detect", 1, "-")] +
                [("batch", top_rung, m) for m in BATCH_MODES
                 if top_rung > 1] +
                ([("detect-batch", top_rung, "-")] if top_rung > 1
                 else []))]


def _matmul_frontier(spec: SurfaceSpec) -> Optional[Tuple[int, int]]:
    """Largest matmul-path bucket (the sweep flips at MATMUL_MAX_N
    nodes, so this regime needs its own probe)."""
    ns = [n for n in node_classes(spec) if n <= MATMUL_MAX_N]
    if not ns:
        return None
    e = _max_reachable_e(max(ns), spec)
    return None if e is None else (max(ns), e)


def check_peak_bytes(spec: SurfaceSpec
                     ) -> Tuple[List[Diagnostic], List[Dict]]:
    """The ``peak-bytes`` gate (the counterpart of the reference's
    ``jaxpr-peak-bytes``): scan the ladder's worst node rows with the
    dominant kinds, then price every kind at the scan winners and the
    matmul frontier."""
    max_findings = 6
    scanned = scan_rows(spec, stop_over_budget=4)
    winners = sorted(scanned, key=lambda r: -r["peak_bytes"])[:2]
    gate_rows: List[Dict] = list(scanned)
    full_at = [(r["n_class"], r["e_class"]) for r in winners]
    mm = _matmul_frontier(spec)
    if mm is not None and mm not in full_at:
        full_at.append(mm)
    for n_class, e_class in dict.fromkeys(full_at):
        for row in _all_kind_rows(n_class, e_class, spec):
            if not any(r["bucket"] == row["bucket"]
                       and r["kind"] == row["kind"]
                       and r["mode"] == row["mode"] for r in gate_rows):
                gate_rows.append(row)
    diags = [Diagnostic(
        rule="peak-bytes", file=spec.origin, line=spec.origin_line,
        message=f"serving kind {r['kind']} at bucket {r['bucket']} "
                f"(B={r['batch']}, mode={r['mode']}) models a peak of "
                f"{r['peak_bytes']:,} device bytes > the per-chip budget "
                f"{spec.hbm_bytes:,} (--hbm-bytes): it runs out of "
                f"memory on first traffic unless kept off the chip "
                f"(--chip-max-edges / --max-nodes admission)")
        for r in gate_rows if r["peak_bytes"] > spec.hbm_bytes]
    return diags[:max_findings], gate_rows


def footprint_table(spec: SurfaceSpec, max_rows: int = 12) -> List[Dict]:
    """The per-bucket footprint table (the report's ``buckets`` block):
    the edge spine at power-of-two classes (plus the floor and top),
    each bucket at its densest-connected node class, the batched round
    at the top rung beside the solo round."""
    es = edge_classes(spec)
    spine = sorted(set([e for e in es if e & (e - 1) == 0] +
                       [es[0], es[-1]]))
    if len(spine) > max_rows:
        idx = {0, len(spine) - 1}
        step = (len(spine) - 1) / (max_rows - 1)
        idx |= {round(i * step) for i in range(max_rows)}
        spine = [spine[i] for i in sorted(idx)]
    rows: List[Dict] = []
    top_rung = batch_rungs(spec.max_batch)[-1]
    for e_class in spine:
        n_class = grid_up(min(2 * e_class, spec.max_nodes), MIN_NODE_CLASS)
        if not reachable(n_class, e_class, spec):
            continue
        batch = _peak("batch" if top_rung > 1 else "rounds", n_class,
                      e_class, top_rung, "warm", spec)
        solo = _peak("rounds", n_class, e_class, 1, "warm", spec)
        pad = pad_fraction(n_class, e_class)
        rows.append({
            "bucket": f"n{n_class}_e{e_class}",
            "n_class": n_class, "e_class": e_class,
            "capacity": bucket_capacity(e_class), "batch": top_rung,
            "peak_bytes": batch["peak"], "solo_peak_bytes": solo["peak"],
            "arg_bytes": batch["arg_bytes"],
            "out_bytes": batch["out_bytes"],
            "pad_frac": round(pad, 4) if pad is not None else None,
        })
    return rows


def derive_chip_ceiling(hbm_bytes: Optional[int] = None,
                        spec: Optional[SurfaceSpec] = None) -> Optional[int]:
    """The largest ladder edge class E such that EVERY edge class up to E
    fits ``hbm_bytes`` on one card: what ``serve --chip-max-edges auto``
    routes on.  Routing is by edge class alone, so the ceiling is a
    prefix property: the walk goes up the ladder and stops at the first
    edge class whose worst kind does not fit (peaks are not monotone in
    bucket size, so a binary search would be wrong).  Each edge class is
    priced at its densest-connected node class and the top batch rung,
    the larger of the batched round and the batched final detect.  None
    when not even the floor bucket fits."""
    spec = spec or SurfaceSpec()
    if hbm_bytes is None:
        hbm_bytes = spec.hbm_bytes
    ceiling: Optional[int] = None
    for e_class in edge_classes(spec):
        peak = edge_class_peak(e_class, spec)
        if peak is None:
            continue
        if peak > hbm_bytes:
            break
        ceiling = e_class
    return ceiling


def edge_class_peak(e_class: int, spec: SurfaceSpec) -> Optional[int]:
    """What :func:`derive_chip_ceiling` prices edge class ``e_class`` at
    (None when its densest-connected bucket is not reachable)."""
    n_class = grid_up(min(2 * e_class, spec.max_nodes), MIN_NODE_CLASS)
    if not reachable(n_class, e_class, spec):
        return None
    return max(_peak(k, n_class, e_class, b, m, spec)["peak"]
               for k, b, m in _rep_kinds(spec))


def evaluate(spec: SurfaceSpec, rules: Optional[Iterable[str]] = None,
             with_table: bool = False, with_ceiling: bool = False
             ) -> Tuple[List[Diagnostic], Dict]:
    """Run the selected footprint rules against one posture: (diagnostics,
    the report block of the module docstring's schema).  Only
    ``peak-bytes`` imports torch."""
    selected = set(rules) if rules is not None else set(FOOTPRINT_RULES)
    selected &= {r for r in FOOTPRINT_RULES if spec.wants(r)}
    diags: List[Diagnostic] = []
    block: Dict = {
        "tool": "fcheck-footprint",
        "version": 1,
        "config": {
            "max_nodes": spec.max_nodes, "max_edges": spec.max_edges,
            "max_batch": spec.max_batch, "n_p": spec.n_p,
            "algorithm": spec.algorithm, "hbm_bytes": spec.hbm_bytes,
            "surface_budget": spec.surface_budget,
            "pad_waste_frac": spec.pad_waste_frac,
        },
        "surface_count": surface_count(spec),
        "surface_budget": spec.surface_budget,
        "max_pad_frac": round(max_pad_fraction(spec), 4),
        "chip_ceiling_edges": None,
        "gate": [],
        "buckets": [],
    }
    if "surface-count" in selected:
        diags.extend(check_surface(spec))
    if "padding-waste" in selected:
        diags.extend(check_padding(spec))
    if "peak-bytes" in selected:
        peak_diags, gate_rows = check_peak_bytes(spec)
        diags.extend(peak_diags)
        block["gate"] = gate_rows
        if with_ceiling:
            block["chip_ceiling_edges"] = derive_chip_ceiling(
                spec.hbm_bytes, spec)
        if with_table:
            block["buckets"] = footprint_table(spec)
    return diags, block
