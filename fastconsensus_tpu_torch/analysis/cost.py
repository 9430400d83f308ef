"""fcheck-cost for the port: the serving tier's cost priors and the cost
rules, the torch-free counterpart of the reference's
``fastconsensus_tpu/analysis/cost.py``.

* **The ladder mirror** (``mirror_cost``, ``mirror_est_s``): the
  reference's closed-form fit of its traced jaxpr cost visitor over the
  bucket ladder, with its coefficients unchanged, under the reference's
  :class:`MachineModel`, the envelope of a CPU CI host (4e11 FLOP/s,
  4e11 B/s, 0.5 ms dispatch).
* **Runtime priors** (``static_service_prior``, ``spill_weight``): what
  routing (``serve/scheduler.py``) and shaping (``serve/shaping.py``)
  read, so a cold bucket's first Retry-After and shed decisions, and the
  spill weight of a queued bucket, come out as the reference's.
* **The rules**, all on the mirror as in the reference:
  ``cost-dead-compute`` (the frontier dead-compute bill over the
  reference's measured frontier series), ``cost-duality`` (the per-job
  saving of the top batch rung) and ``cost-roofline-regress`` (a
  fixture's ``kind@bucket`` baseline), with ``COST_SPEC`` fixture
  postures.

**These priors are not the H100's.**  The reference's jaxpr visitor
(``eqn_cost``, ``_trace_cost``) is not ported: it walks a traced
program, and the port runs eagerly with none to walk.  Its two traced
tables are priced on the mirror instead: ``gate`` and ``calibration``
carry the mirror's estimates of the same kinds and buckets.  A prior
calibrated for the card would change shaping decisions in the port
alone (``ROADMAP.md``); ``chip_smoke.py`` phase ``serve`` prints each
bucket's prior beside the device seconds the card measured.  The
reference's history twin of the regress rule (``obs/history.
check_costs``) and its calibration gate read committed bench artifacts
through ``obs/history.py``, which is not ported: the port has no bench
history yet.

**Report schema** (the ``cost`` block of ``python -m
fastconsensus_tpu_torch.analysis --json``), the reference's::

    {
      "tool": "fcheck-cost", "version": 1,
      "config":  {max_nodes, max_edges, max_batch, n_p, algorithm,
                  waste_budget, duality_min_saving, regress_frac,
                  peak_flops, hbm_bytes_per_s, dispatch_overhead_s},
      "frontier_series": [...],
      "dead_compute": {bucket, n_p, rounds, round_flops, per_round,
                       run_dead_frac, late_round_dead_frac, waste_budget},
      "duality": [ {bucket, batch, solo_est_s, batch_est_s,
                    per_job_est_s, per_job_saving_frac} ... ],
      "gate": [ {kind, bucket, batch, flops, hbm_bytes,
                 arith_intensity, est_device_s} ... ],
      "buckets": [ {bucket, n_class, e_class, flops, hbm_bytes,
                    arith_intensity, est_device_s} ... ],
      "calibration": {bucket, n_p, kind, est_device_ms, band}
    }
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Tuple

from fastconsensus_tpu_torch.analysis.diagnostics import Diagnostic
# MATMUL_MAX_N: the matmul/hash detection-path flip the mirror's regimes
# split at
from fastconsensus_tpu_torch.analysis.footprint import (
    MATMUL_MAX_N, MIN_NODE_CLASS, SurfaceSpec, batch_rungs, edge_classes,
    find_literals, grid_up, reachable)

COST_RULES = ("cost-dead-compute", "cost-duality", "cost-roofline-regress")

# The reference's pinned budgets: the run-level dead-compute budget, the
# per-job batched saving floor and the est_device_s growth that counts
# as a roofline regression.
WASTE_BUDGET_DEFAULT = 0.75
DUALITY_MIN_SAVING_DEFAULT = 0.0
REGRESS_FRAC_DEFAULT = 0.5

# The reference's measured fcqual frontier series (the fraction of lfr1k
# vertices still active entering each round) and the posture its
# dead-compute bill prices: bucket n1024_e6144 at n_p 20.
FRONTIER_SERIES_DEFAULT = (0.807, 0.533, 0.161, 0.059)
DEAD_BUCKET_DEFAULT = (1024, 6144)
DEAD_N_P_DEFAULT = 20

# The reference's effective envelope of its CPU CI host (sustained
# FLOP/s, bytes/s, per-executable dispatch cost).
PEAK_FLOPS_DEFAULT = 4.0e11
HBM_BW_DEFAULT = 4.0e11
DISPATCH_OVERHEAD_S_DEFAULT = 5.0e-4
# Predicted-vs-measured ratio the reference's calibration gate tolerates
# in either direction.
CALIBRATION_BAND = 4.0


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Roofline envelope: time = max(compute, traffic) + dispatch."""

    peak_flops: float = PEAK_FLOPS_DEFAULT
    hbm_bytes_per_s: float = HBM_BW_DEFAULT
    dispatch_overhead_s: float = DISPATCH_OVERHEAD_S_DEFAULT

    def est_device_s(self, flops: float, hbm_bytes: float) -> float:
        return max(flops / self.peak_flops,
                   hbm_bytes / self.hbm_bytes_per_s) \
            + self.dispatch_overhead_s


@dataclasses.dataclass(frozen=True)
class CostSpec:
    """One serving posture priced by the cost pass; the surface bounds
    are ``footprint.SurfaceSpec``'s."""

    max_nodes: int = 1 << 20
    max_edges: int = 1 << 22
    max_batch: int = 8
    n_p: int = 20
    algorithm: str = "louvain"
    waste_budget: float = WASTE_BUDGET_DEFAULT
    duality_min_saving: float = DUALITY_MIN_SAVING_DEFAULT
    regress_frac: float = REGRESS_FRAC_DEFAULT
    frontier_series: Tuple[float, ...] = FRONTIER_SERIES_DEFAULT
    # fixture-mode baseline: {"kind@bucket" or "kind@bucket:b":
    # est_device_s}, what cost-roofline-regress compares the mirror with
    baseline: Optional[Dict[str, float]] = None
    peak_flops: float = PEAK_FLOPS_DEFAULT
    hbm_bytes_per_s: float = HBM_BW_DEFAULT
    dispatch_overhead_s: float = DISPATCH_OVERHEAD_S_DEFAULT
    # restrict evaluation to these rules (fixture mode; None = all)
    rules: Optional[Tuple[str, ...]] = None
    origin: str = "<defaults>"
    origin_line: int = 0

    _KEYS = ("max_nodes", "max_edges", "max_batch", "n_p", "algorithm",
             "waste_budget", "duality_min_saving", "regress_frac",
             "frontier_series", "baseline", "peak_flops",
             "hbm_bytes_per_s", "dispatch_overhead_s", "rules")

    @classmethod
    def from_mapping(cls, d: Dict, origin: str = "<spec>",
                     origin_line: int = 0) -> "CostSpec":
        unknown = set(d) - set(cls._KEYS)
        if unknown:
            raise ValueError(
                f"{origin}: unknown COST_SPEC key(s) "
                f"{sorted(unknown)}; known: {list(cls._KEYS)}")
        kw = dict(d)
        for k in ("frontier_series", "rules"):
            if kw.get(k) is not None:
                kw[k] = tuple(kw[k])
        if kw.get("baseline") is not None and \
                not isinstance(kw["baseline"], dict):
            raise ValueError(
                f"{origin}: COST_SPEC baseline must be a dict of "
                f"'kind@bucket' -> est_device_s")
        if kw.get("rules"):
            bad = set(kw["rules"]) - set(COST_RULES)
            if bad:
                raise ValueError(
                    f"{origin}: COST_SPEC rules {sorted(bad)} are "
                    f"not cost rules {list(COST_RULES)}")
        return cls(origin=origin, origin_line=origin_line, **kw)

    def wants(self, rule: str) -> bool:
        return self.rules is None or rule in self.rules

    def machine(self) -> MachineModel:
        return MachineModel(self.peak_flops, self.hbm_bytes_per_s,
                            self.dispatch_overhead_s)

    def surface(self) -> SurfaceSpec:
        """The footprint-side view of this posture."""
        return SurfaceSpec(max_nodes=self.max_nodes,
                           max_edges=self.max_edges,
                           max_batch=self.max_batch, n_p=self.n_p,
                           algorithm=self.algorithm)


def find_specs(paths: Iterable[str]) -> List[CostSpec]:
    """Module-level ``COST_SPEC = {...}`` literals in the scanned sources
    (fixture mode)."""
    return [CostSpec.from_mapping(d, origin=f, origin_line=line)
            for f, line, d in find_literals(paths, "COST_SPEC")]


# The reference's least-squares fits of its traced visitor over the
# ladder, per kind and detection-path regime (matmul: n <= MATMUL_MAX_N;
# hash above), each linear in ensemble width n_p and batch rung b.
# rounds block, matmul regime: per-n_p flops ~ c3*n^3 + c2*n^2 + ce*e
_ROUNDS_MM_F = (2046.0, 19500.0, 1600.0)
# ...bytes ~ d2*n^2 + dn*n + de*e
_ROUNDS_MM_B = (2.37e5, 6.0e5, 2.55e5)
# rounds block, hash regime: per-n_p flops ~ fn*n + fe*e
_ROUNDS_HASH_F = (9.1e4, 3.48e5)
_ROUNDS_HASH_B = (1.32e6, 6.54e6)
# final detect, matmul regime: per-n_p flops ~ c3*n^3 + c2*n^2
_DETECT_MM_F = (64.0, 610.0)
_DETECT_MM_B = (7400.0, 2.5e4)
_DETECT_HASH_F = (2.4e3, 1.1e4)
_DETECT_HASH_B = (4.5e4, 2.0e5)
# tail merge: ~ (n + e) with a weak ensemble-width term
_TAIL_F = 300.0
_TAIL_B = 6000.0


def _mirror_rounds(n: int, e: int) -> Tuple[float, float]:
    if n <= MATMUL_MAX_N:
        c3, c2, ce = _ROUNDS_MM_F
        d2, dn, de = _ROUNDS_MM_B
        return (c3 * n ** 3 + c2 * n ** 2 + ce * e,
                d2 * n ** 2 + dn * n + de * e)
    fn, fe = _ROUNDS_HASH_F
    bn, be = _ROUNDS_HASH_B
    return (fn * n + fe * e, bn * n + be * e)


def _mirror_detect(n: int, e: int) -> Tuple[float, float]:
    if n <= MATMUL_MAX_N:
        c3, c2 = _DETECT_MM_F
        d2, dn = _DETECT_MM_B
        return (c3 * n ** 3 + c2 * n ** 2, d2 * n ** 2 + dn * n)
    fn, fe = _DETECT_HASH_F
    bn, be = _DETECT_HASH_B
    return (fn * n + fe * e, bn * n + be * e)


def mirror_cost(kind: str, n_class: int, e_class: int, b: int = 1,
                n_p: int = 20) -> Dict[str, float]:
    """{flops, hbm_bytes} of one surface kind (``rounds``/``batch``,
    ``detect``/``detect-batch``, ``tail``; a ``[mode]`` suffix is
    ignored) at one bucket, as the reference's mirror prices it."""
    base = kind.split("[", 1)[0]
    n, e = int(n_class), int(e_class)
    npp, bb = max(int(n_p), 1), max(int(b), 1)
    if base in ("rounds", "batch"):
        f, by = _mirror_rounds(n, e)
        return {"flops": f * npp * bb, "hbm_bytes": by * npp * bb}
    if base in ("detect", "detect-batch"):
        f, by = _mirror_detect(n, e)
        return {"flops": f * npp * bb, "hbm_bytes": by * npp * bb}
    if base == "tail":
        scale = (n + e) * (1.0 + npp / 16.0)
        return {"flops": _TAIL_F * scale, "hbm_bytes": _TAIL_B * scale}
    raise ValueError(f"unknown surface kind {kind!r}")


def mirror_est_s(kind: str, n_class: int, e_class: int, b: int = 1,
                 n_p: int = 20,
                 machine: Optional[MachineModel] = None) -> float:
    """Roofline seconds of one surface kind at one bucket."""
    m = machine or MachineModel()
    c = mirror_cost(kind, n_class, e_class, b=b, n_p=n_p)
    return m.est_device_s(c["flops"], c["hbm_bytes"])


_BUCKET_KEY_RE = re.compile(r"^n(\d+)_e(\d+)$")

# One backlog unit of the spill weighting = a job this long; weights are
# clamped to [1, SPILL_WEIGHT_MAX].
SPILL_COST_UNIT_S = 1.0
SPILL_WEIGHT_MAX = 16.0


def parse_bucket_key(bucket_key: str) -> Optional[Tuple[int, int]]:
    """``"n64_e96" -> (64, 96)``; None for anything unparseable."""
    m = _BUCKET_KEY_RE.match(str(bucket_key or ""))
    if not m:
        return None
    return int(m.group(1)), int(m.group(2))


def static_service_prior(bucket_key: str, n_p: int = 20,
                         algorithm: str = "louvain",
                         machine: Optional[MachineModel] = None
                         ) -> Optional[float]:
    """Cold-start device-seconds prior of one bucket: the mirrored
    roofline estimate of its solo rounds (None when the key is not a
    ladder bucket).  ``algorithm`` is accepted for signature parity; the
    mirror prices the Louvain family either way."""
    parsed = parse_bucket_key(bucket_key)
    if parsed is None:
        return None
    n, e = parsed
    return mirror_est_s("rounds", n, e, b=1, n_p=n_p, machine=machine)


def spill_weight(bucket_key: str, n_p: int = 20) -> float:
    """StickyScheduler backlog weight: a queued job of this bucket counts
    as ``prior / SPILL_COST_UNIT_S`` backlog units, clamped to
    [1, SPILL_WEIGHT_MAX]."""
    prior = static_service_prior(bucket_key, n_p=n_p)
    if prior is None:
        return 1.0
    return min(max(prior / SPILL_COST_UNIT_S, 1.0), SPILL_WEIGHT_MAX)


# --------------------------------------------------------------------
# The rules (on the mirror).
# --------------------------------------------------------------------


def dead_compute_bill(spec: CostSpec) -> Dict:
    """The frontier dead-compute bill: per round, the fraction of the
    rounds kind's FLOPs spent on vertices the measured frontier series
    says have left the active set (vertex-proportional round cost),
    priced at the lfr1k posture the series was measured on."""
    n, e = DEAD_BUCKET_DEFAULT
    n = grid_up(min(n, spec.max_nodes), MIN_NODE_CLASS)
    e = grid_up(min(e, spec.max_edges), MIN_NODE_CLASS)
    n_p = DEAD_N_P_DEFAULT
    round_flops = mirror_cost("rounds", n, e, b=1, n_p=n_p)["flops"]
    per_round = []
    for i, frac in enumerate(float(f) for f in spec.frontier_series):
        dead = max(0.0, min(1.0, 1.0 - frac))
        per_round.append({
            "round": i + 1,
            "frontier_frac": round(frac, 6),
            "dead_frac": round(dead, 6),
            "dead_flops": int(round_flops * dead),
        })
    dead_fracs = [r["dead_frac"] for r in per_round]
    run_dead = sum(dead_fracs) / len(dead_fracs) if dead_fracs else 0.0
    late = dead_fracs[len(dead_fracs) // 2:] or [0.0]
    return {
        "bucket": f"n{n}_e{e}",
        "n_p": n_p,
        "rounds": len(per_round),
        "round_flops": int(round_flops),
        "per_round": per_round,
        "run_dead_frac": round(run_dead, 6),
        "late_round_dead_frac": round(sum(late) / len(late), 6),
        "waste_budget": spec.waste_budget,
    }


def check_dead_compute(spec: CostSpec) -> Tuple[List[Diagnostic], Dict]:
    bill = dead_compute_bill(spec)
    diags: List[Diagnostic] = []
    if bill["run_dead_frac"] > spec.waste_budget:
        diags.append(Diagnostic(
            rule="cost-dead-compute",
            message=(
                f"frontier dead-compute bill: {bill['run_dead_frac']:.2f}"
                f" of the run's rounds-executable FLOPs at "
                f"{bill['bucket']} go to vertices the measured frontier "
                f"series has already frozen (late rounds "
                f"{bill['late_round_dead_frac']:.2f}), over the "
                f"{spec.waste_budget:.2f} waste budget "
                f"(--waste-budget): land the frontier mask or re-pin "
                f"the budget with the quantified bill"),
            file=spec.origin, line=spec.origin_line))
    return diags, bill


def _rep_buckets(spec: CostSpec) -> List[Tuple[int, int]]:
    """The buckets the duality and gate tables price: the ladder floor,
    the matmul sweep's top and a hash-sweep bucket, clamped to the
    posture."""
    surface = spec.surface()
    cands = [(MIN_NODE_CLASS, grid_up(96, MIN_NODE_CLASS)),
             (MATMUL_MAX_N, grid_up(3 * MATMUL_MAX_N // 2, MIN_NODE_CLASS)),
             (4 * MATMUL_MAX_N, grid_up(8 * MATMUL_MAX_N, MIN_NODE_CLASS))]
    out = []
    for n, e in cands:
        n = grid_up(min(n, spec.max_nodes), MIN_NODE_CLASS)
        e = grid_up(min(e, spec.max_edges), MIN_NODE_CLASS)
        if reachable(n, e, surface) and (n, e) not in out:
            out.append((n, e))
    return out


def duality_table(spec: CostSpec) -> List[Dict]:
    """Per representative bucket at the top batch rung: the solo and the
    batched estimate and the per-job saving the rung buys."""
    machine = spec.machine()
    top = batch_rungs(spec.max_batch)[-1]
    rows: List[Dict] = []
    for n, e in _rep_buckets(spec):
        solo = mirror_est_s("rounds", n, e, b=1, n_p=spec.n_p,
                            machine=machine)
        batch = mirror_est_s("batch", n, e, b=top, n_p=spec.n_p,
                             machine=machine) if top > 1 else solo
        per_job = batch / max(top, 1)
        saving = 1.0 - per_job / solo if solo > 0 else 0.0
        rows.append({
            "bucket": f"n{n}_e{e}",
            "batch": top,
            "solo_est_s": round(solo, 9),
            "batch_est_s": round(batch, 9),
            "per_job_est_s": round(per_job, 9),
            "per_job_saving_frac": round(saving, 6),
        })
    return rows


def check_duality(spec: CostSpec) -> Tuple[List[Diagnostic], List[Dict]]:
    rows = duality_table(spec)
    diags: List[Diagnostic] = []
    for row in rows:
        if row["per_job_saving_frac"] < spec.duality_min_saving:
            diags.append(Diagnostic(
                rule="cost-duality",
                message=(
                    f"solo/batch duality at {row['bucket']}: the "
                    f"B={row['batch']} rung saves "
                    f"{row['per_job_saving_frac']:.3f} per job over "
                    f"solo dispatch ({row['per_job_est_s']:.6f}s vs "
                    f"{row['solo_est_s']:.6f}s), under the "
                    f"{spec.duality_min_saving:.3f} floor — the "
                    f"two-path surface costs more than it returns "
                    f"here"),
                file=spec.origin, line=spec.origin_line))
            break   # one finding prices the posture; rows carry the rest
    return diags, rows


_BASELINE_KEY_RE = re.compile(
    r"^(?P<kind>[a-z-]+(?:\[[a-z]+\])?)@n(?P<n>\d+)_e(?P<e>\d+)"
    r"(?::(?P<b>\d+))?$")


def check_regress(spec: CostSpec) -> List[Diagnostic]:
    """Fixture-mode roofline regression: the mirror's estimates against
    the spec's baseline map."""
    if not spec.baseline:
        return []
    machine = spec.machine()
    diags: List[Diagnostic] = []
    for key in sorted(spec.baseline):
        m = _BASELINE_KEY_RE.match(key)
        if not m:
            raise ValueError(
                f"{spec.origin}: COST_SPEC baseline key {key!r} is not "
                f"'kind@n<N>_e<E>[:b]'")
        base_s = float(spec.baseline[key])
        est = mirror_est_s(m.group("kind"), int(m.group("n")),
                           int(m.group("e")), b=int(m.group("b") or 1),
                           n_p=spec.n_p, machine=machine)
        if base_s > 0 and est > base_s * (1.0 + spec.regress_frac):
            diags.append(Diagnostic(
                rule="cost-roofline-regress",
                message=(
                    f"roofline regression at {key}: modeled "
                    f"est_device_s {est:.6f}s is "
                    f"{est / base_s:.2f}x the committed baseline "
                    f"{base_s:.6f}s (tolerance "
                    f"+{spec.regress_frac:.0%}); re-baseline only "
                    f"with the perf change that justifies it"),
                file=spec.origin, line=spec.origin_line))
    return diags


def _cost_row(n: int, e: int, flops: float, hbm: float,
              machine: MachineModel) -> Dict:
    return {"bucket": f"n{n}_e{e}",
            "flops": int(flops), "hbm_bytes": int(hbm),
            "arith_intensity": round(flops / hbm, 6) if hbm else None,
            "est_device_s": round(machine.est_device_s(flops, hbm), 9)}


def gate_table(spec: CostSpec) -> List[Dict]:
    """Rows for the reference's 16 kinds per representative bucket (4
    solo + 4 per batch rung > 1), each priced on the mirror (the
    reference traces them; its modes share one program, as they share
    one mirror row here)."""
    machine = spec.machine()
    rows: List[Dict] = []
    for n, e in _rep_buckets(spec):
        kinds = [(f"rounds[{m}]", 1) for m in ("warm", "scratch")] + \
            [("tail", 1), ("detect", 1)]
        for rung in batch_rungs(spec.max_batch):
            if rung > 1:
                kinds += [(f"batch[{m}]", rung)
                          for m in ("warm", "cold", "scratch")]
                kinds.append(("detect-batch", rung))
        for label, b in kinds:
            c = mirror_cost(label, n, e, b=b, n_p=spec.n_p)
            rows.append({"kind": label, "batch": b,
                         **_cost_row(n, e, c["flops"], c["hbm_bytes"],
                                     machine)})
    return rows


def cost_table(spec: CostSpec, max_rows: int = 12) -> List[Dict]:
    """The mirror's per-bucket cost table (the report's ``buckets``
    block): the edge spine at power-of-two classes plus the floor and
    top, each at its densest-connected node class, solo rounds."""
    machine = spec.machine()
    surface = spec.surface()
    es = edge_classes(surface)
    spine = sorted(set([e for e in es if e & (e - 1) == 0] +
                       [es[0], es[-1]]))
    if len(spine) > max_rows:
        idx = {0, len(spine) - 1}
        step = (len(spine) - 1) / (max_rows - 1)
        idx |= {round(i * step) for i in range(max_rows)}
        spine = [spine[i] for i in sorted(idx)]
    rows: List[Dict] = []
    for e_class in spine:
        n_class = grid_up(min(2 * e_class, spec.max_nodes), MIN_NODE_CLASS)
        if not reachable(n_class, e_class, surface):
            continue
        c = mirror_cost("rounds", n_class, e_class, b=1, n_p=spec.n_p)
        row = _cost_row(n_class, e_class, c["flops"], c["hbm_bytes"],
                        machine)
        rows.append({"bucket": row.pop("bucket"), "n_class": n_class,
                     "e_class": e_class, **row})
    return rows


# The reference's serve_load posture the calibration block prices:
# karate-sized jobs (bucket n64_e96), louvain, n_p 4.
CALIBRATION_BUCKET = (64, 96)
CALIBRATION_N_P = 4


def calibration_block(spec: CostSpec) -> Dict:
    """The mirror's predicted device time at the reference's serve_load
    posture (``CALIBRATION_BUCKET``).  The reference compares it with its
    bench history (``obs/history.check_cost_calibration``); the port has
    no bench history, so nothing reads it yet."""
    n, e = CALIBRATION_BUCKET
    est = mirror_est_s("rounds", n, e, b=1, n_p=CALIBRATION_N_P,
                       machine=spec.machine())
    return {
        "bucket": f"n{n}_e{e}",
        "n_p": CALIBRATION_N_P,
        "kind": "rounds[warm]",
        "est_device_ms": round(est * 1000.0, 3),
        "band": CALIBRATION_BAND,
    }


def evaluate(spec: CostSpec, rules: Optional[Iterable[str]] = None,
             with_table: bool = False) -> Tuple[List[Diagnostic], Dict]:
    """Run the selected cost rules against one posture: (diagnostics, the
    report block of the module docstring's schema); ``with_table`` adds
    the gate, bucket and calibration tables."""
    selected = set(rules) if rules is not None else set(COST_RULES)
    selected &= {r for r in COST_RULES if spec.wants(r)}
    diags: List[Diagnostic] = []
    block: Dict = {
        "tool": "fcheck-cost",
        "version": 1,
        "config": {
            "max_nodes": spec.max_nodes, "max_edges": spec.max_edges,
            "max_batch": spec.max_batch, "n_p": spec.n_p,
            "algorithm": spec.algorithm,
            "waste_budget": spec.waste_budget,
            "duality_min_saving": spec.duality_min_saving,
            "regress_frac": spec.regress_frac,
            "peak_flops": spec.peak_flops,
            "hbm_bytes_per_s": spec.hbm_bytes_per_s,
            "dispatch_overhead_s": spec.dispatch_overhead_s,
        },
        "frontier_series": [round(float(f), 6)
                            for f in spec.frontier_series],
        "dead_compute": None,
        "duality": [],
        "gate": [],
        "buckets": [],
        "calibration": None,
    }
    if "cost-dead-compute" in selected:
        dead_diags, bill = check_dead_compute(spec)
        diags.extend(dead_diags)
        block["dead_compute"] = bill
    if "cost-duality" in selected:
        dual_diags, rows = check_duality(spec)
        diags.extend(dual_diags)
        block["duality"] = rows
    if "cost-roofline-regress" in selected:
        diags.extend(check_regress(spec))
    if with_table:
        block["gate"] = gate_table(spec)
        block["buckets"] = cost_table(spec)
        block["calibration"] = calibration_block(spec)
    return diags, block
