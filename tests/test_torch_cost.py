"""The port's cost pass (``fastconsensus_tpu_torch/analysis/cost.py``)
against the reference's, function by function over the reference's
postures (``tests/test_cost.py``) and its ``COST_SPEC`` fixtures: the
rules, their diagnostics and the report block are equal.  The
reference's traced tables (``gate``, ``calibration``) have no traced
counterpart in the port; the port prices them on the mirror, which is
held to the reference's mirror."""

import dataclasses
from pathlib import Path

import pytest
import torch

from fastconsensus_tpu.analysis import cost as jcost
from fastconsensus_tpu_torch.analysis import cost as tcost

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "analysis_fixtures"

POSTURES = {
    "defaults": {},
    "tight_waste": {"waste_budget": 0.25},
    "duality_floor": {"duality_min_saving": 0.9},
    "stale_baseline": {"baseline": {"rounds[warm]@n64_e96": 0.001}},
    "generous_baseline": {"baseline": {"rounds[warm]@n64_e96": 1.0,
                                       "batch[cold]@n1024_e1536:4": 5.0,
                                       "detect-batch@n4096_e8192:8": 1e-4,
                                       "tail@n64_e96": 1e-9}},
    "schema": {"max_nodes": 256, "max_edges": 512, "max_batch": 2,
               "n_p": 4},
    "solo": {"max_batch": 1, "n_p": 8},
    "short_series": {"frontier_series": (0.5, 0.1, 0.02),
                     "max_nodes": 512, "max_edges": 4096},
    "machine": {"peak_flops": 6.7e13, "hbm_bytes_per_s": 3.35e12,
                "dispatch_overhead_s": 1e-5},
}
COST_FIXTURES = sorted(
    p.name for p in FIXTURES.glob("*.py") if "COST_SPEC" in p.read_text())


def _pair(name):
    if name in POSTURES:
        kw = POSTURES[name]
        return jcost.CostSpec(**kw), tcost.CostSpec(**kw)
    j, = jcost.find_specs([str(FIXTURES / name)])
    t, = tcost.find_specs([str(FIXTURES / name)])
    return j, t


def _diags(ds):
    return [d.to_dict() for d in ds]


TABLES = {
    "dead_compute_bill": lambda m, s: m.dead_compute_bill(s),
    "check_dead_compute": lambda m, s: (
        lambda d, b: (_diags(d), b))(*m.check_dead_compute(s)),
    "duality_table": lambda m, s: m.duality_table(s),
    "check_duality": lambda m, s: (
        lambda d, r: (_diags(d), r))(*m.check_duality(s)),
    "check_regress": lambda m, s: _diags(m.check_regress(s)),
    "cost_table": lambda m, s: m.cost_table(s),
    "rep_buckets": lambda m, s: m._rep_buckets(s),
    "evaluate": lambda m, s: (lambda d, b: (_diags(d), b))(*m.evaluate(s)),
}


@pytest.mark.parametrize("posture", sorted(POSTURES) + COST_FIXTURES)
@pytest.mark.parametrize("fn", sorted(TABLES))
def test_cost_function_equals_reference(fn, posture):
    j, t = _pair(posture)
    assert TABLES[fn](tcost, t) == TABLES[fn](jcost, j)


def test_constants_and_spec_fields_equal_reference():
    for name in ("COST_RULES", "WASTE_BUDGET_DEFAULT",
                 "DUALITY_MIN_SAVING_DEFAULT", "REGRESS_FRAC_DEFAULT",
                 "FRONTIER_SERIES_DEFAULT", "DEAD_BUCKET_DEFAULT",
                 "DEAD_N_P_DEFAULT", "PEAK_FLOPS_DEFAULT",
                 "HBM_BW_DEFAULT", "DISPATCH_OVERHEAD_S_DEFAULT",
                 "CALIBRATION_BAND", "CALIBRATION_BUCKET",
                 "CALIBRATION_N_P"):
        assert getattr(tcost, name) == getattr(jcost, name), name
    assert tcost.CostSpec._KEYS == jcost.CostSpec._KEYS
    for name in COST_FIXTURES:
        j, t = _pair(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("text,words", [
    ("COST_SPEC = {'no_such': 1}\n", "no_such"),
    ("COST_SPEC = {'rules': ['surface-count']}\n", "not cost rules"),
    ("COST_SPEC = {'baseline': 3}\n", "baseline"),
])
def test_find_specs_rejects_junk_as_the_reference(tmp_path, text, words):
    (tmp_path / "bad.py").write_text(text)
    with pytest.raises(ValueError, match=words) as te:
        tcost.find_specs([str(tmp_path)])
    with pytest.raises(ValueError, match=words) as je:
        jcost.find_specs([str(tmp_path)])
    assert str(te.value) == str(je.value)


def test_bad_baseline_key_raises_as_the_reference():
    spec = {"baseline": {"junk": 1.0}}
    with pytest.raises(ValueError, match="kind@n") as te:
        tcost.check_regress(tcost.CostSpec(**spec))
    with pytest.raises(ValueError, match="kind@n") as je:
        jcost.check_regress(jcost.CostSpec(**spec))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("posture", ["defaults", "schema", "solo",
                                     "machine"])
def test_mirror_tables_price_the_reference_mirror(posture):
    """The gate and calibration tables the reference traces are priced
    on the mirror: each row is the reference mirror's estimate of that
    kind at that bucket, and the kinds are the reference's 16."""
    j, t = _pair(posture)
    machine = jcost.MachineModel(j.peak_flops, j.hbm_bytes_per_s,
                                 j.dispatch_overhead_s)
    rows = tcost.gate_table(t)
    per_bucket = len(jcost.batch_rungs(j.max_batch)) * 4
    assert len(rows) == per_bucket * len(jcost._rep_buckets(j))
    for row in rows:
        n, e = jcost.parse_bucket_key(row["bucket"])
        c = jcost.mirror_cost(row["kind"], n, e, b=row["batch"], n_p=j.n_p)
        assert row["flops"] == int(c["flops"])
        assert row["hbm_bytes"] == int(c["hbm_bytes"])
        assert row["est_device_s"] == round(machine.est_device_s(
            c["flops"], c["hbm_bytes"]), 9)
    cal = tcost.calibration_block(t)
    est = jcost.mirror_est_s("rounds", 64, 96, b=1, n_p=4, machine=machine)
    assert cal == {"bucket": "n64_e96", "n_p": 4, "kind": "rounds[warm]",
                   "est_device_ms": round(est * 1000.0, 3),
                   "band": jcost.CALIBRATION_BAND}
    _, block = tcost.evaluate(t, with_table=True)
    assert block["gate"] == rows and block["calibration"] == cal
    assert block["buckets"] == jcost.cost_table(j)
