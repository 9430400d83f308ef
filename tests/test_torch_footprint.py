"""The port's footprint pass (``fastconsensus_tpu_torch/analysis/``).

The torch-free half (the ladder, surface enumeration, padding, fixture
postures, diagnostics) equals the reference's for equal inputs, function
by function over the reference's postures and fixtures.  The memory
model has no reference counterpart to hold it to (the reference traces
jaxprs; on the card ``chip_smoke.py`` phase ``footprint`` holds it to
``max_memory_allocated``), so here it is held to its own contract: the
bucket's worst case is at least the model at any slab of the bucket,
the model is the sum of its terms, and the ceiling is the ascending
prefix rule."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fastconsensus_tpu.analysis import diagnostics as jdiag
from fastconsensus_tpu.analysis import footprint as jfp
from fastconsensus_tpu_torch import sizing
from fastconsensus_tpu_torch.analysis import diagnostics as tdiag
from fastconsensus_tpu_torch.analysis import entrypoints as ep
from fastconsensus_tpu_torch.analysis import footprint as tfp
from fastconsensus_tpu_torch.engine import SLAB_SLOT_BYTES, tail_temp_bytes
from fastconsensus_tpu_torch.graph import (derive_agg_sizing,
                                           derive_dense_sizing,
                                           derive_hybrid_sizing)
from fastconsensus_tpu_torch.serve import bucketer
from fastconsensus_tpu_torch.utils.synth import planted_partition

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "analysis_fixtures"

# The reference's postures (tests/test_footprint.py) as SurfaceSpec
# keyword sets.
POSTURES = {
    "defaults": {},
    "tiny_budget": {"surface_budget": 10},
    "gappy_grid": {"grid": (64, 96, 128, 1024)},
    "ceiling": {"max_nodes": 512, "max_edges": 1024, "max_batch": 2,
                "n_p": 4},
    "schema": {"max_nodes": 256, "max_edges": 512, "max_batch": 2,
               "n_p": 4},
    "solo": {"max_nodes": 4096, "max_edges": 8192, "max_batch": 1},
}
FOOTPRINT_FIXTURES = sorted(
    p.name for p in FIXTURES.glob("*.py") if "FOOTPRINT_SPEC" in p.read_text())


def _pair(name):
    if name in POSTURES:
        kw = POSTURES[name]
        return jfp.SurfaceSpec(**kw), tfp.SurfaceSpec(**kw)
    j, = jfp.find_specs([str(FIXTURES / name)])
    t, = tfp.find_specs([str(FIXTURES / name)])
    return j, t


def _diags(ds):
    return [d.to_dict() for d in ds]


# (name, function of (module, spec) -> comparable value)
TORCH_FREE = {
    "node_classes": lambda m, s: m.node_classes(s),
    "edge_classes": lambda m, s: m.edge_classes(s),
    "surface_buckets": lambda m, s: m.surface_buckets(s),
    "batch_rungs": lambda m, s: m.batch_rungs(s.max_batch),
    "executables_per_bucket": lambda m, s: m.executables_per_bucket(s),
    "surface_count": lambda m, s: m.surface_count(s),
    "check_surface": lambda m, s: _diags(m.check_surface(s)),
    "pad_fraction": lambda m, s: [m.pad_fraction(n, e)
                                  for n, e in m.surface_buckets(s)],
    "max_pad_fraction": lambda m, s: m.max_pad_fraction(s),
    "check_padding": lambda m, s: _diags(m.check_padding(s)),
    "reachable": lambda m, s: [m.reachable(n, e, s)
                               for n in m.grid_values(64, 1 << 12)
                               for e in m.grid_values(64, 1 << 13)],
    "bucket_geometry": lambda m, s: [
        (m.bucket_capacity(e), m.bucket_agg_cap(e), m.bucket_bytes(n, e),
         m.prev_class(e, m.MIN_EDGE_CLASS), m.min_member(e, 64))
        for n, e in m.surface_buckets(s)[:200]],
    "evaluate_torch_free": lambda m, s: (
        lambda d, b: (_diags(d), b))(*m.evaluate(
            s, rules=["surface-count", "padding-waste"])),
}


@pytest.mark.parametrize("posture", sorted(POSTURES) + FOOTPRINT_FIXTURES)
@pytest.mark.parametrize("fn", sorted(TORCH_FREE))
def test_torch_free_function_equals_reference(fn, posture):
    j, t = _pair(posture)
    assert TORCH_FREE[fn](tfp, t) == TORCH_FREE[fn](jfp, j)


def test_constants_and_spec_fields_equal_reference():
    for name in ("CHIP_HBM_BYTES_DEFAULT", "SURFACE_BUDGET_DEFAULT",
                 "PAD_WASTE_FRAC_DEFAULT", "MIN_NODE_CLASS",
                 "MIN_EDGE_CLASS", "BATCH_RUNGS", "MATMUL_MAX_N",
                 "SOLO_KINDS", "BATCH_MODES", "KINDS_PER_RUNG"):
        assert getattr(tfp, name) == getattr(jfp, name), name
    assert tfp.SurfaceSpec._KEYS == jfp.SurfaceSpec._KEYS
    skip = {"rules"}
    for name in FOOTPRINT_FIXTURES:
        j, t = _pair(name)
        assert {f: getattr(t, f) for f in t._KEYS if f not in skip} == \
            {f: getattr(j, f) for f in j._KEYS if f not in skip}
        # the reference's jaxpr-peak-bytes maps onto its counterpart
        assert t.rules == tuple(tfp.REFERENCE_RULES.get(r, r)
                                for r in j.rules)
    from fastconsensus_tpu_torch.consensus import ConsensusConfig
    from fastconsensus_tpu_torch.serve.server import ServeConfig

    spec, cfg = tfp.SurfaceSpec(), ServeConfig()
    assert (spec.max_nodes, spec.max_edges, spec.max_batch, spec.n_p) == \
        (cfg.max_nodes, cfg.max_edges, cfg.max_batch, ConsensusConfig().n_p)


def test_find_specs_rejects_junk_as_the_reference(tmp_path):
    for text in ("FOOTPRINT_SPEC = {'no_such': 1}\n",
                 "FOOTPRINT_SPEC = [1]\n",
                 "FOOTPRINT_SPEC = {'rules': ['cost-duality']}\n"):
        (tmp_path / "bad.py").write_text(text)
        with pytest.raises(ValueError) as je:
            jfp.find_specs([str(tmp_path)])
        with pytest.raises(ValueError) as te:
            tfp.find_specs([str(tmp_path)])
        assert str(te.value).split(":")[0] == str(je.value).split(":")[0]


def test_diagnostics_module_is_the_reference_copy():
    ref = (REPO / "fastconsensus_tpu" / "analysis" / "diagnostics.py")
    port = (REPO / "fastconsensus_tpu_torch" / "analysis" / "diagnostics.py")
    assert port.read_text() == ref.read_text()
    src = "x = 1  # fcheck: ok=peak-bytes\n# fcheck: ok\n\ny = 2\n"
    assert tdiag.parse_pragmas(src) == jdiag.parse_pragmas(src)


def test_report_json_round_trip_equals_reference():
    def report(mod):
        r = mod.Report(n_files=3, n_suppressed=1)
        r.extend([mod.Diagnostic(rule="surface-count", message="m",
                                 file="f.py", line=7),
                  mod.Diagnostic(rule="padding-waste", message="w",
                                 severity=mod.SEVERITY_WARNING)])
        r.footprint = {"surface_count": 5, "surface_budget": 9,
                       "max_pad_frac": 0.5, "chip_ceiling_edges": None}
        return r

    t, j = report(tdiag), report(jdiag)
    assert t.to_json() == j.to_json()
    assert t.format_human() == j.format_human()
    back = [tdiag.Diagnostic(**d)
            for d in json.loads(t.to_json())["diagnostics"]]
    assert back == t.diagnostics


def test_torch_free_half_imports_no_torch():
    code = ("import sys\n"
            "from fastconsensus_tpu_torch.analysis import cost, footprint\n"
            "footprint.evaluate(footprint.SurfaceSpec(),\n"
            "                   rules=['surface-count', 'padding-waste'])\n"
            "cost.evaluate(cost.CostSpec(), with_table=True)\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "assert not any(m.startswith('jax') for m in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


# -- the memory model ---------------------------------------------------


def _bucket_slab(n, k, p_in, p_out, seed, rederive, hubs=0):
    """A seeded planted graph (``hubs`` of its nodes joined to 700 others
    each) packed into its bucket, with its row budgets re-derived from its
    degrees as a served run re-derives them (``rederive``)."""
    edges, _ = planted_partition(n, k, p_in, p_out, seed=seed)
    if hubs:
        rng = np.random.default_rng(seed)
        edges = np.concatenate([edges, [
            (h, v) for h in range(hubs)
            for v in rng.choice(np.arange(hubs, n), 700, replace=False)]])
    slab, bucket = bucketer.pad_to_bucket(edges, n, device="cpu")
    if rederive:
        deg = slab.degrees().numpy()
        alive = int(slab.num_alive())
        d_hyb, hub = derive_hybrid_sizing(deg, slab.n_nodes, alive)
        slab = slab.with_statics(
            d_cap=derive_dense_sizing(deg, slab.n_nodes), d_hyb=d_hyb,
            hub_cap=hub, agg_cap=derive_agg_sizing(alive))
    return slab, bucket


GRAPHS = {
    "matmul": (600, 12, 0.2, 0.01, 1, False),
    "hash": (1500, 15, 0.05, 0.002, 2, False),
    "rederived": (2000, 20, 0.04, 0.002, 3, True),
    "wide": (1800, 6, 0.02, 0.0005, 4, True),
    "hybrid": (3000, 30, 0.03, 0.0005, 5, True, 6),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("kind", ep.SERVING_KINDS)
def test_bucket_worst_case_bounds_the_slab_model(kind, graph):
    slab, bucket = _bucket_slab(*GRAPHS[graph])
    assert ep.path_of(slab) == {"rederived": "dense", "wide": "dense"}.get(
        graph, graph)
    for algorithm in ep.ALGORITHMS:
        for b in (1, 4):
            a = ep.slab_peak_bytes(kind, slab, b=b, n_p=6,
                                   algorithm=algorithm,
                                   n_closure=bucket.n_closure)
            w = ep.serving_peak_bytes(kind, bucket.n_class, bucket.e_class,
                                      b=b, n_p=6, algorithm=algorithm)
            assert w["peak"] >= a["peak"] > a["arg_bytes"] > 0, \
                (algorithm, b, a, w)


@pytest.mark.parametrize("kind", ep.SERVING_KINDS)
def test_model_is_the_sum_of_its_terms(kind):
    """(a) = the arguments + the chunk of ``members_per_call`` members
    times one member's model (plus its copy of the graph's state when
    stacked) beside the state and labels, or the tail's temporaries:
    each term from the function that defines it."""
    from fastconsensus_tpu_torch.models import louvain

    slab, bucket = _bucket_slab(*GRAPHS["rederived"])
    n_p, b, lc = 6, (4 if kind in ("batch", "detect-batch") else 1), \
        bucket.n_closure
    t = ep.peak_terms(kind, slab, b=b, n_p=n_p, n_closure=lc)
    k = b * n_p
    stacked = kind in ("batch", "detect-batch")
    member = louvain.sweep_temp_bytes(slab)
    copy = ep.copy_bytes(slab) if stacked else 0
    sl = SLAB_SLOT_BYTES * slab.capacity
    lab = 8 * n_p * slab.n_nodes
    tail = tail_temp_bytes(slab, n_p, lc)
    if kind != "tail":
        chunk = sizing.members_per_call(slab, k, louvain.sweep_temp_bytes,
                                        copy)
        assert (t["detect_member"], t["detect_copy"], t["detect_chunk"]) \
            == (member, copy, chunk)
        assert t["detect_work"] == chunk * (member + copy)
        state = b * ep.state_bytes(slab)
        labels = 8 * k * slab.n_nodes
        detect = state + max(t["detect_build"], chunk * (member + copy)
                             + labels, 2 * labels)
        assert t["detect"] == detect
    want = {
        "detect": sl + 16 * n_p + lab + t["detect"],
        "tail": sl + 2 * lab + 16 + tail,
        "rounds": sl + lab + 16 + max(16 * n_p + t["detect"], lab + tail),
        "batch": b * (sl + lab + 16) + max(
            b * sl + b * lab + 16 * k + t["detect"],
            b * lab + (b - 1) * sl + tail),
        "detect-batch": 2 * b * sl + 16 * k + b * lab + t["detect"],
    }[kind]
    assert t["peak"] == want
    assert ep.slab_peak_bytes(kind, slab, b=b, n_p=n_p,
                              n_closure=lc)["peak"] == want


def test_member_over_budget_runs_alone_and_says_so(monkeypatch):
    slab, bucket = _bucket_slab(*GRAPHS["rederived"])
    monkeypatch.setenv("FCTPU_ENSEMBLE_BUDGET_MB", "1")
    a = ep.slab_peak_bytes("detect", slab, n_p=6)
    assert a["chunk"] == 1 and a["over_budget"]
    monkeypatch.setenv("FCTPU_ENSEMBLE_BUDGET_MB", "4096")
    a = ep.slab_peak_bytes("detect", slab, n_p=6)
    assert a["chunk"] == 6 and not a["over_budget"]


def test_kind_and_mode_are_checked():
    slab, _ = _bucket_slab(*GRAPHS["matmul"])
    with pytest.raises(ValueError, match="unknown serving kind"):
        ep.slab_peak_bytes("compile", slab)
    with pytest.raises(ValueError, match="no mode"):
        ep.slab_peak_bytes("rounds", slab, mode="cold")
    with pytest.raises(ValueError, match="algorithm"):
        ep.slab_peak_bytes("detect", slab, algorithm="cnm")


SMALL = tfp.SurfaceSpec(max_nodes=512, max_edges=1024, max_batch=2, n_p=4)


def test_chip_ceiling_is_the_ascending_prefix_rule():
    ladder = tfp.edge_classes(SMALL)
    peaks = [tfp.edge_class_peak(e, SMALL) for e in ladder]
    assert tfp.derive_chip_ceiling(1 << 40, SMALL) == ladder[-1]
    assert tfp.derive_chip_ceiling(1000, SMALL) is None
    for i in range(len(ladder) - 1):
        # a budget between two edge classes' peaks: every class up to
        # the first that does not fit, and nothing past it
        budget = peaks[i]
        first_over = next((j for j, p in enumerate(peaks)
                           if p is not None and p > budget), None)
        want = max((e for e, p in zip(ladder[:first_over], peaks)
                    if p is not None), default=None)
        assert tfp.derive_chip_ceiling(budget, SMALL) == want


def test_chip_ceiling_stops_at_the_first_misfit(monkeypatch):
    """Peaks are not monotone along the ladder: a later class that fits
    again is not admitted past one that does not."""
    ladder = tfp.edge_classes(SMALL)
    fake = {e: (10 if i != 2 else 1000) for i, e in enumerate(ladder)}
    monkeypatch.setattr(tfp, "edge_class_peak",
                        lambda e, spec: fake[e])
    assert tfp.derive_chip_ceiling(100, SMALL) == ladder[1]


def test_peak_rule_fires_on_its_fixture_only():
    def run(name):
        spec, = tfp.find_specs([str(FIXTURES / name)])
        return {d.rule for d in tfp.evaluate(spec)[0]}

    assert run("bad_footprint_budget.py") == {"peak-bytes"}
    assert run("ok_footprint_budget.py") == set()
    assert run("bad_surface_budget.py") == {"surface-count"}
    assert run("bad_padding_ladder.py") == {"padding-waste"}


def test_evaluate_block_has_the_reference_keys():
    spec = dataclasses.replace(SMALL, max_edges=512, max_nodes=256)
    diags, block = tfp.evaluate(spec, with_table=True, with_ceiling=True)
    assert not diags
    _, jblock = jfp.evaluate(jfp.SurfaceSpec(
        max_nodes=256, max_edges=512, max_batch=2, n_p=4),
        rules=["surface-count", "padding-waste"])
    assert set(block) == set(jblock)
    assert set(block["config"]) == set(jblock["config"])
    assert block["chip_ceiling_edges"] in tfp.edge_classes(spec)
    # the reference's row schemas (its scan_rows and footprint_table)
    assert block["gate"] and all(
        set(r) == {"kind", "bucket", "n_class", "e_class", "batch", "mode",
                   "peak_bytes", "arg_bytes", "out_bytes"}
        for r in block["gate"])
    assert block["buckets"] and all(
        set(r) == {"bucket", "n_class", "e_class", "capacity", "batch",
                   "peak_bytes", "solo_peak_bytes", "arg_bytes",
                   "out_bytes", "pad_frac"} and
        r["peak_bytes"] >= r["solo_peak_bytes"] > 0
        for r in block["buckets"])


def test_meta_slabs_hold_no_memory():
    slab = ep.meta_slab(1 << 20, (1 << 23) + 16, d_hyb=64, hub_cap=4096)
    assert slab.src.device.type == "meta" and slab.capacity == (1 << 23) + 16
    assert np.isfinite(ep.slab_peak_bytes("detect", slab)["peak"])
