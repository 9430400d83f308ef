"""The port's analysis CLI (``python -m fastconsensus_tpu_torch.analysis``)
and the server's ``--chip-max-edges auto`` / ``--hbm-bytes``, against
the reference's exit codes and messages.

The reference's ceiling needs its traced peak model, which cannot run in
this environment (``tests/test_footprint.py`` fails on ``jax.core.Var``
here), so the server cases pin both packages' ``derive_chip_ceiling`` to
the same value and compare what each server does with it."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fastconsensus_tpu.analysis import footprint as jfp
from fastconsensus_tpu_torch.analysis import footprint as tfp
from fastconsensus_tpu_torch.analysis.__main__ import main as analysis_main

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "analysis_fixtures"
TORCH_FIXTURES = REPO / "tests" / "torch_analysis_fixtures"


# the source rules that fire on the reference's fixture directory: its
# concurrency and fault fixtures are plain Python, and its key-reuse and
# sync-in-loop fixtures use the same idioms (its float64 fixture is jnp's)
REF_SOURCE_RULES = {
    "key-reuse", "sync-in-loop", "guarded-field", "lock-order",
    "blocking-under-lock", "notify-outside-lock", "unguarded-root-write",
    "escape-thread-root", "swallowed-error", "unmapped-http-error",
    "resource-leak"}
SOURCE_RULES = {
    "key-reuse", "sync-in-loop", "f64-dtype", "syntax-error",
    "guarded-field", "lock-order", "blocking-under-lock",
    "notify-outside-lock", "unguarded-root-write", "escape-thread-root",
    "swallowed-error", "unmapped-http-error", "resource-leak"}


@pytest.mark.parametrize("args,rc,rules", [
    (["--only", "surface-count,padding-waste"], 0, set()),
    ([str(FIXTURES / "ok_surface_budget.py"),
      str(FIXTURES / "ok_cost_waste.py")], 0, set()),
    ([str(FIXTURES / "bad_surface_budget.py")], 1, {"surface-count"}),
    ([str(FIXTURES / "bad_padding_ladder.py")], 1, {"padding-waste"}),
    ([str(FIXTURES / "bad_footprint_budget.py")], 1, {"peak-bytes"}),
    ([str(FIXTURES / "bad_cost_regress.py")], 1, {"cost-roofline-regress"}),
    ([str(FIXTURES)], 1, {"surface-count", "padding-waste", "peak-bytes",
                          "cost-dead-compute", "cost-duality",
                          "cost-roofline-regress"} | REF_SOURCE_RULES),
    (["--only", "peak-bytes", "--hbm-bytes", "1000000"], 1,
     {"peak-bytes"}),
    ([str(FIXTURES), "--only", "cost-duality"], 1, {"cost-duality"}),
    # no paths: the port's own package, clean under every pass
    ([], 0, set()),
    ([str(TORCH_FIXTURES)], 1, SOURCE_RULES),
])
def test_cli_exit_codes_and_json(tmp_path, args, rc, rules):
    out = tmp_path / "r.json"
    assert analysis_main(args + ["--json", str(out), "--quiet"]) == rc
    report = json.loads(out.read_text())
    assert report["tool"] == "fcheck"
    assert {d["rule"] for d in report["diagnostics"]} == rules
    assert report["n_diagnostics"] == len(report["diagnostics"])


@pytest.mark.parametrize("rule", ["phantom-reader", "schema-drift",
                                  "dead-counter", "event-vocab",
                                  "doc-drift"])
def test_unported_rule_exits_2_naming_the_queue(capsys, rule):
    """The name-contracts rules are the reference's pass still to port."""
    assert analysis_main(["--only", rule]) == 2
    err = capsys.readouterr().err
    assert rule in err and "ROADMAP.md, Queue 1 item 4" in err


@pytest.mark.parametrize("rule", ["jaxpr-peak-bytes", "jaxpr-f64",
                                  "traced-branch", "retrace-risk",
                                  "weak-static-arg", "kernel-tracer-closure",
                                  "module-jnp-const", "mesh-axis"])
def test_jit_only_rule_exits_2_as_not_applicable(capsys, rule):
    assert analysis_main(["--only", rule]) == 2
    err = capsys.readouterr().err
    assert rule in err and "not applicable to eager PyTorch" in err
    assert "ROADMAP" not in err


@pytest.mark.parametrize("rule,bad,ok", [
    ("lock-order", "bad_lock_order.py", "ok_lock_order.py"),
    ("key-reuse", "bad_key_reuse.py", "ok_key_reuse.py"),
    ("swallowed-error", "bad_swallowed_error.py", "ok_swallowed_error.py"),
    ("sync-in-loop", "bad_sync_loop.py", "ok_sync_loop.py"),
    ("f64-dtype", "bad_f64.py", "ok_f64.py"),
    ("blocking-under-lock", "bad_blocking_sync.py", "ok_blocking_sync.py"),
])
def test_ported_rule_exits_1_on_bad_and_0_on_ok(capsys, rule, bad, ok):
    assert analysis_main(["--only", rule, "--quiet",
                          str(TORCH_FIXTURES / bad)]) == 1
    assert analysis_main(["--only", rule, str(TORCH_FIXTURES / bad)]) == 1
    assert f"[{rule}]" in capsys.readouterr().out
    assert analysis_main(["--only", rule, "--quiet",
                          str(TORCH_FIXTURES / ok)]) == 0


def test_package_scan_at_the_synthetic_budget_still_fires_peak_bytes():
    """The package's posture is priced at the port's card; at the
    reference's synthetic 24 GiB the top bucket's batch kinds do not
    fit, and the rule says so."""
    assert tfp.H100_HBM_BYTES > tfp.CHIP_HBM_BYTES_DEFAULT
    diags, _ = tfp.evaluate(tfp.SurfaceSpec(), rules={"peak-bytes"})
    assert diags and {d.rule for d in diags} == {"peak-bytes"}
    diags, _ = tfp.evaluate(tfp.SurfaceSpec(hbm_bytes=tfp.H100_HBM_BYTES),
                            rules={"peak-bytes"})
    assert not diags


@pytest.mark.parametrize("args,words", [
    (["--only", "no-such-rule"], "unknown rule id"),
    (["--footprint-out", "x.json", str(FIXTURES / "ok_surface_budget.py")],
     "--footprint-out needs the footprint pass"),
])
def test_cli_usage_errors_exit_2(capsys, args, words):
    assert analysis_main(args) == 2
    assert words in capsys.readouterr().err


def test_cli_bad_fixture_spec_exits_2(tmp_path, capsys):
    (tmp_path / "bad.py").write_text("FOOTPRINT_SPEC = {'no_such': 1}\n")
    assert analysis_main([str(tmp_path)]) == 2
    assert "no_such" in capsys.readouterr().err


def test_python_m_on_the_default_posture_writes_both_blocks(tmp_path):
    out = tmp_path / "r.json"
    fp_out = tmp_path / "fp.json"
    proc = subprocess.run(
        [sys.executable, "-m", "fastconsensus_tpu_torch.analysis",
         "--json", str(out), "--footprint-out", str(fp_out)], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode in (0, 1), proc.stderr
    report = json.loads(out.read_text())
    block = report["footprint"]
    assert block == json.loads(fp_out.read_text())
    assert block["chip_ceiling_edges"] in tfp.edge_classes(tfp.SurfaceSpec())
    assert block["gate"] and block["buckets"]
    assert report["cost"]["calibration"]["bucket"] == "n64_e96"
    assert "fcheck-footprint:" in proc.stdout
    assert proc.returncode == (1 if report["diagnostics"] else 0)
    # the package's own scan is clean
    assert proc.returncode == 0 and report["n_files"] > 50


# -- the server's flags --------------------------------------------------


class _Stop:
    """A ConsensusService stand-in: records the config it was given and
    stops the entry point before any worker starts."""

    seen = []

    def __init__(self, cfg):
        _Stop.seen.append(cfg)

    def start(self):
        raise ValueError("stopped before the pool")


def _serve(pkg, monkeypatch, capsys, ceiling, argv):
    import importlib

    fp = jfp if pkg == "fastconsensus_tpu" else tfp
    monkeypatch.setattr(fp, "derive_chip_ceiling",
                        lambda budget, spec: ceiling)
    server = importlib.import_module(pkg + ".serve.server")
    monkeypatch.setattr(server, "ConsensusService", _Stop)
    if pkg == "fastconsensus_tpu":
        import fastconsensus_tpu.utils.env as jenv

        monkeypatch.setattr(jenv, "setup_compile_cache", lambda: None)
        base = ["--devices", "2", "--huge-devices", "1"]
    else:
        base = ["--device", "cpu", "--devices", "2", "--huge-devices", "1"]
    main = importlib.import_module(pkg + ".serve.__main__").main
    _Stop.seen = []
    rc = main(base + ["--port", "0", "--quiet"] + argv)
    err = capsys.readouterr().err
    return rc, err, [c.chip_max_edges for c in _Stop.seen]


@pytest.mark.parametrize("ceiling,argv,rc,words", [
    # a budget no bucket fits
    (None, ["--chip-max-edges", "auto", "--hbm-bytes", "1000"], 2,
     "no ladder bucket fits --hbm-bytes 1000"),
    # a budget that fits the whole admissible ladder: the huge tier idles
    (4194304, ["--chip-max-edges", "auto", "--hbm-bytes", str(1 << 40)], 2,
     "covers every admissible bucket"),
    # an explicit ceiling above the derived one
    (24576, ["--chip-max-edges", "98304", "--hbm-bytes", "5000000000"], 2,
     "exceeds the derived single-chip ceiling 24576"),
    # a sound derived ceiling reaches the service
    (24576, ["--chip-max-edges", "auto", "--hbm-bytes", "5000000000"], 2,
     "stopped before the pool"),
    # on the CPU the budget is the model's synthetic one
    (24576, ["--chip-max-edges", "auto"], 2, "stopped before the pool"),
    # a sound explicit ceiling is kept
    (24576, ["--chip-max-edges", "6144", "--hbm-bytes", "5000000000"], 2,
     "stopped before the pool"),
])
def test_serve_ceiling_flags_match_the_reference(monkeypatch, capsys,
                                                 ceiling, argv, rc, words):
    got = {pkg: _serve(pkg, monkeypatch, capsys, ceiling, argv)
           for pkg in ("fastconsensus_tpu", "fastconsensus_tpu_torch")}
    (jrc, jerr, jcfg), (trc, terr, tcfg) = got.values()
    assert jrc == trc == rc
    assert words in jerr and words in terr
    assert terr == jerr
    assert tcfg == jcfg


def test_serve_parses_auto_and_budget():
    from fastconsensus_tpu_torch.serve.__main__ import build_parser

    args = build_parser().parse_args(["--chip-max-edges", "auto",
                                      "--huge-devices", "1",
                                      "--hbm-bytes", "1000000"])
    assert args.chip_max_edges == "auto" and args.hbm_bytes == 1000000


def test_serve_reads_the_card_or_refuses(monkeypatch):
    """--device cpu has no card to read (the synthetic budget applies);
    on CUDA the card's memory is read, and without a card it is an
    error, never the synthetic budget."""
    from fastconsensus_tpu_torch.serve import __main__ as smain

    assert smain._device_hbm_bytes("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        smain._device_hbm_bytes("cuda")

    class Props:
        def __init__(self, total):
            self.total_memory = total

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props([80 << 30, 40 << 30][i]))
    assert smain._device_hbm_bytes("cuda") == 40 << 30
