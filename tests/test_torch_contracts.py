"""The port's name-contract pass (analysis/contracts.py), against the
reference's.

* Cross-package parity: each contract rule's ``bad_``/``ok_`` fixture in
  ``tests/analysis_fixtures/`` gives equal ``(rule, line, message)`` in
  both packages' fixture mode (the one hint naming the command that
  regenerates the counters reference differs by design, and is mapped
  before the comparison); ``_scan_module`` gives equal facts on the
  reference's ``serve/server.py``, ``serve/client.py`` and
  ``obs/counters.py``, read as text; ``template_matches``,
  ``_to_templates``, ``_scan_shell`` and ``_scan_readme`` are equal on
  the reference's test inputs.
* Repo mode on the port's package: clean, with ``torch``, ``jax`` and
  ``fastconsensus_tpu`` poisoned; the committed
  ``analysis/contract_inventory.json`` and ``COUNTERS.md`` equal fresh
  emissions; the README section's rule table lists every rule id.
* The runtime cross-check: ``assert_covered`` accepts known names,
  names strays, and covers a live CPU server's ``/metricsz``;
  ``load_inventory`` reads either package's artifact and rejects a
  foreign one; ``bench_report --check``'s phantom-key fast-fail.

Tolerance: exact.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest
import torch

from fastconsensus_tpu.analysis import contracts as jcon
from fastconsensus_tpu_torch.analysis import contracts

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "fastconsensus_tpu_torch")
FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures")
INVENTORY = os.path.join(PKG, "analysis", "contract_inventory.json")
REF_HINT = "python -m fastconsensus_tpu.analysis --emit-inventory"

CONTRACT_FIXTURES = [
    ("bad_phantom_reader.py", "ok_phantom_reader.py", "phantom-reader", 1),
    ("bad_schema_drift.py", "ok_schema_drift.py", "schema-drift", 2),
    ("bad_dead_counter.py", "ok_dead_counter.py", "dead-counter", 1),
    ("bad_event_vocab.py", "ok_event_vocab.py", "event-vocab", 2),
    ("bad_doc_drift.py", "ok_doc_drift.py", "doc-drift", 3),
]


def _fixture_diags(mod, name):
    path = os.path.join(FIXTURES, name)
    with open(path, encoding="utf-8") as fh:
        diags, _ = mod.check_contracts({path: fh.read()})
    return [(d.rule, d.line, d.message.replace(contracts._REGEN_HINT,
                                               REF_HINT)) for d in diags]


@pytest.mark.parametrize("bad,ok,rule,n_bad", CONTRACT_FIXTURES,
                         ids=[r[2] for r in CONTRACT_FIXTURES])
def test_fixture_mode_equals_the_reference(bad, ok, rule, n_bad):
    got = _fixture_diags(contracts, bad)
    assert got == _fixture_diags(jcon, bad)
    assert [r for r, _, _ in got] == [rule] * n_bad
    assert _fixture_diags(contracts, ok) == _fixture_diags(jcon, ok) == []


def test_contract_spec_must_be_a_literal_dict(tmp_path):
    p = tmp_path / "bad_spec.py"
    for text, words in (("CONTRACT_SPEC = ['not-a-dict']\n", "must be a dict"),
                        ("CONTRACT_SPEC = {'rules': ['no-such-rule']}\n",
                         "no-such-rule"),
                        ("CONTRACT_SPEC = {'surprise': 1}\n", "surprise")):
        p.write_text(text)
        with pytest.raises(ValueError, match=words):
            contracts.check_contracts({str(p): p.read_text()})


def _facts(mod, path):
    with open(path, encoding="utf-8") as fh:
        f = mod._scan_module(path, fh.read())
    return {k: getattr(f, k) for k in (
        "metrics", "events", "wire_keys", "emit_groups", "reads", "parsers",
        "event_kinds", "spec")}


@pytest.mark.parametrize("rel", ["serve/server.py", "serve/client.py",
                                 "obs/counters.py"])
def test_module_facts_equal_the_reference_on_its_sources(rel):
    path = os.path.join(REPO, "fastconsensus_tpu", rel)
    got = _facts(contracts, path)
    assert got == _facts(jcon, path)
    assert got["metrics"] or got["parsers"]


_SERVE_STYLE = textwrap.dedent("""\
    PREFIX = "serve.pool"
    PHASES = (("queue_wait", "t_admit"), ("device", "t_start"))

    def tick(reg, klass="interactive"):
        for arm in ("met", "missed"):
            reg.inc(f"serve.slo.{klass}.{arm}")
        for i in range(4):
            reg.gauge(f"serve.device.{i}.jobs", i)
        reg.inc(PREFIX + ".spawns")
        reg.inc("a.b" if klass else "a.c")

    def stats(counters):
        out = {name: counters.get(f"serve.shape.{name}", 0)
               for name in ("holds", "bypass", "edf_promotions")}
        for extra in ("deadline_sheds",):
            out[extra] = 0
        return out
    """)


def test_constant_propagation_equals_the_reference():
    tj = jcon._scan_module("m.py", _SERVE_STYLE)
    tt = contracts._scan_module("m.py", _SERVE_STYLE)
    for k in ("metrics", "wire_keys", "reads", "emit_groups"):
        assert getattr(tt, k) == getattr(tj, k), k
    assert {"serve.slo.interactive.met", "serve.device.*.jobs",
            "serve.pool.spawns", "a.b", "a.c"} <= set(tt.metrics)
    assert {"holds", "deadline_sheds", "t_admit"} <= set(tt.wire_keys)
    assert ("serve.shape.holds", 13) in tt.reads


@pytest.mark.parametrize("template,name", [
    ("serve.device.*.jobs", "serve.device.3.jobs"),
    ("serve.device.*.jobs", "serve.device.jobs"),
    ("serve.device.*", "serve.device.3.jobs"),
    ("serve.*", "serve.cache.hit"),
    ("serve.slo.*.met", "serve.slo.*.met"),
    ("host_sync.*", "host_sync.barrier"),
    ("serve.x*", "serve.xla_compiles"),
    ("a.b", "a.c"),
])
def test_template_matches_equals_the_reference(template, name):
    assert contracts.template_matches(template, name) == \
        jcon.template_matches(template, name)
    vals = {template.replace("*", "\x00"), name}
    assert contracts._to_templates(vals) == jcon._to_templates(vals)


_SHELL = textwrap.dedent("""\
    grep -q "serve.cache.hit" out.log
    python - <<'PYEOF'
    m = snapshot()
    x = m.get("serve.queue.depth", 0)
    PYEOF
    echo done  # a comment quoting "serve.not.a.read"
    cp artifact runs/bench_r9.json
    jq '.fcobs.counters["serve.batch.coalesced"]' m.json
    """)


def test_shell_lexer_equals_the_reference():
    got = contracts._scan_shell(_SHELL)
    assert got == jcon._scan_shell(_SHELL)
    reads = dict(got)
    assert "serve.cache.hit" in reads and "serve.queue.depth" in reads
    assert "serve.not.a.read" not in reads
    assert not any(n.endswith(".json") for n in reads)


def _readme_inputs():
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as fh:
        yield "README.md", fh.read()
    for bad, ok, _, _ in CONTRACT_FIXTURES:
        for name in (bad, ok):
            with open(os.path.join(FIXTURES, name), encoding="utf-8") as fh:
                facts = jcon._scan_module(name, fh.read())
            if "readme" in facts.spec[0]:
                yield name, facts.spec[0]["readme"]


@pytest.mark.parametrize("name,text", list(_readme_inputs()),
                         ids=[n for n, _ in _readme_inputs()])
def test_readme_scan_equals_the_reference(name, text):
    """Equal, but for the references to the port's own modules and to
    torch, which the port takes for module paths, not metric names."""
    got, want = contracts._scan_readme(text), jcon._scan_readme(text)
    ours = ("torch.", "fastconsensus_tpu_torch.")
    want["refs"] = [(n, ln) for n, ln in want["refs"]
                    if not n.startswith(ours)]
    assert got == want


# -- repo mode on the port's package ------------------------------------


_POISONED_SCAN = textwrap.dedent("""\
    import sys

    sys.modules["torch"] = None
    sys.modules["jax"] = None
    sys.modules["fastconsensus_tpu"] = None
    sys.path.insert(0, sys.argv[1])
    from fastconsensus_tpu_torch.analysis import contracts, read_sources

    sources = read_sources([sys.argv[1] + "/fastconsensus_tpu_torch"])
    assert contracts._find_pkg_root(sources)
    diags, suppressed = contracts.check_contracts(sources)
    for d in diags:
        print(d.format())
    print("suppressed", suppressed)
    sys.exit(1 if diags else 0)
    """)


def test_repo_mode_is_clean_with_torch_and_jax_poisoned():
    proc = subprocess.run([sys.executable, "-c", _POISONED_SCAN, REPO],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # the deliberate reads: history's external wrapper shapes (the
    # ``parsed`` and ``record`` fields under one pragma)
    assert "suppressed 2" in proc.stdout


def test_repo_mode_reads_every_surface():
    from fastconsensus_tpu_torch.analysis import read_sources

    sources = read_sources([PKG])
    uni = contracts.build_universe(dict(sources),
                                   contracts._find_pkg_root(sources))
    gate_files = {os.path.basename(p) for _, p, _ in uni.gate_reads}
    assert {"history.py", "chip_smoke.py"} <= gate_files
    smoke = [n for n, p, _ in uni.gate_reads if p.endswith("chip_smoke.py")]
    assert "serve.batch.coalesced" in smoke and all("." in n for n in smoke)
    # the resolved names of the counters phase serve prints
    assert "serve.pool.deque_coalesced" in smoke
    assert {os.path.basename(p) for _, p, _ in uni.client_reads} == \
        {"client.py"}
    # bench.py's telemetry block is in the wire universe
    assert uni.wire_keys["fleet_e2e_p95_ms"]
    assert uni.readme_path.endswith("README.md")
    assert uni.appendix_path.endswith(os.path.join(
        "fastconsensus_tpu_torch", "COUNTERS.md"))
    assert uni.readme["has_appendix"]


def test_the_readme_sections_rule_table_lists_every_rule_id():
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as fh:
        section, first = contracts._readme_section(fh.read())
    assert section.startswith(contracts.README_SECTION) and first > 1
    rules = contracts._rule_universe()
    table = {line.split("`")[1] for line in section.splitlines()
             if line.strip().startswith("| `")}
    assert table == rules and len(rules) == 24
    assert not any(r.startswith("jaxpr") or r == "trace-error"
                   for r in rules)
    assert rules <= contracts._scan_readme(section)["rule_ids"]


def test_a_missing_rule_row_is_doc_drift(tmp_path):
    """Repo mode holds the README section's table to the rule universe:
    drop a row in a copy of the surfaces and the rule fires there."""
    import shutil

    from fastconsensus_tpu_torch.analysis import read_sources

    shutil.copytree(PKG, tmp_path / "fastconsensus_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name in ("bench.py", "chip_smoke.py"):
        shutil.copy(os.path.join(REPO, name), tmp_path / name)
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as fh:
        readme = fh.read()
    row = next(line for line in readme.splitlines()
               if line.strip().startswith("| `event-vocab` |"))
    (tmp_path / "README.md").write_text(readme.replace(row + "\n", ""))
    diags, _ = contracts.check_contracts(
        read_sources([str(tmp_path / "fastconsensus_tpu_torch")]))
    assert [(d.rule, os.path.basename(d.file)) for d in diags] == \
        [("doc-drift", "README.md")]
    assert "'event-vocab'" in diags[0].message


def test_committed_inventory_equals_a_fresh_emission(tmp_path):
    from fastconsensus_tpu_torch.analysis.__main__ import main

    out = tmp_path / "inv.json"
    assert main(["--quiet", "--no-footprint", "--emit-inventory",
                 str(out)]) == 0
    assert out.read_text() == open(INVENTORY, encoding="utf-8").read()
    inv = contracts.load_inventory(str(out))
    assert inv["tool"] == jcon.INVENTORY_TOOL == contracts.INVENTORY_TOOL
    assert inv["version"] == jcon.INVENTORY_VERSION
    assert inv["rules"] == sorted(contracts.CONTRACT_RULES)
    names = {m["name"] for m in inv["metrics"]}
    assert {"serve.cache.hit", "serve.device.*.jobs",
            "serve.slo.*.met"} <= names
    for m in inv["metrics"]:
        assert m["writers"] and not m["writers"][0].startswith("/"), m
    assert set(inv["events"]) <= set(inv["event_vocab"])
    assert inv["readers"]["gate"] and inv["readers"]["client"]


def test_counters_md_equals_a_fresh_emission():
    proc = subprocess.run(
        [sys.executable, "-m", "fastconsensus_tpu_torch.analysis",
         "--no-footprint", "--emit-appendix"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with open(os.path.join(PKG, "COUNTERS.md"), encoding="utf-8") as fh:
        assert proc.stdout == fh.read()
    inv = contracts.load_inventory(INVENTORY)
    section = proc.stdout.split(contracts.APPENDIX_BEGIN, 1)[1] \
        .split(contracts.APPENDIX_END, 1)[0].strip()
    assert section == contracts.render_counters_appendix(inv).strip()


def test_event_vocabulary_matches_the_ports_flight_module():
    from fastconsensus_tpu_torch.obs import flight

    inv = contracts.load_inventory(INVENTORY)
    assert sorted(flight.EVENT_KINDS) == inv["event_vocab"]
    assert "watchdog_trip" in inv["event_vocab"]


# -- the runtime cross-check --------------------------------------------


def test_assert_covered_accepts_known_and_names_strays():
    snapshot = {
        "fcobs": {"counters": {"serve.cache.hit": 3,
                               "serve.slo.interactive.met": 1},
                  "gauges": {"serve.queue.depth": 0}, "series": {}},
        "latency": {"histograms": [{"name": "serve.e2e"}],
                    "arrivals": {}, "dispatches": {}},
    }
    assert contracts.assert_covered(snapshot, INVENTORY) == 4
    stray = {"fcobs": {"counters": {"serve.cache.hit": 1,
                                    "serve.totally.unknown": 2}}}
    assert contracts.uncovered(stray, INVENTORY) == \
        ["serve.totally.unknown"]
    with pytest.raises(AssertionError, match="serve.totally.unknown"):
        contracts.assert_covered(stray, INVENTORY)


def test_load_inventory_reads_either_package_and_rejects_foreign(tmp_path):
    ref = contracts.load_inventory(os.path.join(REPO, "runs",
                                                "contract_r19.json"))
    assert ref["tool"] == contracts.INVENTORY_TOOL
    assert jcon.load_inventory(INVENTORY)["metrics"]
    p = tmp_path / "other.json"
    p.write_text(json.dumps({"tool": "something-else"}))
    with pytest.raises(ValueError, match="not a fcheck-contract"):
        contracts.load_inventory(str(p))


def test_a_live_cpu_servers_metricsz_is_covered():
    """Every name a CPU service reports after a real job and a cache hit
    has a writer in the committed inventory (the card's phases serve and
    fleet run the same check)."""
    from fastconsensus_tpu_torch.serve.client import ServeClient
    from fastconsensus_tpu_torch.serve.server import (ConsensusService,
                                                      ServeConfig,
                                                      make_http_server)
    from fastconsensus_tpu_torch.utils.io import read_edgelist

    edges, _, ids = read_edgelist(os.path.join(REPO, "examples",
                                               "karate_club.txt"))
    svc = ConsensusService(ServeConfig(device="cpu", pin_sizing=False))
    httpd = make_http_server(svc, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    svc.start()
    try:
        client = ServeClient("http://127.0.0.1:%d" % httpd.server_address[1],
                             timeout=30.0)
        job = dict(edges=edges.tolist(), n_nodes=len(ids), algorithm="lpm",
                   n_p=4, delta=0.1, max_rounds=2, seed=1)
        client.wait(client.submit(**job)["job_id"], timeout=300)
        assert client.submit(**job)["cached"]
        snap = client.metricsz()
    finally:
        httpd.shutdown()
        httpd.server_close()
        assert svc.drain(60)
    assert contracts.uncovered(snap, INVENTORY) == []
    assert contracts.assert_covered(snap, INVENTORY) >= 20


def test_history_gate_reads_have_writers():
    path = os.path.join(PKG, "obs", "history.py")
    assert contracts.phantom_reads_for(path, INVENTORY) == []
    assert contracts.phantom_reads_for(
        os.path.join(PKG, "obs", "bench_report.py"), INVENTORY) == []


def test_phantom_reads_for_detects_and_suppresses(tmp_path):
    gate = tmp_path / "gate.py"
    gate.write_text(textwrap.dedent("""\
        def check(counters):
            a = counters.get("serve.cache.hit", 0)
            b = counters.get("serve.cache.hitz", 0)
            return a + b
        """))
    assert [n for n, _ in
            contracts.phantom_reads_for(str(gate), INVENTORY)] == \
        ["serve.cache.hitz"]
    gate.write_text(textwrap.dedent("""\
        def check(counters):
            a = counters.get("serve.cache.hit", 0)
            # fcheck: ok=phantom-reader (external artifact schema)
            b = counters.get("serve.cache.hitz", 0)
            return a + b
        """))
    assert contracts.phantom_reads_for(str(gate), INVENTORY) == []


def _run_bench_report(*extra):
    return subprocess.run(
        [sys.executable, "-m", "fastconsensus_tpu_torch.obs.bench_report",
         "--check", "--quiet", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=120)


def test_bench_report_check_passes_with_committed_inventory():
    proc = _run_bench_report()
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_bench_report_check_fast_fails_on_phantom_gate_keys(tmp_path):
    stripped = {"tool": contracts.INVENTORY_TOOL,
                "version": contracts.INVENTORY_VERSION,
                "rules": sorted(contracts.CONTRACT_RULES),
                "metrics": [], "wire_keys": [], "events": [],
                "event_vocab": [], "readers": {"gate": [], "client": []}}
    p = tmp_path / "contract_stripped.json"
    p.write_text(json.dumps(stripped))
    proc = _run_bench_report("--inventory", str(p))
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "PHANTOM" in proc.stderr
    assert "history.py" in proc.stderr


def test_bench_report_check_skips_on_missing_inventory(tmp_path):
    proc = _run_bench_report("--inventory", str(tmp_path / "nope.json"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "skipping the phantom-key check" in proc.stderr
