"""The port's fault-flow pass (``fastconsensus_tpu_torch/analysis/
faults.py``) and its injection-site inventory.

* On the reference's fault fixtures (``tests/analysis_fixtures/``) the
  port's pass gives exactly the reference's ``(rule, line, col)``
  diagnostics and suppression counts (the reference's counts are in
  ``tests/test_faults.py``), file by file and as one program.
* The port's fixtures (``tests/torch_analysis_fixtures/``) fire each
  rule on the bad file only; the torch tables (``torch.load`` raises
  OSError, RuntimeError and UnpicklingError; ``torch.cuda.
  OutOfMemoryError`` is a RuntimeError) and the port's own error
  classes feed the propagation.
* The committed ``analysis/fault_inventory.json`` equals a fresh
  inventory of the package, its site ids parse with the port's
  ``serve/faultinject.parse_site_id``, and the CLI writes it.
* The two findings the pass raised in the port's serving and obs code
  now have outlets: each failure is counted.
"""

import json
import os
import textwrap

import pytest
import torch

from fastconsensus_tpu.analysis import faults as jfaults
from fastconsensus_tpu_torch.analysis import faults as tfaults
from fastconsensus_tpu_torch.analysis import lint_paths, read_sources
from fastconsensus_tpu_torch.analysis.__main__ import main as analysis_main

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures")
FIXTURES = os.path.join(REPO, "tests", "torch_analysis_fixtures")
PKG = os.path.join(REPO, "fastconsensus_tpu_torch")
INVENTORY = os.path.join(PKG, "analysis", "fault_inventory.json")

FAULT_CASES = [
    ("bad_escape_thread_root.py", "ok_escape_thread_root.py",
     "escape-thread-root"),
    ("bad_swallowed_error.py", "ok_swallowed_error.py", "swallowed-error"),
    ("bad_unmapped_http.py", "ok_unmapped_http.py", "unmapped-http-error"),
    ("bad_resource_leak.py", "ok_resource_leak.py", "resource-leak"),
]
# findings per bad fixture: the reference's (tests/test_faults.py), the
# port's (bad_escape_thread_root: one per type torch.load raises)
REF_COUNTS = {"escape-thread-root": 1, "swallowed-error": 1,
              "unmapped-http-error": 1, "resource-leak": 1}
PORT_COUNTS = {"escape-thread-root": 3, "swallowed-error": 1,
               "unmapped-http-error": 1, "resource-leak": 1}


def _key(diags):
    return sorted((d.rule, d.line, d.col) for d in diags)


def _check(src):
    return tfaults.check_faults({"mod.py": textwrap.dedent(src)})


@pytest.mark.parametrize("bad,ok,rule", FAULT_CASES,
                         ids=[c[2] for c in FAULT_CASES])
def test_reference_fixtures_give_the_reference_diagnostics(bad, ok, rule):
    for name in (bad, ok):
        path = os.path.join(REF_FIXTURES, name)
        src = read_sources([path])
        t_diags, t_supp = tfaults.check_faults(src)
        j_diags, j_supp = jfaults.check_faults(src)
        assert _key(t_diags) == _key(j_diags), name
        assert t_supp == j_supp, name
        hits = [d for d in t_diags if d.rule == rule]
        assert len(hits) == (REF_COUNTS[rule] if name == bad else 0), \
            [d.format() for d in t_diags]


def test_reference_fixture_set_as_one_program():
    sources = read_sources([REF_FIXTURES])
    t_diags, t_supp = tfaults.check_faults(sources)
    j_diags, j_supp = jfaults.check_faults(sources)
    assert _key(t_diags) == _key(j_diags) and t_supp == j_supp
    assert {d.rule for d in t_diags} == set(tfaults.FAULT_RULES)


@pytest.mark.parametrize("bad,ok,rule", FAULT_CASES,
                         ids=[c[2] for c in FAULT_CASES])
def test_port_fixtures_fire_on_bad_only(bad, ok, rule):
    hits = lint_paths([os.path.join(FIXTURES, bad)]).diagnostics
    assert [d.rule for d in hits] == [rule] * PORT_COUNTS[rule], \
        [d.format() for d in hits]
    assert not lint_paths([os.path.join(FIXTURES, ok)]).diagnostics


def test_torch_load_raises_what_the_table_says():
    hits = lint_paths([os.path.join(
        FIXTURES, "bad_escape_thread_root.py")]).diagnostics
    text = " ".join(d.message for d in hits)
    for exc in ("OSError", "RuntimeError", "UnpicklingError"):
        assert exc in text, text


@pytest.mark.parametrize("handler,escapes", [
    ("RuntimeError", False),       # OutOfMemoryError is a RuntimeError
    ("torch.cuda.OutOfMemoryError", False),
    ("ValueError", True),
])
def test_out_of_memory_is_a_runtime_error(handler, escapes):
    diags, _ = _check(f"""\
        import threading

        import torch


        class Runner:
            def __init__(self, reg):
                self._reg = reg
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)

            def _loop(self):
                while True:
                    try:
                        self._step()
                    except {handler}:
                        self._reg.inc("oom")

            def _step(self):
                raise torch.cuda.OutOfMemoryError("card full")
        """)
    hits = [d for d in diags if d.rule == "escape-thread-root"]
    assert bool(hits) == escapes, [d.format() for d in diags]


def test_the_port_error_classes_join_the_hierarchy():
    """``KernelBuildError(RuntimeError)`` is merged from the scan as any
    project class is: an ``except RuntimeError`` absorbs it, an ``except
    ValueError`` does not."""
    for handler, escapes in (("RuntimeError", False), ("ValueError", True)):
        diags, _ = _check(f"""\
            import threading


            class KernelBuildError(RuntimeError):
                pass


            def _build():
                raise KernelBuildError("nvcc failed")


            def _loop(reg):
                try:
                    _build()
                except {handler}:
                    reg.inc("build_failed")


            def start(reg):
                threading.Thread(target=_loop, args=(reg,),
                                 daemon=True).start()
            """)
        hits = [d for d in diags if d.rule == "escape-thread-root"]
        assert bool(hits) == escapes, [d.format() for d in diags]


# -- the injection-site inventory ---------------------------------------


def _committed():
    with open(INVENTORY, encoding="utf-8") as fh:
        return json.load(fh)


def test_committed_inventory_equals_a_fresh_one():
    assert tfaults.fault_inventory_from_paths([PKG]) == _committed()


def test_inventory_schema_and_site_ids():
    from fastconsensus_tpu_torch.serve import faultinject

    inv = _committed()
    assert inv["tool"] == "fcheck-fault" and inv["version"] == 1
    assert inv["module_prefix"] == "fastconsensus_tpu_torch.serve"
    sites = inv["sites"]
    assert sites and sites == sorted(sites, key=lambda s: s["site_id"])
    kinds = set()
    for site in sites:
        assert set(site) == {"site_id", "file", "function", "exception",
                             "kind", "lines", "boundary", "injectable"}
        module, qualname, exc = faultinject.parse_site_id(site["site_id"])
        assert module.startswith("fastconsensus_tpu_torch.serve")
        assert site["file"] in (module.replace(".", "/") + ".py",
                                module.replace(".", "/") + "/__init__.py")
        assert (qualname, exc) == (site["function"], site["exception"])
        assert site["lines"] == sorted(site["lines"])
        kinds.add(site["kind"])
        if site["injectable"]:
            assert site["boundary"]
            assert all(not b.startswith("<") for b in site["boundary"])
        if site["kind"] == "escape":
            assert site["injectable"], site["site_id"]
    assert kinds == {"raise", "builtin-call", "escape"}


def test_inventory_lists_the_drain_time_spill_fault():
    """The site the release check arms in phase fleet: OSError leaving
    ``ResultCache.spill`` (raised in ``_spill_locked``), absorbed by the
    drain alone; the periodic spill's own path is a different site."""
    by_id = {s["site_id"]: s for s in _committed()["sites"]}
    site = by_id["fastconsensus_tpu_torch.serve.cache:ResultCache.spill:"
                 "OSError"]
    assert site["kind"] == "escape" and site["injectable"]
    assert site["boundary"] == [
        "fastconsensus_tpu_torch.serve.server.ConsensusService.drain"]
    raised = by_id["fastconsensus_tpu_torch.serve.cache:"
                   "ResultCache._spill_locked:OSError"]
    assert "fastconsensus_tpu_torch.serve.server.ConsensusService.drain" \
        in raised["boundary"]


def test_cli_emits_the_committed_inventory(tmp_path):
    out = tmp_path / "inv.json"
    assert analysis_main(["--quiet", "--no-footprint",
                          "--emit-fault-inventory", str(out)]) == 0
    assert json.loads(out.read_text()) == _committed()


# -- the outlets the pass asked for -------------------------------------


def test_queue_counts_a_failed_solo_probe(monkeypatch):
    from fastconsensus_tpu_torch.consensus import ConsensusConfig
    from fastconsensus_tpu_torch.obs import counters as obs_counters
    from fastconsensus_tpu_torch.serve.jobs import Job, JobSpec
    from fastconsensus_tpu_torch.serve.queue import AdmissionQueue

    class Decision:
        hold_s, target = 0.0, 0

    class BrokenShaper:
        def runs_solo(self, bucket):
            raise RuntimeError("no cost model for " + bucket)

        def hold_decision(self, bucket, **kw):
            return Decision()

        def hold_is_free(self):
            return True

    monkeypatch.setattr(obs_counters, "_REGISTRY",
                        obs_counters.ObsRegistry())
    queue = AdmissionQueue(max_depth=8)
    queue.set_shaper(BrokenShaper())
    import numpy as np

    ring = np.stack([np.arange(12), (np.arange(12) + 1) % 12], 1)
    for seed in range(2):
        queue.submit(Job(JobSpec(edges=ring, n_nodes=12,
                                 config=ConsensusConfig(n_p=4,
                                                        seed=seed))))
    batch = queue.pop_batch(4, group_key=lambda j: j.spec.batch_group())
    assert len(batch) == 2
    counters = obs_counters.get_registry().counters()
    assert counters.get("serve.queue.solo_probe_errors", 0) >= 1, counters


def test_profiler_counts_a_failed_export(monkeypatch, tmp_path):
    from fastconsensus_tpu_torch.obs import counters as obs_counters
    from fastconsensus_tpu_torch.obs.device import ProfilerSession

    class BrokenProfiler:
        def __exit__(self, *exc):
            raise RuntimeError("trace buffer lost")

    monkeypatch.setattr(obs_counters, "_REGISTRY",
                        obs_counters.ObsRegistry())
    sess = ProfilerSession(str(tmp_path))
    sess.active, sess._prof = True, BrokenProfiler()
    assert sess.__exit__(None, None, None) is False
    assert sess.trace_path is None
    assert obs_counters.get_registry().counters()[
        "obs.profiler.export_failed"] == 1
