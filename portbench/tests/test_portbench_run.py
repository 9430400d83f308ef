"""Whole runs at a CPU size: the last line's schema, the check coming out
true on the program and false under each fault the cells can have, and
the harness refusing to run without the card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT
from portbench import harness

CHECKS = ["tail_faults", "chain_faults", "cold_round_unsettled",
          "warm_round_unsettled", "unsettled_answers"]


def run(root, cell, seed=5, seconds=0.5, trace=False):
    return harness.run(cell, seed, seconds, trace, time.perf_counter(),
                       root=root, device="cpu")


@pytest.mark.parametrize("cell", ["tiny-louvain.solo",
                                  "tiny-louvain.batch4"])
def test_last_line_schema_and_correct(tiny_root, cell):
    line = run(tiny_root, cell)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks" and list(line["checks"]) == CHECKS
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"partitions_per_s", "final_nmi",
                                    "setup_s"}   # no card: no memory
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["checks"]["tail_faults"] == {"value": 0.0, "limit": 0}
    json.loads(json.dumps(line))


def test_traced_line_has_per_layer_metrics_and_breakdown(tiny_root):
    line = run(tiny_root, "tiny-louvain.solo", trace=True)
    assert line["correct"] is True
    assert {"device_idle_pct", "launches_per_partition",
            "final_detect_pct"} <= set(line["metrics"])
    assert "partitions_per_s" not in line["metrics"]
    dev = line["device"]
    assert dev["busy_s"] > 0 and dev["window_s"] >= dev["busy_s"]
    for key in ("device_ops", "idle_gaps"):
        assert len(line["breakdown"][key]) <= 10
    assert list(line)[-1] == "checks"


def test_seed_gives_the_same_work(tiny_root):
    a = run(tiny_root, "tiny-louvain.batch4", seed=2 ** 31 + 7)
    b = run(tiny_root, "tiny-louvain.batch4", seed=2 ** 31 + 7)
    assert a["checks"] == b["checks"]
    assert a["metrics"]["final_nmi"] == b["metrics"]["final_nmi"]


def _fault(monkeypatch, kind):
    import functools

    from fastconsensus_tpu_torch import engine
    from fastconsensus_tpu_torch.models import louvain
    from fastconsensus_tpu_torch.ops import consensus_ops as cops

    if kind == "state_unchanged":
        orig = engine.consensus_tail

        @functools.wraps(orig)
        def tail(slab, labels, *a, **k):
            _, stats = orig(slab, labels, *a, **k)
            return slab, stats
        monkeypatch.setattr(engine, "consensus_tail", tail)
    elif kind == "half_the_members":
        orig = cops.comembership_counts

        def half(labels, src, dst):
            h = labels.shape[0] // 2
            return orig(labels[:h], src, dst) * (labels.shape[0] / h)
        monkeypatch.setattr(cops, "comembership_counts", half)
    elif kind == "rounds_one_sweep":
        # every member of every round stops after one sweep
        orig = louvain.louvain_members

        def one_sweep(prep, keys, init, max_sweeps=32, update_prob=0.5):
            return orig(prep, keys, init, 1, update_prob)
        monkeypatch.setattr(louvain, "louvain_members", one_sweep)
    elif kind == "answer_altered":
        orig = louvain.louvain_members

        def altered(*a, **k):
            lab = orig(*a, **k)
            gen = torch.Generator().manual_seed(0)
            perm = torch.randperm(lab.shape[1], generator=gen)
            lab[0] = lab[0][perm.to(lab.device)]
            return lab
        monkeypatch.setattr(louvain, "louvain_members", altered)


# a step that returns its state unchanged; half of the members left out
# and the count scaled from the rest; detection cut to one sweep; an
# answer altered where it is made.  (One card: no exchange between chips
# to leave out.)
@pytest.mark.parametrize("kind", ["state_unchanged", "half_the_members",
                                  "rounds_one_sweep", "answer_altered"])
@pytest.mark.parametrize("cell", ["tiny-louvain.solo",
                                  "tiny-louvain.batch4"])
def test_each_fault_comes_out_not_correct(tiny_root, monkeypatch, kind, cell):
    _fault(monkeypatch, kind)
    line = run(tiny_root, cell)
    assert line["correct"] is False
    assert line["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def _script(root, name, *args, env=None):
    return subprocess.run(
        [sys.executable, str(root / "portbench" / name), *args],
        capture_output=True, text=True, timeout=600, cwd=root,
        env={**os.environ, **(env or {})})


def test_the_control_comes_out_not_correct(tiny_root):
    out = _script(tiny_root, "control.py", "--workload",
                  "tiny-louvain.batch4", "--seeds", "1,2", "--seconds",
                  "0.5", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == 2
    assert all(x["control"] == "closure" and x["correct"] is False and
               x["checks"]["tail_faults"] > 0 for x in lines)


def test_the_quarter_budget_comes_out_not_correct(tiny_root):
    out = _script(tiny_root, "control.py", "--workload",
                  "tiny-louvain.solo", "--seeds", "1,2", "--seconds",
                  "0.5", "--device", "cpu", "--control", "quarter")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == 2
    assert all(x["control"] == "quarter" and x["correct"] is False and
               x["checks"]["cold_round_unsettled"] > 0.05 and
               x["checks"]["warm_round_unsettled"] > 0.03 for x in lines)


def test_without_a_card_it_fails_and_prints_no_result(tiny_root):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _script(tiny_root, "run.py", "--workload", "tiny-louvain.solo",
                  "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_without_the_program_it_fails(tmp_path):
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _script(tmp_path, "run.py", "--workload", "lfr1k-louvain.batch8",
                  "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "No module named 'fastconsensus_tpu_torch'" in out.stderr


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _script(ROOT, "run.py", "--workload", "lfr1k-louvain.batch8",
                  "--seed", "3", "--seconds", "2", "--trace", "0")
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
