"""Fixtures of the benchmark's CPU tests: a checkout-like tree with the
committed ``BENCHMARK.json`` and ``portbench/``, plus a tiny cell of each
driver that the CPU runs in seconds.

Run from the repository's root: ``python -m pytest portbench/tests -q``.
"""

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_GRAPH = {"kind": "lfr", "n": 300, "mean_degree": 12, "max_degree": 30,
              "degree_exponent": 2, "community_exponent": 1,
              "min_community": 10, "max_community": 40, "mu": 0.5}
TINY_CELLS = ("tiny-louvain.batch4", "tiny-louvain.solo")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is false")


def make_tree(dest: Path) -> Path:
    """``dest`` holding ``BENCHMARK.json`` and ``portbench/`` as committed,
    a link to the port, and the tiny cells."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(ROOT / "fastconsensus_tpu_torch",
               dest / "fastconsensus_tpu_torch")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny-louvain", "source": "https://example.org/tiny",
        "file": "portbench/configs/tiny-louvain.json", "reduced": [],
        "why": "a CPU-sized LFR graph"})
    for name in TINY_CELLS:
        bench["workloads"].append({
            "name": name, "config": "tiny-louvain",
            "traffic": name.split(".")[1], "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(TINY_CELLS)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    pb = dest / "portbench"
    cfg = json.loads((pb / "configs" / "lfr1k-louvain.json").read_text())
    cfg.update(name="tiny-louvain", graph=TINY_GRAPH, n_p=8, max_rounds=4)
    (pb / "configs" / "tiny-louvain.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "batch4.json").write_text(json.dumps(
        {"driver": "batch", "batch": 4, "bucket": "n384_e2048",
         "pool_batches": 2}))
    # the tiny graph's rounds: sound ones read at most 0.0029 (cold) and
    # 0.0071 (warm) on the CPU, under a quarter of the sweep budgets
    # 0.19-0.21 and 0.059-0.094
    limits = json.loads((pb / "limits" / "lfr1k-louvain.json").read_text())
    limits.update(cold_round_unsettled=0.05, warm_round_unsettled=0.03)
    (pb / "limits" / "tiny-louvain.json").write_text(json.dumps(limits))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tree(tmp_path_factory.mktemp("checkout"))
