"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the mix names its driver.  Each metric name is a reader module under
``metrics/``.  Nothing here knows a particular cell, mix or metric, so a
later change adds files and entries without editing this one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    kind: str                        # "end_to_end" or "per_layer"
    workloads: Optional[List[str]]   # None: every cell that reports it

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    limits: dict
    metrics: List[Metric]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path`` as module ``name`` (no package needed)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def metrics_of(bench: dict) -> List[Metric]:
    out = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            out.append(Metric(m["name"], m["unit"], kind,
                              m.get("workloads")))
    return out


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, mix, limits and metrics
    read from the files ``BENCHMARK.json`` names."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / configs[w["config"]]["file"])
    mix = load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "portbench" / "limits" / f"{w['config']}.json")
    mets = [m for m in metrics_of(bench) if m.applies_to(name)]
    return Cell(name, cfg, mix, int(w["chips"]), limits, mets)


def reader(metric: str, root: Path = ROOT) -> Callable[[dict], Optional[float]]:
    """The ``read(facts)`` function of ``metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    return load_module(path, f"portbench_metric_{metric.replace('.', '_')}"
                       ).read


def driver(name: str, root: Path = ROOT) -> ModuleType:
    """``drivers/<name>.py``: the loop that offers a mix's load."""
    return load_module(root / "portbench" / "drivers" / f"{name}.py",
                       f"portbench_driver_{name}")


def read_metrics(metrics: List[Metric], kind: str, facts: dict,
                 root: Path = ROOT) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of the ``kind`` metrics whose reader
    finds something to read in ``facts``."""
    out = {}
    for m in metrics:
        if m.kind != kind:
            continue
        v = reader(m.name, root)(facts)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.unit}
    return out
