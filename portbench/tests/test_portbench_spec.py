"""``BENCHMARK.json`` against the contract's shape, and the harness
finding each part of a cell by its name."""

import json
import re
import shutil

import pytest

from conftest import ROOT, make_tree
from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert (ROOT / "portbench" / "run.py").exists()
    for c in b["configs"]:
        assert set(c) == KEYS["config"]
        assert NAME.match(c["name"]) and TEXT.match(c["why"])
        assert c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == KEYS["workload"]
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert TEXT.match(w["why"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert set(m) - {"workloads"} == KEYS[kind]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert m["moves"] in e2e and TEXT.match(m["layer"])
            for cell in m.get("workloads", []):
                assert cell in {w["name"] for w in b["workloads"]}


def test_each_layer_metric_moves_a_metric_its_cells_report():
    b = bench()
    cells = [w["name"] for w in b["workloads"]]
    e2e = {m["name"]: m.get("workloads", cells) for m in b["end_to_end"]}
    for m in b["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]], (m["name"], cell)
    # every cell reports an end-to-end metric besides setup_s
    for cell in cells:
        assert [k for k, ws in e2e.items() if cell in ws and k != "setup_s"]


def test_every_named_part_is_found():
    for w in bench()["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert hasattr(spec.driver(cell.mix["driver"]), "Driver")
        assert set(cell.limits) == {"tail_faults", "chain_faults",
                                    "cold_round_unsettled",
                                    "warm_round_unsettled",
                                    "unsettled_answers",
                                    "unsettled_share"}
        for m in cell.metrics:
            assert callable(spec.reader(m.name))
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer one
        kinds = [m.kind for m in cell.metrics]
        assert "setup_s" in [m.name for m in cell.metrics]
        assert kinds.count("end_to_end") >= 2 and "per_layer" in kinds


def test_config_files_hold_the_run_settings():
    for c in bench()["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["algorithm"] == "louvain"
        for key in c["reduced"]:
            assert key in cfg.get("published", {})


def test_a_new_metric_is_picked_up_without_an_edit(tmp_path):
    root = make_tree(tmp_path)
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({
        "name": "units_per_s", "unit": "units/s", "better": "higher",
        "source": "host_clock", "layer": "consensus (driver)",
        "moves": "partitions_per_s", "workloads": ["tiny-louvain.solo"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "portbench" / "metrics" / "units_per_s.py").write_text(
        "def read(facts):\n    return facts['units'] / facts['window_s']\n")
    before = {p.name: p.read_bytes()
              for p in (ROOT / "portbench").rglob("*.py")}
    cell = spec.cell("tiny-louvain.solo", root)
    assert "units_per_s" in [m.name for m in cell.metrics]
    got = spec.read_metrics(cell.metrics, "per_layer",
                            {"units": 6, "window_s": 3.0, "partitions": 12},
                            root)
    assert got["units_per_s"] == {"value": 2.0, "unit": "units/s"}
    # a reader that finds nothing to read leaves its metric out
    assert "row_totals_roofline" not in got
    assert {p.name: p.read_bytes()
            for p in (ROOT / "portbench").rglob("*.py")} == before


def test_a_new_config_and_mix_are_found_by_name(tmp_path):
    root = make_tree(tmp_path)
    cell = spec.cell("tiny-louvain.batch4", root)
    assert cell.mix["driver"] == "batch" and cell.config["n_p"] == 8
    with pytest.raises(KeyError):
        spec.cell("no-such.cell", root)
    shutil.rmtree(root / "portbench" / "traffic")
    with pytest.raises(FileNotFoundError):
        spec.cell("tiny-louvain.batch4", root)
