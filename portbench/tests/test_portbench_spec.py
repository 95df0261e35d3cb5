"""``BENCHMARK.json`` against the contract's shapes, and every file that a
name in it leads to."""

import json
import re

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.benchmark()


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in SPEC[group]:
            assert NAME.match(item["name"]), item["name"]
            names.append(item["name"])
            if "unit" in item:
                assert UNIT.match(item["unit"]), item["unit"]
                assert item["better"] in ("lower", "higher")
    assert len(names) == len(set(names))


def test_cells_files_and_keys():
    configs = {c["name"]: c for c in SPEC["configs"]}
    pairs = set()
    for cell in SPEC["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] == 1 and len(cell["why"]) <= 200
        assert (cell["config"], cell["traffic"]) not in pairs
        pairs.add((cell["config"], cell["traffic"]))
        entry, config, traffic = harness.cell(cell["name"])
        assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").is_file()
        assert config["name"] == cell["config"]
    for name, item in configs.items():
        assert set(item) == {"name", "source", "file", "reduced", "why"}
        data = harness.load_json(harness.ROOT / item["file"])
        assert data["source"] == item["source"] and data["reduced"] == item["reduced"]
        assert len(item["source"]) <= 200
        assert any(c["config"] == name for c in SPEC["workloads"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in SPEC["workloads"]:
        e2e = [m["name"] for m in harness.metrics_of(cell["name"], traced=False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(cell["name"], traced=True)


def test_per_layer_metrics_move_a_metric_of_their_cells():
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert (harness.HERE / "layer_metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            reported = [e["name"] for e in harness.metrics_of(cell, traced=False)]
            assert m["moves"] in reported, (m["name"], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_end_to_end_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
