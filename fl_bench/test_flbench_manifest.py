"""The manifest (``BENCHMARK.json``) against the benchmark's contract and
its files: every name and unit in the allowed characters, every cell,
configuration, traffic mix, family and metric found by name, each cell's
file agreeing with its manifest entry."""
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
MANIFEST = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "fl_bench/run.py"]
    assert MANIFEST["paths"] == ["fl_bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((HERE.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entry(metric):
    assert NAME.match(metric["name"])
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (HERE / "metrics" / f"{metric['name']}.py").exists()
    if metric in MANIFEST["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=[w["name"] for w in MANIFEST["workloads"]])
def test_cell_files(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    spec = json.loads((HERE / "cells" / f"{cell['name']}.json").read_text())
    for key in ("config", "traffic", "chips", "why"):
        assert spec[key] == cell[key], key
    assert spec["limits"]
    assert (HERE / "traffic" / f"{cell['traffic']}.json").exists()
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    cfg = json.loads((HERE.parent / configs[cell["config"]]["file"])
                     .read_text())
    assert (HERE / "families" / f"{cfg['family']}.py").exists()


@pytest.mark.parametrize("config", MANIFEST["configs"],
                         ids=[c["name"] for c in MANIFEST["configs"]])
def test_config_entry(config):
    assert NAME.match(config["name"])
    assert config["file"] == f"fl_bench/configs/{config['name']}.json"
    cfg = json.loads((HERE.parent / config["file"]).read_text())
    assert cfg["reduced"] == config["reduced"]
    assert all(NAME.match(k) for k in config["reduced"])
    assert any(w["config"] == config["name"] for w in MANIFEST["workloads"])
