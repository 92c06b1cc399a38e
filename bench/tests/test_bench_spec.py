"""BENCHMARK.json keeps the benchmark's contract: its keys, names, units,
bounds, and files found by name under ``paths``."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "bench/run.py"]
    assert B["paths"] == ["bench"]
    assert 1 <= B["run_seconds"] <= 51


def test_names_units_and_entries():
    metrics = B["end_to_end"] + B["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in B["workloads"]] \
        + [c["name"] for c in B["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in B["end_to_end"]]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", B["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_whole(cell):
    def reports(m):
        return "workloads" not in m or cell["name"] in m["workloads"]
    e2e = [m["name"] for m in B["end_to_end"] if reports(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = [m for m in B["per_layer"] if reports(m)]
    assert per and all(m["moves"] in e2e for m in per
                       if "workloads" in m)
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200
    assert (ROOT / "bench" / "traffic" / f"{cell['traffic']}.json").exists()
    assert (ROOT / "bench" / "limits" / f"{cell['name']}.json").exists()
    for m in B["end_to_end"] + B["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("config", B["configs"], ids=lambda c: c["name"])
def test_configs_hold_the_model_they_run(config):
    path = ROOT / config["file"]
    assert path.parts[len(ROOT.parts)] == "bench"
    data = json.loads(path.read_text())
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == []
    assert data["model"]["name"] == config["name"]
    assert {"max_seq", "scheduler", "kernels"} <= set(data["engine"])
