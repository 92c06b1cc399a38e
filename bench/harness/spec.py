"""What a cell is made of, found by name under the benchmark's root.

``BENCHMARK.json`` names the cell; its configuration is the file the
``configs`` entry names, its traffic ``bench/traffic/<traffic>.json``,
its correctness limits ``bench/limits/<cell>.json``, and each per-layer
metric a reader ``bench/metrics/<metric>.py``.  Adding a configuration,
a mix, a cell or a metric adds files and edits none of these.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict          # the configuration file
    mix: Dict             # the traffic file
    limits: Dict          # the check's limits
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic"
                      / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "bench" / "limits"
                         / f"{name}.json").read_text())
    return Cell(name, w["chips"], config, mix, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def reader(root: Path, metric: str) -> Callable:
    """The ``read(run)`` function of ``bench/metrics/<metric>.py``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
