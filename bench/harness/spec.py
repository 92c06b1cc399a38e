"""What a cell is made of, found by name under the benchmark's root.

``BENCHMARK.json`` names the cell; its configuration is the file the
``configs`` entry names, its traffic ``bench/traffic/<traffic>.json``,
its correctness limits ``bench/limits/<cell>.json``, and each per-layer
metric a reader ``bench/metrics/<metric>.py``.  The configuration's
``model["family"]`` names the family module ``bench/families/<family>.py``
(weights, the port's config, the work the metrics count) and the plain
reference ``bench/reference/<family>.py``.  Adding a family, a
configuration, a mix, a cell or a metric adds files and edits none of
these.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
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
    family: ModuleType    # bench/families/<family>.py
    reference: ModuleType  # bench/reference/<family>.py


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
    fam, ref = family_modules(root, config["model"]["family"])
    return Cell(name, w["chips"], config, mix, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)],
                fam, ref)


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_modules(root: Path, name: str):
    """The family module and the plain reference of family ``name``:
    ``bench/families/<name>.py`` and ``bench/reference/<name>.py``."""
    paths = [root / "bench" / kind / f"{name}.py"
             for kind in ("families", "reference")]
    missing = [str(p.relative_to(root)) for p in paths if not p.is_file()]
    if missing:
        raise LookupError(f"no family {name!r} in the benchmark: add "
                          + " and ".join(missing))
    return tuple(_load(p, f"bench_{p.parent.name}_{name}") for p in paths)


def reader(root: Path, metric: str) -> Callable:
    """The ``read(run)`` function of ``bench/metrics/<metric>.py``."""
    return _load(root / "bench" / "metrics" / f"{metric}.py",
                 "bench_metric_" + metric).read
