"""Find a cell's files by the names in ``BENCHMARK.json``.

Nothing here names a cell, a configuration, a traffic mix or a metric: a
cell of ``workloads`` names its configuration (``annbench/configs/<name>.json``)
and its traffic mix (``annbench/traffic/<name>.json``); the cell's own file
(``annbench/workloads/<name>.json``) names its engine
(``annbench/engines/<engine>.py``), its operating point and its limits; the
traffic names its driver (``annbench/drivers/<driver>.py``); each per-layer
metric is read by ``annbench/metrics/<name>.py``.  Adding any of them adds
files, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[1]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a Python file by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    spec: dict  # the cell's own file
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    def engine(self):
        return load_module(self.root / "annbench" / "engines" / f"{self.spec['engine']}.py",
                           f"annbench_engine_{self.spec['engine']}")

    def driver(self):
        return load_module(self.root / "annbench" / "drivers" / f"{self.traffic['driver']}.py",
                           f"annbench_driver_{self.traffic['driver']}")

    def reader(self, metric: str):
        return load_module(self.root / "annbench" / "metrics" / f"{metric}.py", f"annbench_metric_{metric}")


def _lists(entry: dict, name: str) -> bool:
    return "workloads" not in entry or name in entry["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its files."""
    bench = _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    base = root / "annbench"
    e2e = [m for m in bench["end_to_end"] if _lists(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=_json(base / "configs" / f"{entry['config']}.json"),
        traffic=_json(base / "traffic" / f"{entry['traffic']}.json"),
        spec=_json(base / "workloads" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
        root=root,
    )
