"""Benchmark result persistence (copy of expann_tpu/bench/manager.py).

Counterpart of the reference's bench_data_manager
(reference: src/bench_data_manager.h:64-88): results of the current run are
appended to ``<prefix>data/all.json`` and overwrite
``<prefix>data/latest.json``; the CLI passes prefix ``./data/<ds_name>/``
(reference: src/main.cpp:105-106).
"""

from __future__ import annotations

import json
import os
from typing import List, Union

from expann_tpu_torch.bench.bench_data import BenchData


class BenchDataManager:
    def __init__(self, dataset_name: str):
        self.dataset_name = dataset_name
        self.latest: List[BenchData] = []
        self.bd_all_filename = "data/all.json"
        self.bd_latest_filename = "data/latest.json"

    def add(self, bd: Union[BenchData, str]) -> None:
        if isinstance(bd, BenchData):
            self.latest.append(bd)
        else:
            print(f"Got bench error: {bd}")

    def _write(self, filename: str, append: bool) -> None:
        existing = []
        if append and os.path.exists(filename):
            try:
                with open(filename) as f:
                    existing = json.load(f)
            except (json.JSONDecodeError, OSError):
                existing = []
        existing.extend(bd.to_dict() for bd in self.latest)
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        with open(filename, "w") as f:
            json.dump(existing, f, indent=4)

    def save(self, prefix: str = "") -> None:
        self._write(prefix + self.bd_latest_filename, append=False)
        self._write(prefix + self.bd_all_filename, append=True)

    def get_latest(self) -> List[BenchData]:
        return list(self.latest)

    def get_all(self, prefix: str = "") -> List[BenchData]:
        filename = prefix + self.bd_all_filename
        if not os.path.exists(filename):
            return []
        with open(filename) as f:
            data = json.load(f)
        return [BenchData.from_dict(j) for j in data]
