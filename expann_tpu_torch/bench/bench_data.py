"""Benchmark result record (copy of expann_tpu/bench/bench_data.py).

Field-for-field the reference's ``bench_data`` JSON schema
(reference: src/bench_data.h:8-39) — the plot dashboard keys off these exact
names: time_per_query_ns, time_to_build_ns, average_distance,
average_squared_distance, recall, engine_name, param_list.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict


@dataclasses.dataclass
class BenchData:
    time_per_query_ns: float = 0.0
    time_to_build_ns: float = 0.0
    average_distance: float = 0.0
    average_squared_distance: float = 0.0
    recall: float = 0.0
    engine_name: str = ""
    param_list: Dict[str, str] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "time_per_query_ns": self.time_per_query_ns,
            "time_to_build_ns": self.time_to_build_ns,
            "average_distance": self.average_distance,
            "average_squared_distance": self.average_squared_distance,
            "recall": self.recall,
            "engine_name": self.engine_name,
            "param_list": dict(self.param_list),
        }

    @classmethod
    def from_dict(cls, j: dict) -> "BenchData":
        return cls(
            time_per_query_ns=j["time_per_query_ns"],
            time_to_build_ns=j["time_to_build_ns"],
            average_distance=j["average_distance"],
            average_squared_distance=j["average_squared_distance"],
            recall=j["recall"],
            engine_name=j["engine_name"],
            param_list=dict(j.get("param_list", {})),
        )

    def to_string(self) -> str:
        return json.dumps(self.to_dict())

    @property
    def qps(self) -> float:
        """QPS transform used by the dashboard (reference:
        src/pyplotter.py:46-49)."""
        return 1e9 / self.time_per_query_ns if self.time_per_query_ns else 0.0
