"""In-memory test dataset with ground truth.

Counterpart of the reference's CRTP dataset/test_dataset pair and its
in-memory implementation with JSON round-trip
(reference: src/dataset.h:9-31, src/in_memory_dataset.h:25-47).  The JSON
cache schema keeps the reference's field names ({name, n, dim, m, k,
all_vecs, all_query_vecs, all_query_ans}) so caches are interchangeable in
shape; vectors are stored as plain lists of floats.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List

import numpy as np


@dataclasses.dataclass
class TestDataset:
    __test__ = False  # not a pytest class

    name: str
    vecs: np.ndarray  # (n, dim) f32 corpus
    queries: np.ndarray  # (m, dim) f32
    ground_truth: np.ndarray  # (m, k) int64 ids

    @property
    def n(self) -> int:
        return self.vecs.shape[0]

    @property
    def dim(self) -> int:
        return self.vecs.shape[1]

    @property
    def m(self) -> int:
        return self.queries.shape[0]

    @property
    def k(self) -> int:
        return self.ground_truth.shape[1]

    def get_vec(self, i: int) -> np.ndarray:
        return self.vecs[i]

    def get_query(self, i: int) -> np.ndarray:
        return self.queries[i]

    def get_query_ans(self, i: int) -> List[int]:
        return [int(v) for v in self.ground_truth[i]]

    # --- JSON cache (same field names as the reference's imtd JSON,
    #     src/in_memory_dataset.h:25-47) ---
    def save_json(self, filename: str) -> None:
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        payload = {
            "name": self.name,
            "n": self.n,
            "dim": self.dim,
            "m": self.m,
            "k": self.k,
            "all_vecs": self.vecs.tolist(),
            "all_query_vecs": self.queries.tolist(),
            "all_query_ans": self.ground_truth.tolist(),
        }
        with open(filename, "w") as f:
            json.dump(payload, f)

    @classmethod
    def load_json(cls, filename: str) -> "TestDataset":
        with open(filename) as f:
            payload = json.load(f)
        return cls(
            name=payload["name"],
            vecs=np.asarray(payload["all_vecs"], np.float32),
            queries=np.asarray(payload["all_query_vecs"], np.float32),
            ground_truth=np.asarray(payload["all_query_ans"], np.int64),
        )
