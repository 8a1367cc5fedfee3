"""Recall / QPS measurement harness (counterpart of
expann_tpu/bench/harness.py).

Counterpart of the reference's basic_bench (reference:
src/basic_bench.h:58-149): times store+build, runs the full query set,
computes recall as |ans intersect GT| / (m * k), fails on duplicate
results ("Duplicates detected, engine is buggy", :98-104), and records
average (squared) distance of each top-1 answer.

Queries run batched, so time_per_query_ns is amortized wall-clock over the
query set: the reference's definition (total loop time / m, :131-135).
CUDA work is asynchronous, so each clock is read after the engine's card
has finished (``torch.cuda.synchronize``): otherwise the tail of the build
would be billed to the first query.  ``timed_queries`` and ``score`` are
the two halves of the measurement; the sweep runner (``runner.py``) calls
them for the jobs that reuse a build, so every job passes the same
duplicate check.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from expann_tpu_torch.bench.bench_data import BenchData
from expann_tpu_torch.data.dataset import TestDataset
from expann_tpu_torch.models.base import Engine


def sync(device: torch.device) -> None:
    """Wait for ``device`` where it is a card; the clocks read after it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_queries(eng: Engine, ds: TestDataset) -> Tuple[np.ndarray, float]:
    """Answers to the whole query set, ``(m, k)``, and the wall-clock
    nanoseconds per query of one timed pass.  One untimed warm-up pass at
    the timed shapes comes first: the first call builds the packed serving
    layout and, in a fresh process, the kernels (nvcc), neither of which the
    reference's ahead-of-time C++ pays per query."""
    eng.query_k_batch(ds.queries, ds.k)
    eng.reset_stats()  # the warm-up must not inflate the distcomp counters
    sync(eng.device)
    t0 = time.perf_counter_ns()
    ans = eng.query_k_batch(ds.queries, ds.k)
    sync(eng.device)
    t1 = time.perf_counter_ns()
    return ans, (t1 - t0) / ds.m


def score(eng: Engine, ds: TestDataset, ans: np.ndarray, per_query_ns: float, build_ns: float) -> BenchData:
    """The record of one job from its answers: recall, the top-1 distances,
    the times given.  Raises AssertionError on duplicate ids in a row
    (src/basic_bench.h:98-104); ids outside [0, n) are padding sentinels
    (-1 or n), not duplicates."""
    m, k = ds.m, ds.k
    if ans.shape[0] != m:
        raise ValueError(f"{ans.shape[0]} answer rows for {m} queries")
    gt = ds.ground_truth
    if gt.shape[1] != k:
        raise ValueError(f"ground truth holds {gt.shape[1]} ids a query, not k={k}")
    valid = (ans >= 0) & (ans < ds.n)
    for q in range(m):
        row = ans[q][valid[q]]
        if np.unique(row).size != row.size:
            raise AssertionError("Duplicates detected, engine is buggy.")

    num_best_found = 0
    avg_d = 0.0
    avg_d2 = 0.0
    for q in range(m):
        row = set(int(v) for v in ans[q][valid[q]])
        num_best_found += len(row.intersection(int(v) for v in gt[q]))
        if ans[q].size and valid[q].any():
            top1 = int(ans[q][valid[q]][0])
            diff = ds.queries[q].astype(np.float64) - ds.vecs[top1].astype(np.float64)
            d2 = float(np.dot(diff, diff))
            avg_d += np.sqrt(d2)
            avg_d2 += d2

    return BenchData(
        time_per_query_ns=per_query_ns,
        time_to_build_ns=build_ns,
        average_distance=avg_d / m,
        average_squared_distance=avg_d2 / m,
        recall=num_best_found / (m * k),
        engine_name=eng.name(),
        param_list=eng.param_list(),
    )


def get_benchmark_data(eng: Engine, ds: TestDataset) -> BenchData:
    """Store, build (timed) and query (timed) one engine on ``ds``."""
    t0 = time.perf_counter_ns()
    eng.store_many_vectors(ds.vecs)
    eng.build()
    sync(eng.device)
    t1 = time.perf_counter_ns()
    ans, per_query_ns = timed_queries(eng, ds)
    return score(eng, ds, ans, per_query_ns, float(t1 - t0))
