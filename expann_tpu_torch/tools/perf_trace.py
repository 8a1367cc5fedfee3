"""Trace-driven serving profile (counterpart of tools/perf_trace.py; uses
``utils/profiling.trace``).

Captures a ``torch.profiler`` trace around one warm ``query_k_batch`` call
of an engine (graph or flat) and reports where the card's time went: device
time per kernel and per copy, summed from the records of the exported
Chrome trace, and how much of the call the device sat idle.  The
counters say how many distance computations ran (RECORD_STATS,
src/antitopo_engine.h:125-129); the trace says where the time went, as the
reference's callgrind toggles around the query loop did
(src/basic_bench.h:76-77, 128-129).

    python -m expann_tpu_torch.tools.perf_trace [--B 8192] [--ef 100] [--top 15]
        [--log-dir build/trace] [--index index/perf_fused_idx_56000.npz]
        [--engine graph|flat|flat_i8]

serves the canonical 56k index on s8 packed blocks (the index file is
built on the card first if it is missing), or with ``--engine`` the
canonical corpus on the flat engine (``mode="fused"``) or on ``fused_i8``
with the i8 query wire.  Prints a JSON object with the top kernels by
device time, the copies, the idle share and the seconds of the process's
steps (``seconds``: corpus, build, traced call with its warm-up).
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from expann_tpu_torch.utils.profiling import DEFAULT_LOG_DIR, annotate, trace

ROOT = Path(__file__).resolve().parents[2]
IDX = str(ROOT / "index" / "perf_fused_idx_56000.npz")


def _newest_events(log_dir: str):
    """The events of the newest Chrome trace under ``log_dir`` (None without one)."""
    paths = sorted(glob.glob(os.path.join(log_dir, "*.json")) + glob.glob(os.path.join(log_dir, "*.json.gz")),
                   key=os.path.getmtime)
    if not paths:
        return None
    opener = gzip.open if paths[-1].endswith(".gz") else open
    with opener(paths[-1], "rt") as f:
        return json.load(f).get("traceEvents", [])


def _us_by_name(events, cats) -> dict:
    out = defaultdict(float)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cats and "dur" in e:
            out[e["name"]] += float(e["dur"])
    return out


def parse_trace(log_dir: str, top: int):
    """Device time per kernel name (µs) in the newest Chrome trace under
    ``log_dir``, kernel records only (``"cat": "kernel"``): the ``top``
    names by total time, and the total.  ``(None, None)`` without a trace."""
    events = _newest_events(log_dir)
    if events is None:
        return None, None
    kernel_us = _us_by_name(events, ("kernel",))
    ranked = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:top]
    return ranked, sum(kernel_us.values())


def parse_copies(log_dir: str, region: str):
    """The copies of the newest trace under ``log_dir`` and the region they
    ran in: device µs per memcpy / memset name (``"gpu_memcpy"``,
    ``"gpu_memset"`` records), their total, and the host span (µs) of the
    ``annotate(region)`` record, which covers a call that ends in a sync.
    ``(None, None, None)`` without a trace; the span is None without the
    region."""
    events = _newest_events(log_dir)
    if events is None:
        return None, None, None
    copy_us = _us_by_name(events, ("gpu_memcpy", "gpu_memset"))
    spans = [float(e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") == region]
    return dict(sorted(copy_us.items(), key=lambda kv: -kv[1])), sum(copy_us.values()), max(spans, default=None)


REGION = "fused_serving_dispatch"
ENGINES = ("graph", "flat", "flat_i8")
N, M, D = 56000, 400, 128  # config_synthetic.json


def canonical_corpus() -> np.ndarray:
    """The canonical corpus, the bytes ``load_synthetic_uniform_sphere_points``
    returns as ``vecs``, drawn alone: no ground truth, no dataset file."""
    from expann_tpu_torch.data.loader import generate_synthetic

    return generate_synthetic(N, M, D, None)[0]


def profile_dispatch(eng, B: int = 8192, k: int = 10, top: int = 15, log_dir: str = DEFAULT_LOG_DIR,
                     seed: int = 7) -> dict:
    """One warm ``query_k_batch`` of B fresh N(0, 1) queries on ``eng`` (a
    graph or a flat engine) under the profiler: wall ms (profiler
    included), device µs of the kernels, the top kernels with their shares,
    the device µs of the copies by name, the call's host span (µs, from its
    annotation) and the device's idle share of that span (1 - (kernels +
    copies) / span, unclamped: below 0 when the device records overrun the
    span, and then the accounting is off).  A warm-up call of other queries runs first under a
    trace of its own: the first trace in a process pays the tracer's
    start-up (seconds on an H100 host), which must not land in the timed
    call.  The timed call's trace is the newest file in ``log_dir``."""
    rng = np.random.default_rng(seed)
    with trace(log_dir, device=eng.device):
        eng.query_k_batch(rng.standard_normal((B, eng.dim)).astype(np.float32), k)
    qs = rng.standard_normal((B, eng.dim)).astype(np.float32)
    t0 = time.perf_counter()
    with trace(log_dir, device=eng.device):
        with annotate(REGION):
            eng.query_k_batch(qs, k)
    wall = time.perf_counter() - t0
    ranked, total_us = parse_trace(log_dir, top)
    if not ranked:
        raise RuntimeError(f"no kernel records in the trace under {log_dir}")
    copies, copy_us, span_us = parse_copies(log_dir, REGION)
    return {
        "B": B,
        "ef": getattr(getattr(eng, "cfg", None), "ef_search", None),
        "wall_ms": wall * 1e3,
        "device_total_us": total_us,
        "top_kernels": [{"kernel": name[:120], "us": us, "pct": 100 * us / total_us} for name, us in ranked],
        "copies": [{"copy": name[:120], "us": us} for name, us in copies.items()],
        "copy_us": copy_us,
        "span_us": span_us,
        "idle_share": None if not span_us else 1 - (total_us + copy_us) / span_us,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=8192)
    ap.add_argument("--ef", type=int, default=100)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--log-dir", default=DEFAULT_LOG_DIR)
    ap.add_argument("--index", default=IDX)
    ap.add_argument("--engine", choices=ENGINES, default="graph")
    args = ap.parse_args(argv)

    from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
    from expann_tpu_torch.models.brute_force import BruteForceEngine

    seconds, t0 = {}, time.perf_counter()
    if args.engine == "graph":
        # the index of tools/perf_e2e_graph.py's build (prune_overflow=1),
        # served as tools/perf_trace.py serves it: s8 blocks, 8 entry seeds
        cfg = AntitopoConfig(
            M=60, ef_construction=500, prune_cand=500, prune_overflow=1,
            packed_dtype="i8", entry_seeds=8, ef_search=args.ef,
            index_filename=args.index, read_index=True, write_index=True,
        )
        eng = AntitopoEngine(config=cfg)
        if not os.path.exists(args.index):
            os.makedirs(os.path.dirname(os.path.abspath(args.index)), exist_ok=True)
            corpus = canonical_corpus()
            seconds["corpus"] = time.perf_counter() - t0
            eng.store_many_vectors(corpus)
    else:  # the flat engines over the canonical corpus, as bench.py builds them
        eng = BruteForceEngine(mode="fused") if args.engine == "flat" else BruteForceEngine(
            mode="fused_i8", query_wire="i8")
        corpus = canonical_corpus()
        seconds["corpus"] = time.perf_counter() - t0
        eng.store_many_vectors(corpus)
    t1 = time.perf_counter()
    eng.build()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    seconds["build"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out = profile_dispatch(eng, args.B, top=args.top, log_dir=args.log_dir)
    seconds["traced"] = time.perf_counter() - t1
    out["seconds"] = seconds
    print(f"traced dispatch: {out['wall_ms']:.1f} ms wall (B={args.B})", flush=True)
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
