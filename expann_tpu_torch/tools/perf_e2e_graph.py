"""Engine-level graph QPS against batch size (counterpart of
tools/perf_e2e_graph.py).

Serves the canonical 56k index (built from the canonical corpus and
written to ``--index`` when the file is missing) through
``AntitopoEngine.query_k_batch`` and prints recall@10 on the 400 canonical
queries, then for each batch size Q the median and best QPS of 5 calls on
fresh N(0,1) queries (host clock, numpy in and out).  The JAX tool's
environment variables are arguments: ``--E`` (query_expand), ``--C``
(fused_cand), ``--qt`` (fused_qt, which on the card only sets the batch
below which a chunk takes the per-iteration route).  ``PERF_SORT``
(``fused_sort_tiles``) is not carried: that option is retired.  The other
tools serve the same index through ``canonical_graph``::

    python -m expann_tpu_torch.tools.perf_e2e_graph [--ef 100] [--Q 8192,32768,65536] [--qb 4096]
        [--dtype bf16|i8] [--E 2] [--C 16] [--qt 128]
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np

from expann_tpu_torch.bench.harness import sync
from expann_tpu_torch.data.loader import load_synthetic_uniform_sphere_points
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.tools.bench_1m import recall
from expann_tpu_torch.tools.perf_trace import IDX

ROOT = Path(__file__).resolve().parents[2]
DATA = str(ROOT / "build" / "data")
D, K = 128, 10


def canonical_data(n: int = 56000, device="cuda"):
    """The canonical dataset (``config_synthetic.json`` at ``n`` rows: 400
    queries, k=10, exact ground truth), cached under ``build/data/``."""
    return load_synthetic_uniform_sphere_points(n, 400, K, D, cache_dir=DATA, device=device)


def canonical_graph(index: str = IDX, n: int = 56000, device="cuda", **serve) -> AntitopoEngine:
    """The engine over the canonical graph (M=60, ef_construction =
    prune_cand = 500, prune_overflow=1, bench.py's build), read from
    ``index``, or built from ``canonical_data(n)`` and written there when
    the file is missing; ``serve`` sets the serving fields of
    ``AntitopoConfig`` (entry_seeds 8 unless given)."""
    cfg = AntitopoConfig(M=60, ef_construction=500, prune_cand=500, prune_overflow=1, precision="default",
                         index_filename=index, read_index=True, write_index=True,
                         **{"entry_seeds": 8, **serve})
    eng = AntitopoEngine(config=cfg, device=device)
    if not os.path.exists(index):
        os.makedirs(os.path.dirname(os.path.abspath(index)), exist_ok=True)
        eng.store_many_vectors(canonical_data(n, device).vecs)
    eng.build()
    return eng


def main(argv=None, device="cuda") -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=56000)
    ap.add_argument("--ef", type=int, default=100)
    ap.add_argument("--Q", default="8192,32768,65536", help="batch sizes")
    ap.add_argument("--qb", type=int, default=4096, help="query_block")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "i8"), help="packed_dtype")
    ap.add_argument("--E", type=int, default=2, help="query_expand")
    ap.add_argument("--C", type=int, default=16, help="fused_cand")
    ap.add_argument("--qt", type=int, default=128, help="fused_qt")
    ap.add_argument("--index", default=IDX)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    eng = canonical_graph(args.index, args.n, device, ef_search=args.ef, query_block=args.qb,
                          packed_dtype=args.dtype, query_expand=args.E, fused_cand=args.C, fused_qt=args.qt)
    sync(eng.device)
    print(f"build/load: {time.perf_counter() - t0:.1f}s", flush=True)
    ds = canonical_data(args.n, device)
    ids = eng.query_k_batch(ds.queries, K)
    m = ds.queries.shape[0]
    print(f"ef={args.ef} recall@10={recall(ids, ds.ground_truth):.4f} distcomps/q={eng.num_distcomps / m:.0f}",
          flush=True)
    rng = np.random.default_rng(7)
    out = []
    for Q in (int(v) for v in args.Q.split(",")):
        eng.query_k_batch(rng.standard_normal((Q, D)).astype(np.float32), K)
        times = []
        for _ in range(args.reps):
            b = rng.standard_normal((Q, D)).astype(np.float32)
            t0 = time.perf_counter()
            eng.query_k_batch(b, K)
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        out.append({"Q": Q, "qps": Q / med, "qps_best": Q / min(times)})
        print(f"Q={Q:6d} qb={args.qb}: median {med * 1e3:7.1f} ms -> {Q / med:8.0f} QPS "
              f"(best {Q / min(times):8.0f}) on {device}", flush=True)
    return out


if __name__ == "__main__":
    main()
