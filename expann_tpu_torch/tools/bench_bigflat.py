"""Tens of millions of flat rows on one card (counterpart of
tools/bench_bigflat.py).

The flat engine stores each vector once: a bf16 corpus takes 2 bytes a
dimension, so 20M x 128 rows are 5.1 GB on the card, scanned by the flat
top-k kernel (K2; ``fused_i8``: K2-s8 over int8 codes, then the exact
rerank).  Ids past 2^24 appear from n = 16,777,217 on: an id carried in f32
or an element offset in 32 bits would break there.  This tool measures
recall@k and QPS at that size, with the JAX tool's draws: the corpus N(0,1)
from numpy seed 0 in chunks of 2^20 rows (``gen_corpus``), m queries from
seed 1, exact f32 host ground truth (``host_gt``, cached under
``build/bigflat/``), QPS on batches of Q fresh queries (median and best of
``--reps``, host clock, numpy in and out).  ``fused_i8`` keeps its rerank
corpus in bf16 above 8M rows.

It prints the JAX tool's JSON line plus the card, the ids >= 2^24 among the
results and the peak device memory, and the wall time of the m-query
recall call on a line of its own: that call is ceil(m / 64) blocks of K2
(2 of the H100's 132 SMs at m=100), each streaming the whole corpus::

    python -m expann_tpu_torch.tools.bench_bigflat [--n 20000000] [--m 100] [--mode fused|fused_i8]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from expann_tpu_torch.models.brute_force import BruteForceEngine
from expann_tpu_torch.tools.bench_1m import recall
from expann_tpu_torch.utils.profiling import card_name

CACHE = str(Path(__file__).resolve().parents[2] / "build" / "bigflat")
BIG_ID = 1 << 24
I8_BF16_RERANK_ROWS = 8_000_000  # above it fused_i8 reranks against bf16 rows


def gen_corpus(n: int, d: int, seed: int = 0) -> np.ndarray:
    """Chunked N(0,1) corpus straight into one preallocated f32 buffer."""
    x = np.empty((n, d), np.float32)
    rng = np.random.default_rng(seed)
    step = 1 << 20
    for s in range(0, n, step):
        e = min(n, s + step)
        x[s:e] = rng.standard_normal((e - s, d), dtype=np.float32)
    return x


def host_gt(x: np.ndarray, q: np.ndarray, k: int, cache: str = "") -> np.ndarray:
    """Exact top-k ids by f32 host matmuls over blocks of 2^20 rows, each
    block's k best kept by ``argpartition`` and merged; read from and
    written to ``cache`` (an .npz path) when given."""
    if cache and os.path.exists(cache):
        return np.load(cache)["gt"]
    m = q.shape[0]
    qn = (q * q).sum(1)[:, None]
    best_d = np.full((m, k), np.inf, np.float64)
    best_i = np.zeros((m, k), np.int64)
    step = 1 << 20
    for s in range(0, x.shape[0], step):
        xb = x[s : s + step]
        d2 = qn + (xb * xb).sum(1)[None, :] - 2.0 * (q @ xb.T)
        part = np.argpartition(d2, k, axis=1)[:, :k]
        cd = np.take_along_axis(d2, part, axis=1)
        alld = np.concatenate([best_d, cd], axis=1)
        alli = np.concatenate([best_i, part + s], axis=1)
        sel = np.argpartition(alld, k, axis=1)[:, :k]
        best_d = np.take_along_axis(alld, sel, axis=1)
        best_i = np.take_along_axis(alli, sel, axis=1)
    order = np.argsort(best_d, axis=1)
    gt = np.take_along_axis(best_i, order, axis=1)
    if cache:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez(cache, gt=gt)
    return gt


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--mode", choices=("fused", "fused_i8"), default="fused")
    ap.add_argument("--Q", type=int, default=16384, help="QPS batch size")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cache", default=CACHE, help="directory of the cached ground truth ('' : none)")
    args = ap.parse_args(argv)
    n, d, m, k = args.n, args.d, args.m, args.k
    device = torch.device(device)
    on_card = device.type == "cuda"
    card = card_name() if on_card else "cpu"

    t0 = time.perf_counter()
    x = gen_corpus(n, d)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((m, d)).astype(np.float32)
    print(f"corpus {n} x {d}: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    gt = host_gt(x, q, k, os.path.join(args.cache, f"gt_{n}_{d}_{m}_k{k}.npz") if args.cache else "")
    print(f"host ground truth: {time.perf_counter() - t0:.1f}s", flush=True)

    eng = BruteForceEngine(mode=args.mode, device=device,
                           rerank_store="bf16" if args.mode == "fused_i8" and n > I8_BF16_RERANK_ROWS else "f32")
    eng.store_many_vectors(x)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.build()
    if on_card:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del x
    print(f"build (upload): {build_s:.1f}s", flush=True)

    t0 = time.perf_counter()
    ids = eng.query_k_batch(q, k)  # numpy out: the device work is done
    call_s = time.perf_counter() - t0
    rec = recall(ids, gt)
    big_ids = int((ids >= BIG_ID).sum())
    print(f"recall call: m={m} queries, {(m + 63) // 64} blocks of the flat kernel, wall {call_s:.3f}s",
          flush=True)

    Q = args.Q
    eng.query_k_batch(rng.standard_normal((Q, d)).astype(np.float32), k)
    times = []
    for _ in range(args.reps):
        b = rng.standard_normal((Q, d)).astype(np.float32)
        t0 = time.perf_counter()
        eng.query_k_batch(b, k)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    out = {"point": f"bigflat_{args.mode}", "n": n, "recall": round(rec, 4), "qps": round(Q / med, 1),
           "qps_best": round(Q / min(times), 1), "build_s": round(build_s, 1), "ids_ge_2_24": big_ids,
           "recall_call_s": round(call_s, 3), "rerank_store": eng.rerank_store,
           "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2) if on_card else None, "card": card}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
