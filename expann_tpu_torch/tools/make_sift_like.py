"""Write a SIFT1M-shaped dataset as fvecs / ivecs files (counterpart of
tools/make_sift_like.py).

SIFT1M itself is absent, so this stand-in carries SIFT's value regime:

  * n=1,000,000 base vectors, d=128, m=10,000 queries (SIFT1M's shape,
    reference src/main.cpp:72-80);
  * integer components in [0, 255] stored as f32 (real SIFT fvecs hold u8
    descriptors promoted to float), so the uint8 cast of ``use_compression``
    (reference src/quantizer.h:132-141) is lossless on it;
  * the clustered geometry of ``data/loader.generate_synthetic_clustered``
    (seed 7) mapped affinely into that box, the queries by the corpus's map;
  * the exact top-100 ids as ground truth, computed on ``device`` (the card
    by default) by this package's exact engine, ``BruteForceEngine(mode=
    "exact")``, in chunks of 512 queries, ties broken by (d, id).

Writes ``<out>/sift_base.fvecs``, ``sift_query.fvecs`` and
``sift_groundtruth.ivecs`` (the reference's file names), ~520 MB at full
size; ``tools/bench_1m.py --data fvecs:<out>`` and the CLI read them::

    python -m expann_tpu_torch.tools.make_sift_like [--n 1000000] [--m 10000] [--out build/sift_like]
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np

from expann_tpu_torch.data.loader import generate_synthetic_clustered
from expann_tpu_torch.models.brute_force import BruteForceEngine

OUT = str(Path(__file__).resolve().parents[2] / "build" / "sift_like")
GT_CHUNK = 512  # queries per exact-engine call


def write_vecs(path: str, mat: np.ndarray, as_int: bool = False) -> None:
    """fvecs / ivecs: each record is (int32 d, then d 4-byte items)
    (reference: src/dataset_loader.h:96-125), in one write."""
    n, d = mat.shape
    body = mat.astype(np.int32) if as_int else mat.astype(np.float32).view(np.int32)
    rec = np.empty((n, d + 1), np.int32)
    rec[:, 0] = d
    rec[:, 1:] = body
    rec.tofile(path)


def to_u8_box(x: np.ndarray, lo_q=0.001, hi_q=0.999, bounds=None) -> tuple:
    """Map a float cloud affinely onto integer values in [0, 255] (SIFT's
    value regime).  Returns ``(u8-valued f32 array, bounds)``: pass the
    bounds back in so that the queries share the corpus's map."""
    if bounds is None:
        bounds = (float(np.quantile(x, lo_q)), float(np.quantile(x, hi_q)))
    lo, hi = bounds
    y = (x - lo) / max(hi - lo, 1e-9) * 255.0
    return np.clip(np.rint(y), 0, 255).astype(np.float32), bounds


def exact_gt(x: np.ndarray, q: np.ndarray, k: int, device="cuda") -> np.ndarray:
    """Exact top-k ids of each query, ordered by (d, id), by the exact
    engine on ``device`` in chunks of ``GT_CHUNK`` queries."""
    eng = BruteForceEngine(mode="exact", batch_size=GT_CHUNK, device=device)
    eng.store_many_vectors(x)
    eng.build()
    return eng.query_k_batch(q, k)


def make_sift_like(out: str, n: int, m: int, d: int = 128, k: int = 100, seed: int = 7, device="cuda") -> dict:
    """Generate and write the three files under ``out``; returns the box
    bounds and the seconds of each step."""
    t0 = time.perf_counter()
    x, q = generate_synthetic_clustered(n, m, d, seed=seed)
    x, bounds = to_u8_box(x)
    q, _ = to_u8_box(q, bounds=bounds)
    t1 = time.perf_counter()
    gt = exact_gt(x, q, k, device)
    t2 = time.perf_counter()
    os.makedirs(out, exist_ok=True)
    write_vecs(os.path.join(out, "sift_base.fvecs"), x)
    write_vecs(os.path.join(out, "sift_query.fvecs"), q)
    write_vecs(os.path.join(out, "sift_groundtruth.ivecs"), gt, as_int=True)
    return {"bounds": bounds, "data_s": t1 - t0, "gt_s": t2 - t1, "write_s": time.perf_counter() - t2}


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=10_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    print(f"generating clustered n={args.n} m={args.m} d={args.d} seed={args.seed} ...", flush=True)
    res = make_sift_like(args.out, args.n, args.m, args.d, args.k, args.seed, device)
    print(f"u8 box bounds={res['bounds']}; data {res['data_s']:.1f}s, exact top-{args.k} on {device} "
          f"{res['gt_s']:.1f}s, write {res['write_s']:.1f}s -> {args.out}/", flush=True)
    return res


if __name__ == "__main__":
    main()
