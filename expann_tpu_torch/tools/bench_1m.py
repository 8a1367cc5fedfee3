"""Million-row build and serving on one card (counterpart of
tools/bench_1m.py).

Builds a 1M x 128 index with the one-device distributed one-shot builder
(parallel/distbuild.py: waves of 4096, candidates by segmented flat scans
through the flat top-k kernel K2, or with ``--ortho-count`` > 1 dense
penalized scans in column blocks) or, with ``--builder wave``, the wave
builder (models/wavebuild.py: beam-search candidates, waves of 1024, or
4096 from 524288 rows); ``--refine-frac`` > 0 then re-inserts that share of
the corpus (``refine_index_wave``).  It measures:

  * the build: seconds per stage, peak device memory, K2 launches, and for
    the wave builder its waves and beam iterations per wave; the
    refinement's seconds;
  * graph points (the fused traversal, entry seeds 8, f32 rerank):
    recall@10 against the exact oracle and host-clock QPS on 32768 fresh
    N(0,1) queries (best of 3), on s8 blocks at (expand, ef, cand) of the
    JAX tool's sweep, and on bf16 blocks where they fit under the engine's
    ``PACKED_BUDGET_BYTES``;
  * the flat engines ``fused`` and ``fused_i8``: recall@10 and QPS on 16384
    fresh queries (best of 3).

Data: ``--data clustered`` (``generate_synthetic_clustered(n, m, d,
seed=0)``, the hardened mixture), ``gaussian`` (N(0,1), seed 0) or
``fvecs:<dir>`` (``<dir>/sift_base.fvecs``, ``sift_query.fvecs``,
``sift_groundtruth.ivecs``, the reference's SIFT1M layout,
src/main.cpp:72-80).  Ground truth: ``BruteForceEngine(mode="exact")`` on
the card.  The index and the ground truth are cached under
``build/bench_1m/`` of the checkout, or ``--cache`` (``--skip-build``
reuses the index; its file name carries the builder and the refinement).
Prints one JSON line per point, each with the card's name and power
limit, and a summary line last:

    python -m expann_tpu_torch.tools.bench_1m --data clustered --M 48 --efc 300
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from expann_tpu_torch.data.loader import generate_synthetic, generate_synthetic_clustered, load_sift1m
from expann_tpu_torch.models.antitopo import PACKED_BUDGET_BYTES, AntitopoConfig, AntitopoEngine
from expann_tpu_torch.models.brute_force import BruteForceEngine
from expann_tpu_torch.models.build import BuildConfig, wave_size_for
from expann_tpu_torch.models.layout import Blocks, choose
from expann_tpu_torch.ops import _kernels
from expann_tpu_torch.models.wavebuild import build_index_wave, refine_index_wave
from expann_tpu_torch.parallel.distbuild import build_distributed
from expann_tpu_torch.utils.persist import load_index, save_index
from expann_tpu_torch.utils.profiling import card_name

CACHE = Path(__file__).resolve().parents[2] / "build" / "bench_1m"
# (expand, ef, cand) on s8 blocks: the JAX tool's sweep (tools/bench_1m.py:169-175)
GRAPH_POINTS = ((2, 40, 16), (2, 80, 8), (2, 80, 16), (2, 120, 8), (2, 120, 16), (2, 200, 32), (2, 256, 32))
BF16_POINT = (2, 120, 16)
GRAPH_B, FLAT_B = 32768, 16384


def recall(ids: np.ndarray, gt: np.ndarray) -> float:
    k = gt.shape[1]
    return float(np.mean([len(set(a[:k].tolist()) & set(b[:k].tolist())) / k for a, b in zip(ids, gt)]))


def best_qps(eng, rng, B: int, d: int, k: int, reps: int = 3) -> float:
    """Host-clock queries/s of one ``query_k_batch`` call on B fresh N(0,1)
    queries, numpy in and out, best of ``reps`` after one warm-up call."""
    eng.query_k_batch(rng.standard_normal((B, d)).astype(np.float32), k)
    best = float("inf")
    for _ in range(reps):
        qs = rng.standard_normal((B, d)).astype(np.float32)
        t0 = time.perf_counter()
        eng.query_k_batch(qs, k)
        best = min(best, time.perf_counter() - t0)
    return B / best


def graph_engine(graph, dim: int, M: int, qb: int, wire: str, device) -> AntitopoEngine:
    """A serving engine over a built graph: the fused route on the packed
    layout, 8 entry seeds, the given query block and wire."""
    cfg = AntitopoConfig(M=M, query_block=qb, entry_seeds=8, use_packed=True, query_wire=wire, packed_dtype="i8")
    eng = AntitopoEngine(config=cfg, device=device)
    eng.graph, eng.n, eng.dim = graph, graph.n, dim
    return eng


def graph_point(eng, queries, gt, expand: int, ef: int, cand: int, dtype: str, rng, qps_b: int) -> dict:
    """recall@10, distance computations a query and QPS of the graph
    engine at (expand, ef, cand) on ``dtype`` blocks."""
    eng.set_packed_dtype(dtype)
    eng.cfg.query_expand, eng.cfg.fused_cand = expand, cand
    eng.set_ef_search(ef)
    rec = recall(eng.query_k_batch(queries, gt.shape[1]), gt)
    dc = eng.num_distcomps / queries.shape[0]
    qps = best_qps(eng, rng, qps_b, queries.shape[1], gt.shape[1]) if qps_b else None
    return {"point": f"antitopo_ef{ef}_e{expand}_c{cand}_{dtype}", "recall": round(rec, 4),
            "qps": None if qps is None else round(qps, 1), "distcomps": round(dc, 1)}


def flat_point(x, queries, gt, mode: str, wire: str, rng, qps_b: int, device) -> tuple:
    """recall@10 and QPS of the flat engine in ``mode``: returns the point
    and the engine."""
    eng = BruteForceEngine(mode=mode, query_wire=wire if mode == "fused_i8" else "bf16", device=device)
    eng.store_many_vectors(x)
    t0 = time.perf_counter()
    eng.build()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rec = recall(eng.query_k_batch(queries, gt.shape[1]), gt)
    qps = best_qps(eng, rng, qps_b, queries.shape[1], gt.shape[1]) if qps_b else None
    return {"point": f"gpu_flat_{mode}", "recall": round(rec, 4), "qps": None if qps is None else round(qps, 1),
            "build_s": round(build_s, 2)}, eng


def load_data(args):
    """(x, queries, gt or None) of ``--data``."""
    if args.data.startswith("fvecs:"):
        base = args.data[6:].rstrip("/")
        ds = load_sift1m(os.path.join(base, "sift_base.fvecs"), os.path.join(base, "sift_query.fvecs"),
                         os.path.join(base, "sift_groundtruth.ivecs"), k_custom=args.k)
        return np.asarray(ds.vecs, np.float32), np.asarray(ds.queries, np.float32), np.asarray(ds.ground_truth)
    gen = generate_synthetic_clustered if args.data == "clustered" else generate_synthetic
    x, q = gen(args.n, args.m, args.d, seed=0)
    return x, q, None


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=400)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--skip-build", action="store_true", help="reuse the cached index when present")
    ap.add_argument("--build-only", action="store_true", help="build and cache the index, then stop")
    ap.add_argument("--M", type=int, default=32)
    ap.add_argument("--efc", type=int, default=127, help="ef_construction = prune_cand = C")
    ap.add_argument("--ortho-count", type=int, default=1, help="candidate passes; > 1 scans dense")
    ap.add_argument("--builder", default="auto", choices=("auto", "wave"),
                    help="auto: the distributed builder; wave: the wave builder")
    ap.add_argument("--refine-frac", type=float, default=0.0, help="> 0: refine this share of the corpus")
    ap.add_argument("--cache", default=str(CACHE), help="directory of the cached index and ground truth")
    ap.add_argument("--data", default="gaussian", help="gaussian, clustered or fvecs:<dir>")
    ap.add_argument("--wire", default="bf16", choices=("bf16", "i8"), help="graph query wire; fused_i8's too")
    ap.add_argument("--qb", type=int, default=8192, help="serving query_block")
    ap.add_argument("--ef-list", default="", help="serve only these ef (expand=2, cand=8, s8 blocks), e.g. 80,120")
    ap.add_argument("--skip-flat", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a small rehearsal")
    args = ap.parse_args(argv)
    if not (args.data in ("gaussian", "clustered") or args.data.startswith("fvecs:")):
        ap.error("--data must be gaussian, clustered, or fvecs:<dir>")
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("bench_1m runs on an NVIDIA GPU; none is present (--device cpu rehearses)")
    card = card_name() if on_card else "cpu"
    if on_card:
        t0 = time.perf_counter()
        _kernels.library()  # nvcc builds the kernels at first use: not build time
        print(f"kernels built: {time.perf_counter() - t0:.1f}s", flush=True)
    ntag = "" if args.n == 1_000_000 else f"_n{args.n}"
    otag = "" if args.ortho_count == 1 else f"_oc{args.ortho_count}"
    btag = "" if args.builder == "auto" else f"_{args.builder}"
    rtag = "" if args.refine_frac <= 0 else f"_rf{args.refine_frac:g}"
    dtag = "fvecs_" + os.path.basename(args.data[6:].rstrip("/")) if args.data.startswith("fvecs:") else args.data
    cache = Path(args.cache)
    cache.mkdir(parents=True, exist_ok=True)
    idx_path = cache / f"idx_M{args.M}_efc{args.efc}_{dtag}{ntag}{otag}{btag}{rtag}.npz"
    gt_path = cache / f"gt_{dtag}{ntag}_m{args.m}_k{args.k}.npz"
    results = []

    def emit(pt: dict) -> None:
        pt["card"] = card
        results.append(pt)
        print(json.dumps(pt), flush=True)

    t0 = time.perf_counter()
    x, queries, gt = load_data(args)
    n, d = x.shape
    print(f"data {args.data}: n={n} d={d} m={queries.shape[0]} ({time.perf_counter() - t0:.1f}s)", flush=True)
    if gt is None and not args.build_only:
        if gt_path.exists():
            gt = np.load(gt_path)["gt"]
        else:
            t0 = time.perf_counter()
            bf = BruteForceEngine(mode="exact", batch_size=100, device=device)
            bf.store_many_vectors(x)
            bf.build()
            gt = bf.query_k_batch(queries, args.k)
            print(f"exact ground truth: {time.perf_counter() - t0:.1f}s", flush=True)
            np.savez(gt_path, gt=gt)
            del bf

    if args.skip_build and idx_path.exists():
        graph, _ = load_index(str(idx_path), device)
    else:
        cfg = BuildConfig(M=args.M, ef_construction=args.efc, prune_cand=args.efc, ortho_count=args.ortho_count)
        _kernels.launches.clear()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        ws = wave_size_for(cfg, n)
        t0 = time.perf_counter()
        if args.builder == "wave":
            stats = {}
            graph = build_index_wave(x, cfg, device, wave_size=ws, verbose=True, stats=stats)
            iters = stats.pop("wave_iterations")
            stats.update(wave_size=ws, iterations_mean=round(float(np.mean(iters)), 1) if iters else 0,
                         iterations_max=max(iters, default=0))
        else:
            graph, stats = build_distributed(x, cfg, device, wave_size=4096, mode="oneshot", candidates="flat",
                                             verbose=True)
        build_s = time.perf_counter() - t0
        adj = graph.adj_bottom[:n]
        deg = (adj < n).sum(1)
        emit({"point": "build", "builder": args.builder, "build_s": round(build_s, 2), "n": n, "M": args.M,
              "efc": args.efc, "ortho_count": args.ortho_count,
              "seconds": {k: round(v, 2) for k, v in stats.pop("seconds").items()}, **stats,
              "flat_topk_launches": _kernels.launches.get("flat_topk", 0), "layers": len(graph.layers),
              "degree_mean": round(float(deg.float().mean()), 2), "degree_min": int(deg.min()),
              "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2) if on_card else None})
        if args.refine_frac > 0:
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            stats = {}
            t0 = time.perf_counter()
            graph = refine_index_wave(graph, cfg, frac=args.refine_frac, wave_size=ws, verbose=True, stats=stats)
            emit({"point": "refine", "refine_s": round(time.perf_counter() - t0, 2), "frac": args.refine_frac,
                  "wave_size": ws, "waves": stats["waves"], "swept_rows": stats["swept_rows"],
                  "seconds": {k: round(v, 2) for k, v in stats["seconds"].items()},
                  "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2) if on_card else None})
        save_index(str(idx_path), graph, {"dim": d})
    if args.build_only:
        print(f"build-only: index at {idx_path}", flush=True)
        return results

    rng = np.random.default_rng(99)
    qps_b = GRAPH_B if on_card else 0
    eng = graph_engine(graph, d, args.M, args.qb, args.wire, device)
    plist = [(e, ef, c, "i8") for e, ef, c in GRAPH_POINTS]
    if choose(n + 1, graph.adj_bottom.shape[1], graph.vectors.shape[1], "bf16", PACKED_BUDGET_BYTES) is Blocks:
        plist.append((*BF16_POINT, "bf16"))
    if args.ef_list:
        plist = [(2, int(s), 8, "i8") for s in args.ef_list.split(",")]
    for expand, ef, cand, dtype in plist:
        emit(graph_point(eng, queries, gt, expand, ef, cand, dtype, rng, qps_b))
    del eng, graph
    for mode in () if args.skip_flat else ("fused", "fused_i8"):
        emit(flat_point(x, queries, gt, mode, args.wire, rng, FLAT_B if on_card else 0, device)[0])
    print(json.dumps({"summary_1m": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
