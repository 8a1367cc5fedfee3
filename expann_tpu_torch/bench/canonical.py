"""The canonical benchmark: recall@10 against QPS on the reference's
canonical synthetic config, n=56000, m=400, d=128, k=10
(config_synthetic.json); the counterpart of the repo-root bench.py::

    python -m expann_tpu_torch.bench.canonical                 # canonical size
    BENCH_QUICK=1 python -m expann_tpu_torch.bench.canonical   # n=8000, m=200, fewer points

Prints ONE JSON line with bench.py's keys.  The flow is bench.py's
(:199-390), through this package's engines on the card:

  * ``gpu_flat``: ``BruteForceEngine(mode="fused")``, the flat top-k kernel;
  * ``gpu_flat_i8``: ``mode="fused_i8"`` on the i8 query wire, the s8 flat
    top-k kernel and the exact f32 rerank;
  * the graph engine with bench.py's config at ef 40 / 60 / 100 / 120
    (``antitopo_ef*``, the fused traversal over bf16 blocks), on s8 blocks
    at ef 100 / 110 / 120 (``antitopo_compressed_ef*``) and on the i8 query
    wire at ef 110 / 120 (``antitopo_wire_i8_ef*``).

QPS is the median of ``reps`` timed ``query_k_batch`` calls, each on a
fresh batch of unique N(0,1) queries made by numpy (numpy in, numpy out:
upload, download and host work included), with the best alongside.  Recall
is measured on the m canonical queries against the exact ground truth, and
distance computations per query come from that recall run.  The device
QPS exclude the host: ``flat_topk`` on bf16 queries made on the card
(CUDA events, median of ``reps``), and ``fused_query_batch`` on 512
resident queries at ef=120, the slope between r1 and r2 back-to-back calls
(median of 3).  Off the card they are null: the calls run, but a host
clock is not a device metric.

``vs_baseline`` and ``vs_baseline_build`` divide by the single-core CPU
reference loop measured on the card's own host (``cpu_baseline.json``
beside this file, written by ``expann_tpu_torch/tools/cpu_baseline.py``),
and only at the config it was measured at; otherwise they are null, and
``baseline_note`` says why.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from expann_tpu_torch.bench.harness import sync
from expann_tpu_torch.data.loader import load_synthetic_uniform_sphere_points
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.models.brute_force import BruteForceEngine
from expann_tpu_torch.models.search import fused_query_batch
from expann_tpu_torch.ops.topk import flat_topk

RECALL_TARGET = 0.95
BASELINE_QPS_EST = 10_000.0  # rounds 1-3 engineering estimate, not a reading (bench.py:38)
BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpu_baseline.json")
CANONICAL = (56000, 400, 128, 10)  # n, m, d, k
QUICK = (8000, 200, 128, 10)
GRAPH_MULTS = (4, 6, 10, 12)  # ef = k * mult (bench.py:284)
QUICK_MULTS = (4,)
QUANT_MULTS = (10, 11, 12)  # s8 blocks (bench.py:306)
WIRE_MULTS = (11, 12)  # i8 query wire (bench.py:329)
DEVICE_EF = 120
DEVICE_B = 512

Point = Tuple[str, float, float, float, float]  # name, recall, qps, distcomps/query, best qps


def graph_config() -> AntitopoConfig:
    """bench.py's graph config (bench.py:256-279).  ``use_packed`` and
    ``use_fused`` are True: on the card "auto" resolves to the same for
    these calls (every chunk is at least ``fused_qt``), and set, they take
    a CPU run down the same route through the plain versions."""
    return AntitopoConfig(
        M=60,
        ef_construction=500,
        ortho_count=1,
        prune_overflow=1,
        prune_cand=500,
        query_expand=2,
        packed_topt=8,
        fused_cand=8,
        fused_qt=128,
        query_block=16384,
        entry_seeds=8,
        precision="default",
        use_packed=True,
        use_fused=True,
    )


def load_cpu_baseline(path: str = BASELINE_FILE) -> Optional[dict]:
    """The CPU denominators measured on the card's host, or None."""
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def _denominators(base: Optional[dict], config: dict) -> Tuple[Optional[float], Optional[float], str]:
    """``(qps, build_s, note)``: the baseline's QPS and build seconds where
    it was measured at ``config``, else None, and the note that says which."""
    if base is None:
        return None, None, (
            "vs_baseline and vs_baseline_build are null: no CPU baseline "
            "(expann_tpu_torch/bench/cpu_baseline.json is missing)"
        )
    if base["config"] != config:
        return None, None, (
            f"vs_baseline and vs_baseline_build are null: the CPU baseline was "
            f"measured at {base['config']}, this run is {config}"
        )
    den, build_s = base["denominator"], base.get("build_s")
    note = (
        f"vs_baseline = value / {den['qps']} QPS, the single-core CPU reference "
        f"serving loop (native/baseline_search.cpp, pinned to one core, the median "
        f"QPS of ef-interleaved sweeps) over this "
        f"package's canonical graph on the card's own host ({base['host_cpu']}) at "
        f"its lowest ef with recall@10 >= {RECALL_TARGET} (ef={den['ef']}, recall "
        f"{den['recall']}; expann_tpu_torch/bench/cpu_baseline.json, written by "
        f"expann_tpu_torch/tools/cpu_baseline.py); vs_baseline_est10k = value / "
        f"10000, the rounds 1-3 engineering estimate, not a reading; "
    )
    if build_s:
        note += (
            f"vs_baseline_build = {build_s} s, the single-core insert-loop build "
            f"(native/baseline_build.cpp) on the same host, / graph_build_s"
        )
    else:
        note += f"vs_baseline_build is null: {base.get('build_note', 'the baseline holds no build time')}"
    return den["qps"], build_s or None, note


def _device_seconds(device: torch.device, fn) -> Optional[float]:
    """Seconds of ``fn``'s work on the card by CUDA events.  Off the card
    ``fn`` runs all the same and the result is None."""
    if device.type != "cuda":
        fn()
        return None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _recall(ans: np.ndarray, gt_sets: List[set], k: int) -> float:
    hits = sum(len(set(int(v) for v in ans[i]) & gt_sets[i]) for i in range(len(gt_sets)))
    return hits / (len(gt_sets) * k)


def _qps(eng, d: int, k: int, Q: int, reps: int, seed: int = 20260816) -> Tuple[float, float]:
    """``(median, best)`` QPS of ``reps`` calls, each on a fresh batch of Q
    unique N(0,1) queries (the synthetic dataset's distribution), after one
    warm-up call.  ``query_k_batch`` returns numpy, so a call's clock stops
    after the card has finished."""
    rng = np.random.default_rng(seed)

    def batch():
        return rng.standard_normal((Q, d)).astype(np.float32)

    eng.query_k_batch(batch(), k)
    times = []
    for _ in range(reps):
        b = batch()
        t0 = time.perf_counter()
        eng.query_k_batch(b, k)
        times.append(time.perf_counter() - t0)
    return Q / float(np.median(times)), Q / min(times)


def flat_device_qps(flat: BruteForceEngine, d: int, k: int, Q: int, reps: int, seed: int = 1) -> Optional[float]:
    """Queries per second of one ``flat_topk`` call on Q bf16 queries made on
    the card, a fresh batch each rep (CUDA events, median of ``reps``)."""
    x = flat._x_fused
    gen = torch.Generator(x.device).manual_seed(seed)

    def batch():
        q = torch.randn((Q, d), generator=gen, device=x.device, dtype=torch.bfloat16)
        return F.pad(q, (0, x.shape[1] - d))

    flat_topk(batch(), x, k)
    secs = []
    for _ in range(reps):
        q = batch()
        secs.append(_device_seconds(x.device, lambda: flat_topk(q, x, k)))
    return None if secs[0] is None else Q / float(np.median(secs))


def graph_device_qps(eng: AntitopoEngine, d: int, k: int, ef: int = DEVICE_EF, B: int = DEVICE_B,
                     seed: int = 7) -> Optional[float]:
    """Queries per second of the whole fused query path (entry scan,
    traversal, exact rerank) on B resident queries at ``ef``, over the
    engine's current packed layout: the slope between r1 and r2
    back-to-back calls, r2 doubled until a run takes 0.5 s, median of 3
    (the slope cancels the fixed cost of a run)."""
    g, c = eng.graph, eng.cfg
    dev = g.vectors.device
    gen = torch.Generator(dev).manual_seed(seed)
    q = F.pad(torch.randn((B, d), generator=gen, device=dev), (0, g.vectors.shape[1] - d))

    def calls(r: int) -> None:
        for _ in range(r):
            fused_query_batch(g, q, ef=ef, k=k, ef_cap=ef + (-ef) % 128, expand=c.query_expand,
                              cand=c.fused_cand, seeds=c.entry_seeds)

    def t(r: int) -> Optional[float]:
        return _device_seconds(dev, lambda: calls(r))

    if t(1) is None:
        return None
    r1, r2 = 4, 8
    while t(r2) < 0.5 and r2 < 4096:
        r2 *= 2
    slopes = [(t(r2) - t(r1)) / (r2 - r1) for _ in range(3)]
    return B / float(np.median(slopes))


def _graph_point(label: str, graph: AntitopoEngine, ds, gt_sets, k: int, Q: int, reps: int) -> Point:
    rec = _recall(graph.query_k_batch(ds.queries, k), gt_sets, k)
    # per query, from the recall run (RECORD_STATS parity)
    distcomps = (graph.num_distcomps + graph.num_distcomps_compressed) / ds.m
    qps, best = _qps(graph, ds.dim, k, Q, reps)
    return label, rec, qps, distcomps, best


def _round(x: Optional[float], nd: int) -> Optional[float]:
    return None if x is None else round(x, nd)


def run(n: int, m: int, d: int, k: int, *, qps_queries: int = 65536, reps: int = 5, quick: bool = False,
        cache_dir: str = "./data", device="cuda") -> dict:
    """Run the benchmark at (n, m, d, k) on ``device`` and return bench.py's
    ``out`` dict.  ``quick`` drops the quantized points and runs the graph
    at ef = 4k only (BENCH_QUICK); the dataset is cached under
    ``cache_dir``."""
    device = torch.device(device)
    ds = load_synthetic_uniform_sphere_points(n=n, m=m, k=k, d=d, cache_dir=cache_dir, device=device)
    gt_sets = [set(int(v) for v in row) for row in ds.ground_truth]
    points: List[Point] = []

    def timed_build(eng) -> float:
        eng.store_many_vectors(ds.vecs)
        t0 = time.perf_counter()
        eng.build()
        sync(device)
        return time.perf_counter() - t0

    # --- flat: the flat top-k kernel over a bf16 corpus ---
    flat = BruteForceEngine(mode="fused", device=device)
    flat_build_s = timed_build(flat)
    flat_recall = _recall(flat.query_k_batch(ds.queries, k), gt_sets, k)
    flat_qps, flat_best = _qps(flat, d, k, qps_queries, reps)
    points.append(("gpu_flat", flat_recall, flat_qps, n, flat_best))  # a flat scan scores every row
    flat_dev_qps = flat_device_qps(flat, d, k, qps_queries, reps)

    # --- flat on the i8 wire: the s8 scan, then the exact f32 rerank ---
    if not quick:
        flat8 = BruteForceEngine(mode="fused_i8", query_wire="i8", device=device)
        timed_build(flat8)
        rec8 = _recall(flat8.query_k_batch(ds.queries, k), gt_sets, k)
        qps8, best8 = _qps(flat8, d, k, qps_queries, reps)
        points.append(("gpu_flat_i8", rec8, qps8, n, best8))
        del flat8

    # --- the graph engine: bf16 blocks, then s8 blocks, then the i8 wire ---
    graph = AntitopoEngine(config=graph_config(), device=device)
    graph_build_s = timed_build(graph)
    for mult in QUICK_MULTS if quick else GRAPH_MULTS:
        graph.set_ef_search(k * mult)  # also resets the distcomp counters
        points.append(_graph_point(f"antitopo_ef{k * mult}", graph, ds, gt_sets, k, qps_queries, reps))
    graph_dev_qps = graph_device_qps(graph, d, k)

    graph_dev_qps_i8 = None
    if not quick:
        graph.cfg.use_compression = True
        graph._attach_codes()  # the first query switches the layout to s8 blocks
        for mult in QUANT_MULTS:
            graph.set_ef_search(k * mult)
            points.append(_graph_point(f"antitopo_compressed_ef{k * mult}", graph, ds, gt_sets, k, qps_queries, reps))
        graph_dev_qps_i8 = graph_device_qps(graph, d, k)
        graph.cfg.query_wire = "i8"
        for mult in WIRE_MULTS:
            graph.set_ef_search(k * mult)
            points.append(_graph_point(f"antitopo_wire_i8_ef{k * mult}", graph, ds, gt_sets, k, qps_queries, reps))
        graph.cfg.query_wire = "bf16"

    qualifying = [p for p in points if p[1] >= RECALL_TARGET]
    best = max(qualifying, key=lambda p: p[2]) if qualifying else max(points, key=lambda p: p[1])
    qps_den, build_den, baseline_note = _denominators(load_cpu_baseline(), {"n": n, "m": m, "d": d, "k": k})
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU"

    return {
        "metric": f"synthetic n={n} d={d} best QPS at recall@10>={RECALL_TARGET}",
        "value": round(best[2], 1),
        "unit": "qps",
        "vs_baseline": None if qps_den is None else round(best[2] / qps_den, 3),
        "vs_baseline_est10k": round(best[2] / BASELINE_QPS_EST, 3),
        "best_engine": best[0],
        "recall": round(best[1], 4),
        "time_per_query_ns": round(1e9 / best[2], 0),
        "qps_stat": f"median of {reps} (fresh unique batches of {qps_queries}); qps_best alongside",
        "flat_device_qps": _round(flat_dev_qps, 1),
        "graph_device_qps": _round(graph_dev_qps, 1),
        "graph_device_qps_i8": _round(graph_dev_qps_i8, 1),
        "graph_device_ef": DEVICE_EF,
        "pareto": [
            {
                "engine": nm,
                "recall": round(r, 4),
                "qps": round(q, 1),
                "qps_best": round(qb, 1),
                "distcomps_per_query": round(dc, 1),
            }
            for nm, r, q, dc, qb in points
        ],
        "flat_build_s": round(flat_build_s, 3),
        "graph_build_s": round(graph_build_s, 3),
        "vs_baseline_build": None if build_den is None else round(build_den / graph_build_s, 2),
        "baseline_note": baseline_note,
        "pairing_note": (
            f"on {card}: recall is measured on the {m} canonical queries; QPS on fresh "
            f"unique N(0,1) batches of the same distribution, numpy in and out of "
            f"query_k_batch (host clock: upload, download and host work included); the "
            f"device QPS on queries made on the card, CUDA events, no host work timed"
        ),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("expann_tpu_torch.bench.canonical needs an NVIDIA GPU: torch.cuda.is_available() is False")
    quick = os.environ.get("BENCH_QUICK") == "1"
    n, m, d, k = QUICK if quick else CANONICAL
    print(json.dumps(run(n, m, d, k, qps_queries=16384 if quick else 65536, reps=5, quick=quick)))


if __name__ == "__main__":
    main()
