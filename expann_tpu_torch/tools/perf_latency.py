"""Device latency of one serving call at small batch sizes (counterpart of
tools/perf_latency.py).

Method (the JAX tool's): R serially dependent calls, query i+1 perturbed
by a function of result i on the device (``q = qbase + c * 1e-6``, ``c`` from
the sum of the ids), so no call can start before the one it depends on has
ended; the latency is the slope between two rep counts, r2 grown until
the chain takes 0.5 s, median of 3 slopes.  On the card UNROLL calls are
captured once as a CUDA graph and the chain is its replays, timed by CUDA
events (``replayable``, ``chain_seconds``): the card runs the calls back to
back, as the JAX tool's chain inside one jit ran, and each reading carries
the host's time to enqueue a call beside it (the card's time is its own
while the host's is below it; a host time equal to the card's is the host
waiting on a full launch queue, the card setting the pace).  On the CPU the host clock times the plain
versions: not a device reading.

Engines: ``flat`` (the flat top-k kernel K2 over the bf16 corpus, k=10),
``flat_i8`` (K2-s8 over the int8 codes at k=30, then the exact f32 rerank
against the bf16 corpus, the queries quantized on the device) and
``graph`` (the canonical or million-row index on s8 blocks: 8 entry seeds
by the dense scan, ``graph:entry``; K1-s8 at ef=100, expand 2, cand 16 from
those seeds, plus the f32 rerank, ``graph:trav``; and the whole
``fused_query_batch``, ``graph``).  Scales: ``56k`` (the canonical corpus
and ``tools/perf_e2e_graph.canonical_graph``'s index) and ``1m``
(``generate_synthetic_clustered(1M, 16, 128, seed=1234)`` for the flat
engines; for the graph the index that ``tools/bench_1m.py --data clustered
--M 48 --efc 300`` caches).  Each reading prints ``ctas``: the blocks of
the kernel's grid (K2: one per 64 queries, so one block at B <= 64, on one
of the H100's 132 SMs; K1: one per query).  The JAX tool's salt, a
workaround for its host's result dedup, is not carried, nor its padding of
B to the kernel's query tile (the CUDA kernels take any B)::

    python -m expann_tpu_torch.tools.perf_latency --engine graph --scale 1m
    python -m expann_tpu_torch.tools.perf_latency --engine flat --scale 56k --B 8,64,512
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from expann_tpu_torch.models.brute_force import rerank_exact
from expann_tpu_torch.models.search import entry_beam, fused_query_batch, kernel_query, rerank
from expann_tpu_torch.ops.fused import fused_search
from expann_tpu_torch.ops.topk import flat_topk, flat_topk_prepare, quantize_corpus_i8
from expann_tpu_torch.utils.profiling import card_name

ROOT = Path(__file__).resolve().parents[2]
IDX_1M = str(ROOT / "build" / "bench_1m" / "idx_M48_efc300_clustered.npz")
D, K = 128, 10
EF, SEEDS, EXPAND, CAND = 100, 8, 2, 16
UNROLL = 8  # chained calls captured in one CUDA graph


def chain_step(search, qbase: torch.Tensor):
    """One call of the chain over ``search`` ((B, D) f32 queries -> ids): the
    query is ``qbase + c * 1e-6`` and the call leaves c = (sum of its ids
    mod 1024) * 1e-3 in place, all on the device."""
    c = torch.zeros((), device=qbase.device)

    def step():
        ids = search(qbase + c * 1e-6)
        c.copy_((ids.sum() % 1024).float() * 1e-3)

    return step


def replayable(step, device: torch.device) -> tuple:
    """``(run, calls)``: on the card, UNROLL calls of ``step`` captured once
    as a CUDA graph and ``run`` its replay (one launch for all their
    kernels, so the card runs the chain back to back, as the JAX tool's
    chain inside one jit ran); elsewhere ``step`` itself, one call."""
    if device.type != "cuda":
        return step, 1
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up outside the capture
            for _ in range(2):
                step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(UNROLL):
                step()
    return graph.replay, UNROLL


def chain_seconds(run, reps: int, device: torch.device) -> tuple:
    """``(seconds, host seconds)`` of ``reps`` calls of ``run``: on the card
    by CUDA events around them, beside the host's time to enqueue them (as
    long as the host enqueues faster, the card never waits for it); on the
    CPU both by the host clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        s = time.perf_counter() - t0
        return s, s
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        host = time.perf_counter() - t0
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, host


def slope_seconds(search, qbase: torch.Tensor, device: torch.device, window: float = 0.5, r1: int = 4,
                  r2: int = 24) -> tuple:
    """``(seconds a call, host seconds a call, r2)``: the slope of
    ``chain_seconds`` between r1 and r2 runs (r2 multiplied by 4 until its
    chain takes ``window`` seconds, at most 4096 runs), median of 3, per
    chained call."""
    run, calls = replayable(chain_step(search, qbase), device)
    chain_seconds(run, 1, device)  # warm-up
    while chain_seconds(run, r2, device)[0] < window and r2 < 4096:
        r2 *= 4
    slopes, hosts = [], []
    for _ in range(3):
        (d2, h2), (d1, h1) = chain_seconds(run, r2, device), chain_seconds(run, r1, device)
        slopes.append((d2 - d1) / (r2 - r1) / calls)
        hosts.append((h2 - h1) / (r2 - r1) / calls)
    return float(np.median(slopes)), float(np.median(hosts)), r2


def report(label: str, B: int, ctas: int, search, qbase, device, card: str, window: float) -> dict:
    lat, host, r2 = slope_seconds(search, qbase, device, window)
    row = {"engine": label, "B": B, "us_per_call": lat * 1e6, "us_per_query": lat / B * 1e6, "qps": B / lat,
           "host_us_per_call": host * 1e6, "ctas": ctas, "reps": [4, r2],
           "timer": "cuda events, CUDA graphs" if device.type == "cuda" else "host clock", "card": card}
    print(f"{label:11s} B={B:5d}: {lat * 1e6:9.1f} us/call ({lat / B * 1e6:8.2f} us/query, {B / lat:9.0f} QPS, "
          f"{ctas} CTAs; host enqueue {host * 1e6:.1f} us/call, reps 4->{r2})", flush=True)
    print(json.dumps(row), flush=True)
    return row


def run_flat(x: np.ndarray, Bs, i8: bool, device, card: str, window: float) -> list:
    k = K
    if i8:
        codes, center, scale, _ = quantize_corpus_i8(x, device)
        center_d = torch.from_numpy(center).to(device)
        xr = torch.from_numpy(x).to(device, torch.bfloat16)  # the rerank corpus, 2 B a dimension
        xn = torch.from_numpy((x * x).sum(axis=1)).to(device)
        scan_k = min(3 * k, 128)

        def search(q):
            qk = torch.clamp(torch.round((q - center_d) * scale), -127, 127).to(torch.int8)
            cand, _ = flat_topk(qk, codes, scan_k)
            return rerank_exact(q, xr, xn, cand, k)[0]
    else:
        xdev, _ = flat_topk_prepare(x, device)

        def search(q):
            return flat_topk(q.to(torch.bfloat16), xdev, k)[0]

    rng = np.random.default_rng(3)
    out = []
    for B in Bs:
        qb = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(device)
        out.append(report("flat_i8" if i8 else "flat", B, (B + 63) // 64, search, qb, device, card, window))
    return out


def run_graph(eng, Bs, device, card: str, window: float) -> list:
    eng._resolve_packed()
    g = eng.graph
    EFW = 128  # beam width, EF rounded up to 128 as the engine sizes it
    rng = np.random.default_rng(3)
    out = []
    for B in Bs:
        qb = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(device)
        # seed beams for the traversal chain: the perturbed queries keep
        # them valid seeds (the traversal refines its entries)
        bd0, bi0, _ = entry_beam(g, qb, EFW, SEEDS)

        def entry(q):
            return entry_beam(g, q, EFW, SEEDS)[1]

        def trav(q):
            ids = fused_search(g.packed, g.packed_norms, g.packed_ids, kernel_query(g, q), bd0, bi0, ef=EF,
                               expand=EXPAND, cand=CAND)[0]
            return rerank(g, q, ids, K)[0]

        def whole(q):
            return fused_query_batch(g, q, ef=EF, k=K, ef_cap=EFW, expand=EXPAND, cand=CAND, seeds=SEEDS)[0]

        for label, fn in (("graph:entry", entry), ("graph:trav", trav), ("graph", whole)):
            out.append(report(label, B, B, fn, qb, device, card, window))
    return out


def main(argv=None, device="cuda") -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("flat", "flat_i8", "graph"), required=True)
    ap.add_argument("--scale", choices=("56k", "1m"), default="56k")
    ap.add_argument("--B", default="8,64,512")
    ap.add_argument("--n", type=int, default=0, help="rows instead of the scale's (a small rehearsal)")
    ap.add_argument("--index", default="", help="graph index file instead of the scale's")
    ap.add_argument("--window", type=float, default=0.5, help="seconds the longer chain must take")
    args = ap.parse_args(argv)
    from expann_tpu_torch.tools.perf_e2e_graph import canonical_data, canonical_graph
    from expann_tpu_torch.tools.perf_trace import IDX

    device = torch.device(device)
    card = card_name() if device.type == "cuda" else "cpu"
    Bs = [int(v) for v in args.B.split(",")]
    n = args.n or (56000 if args.scale == "56k" else 1_000_000)
    print(f"engine={args.engine} scale={args.scale} n={n} device={device}", flush=True)
    if args.engine == "graph":
        index = args.index or (IDX if args.scale == "56k" else IDX_1M)
        if args.scale == "1m" and not Path(index).exists():
            raise SystemExit(f"{index} missing: build it with python -m expann_tpu_torch.tools.bench_1m "
                             "--data clustered --M 48 --efc 300 --build-only")
        t0 = time.perf_counter()
        eng = canonical_graph(index, n, device, packed_dtype="i8", ef_search=EF, use_packed=True, use_fused=True)
        print(f"graph load+pack: {time.perf_counter() - t0:.1f}s", flush=True)
        return run_graph(eng, Bs, device, card, args.window)
    if args.scale == "56k":
        x = canonical_data(n, device).vecs
    else:
        from expann_tpu_torch.data.loader import generate_synthetic_clustered

        x, _ = generate_synthetic_clustered(n, 16, D, seed=1234)
    return run_flat(x, Bs, args.engine == "flat_i8", device, card, args.window)


if __name__ == "__main__":
    main()
