#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one NVIDIA GPU.

Phases, one line each:
  1. device     the card, as torch and nvidia-smi name it;
  2. build      nvcc builds the kernels of expann_tpu_torch/csrc for sm_90a
                (registers and spills from ptxas, shared memory per launch);
  3. flat_topk  the flat top-k kernel against its plain version, random bf16
                corpus n=56000, d=128, 4096 queries, k=10;
  4. canonical  config_synthetic.json (n=56000, d=128, 400 queries, k=10):
                the flat engine (mode="fused") and the graph engine with
                bench.py's graph config, built on the card and served at
                ef 40 / 100 / 120, recall@10 against the exact oracle;
  5. fused      the traversal kernel against its plain version on that graph
                at ef=120, from the same seeded beams;
  6. launches   kernel launches counted during phase 4 (both must be > 0);
  7. times      graph and flat QPS on 65536 fresh queries (host clock around
                finished calls) and kernel vs plain times (CUDA events) at
                the main path's shapes.
Then the kernel summary as JSON, the card's name and power limit as
nvidia-smi prints them, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

A failed check raises: the script exits non-zero without that last line,
as it does where no CUDA device is present.  Run from anywhere:
    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

N, M_QUERIES, D, K = 56000, 400, 128, 10  # config_synthetic.json
# bench.py's graph config, without its TPU-only knobs (packed_topt, fused_qt)
GRAPH_CFG = dict(
    M=60, ef_construction=500, ortho_count=1, prune_overflow=1, prune_cand=500,
    query_expand=2, fused_cand=8, query_block=16384, entry_seeds=8, precision="default",
)
EFS = (40, 100, 120)
QPS_QUERIES = 65536
FLAT_B = 4096  # phase 3 batch
FLAT_CHUNK = 16384  # queries per flat_topk call on the flat engine's path
# |d_kernel - d_plain| allowed: both sum 128 f32 products of magnitude <= ~|q||x|
# in another order; |d| ~ 256 here, so a few hundred ulps of 256 plus a margin
D_ATOL, D_RTOL = 2e-3, 1e-5


def phase(name: str, **vals) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in vals.items()), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def recall(ids: np.ndarray, gt: np.ndarray) -> float:
    k = gt.shape[1]
    return float(np.mean([len(set(a[:k].tolist()) & set(b.tolist())) / k for a, b in zip(ids, gt)]))


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_summary(report: str) -> dict:
    """Registers and spill bytes per kernel from the ptxas report."""
    out, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)' for '(\w+)'", line)
        if m:
            current = next((k for k in ("flat_topk_kernel", "fused_search_kernel") if k in m.group(1)), None)
            if current:
                out[current] = {"arch": m.group(2)}
        elif current and "registers" in line:
            out[current]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
        elif current and "spill stores" in line:
            out[current]["spill_bytes"] = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from expann_tpu_torch import AntitopoConfig, AntitopoEngine, BruteForceEngine
    from expann_tpu_torch.data.loader import load_synthetic_uniform_sphere_points
    from expann_tpu_torch.models.search import entry_beam, rerank
    from expann_tpu_torch.ops import _kernels
    from expann_tpu_torch.ops.fused import fused_search_cuda, fused_search_plain, topt_for
    from expann_tpu_torch.ops.topk import flat_topk_cuda, flat_topk_plain

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"'{smi}'"
    phase("device", kind=repr(kind), count=count, torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=card)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _kernels.library()
    build_s = time.perf_counter() - t0
    ptx = ptxas_summary(_kernels.build_report())
    check(set(ptx) == {"flat_topk_kernel", "fused_search_kernel"}, f"ptxas report lists {sorted(ptx)}")
    check(all(v["arch"] == "sm_90a" for v in ptx.values()), f"not built for sm_90a: {ptx}")
    topt = topt_for(GRAPH_CFG["fused_cand"], GRAPH_CFG["query_expand"], 128)
    smem = {
        "flat_topk_kernel": lib.expann_flat_topk_smem_bytes(D, K),
        "fused_search_kernel": lib.expann_fused_search_smem_bytes(D, 128, 128, GRAPH_CFG["query_expand"], topt),
    }
    for kname, info in ptx.items():
        phase("build", kernel=kname, arch=info["arch"], registers=info["registers"],
              spill_bytes=info["spill_bytes"], dynamic_smem_bytes=smem[kname])
    phase("build", seconds=f"{build_s:.3f}", source=os.path.join("expann_tpu_torch", "csrc"))

    # ---- 3. flat_topk against its plain version ---------------------------
    rng = np.random.default_rng(0)
    xr = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).to(dev, torch.bfloat16)
    qr = torch.from_numpy(rng.standard_normal((FLAT_B, D)).astype(np.float32)).to(dev)
    ids, dk = flat_topk_cuda(qr, xr, K)
    pids, pd = flat_topk_plain(qr, xr, K)
    torch.cuda.synchronize()
    flat_err = float((dk - pd).abs().max())
    check(bool(torch.isfinite(dk).all()), "flat_topk: non-finite distances")
    check(bool(torch.allclose(dk, pd, rtol=D_RTOL, atol=D_ATOL)), f"flat_topk distances differ by {flat_err}")
    # an id may differ from the plain one only where the two tie within tolerance
    qb, xb = qr.to(torch.bfloat16).float(), xr.float()
    exact_of_kernel_ids = ((qb[:, None, :] - xb[ids.long()]) ** 2).sum(-1)
    mism = ids != pids
    tie_err = float((exact_of_kernel_ids - pd).abs()[mism].max()) if bool(mism.any()) else 0.0
    check(tie_err <= 1e-2, f"flat_topk: a differing id is not a tie ({tie_err})")
    phase("flat_topk", n=N, B=FLAT_B, k=K, max_abs_err=f"{flat_err:.3e}",
          differing_ids=int(mism.sum()), worst_tie_gap=f"{tie_err:.3e}")
    del xr, qr, qb, xb, exact_of_kernel_ids

    # ---- 4. the canonical config: the main path ---------------------------
    with tempfile.TemporaryDirectory() as cache:
        ds = load_synthetic_uniform_sphere_points(N, M_QUERIES, K, D, cache_dir=cache, device=dev)
    # the oracle itself, against float64 numpy on a slice
    d64 = ((ds.queries[:50, None, :].astype(np.float64) - ds.vecs[None].astype(np.float64)) ** 2).sum(-1)
    check(recall(ds.ground_truth[:50], np.argsort(d64, 1)[:, :K]) >= 0.999, "exact oracle disagrees with float64")
    _kernels.launches.clear()

    flat = BruteForceEngine(mode="fused", device=dev)
    flat.store_many_vectors(ds.vecs)
    flat.build()
    flat_ids = flat.query_k_batch(ds.queries, K)
    flat_recall = recall(flat_ids, ds.ground_truth)
    phase("canonical", engine="flat", mode="fused", recall_at_10=f"{flat_recall:.4f}")

    graph = AntitopoEngine(config=AntitopoConfig(**GRAPH_CFG), device=dev)
    graph.store_many_vectors(ds.vecs)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph.build()
    graph_build_s = time.perf_counter() - t0
    build_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    g = graph.graph
    adj = g.adj_bottom[:N]
    check(not bool((adj == torch.arange(N, device=dev)[:, None]).any()), "graph has self edges")
    phase("canonical", engine="graph", build_seconds=f"{graph_build_s:.2f}", layers=len(g.layers),
          degree_mean=f"{float((adj < N).sum(1).float().mean()):.2f}", build_peak_gib=f"{build_peak_gb:.2f}")
    graph_recall = {}
    for ef in EFS:
        graph.set_ef_search(ef)
        gids = graph.query_k_batch(ds.queries, K)
        check(gids.shape == (M_QUERIES, K) and all(len(set(r.tolist())) == K for r in gids),
              f"graph results at ef={ef} have wrong shape or duplicates")
        graph_recall[ef] = recall(gids, ds.ground_truth)
        phase("canonical", engine="graph", ef=ef, recall_at_10=f"{graph_recall[ef]:.4f}",
              distcomps_per_query=f"{graph.num_distcomps / M_QUERIES:.1f}")
    launches = dict(_kernels.launches)
    check(flat_recall >= 0.99, f"flat recall@10 {flat_recall} < 0.99")
    check(graph_recall[120] >= 0.95, f"graph recall@10 at ef=120 {graph_recall[120]} < 0.95")

    # ---- 5. the traversal kernel against its plain version ----------------
    qg = torch.from_numpy(ds.queries).to(torch.bfloat16).to(dev).float()
    EF, ef = 128, 120
    topt = topt_for(GRAPH_CFG["fused_cand"], GRAPH_CFG["query_expand"], g.packed.shape[1])
    args = (g.packed, g.packed_norms, g.packed_ids)
    bd0, bi0, _ = entry_beam(g, qg, EF, GRAPH_CFG["entry_seeds"])
    ki, kd, kn, _ = fused_search_cuda(*args, qg, bd0, bi0, ef, GRAPH_CFG["query_expand"], topt, 8 * ef + 16)
    pi_, pd_, pn, _ = fused_search_plain(*args, qg, bd0, bi0, ef, GRAPH_CFG["query_expand"], topt, 8 * ef + 16)
    torch.cuda.synchronize()
    same = (ki == pi_) & (ki < N)
    fused_err = float((kd - pd_).abs()[same].max())
    k_top, _ = rerank(g, qg, ki, K)
    p_top, _ = rerank(g, qg, pi_, K)
    k_top, p_top = k_top.cpu().numpy(), p_top.cpu().numpy()
    overlap = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K for a, b in zip(k_top, p_top)]))
    r_diff = recall(k_top, ds.ground_truth) - recall(p_top, ds.ground_truth)
    nk, npl = int(kn.sum()), int(pn.sum())
    phase("fused", ef=ef, top10_overlap=f"{overlap:.4f}", recall_diff=f"{r_diff:+.4f}",
          distcomps_kernel=nk, distcomps_plain=npl, max_abs_err=f"{fused_err:.3e}")
    check(overlap >= 0.99, f"fused_search: top-10 overlap with the plain version {overlap} < 0.99")
    check(abs(r_diff) <= 0.005, f"fused_search: recall differs from the plain version by {r_diff}")
    check(abs(nk - npl) <= 0.01 * npl, f"fused_search: distcomps {nk} vs plain {npl}")
    check(bool(torch.allclose(kd[same], pd_[same], rtol=D_RTOL, atol=D_ATOL)),
          f"fused_search: beam distances differ by {fused_err}")

    # ---- 6. launches on the main path -------------------------------------
    phase("launches", **launches)
    check(launches.get("flat_topk", 0) > 0 and launches.get("fused_search", 0) > 0,
          f"a kernel of the main path was never launched: {launches}")

    # ---- 7. times ---------------------------------------------------------
    rng = np.random.default_rng(1)
    qps = {}
    for label, eng, ef_q in (("graph_ef100", graph, 100), ("graph_ef120", graph, 120), ("flat", flat, None)):
        if ef_q is not None:
            eng.set_ef_search(ef_q)
        eng.query_k_batch(rng.standard_normal((1024, D)).astype(np.float32), K)  # warm-up
        runs = []
        for _ in range(2):
            batch = rng.standard_normal((QPS_QUERIES, D)).astype(np.float32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.query_k_batch(batch, K)  # returns host arrays: the device work is done
            runs.append(QPS_QUERIES / (time.perf_counter() - t0))
        qps[label] = runs
        phase("times", path=label, queries=QPS_QUERIES, qps=",".join(f"{v:.0f}" for v in runs), card=card)

    qf = torch.from_numpy(rng.standard_normal((FLAT_CHUNK, D)).astype(np.float32)).to(dev, torch.bfloat16)
    flat_ms = cuda_ms(torch, lambda: flat_topk_cuda(qf, flat._x_fused, K), reps=5)
    flat_plain_ms = cuda_ms(torch, lambda: flat_topk_plain(qf, flat._x_fused, K), reps=2)
    flat_tflops = 2.0 * FLAT_CHUNK * N * D / (flat_ms * 1e-3) / 1e12
    phase("times", kernel="flat_topk", B=FLAT_CHUNK, n=N, k=K, ms=f"{flat_ms:.3f}",
          plain_ms=f"{flat_plain_ms:.3f}", achieved_tflops=f"{flat_tflops:.1f}", card=card)
    qt = torch.from_numpy(rng.standard_normal((GRAPH_CFG["query_block"], D)).astype(np.float32))
    qt = qt.to(torch.bfloat16).to(dev).float()
    bd0, bi0, _ = entry_beam(g, qt, EF, GRAPH_CFG["entry_seeds"])
    fargs = (*args, qt, bd0, bi0, ef, GRAPH_CFG["query_expand"], topt, 8 * ef + 16)
    fused_ms = cuda_ms(torch, lambda: fused_search_cuda(*fargs), reps=5)
    fused_plain_ms = cuda_ms(torch, lambda: fused_search_plain(*fargs), reps=1)
    # bytes the traversal must read: per expansion one RS x D bf16 block plus
    # RS norms and RS ids (ncomp counts RS per expansion)
    rs = g.packed.shape[1]
    expansions = int(fused_search_cuda(*fargs)[2].sum()) / rs
    fused_tbps = expansions * rs * (2 * D + 8) / (fused_ms * 1e-3) / 1e12
    phase("times", kernel="fused_search", B=GRAPH_CFG["query_block"], ef=ef, EF=EF, ms=f"{fused_ms:.3f}",
          plain_ms=f"{fused_plain_ms:.3f}", expansions_per_query=f"{expansions / GRAPH_CFG['query_block']:.1f}",
          achieved_tb_per_s=f"{fused_tbps:.2f}", card=card)

    kernels = [
        {
            "name": "fused_search", "route": "cuda",
            "source": "expann_tpu_torch/csrc/fused_search.cu",
            "replaces": "expann_tpu/ops/pallas_fused.py:69",
            "launches": launches["fused_search"], "max_abs_err": fused_err,
            "ms": fused_ms, "plain_ms": fused_plain_ms,
        },
        {
            "name": "flat_topk", "route": "cuda",
            "source": "expann_tpu_torch/csrc/flat_topk.cu",
            "replaces": "expann_tpu/ops/pallas_topk.py:147",
            "launches": launches["flat_topk"], "max_abs_err": flat_err,
            "ms": flat_ms, "plain_ms": flat_plain_ms,
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
