#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's paths once on one NVIDIA GPU.

Phases, one line each, stamped with the host seconds since the script started:
  1. device        the card, as torch and nvidia-smi name it;
  2. build         nvcc builds the kernels of expann_tpu_torch/csrc for sm_90a
                   (registers, spills and static shared memory from ptxas,
                   the most of any template instance, dynamic shared memory
                   per launch, and the traversal kernels' resident queries
                   per SM at the canonical widths; no flat top-k kernel, K2,
                   K2-s8, K3 or K3-s8, not the block scorer K4, not the
                   traversal kernels K1 and K1-s8 and not the probes P1 and
                   P3 may spill);
  3. flat_topk     the count-mode flat top-k kernel (K2) against its plain
                   version, random bf16 corpus n=56000, d=128, 4096 queries,
                   k=10; flat_fixed: the fixed-pass kernel (K3) the same way
                   at k=10 and k=100; flat_topk_s8: K2-s8 and K3-s8 on random
                   s8 codes of the same shape at k=30 and k=100, ids and
                   distances identical to the plain version;
  4. canonical     config_synthetic.json (n=56000, d=128, 400 queries, k=10):
                   the flat engine (mode="fused") and the graph engine with
                   bench.py's graph config, built on the card and served at
                   ef 40 / 100 / 120 in 400-query calls (the fused route),
                   recall@10 against the exact oracle; then the flat engine
                   with topk_mode="fixed" (K3's path), whose ids must equal
                   count mode's;
  5. fused         the traversal kernel (K1) against its plain version on that
                   graph at ef=120, from the same seeded beams;
  6. packed_score  the block scorer (K4) against its plain version on that
                   graph: the 400 queries, E=2 seeded selections of real nodes
                   and sentinels, topt 0 and 8; then negative partial
                   distances (each query 3x a row of its first node) and
                   all-tie blocks (4096 copies of one integer row, integer
                   queries: distances and ids identical);
  7. small_batch   the per-iteration route at ef=120: the 400 queries one per
                   call (as query_k calls) and in 32-query calls, identical
                   ids, recall@10;
  8. times         graph and flat QPS on 65536 fresh queries, per-call latency
                   at B = 1, 8, 32 on both graph routes (host clock, numpy in
                   and out), and kernel / plain / library-chain times (CUDA
                   events, utils/profiling.event_ms) at the paths' shapes,
                   beside each kernel's bound (K1's bound counts every input
                   byte once, tools/perf_fused_search.traversal_bound: the
                   distinct blocks the call expands, as the plain version
                   records them, with its gathered rate, a block an
                   expansion, beside it); K1-rows (`fused_rows`) held
                   to its plain version at the wide index's shape (2**20
                   integer-valued rows of 1024 dims, 96 neighbours, 8192
                   queries at ef=80: ids, distances, rows and iterations
                   identical, 7 launches counted) and timed against the
                   rows it read at 3.35 TB/s; K2 and K3
                   are first held to
                   their plain version on the timed inputs (16384 queries
                   on the flat engine's corpus) with phase 3's limits, and
                   each flat kernel's time is printed as a factor of the
                   library chain's (vs_library > 1: the kernel is faster);
                   K4 likewise on the inputs it times at B = 1, 32, 16384,
                   with phase 6's limits;
  9. canonical_quantized  quantized serving on the canonical config: the flat
                   engine mode="fused_i8" on both query wires and in both
                   top-k modes, then bench.py's flow on the graph engine built
                   in phase 4 (use_compression=True, _attach_codes()): s8
                   packed blocks at ef 100 / 110 / 120 and the i8 query wire
                   at ef 110 / 120, recall@10 and distance counts;
 10. fused_s8      the s8 traversal kernel (K1-s8) against its plain version
                   on that graph at ef=120, from the same code-space seeds;
 11. small_batch_compressed  the per-iteration route of the compressed engine
                   (the uint8 gather beam, no kernel): 400 one-query calls and
                   32-query calls, identical ids;
 12. times (quantized)  QPS of the quantized paths, and K1-s8, K2-s8, K3-s8
                   beside their plain versions, bounds and library chain;
                   K2-s8 and K3-s8 are first held to their plain version on
                   the timed inputs (16384 queries on fused_i8's codes,
                   k=30), identical ids and distances, each time beside the
                   library chain's as a factor;
 13. launches      kernel launches counted on each path: the counts are set to
                   0 just before a path and read just after;
 14. probe_fused   P1 (expann_tpu_torch/tools/probe_fused.py) against its
                   plain version: the bulk copy by an in-kernel index and the
                   data-dependent loop, identical, at the tool's inputs and
                   at the card tests' cases (8 seeds, ties in row 0, the
                   minimum in column 127, the table's last entry, loop caps
                   0 and 1); its time beside one indexing call's copy of the
                   same entry (tab[entry]);
 15. probe_gather  P2 against its plain version on all 33001 rows at every
                   ring of the sweep (R 16-128 x NBUF 2, 4, 8) on its 2 GiB
                   tables, the refusal of the R=128, NBUF=8 ring, and the
                   time at R=128, NBUF=4;
 16. probe_step    K1 on P3's companion layout against its plain version at
                   both iteration caps (1024 queries); P3 against its plain
                   version at every feature at B = 8, 1000 and 8192 (the
                   tool's cluster size: padded clusters at 8 and 1000), and
                   its time with the cluster size, the L2 bytes a call reads
                   and the clusters the card holds at once;
 17. probe_lanes   P4 against its plain version at every mode, identical
                   (the prefix sum within 1e-5), and the modes that reduce
                   identical on the edge rows (ties, -0 beside +0, +inf);
     then the probes path, counts reset just before it: the tools' sweeps
     (P1 once; P2's block-gather GB/s by R x NBUF and the library chain's;
     P3's µs per step by feature, `dma` at every cluster size, the fixed
     cost of a step alone on an SM (B=8, cluster 1, with and without
     `dma`), and K1's ms at 24 and 96 iterations with its slope; P4's ns
     per step by mode from ITERS 256 and 512), with the
     probe kernels' times beside their plain versions and bounds;
 18. trace         tools/perf_trace's profile of one warm call on each serving
                   engine, each in a fresh process of perf_trace on the
                   canonical corpus: 8192 queries on the graph engine on s8
                   blocks (built in that process) at ef=100; 16384 on the flat
                   engine (mode="fused", K2) and on fused_i8 with the i8 wire
                   (K2-s8): wall ms, the call's span, device µs of kernels and
                   copies, the device's idle share (negative fails: the
                   records would overrun the span), the top kernels by device
                   time, the process's seconds by step (corpus, build, the
                   traced call with its warm-up; start-up and exit the rest);
                   and the host's own steps of a flat chunk (bf16 cast, i8
                   quantization);
 19. bench         expann_tpu_torch.bench.canonical.run at the canonical size,
                   in this process (the counterpart of bench.py): its JSON line,
                   bench.py's keys, all 11 points, recall@10 at PERF.md's limits
                   (flat 0.99, fused_i8 0.97, the graph at ef=120 0.95 on bf16
                   and s8 blocks and on the i8 wire), ``value`` from the points,
                   and K1, K1-s8, K2, K2-s8 launched;
 20. cli           python -m expann_tpu_torch.cli --config config_synthetic.json
                   in a scratch directory: the 24-job sweep, 24 records with
                   each job's recall and QPS, K1 on the 12 uncompressed jobs and
                   K1-s8 on the 12 compressed ones (two 400-query calls a job),
                   every job's recall within 0.01 of the JAX package's tracked
                   record of it (read only); fresh engines over a sweep index
                   file, bf16 and s8 blocks, answering as the reused jobs did,
                   and K1 and K1-s8 against their plain versions there at the
                   grid's own arguments (query_expand=1, no entry seeds, ef 10
                   and 60);
 21. ortho         the canonical config with ortho_count=2 built through
                   AntitopoEngine on the card: build seconds, layers, the rows
                   it shares with phase 4's graph (all of them at the default
                   ortho_bias=0: no penalty is negative, so the union is the
                   plain list), recall@10 at ef 100 / 120 through K1 beside the
                   ortho_count=1 graph's (>= 0.95 at ef=120), K1 launched and
                   K4 not; then ortho_bias=-1, ortho_count 1 and 2, whose rows
                   must differ on at least 10% of the nodes;
 22. million       the million-row path: generate_synthetic_clustered(MILLION_N,
                   400, 128, seed=0), exact ground truth on the card,
                   build_index on its auto route (the one-device distributed
                   builder, K2 as the candidate scan) at M=48, efc = prune_cand
                   = 300: build seconds per stage, peak memory, exactly waves x
                   segments K2 launches, the graph's invariants, K2 held to its
                   plain version on the first wave's first segment (4096 x
                   333,824, k=128) and timed there beside its bound and the
                   library chain; then s8 blocks at ef 40 / 80 / 120 (expand 2,
                   cand 8; recall@10 >= 0.98 at ef=80) and the flat engines
                   (fused >= 0.99, fused_i8 >= 0.97), with host-clock QPS;
                   after the counts are read, K1-s8 on the million-row s8
                   layout (ef 80), K2 over the 1M rows (k=10) and K2-s8 over
                   the 1M codes (k=30), each held to its plain version;
 23. wave          the wave builders through AntitopoEngine on the canonical
                   corpus (counts reset just before): builder="wave" (stage
                   seconds, waves, beam iterations, peak memory, invariants,
                   no kernel in the build; recall@10 at ef 100 / 120 through
                   K1 beside phase 4's, >= 0.90 at ef=120; 32-query calls
                   through K4 equal to one-query calls; s8 blocks through
                   K1-s8, >= 0.90); store -> build -> store -> build of
                   28000 + 28000 rows (invariants, both halves answered,
                   >= 0.90); refine_index_wave(frac=0.5) (invariants, recall
                   no more than 0.01 below); wave builds of the first 16384
                   rows at ortho_count 1 and 2, ortho_bias 0 and -1 (the
                   rows the counts share, recall); then K1, K4 and K1-s8 on
                   the wave graph's layouts held to their plain versions;
 24. sharded       the multi-device layer (expann_tpu_torch/parallel/) on
                   SHARDS shards over the visible cards, round-robin (one
                   card: all of them on it), counts reset just before each
                   step: tools/dryrun_multichip; build_sharded of the
                   canonical corpus; sharded_packed_query at ef 100 / 120
                   (exactly S K1 launches a call, recall@10 >= 0.95 at
                   ef=120 beside phase 4's, shard 0's K1 call held to its
                   plain version, QPS); sharded_flat_query (exactly S K2
                   launches, ids equal to one K2 call over the whole corpus
                   but on ties, QPS); replicated_fused_query_dp on phase 4's
                   graph (ids identical to one fused_query_batch call, QPS
                   beside it); sharded_build_step on a wave of 4096 rows
                   against the one-shard call (>= 99% of rows identical);
                   build_distributed over the shards, dense on the canonical
                   corpus against one device (>= 95% of rows identical,
                   recall within 0.01), then flat on 262144 clustered rows
                   (exactly waves x S x segments K2 launches, s8 recall@10
                   at ef=80 >= 0.98);
 25. bigflat       tools/bench_bigflat's flat route at BIGFLAT_N = 2^24 + 2^20
                   rows (its corpus and 100 held-out queries; exact f32 ground
                   truth by the plain version on the card in column blocks): the
                   100 queries inside one fused engine call of 8448 (one K2
                   launch, recall@10 >= 0.99, ids >= 2^24 present); K2 held to
                   its plain version on them and K2-s8 on s8 codes of the same
                   n (k=30, identical); K2's ms per 16384-query call beside its
                   bound and the library chain, the 100-query call's seconds,
                   host-clock QPS;
 26. sift_like     tools/make_sift_like at n=65536, m=1000, k=100 under build/:
                   read_vecs through the native reader (utils/io_native.py),
                   byte-equal to the numpy reader; load_sift1m into a flat
                   fused engine, recall@10 >= 0.99 against the file's truth.
Then the script's run time, the kernel summary as JSON, the card's name
and power limit as nvidia-smi prints them, and as the last line
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
EFS = (40, 100, 120)
QPS_QUERIES = 65536
FLAT_B = 4096  # phase 3 batch
FLAT_CHUNK = 16384  # queries per flat_topk call on the flat engine's path
SMALL_CHUNK = 32  # queries per call in the small-batch phase
LATENCY_B = (1, 8, 32)
LATENCY_CALLS = 50
K4_B = (1, 32, 16384)
# |d_kernel - d_plain| allowed: both sum 128 f32 products of magnitude <= ~|q||x|
# in another order; |d| ~ 256 here, so a few hundred ulps of 256 plus a margin
D_ATOL, D_RTOL = 2e-3, 1e-5
# the card's peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s, and the
# tensor-core operations/s of each operand type
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}  # f32: outside the tensor cores
QUANT_EFS = (100, 110, 120)  # bench.py:306 (s8 blocks)
WIRE_EFS = (110, 120)  # bench.py:329 (i8 query wire)
FLAT_S8_KS = (30, 100)  # 30: fused_i8's scan at k=10 (rerank_mult=3)
MILLION_N = 1_000_000  # phase 22's corpus (tools/bench_1m.py --data clustered)
WAVE_ORTHO_N = 16384  # phase 23 (d): rows of the ortho-pass builds
SHARDS = 4  # phase 24: shards over the visible cards, round-robin
SHARD_WAVE = 4096  # phase 24 (f): the sharded build step's wave
SHARD_FLAT_N = 262144  # phase 24 (g): rows of the distributed flat build
# phase 25: tools/bench_bigflat.py's 20M rows cut to 2^24 + 2^20 to fit this
# script's time; ids >= 2^24 are still ~6% of the rows
BIGFLAT_N = (1 << 24) + (1 << 20)
BIGFLAT_B = 132 * 64  # one call of K2 blocks for every SM of an H100 (64 queries a block)
BIGFLAT_Q = 100  # the tool's held-out queries (numpy seed 1)
SIFT_LIKE = (65536, 1000, 100)  # phase 26: n, m, k of tools/make_sift_like.py, cut from 1M / 10k


def graph_cfg():
    """bench.py's graph config as the canonical bench builds it
    (bench/canonical.graph_config), with both routes left to "auto": on the
    card 400-query calls take the fused route and small batches the
    per-iteration route."""
    import dataclasses

    from expann_tpu_torch.bench.canonical import graph_config

    return dataclasses.replace(graph_config(), use_packed="auto", use_fused="auto")


T0 = time.perf_counter()


def phase(name: str, **vals) -> None:
    """One line, stamped with the host seconds since the script started."""
    print(f"{time.perf_counter() - T0:9.3f} [{name}] " + " ".join(f"{k}={v}" for k, v in vals.items()), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def recall(ids: np.ndarray, gt: np.ndarray) -> float:
    k = gt.shape[1]
    return float(np.mean([len(set(a[:k].tolist()) & set(b.tolist())) / k for a, b in zip(ids, gt)]))


def bound(nbytes: float, ops: float, dtype: str = "bf16") -> tuple:
    """The least time the card could take, in ms, and what sets it: the
    bytes over HBM bandwidth or the operations over the tensor peak of the
    operands' type (bf16 or int8 tensor rates, or f32 outside them)."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


KERNEL_NAMES = (
    "flat_topk_fixed_kernel", "flat_topk_fixed_s8_kernel", "flat_topk_kernel", "flat_topk_s8_kernel",
    "fused_search_kernel", "fused_search_s8_kernel", "fused_search_rows_kernel", "packed_score_kernel",
    "probe_fused_kernel", "block_gather_kernel", "step_overhead_kernel", "probe_lanes_kernel",
)
# P2's comparison: steps, odd, at least 4 rings of NBUF=8 on each block of
# the grid (at most 8 blocks of 256 threads per SM, 132 SMs)
PROBE_G = 33001


def ptxas_summary(report: str) -> dict:
    """Registers, spill bytes and static shared memory per kernel from the
    ptxas report; a kernel built in several template instances (K3 and
    K3-s8: one per list size; P3: one per feature set) reports its count of
    instances and the most of each of any."""
    out, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)' for '(\w+)'", line)
        if m:
            current = next((k for k in KERNEL_NAMES if re.search(rf"\d{k}", m.group(1))), None)
            if current:
                info = out.setdefault(current, {"arch": m.group(2), "instances": 0, "registers": 0, "spill_bytes": 0,
                                                "static_smem_bytes": 0})
                info["instances"] += 1
        elif current and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out[current]["registers"] = max(out[current]["registers"], regs)
            smem = re.search(r"(\d+) bytes smem", line)
            if smem:
                out[current]["static_smem_bytes"] = max(out[current]["static_smem_bytes"], int(smem.group(1)))
        elif current and "spill stores" in line:
            spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
            out[current]["spill_bytes"] = max(out[current]["spill_bytes"], spills)
    return out


def latency_ms(eng, queries: np.ndarray, B: int, calls: int) -> np.ndarray:
    """Host-clock milliseconds of ``calls`` query_k_batch calls of B rows
    (numpy in, numpy out: the device work is done when a call returns),
    after 5 warm-up calls."""
    out = []
    for i in range(calls + 5):
        s = (i * B) % (queries.shape[0] - B + 1)
        t0 = time.perf_counter()
        eng.query_k_batch(queries[s : s + B], K)
        if i >= 5:
            out.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(out)


def profile_call(torch, kernels, eng, queries: np.ndarray) -> dict:
    """One warm query_k_batch call under torch.profiler: wall ms (with the
    profiler's own cost), device busy ms (kernels and copies), kernels
    launched, host syncs (``aten::_local_scalar_dense``: ``done.all()`` and
    the descent's ``any()``) with their host ms, and the per-iteration
    route's iterations (one K4 launch each)."""
    from torch.profiler import ProfilerActivity, profile

    eng.query_k_batch(queries, K)
    torch.cuda.synchronize()
    k4 = kernels.launches["packed_score"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.query_k_batch(queries, K)
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    on_device = [e for e in events if str(e.device_type).endswith("CUDA")]
    syncs = [e for e in events if e.name == "aten::_local_scalar_dense"]
    busy = sum(e.time_range.elapsed_us() for e in on_device) / 1e3
    return dict(wall_ms=f"{wall:.3f}", device_busy_ms=f"{busy:.3f}", idle_share=f"{1 - busy / wall:.3f}",
                device_ops=len(on_device), host_syncs=len(syncs),
                sync_ms=f"{sum(e.time_range.elapsed_us() for e in syncs) / 1e3:.3f}",
                iterations=kernels.launches["packed_score"] - k4)


def rows_unique(ids: np.ndarray) -> bool:
    return all(len(set(r.tolist())) == ids.shape[1] for r in ids)


def hold_flat_bf16(torch, label: str, fn, q, x, k: int) -> float:
    """A bf16 flat top-k kernel ``fn`` against flat_topk_plain on (q, x) at
    k: finite distances within D_ATOL / D_RTOL, and an id may differ from
    the plain one only where the two tie (the exact distance of the
    kernel's id within 1e-2 of the plain distance at that rank).  Prints one
    line; returns the largest |d_kernel - d_plain|."""
    from expann_tpu_torch.ops.topk import flat_topk_plain

    ids, dk = fn(q, x, k)
    pids, pd = flat_topk_plain(q, x, k)
    torch.cuda.synchronize()
    err = float((dk - pd).abs().max())
    check(bool(torch.isfinite(dk).all()), f"{label}: non-finite distances")
    check(bool(torch.allclose(dk, pd, rtol=D_RTOL, atol=D_ATOL)), f"{label} k={k}: distances differ by {err}")
    qb = q.to(torch.bfloat16).float()
    exact_of_kernel_ids = ((qb[:, None, :] - x[ids.long()].float()) ** 2).sum(-1)
    mism = ids != pids
    tie_err = float((exact_of_kernel_ids - pd).abs()[mism].max()) if bool(mism.any()) else 0.0
    check(tie_err <= 1e-2, f"{label} k={k}: a differing id is not a tie ({tie_err})")
    phase(label, n=x.shape[0], B=q.shape[0], k=k, max_abs_err=f"{err:.3e}",
          differing_ids=int(mism.sum()), worst_tie_gap=f"{tie_err:.3e}")
    return err


def hold_packed(torch, label: str, args, sel, q, t: int, exact: bool = False, min_negative: int = 0) -> float:
    """K4 against its plain version on one input: the same +inf pattern,
    distances within D_RTOL / D_ATOL (identical with ``exact``), ids
    identical at topt=0 and with ``exact``, else differing only on a tie
    (each kernel id's distance, looked up in its node's full row, is the
    one the kernel reports); with topt > 0, every pass past a node's finite
    slots gives the node's lane-0 id.  Returns the largest |d_kernel - d_plain|."""
    from expann_tpu_torch.ops.packed import packed_score_cuda, packed_score_plain

    B, E = sel.shape
    kd, ki = packed_score_cuda(*args, sel, q, t)
    pd, pi = packed_score_plain(*args, sel, q, t)
    full_d, full_i = packed_score_plain(*args, sel, q, 0)
    torch.cuda.synchronize()
    fin = torch.isfinite(pd)
    check(bool(torch.equal(torch.isfinite(kd), fin)), f"packed_score {label} topt={t}: +inf slots differ")
    err = float((kd - pd).abs()[fin].max())
    check(bool(torch.allclose(kd[fin], pd[fin], rtol=D_RTOL, atol=D_ATOL)),
          f"packed_score {label} topt={t}: distances differ by {err}")
    check(not exact or bool(torch.equal(kd[fin], pd[fin])), f"packed_score {label} topt={t}: distances not identical")
    check((t != 0 and not exact) or bool(torch.equal(ki, pi)), f"packed_score {label} topt={t}: ids differ")
    n_neg = int((pd < 0).sum())
    check(n_neg >= min_negative, f"packed_score {label}: {n_neg} negative distances, expected >= {min_negative}")
    w = t or full_i.shape[1] // E
    full_d, full_i = full_d.view(B, E, -1), full_i.view(B, E, -1)
    kd3, ki3 = kd.view(B, E, w), ki.view(B, E, w)
    ok = torch.isfinite(kd3)
    hit = (full_i[:, :, None, :] == ki3[:, :, :, None]) & ok[:, :, :, None]
    looked_up = torch.where(hit, full_d[:, :, None, :], 0.0).sum(-1)
    tie_gap = float((looked_up - kd3).abs()[ok].max())
    check(tie_gap <= D_ATOL + D_RTOL * 512, f"packed_score {label} topt={t}: a differing id is not a tie ({tie_gap})")
    lane0 = args[2][sel.long()][:, :, :1].expand(B, E, w)
    check(t == 0 or bool(torch.equal(ki3[~ok], lane0[~ok])),
          f"packed_score {label} topt={t}: an exhausted pass is not lane 0")
    phase("packed_score", input=label, B=B, E=E, topt=t, sentinel_pairs=int((sel == args[0].shape[0] - 1).sum()),
          negative_slots=n_neg, max_abs_err=f"{err:.3e}", differing_ids=int((ki != pi).sum()),
          worst_tie_gap=f"{tie_gap:.3e}")
    return err


def hold_fused(torch, label: str, g, q, ef: int, expand: int, cand: int, seeds: int, gt: np.ndarray,
               min_identical: float = 0.0) -> float:
    """K1 (bf16 blocks of ``g``) or K1-s8 (s8 blocks) against its plain
    version on the arguments the engine gives it for the f32 queries ``q``
    at ``ef``: EF=128, the same seeded beams, 8 ef + 16 iterations.  The
    top-10 after the f32 rerank overlaps >= 0.99, recall within 0.005,
    distance computations within 1%, and the beam distances where both
    hold the same id within D_ATOL / D_RTOL on bf16 blocks, identical on
    s8 (exact integer sums); with ``min_identical``, at least that share of
    the beams identical.  Returns the largest of those differences."""
    from expann_tpu_torch.models.search import entry_beam, kernel_query, rerank
    from expann_tpu_torch.ops.fused import fused_search_cuda, fused_search_plain, topt_for

    name = "fused_search_s8" if g.packed_codes is not None else "fused_search"
    topt = topt_for(cand, expand, g.packed.shape[1])
    bd0, bi0, _ = entry_beam(g, q, 128, seeds)
    fargs = (g.packed, g.packed_norms, g.packed_ids, kernel_query(g, q), bd0, bi0, ef, expand, topt, 8 * ef + 16)
    ki, kd, kn, _ = fused_search_cuda(*fargs)
    pi_, pd_, pn, _ = fused_search_plain(*fargs)
    torch.cuda.synchronize()
    same = (ki == pi_) & (ki < g.sentinel)
    err = float((kd - pd_).abs()[same].max())
    k_top = rerank(g, q, ki, K)[0].cpu().numpy()
    p_top = rerank(g, q, pi_, K)[0].cpu().numpy()
    overlap = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K for a, b in zip(k_top, p_top)]))
    r_diff = recall(k_top, gt) - recall(p_top, gt)
    nk, npl = int(kn.sum()), int(pn.sum())
    phase(label, kernel=name, ef=ef, expand=expand, topt=topt, seeds=seeds, B=q.shape[0],
          top10_overlap=f"{overlap:.4f}", recall_diff=f"{r_diff:+.4f}", distcomps_kernel=nk, distcomps_plain=npl,
          beams_identical=f"{int((ki == pi_).all(1).sum())}/{q.shape[0]}", max_abs_err=f"{err:.3e}")
    check(overlap >= 0.99, f"{label}: {name}: top-10 overlap with the plain version {overlap} < 0.99")
    check(abs(r_diff) <= 0.005, f"{label}: {name}: recall differs from the plain version by {r_diff}")
    check(abs(nk - npl) <= 0.01 * npl, f"{label}: {name}: distcomps {nk} vs plain {npl}")
    n_ident = int((ki == pi_).all(1).sum())
    check(n_ident >= min_identical * q.shape[0], f"{label}: {name}: {n_ident}/{q.shape[0]} beams identical")
    if g.packed_codes is not None:
        check(bool(torch.equal(kd[same], pd_[same])), f"{label}: {name}: beam distances differ by {err}")
    else:
        check(bool(torch.allclose(kd[same], pd_[same], rtol=D_RTOL, atol=D_ATOL)),
              f"{label}: {name}: beam distances differ by {err}")
    return err


def hold_fused_rows(torch, dev, card: str, n: int = 1 << 20, B: int = 8192) -> dict:
    """K1-rows through ``fused_search_rows`` at the wide index's serving
    shape against its plain version: 2**20 rows of 1024 integer-valued dims
    in [-3, 3] (a 2 GB bf16 corpus; every distance exact in both), 96
    neighbours a node at an odd stride from a random start (2**20 ids
    without a repeat; every seventh node's last quarter the sentinel), 8192
    integer queries seeded with 4 random nodes, ef=80 in EF=128, expand 2,
    cand 8.  Ids, distances, row counts and iterations identical, the
    launches counted; the kernel timed against its bound: the rows it read
    with their norm and id (2 D + 8 B each), queries and beams, at 3.35
    TB/s.  Returns the largest distance difference, the launches and the
    times."""
    from expann_tpu_torch.ops import _kernels
    from expann_tpu_torch.ops.fused import fused_search_rows, fused_search_rows_plain, ring_for, topt_for
    from expann_tpu_torch.ops.packed import build_rows, packed_widths
    from expann_tpu_torch.utils.profiling import event_ms

    d, R, ef, EF, E, cand = 1024, 96, 80, 128, 2, 8
    gen = torch.Generator(device=dev).manual_seed(21)
    vecs = torch.zeros((n + 1, d), device=dev)
    vecs[:n].random_(-3, 4, generator=gen)
    norms = torch.einsum("nd,nd->n", vecs, vecs)
    norms[n] = float("inf")
    start = torch.randint(0, n, (n + 1, 1), generator=gen, device=dev)
    stride = 2 * torch.randint(0, n // 2, (n + 1, 1), generator=gen, device=dev) + 1
    adj = ((start + stride * torch.arange(R, device=dev)) % n).to(torch.int32)
    adj[::7, R - R // 4 :] = n
    adj[n] = n
    rows, rn, ri = build_rows(vecs, norms, adj)
    q = torch.empty((B, d), device=dev).random_(-3, 4, generator=gen)
    seeds = torch.randint(0, n, (B, 4), generator=gen, device=dev, dtype=torch.int32)
    bd0 = torch.full((B, EF), float("inf"), device=dev)
    bi0 = torch.full((B, EF), n, dtype=torch.int32, device=dev)
    bi0[:, :4] = seeds
    bd0[:, :4] = ((q[:, None, :] - vecs[seeds.long()]) ** 2).sum(-1)
    del vecs, norms, adj, start, stride
    rs = packed_widths(R)[0]
    topt, max_iters = topt_for(cand, E, rs), 8 * ef + 16

    def call():
        return fused_search_rows(rows, rn, ri, rs, q, bd0, bi0, ef=ef, expand=E, cand=cand)

    before = _kernels.launches["fused_search_rows"]
    got = call()
    ref = []
    plain_ms = event_ms(lambda: ref.append(fused_search_rows_plain(rows, rn, ri, rs, q, bd0, bi0, ef, E, topt,
                                                                    max_iters)), reps=1, warmup=0)
    torch.cuda.synchronize()
    diff = {name: int((a != b).sum()) for name, a, b in zip(("ids", "dist", "ncomp", "iters"), got, ref[-1])}
    live = torch.isfinite(got[1]) & torch.isfinite(ref[-1][1])
    err = float((got[1] - ref[-1][1])[live].abs().max())
    ms = event_ms(call, reps=5)
    launched = _kernels.launches["fused_search_rows"] - before
    gathered = int(got[2].sum())
    kb = bound(gathered * (2 * d + 8) + B * d * 4 + 2 * B * EF * 8 + 2 * B * 4, 2.0 * gathered * d)
    ring = ring_for(2, B, d, rs, ri.shape[1], EF, E)
    phase("fused_rows", n=n, d=d, rs=rs, B=B, ef=ef, EF=EF, expand=E, topt=topt, differing=diff,
          max_abs_err=f"{err:.3e}", rows_per_query=f"{gathered / B:.1f}",
          iterations_per_query=f"{float(got[3].float().mean()):.1f}", launches=launched, ms=f"{ms:.3f}",
          plain_ms=f"{plain_ms:.3f}", bound_ms=f"{kb[0]:.4f}", bound_by=kb[1], share=f"{kb[0] / ms:.4f}",
          gathered_tb_per_s=f"{gathered * 2 * d / (ms * 1e-3) / 1e12:.3f}", ring=f"{ring[0]}x{ring[1]}",
          ctas_per_sm=ring[2], card=card)
    check(not any(diff.values()), f"fused_rows: K1-rows differs from its plain version: {diff}")
    check(launched == 7, f"fused_rows: {launched} launches of K1-rows counted, 7 made")
    check(int(got[3].min()) >= 2, "fused_rows: a query stopped before its second iteration")
    del rows, rn, ri, q, bd0, bi0, got, ref
    torch.cuda.empty_cache()
    return dict(err=err, launches=launched,
                times=dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=kb[0], bound_by=kb[1]))


def hold_flat_s8(torch, label: str, fn, q, x, k: int) -> float:
    """An s8 flat top-k kernel ``fn`` against flat_topk_plain on the codes
    (q, x) at k: both sides compute exact integer distances and break ties
    by id, so ids and distances must be identical.  Prints one line;
    returns the largest |d_kernel - d_plain|."""
    from expann_tpu_torch.ops.topk import flat_topk_plain

    ids, dk = fn(q, x, k)
    pids, pd = flat_topk_plain(q, x, k)
    torch.cuda.synchronize()
    err = float((dk - pd).abs().max())
    n_diff = int((ids != pids).sum())
    phase(label, n=x.shape[0], B=q.shape[0], k=k, max_abs_err=f"{err:.3e}", differing_ids=n_diff)
    check(bool(torch.equal(dk, pd)) and n_diff == 0, f"{label} k={k}: not identical to the plain version")
    return err


def flat_s8_phase(torch, dev) -> dict:
    """K2-s8 and K3-s8 against the plain version on random s8 codes (n=56000,
    d=128, 4096 queries).  Returns each kernel's largest |d_kernel -
    d_plain|."""
    from expann_tpu_torch.ops.topk import flat_topk_cuda, flat_topk_fixed_cuda

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-127, 128, (N, D)).astype(np.int8)).to(dev)
    q = torch.from_numpy(rng.integers(-127, 128, (FLAT_B, D)).astype(np.int8)).to(dev)
    err = {}
    for label, fn in (("flat_topk_s8", flat_topk_cuda), ("flat_fixed_s8", flat_topk_fixed_cuda)):
        for k in FLAT_S8_KS:
            err[label] = max(err.get(label, 0.0), hold_flat_s8(torch, label, fn, q, x, k))
    return err


def quantized_phases(torch, dev, ds, graph, cfg, card: str, topt: int) -> dict:
    """Phases 9-12, quantized serving: the fused_i8 flat engine, bench.py's
    flow on the graph engine ``graph`` built in phase 4, K1-s8 against its
    plain version, the compressed small-batch route, and the quantized
    times.  Returns the launch counts of its two paths, K1-s8's largest
    beam-distance error and the s8 kernels' times."""
    from expann_tpu_torch import BruteForceEngine
    from expann_tpu_torch.models.search import entry_beam, kernel_query
    from expann_tpu_torch.ops import _kernels
    from expann_tpu_torch.ops.fused import fused_search_cuda, fused_search_plain, ring_for
    from expann_tpu_torch.ops.topk import flat_topk_cuda, flat_topk_fixed_cuda, flat_topk_plain, quantize_query_i8
    from expann_tpu_torch.tools.perf_fused_search import YARDSTICK, expanded_blocks, traversal_bound
    from expann_tpu_torch.utils.profiling import event_ms

    launches, times, failures = {}, {}, []

    # ---- 9. canonical_quantized: one path, counts reset just before it ----
    _kernels.launches.clear()
    flat8 = {}
    for wire in ("bf16", "i8"):
        for topk_mode in ("count", "fixed"):
            eng = BruteForceEngine(mode="fused_i8", query_wire=wire, topk_mode=topk_mode, device=dev)
            eng.store_many_vectors(ds.vecs)
            eng.build()
            ids = eng.query_k_batch(ds.queries, K)
            flat8[wire, topk_mode] = (eng, ids)
            rec = recall(ids, ds.ground_truth)
            phase("canonical_quantized", engine="flat", mode="fused_i8", query_wire=wire, topk_mode=topk_mode,
                  recall_at_10=f"{rec:.4f}", ids_equal_count_mode=bool((ids == flat8[wire, "count"][1]).all()))
            check(ids.shape == (M_QUERIES, K) and rows_unique(ids), f"fused_i8 ({wire}, {topk_mode}): duplicates")
            if rec < 0.97:
                failures.append(f"flat fused_i8 recall@10 {rec} < 0.97 (wire {wire}, {topk_mode})")
            if not (ids == flat8[wire, "count"][1]).all():
                failures.append(f"fused_i8 topk_mode=fixed ids differ from count mode (wire {wire})")
    # bench.py:300-339 on the engine already built and served in bf16
    graph.cfg.use_compression = True
    graph._attach_codes()
    graph_rec = {}
    for wire, efs in (("bf16", QUANT_EFS), ("i8", WIRE_EFS)):
        graph.cfg.query_wire = wire
        for ef in efs:
            graph.set_ef_search(ef)
            gids = graph.query_k_batch(ds.queries, K)
            check(gids.shape == (M_QUERIES, K) and rows_unique(gids),
                  f"compressed graph results ({wire} wire, ef={ef}) have wrong shape or duplicates")
            graph_rec[wire, ef] = recall(gids, ds.ground_truth)
            phase("canonical_quantized", engine="graph", packed_dtype=str(graph.graph.packed.dtype).split(".")[-1],
                  query_wire=wire, ef=ef, recall_at_10=f"{graph_rec[wire, ef]:.4f}",
                  distcomps_per_query=f"{graph.num_distcomps / M_QUERIES:.1f}",
                  distcomps_compressed_per_query=f"{graph.num_distcomps_compressed / M_QUERIES:.1f}")
    graph.cfg.query_wire = "bf16"
    launches["quantized"] = dict(_kernels.launches)
    g = graph.graph
    check(g.packed.dtype == torch.int8 and g.packed_codes is not None, f"graph.packed is {g.packed.dtype}, not int8")
    for wire in ("bf16", "i8"):
        if graph_rec[wire, 120] < 0.95:
            failures.append(f"compressed graph recall@10 at ef=120 ({wire} wire) {graph_rec[wire, 120]} < 0.95")
    rs = g.packed.shape[1]
    phase("canonical_quantized", packed_bytes=g.packed.numel(), rs=rs,
          flat_codes_bytes=flat8["i8", "count"][0]._x_fused.numel(),
          rerank_corpus_bytes=flat8["i8", "count"][0]._x.numel() * 4)

    # ---- 10. K1-s8 against its plain version, same code-space seeds --------
    qg = torch.from_numpy(ds.queries).to(torch.bfloat16).to(dev).float()
    EF, ef = 128, 120
    args = (g.packed, g.packed_norms, g.packed_ids)
    fused_s8_err = hold_fused(torch, "fused_s8", g, qg, ef, cfg.query_expand, cfg.fused_cand, cfg.entry_seeds,
                              ds.ground_truth)

    # ---- 11. the compressed engine's per-iteration route -----------------
    graph.set_ef_search(120)
    _kernels.launches.clear()
    t0 = time.perf_counter()
    single = np.concatenate([graph.query_k_batch(ds.queries[i : i + 1], K) for i in range(M_QUERIES)])
    single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunked = np.concatenate(
        [graph.query_k_batch(ds.queries[s : s + SMALL_CHUNK], K) for s in range(0, M_QUERIES, SMALL_CHUNK)]
    )
    chunked_s = time.perf_counter() - t0
    launches["small_batch_compressed"] = dict(_kernels.launches)
    n_same = int((single == chunked).all(1).sum())
    phase("small_batch_compressed", ef=120, quant_mode=graph.cfg.quant_mode,
          recall_at_10=f"{recall(single, ds.ground_truth):.4f}", rows_identical=f"{n_same}/{M_QUERIES}",
          distcomps_compressed_per_query=f"{graph.num_distcomps_compressed / (2 * M_QUERIES):.1f}",
          seconds_single=f"{single_s:.2f}", seconds_chunks_of_32=f"{chunked_s:.2f}")
    check(n_same == M_QUERIES, f"compressed small batches: ids differ between 1- and 32-query calls on {M_QUERIES - n_same} rows")
    check(rows_unique(single) and rows_unique(chunked), "compressed small batches: duplicate ids")

    # ---- 12. times --------------------------------------------------------
    rng = np.random.default_rng(4)
    for label, eng, ef_q, wire in (("flat_i8", flat8["i8", "count"][0], None, None),
                                   ("graph_compressed_ef110", graph, 110, "bf16"),
                                   ("graph_compressed_ef120", graph, 120, "bf16"),
                                   ("graph_wire_i8_ef120", graph, 120, "i8")):
        if ef_q is not None:
            graph.cfg.query_wire = wire
            graph.set_ef_search(ef_q)
        eng.query_k_batch(rng.standard_normal((1024, D)).astype(np.float32), K)  # warm-up
        runs = []
        for _ in range(2):
            batch = rng.standard_normal((QPS_QUERIES, D)).astype(np.float32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.query_k_batch(batch, K)
            runs.append(QPS_QUERIES / (time.perf_counter() - t0))
        phase("times", path=label, queries=QPS_QUERIES, qps=",".join(f"{v:.0f}" for v in runs), card=card)
    graph.cfg.query_wire = "bf16"

    eng8 = flat8["i8", "count"][0]
    x8, k8 = eng8._x_fused, 3 * K
    q8 = quantize_query_i8(rng.standard_normal((FLAT_CHUNK, D)).astype(np.float32), eng8._i8_center, eng8._i8_scale)
    q8 = torch.from_numpy(q8).to(dev)
    xn8 = (x8.int() ** 2).sum(1)
    qn8 = (q8.int() ** 2).sum(1)

    def flat8_chain():  # one s8 x s8 -> s32 product, then top-k
        return torch.topk((qn8[:, None] + xn8[None, :]) - 2 * torch._int_mm(q8, x8.T), k8, dim=1, largest=False)

    try:
        lib_ms = event_ms(flat8_chain, reps=3)
    except RuntimeError as e:  # a yardstick only: report it missing, keep going
        lib_ms = None
        phase("times", library="torch._int_mm + topk", unavailable=repr(str(e).splitlines()[0][:120]))
    plain_ms = event_ms(lambda: flat_topk_plain(q8, x8, k8), reps=2)
    fb = bound(N * D + FLAT_CHUNK * D + FLAT_CHUNK * k8 * 8, 2.0 * FLAT_CHUNK * N * D, "int8")
    flat_err = {}
    for name, label, fn in (("flat_topk_s8", "flat_topk_s8", flat_topk_cuda),
                            ("flat_topk_fixed_s8", "flat_fixed_s8", flat_topk_fixed_cuda)):
        # the timed call, on the engine's codes at the serving chunk, against the plain version first
        flat_err[label] = hold_flat_s8(torch, label, fn, q8, x8, k8)
        ms = event_ms(lambda: fn(q8, x8, k8), reps=5)
        times[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=fb[0], bound_by=fb[1])
        phase("times", kernel=name, B=FLAT_CHUNK, n=N, k=k8, ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}",
              library_ms="null" if lib_ms is None else f"{lib_ms:.3f}",
              vs_library="null" if lib_ms is None else f"{lib_ms / ms:.2f}x", bound_ms=f"{fb[0]:.4f}", bound_by=fb[1],
              achieved_tops=f"{2.0 * FLAT_CHUNK * N * D / (ms * 1e-3) / 1e12:.1f}", card=card)
    del x8, q8, xn8, qn8

    Bq = cfg.query_block
    qt = torch.from_numpy(rng.standard_normal((Bq, D)).astype(np.float32)).to(torch.bfloat16).to(dev).float()
    bd0, bi0, _ = entry_beam(g, qt, EF, cfg.entry_seeds)
    targs = (*args, kernel_query(g, qt), bd0, bi0, ef, cfg.query_expand, topt, 8 * ef + 16)
    ms = event_ms(lambda: fused_search_cuda(*targs), reps=5)
    plain_ms = event_ms(lambda: fused_search_plain(*targs), reps=1)
    # the bound counts every input byte once (phase 8's count, on s8 blocks)
    expansions = int(fused_search_cuda(*targs)[2].sum()) // rs
    blocks = expanded_blocks(*targs)
    kb = traversal_bound(expansions, blocks, rs, D, g.packed_norms.shape[1], "s8", Bq, EF)
    ring = ring_for(1, Bq, D, rs, g.packed_norms.shape[1], EF, cfg.query_expand)
    times["fused_search_s8"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=kb["bound_ms"],
                                    bound_by=kb["bound_by"])
    phase("times", kernel="fused_search_s8", B=Bq, ef=ef, EF=EF, ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}",
          bound_ms=f"{kb['bound_ms']:.4f}", bound_by=kb["bound_by"], share=f"{kb['bound_ms'] / ms:.4f}",
          expansions_per_query=f"{expansions / Bq:.1f}", blocks=blocks, blocks_of_layout=g.packed.shape[0] - 1,
          gathered_tb_per_s=f"{kb['gathered_bytes'] / (ms * 1e-3) / 1e12:.3f}",
          gathered_yardstick=repr(YARDSTICK["s8"]),
          ring=f"{ring[0]}x{ring[1]}", ctas_per_sm=ring[2], card=card)

    check(not failures, "; ".join(failures))
    return dict(launches=launches, times=times, fused_s8_err=fused_s8_err, flat_err=flat_err,
                flat_i8=flat8["i8", "count"][0])


def probe_phases(torch, dev, card: str) -> dict:
    """Phases 14-17: each probe kernel (expann_tpu_torch/tools/) against its
    plain version at the tools' shapes, then the probes path with the
    launch counts reset just before it: the tools' own sweeps.  Returns the
    path's launch counts, each kernel's largest error and times."""
    from expann_tpu_torch.ops import _kernels
    from expann_tpu_torch.ops.fused import fused_search, fused_search_plain, topt_for
    from expann_tpu_torch.tools import perf_pallas_gather as pg
    from expann_tpu_torch.tools import probe_fused as pf
    from expann_tpu_torch.tools import probe_lanes as pl
    from expann_tpu_torch.tools import probe_step_overhead as ps
    from expann_tpu_torch.utils.profiling import event_ms

    err, times = {}, {}

    # ---- 14. P1 -------------------------------------------------------------
    tab, x = pf.inputs(dev)
    o, w = pf.probe_fused_cuda(tab, x)
    po, pw = pf.probe_fused_plain(tab, x)
    torch.cuda.synchronize()
    err["probe_fused"] = max(float((o - po).abs().max()), float((w - pw).abs().max()))
    phase("probe_fused", copied_entry=int(torch.argmin(x[0])) % 64, loop_count=int(pw[0, 0]),
          identical=bool(torch.equal(o, po) and torch.equal(w, pw)))
    check(torch.equal(o, po) and torch.equal(w, pw), f"probe_fused differs from its plain version ({err['probe_fused']})")
    # the cases of the card tests: seeds, ties, column 127, the table's last
    # entry, loop caps 0 and 1
    for kind, seed in pf.CASES:
        ct, cx, cap, centry = pf.case_inputs(dev, kind, seed)
        co, cw = pf.probe_fused_cuda(ct, cx, cap)
        cpo, cpw = pf.probe_fused_plain(ct, cx, cap)
        torch.cuda.synchronize()
        same = bool(torch.equal(co, cpo) and torch.equal(cw, cpw)
                    and (centry is None or torch.equal(co, ct[centry])))
        err["probe_fused"] = max(err["probe_fused"], float((co - cpo).abs().max()), float((cw - cpw).abs().max()))
        check(same, f"probe_fused case {kind}-{seed} differs from its plain version")
    phase("probe_fused", cases=len(pf.CASES), identical=True)
    ms = event_ms(lambda: pf.probe_fused_cuda(tab, x), reps=200)
    plain_ms = event_ms(lambda: pf.probe_fused_plain(tab, x), reps=5)
    # the library's copy of the same entry: one indexing call by a device index
    entry = (torch.argmin(x[0]) % tab.shape[0]).reshape(1)
    check(torch.equal(tab[entry][0], po), "tab[entry] is not the entry probe_fused copies")
    lib_ms = event_ms(lambda: tab[entry], reps=200)
    # one block: latency sets its time; the bytes it must move (one 4 KB
    # entry, x, o and w) give the bound
    pb = bound(4 * 4096, 0.0)
    times["probe_fused"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=pb[0], bound_by=pb[1])
    phase("probe_fused", us=f"{ms * 1e3:.3f}", plain_us=f"{plain_ms * 1e3:.1f}", library_us=f"{lib_ms * 1e3:.3f}",
          bound_us=f"{pb[0] * 1e3:.5f}", limited_by="latency", card=card)

    # ---- 15. P2 -------------------------------------------------------------
    # every ring of the sweep on the sweep's own 2 GiB tables, at a step count
    # that wraps each block's ring several times; then the time at R=128,
    # NBUF=4 (the shape named for the comparison) and G_LO steps
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((1, pg.D), generator=gen, device=dev).to(torch.bfloat16)
    err["block_gather"] = 0.0
    for R in pg.R_SWEEP:
        nb = pg.table_blocks(R)
        packed = torch.randn((nb, R, pg.D), generator=gen, device=dev, dtype=torch.bfloat16)
        ids = torch.randint(0, nb, (PROBE_G,), generator=gen, device=dev, dtype=torch.int32)
        ref = pg.block_gather_scores_plain(packed, ids, q)
        for nbuf in pg.NBUF_SWEEP:
            if (R, nbuf) == (128, 8):
                refused = not pg.ring_fits(R, nbuf)
                try:
                    pg.block_gather_scores_cuda(packed, ids, q, nbuf)
                except ValueError as e:
                    refused = refused and "shared memory" in str(e)
                else:
                    refused = False
                phase("probe_gather", R=R, nbuf=nbuf, refused=refused)
                check(refused, "block_gather took an R=128, NBUF=8 ring (256 KB) without refusing it")
                continue
            check(pg.ring_fits(R, nbuf), f"block_gather: the R={R}, NBUF={nbuf} ring does not fit")
            got = pg.block_gather_scores_cuda(packed, ids, q, nbuf)
            torch.cuda.synchronize()
            e = float((got - ref).abs().max())
            err["block_gather"] = max(err["block_gather"], e)
            worst = float(((got - ref).abs() / (1 + ref.abs())).max())
            phase("probe_gather", R=R, nbuf=nbuf, G=PROBE_G, NB=nb, max_abs_err=f"{e:.3e}",
                  worst_relative=f"{worst:.3e}")
            check(worst <= 1e-4, f"block_gather (R={R}, nbuf={nbuf}) differs from its plain version: "
                                 f"{worst} > 1e-4 (1 + |ref|)")
            del got
        del packed, ref
    R, nbuf, G = 128, 4, pg.G_LO
    nb = pg.table_blocks(R)
    packed = torch.randn((nb, R, pg.D), generator=gen, device=dev, dtype=torch.bfloat16)
    ids = torch.randint(0, nb, (G,), generator=gen, device=dev, dtype=torch.int32)
    ms = event_ms(lambda: pg.block_gather_scores_cuda(packed, ids, q, nbuf), reps=10)
    plain_ms = event_ms(lambda: pg.block_gather_scores_plain(packed, ids, q), reps=3)
    lib_ms = event_ms(lambda: pg.library_chain(packed, ids, q), reps=10)
    gb = bound(G * R * pg.D * 2 + G * R * 4 + G * 4, 2.0 * G * R * pg.D)
    times["block_gather"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=gb[0], bound_by=gb[1])
    phase("probe_gather", R=R, nbuf=nbuf, G=G, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
          bound_ms=f"{gb[0]:.4f}", bound_by=gb[1], card=card)
    del packed

    # K1 as P3's companion drives it, against its plain version on a slice
    # of the companion's queries at both iteration caps
    fargs = [t[:1024] if t.shape[0] == ps.B else t for t in ps.fused_inputs(dev)]
    for cap in ps.FUSED_ITERS:
        got = fused_search(*fargs, ef=120, expand=4, cand=32, max_iters=cap)
        ref = fused_search_plain(*fargs, 120, 4, topt_for(32, 4, ps.RS), cap)
        agree = ps.fused_agreement(got, ref, sentinel=ps.NODES)
        phase("probe_step", fused_max_iters=cap, B=1024, **{k: f"{v:.6g}" for k, v in agree.items()})
        check(agree["same_beams"] >= 0.95 and agree["overlap"] >= 0.99,
              f"fused_search on the companion layout (cap {cap}): beams differ from the plain version: {agree}")
        check(agree["dist_err"] <= D_ATOL + D_RTOL * agree["dist_max"],
              f"fused_search on the companion layout (cap {cap}): distances differ: {agree}")
        check(agree["same_iters"] >= 0.95 and abs(agree["iters_ratio"] - 1) <= 0.01
              and abs(agree["ncomp_ratio"] - 1) <= 0.01,
              f"fused_search on the companion layout (cap {cap}): iterations or distance counts differ: {agree}")
    del fargs, got, ref

    # ---- 16. P3 -------------------------------------------------------------
    qs, bd0, blocks = ps.inputs(dev)
    err["step_overhead"] = 0.0
    # every feature at one tile (B=8: cluster - 1 padded blocks), 125 tiles
    # (no multiple of the cluster) and the tool's 1024, at the tool's
    # cluster: identical, as the kernel rounds every multiply and add as
    # the plain version does
    for b in (8, 1000, ps.B):
        for feat in ps.FEATURES:
            got = ps.step_overhead_cuda(qs[:b], bd0[:b], blocks, feat)
            ref = ps.step_overhead_plain(qs[:b], bd0[:b], blocks, feat)
            torch.cuda.synchronize()
            e = float((got - ref).abs().max())
            err["step_overhead"] = max(err["step_overhead"], e)
            phase("probe_step", feature=feat or "base", B=b, iters=ps.ITERS, cluster=ps.CLUSTER,
                  max_abs_err=f"{e:.3e}", identical=bool(torch.equal(got, ref)))
            check(bool(torch.equal(got, ref)), f"step_overhead {feat!r} B={b} is not identical (differs by {e})")
        # on a beam of ~1e-7 each copied row (times 1e-9) moves every value
        # by many ulps, so a wrong, early or missing copy shows; one-block
        # clusters (plain copies) and the tool's (multicasts)
        small = bd0[:b] * 1e-7
        ref = ps.step_overhead_plain(qs[:b], small, blocks, "dma")
        moved = float((ref != ps.step_overhead_plain(qs[:b], small, blocks, "")).float().mean())
        check(moved > 0.99, f"step_overhead: the copies move only {moved} of the small beam's values")
        for c in (1, ps.CLUSTER):
            got = ps.step_overhead_cuda(qs[:b], small, blocks, "dma", ps.ITERS, c)
            torch.cuda.synchronize()
            e = float((got - ref).abs().max())
            phase("probe_step", feature="dma", beam="small", B=b, cluster=c, moved=f"{moved:.4f}",
                  max_abs_err=f"{e:.3e}", identical=bool(torch.equal(got, ref)))
            check(bool(torch.equal(got, ref)), f"step_overhead dma, small beam, B={b}, cluster {c}: differs by {e}")
    ms = event_ms(lambda: ps.step_overhead_cuda(qs, bd0, blocks, "dma"), reps=5)
    plain_ms = event_ms(lambda: ps.step_overhead_plain(qs, bd0, blocks, "dma"), reps=2)
    sb = bound(ps.step_bytes("dma"), 3.0 * ps.B * ps.EF * ps.ITERS, "f32")
    times["step_overhead"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=sb[0], bound_by=sb[1])
    phase("probe_step", feature="dma", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{sb[0]:.5f}",
          bound_by=sb[1], cluster=ps.CLUSTER, l2_bytes=ps.l2_bytes(ps.B, ps.ITERS, ps.CLUSTER),
          clusters_at_once=ps.active_clusters(ps.RS, True, ps.CLUSTER, dev), card=card)
    del qs, bd0, blocks

    # ---- 17. P4 -------------------------------------------------------------
    # every mode identical to its plain version (the prefix sum within 1e-5:
    # another summation order); the modes that reduce, identical on the
    # edge rows too (ties, signs of zero, +inf)
    xl = pl.inputs(dev)
    xl[:, 3] = xl[:, 70]  # ties with lane 3 for bcast
    edges = pl.edge_rows(dev)
    err["probe_lanes"] = 0.0
    for mode in pl.MODES:
        got = pl.lane_ops_cuda(xl, mode)
        ref = pl.lane_ops_plain(xl, mode)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        err["probe_lanes"] = max(err["probe_lanes"], e)
        phase("probe_lanes", mode=mode, rows=xl.shape[0], iters=pl.ITERS, max_abs_err=f"{e:.3e}",
              identical=bool(torch.equal(got, ref)))
        if mode == "matmul_cumsum":
            check(bool(torch.allclose(got, ref, rtol=1e-5, atol=1e-6)), f"probe_lanes {mode} differs by {e}")
        else:
            check(bool(torch.equal(got, ref)), f"probe_lanes {mode} is not identical to its plain version ({e})")
        if mode in ("reduce", "reduce3") or mode.startswith("carry"):
            same = bool(torch.equal(pl.lane_ops_cuda(edges, mode), pl.lane_ops_plain(edges, mode)))
            phase("probe_lanes", mode=mode, edge_rows=edges.shape[0], identical=same)
            check(same, f"probe_lanes {mode} is not identical to its plain version on the edge rows")
    ms = event_ms(lambda: pl.lane_ops_cuda(xl, "reduce"), reps=20)
    plain_ms = event_ms(lambda: pl.lane_ops_plain(xl, "reduce"), reps=1)
    rows = xl.shape[0]
    # per element and step: its share of the row's min and one add
    lb = bound(2 * rows * pl.W * 4, 2.0 * rows * pl.W * pl.ITERS, "f32")
    times["probe_lanes"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=lb[0], bound_by=lb[1])
    phase("probe_lanes", mode="reduce", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{lb[0]:.5f}",
          bound_by=lb[1], card=card)
    del xl

    # ---- the probes path: the tools' sweeps, counts reset just before -----
    _kernels.launches.clear()
    p1 = pf.main(dev)
    gather = pg.sweep(dev, log=lambda line: None)
    steps = [ps.run(feat, dev) for feat in ps.FEATURES]
    sweep = [ps.run("dma", dev, c) for c in ps.cluster_sizes(ps.B // ps.T)]
    alone = [ps.run(feat, dev, 1, ps.T) for feat in ("", "dma")]  # one tile alone on an SM
    fused = ps.run_fused(dev)
    lanes = [pl.run(mode, dev) for mode in pl.MODES]
    launches = dict(_kernels.launches)
    check(p1["ok_dma"] and p1["ok_while"], f"probe_fused's own check failed: {p1}")
    for r in gather:
        if r["launchable"]:
            phase("probe_gather", R=r["R"], nbuf=r["nbuf"], block_kb=f"{r['block_kb']:.0f}",
                  gb_per_s=f"{r['gb_per_s']:.1f}", ns_per_block=f"{r['ns_per_block']:.3f}",
                  hbm_share=f"{r['hbm_share']:.3f}", library_gb_per_s=f"{r['library_gb_per_s']:.1f}", card=card)
        else:
            phase("probe_gather", R=r["R"], nbuf=r["nbuf"], launchable=False)
    check(sorted((r["R"], r["nbuf"], r["launchable"]) for r in gather)
          == sorted((R, nb, (R, nb) != (128, 8)) for R in pg.R_SWEEP for nb in pg.NBUF_SWEEP),
          "the sweep did not run every ring but R=128, NBUF=8, or did not refuse that one")
    for r in steps + sweep + alone:
        phase("probe_step", feature=r["feat"] or "base", B=r["B"], iters=ps.ITERS, cluster=r["cluster"],
              ms=f"{r['ms']:.4f}", us_per_tile=f"{r['us_per_tile']:.4f}", ns_per_step=f"{r['ns_per_step']:.2f}",
              l2_bytes=r["l2_bytes"], card=card)
    phase("probe_step", fixed_step_ns=f"{alone[0]['ns_per_step']:.2f}",
          fixed_step_dma_ns=f"{alone[1]['ns_per_step']:.2f}", B=ps.T, cluster=1, card=card)
    for r in fused:
        phase("probe_step", fused_max_iters=r["max_iters"], B=ps.B, ef=120, expand=4, cand=32, ms=f"{r['ms']:.3f}",
              iters_mean=f"{r['iters_mean']:.2f}", iters_max=r["iters_max"], card=card)
    phase("probe_step", fused_ms_per_iteration=f"{ps.fused_slope(fused):.4f}", card=card)
    for r in lanes:
        phase("probe_lanes", mode=r["mode"], ns_per_step=f"{r['ns_per_step']:.2f}",
              us_256=f"{r['ms_half'] * 1e3:.3f}", us_512=f"{r['ms'] * 1e3:.3f}", card=card)
        check(r["ms"] >= 1.2 * r["ms_half"], f"probe_lanes {r['mode']}: 512 steps do not take longer than 256 ({r})")
    return dict(launches=launches, err=err, times=times)


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock milliseconds of ``fn`` (host work only)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def traced_in_a_fresh_process(engine: str, B: int, work_dir: str) -> dict:
    """tools/perf_trace's profile of one warm call of ``engine`` (graph,
    flat or flat_i8) on the canonical corpus, in a process of its own, with
    its trace and the graph's index under ``work_dir``, and the process's
    host seconds (``process_seconds``).  Every engine is traced this way:
    inside this script, after its earlier profiler sessions, a traced flat
    call (~7 ms) recorded no device activity at all on an H100 (torch
    2.11), while the same call traces in a fresh process."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "expann_tpu_torch.tools.perf_trace", "--engine", engine, "--B", str(B),
         "--ef", "100", "--top", "8", "--log-dir", os.path.join(work_dir, "trace"),
         "--index", os.path.join(work_dir, "index.npz")],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    check(proc.returncode == 0, f"perf_trace --engine {engine} failed ({proc.returncode}):\n{proc.stderr[-2000:]}")
    return dict(json.loads(proc.stdout[proc.stdout.index("{"):]), process_seconds=time.perf_counter() - t0)


def trace_phase(torch, flat_i8, card: str) -> None:
    """Phase 18: tools/perf_trace's profile of one warm call on each
    serving engine, each in a fresh process: the graph on s8 blocks at
    ef=100 and 8192 queries, flat ``fused`` (K2) and ``fused_i8`` on the i8
    wire (K2-s8) at one FLAT_CHUNK of queries; then the host's own steps of
    a flat chunk (the bf16 cast of the query wire, the i8 quantization, on
    ``flat_i8``'s scales)."""
    from expann_tpu_torch.ops.topk import quantize_query_i8

    t0 = time.perf_counter()
    for label, engine, B, kernel in (("graph_s8", "graph", 8192, "fused_search_s8"),
                                     ("flat", "flat", FLAT_CHUNK, "flat_topk_kernel"),
                                     ("flat_i8", "flat_i8", FLAT_CHUNK, "flat_topk_s8_kernel")):
        with tempfile.TemporaryDirectory() as work_dir:
            prof = traced_in_a_fresh_process(engine, B, work_dir)
        check(bool(prof["span_us"]), f"the {label} trace holds no span of the annotated call")
        # the process's steps: start-up and exit are what its own steps leave
        steps = prof["seconds"]
        phase("trace", engine=label, process_seconds=f"{prof['process_seconds']:.1f}",
              startup_and_exit_seconds=f"{prof['process_seconds'] - sum(steps.values()):.1f}",
              **{f"{k}_seconds": f"{v:.1f}" for k, v in steps.items()})
        phase("trace", engine=label, B=prof["B"], ef=prof["ef"], wall_ms=f"{prof['wall_ms']:.3f}",
              span_us=f"{prof['span_us']:.1f}", device_us=f"{prof['device_total_us']:.1f}",
              copy_us=f"{prof['copy_us']:.1f}", idle_share=f"{prof['idle_share']:.4f}", card=card)
        for r in prof["top_kernels"]:
            phase("trace", engine=label, kernel=repr(r["kernel"][:90]), us=f"{r['us']:.1f}", pct=f"{r['pct']:.2f}")
        for r in prof["copies"]:
            phase("trace", engine=label, copy=repr(r["copy"][:60]), us=f"{r['us']:.1f}")
        check(prof["device_total_us"] > 0, f"the {label} trace holds no device time")
        check(prof["idle_share"] >= 0, f"the {label} trace's kernels and copies overrun the call's span: "
              f"idle share {prof['idle_share']}, the accounting is off")
        check(any(kernel in r["kernel"] for r in prof["top_kernels"]),
              f"{kernel} is not among the traced kernels of {label}")
    qh = np.random.default_rng(8).standard_normal((FLAT_CHUNK, D)).astype(np.float32)
    phase("trace", host_bf16_cast_ms=f"{host_ms(lambda: torch.from_numpy(qh).to(torch.bfloat16)):.3f}",
          host_i8_quantize_ms=f"{host_ms(lambda: quantize_query_i8(qh, flat_i8._i8_center, flat_i8._i8_scale)):.3f}",
          B=FLAT_CHUNK)
    phase("trace", seconds=f"{time.perf_counter() - t0:.1f}")


def bench_py_keys() -> tuple:
    """The keys of bench.py's ``out`` dict and of its pareto entries, read
    from its source (bench.py imports JAX; it is not run)."""
    import ast

    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    out = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "out" for t in n.targets))
    keys = [k.value for k in out.keys]
    return keys, [k.value for k in out.values[keys.index("pareto")].elt.keys]


def bench_phase(work: str, card: str) -> dict:
    """Phase 19: ``bench.canonical.run`` at the canonical size in this
    process, the launch counts reset just before it: bench.py's keys, all
    11 points, PERF.md's recall limits, ``value`` from the points, and K1,
    K1-s8, K2, K2-s8 launched.  Returns the path's launch counts."""
    from expann_tpu_torch.bench import canonical
    from expann_tpu_torch.ops import _kernels

    _kernels.launches.clear()
    t0 = time.perf_counter()
    out = canonical.run(N, M_QUERIES, D, K, qps_queries=QPS_QUERIES, reps=5, cache_dir=os.path.join(work, "data"))
    secs = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    print("[bench] " + json.dumps(out), flush=True)
    phase("bench", seconds=f"{secs:.1f}", card=card)
    phase("launches", path="bench", **launches)
    keys, pareto_keys = bench_py_keys()
    check(list(out) == keys, f"bench keys {list(out)} are not bench.py's {keys}")
    check(all(list(p) == pareto_keys for p in out["pareto"]), "a pareto entry's keys are not bench.py's")
    rec = {p["engine"]: p["recall"] for p in out["pareto"]}
    names = ["gpu_flat", "gpu_flat_i8"] + [f"antitopo_ef{ef}" for ef in (40, 60, 100, 120)] + [
        f"antitopo_compressed_ef{ef}" for ef in QUANT_EFS] + [f"antitopo_wire_i8_ef{ef}" for ef in WIRE_EFS]
    check(list(rec) == names, f"bench points {list(rec)}, expected {names}")
    limits = dict(gpu_flat=0.99, gpu_flat_i8=0.97, antitopo_ef120=0.95, antitopo_compressed_ef120=0.95,
                  antitopo_wire_i8_ef120=0.95)
    low = {name: rec[name] for name, lim in limits.items() if rec[name] < lim}
    check(not low, f"bench recall@10 below PERF.md's limits {limits}: {low}")
    ok = [p for p in out["pareto"] if p["recall"] >= canonical.RECALL_TARGET]
    best = max(ok, key=lambda p: p["qps"]) if ok else max(out["pareto"], key=lambda p: p["recall"])
    check(out["value"] == best["qps"] and out["best_engine"] == best["engine"],
          f"bench value {out['value']} ({out['best_engine']}) is not the best qualifying point {best}")
    check(all(out[key] and out[key] > 0 for key in ("flat_device_qps", "graph_device_qps", "graph_device_qps_i8")),
          "a device QPS of the bench is missing")
    check((out["vs_baseline"] is None) == (canonical.load_cpu_baseline() is None),
          f"vs_baseline {out['vs_baseline']} does not follow bench/cpu_baseline.json")
    missing = [name for name in ("fused_search", "fused_search_s8", "flat_topk", "flat_topk_s8")
               if not launches.get(name)]
    check(not missing, f"the bench launched no {missing}: {launches}")
    return launches


def cli_phase(dev, ds, work: str, card: str) -> tuple:
    """Phase 20: ``cli.main(["--config", config_synthetic.json])`` in the
    work directory (never the repo's tracked data/), the launch counts reset
    just before it: 24 records and no failed job; every job's two
    400-query calls (warm-up, timed) one launch each of K1 (uncompressed
    jobs, bf16 blocks) or K1-s8 (compressed jobs); every job's recall within
    0.01 of the JAX package's record of the same job (the tracked
    data/<ds_name>/data/latest.json, read only); and, on fresh engines over
    the prune_overflow=1 index file, uncompressed and compressed, the
    recall of the reused jobs at ef_search_mult=6, and K1 and K1-s8 held to
    their plain versions at the jobs' own arguments (query_expand=1, no
    entry seeds) at ef_search_mult 1 and 6.  Returns the path's launch
    counts and the holds' largest errors by kernel."""
    import contextlib

    import torch

    from expann_tpu_torch import AntitopoEngine, cli
    from expann_tpu_torch.bench.harness import score
    from expann_tpu_torch.bench.runner import canonical_job_grid
    from expann_tpu_torch.ops import _kernels

    config = os.path.join(ROOT, "config_synthetic.json")
    with open(config) as f:
        ds_name = json.load(f)["ds_name"]
    with open(os.path.join(ROOT, "data", ds_name, "data", "latest.json")) as f:
        jax_recs = json.load(f)
    log = os.path.join(work, "cli.log")
    cwd = os.getcwd()
    _kernels.launches.clear()
    t0 = time.perf_counter()
    os.chdir(work)
    try:
        with open(log, "w") as f, contextlib.redirect_stdout(f):
            rc = cli.main(["--config", config])
    finally:
        os.chdir(cwd)
    secs = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    with open(log) as f:
        log_text = f.read()
    with open(os.path.join(work, "data", ds_name, "data", "latest.json")) as f:
        recs = json.load(f)

    def job_key(r):
        p = r["param_list"]
        return int(p["ef_search_mult"]), p["use_compression"] == "1", int(p["prune_overflow"])

    jax_recall = {job_key(r): r["recall"] for r in jax_recs}
    for i, r in enumerate(recs):
        mult, compressed, po = job_key(r)
        phase("cli", job=i + 1, ef_search_mult=mult, use_compression=int(compressed), prune_overflow=po,
              recall_at_10=f"{r['recall']:.4f}", jax_record_recall_at_10=jax_recall.get(job_key(r), "null"),
              qps=f"{1e9 / r['time_per_query_ns']:.0f}", build_s=f"{r['time_to_build_ns'] / 1e9:.3f}", card=card)
    diff = {job_key(r): abs(r["recall"] - jax_recall[job_key(r)]) for r in recs if job_key(r) in jax_recall}
    phase("cli", seconds=f"{secs:.1f}", records=len(recs), recall_min=f"{min(r['recall'] for r in recs):.4f}",
          recall_max=f"{max(r['recall'] for r in recs):.4f}",
          max_recall_diff_to_jax_records=f"{max(diff.values(), default=float('nan')):.4f}")
    phase("launches", path="cli", **launches)
    check(rc == 0 and len(recs) == 24 and "Got bench error" not in log_text,
          f"the CLI returned {rc} with {len(recs)} records:\n{log_text[-3000:]}")
    per_job = 2  # one warm-up and one timed call of the 400 queries, one chunk each
    check(launches.get("fused_search") == 12 * per_job and launches.get("fused_search_s8") == 12 * per_job,
          f"the 12 uncompressed jobs did not each serve bf16 blocks (K1) and the 12 compressed s8 (K1-s8): {launches}")
    check(len(diff) == 24 and max(diff.values()) <= 0.01,
          f"recall differs from the JAX package's records of the same jobs by more than 0.01: "
          f"{ {k: v for k, v in diff.items() if v > 0.01} } ({len(diff)} of 24 jobs matched)")

    recall_of = {job_key(r): r["recall"] for r in recs}
    qg = torch.from_numpy(ds.queries).to(torch.bfloat16).to(dev).float()  # the engine's fused-route query
    errs = {}
    for compressed in (False, True):
        conf = next(c for c in canonical_job_grid(os.path.join(work, "index"))
                    if (c.ef_search_mult, c.use_compression, c.prune_overflow) == (6, compressed, 1))
        fresh = AntitopoEngine(config=conf, device=dev)
        fresh.build()  # reads the index file the sweep wrote
        fresh_recall = score(fresh, ds, fresh.query_k_batch(ds.queries, K), 0.0, 0.0).recall
        g = fresh.graph
        phase("cli", job=f"ef_search_mult=6 use_compression={int(compressed)} prune_overflow=1",
              packed_dtype=str(g.packed.dtype).split(".")[-1], recall_at_10=f"{recall_of[6, compressed, 1]:.4f}",
              fresh_engine_recall_at_10=f"{fresh_recall:.4f}")
        check(g.packed.dtype == (torch.int8 if compressed else torch.bfloat16),
              f"a fresh engine with use_compression={compressed} serves {g.packed.dtype} blocks")
        check(fresh_recall == recall_of[6, compressed, 1],
              f"a fresh engine over the sweep's index (use_compression={compressed}) gives recall {fresh_recall}, "
              f"the reused job {recall_of[6, compressed, 1]}")
        for mult in (1, 6):
            err = hold_fused(torch, "cli", g, qg, K * mult, conf.query_expand, conf.fused_cand, conf.entry_seeds,
                             ds.ground_truth)
            name = "fused_search_s8" if compressed else "fused_search"
            errs[name] = max(errs.get(name, 0.0), err)
        del fresh, g
    return launches, errs


def ortho_phase(dev, ds, card: str, ortho1_recall: dict, ortho1_adj) -> dict:
    """Phase 21: the canonical config with ``ortho_count=2`` (the penalized
    candidate passes and their union) built through AntitopoEngine on the
    card, counts reset just before it; the 400 queries through K1 at ef 100
    and 120 beside the ortho_count=1 graph's recall.  Gates: recall@10 >= 0.95
    at ef=120, no self edge, no duplicate result, K1 launched and K4 not.
    With the default ortho_bias=0 no penalty is negative, so the union is the
    plain candidate list and the rows those of phase 4's graph (printed);
    then ortho_bias=-1 against ortho_count=1 at that bias, where the passes
    must change at least 10% of the rows (printed with its recall, no
    recall gate).  Returns the path's launch counts."""
    import dataclasses

    import torch

    from expann_tpu_torch import AntitopoEngine
    from expann_tpu_torch.ops import _kernels

    def build(**over):
        eng = AntitopoEngine(config=dataclasses.replace(graph_cfg(), **over), device=dev)
        eng.store_many_vectors(ds.vecs)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng.build()
        return eng, time.perf_counter() - t0

    _kernels.launches.clear()
    eng, build_s = build(ortho_count=2)
    adj = eng.graph.adj_bottom[:N]
    check(not bool((adj == torch.arange(N, device=dev)[:, None]).any()), "the ortho_count=2 graph has self edges")
    same = int((adj == ortho1_adj[:N]).all(1).sum())
    phase("ortho", ortho_count=2, build_seconds=f"{build_s:.2f}", layers=len(eng.graph.layers),
          degree_mean=f"{float((adj < N).sum(1).float().mean()):.2f}",
          build_peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
          rows_identical_to_ortho_count_1=f"{same}/{N}", card=card)
    rec = {}
    for ef in (100, 120):
        eng.set_ef_search(ef)
        ids = eng.query_k_batch(ds.queries, K)
        check(ids.shape == (M_QUERIES, K) and rows_unique(ids), f"ortho_count=2 results at ef={ef}: shape or duplicates")
        rec[ef] = recall(ids, ds.ground_truth)
        phase("ortho", ortho_count=2, ef=ef, recall_at_10=f"{rec[ef]:.4f}",
              ortho_count_1_recall_at_10=f"{ortho1_recall[ef]:.4f}",
              distcomps_per_query=f"{eng.num_distcomps / M_QUERIES:.1f}")
    launches = dict(_kernels.launches)
    phase("launches", path="ortho", **launches)
    check(rec[120] >= 0.95, f"ortho_count=2 recall@10 at ef=120 {rec[120]} < 0.95")
    check(launches.get("fused_search", 0) > 0 and launches.get("packed_score", 0) == 0,
          f"the ortho_count=2 graph's 400-query calls did not take K1 alone: {launches}")
    del eng

    graphs = {oc: build(ortho_count=oc, ortho_bias=-1.0) for oc in (1, 2)}
    a1, a2 = (graphs[oc][0].graph.adj_bottom[:N] for oc in (1, 2))
    same = int((a1 == a2).all(1).sum())
    for oc, (eng_b, secs) in graphs.items():
        eng_b.set_ef_search(120)
        r = recall(eng_b.query_k_batch(ds.queries, K), ds.ground_truth)
        phase("ortho", ortho_count=oc, ortho_bias=-1.0, build_seconds=f"{secs:.2f}", ef=120, recall_at_10=f"{r:.4f}",
              rows_identical_between_the_two=f"{same}/{N}")
    check(same <= 0.9 * N, f"ortho_bias=-1: ortho_count=2 left {same}/{N} rows as ortho_count=1's")
    return launches


def adjacency_invariants(torch, adj, n: int, cap: int) -> dict:
    """The bottom rows ``adj`` (n, R) of a built graph: no self edge, no
    duplicate, the sentinel n only after a row's last edge, 1..cap edges a
    row.  Raises on a breach; returns the degree summary."""
    real = adj < n
    check(bool((adj <= n).all()) and bool((adj >= 0).all()), "adjacency ids out of range")
    check(not bool((adj == torch.arange(n, device=adj.device)[:, None]).any()), "a row holds its own id")
    s = torch.sort(adj, dim=1).values
    check(not bool(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] < n)).any()), "a row holds an id twice")
    check(not bool((real[:, 1:] & ~real[:, :-1]).any()), "a sentinel before a row's last edge")
    deg = real.sum(1)
    check(int(deg.min()) >= 1 and int(deg.max()) <= cap, f"degrees {int(deg.min())}..{int(deg.max())} outside 1..{cap}")
    return dict(degree_min=int(deg.min()), degree_max=int(deg.max()), degree_mean=f"{float(deg.float().mean()):.2f}")


def million_phase(torch, dev, card: str) -> dict:
    """Phase 22: the million-row path.  ``generate_synthetic_clustered(
    MILLION_N, 400, 128, seed=0)`` (the hardened mixture), exact ground
    truth on the card, then ``build_index`` on the auto route (above
    ``auto_wave_threshold``: the distributed one-shot builder, flat
    candidates through K2) with M=48, efc = prune_cand = 300, counts reset
    just before it: build seconds per stage (the builder prints them), peak
    device memory, exactly waves x n_seg K2 launches; K2 held to its plain
    version on the first wave's first segment and timed there beside its
    bound and the library chain; the graph's invariants.  Then, counts
    reset again, serving: s8 blocks at ef 40 / 80 / 120 (expand 2, cand 8,
    8 entry seeds), recall@10 >= 0.98 at ef=80; flat ``fused`` >= 0.99 and
    ``fused_i8`` >= 0.97; host-clock QPS of each.  Then, after the counts
    are read, K1-s8 on the million-row s8 layout, K2 over the 1M rows at
    k=10 and K2-s8 over the 1M codes at k=30, each held to its plain
    version on the 400 queries.  Returns the two paths' launch counts, K2's
    times at the build shape and each kernel's largest error."""
    from expann_tpu_torch.data.loader import generate_synthetic_clustered
    from expann_tpu_torch.models.brute_force import BruteForceEngine
    from expann_tpu_torch.models.build import BuildConfig, build_index
    from expann_tpu_torch.ops import _kernels
    from expann_tpu_torch.ops.topk import flat_topk_cuda, flat_topk_plain, quantize_query_i8
    from expann_tpu_torch.parallel.distbuild import flat_segments
    from expann_tpu_torch.tools.bench_1m import flat_point, graph_engine, graph_point
    from expann_tpu_torch.utils.profiling import event_ms

    n, M, efc, W = MILLION_N, 48, 300, 4096
    t0 = time.perf_counter()
    x, q = generate_synthetic_clustered(n, M_QUERIES, D, seed=0)
    bf = BruteForceEngine(mode="exact", batch_size=100, device=dev)
    bf.store_many_vectors(x)
    bf.build()
    gt = bf.query_k_batch(q, K)
    del bf
    phase("million", n=n, d=D, queries=M_QUERIES, data="clustered hardened seed=0",
          data_and_truth_seconds=f"{time.perf_counter() - t0:.1f}")

    cfg = BuildConfig(M=M, ef_construction=efc, prune_cand=efc)
    check(n > cfg.auto_wave_threshold, f"n={n} does not take the distributed route")
    _kernels.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph = build_index(x, cfg, dev, verbose=True)
    build_s = time.perf_counter() - t0
    build_launches = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    seg_rows, kk = flat_segments(n, efc)
    n_seg = (n + seg_rows - 1) // seg_rows
    waves = (n + W - 1) // W
    phase("million", build_seconds=f"{build_s:.1f}", peak_gib=f"{peak:.2f}", layers=len(graph.layers),
          waves=waves, segments=n_seg, k=kk, card=card)
    phase("launches", path="million_build", **build_launches)
    check(build_launches == {"flat_topk": waves * n_seg},
          f"the build launched {build_launches}, not exactly {waves} x {n_seg} K2 calls")
    inv = adjacency_invariants(torch, graph.adj_bottom[:n], n, 2 * M)
    phase("million", **inv)

    # K2 on the first wave's first segment: the shape the build gives it
    wq = graph.vectors[:W]
    xs = graph.vectors[:seg_rows].to(torch.bfloat16)
    err = hold_flat_bf16(torch, "million_scan", flat_topk_cuda, wq, xs, kk)
    ms = event_ms(lambda: flat_topk_cuda(wq, xs, kk), reps=5)
    plain_ms = event_ms(lambda: flat_topk_plain(wq, xs, kk), reps=1)
    qb = wq.to(torch.bfloat16)
    xn = (xs.float() ** 2).sum(1)

    def chain():  # one bf16 product with f32 results, then top-k
        return torch.topk(xn - 2.0 * torch.mm(qb, xs.T, out_dtype=torch.float32), kk, dim=1, largest=False)

    lib_ms = event_ms(chain, reps=5)
    b = bound(seg_rows * D * 2 + W * D * 2 + W * kk * 8, 2.0 * W * seg_rows * D)
    build_times = dict(build_ms=ms, build_plain_ms=plain_ms, build_library_ms=lib_ms, build_bound_ms=b[0],
                       build_bound_by=b[1], build_launches=build_launches["flat_topk"])
    phase("times", kernel="flat_topk", path="million_build", B=W, n=seg_rows, k=kk, ms=f"{ms:.3f}",
          plain_ms=f"{plain_ms:.3f}", library_ms=f"{lib_ms:.3f}", vs_library=f"{lib_ms / ms:.2f}x",
          bound_ms=f"{b[0]:.4f}", bound_by=b[1],
          achieved_tflops=f"{2.0 * W * seg_rows * D / (ms * 1e-3) / 1e12:.1f}", card=card)
    del wq, xs, qb, xn

    _kernels.launches.clear()
    rng = np.random.default_rng(99)
    eng = graph_engine(graph, D, M, 8192, "bf16", dev)
    rec = {}
    for ef in (40, 80, 120):
        pt = graph_point(eng, q, gt, 2, ef, 8, "i8", rng, QPS_QUERIES // 2)
        rec[ef] = pt["recall"]
        phase("million", **pt, card=card)
    flat, flat_eng = {}, {}
    for mode in ("fused", "fused_i8"):
        pt, flat_eng[mode] = flat_point(x, q, gt, mode, "bf16", rng, FLAT_CHUNK, dev)
        flat[mode] = pt["recall"]
        phase("million", **pt, card=card)
    serve_launches = dict(_kernels.launches)
    phase("launches", path="million_serve", **serve_launches)
    check(rec[80] >= 0.98, f"million-row recall@10 on s8 blocks at ef=80 {rec[80]} < 0.98")
    check(flat["fused"] >= 0.99, f"million-row flat recall@10 {flat['fused']} < 0.99")
    check(flat["fused_i8"] >= 0.97, f"million-row flat fused_i8 recall@10 {flat['fused_i8']} < 0.97")
    check(all(serve_launches.get(k, 0) > 0 for k in ("fused_search_s8", "flat_topk", "flat_topk_s8")),
          f"a kernel of the million-row serving path was never launched: {serve_launches}")

    # the serving kernels against their plain versions at the shapes this
    # path gives them: K1-s8 on the million-row s8 layout (R0 = 96 slots a
    # block), K2 over the 1M bf16 rows at k=10, K2-s8 over the 1M codes at
    # fused_i8's scan width
    qg = torch.from_numpy(q).to(torch.bfloat16).to(dev).float()
    s8_err = hold_fused(torch, "million_s8", eng.graph, qg, 80, 2, 8, 8, gt)
    del eng, graph
    fe = flat_eng["fused"]
    flat_err = hold_flat_bf16(torch, "million_flat", flat_topk_cuda, qg.to(torch.bfloat16), fe._x_fused, K)
    fe = flat_eng["fused_i8"]
    q8 = torch.from_numpy(quantize_query_i8(q, fe._i8_center, fe._i8_scale)).to(dev)
    flat_s8_err = hold_flat_s8(torch, "million_flat_s8", flat_topk_cuda, q8, fe._x_fused,
                               min(fe.rerank_mult * K, 128))
    del flat_eng, fe
    return dict(build=build_launches, serve=serve_launches, err=err, times=build_times, s8_err=s8_err,
                flat_err=flat_err, flat_s8_err=flat_s8_err)


def wave_phase(torch, dev, ds, card: str, oneshot_recall: dict) -> dict:
    """Phase 23: the wave builders on the canonical corpus through
    AntitopoEngine, counts reset just before the path and read after its
    last query.  (a) builder="wave" (waves of 1024): stage seconds, waves,
    beam iterations a wave, peak memory, the adjacency invariants, no kernel
    launched by the build; recall@10 at ef 100 / 120 through K1 beside
    phase 4's one-shot graph (>= 0.90 at ef=120), K4 not launched; 32-query
    calls through K4 whose ids equal one-query calls; s8 blocks at ef=120
    through K1-s8 (>= 0.90).  (b) store -> build -> store -> build, 28000 +
    28000 rows, the first build one-shot ("auto"), the second by waves: n,
    the invariants, answers from both halves, recall@10 at ef=120 >= 0.90.
    (c) refine_index_wave(frac=0.5) on (a)'s graph: seconds, invariants,
    recall@10 at ef=120 no more than 0.01 below (a)'s.  (d) the first 16384
    rows, wave builds at ortho_count 1 and 2 and ortho_bias 0 and -1: the
    rows the two counts share at each bias, and recall (printed).  Then,
    after the counts are read, K1 and K4 on (a)'s bf16 layout and K1-s8 on
    its s8 layout, each held to its plain version.  Returns the path's
    launch counts and each held kernel's largest error."""
    import dataclasses

    from expann_tpu_torch import AntitopoEngine, BruteForceEngine
    from expann_tpu_torch.models.search import _earlier_dup
    from expann_tpu_torch.models.wavebuild import refine_index_wave
    from expann_tpu_torch.ops import _kernels
    from expann_tpu_torch.ops.packed import build_packed
    from expann_tpu_torch.utils.profiling import event_ms

    cfg = graph_cfg()
    M0 = cfg.M0

    def engine(**over):
        return AntitopoEngine(config=dataclasses.replace(cfg, **over), device=dev)

    def serve(eng, ef: int, gt=ds.ground_truth) -> tuple:
        eng.set_ef_search(ef)
        ids = eng.query_k_batch(ds.queries, K)
        check(ids.shape == (M_QUERIES, K) and rows_unique(ids), f"wave path results at ef={ef}: shape or duplicates")
        return ids, recall(ids, gt)

    def timed_build(eng) -> float:
        t0 = time.perf_counter()
        eng.build()
        return time.perf_counter() - t0

    def stage_seconds(st: dict) -> dict:
        it = st["wave_iterations"]
        return dict(**{f"{k}_s": f"{v:.2f}" for k, v in st["seconds"].items()}, waves=st["waves"],
                    iterations_mean=f"{np.mean(it):.1f}" if it else 0, iterations_max=max(it, default=0),
                    swept_rows=st["swept_rows"])

    # (a) the wave build and its serving routes
    _kernels.launches.clear()
    eng = engine(builder="wave")
    eng.store_many_vectors(ds.vecs)
    torch.cuda.reset_peak_memory_stats()
    build_s = timed_build(eng)
    peak = torch.cuda.max_memory_allocated() / 2**30
    build_launches = dict(_kernels.launches)
    phase("wave", builder="wave", wave_size=cfg.wave_size, build_seconds=f"{build_s:.2f}",
          **stage_seconds(eng.build_stats), peak_gib=f"{peak:.2f}", layers=len(eng.graph.layers), card=card)
    check(not build_launches, f"the wave build launched a kernel: {build_launches}")
    phase("wave", **adjacency_invariants(torch, eng.graph.adj_bottom[:N], N, M0))
    # the construction beam's dedup at the wave's shape: the sort-based
    # first-occurrence mask of models/search against the all-pairs masks the
    # JAX package builds (search.py:270-276), on ids with many repeats
    B, ef_c, kn = cfg.wave_size, cfg.ef_construction, cfg.wave_expand * ((M0 + 64 + 15) // 16 * 16)
    gen = torch.Generator(device=dev).manual_seed(5)
    beam = torch.randint(0, 4000, (B, ef_c), generator=gen, device=dev, dtype=torch.int32)
    nbrs = torch.randint(0, 4000, (B, kn), generator=gen, device=dev, dtype=torch.int32)
    earlier = torch.ones((kn, kn), dtype=torch.bool, device=dev).tril(-1)

    def all_pairs():
        in_beam = (nbrs[:, :, None] == beam[:, None, :]).any(-1)
        return in_beam | ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier).any(-1)

    def by_sort():
        return _earlier_dup(torch.cat([beam, nbrs], 1))[:, ef_c:]

    check(bool(torch.equal(all_pairs(), by_sort())), "the sort-based dedup mask differs from the all-pairs one")
    phase("wave", dedup_B=B, ef=ef_c, neighbours=kn, sort_ms=f"{event_ms(by_sort, reps=10):.3f}",
          all_pairs_ms=f"{event_ms(all_pairs, reps=10):.3f}", card=card)
    del beam, nbrs, earlier
    rec = {}
    for ef in (100, 120):
        _, rec[ef] = serve(eng, ef)
        phase("wave", ef=ef, recall_at_10=f"{rec[ef]:.4f}", oneshot_recall_at_10=f"{oneshot_recall[ef]:.4f}",
              distcomps_per_query=f"{eng.num_distcomps / M_QUERIES:.1f}")
    batched = dict(_kernels.launches)
    check(batched.get("fused_search", 0) > 0 and batched.get("packed_score", 0) == 0,
          f"the wave graph's 400-query calls did not take K1 alone: {batched}")
    check(rec[120] >= 0.90, f"wave graph recall@10 at ef=120 {rec[120]} < 0.90")
    nq = 2 * SMALL_CHUNK
    single = np.concatenate([eng.query_k_batch(ds.queries[i : i + 1], K) for i in range(nq)])
    chunked = np.concatenate([eng.query_k_batch(ds.queries[s : s + SMALL_CHUNK], K)
                              for s in range(0, nq, SMALL_CHUNK)])
    n_same = int((single == chunked).all(1).sum())
    small = dict(_kernels.launches)
    phase("wave", route="per_iteration", ef=120, queries=nq, rows_identical=f"{n_same}/{nq}",
          recall_at_10=f"{recall(single, ds.ground_truth[:nq]):.4f}")
    check(n_same == nq, f"wave graph: 32-query calls differ from one-query calls on {nq - n_same} rows")
    check(small.get("packed_score", 0) > 0 and small.get("fused_search", 0) == batched["fused_search"],
          f"the wave graph's small batches did not take K4 alone: {small}")
    eng.cfg.use_compression = True  # bench.py's flip: s8 blocks on the built graph
    eng._attach_codes()
    _, rec_s8 = serve(eng, 120)
    phase("wave", packed_dtype="i8", ef=120, recall_at_10=f"{rec_s8:.4f}",
          distcomps_per_query=f"{eng.num_distcomps_compressed / M_QUERIES:.1f}")
    check(rec_s8 >= 0.90, f"wave graph recall@10 on s8 blocks at ef=120 {rec_s8} < 0.90")
    check(_kernels.launches.get("fused_search_s8", 0) > 0, f"K1-s8 never launched: {dict(_kernels.launches)}")
    wave_graph = eng.graph
    del eng

    # (b) store -> build -> store -> build: one-shot, then waves
    eng = engine()
    eng.store_many_vectors(ds.vecs[: N // 2])
    first_s = timed_build(eng)
    eng.store_many_vectors(ds.vecs[N // 2 :])
    second_s = timed_build(eng)
    phase("wave", part="extend", first_rows=N // 2, first_build_seconds=f"{first_s:.2f}",
          extend_seconds=f"{second_s:.2f}", **stage_seconds(eng.build_stats), n=eng.n)
    check(eng.n == N and eng.graph.n == N, f"the extended index holds {eng.n} rows, not {N}")
    phase("wave", part="extend", **adjacency_invariants(torch, eng.graph.adj_bottom[:N], N, M0))
    ids, rec_ext = serve(eng, 120)
    phase("wave", part="extend", ef=120, recall_at_10=f"{rec_ext:.4f}",
          ids_from_first_half=int((ids < N // 2).sum()), ids_from_second_half=int((ids >= N // 2).sum()))
    check(rec_ext >= 0.90, f"extended index recall@10 at ef=120 {rec_ext} < 0.90")
    check(bool((ids < N // 2).any()) and bool((ids >= N // 2).any()), "the extended index answers from one half")
    del eng

    # (c) refinement of (a)'s graph
    eng = engine()
    t0 = time.perf_counter()
    st = {}
    refined = refine_index_wave(wave_graph, eng._build_config(), frac=0.5, stats=st)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    phase("wave", part="refine", frac=0.5, seconds=f"{refine_s:.2f}", **stage_seconds(st))
    phase("wave", part="refine", **adjacency_invariants(torch, refined.adj_bottom[:N], N, M0))
    eng.graph, eng.n, eng.dim = refined, N, D
    _, rec_ref = serve(eng, 120)
    phase("wave", part="refine", ef=120, recall_at_10=f"{rec_ref:.4f}", unrefined_recall_at_10=f"{rec[120]:.4f}")
    check(rec_ref >= rec[120] - 0.01, f"refinement lost recall: {rec_ref} against {rec[120]}")
    del eng, refined

    # (d) the ortho passes in beam form, on the first WAVE_ORTHO_N rows
    n4 = WAVE_ORTHO_N
    bf = BruteForceEngine(mode="exact", device=dev)
    bf.store_many_vectors(ds.vecs[:n4])
    bf.build()
    gt4 = bf.query_k_batch(ds.queries, K)
    del bf
    adjs = {}
    for bias in (0.0, -1.0):
        for oc in (1, 2):
            eng = engine(builder="wave", ortho_count=oc, ortho_bias=bias)
            eng.store_many_vectors(ds.vecs[:n4])
            secs = timed_build(eng)
            adjs[oc] = eng.graph.adj_bottom[:n4]
            adjacency_invariants(torch, adjs[oc], n4, M0)
            _, r = serve(eng, 120, gt4)
            phase("wave", part="ortho", n=n4, ortho_count=oc, ortho_bias=bias, build_seconds=f"{secs:.2f}",
                  iterations_mean=f"{np.mean(eng.build_stats['wave_iterations']):.1f}", ef=120,
                  recall_at_10=f"{r:.4f}")
            del eng
        same = int((adjs[1] == adjs[2]).all(1).sum())
        phase("wave", part="ortho", n=n4, ortho_bias=bias, rows_shared_by_counts_1_and_2=f"{same}/{n4}",
              share=f"{same / n4:.4f}", card=card)
    launches = dict(_kernels.launches)
    phase("launches", path="wave", **launches)

    # the path's kernels against their plain versions on (a)'s layouts
    qg = torch.from_numpy(ds.queries).to(torch.bfloat16).to(dev).float()
    err = {"fused_search_s8": hold_fused(torch, "wave_s8", wave_graph, qg, 120, cfg.query_expand,
                                         cfg.fused_cand, cfg.entry_seeds, ds.ground_truth)}
    g = dataclasses.replace(wave_graph, packed_codes=None, packed_code_norms=None, packed_center=None,
                            packed_scale=None)
    g.packed, g.packed_norms, g.packed_ids = build_packed(g.vectors, g.norms, g.adj_bottom)
    err["fused_search"] = hold_fused(torch, "wave", g, qg, 120, cfg.query_expand, cfg.fused_cand, cfg.entry_seeds,
                                     ds.ground_truth)
    rng = np.random.default_rng(23)
    sel = torch.from_numpy(rng.integers(0, N, (M_QUERIES, 2)).astype(np.int32)).to(dev)
    sel[::5, 1] = N
    q400 = torch.from_numpy(ds.queries).to(dev)
    err["packed_score"] = max(hold_packed(torch, "wave", (g.packed, g.packed_norms, g.packed_ids), sel, q400, t)
                              for t in (0, cfg.packed_topt))
    del g, wave_graph
    return dict(launches=launches, err=err)


def sharded_phase(torch, dev, ds, card: str, g, graph_recall: dict) -> dict:
    """Phase 24: the multi-device layer on a mesh of SHARDS devices, the
    visible cards round-robin (one card: SHARDS shards on it), counts reset
    just before each step and read just after.  (a) tools/dryrun_multichip.
    (b) build_sharded of the canonical corpus at bench.py's build config:
    seconds, peak, levels a shard, no kernel.  (c) pack_sharded and
    sharded_packed_query at ef 100 / 120 on the 400 queries: recall@10
    beside phase 4's, >= 0.95 at ef=120, ids unique and below n, exactly S
    K1 launches a call; shard 0's K1 call held to its plain version (>= 99%
    of beams identical); QPS on 65536 fresh queries, median of 3.  (d)
    sharded_flat_query on 16384 queries: exactly S K2 launches, ids equal
    to K2 over the whole bf16 corpus except on ties (all counted, all
    ties), recall on the 400 queries >= 0.99; shard 0's K2 call held to its
    plain version; the S shard calls' time beside one call's; QPS.  (e) replicated_fused_query_dp on phase 4's graph,
    65536 queries at ef=120: exactly S K1 launches, ids identical to one
    fused_query_batch call; QPS beside that call's.  (f) sharded_build_step
    on the first SHARD_WAVE canonical rows at C = prune_cand, cap = M0:
    top-C lists and pruned rows against the one-shard call, >= 99% of rows
    identical.  (g) build_distributed on the mesh: the canonical corpus
    with dense candidates against the one-device build (>= 95% of rows
    identical, recall@10 at ef=120 within 0.01), then SHARD_FLAT_N rows of
    the clustered data with flat candidates, M=48, efc = prune_cand = 300:
    exactly waves x S x n_seg K2 launches and nothing else, seconds, peak,
    s8 recall@10 at ef=80 >= 0.98.  Returns the launch counts and the held
    errors."""
    import dataclasses

    from expann_tpu_torch import AntitopoEngine, BruteForceEngine
    from expann_tpu_torch.data.loader import generate_synthetic_clustered
    from expann_tpu_torch.models.build import BuildConfig
    from expann_tpu_torch.models.graph import make_corpus
    from expann_tpu_torch.models.search import fused_query_batch
    from expann_tpu_torch.ops import _kernels
    from expann_tpu_torch.ops.packed import build_packed
    from expann_tpu_torch.ops.topk import flat_topk, flat_topk_cuda
    from expann_tpu_torch.parallel.distbuild import build_distributed, flat_segments
    from expann_tpu_torch.parallel.sharded import (
        build_sharded,
        build_sharded_flat,
        pack_sharded,
        replicated_fused_query_dp,
        sharded_build_step,
        sharded_candidates,
        sharded_flat_query,
        sharded_packed_query,
    )
    from expann_tpu_torch.tools.bench_1m import graph_engine, graph_point
    from expann_tpu_torch.tools.dryrun_multichip import dryrun_multichip, round_robin
    from expann_tpu_torch.utils.profiling import event_ms

    cfg = graph_cfg()
    mesh = round_robin(SHARDS)
    S = len(mesh)
    rng = np.random.default_rng(24)
    launches, err = {}, {}
    phase("sharded", shards=S, devices=",".join(str(d) for d in mesh), card=card)

    def counted(fn):
        _kernels.launches.clear()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(_kernels.launches)

    def median_qps(fn, B: int) -> tuple:
        runs = []
        for _ in range(3):
            batch = rng.standard_normal((B, D)).astype(np.float32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(batch)  # returns host arrays: the device work is done
            runs.append(B / (time.perf_counter() - t0))
        return float(np.median(runs)), runs

    # (a) the dryrun at its tiny sizes
    t0 = time.perf_counter()
    out, launches["dryrun"] = counted(lambda: dryrun_multichip(mesh))
    phase("sharded", part="dryrun", seconds=f"{time.perf_counter() - t0:.2f}", **out)
    phase("launches", path="sharded_dryrun", **launches["dryrun"])

    # (b) the sharded index at bench.py's build config
    bcfg = AntitopoEngine(config=cfg, device=dev)._build_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx, build_l = counted(lambda: build_sharded(ds.vecs, bcfg, mesh))
    phase("sharded", part="build_sharded", n=N, n_shard=idx.n_shard, seconds=f"{time.perf_counter() - t0:.2f}",
          peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
          levels=",".join(str(len(sh.layers)) for sh in idx.shards), card=card)
    check(build_l == {}, f"build_sharded launched a kernel: {build_l}")

    # (c) the per-shard fused traversal, K1 once a shard a call
    pidx = pack_sharded(idx)
    del idx
    rec = {}
    for ef in (100, 120):
        ids, launches[f"packed_ef{ef}"] = counted(lambda: sharded_packed_query(
            pidx, ds.queries, K, ef, expand=cfg.query_expand, cand=cfg.fused_cand))
        check(ids.shape == (M_QUERIES, K) and rows_unique(ids) and bool(((ids >= 0) & (ids < N)).all()),
              f"sharded_packed_query at ef={ef}: shape, duplicates or ids outside [0, n)")
        check(launches[f"packed_ef{ef}"] == {"fused_search": S},
              f"sharded_packed_query launched {launches[f'packed_ef{ef}']}, not {S} K1 calls")
        rec[ef] = recall(ids, ds.ground_truth)
        phase("sharded", part="packed", ef=ef, expand=cfg.query_expand, cand=cfg.fused_cand,
              recall_at_10=f"{rec[ef]:.4f}", single_graph_recall_at_10=f"{graph_recall[ef]:.4f}",
              k1_launches=launches[f"packed_ef{ef}"]["fused_search"])
    check(rec[120] >= 0.95, f"sharded recall@10 at ef=120 {rec[120]} < 0.95")
    qg = torch.from_numpy(ds.queries).to(dev)
    err["fused_search"] = hold_fused(torch, "sharded_shard0", pidx.shards[0], qg, 120, cfg.query_expand,
                                     cfg.fused_cand, 0, ds.ground_truth, min_identical=0.99)
    qps, runs = median_qps(lambda b: sharded_packed_query(pidx, b, K, 120, expand=cfg.query_expand,
                                                          cand=cfg.fused_cand), QPS_QUERIES)
    phase("sharded", part="packed", ef=120, queries=QPS_QUERIES, qps_median=f"{qps:.0f}",
          qps=",".join(f"{v:.0f}" for v in runs), card=card)
    shard_corpus = [(sh.vectors, sh.norms) for sh in pidx.shards]  # (f)'s corpus
    del pidx

    # (d) the per-shard flat scan, K2 once a shard a call
    flat = build_sharded_flat(ds.vecs, mesh)
    qf = rng.standard_normal((FLAT_CHUNK, D)).astype(np.float32)
    ids, launches["flat"] = counted(lambda: sharded_flat_query(flat, qf, K))
    check(launches["flat"] == {"flat_topk": S}, f"sharded_flat_query launched {launches['flat']}, not {S} K2 calls")
    xall = torch.from_numpy(ds.vecs).to(dev, torch.bfloat16)
    qt = torch.from_numpy(qf).to(dev)
    one_ids, one_d = flat_topk(qt, xall, K)
    one_ids = one_ids.cpu().numpy()
    diff = ids != one_ids
    qb, xb = qt.to(torch.bfloat16).float(), xall.float()
    got_d = ((qb[:, None, :] - xb[torch.from_numpy(ids).to(dev).long()]) ** 2).sum(-1)
    gap = (got_d - one_d).abs().cpu().numpy()
    tie_gap = float(gap[diff].max()) if diff.any() else 0.0
    flat_rec = recall(sharded_flat_query(flat, ds.queries, K), ds.ground_truth)
    phase("sharded", part="flat", B=FLAT_CHUNK, k=K, ids_differing=int(diff.sum()),
          rows_differing=int(diff.any(1).sum()), worst_tie_gap=f"{tie_gap:.3e}", recall_at_10=f"{flat_rec:.4f}",
          k2_launches=launches["flat"]["flat_topk"])
    check(tie_gap <= 1e-2, f"sharded flat ids differ from one K2 call where the distances do not tie ({tie_gap})")
    check(flat_rec >= 0.99, f"sharded flat recall@10 {flat_rec} < 0.99")
    err["flat_topk"] = hold_flat_bf16(torch, "sharded_flat_shard0", flat_topk_cuda, qt, flat.x[0], K)
    shard_ms = event_ms(lambda: [flat_topk_cuda(qt, xs, K) for xs in flat.x], reps=5)
    one_ms = event_ms(lambda: flat_topk_cuda(qt, xall, K), reps=5)
    phase("times", kernel="flat_topk", path="sharded_flat", B=FLAT_CHUNK, n_shard=flat.n_shard, k=K,
          shards_ms=f"{shard_ms:.3f}", one_call_ms=f"{one_ms:.3f}", card=card)
    qps, runs = median_qps(lambda b: sharded_flat_query(flat, b, K), QPS_QUERIES)
    phase("sharded", part="flat", queries=QPS_QUERIES, qps_median=f"{qps:.0f}", qps=",".join(f"{v:.0f}" for v in runs),
          card=card)
    del flat, xall, qt, qb, xb, got_d

    # (e) data-parallel serving on phase 4's graph (bf16 blocks)
    gb = dataclasses.replace(g, packed_codes=None, packed_code_norms=None, packed_center=None, packed_scale=None)
    gb.packed, gb.packed_norms, gb.packed_ids = build_packed(gb.vectors, gb.norms, gb.adj_bottom)
    kw = dict(expand=cfg.query_expand, cand=cfg.fused_cand, seeds=cfg.entry_seeds, ef_cap=128)
    qr = rng.standard_normal((QPS_QUERIES, D)).astype(np.float32)
    dp, launches["dp"] = counted(lambda: replicated_fused_query_dp(gb, qr, K, 120, mesh, **kw))
    whole = fused_query_batch(gb, torch.from_numpy(qr).to(dev), 120, K, **kw)[0].cpu().numpy()
    n_same = int((dp == whole).all(1).sum())
    check(launches["dp"] == {"fused_search": S}, f"replicated_fused_query_dp launched {launches['dp']}")
    check(n_same == QPS_QUERIES, f"replicated DP ids differ from one fused_query_batch call on "
                                 f"{QPS_QUERIES - n_same} rows")
    qps, runs = median_qps(lambda b: replicated_fused_query_dp(gb, b, K, 120, mesh, **kw), QPS_QUERIES)
    one_qps, one_runs = median_qps(
        lambda b: fused_query_batch(gb, torch.from_numpy(b).to(dev), 120, K, **kw)[0].cpu().numpy(), QPS_QUERIES)
    phase("sharded", part="replicated_dp", ef=120, queries=QPS_QUERIES, rows_identical=f"{n_same}/{QPS_QUERIES}",
          qps_median=f"{qps:.0f}", qps=",".join(f"{v:.0f}" for v in runs), one_call_qps_median=f"{one_qps:.0f}",
          one_call_qps=",".join(f"{v:.0f}" for v in one_runs), k1_launches=launches["dp"]["fused_search"], card=card)
    del gb, dp, whole

    # (f) one sharded construction step against the one-shard call
    ns = shard_corpus[0][0].shape[0] - 1
    v_parts, n_parts = [v for v, _ in shard_corpus], [nm for _, nm in shard_corpus]
    vf, nf = make_corpus(ds.vecs, dev)
    wave = vf[:SHARD_WAVE]
    C, cap = bcfg.prune_cand, bcfg.M0
    t0 = time.perf_counter()
    c_ids, c_d = sharded_candidates(v_parts, n_parts, wave, C, ns, mesh)
    o_ids, o_d = sharded_candidates([vf], [nf], wave, C, N, (dev,))
    same_c = int(((c_ids == o_ids) | ((c_ids < 0) & (o_ids < 0))).all(1).sum())
    step = dict(C=C, cap=cap, ortho_factor=bcfg.ortho_factor, ortho_bias=bcfg.ortho_bias,
                prune_overflow=bcfg.prune_overflow)
    (sel, _), launches["build_step"] = counted(lambda: sharded_build_step(v_parts, n_parts, wave, n_shard=ns,
                                                                           mesh=mesh, **step))
    one_sel, _ = sharded_build_step([vf], [nf], wave, n_shard=N, mesh=(dev,), **step)
    sel = torch.where(sel >= N, N, sel)  # both sentinels as n
    same_p = int((sel == one_sel).all(1).sum())
    phase("sharded", part="build_step", wave=SHARD_WAVE, C=C, cap=cap, topc_rows_identical=f"{same_c}/{SHARD_WAVE}",
          pruned_rows_identical=f"{same_p}/{SHARD_WAVE}", seconds=f"{time.perf_counter() - t0:.2f}")
    check(same_c >= 0.99 * SHARD_WAVE and same_p >= 0.99 * SHARD_WAVE,
          f"sharded build step: {same_c} top-C rows and {same_p} pruned rows of {SHARD_WAVE} identical (< 99%)")
    check(launches["build_step"] == {}, f"the build step launched a kernel: {launches['build_step']}")
    del shard_corpus, v_parts, n_parts, vf, nf, c_ids, c_d, o_ids, o_d, sel, one_sel

    # (g) one global graph over the mesh: the canonical corpus (dense), then
    # SHARD_FLAT_N clustered rows (flat candidates through K2)
    def serve(graph) -> float:
        eng = AntitopoEngine(config=cfg, device=dev)
        eng.graph, eng.n, eng.dim = graph, graph.n, D
        eng.set_ef_search(120)
        ids = eng.query_k_batch(ds.queries, K)
        check(rows_unique(ids), "distributed graph: duplicate ids")
        return recall(ids, ds.ground_truth)

    built = {}
    for label, where in (("mesh", mesh), ("one_device", dev)):
        t0 = time.perf_counter()
        (graph, st), built[label + "_launches"] = counted(
            lambda: build_distributed(ds.vecs, bcfg, where, candidates="dense"))
        built[label] = (graph, st, time.perf_counter() - t0)
    (gm, sm, tm), (g1, s1, t1) = built["mesh"], built["one_device"]
    same = int((gm.adj_bottom == g1.adj_bottom).all(1).sum())
    r_m, r_1 = serve(gm), serve(g1)
    phase("sharded", part="distributed_dense", n=N, n_shards=sm["n_shards"], n_shard=sm["n_shard"], waves=sm["waves"],
          seconds=f"{tm:.2f}", one_device_seconds=f"{t1:.2f}", rows_identical=f"{same}/{N + 1}",
          recall_at_10=f"{r_m:.4f}", one_device_recall_at_10=f"{r_1:.4f}",
          **{f"{k}_s": f"{v:.2f}" for k, v in sm["seconds"].items()}, card=card)
    check(sm["n_shards"] == S and s1["n_shards"] == 1, f"n_shards {sm['n_shards']} / {s1['n_shards']}")
    check(built["mesh_launches"] == {} and built["one_device_launches"] == {}, "a dense distributed build launched a kernel")
    check(same >= 0.95 * (N + 1), f"distributed dense build over {S} shards: {same}/{N + 1} rows identical (< 95%)")
    check(abs(r_m - r_1) <= 0.01, f"distributed recall@10 over {S} shards {r_m} vs one device {r_1}")
    del built, gm, g1

    n, M, efc, W = SHARD_FLAT_N, 48, 300, 4096
    t0 = time.perf_counter()
    x, q = generate_synthetic_clustered(n, M_QUERIES, D, seed=0)
    bf = BruteForceEngine(mode="exact", batch_size=100, device=dev)
    bf.store_many_vectors(x)
    bf.build()
    gt = bf.query_k_batch(q, K)
    del bf
    data_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (graph, st), launches["dist_flat"] = counted(lambda: build_distributed(
        x, BuildConfig(M=M, ef_construction=efc, prune_cand=efc), mesh, wave_size=W, candidates="flat"))
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    ns = st["n_shard"]
    seg_rows, kk = flat_segments(ns, efc)
    n_seg = (ns + seg_rows - 1) // seg_rows
    waves = (n + W - 1) // W
    inv = adjacency_invariants(torch, graph.adj_bottom[:n], n, 2 * M)
    pt = graph_point(graph_engine(graph, D, M, 16384, "bf16", dev), q, gt, 2, 80, 8, "i8", rng, 0)
    phase("sharded", part="distributed_flat", n=n, n_shards=st["n_shards"], n_shard=ns, waves=waves, segments=n_seg,
          k=kk, build_seconds=f"{build_s:.2f}", data_and_truth_seconds=f"{data_s:.1f}", peak_gib=f"{peak:.2f}",
          **{f"{k}_s": f"{v:.2f}" for k, v in st["seconds"].items()}, s8_recall_at_10_ef80=f"{pt['recall']:.4f}",
          **inv, card=card)
    phase("launches", path="sharded_distributed_flat", **launches["dist_flat"])
    check(st["candidates"] == "flat" and launches["dist_flat"] == {"flat_topk": waves * S * n_seg},
          f"the distributed flat build launched {launches['dist_flat']}, not exactly {waves} x {S} x {n_seg} K2 calls")
    check(pt["recall"] >= 0.98, f"distributed flat graph s8 recall@10 at ef=80 {pt['recall']} < 0.98")
    for path in ("packed_ef100", "packed_ef120", "flat", "dp", "build_step"):
        phase("launches", path=f"sharded_{path}", **launches[path])
    return dict(launches=launches, err=err)


def bigflat_phase(torch, dev, card: str) -> dict:
    """Phase 25: tens of millions of flat rows (tools/bench_bigflat.py) at
    BIGFLAT_N rows: the tool's corpus (``gen_corpus``, numpy seed 0) and
    its 100 held-out queries (seed 1), exact f32 ground truth by the plain
    version on the card (``flat_topk_plain`` on the f32 corpus, in column
    blocks); ``BruteForceEngine(mode="fused")``
    answers the 100 queries inside one call of BIGFLAT_B (so K2's grid
    fills the card), counts reset just before it: exactly one K2 launch,
    recall@10 >= 0.99, at least one id >= 2^24.  Then K2 held to its plain
    version on the 100 queries (ids identical but on ties), K2-s8 on s8
    codes of the same n made on the card, 128 queries at k=30 (identical);
    K2's ms per 16384-query call beside its bound and the library chain
    (bf16 products with f32 results, ``topk`` per column block, merged), and
    the engine's host-clock QPS on 16384 fresh queries.  Returns the
    launches, the held errors and K2's times at this shape."""
    from expann_tpu_torch.models.brute_force import BruteForceEngine
    from expann_tpu_torch.ops import _kernels
    from expann_tpu_torch.ops.topk import flat_topk_cuda, flat_topk_plain
    from expann_tpu_torch.tools.bench_bigflat import BIG_ID, gen_corpus
    from expann_tpu_torch.utils.profiling import event_ms

    n = BIGFLAT_N
    t0 = time.perf_counter()
    x = gen_corpus(n, D)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((BIGFLAT_Q, D)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)  # f32: the plain version scores it in column blocks
    gt = flat_topk_plain(torch.from_numpy(q).to(dev), xd, K)[0].cpu().numpy()
    del xd
    data_s = time.perf_counter() - t0

    _kernels.launches.clear()
    eng = BruteForceEngine(mode="fused", device=dev)
    eng.store_many_vectors(x)
    t0 = time.perf_counter()
    eng.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del x
    batch = rng.standard_normal((BIGFLAT_B, D)).astype(np.float32)
    batch[:BIGFLAT_Q] = q
    t0 = time.perf_counter()
    ids = eng.query_k_batch(batch, K)[:BIGFLAT_Q]
    call_s = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    rec = recall(ids, gt)
    big = int((ids >= BIG_ID).sum())
    phase("bigflat", n=n, d=D, corpus_gb=f"{n * D * 2 / 1e9:.2f}", data_and_truth_seconds=f"{data_s:.1f}",
          build_seconds=f"{build_s:.2f}", call_queries=BIGFLAT_B, call_seconds=f"{call_s:.3f}",
          recall_at_10=f"{rec:.4f}", ids_ge_2_24=big, truth_ids_ge_2_24=int((gt >= BIG_ID).sum()), card=card)
    phase("launches", path="bigflat", **launches)
    check(launches == {"flat_topk": 1}, f"the bigflat call launched {launches}, not one K2 call")
    check(rec >= 0.99, f"bigflat recall@10 {rec} < 0.99")
    check(big >= 1, "no result id >= 2^24 at 2^24 + 2^20 rows")

    xf = eng._x_fused
    q100 = torch.from_numpy(q).to(dev)
    err = hold_flat_bf16(torch, "bigflat_flat", flat_topk_cuda, q100, xf, K)
    t0 = time.perf_counter()
    flat_topk_cuda(q100, xf, K)
    torch.cuda.synchronize()
    small_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(25)
    x8 = torch.randint(-127, 128, (n, D), generator=gen, device=dev, dtype=torch.int8)
    q8 = torch.randint(-127, 128, (128, D), generator=gen, device=dev, dtype=torch.int8)
    s8_err = hold_flat_s8(torch, "bigflat_flat_s8", flat_topk_cuda, q8, x8, 3 * K)
    del x8, q8

    qb = torch.from_numpy(rng.standard_normal((FLAT_CHUNK, D)).astype(np.float32)).to(dev, torch.bfloat16)
    ms = event_ms(lambda: flat_topk_cuda(qb, xf, K), reps=2)
    step = 1 << 20
    xn = torch.cat([(xf[s : s + step].float() ** 2).sum(1) for s in range(0, n, step)])

    def chain():  # per 4096 queries and 2^20 rows: one bf16 product with f32 results, topk; merged
        out = []
        for s in range(0, FLAT_CHUNK, 4096):
            best_d = best_i = None
            for c in range(0, n, step):
                d2 = torch.mm(qb[s : s + 4096], xf[c : c + step].T, out_dtype=torch.float32)
                v, i = torch.topk(d2.mul_(-2.0).add_(xn[c : c + step]), K, dim=1, largest=False)
                if best_d is None:
                    best_d, best_i = v, i
                else:
                    best_d, o = torch.topk(torch.cat([best_d, v], 1), K, dim=1, largest=False)
                    best_i = torch.cat([best_i, i + c], 1).gather(1, o)
            out.append(best_i)
        return out

    lib_ms = event_ms(chain, reps=1, warmup=0)
    b = bound(n * D * 2 + FLAT_CHUNK * D * 2 + FLAT_CHUNK * K * 8, 2.0 * FLAT_CHUNK * n * D)
    eng.query_k_batch(rng.standard_normal((1024, D)).astype(np.float32), K)
    runs = []
    for _ in range(2):
        qs = rng.standard_normal((FLAT_CHUNK, D)).astype(np.float32)
        t0 = time.perf_counter()
        eng.query_k_batch(qs, K)
        runs.append(FLAT_CHUNK / (time.perf_counter() - t0))
    phase("times", kernel="flat_topk", path="bigflat", B=FLAT_CHUNK, n=n, k=K, ms=f"{ms:.3f}",
          library_ms=f"{lib_ms:.3f}", vs_library=f"{lib_ms / ms:.2f}x", bound_ms=f"{b[0]:.4f}", bound_by=b[1],
          achieved_tflops=f"{2.0 * FLAT_CHUNK * n * D / (ms * 1e-3) / 1e12:.1f}",
          call_100_queries_seconds=f"{small_s:.3f}", qps=",".join(f"{v:.0f}" for v in runs), card=card)
    del eng, xf, qb, xn
    torch.cuda.empty_cache()
    times = dict(bigflat_ms=ms, bigflat_library_ms=lib_ms, bigflat_bound_ms=b[0], bigflat_bound_by=b[1],
                 bigflat_n=n, bigflat_launches=launches["flat_topk"], bigflat_100_query_call_s=small_s)
    return dict(launches=launches, err=err, s8_err=s8_err, times=times)


def sift_like_phase(torch, dev, card: str) -> dict:
    """Phase 26: the SIFT-like files (tools/make_sift_like.py) at SIFT_LIKE's
    reduced n, m, k, written under build/: read back through the loader's
    ``read_vecs``, which must take the native reader (utils/io_native.py,
    built by g++ into build/native/) and equal the numpy reader byte for
    byte; then ``load_sift1m`` feeds a flat ``fused`` engine (counts reset
    just before it), recall@10 against the file's ground truth >= 0.99.
    Returns the launches."""
    import shutil

    from expann_tpu_torch.data.loader import load_sift1m, read_vecs, read_vecs_numpy
    from expann_tpu_torch.models.brute_force import BruteForceEngine
    from expann_tpu_torch.ops import _kernels
    from expann_tpu_torch.tools.make_sift_like import make_sift_like
    from expann_tpu_torch.utils import io_native

    n, m, k = SIFT_LIKE
    out = os.path.join(ROOT, "build", "chip_smoke_sift_like")
    t0 = time.perf_counter()
    res = make_sift_like(out, n, m, D, k, 7, dev)
    make_s = time.perf_counter() - t0
    files = [(os.path.join(out, name), dtype) for name, dtype in (
        ("sift_base.fvecs", np.float32), ("sift_query.fvecs", np.float32), ("sift_groundtruth.ivecs", np.int32))]
    before = io_native.reads
    same = [read_vecs(f, dtype).tobytes() == read_vecs_numpy(f, dtype).tobytes() for f, dtype in files]
    native = io_native.reads - before
    _kernels.launches.clear()
    ds = load_sift1m(*(f for f, _ in files), k_custom=k)
    eng = BruteForceEngine(mode="fused", device=dev)
    eng.store_many_vectors(ds.vecs)
    eng.build()
    rec = recall(eng.query_k_batch(ds.queries, K), ds.ground_truth[:, :K])
    launches = dict(_kernels.launches)
    phase("sift_like", n=n, m=m, k=k, bounds=f"{res['bounds'][0]:.4f},{res['bounds'][1]:.4f}",
          make_seconds=f"{make_s:.1f}", truth_seconds=f"{res['gt_s']:.2f}", native_reads=native,
          native_library=io_native._load()._name, bytes_equal_numpy=all(same), recall_at_10=f"{rec:.4f}", card=card)
    phase("launches", path="sift_like", **launches)
    shutil.rmtree(out)
    check(native == len(files), f"read_vecs took the native reader for {native} of {len(files)} files")
    check(all(same), f"the native reader differs from numpy on {[f for (f, _), s in zip(files, same) if not s]}")
    check(ds.vecs.shape == (n, D) and float(ds.vecs.min()) >= 0 and float(ds.vecs.max()) <= 255,
          "the SIFT-like corpus is not u8-valued")
    check(rec >= 0.99, f"SIFT-like flat recall@10 {rec} < 0.99")
    check(launches.get("flat_topk", 0) > 0, f"the SIFT-like flat engine never launched K2: {launches}")
    return dict(launches=launches)


def main() -> None:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from expann_tpu_torch import AntitopoEngine, BruteForceEngine
    from expann_tpu_torch.data.loader import load_synthetic_uniform_sphere_points
    from expann_tpu_torch.models.search import entry_beam
    from expann_tpu_torch.ops import _kernels
    from expann_tpu_torch.ops.fused import fused_search_cuda, fused_search_plain, ring_for, topt_for
    from expann_tpu_torch.ops.packed import build_packed, packed_score_cuda, packed_score_plain
    from expann_tpu_torch.ops.topk import flat_topk_cuda, flat_topk_fixed_cuda, flat_topk_plain
    from expann_tpu_torch.tools.perf_fused_search import YARDSTICK, expanded_blocks, traversal_bound
    from expann_tpu_torch.utils.profiling import card_name, event_ms

    dev = torch.device("cuda")
    cfg = graph_cfg()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = card_name()
    card = f"'{smi}'"
    phase("device", kind=repr(kind), count=count, torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=card)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _kernels.library()
    build_s = time.perf_counter() - t0
    ptx = ptxas_summary(_kernels.build_report())
    check(set(ptx) == set(KERNEL_NAMES), f"ptxas report lists {sorted(ptx)}")
    check(all(v["arch"] == "sm_90a" for v in ptx.values()), f"not built for sm_90a: {ptx}")
    smem = {
        "flat_topk_kernel": lib.expann_flat_topk_smem_bytes(D, K),
        "flat_topk_fixed_kernel": lib.expann_flat_topk_fixed_smem_bytes(D, K),
        "fused_search_kernel": lib.expann_fused_search_smem_bytes(0, D, 128, 128, 128, cfg.query_expand),
        "packed_score_kernel": lib.expann_packed_score_smem_bytes(D, 128, 128),
        "flat_topk_s8_kernel": lib.expann_flat_topk_smem_bytes(D, 3 * K),
        "flat_topk_fixed_s8_kernel": lib.expann_flat_topk_fixed_smem_bytes(D, 3 * K),
        "fused_search_s8_kernel": lib.expann_fused_search_smem_bytes(1, D, 128, 128, 128, cfg.query_expand),
        "fused_search_rows_kernel": lib.expann_fused_search_smem_bytes(2, D, 128, 128, 128, cfg.query_expand),
        "probe_fused_kernel": 0,
        "block_gather_kernel": lib.expann_block_gather_smem_bytes(128, D, 4),
        "step_overhead_kernel": lib.expann_step_overhead_smem_bytes(128),
        "probe_lanes_kernel": 0,
    }
    # resident queries per SM of the traversal kernels at the canonical widths and batch
    ctas = {name: ring_for(kind, cfg.query_block, D, 128, 128, 128, cfg.query_expand)[2]
            for kind, name in enumerate(("fused_search_kernel", "fused_search_s8_kernel", "fused_search_rows_kernel"))}
    check(all(v >= 1 for v in ctas.values()), f"a traversal kernel cannot be resident: {ctas}")
    for kname, info in sorted(ptx.items()):
        phase("build", kernel=kname, arch=info["arch"], instances=info["instances"], registers=info["registers"],
              spill_bytes=info["spill_bytes"], static_smem_bytes=info["static_smem_bytes"],
              dynamic_smem_bytes=smem[kname],
              **({"ctas_per_sm": ctas[kname]} if kname in ctas else {}))
    phase("build", seconds=f"{build_s:.3f}", source=os.path.join("expann_tpu_torch", "csrc"))
    no_spill = ("flat_topk_kernel", "flat_topk_s8_kernel", "flat_topk_fixed_kernel", "flat_topk_fixed_s8_kernel",
                "packed_score_kernel", "fused_search_kernel", "fused_search_s8_kernel", "fused_search_rows_kernel",
                "probe_fused_kernel",
                "block_gather_kernel", "step_overhead_kernel", "probe_lanes_kernel")
    check(all(ptx[name]["spill_bytes"] == 0 for name in no_spill),
          f"a kernel that may not spill spills registers: {[(name, ptx[name]) for name in no_spill]}")

    # ---- 3. flat_topk (K2) and flat_fixed (K3) against the plain version ---
    rng = np.random.default_rng(0)
    xr = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).to(dev, torch.bfloat16)
    qr = torch.from_numpy(rng.standard_normal((FLAT_B, D)).astype(np.float32)).to(dev)
    flat_err = {}
    for label, fn, ks in (("flat_topk", flat_topk_cuda, (K,)), ("flat_fixed", flat_topk_fixed_cuda, (K, 100))):
        for k in ks:
            flat_err[label] = max(flat_err.get(label, 0.0), hold_flat_bf16(torch, label, fn, qr, xr, k))
    del xr, qr
    flat_err.update(flat_s8_phase(torch, dev))

    # ---- 4. the canonical config: the batched main path --------------------
    # the dataset cache and the bench's and the CLI's files; removed at exit
    work_dir = tempfile.TemporaryDirectory()
    work = work_dir.name
    ds = load_synthetic_uniform_sphere_points(N, M_QUERIES, K, D, cache_dir=os.path.join(work, "data"), device=dev)
    # the oracle itself, against float64 numpy on a slice
    d64 = ((ds.queries[:50, None, :].astype(np.float64) - ds.vecs[None].astype(np.float64)) ** 2).sum(-1)
    check(recall(ds.ground_truth[:50], np.argsort(d64, 1)[:, :K]) >= 0.999, "exact oracle disagrees with float64")
    launches = {}
    _kernels.launches.clear()

    flat = BruteForceEngine(mode="fused", device=dev)
    flat.store_many_vectors(ds.vecs)
    flat.build()
    flat_ids = flat.query_k_batch(ds.queries, K)
    flat_recall = recall(flat_ids, ds.ground_truth)
    phase("canonical", engine="flat", mode="fused", recall_at_10=f"{flat_recall:.4f}")

    graph = AntitopoEngine(config=graph_cfg(), device=dev)
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
    launches["batched"] = dict(_kernels.launches)
    check(flat_recall >= 0.99, f"flat recall@10 {flat_recall} < 0.99")
    check(graph_recall[120] >= 0.95, f"graph recall@10 at ef=120 {graph_recall[120]} < 0.95")

    _kernels.launches.clear()
    flat_fixed = BruteForceEngine(mode="fused", topk_mode="fixed", device=dev)
    flat_fixed.store_many_vectors(ds.vecs)
    flat_fixed.build()
    fixed_ids = flat_fixed.query_k_batch(ds.queries, K)
    launches["flat_fixed"] = dict(_kernels.launches)
    fixed_recall = recall(fixed_ids, ds.ground_truth)
    phase("canonical", engine="flat", mode="fused", topk_mode="fixed", recall_at_10=f"{fixed_recall:.4f}",
          ids_equal_count_mode=bool((fixed_ids == flat_ids).all()))
    check(fixed_recall >= 0.99, f"flat (topk_mode=fixed) recall@10 {fixed_recall} < 0.99")
    # K3 runs K2's distance tile and orders by (d, id) as K2 does
    check(bool((fixed_ids == flat_ids).all()),
          f"flat topk_mode=fixed ids differ from count mode on {int((fixed_ids != flat_ids).any(1).sum())} rows")

    # ---- 5. the traversal kernel against its plain version ----------------
    qg = torch.from_numpy(ds.queries).to(torch.bfloat16).to(dev).float()
    EF, ef = 128, 120
    topt = topt_for(cfg.fused_cand, cfg.query_expand, g.packed.shape[1])
    args = (g.packed, g.packed_norms, g.packed_ids)
    fused_err = hold_fused(torch, "fused", g, qg, ef, cfg.query_expand, cfg.fused_cand, cfg.entry_seeds,
                           ds.ground_truth)

    # ---- 6. the block scorer against its plain version ---------------------
    q400 = torch.from_numpy(ds.queries).to(dev)
    rng = np.random.default_rng(2)
    sel = torch.from_numpy(rng.integers(0, N, (M_QUERIES, 2)).astype(np.int32)).to(dev)
    sel[::5, 1] = N  # sentinel selections, as done queries and exhausted beams give
    sel[::17, 0] = N
    ps_err = 0.0
    for t in (0, cfg.packed_topt):
        ps_err = max(ps_err, hold_packed(torch, "canonical", args, sel, q400, t))
    # negative partial distances: each query a scaled copy of one of its
    # first node's rows, so 2 q.x > |x|^2 there (no |q|^2, no clamp)
    sel_neg = sel.clone()
    sel_neg[:, 0] = torch.where(sel[:, 0] == N, 0, sel[:, 0])
    qneg = 3.0 * g.packed[sel_neg[:, 0].long(), 1].float()
    for t in (0, cfg.packed_topt):
        ps_err = max(ps_err, hold_packed(torch, "negative", args, sel_neg, qneg, t, min_negative=M_QUERIES // 2))
    # all-tie blocks: 4096 copies of one integer-valued row, each node with
    # 120 distinct random neighbours (every seventh with a sentinel tail),
    # integer queries: every distance exact, every finite slot of a node
    # tied, so the ids must be the plain version's, in lane order
    nt = 4096
    tie_rows = torch.zeros((nt + 1, D), device=dev)
    tie_rows[:nt] = torch.round(4.0 * q400[0]).clamp(-8, 8)
    tie_norms = (tie_rows * tie_rows).sum(1)
    tie_norms[nt] = float("inf")
    gen = torch.Generator(device=dev).manual_seed(3)
    adj_t = torch.argsort(torch.rand((nt + 1, nt), generator=gen, device=dev), dim=1)[:, :120].to(torch.int32)
    adj_t[::7, -9:] = nt
    adj_t[nt] = nt
    tie_args = build_packed(tie_rows, tie_norms, adj_t)
    sel_t = torch.where(sel == N, nt, sel % nt).to(torch.int32)
    qtie = torch.round(2.0 * q400).clamp(-4, 4)
    for t in (0, cfg.packed_topt):
        ps_err = max(ps_err, hold_packed(torch, "all_tie", tie_args, sel_t, qtie, t, exact=True))
    del tie_args, adj_t

    # ---- 7. the per-iteration route: small batches -------------------------
    graph.set_ef_search(120)
    _kernels.launches.clear()
    t0 = time.perf_counter()
    single = np.concatenate([graph.query_k_batch(ds.queries[i : i + 1], K) for i in range(M_QUERIES)])
    single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunked = np.concatenate(
        [graph.query_k_batch(ds.queries[s : s + SMALL_CHUNK], K) for s in range(0, M_QUERIES, SMALL_CHUNK)]
    )
    chunked_s = time.perf_counter() - t0
    launches["small_batch"] = dict(_kernels.launches)
    small_recall = recall(single, ds.ground_truth)
    n_same = int((single == chunked).all(1).sum())
    phase("small_batch", ef=120, recall_at_10=f"{small_recall:.4f}", rows_identical=f"{n_same}/{M_QUERIES}",
          distcomps_per_query=f"{graph.num_distcomps / (2 * M_QUERIES):.1f}",
          seconds_single=f"{single_s:.2f}", seconds_chunks_of_32=f"{chunked_s:.2f}")
    check(n_same == M_QUERIES, f"small batches: ids differ between 1-query and 32-query calls on {M_QUERIES - n_same} rows")
    check(all(len(set(r.tolist())) == K for r in single), "small batches: duplicate ids")
    check(small_recall >= 0.95, f"small-batch recall@10 at ef=120 {small_recall} < 0.95")

    # ---- 8. times ---------------------------------------------------------
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

    graph.set_ef_search(120)
    for route, use_fused in (("per_iteration", "auto"), ("fused", True)):
        graph.cfg.use_fused = use_fused
        for B in LATENCY_B:
            ms = latency_ms(graph, ds.queries, B, LATENCY_CALLS)
            phase("times", latency=route, B=B, ef=120, calls=LATENCY_CALLS, median_ms=f"{np.median(ms):.3f}",
                  p90_ms=f"{np.percentile(ms, 90):.3f}", min_ms=f"{ms.min():.3f}", card=card)
        for B in (1, SMALL_CHUNK):
            phase("times", profile=route, B=B, ef=120, **profile_call(torch, _kernels, graph, ds.queries[:B]),
                  card=card)
    graph.cfg.use_fused = "auto"

    times = {}
    qf = torch.from_numpy(rng.standard_normal((FLAT_CHUNK, D)).astype(np.float32)).to(dev, torch.bfloat16)
    xf = flat._x_fused
    xn = (xf.float() ** 2).sum(1)

    def flat_chain():  # one bf16 product with f32 results, then top-k
        return torch.topk(xn - 2.0 * torch.mm(qf, xf.T, out_dtype=torch.float32), K, dim=1, largest=False)

    flat_lib_ms = event_ms(flat_chain, reps=5)
    flat_plain_ms = event_ms(lambda: flat_topk_plain(qf, xf, K), reps=2)
    flat_bound = bound(N * D * 2 + FLAT_CHUNK * D * 2 + FLAT_CHUNK * K * 8, 2.0 * FLAT_CHUNK * N * D)
    for name, label, fn in (("flat_topk", "flat_topk", flat_topk_cuda),
                            ("flat_topk_fixed", "flat_fixed", flat_topk_fixed_cuda)):
        # the timed call, at the serving chunk, against the plain version first
        flat_err[label] = max(flat_err[label], hold_flat_bf16(torch, label, fn, qf, xf, K))
        ms = event_ms(lambda: fn(qf, xf, K), reps=5)
        times[name] = dict(ms=ms, plain_ms=flat_plain_ms, library_ms=flat_lib_ms,
                           bound_ms=flat_bound[0], bound_by=flat_bound[1])
        phase("times", kernel=name, B=FLAT_CHUNK, n=N, k=K, ms=f"{ms:.3f}", plain_ms=f"{flat_plain_ms:.3f}",
              library_ms=f"{flat_lib_ms:.3f}", vs_library=f"{flat_lib_ms / ms:.2f}x", bound_ms=f"{flat_bound[0]:.4f}",
              bound_by=flat_bound[1], achieved_tflops=f"{2.0 * FLAT_CHUNK * N * D / (ms * 1e-3) / 1e12:.1f}",
              card=card)

    qt = torch.from_numpy(rng.standard_normal((cfg.query_block, D)).astype(np.float32))
    qt = qt.to(torch.bfloat16).to(dev).float()
    bd0, bi0, _ = entry_beam(g, qt, EF, cfg.entry_seeds)
    fargs = (*args, qt, bd0, bi0, ef, cfg.query_expand, topt, 8 * ef + 16)
    fused_ms = event_ms(lambda: fused_search_cuda(*fargs), reps=5)
    fused_plain_ms = event_ms(lambda: fused_search_plain(*fargs), reps=1)
    # the bound counts every input byte once: the distinct blocks the call
    # expands (the plain version's record) with their norm and id rows,
    # queries and beams in and out (ncomp counts RS per expansion); the
    # gathered rate, a block an expansion
    rs = g.packed.shape[1]
    Bq = cfg.query_block
    expansions = int(fused_search_cuda(*fargs)[2].sum()) // rs
    blocks = expanded_blocks(*fargs)
    kb = traversal_bound(expansions, blocks, rs, D, g.packed_norms.shape[1], "bf16", Bq, EF)
    ring = ring_for(0, Bq, D, rs, g.packed_norms.shape[1], EF, cfg.query_expand)
    times["fused_search"] = dict(ms=fused_ms, plain_ms=fused_plain_ms, library_ms=None,
                                 bound_ms=kb["bound_ms"], bound_by=kb["bound_by"])
    phase("times", kernel="fused_search", B=Bq, ef=ef, EF=EF, ms=f"{fused_ms:.3f}",
          plain_ms=f"{fused_plain_ms:.3f}", bound_ms=f"{kb['bound_ms']:.4f}", bound_by=kb["bound_by"],
          share=f"{kb['bound_ms'] / fused_ms:.4f}", expansions_per_query=f"{expansions / Bq:.1f}",
          blocks=blocks, blocks_of_layout=g.packed.shape[0] - 1,
          gathered_tb_per_s=f"{kb['gathered_bytes'] / (fused_ms * 1e-3) / 1e12:.3f}",
          gathered_yardstick=repr(YARDSTICK["bf16"]),
          ring=f"{ring[0]}x{ring[1]}", ctas_per_sm=ring[2], card=card)
    del bd0, bi0, fargs
    rows_res = hold_fused_rows(torch, dev, card)
    times["fused_search_rows"] = rows_res["times"]

    t4 = cfg.packed_topt
    rt = g.packed_norms.shape[1]
    for B in K4_B:
        qs = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
        sel = torch.from_numpy(rng.integers(0, N, (B, 2)).astype(np.int32)).to(dev)
        reps = 20 if B < 1024 else 5

        def k4_chain():
            s = sel.long()
            blk = g.packed[s].view(B * 2, rs, D)
            qq = qs.to(torch.bfloat16)[:, None, :].expand(B, 2, D).reshape(B * 2, D, 1)
            dots = torch.bmm(blk, qq, out_dtype=torch.float32)[:, :, 0].view(B, 2, rs)
            return torch.topk(g.packed_norms[s][:, :, :rs] - 2.0 * dots, t4, dim=2, largest=False)

        ps_err = max(ps_err, hold_packed(torch, "timed", args, sel, qs, t4))
        ms = event_ms(lambda: packed_score_cuda(*args, sel, qs, t4), reps=reps)
        plain_ms = event_ms(lambda: packed_score_plain(*args, sel, qs, t4), reps=max(2, reps // 4))
        lib_ms = event_ms(k4_chain, reps=reps)
        pairs = 2 * B
        k4_bound = bound(pairs * (rs * D * 2 + rt * 8 + 4 + t4 * 8) + B * D * 4, pairs * rs * D * 2.0)
        if B == SMALL_CHUNK:
            times["packed_score"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                         bound_ms=k4_bound[0], bound_by=k4_bound[1])
        phase("times", kernel="packed_score", B=B, E=2, topt=t4, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              library_ms=f"{lib_ms:.4f}", vs_library=f"{lib_ms / ms:.2f}x", bound_ms=f"{k4_bound[0]:.5f}",
              bound_by=k4_bound[1], achieved_tb_per_s=f"{pairs * rs * D * 2 / (ms * 1e-3) / 1e12:.3f}", card=card)

    # ---- 9-12. quantized serving ------------------------------------------
    del args  # the bf16 layout: the flip below drops it from the graph
    graph.set_ef_search(120)
    qres = quantized_phases(torch, dev, ds, graph, cfg, card, topt)
    launches.update(qres["launches"])
    times.update(qres["times"])
    for label, err in qres["flat_err"].items():
        flat_err[label] = max(flat_err[label], err)

    # ---- 13. launches on each path ------------------------------------------
    for path, counts in launches.items():
        phase("launches", path=path, **counts)
    check(launches["batched"].get("flat_topk", 0) > 0 and launches["batched"].get("fused_search", 0) > 0,
          f"a kernel of the batched path was never launched: {launches['batched']}")
    check(launches["batched"].get("packed_score", 0) == 0, "400-query calls took the per-iteration route")
    check(launches["flat_fixed"].get("flat_topk_fixed", 0) > 0, f"K3 never launched: {launches['flat_fixed']}")
    check(launches["small_batch"].get("packed_score", 0) > 0 and launches["small_batch"].get("fused_search", 0) == 0,
          f"small batches did not take the per-iteration route: {launches['small_batch']}")
    quant = launches["quantized"]
    check(all(quant.get(name, 0) > 0 for name in ("flat_topk_s8", "flat_topk_fixed_s8", "fused_search_s8")),
          f"a kernel of the quantized path was never launched: {quant}")
    check(quant.get("fused_search", 0) == 0 and quant.get("flat_topk", 0) == 0,
          f"the quantized path launched a bf16 kernel: {quant}")
    small_c = launches["small_batch_compressed"]
    check(not any(small_c.get(name, 0) for name in ("fused_search", "fused_search_s8", "packed_score")),
          f"compressed small batches launched the fused traversal or the block scorer: {small_c}")

    # ---- 14-17. the probes; 18. the serving trace ----------------------------
    pres = probe_phases(torch, dev, card)
    launches["probes"] = pres["launches"]
    times.update(pres["times"])
    phase("launches", path="probes", **launches["probes"])
    check(all(launches["probes"].get(n, 0) > 0 for n in ("probe_fused", "block_gather", "step_overhead", "probe_lanes")),
          f"a probe kernel was never launched on the probes path: {launches['probes']}")
    trace_phase(torch, qres["flat_i8"], card)

    # ---- 19. the canonical bench; 20. the CLI's 24-job sweep ----------------
    launches["bench"] = bench_phase(work, card)
    launches["cli"], cli_err = cli_phase(dev, ds, work, card)
    work_dir.cleanup()

    # ---- 21. ortho_count=2 on the canonical config; 22. the million-row path
    launches["ortho"] = ortho_phase(dev, ds, card, graph_recall, g.adj_bottom)
    mres = million_phase(torch, dev, card)
    launches["million_build"], launches["million_serve"] = mres["build"], mres["serve"]

    # ---- 23. the wave builders ------------------------------------------------
    wres = wave_phase(torch, dev, ds, card, graph_recall)
    wave = launches["wave"] = wres["launches"]

    # ---- 24. the multi-device layer ---------------------------------------------
    sres = sharded_phase(torch, dev, ds, card, g, graph_recall)
    sharded = {name: sum(c.get(name, 0) for c in sres["launches"].values()) for name in ("fused_search", "flat_topk")}

    # ---- 25. tens of millions of flat rows; 26. the SIFT-like files -------------
    bres = bigflat_phase(torch, dev, card)
    launches["sift_like"] = sift_like_phase(torch, dev, card)["launches"]

    rows = [
        ("fused_search", "expann_tpu_torch/csrc/fused_search.cu", "expann_tpu/ops/pallas_fused.py:69",
         launches["batched"]["fused_search"] + wave["fused_search"] + sharded["fused_search"],
         max(fused_err, cli_err["fused_search"], wres["err"]["fused_search"], sres["err"]["fused_search"])),
        ("fused_search_rows", "expann_tpu_torch/csrc/fused_search.cu", None, rows_res["launches"], rows_res["err"]),
        ("fused_search_s8", "expann_tpu_torch/csrc/fused_search.cu", "expann_tpu/ops/pallas_fused.py:258",
         quant["fused_search_s8"] + mres["serve"]["fused_search_s8"] + wave["fused_search_s8"],
         max(qres["fused_s8_err"], cli_err["fused_search_s8"], mres["s8_err"], wres["err"]["fused_search_s8"])),
        ("flat_topk", "expann_tpu_torch/csrc/flat_topk.cu", "expann_tpu/ops/pallas_topk.py:147",
         launches["batched"]["flat_topk"] + mres["build"]["flat_topk"] + mres["serve"]["flat_topk"]
         + sharded["flat_topk"] + bres["launches"]["flat_topk"] + launches["sift_like"]["flat_topk"],
         max(flat_err["flat_topk"], mres["err"], mres["flat_err"], sres["err"]["flat_topk"], bres["err"])),
        ("flat_topk_s8", "expann_tpu_torch/csrc/flat_topk.cu", "expann_tpu/ops/pallas_topk.py:211",
         quant["flat_topk_s8"] + mres["serve"]["flat_topk_s8"],
         max(flat_err["flat_topk_s8"], mres["flat_s8_err"], bres["s8_err"])),
        ("flat_topk_fixed", "expann_tpu_torch/csrc/flat_topk.cu", "expann_tpu/ops/pallas_topk.py:39",
         launches["flat_fixed"]["flat_topk_fixed"], flat_err["flat_fixed"]),
        ("flat_topk_fixed_s8", "expann_tpu_torch/csrc/flat_topk.cu", "expann_tpu/ops/pallas_topk.py:65",
         quant["flat_topk_fixed_s8"], flat_err["flat_fixed_s8"]),
        ("packed_score", "expann_tpu_torch/csrc/packed_score.cu", "expann_tpu/ops/pallas_beam.py:67",
         launches["small_batch"]["packed_score"] + wave["packed_score"], max(ps_err, wres["err"]["packed_score"])),
        ("probe_fused", "expann_tpu_torch/csrc/probes.cu", "tools/probe_fused.py:26",
         launches["probes"]["probe_fused"], pres["err"]["probe_fused"]),
        ("block_gather", "expann_tpu_torch/csrc/probes.cu", "tools/perf_pallas_gather.py:34",
         launches["probes"]["block_gather"], pres["err"]["block_gather"]),
        ("step_overhead", "expann_tpu_torch/csrc/probes.cu", "tools/probe_step_overhead.py:30",
         launches["probes"]["step_overhead"], pres["err"]["step_overhead"]),
        ("probe_lanes", "expann_tpu_torch/csrc/probes.cu", "tools/probe_lanes.py:43",
         launches["probes"]["probe_lanes"], pres["err"]["probe_lanes"]),
    ]
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": n_launch,
         "max_abs_err": err, **times[name], **({**mres["times"], **bres["times"]} if name == "flat_topk" else {})}
        for name, src, rep, n_launch, err in rows
    ]
    phase("total", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
