"""Run one cell once: set-up, the measured window, the traced calls, the
comparison with the plain reference, and the result line.

Set-up (``setup_s``) runs from the harness's start to the window's: the
imports, the kernel library, the corpus and the pool drawn from the seed,
the engine's build (``build_s`` is its own part of it), and one pass of
warm-up calls, which also builds the serving layout.  The window then
drives the cell's driver for ``seconds``.  With ``trace`` a few more calls
run under the profiler, and the per-layer readers take their metrics from
that trace, the engine's counters and its build stages.

Then the peak device memory is read, the engine is freed, and the plain
reference runs on the device: the exact neighbours of the pool, against
which every list the window returned is judged (``check.py``).
"""

from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import List, Tuple

import numpy as np

from annbench import check, data, devtrace, reference
from annbench.manifest import ROOT, cell as find_cell

TRACE_FILE = Path("annbench") / "cache" / "trace" / "{name}.json"


def card(device) -> Tuple[str, str]:
    """``(kind, power limit)`` of the card."""
    import torch

    if device.type != "cuda":
        return "cpu", "n/a"
    kind = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        limit = out.stdout.strip().splitlines()[device.index or 0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        limit = "unknown"
    return kind, limit


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def p95(latencies: List[float]) -> float:
    """The 95th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(latencies), 95))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT, device="cuda",
             t_start: float = None, log=None) -> Tuple[dict, List[str]]:
    """``(result, check lines)``.  ``log`` takes the progress lines (stderr)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    device = torch.device(device)
    c = find_cell(workload, root)
    k = int(c.config["k"])
    engine_mod, driver = c.engine(), c.driver()
    kind, power = card(device)
    log(f"card: {kind}, power limit {power}")

    engine_mod.prepare(device)
    t0 = time.perf_counter()
    x_dev, pool_dev = data.make(c.config["data"], int(c.traffic["pool"]), seed, device)
    x_host, pool_host = x_dev.cpu().numpy(), pool_dev.cpu().numpy()
    del x_dev, pool_dev
    if device.type == "cuda":  # the peak is the program's, not the generator's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    log(f"data: corpus {x_host.shape}, pool {pool_host.shape} ({time.perf_counter() - t0:.3f} s)")

    # the program gets copies of its own: the reference reads the benchmark's
    eng, build_s = engine_mod.build(c.config, c.spec, x_host.copy(), device)
    prog_pool = pool_host.copy()
    log(f"build: {build_s:.4f} s {engine_mod.stages(eng)}")
    t0 = time.perf_counter()
    took = driver.warm(eng, prog_pool, c.traffic, k)
    _sync(device)
    log(f"warm-up: {time.perf_counter() - t0:.3f} s, calls {' '.join(f'{t:.4f}' for t in took)}")
    setup_s = time.perf_counter() - t_start

    w = driver.run(eng, prog_pool, c.traffic, k, seconds)
    log(f"window: {len(w.latencies)} calls, {w.queries} queries in {w.seconds:.4f} s; "
        f"latency median {1e3 * float(np.median(w.latencies)):.4f} ms, p95 {1e3 * p95(w.latencies):.4f} ms "
        f"over {len(w.latencies)} requests")

    ctx = None
    if trace:
        counts1 = engine_mod.counters(eng)
        calls = int(c.traffic.get("trace_calls", 3))
        path = root / str(TRACE_FILE).format(name=workload)
        t0 = time.perf_counter()
        tr = devtrace.profile_calls(lambda i: driver.call(eng, prog_pool, c.traffic, k, i), calls, str(path),
                                    device.type == "cuda")
        counts2 = engine_mod.counters(eng)
        queries = calls * int(c.traffic["batch"])
        log(f"trace: {calls} calls, {queries} queries, span {tr.span_us * 1e-6:.6f} s "
            f"({queries / max(tr.span_us * 1e-6, 1e-12):.1f} queries/s traced against "
            f"{w.queries / w.seconds:.1f} in the window), {time.perf_counter() - t0:.2f} s with the reading")
        ctx = SimpleNamespace(
            trace=tr, traced_calls=calls, traced_queries=queries,
            counters={key: counts2[key] - counts1[key] for key in counts2},
            stages=engine_mod.stages(eng), batch=int(c.traffic["batch"]), n=x_host.shape[0],
            d=x_host.shape[1], k=k, on_card=device.type == "cuda",
        )

    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    del eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    x_ref = torch.from_numpy(x_host).to(device)
    pool_ref = torch.from_numpy(pool_host).to(device)
    gt = reference.exact_topk(x_ref, pool_ref, k)[0]
    numbers = check.judge(w.outs, x_ref, pool_ref, gt, int(c.traffic["batch"]), k)
    _sync(device)
    log(f"reference and comparison: {time.perf_counter() - t0:.3f} s")
    limits = c.spec["limits"]
    correct = check.passes(numbers, limits)

    e2e = {
        "qps": w.queries / w.seconds,
        "p95_ms": 1e3 * p95(w.latencies),
        "recall_at_10": 1.0 - numbers["miss_at_10"],
        "build_s": build_s,
        "setup_s": setup_s,
    }
    for m in c.end_to_end:
        if m["name"] in e2e:
            log(f"metric {m['name']} {e2e[m['name']]!r} {m['unit']}")
    metrics = {}
    if trace:
        for m in c.per_layer:
            value = c.reader(m["name"]).read(ctx)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in c.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind, "count": c.chips,
           "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": w.queries, "failed": numbers["bad_rows"],
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = ctx.trace.busy_us() * 1e-6
        dev["window_s"] = ctx.trace.span_us * 1e-6
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(), "idle_gaps": ctx.trace.idle_gaps()}
    result["checks"] = {name: {"value": numbers[name], "limit": limits[name]} for name in check.NAMES}
    return result, check.lines(numbers, limits)
