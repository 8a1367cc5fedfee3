"""Tracing and timing hooks (counterpart of expann_tpu/utils/profiling.py).

The reference's observability is compile-time stat counters (RECORD_STATS
num_distcomps / total_query_time, src/antitopo_engine.h:125-129) plus
external callgrind / perf toggles around the query loop
(src/basic_bench.h:76-77, 128-129).  Here:

  * the stat counters live on the engines (``num_distcomps``,
    ``num_distcomps_compressed``, ``total_query_time_ns``);
  * ``trace(...)`` wraps a region in a ``torch.profiler`` trace, with the
    card's kernel records on a CUDA device, and writes it as a Chrome trace
    (``trace_<ns>.json``, readable by ``chrome://tracing``, Perfetto, or
    ``expann_tpu_torch.tools.perf_trace.parse_trace``);
  * ``annotate(name)`` names a region inside a trace;
  * ``event_ms(fn, reps)`` times a callable on the card with CUDA events;
  * ``card_name()`` names the card and its power limit (nvidia-smi).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from pathlib import Path

import torch

DEFAULT_LOG_DIR = str(Path(__file__).resolve().parents[2] / "build" / "trace")
HOLD_CYCLES = 40_000_000  # ~20 ms of the card's clock


@contextlib.contextmanager
def trace(log_dir: str = DEFAULT_LOG_DIR, enabled: bool = True, device="cuda"):
    """Profile a region: ``with trace(d): eng.query_k_batch(...)``.  Yields
    the ``torch.profiler.profile`` object (None when disabled).  On a CUDA
    device the card's activity is recorded, and a trace that holds no
    device record raises: it is not silently a host-only trace."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))
    if on_card and not any(str(e.device_type).endswith("CUDA") for e in prof.events()):
        raise RuntimeError("torch.profiler recorded no CUDA activity: the card was not traced")


def annotate(name: str):
    """Name a region inside a trace (a ``user_annotation`` event)."""
    return torch.profiler.record_function(name)


def card_name() -> str:
    """The first card as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints it: its name and power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events
    around ``reps`` calls after ``warmup`` calls.  The card is held busy
    while the host enqueues the timed calls, so a kernel shorter than its
    launch path on the host is timed by its own work, not by the host's
    launch rate (a callable that synchronizes is timed with its host work)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
