"""Tracing and timing hooks (counterpart of expann_tpu/utils/profiling.py).

The reference's observability is compile-time stat counters (RECORD_STATS
num_distcomps / total_query_time, src/antitopo_engine.h:125-129) plus
external callgrind / perf toggles around the query loop
(src/basic_bench.h:76-77, 128-129).  Here:

  * the stat counters live on the engines (``num_distcomps``,
    ``num_distcomps_compressed``);
  * ``annotate(name)`` is the span: while a ``torch.profiler`` profile
    records, it is ``torch.profiler.record_function(name)``,
    a ``user_annotation`` record on the profiler's clock, the clock of the
    device records; otherwise it is one flag check and a shared
    ``nullcontext``.  There is no switch of its own: a region is traced by
    running it under ``trace()`` or any other profiler, and the spans live
    in the profiler's memory until it exports.  The package's spans are
    named ``expann.<layer>.<what>`` (engine, search, build) and
    ``expann.sync``, one a blocking device read;
  * ``StageClock`` splits a build phase into stage seconds that tile it:
    CUDA events on the device's stream (no host sync), the host clock on
    the CPU, each stage inside an ``expann.build.<stage>`` span;
  * ``trace(...)`` wraps a region in a ``torch.profiler`` trace, with the
    card's kernel records on a CUDA device, and writes it as a Chrome trace
    (``trace_<ns>.json``, readable by ``chrome://tracing``, Perfetto, or
    ``expann_tpu_torch.tools.perf_trace.parse_trace``);
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
import torch.autograd.profiler as _autograd_profiler

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


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """The span ``name`` (a ``user_annotation`` record) while a profiler
    records; the shared null context otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


class StageClock:
    """Seconds of the stages of one phase, tiling it: ``with
    clock.stage(name):`` marks the start of ``name``, which ends the stage
    before it, and opens the span ``expann.build.<name>``; ``stop()`` marks
    the end of the last stage.  On a CUDA device a mark is an event recorded
    on the device's current stream, so marking adds no host sync, and
    ``seconds()`` is read after the caller's own synchronise; on the CPU a
    mark is the host clock.  A stage that runs more than once is summed."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.marks: list = []  # (stage name, or None for a stop; event or seconds)

    def _mark(self, name) -> None:
        if self.device.type == "cuda":
            at = torch.cuda.Event(enable_timing=True)
            at.record(torch.cuda.current_stream(self.device))
        else:
            at = time.perf_counter()
        self.marks.append((name, at))

    @contextlib.contextmanager
    def stage(self, name: str):
        self._mark(name)
        with annotate(f"expann.build.{name}"):
            yield

    def stop(self) -> None:
        self._mark(None)

    def seconds(self) -> dict:
        """Seconds a stage, from each mark to the next."""
        out: dict = {}
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            if name is not None:
                dt = a.elapsed_time(b) * 1e-3 if self.device.type == "cuda" else b - a
                out[name] = out.get(name, 0.0) + dt
        return out


def no_stage(name: str):
    """``StageClock.stage`` of a phase that keeps no stage seconds."""
    return _OFF


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
