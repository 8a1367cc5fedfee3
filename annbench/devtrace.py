"""Profile a few steady calls, and read the profiler's Chrome trace.

``profile_calls`` runs calls under ``torch.profiler`` (host and CUDA
activity), each inside a ``user_annotation`` named ``CALL``, exports the
trace to a fixed file under the checkout and parses it.  ``Trace`` holds
what the per-layer readers take:

* ``span``: from the first call's start to the last call's end (host
  clock of the trace, µs); each call ends in a device-to-host copy, so the
  device work of the calls lies inside it;
* ``kernels``, ``copies``: device records (``kernel``; ``gpu_memcpy``,
  ``gpu_memset``) clipped to the span, as ``(name, start, end)``;
* ``host``: host records (``cpu_op``, ``cuda_runtime``, ``user_annotation``)
  inside the span.

Times are unions of intervals, so overlapping records count once.
"""

from __future__ import annotations

import gzip
import heapq
import json
import os
from collections import defaultdict
from typing import Iterable, List, Tuple

CALL = "annbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10

Interval = Tuple[str, float, float]


def union_us(intervals: Iterable[Interval]) -> float:
    """Length of the union of ``(name, start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(intervals, key=lambda t: t[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for _, s, e in sorted(intervals, key=lambda t: t[1]):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


class Trace:
    def __init__(self, events: list):
        calls = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and e.get("name") == CALL]
        self.calls = len(calls)
        if calls:
            self.lo = min(float(e["ts"]) for e in calls)
            self.hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in calls)
        else:
            self.lo = self.hi = 0.0
        self.kernels: List[Interval] = []
        self.copies: List[Interval] = []
        self.host: List[Interval] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = float(e["ts"])
            t = s + float(e["dur"])
            if t <= self.lo or s >= self.hi:
                continue
            iv = (str(e.get("name", "")), max(s, self.lo), min(t, self.hi))
            cat = e.get("cat")
            if cat == "kernel":
                self.kernels.append(iv)
            elif cat in DEVICE_CATS:
                self.copies.append(iv)
            elif cat in HOST_CATS and iv[0] != CALL:
                self.host.append(iv)

    @property
    def span_us(self) -> float:
        return self.hi - self.lo

    @property
    def device(self) -> List[Interval]:
        return self.kernels + self.copies

    def busy_us(self) -> float:
        return union_us(self.device)

    def device_ops(self, top: int = TOP) -> list:
        """The device operations that took most time: ``[name, seconds]``."""
        by = defaultdict(float)
        for name, s, e in self.device:
            by[name[:160]] += e - s
        return [[n, us * 1e-6] for n, us in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = TOP) -> list:
        """The device's idle time inside the span by what the host was doing:
        each gap is named by the shortest host record covering its middle,
        ``[name, seconds]`` summed by name."""
        by = defaultdict(float)
        host = sorted(self.host, key=lambda h: h[1])
        heap: list = []  # (duration, end, name) of host records begun by the current middle
        at = 0
        for s, e in gaps(self.device, self.lo, self.hi):
            mid = 0.5 * (s + e)
            while at < len(host) and host[at][1] <= mid:
                heapq.heappush(heap, (host[at][2] - host[at][1], host[at][2], host[at][0]))
                at += 1
            while heap and heap[0][1] < mid:  # middles only grow: an ended record never covers again
                heapq.heappop(heap)
            by[heap[0][2][:160] if heap else "host (no record)"] += e - s
        return [[n, us * 1e-6] for n, us in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def read(path: str) -> Trace:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return Trace(json.load(f).get("traceEvents", []))


def profile_calls(call, count: int, path: str, on_card: bool) -> Trace:
    """Run ``call(i)`` for i in range(count) under the profiler, each call in
    a ``CALL`` annotation; returns the parsed trace.  One call runs first
    under a profiler of its own: the first session in a process pays the
    tracer's start-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts):
        call(-1)
    with profile(activities=acts) as prof:
        for i in range(count):
            with record_function(CALL):
                call(i)
        if on_card:
            torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    return read(path)
