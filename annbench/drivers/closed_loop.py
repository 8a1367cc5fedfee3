"""One client in a closed loop: each call of ``batch`` queries is sent when
the one before it has returned, the calls cycling through the pool's slots
of ``batch`` rows.  Numpy in, numpy out: a call's time holds the host's
work, the copies and the device's work."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass
class Window:
    outs: List[Tuple[int, np.ndarray]] = field(default_factory=list)  # (slot, ids) a call
    latencies: List[float] = field(default_factory=list)  # seconds a call
    seconds: float = 0.0
    queries: int = 0


def slots(pool: np.ndarray, traffic: dict) -> int:
    return max(1, pool.shape[0] // int(traffic["batch"]))


def call(eng, pool: np.ndarray, traffic: dict, k: int, i: int):
    """``(slot, ids)`` of call ``i`` (negative i: the slot of -i)."""
    b = int(traffic["batch"])
    s = abs(i) % slots(pool, traffic)
    return s, eng.query_k_batch(pool[s * b : (s + 1) * b], k)


def warm(eng, pool: np.ndarray, traffic: dict, k: int) -> List[float]:
    """``warmup_calls`` calls, cycling the slots as the window does (every
    call of one traffic mix has the same shape); the seconds of each."""
    took = []
    for i in range(int(traffic["warmup_calls"])):
        t = time.perf_counter()
        call(eng, pool, traffic, k, i)
        took.append(time.perf_counter() - t)
    return took


def run(eng, pool: np.ndarray, traffic: dict, k: int, seconds: float) -> Window:
    """Calls until ``seconds`` have passed since the first was sent; the
    window closes when the last call returns."""
    w = Window()
    b = int(traffic["batch"])
    start = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        s, ids = call(eng, pool, traffic, k, i)
        end = time.perf_counter()
        w.outs.append((s, ids))
        w.latencies.append(end - t)
        i += 1
        if end - start >= seconds:
            break
    w.seconds = end - start
    w.queries = i * b
    return w
