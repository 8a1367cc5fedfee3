"""P1: the capabilities the fused in-kernel traversal rests on (counterpart
of tools/probe_fused.py, kernel ``probe_kernel`` :26, call :60):

  1. a vector reduction (each row's first argmin lane) feeding a scalar;
  2. that scalar, computed inside the kernel, driving the source address of
     a bulk asynchronous copy (``cp.async.bulk`` on an ``mbarrier``);
  3. a loop whose exit depends on the data.

``probe_fused(tab, x)`` returns ``(o, w)``: ``o = tab[argmin(x[0]) % 64]``
(first minimum) and ``w`` filled with the iteration count of
``c = -100; while c < min(x[0, :8]): c += 1`` (at most ``max_iters``
steps).  The kernel is ``probe_fused_kernel`` in ``csrc/probes.cu``; both
results are exact.

    python -m expann_tpu_torch.tools.probe_fused
    python -m expann_tpu_torch.tools.probe_fused --ab

``--ab`` prints one JSON line: the kernel's µs a call by CUDA events
(``utils/profiling.event_ms``) and as the slope of a CUDA-graph chain, beside
``tab[entry]`` (one indexing call that copies the same entry) timed both
ways.  It uses only the package's public functions, so the same file times
another checkout's kernel: ``PYTHONPATH=<checkout> python <this file> --ab``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Tuple

import numpy as np
import torch

import expann_tpu_torch
from expann_tpu_torch.ops import _kernels
from expann_tpu_torch.utils.profiling import card_name, event_ms

ROWS, W = 8, 128
# past 2^24, c += 1 no longer changes c in f32: the loop is cut there
MAX_ITERS = 1 << 24


GRAPH_CALLS = 64  # calls captured in one CUDA graph for the chain's slope


def probe_fused_plain(tab: torch.Tensor, x: torch.Tensor,
                      max_iters: int = MAX_ITERS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (o, w), each (8, 128) f32."""
    lane = int(torch.argmin(x[0]))  # the first minimum
    o = tab[lane % tab.shape[0]].float().clone()
    m = float(x[0, :8].min())
    c, n = -100.0, 0  # exact integers in f64 as in f32 below 2^24
    while c < m and n < max_iters:
        c += 1.0
        n += 1
    return o, torch.full((ROWS, W), float(n), dtype=torch.float32, device=x.device)


def probe_fused_cuda(tab: torch.Tensor, x: torch.Tensor,
                     max_iters: int = MAX_ITERS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``probe_fused_kernel`` (one block of two warps)."""
    device = x.device
    _kernels.require_cuda(tab, "tab", torch.float32, device)
    _kernels.require_cuda(x, "x", torch.float32, device)
    if x.shape != (ROWS, W) or tab.dim() != 3 or tuple(tab.shape[1:]) != (ROWS, W):
        raise ValueError(f"tab {tuple(tab.shape)} / x {tuple(x.shape)}: expected (n, 8, 128) / (8, 128)")
    if not 0 <= max_iters <= MAX_ITERS:
        raise ValueError(f"max_iters {max_iters} outside [0, {MAX_ITERS}]")
    o = torch.empty((ROWS, W), dtype=torch.float32, device=device)
    w = torch.empty((ROWS, W), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        code = _kernels.library().expann_probe_fused(
            tab.data_ptr(), x.data_ptr(), o.data_ptr(), w.data_ptr(), tab.shape[0], int(max_iters),
            _kernels.stream_ptr(device),
        )
    _kernels.check(code, "probe_fused")
    _kernels.launches["probe_fused"] += 1
    return o, w


def probe_fused(tab: torch.Tensor, x: torch.Tensor, max_iters: int = MAX_ITERS) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.is_cuda:
        return probe_fused_cuda(tab, x, max_iters)
    if x.device.type != "cpu":
        raise ValueError(f"probe_fused runs on CUDA or CPU tensors, not {x.device}")
    return probe_fused_plain(tab, x, max_iters)


def inputs(device, seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tool's inputs: tab (64, 8, 128) and x (8, 128), N(0, 1) from numpy."""
    rng = np.random.default_rng(seed)
    tab = torch.from_numpy(rng.standard_normal((64, ROWS, W)).astype(np.float32)).to(device)
    x = torch.from_numpy(rng.standard_normal((ROWS, W)).astype(np.float32)).to(device)
    return tab, x


CASES = tuple(("seed", s) for s in range(8)) + (("tie", 8), ("lane127", 9), ("last_row", 10), ("max_iters0", 11),
                                                 ("max_iters1", 12))


def case_inputs(device, kind: str, seed: int):
    """``(tab, x, max_iters, entry)`` of one of CASES: ``seed`` raises
    x[0, :8] by 5 * seed (loop counts ~100 to ~135); ``tie`` puts row 0's
    minimum in columns 40, 41, 90 and 127 (within one lane's four columns
    and across lanes: column 40 wins); ``lane127`` in column 127;
    ``last_row`` in column 99 of a 50-entry table (its last entry);
    ``max_iters0`` / ``max_iters1`` cap the loop.  ``entry`` is the table
    row the case must copy, where the case fixes it (else None)."""
    tab, x = inputs(device, seed)
    low = float(x[0].min()) - 1.0
    max_iters, entry = MAX_ITERS, None
    if kind == "seed":
        x[0, :8] += 5.0 * seed
    elif kind == "tie":
        x[0, [40, 41, 90, 127]] = low
        entry = 40
    elif kind == "lane127":
        x[0, 127] = low
        entry = 127 % tab.shape[0]
    elif kind == "last_row":
        tab = tab[:50].contiguous()
        x[0, 99] = low
        entry = 49
    elif kind in ("max_iters0", "max_iters1"):
        max_iters = int(kind[-1])
    else:
        raise ValueError(f"unknown case {kind!r}")
    return tab, x, max_iters, entry


def main(device="cuda") -> dict:
    """Run the probe once and check both capabilities as the TPU tool does."""
    tab, x = inputs(device)
    o, w = probe_fused(tab, x)
    xs = x.cpu().numpy()
    expect_idx = int(np.argmin(xs[0])) % 64
    ok_dma = bool(torch.equal(o.cpu(), tab[expect_idx].cpu()))
    expect_iters = max(0, math.ceil(float(xs[0, :8].min()) + 100.0))
    ok_while = bool((w.cpu() == expect_iters).all())
    print("dma-by-in-kernel-scalar:", "OK" if ok_dma else f"FAIL {o[0, :4].tolist()}", flush=True)
    print("while-loop:", "OK" if ok_while else f"FAIL got {float(w[0, 0])} want {expect_iters}", flush=True)
    return dict(ok_dma=ok_dma, ok_while=ok_while, iters=expect_iters)


def graph_us(fn, device, calls: int = GRAPH_CALLS, r1: int = 2, r2: int = 22) -> float:
    """Device µs a call of ``fn`` as the slope of a CUDA-graph chain
    (``tools/perf_latency``'s method): ``calls`` calls captured once, the
    graph replayed r1 and r2 times between CUDA events, the slope between
    the two runs over the calls, median of 3.  The card runs the calls back
    to back, so the slope is a call's device time and its launch gap."""
    from expann_tpu_torch.tools.perf_latency import chain_seconds

    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up outside the capture
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    chain_seconds(graph.replay, 1, device)
    slopes = []
    for _ in range(3):
        s2, s1 = chain_seconds(graph.replay, r2, device)[0], chain_seconds(graph.replay, r1, device)[0]
        slopes.append((s2 - s1) / (r2 - r1) / calls * 1e6)
    return float(np.median(slopes))


def ab(argv=None) -> dict:
    """The A/B reading: P1 and ``tab[entry]`` at the tool's inputs, each by
    CUDA events over ``--reps`` calls and by the CUDA-graph slope, with
    whether P1's arrays equal the plain version's; one JSON line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ab", action="store_true")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_fused --ab times the kernel on an NVIDIA GPU; none is present")
    from expann_tpu_torch.tools import probe_fused as pkg  # the checkout on the path

    dev = torch.device("cuda")
    tab, x = pkg.inputs(dev)
    o, w = pkg.probe_fused_cuda(tab, x)
    po, pw = pkg.probe_fused_plain(tab, x)
    entry = (torch.argmin(x[0]) % tab.shape[0]).reshape(1)
    row = {"kernel": "probe_fused", "identical": bool(torch.equal(o, po) and torch.equal(w, pw)),
           "us": event_ms(lambda: pkg.probe_fused_cuda(tab, x), reps=args.reps) * 1e3,
           "graph_us": graph_us(lambda: pkg.probe_fused_cuda(tab, x), dev),
           "tab_entry_us": event_ms(lambda: tab[entry], reps=args.reps) * 1e3,
           "tab_entry_graph_us": graph_us(lambda: tab[entry], dev),
           "reps": args.reps, "graph_calls": GRAPH_CALLS, "card": card_name(), "package": expann_tpu_torch.__file__}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    if "--ab" in sys.argv[1:]:
        ab(sys.argv[1:])
    else:
        main()
