"""P1: the capabilities the fused in-kernel traversal rests on (counterpart
of tools/probe_fused.py, kernel ``probe_kernel`` :26, call :60):

  1. a vector reduction (each row's first argmin lane) feeding a scalar;
  2. that scalar, computed inside the kernel, driving the source address of
     a bulk asynchronous copy (``cp.async.bulk`` on an ``mbarrier``);
  3. a loop whose exit depends on the data.

``probe_fused(tab, x)`` returns ``(o, w)``: ``o = tab[argmin(x[0]) % 64]``
(first minimum) and ``w`` filled with the iteration count of
``c = -100; while c < min(x[0, :8]): c += 1``.  The kernel is
``probe_fused_kernel`` in ``csrc/probes.cu``; both results are exact.

    python -m expann_tpu_torch.tools.probe_fused
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from expann_tpu_torch.ops import _kernels

ROWS, W = 8, 128
# past 2^24, c += 1 no longer changes c in f32: the loop is cut there
MAX_ITERS = 1 << 24


def probe_fused_plain(tab: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (o, w), each (8, 128) f32."""
    lane = int(torch.argmin(x[0]))  # the first minimum
    o = tab[lane % tab.shape[0]].float().clone()
    m = float(x[0, :8].min())
    c, n = -100.0, 0  # exact integers in f64 as in f32 below 2^24
    while c < m and n < MAX_ITERS:
        c += 1.0
        n += 1
    return o, torch.full((ROWS, W), float(n), dtype=torch.float32, device=x.device)


def probe_fused_cuda(tab: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``probe_fused_kernel`` (one block)."""
    device = x.device
    _kernels.require_cuda(tab, "tab", torch.float32, device)
    _kernels.require_cuda(x, "x", torch.float32, device)
    if x.shape != (ROWS, W) or tab.dim() != 3 or tuple(tab.shape[1:]) != (ROWS, W):
        raise ValueError(f"tab {tuple(tab.shape)} / x {tuple(x.shape)}: expected (n, 8, 128) / (8, 128)")
    o = torch.empty((ROWS, W), dtype=torch.float32, device=device)
    w = torch.empty((ROWS, W), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        code = _kernels.library().expann_probe_fused(
            tab.data_ptr(), x.data_ptr(), o.data_ptr(), w.data_ptr(), tab.shape[0], MAX_ITERS,
            _kernels.stream_ptr(device),
        )
    _kernels.check(code, "probe_fused")
    _kernels.launches["probe_fused"] += 1
    return o, w


def probe_fused(tab: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.is_cuda:
        return probe_fused_cuda(tab, x)
    if x.device.type != "cpu":
        raise ValueError(f"probe_fused runs on CUDA or CPU tensors, not {x.device}")
    return probe_fused_plain(tab, x)


def inputs(device, seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tool's inputs: tab (64, 8, 128) and x (8, 128), N(0, 1) from numpy."""
    rng = np.random.default_rng(seed)
    tab = torch.from_numpy(rng.standard_normal((64, ROWS, W)).astype(np.float32)).to(device)
    x = torch.from_numpy(rng.standard_normal((ROWS, W)).astype(np.float32)).to(device)
    return tab, x


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


if __name__ == "__main__":
    main()
