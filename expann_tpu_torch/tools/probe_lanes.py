"""P4: the cost of warp-level lane operations (counterpart of
tools/probe_lanes.py, kernel built by ``make_kernel(mode, W)`` :43, call
:134, in ``run`` :131).

Each mode runs ITERS chained steps of one operation on every 128-wide row
of x (T*G rows):

  ``reduce``         d += rowmin(d) * 1e-6
  ``reduce3``        the min, its first lane, the value at that lane (three
                     reductions), d += value * 1e-6
  ``stage``          one bitonic compare-exchange stage against
                     ``roll(d, 1)``: min where bit 0 of the lane is clear,
                     else max; + 1e-7 (``bitonic_stage``, tools :31)
  ``stage64``        the same at distance 64
  ``bcast``          d += 1e-6 where d equals the row's lane 3
  ``matmul_cumsum``  d += inclusive_prefix_sum(d) * 1e-9 (the TPU took the
                     sum as a product with a triangular ones matrix)
  ``carry2``, ``carry3``, ``carry_n1``, ``carry6``
                     ``reduce`` with 1, 2, 1 (per row) or 4 more integer
                     carries XORed (or counted) each step, added times 0.0
                     at the end

The kernel (``probe_lanes_kernel`` in ``csrc/probes.cu``) gives each row to
one warp (4 values a lane), T=8 warps a block, G blocks; ITERS is a launch
argument and each step depends on the one before, so nothing folds.
``main()`` reports ns per step from the slope between ITERS=256 and 512:
with G=64 blocks all tiles run at once, so the slope is one step's latency.

    python -m expann_tpu_torch.tools.probe_lanes
"""

from __future__ import annotations

import torch

from expann_tpu_torch.ops import _kernels
from expann_tpu_torch.utils.profiling import card_name, event_ms

T = 8
ITERS = 512
G = 64
W = 128
# in csrc/probes.cu's order (enum LaneMode)
MODES = ("reduce", "reduce3", "stage", "stage64", "bcast", "matmul_cumsum", "carry2", "carry3", "carry_n1", "carry6")


def lane_ops_plain(x: torch.Tensor, mode: str, iters: int = ITERS) -> torch.Tensor:
    """Plain PyTorch version: (rows, W) f32."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    d = x.float().clone()
    lane = torch.arange(d.shape[1], device=d.device)
    ids = torch.zeros(d.shape, dtype=torch.int32, device=d.device)
    ex = torch.zeros_like(ids)
    dn = torch.zeros((d.shape[0], 1), dtype=torch.int32, device=d.device)
    nc = torch.zeros_like(dn)
    for _ in range(iters):
        if mode == "reduce" or mode.startswith("carry"):
            d = d + d.min(dim=1, keepdim=True).values * 1e-6
            if mode in ("carry2", "carry3", "carry6"):
                ids = ids ^ 1
            if mode in ("carry3", "carry6"):
                ex = ex ^ 1
            if mode in ("carry_n1", "carry6"):
                dn = dn ^ 1
            if mode == "carry6":
                nc = nc + 1
        elif mode == "reduce3":
            m = d.min(dim=1, keepdim=True).values
            ls = torch.where(d == m, lane, 2**31 - 1).min(dim=1, keepdim=True).values
            v = torch.where(lane == ls, d, float("inf")).min(dim=1, keepdim=True).values
            d = d + v * 1e-6
        elif mode in ("stage", "stage64"):
            s = 1 if mode == "stage" else 64
            partner = torch.roll(d, s, dims=1)
            d = torch.where((lane & s) == 0, torch.minimum(d, partner), torch.maximum(d, partner)) + 1e-7
        elif mode == "bcast":
            d = d + torch.where(d == d[:, 3:4], 1e-6, 0.0)
        else:  # matmul_cumsum
            d = d + torch.cumsum(d, dim=1) * 1e-9
    if mode in ("carry2", "carry3", "carry6"):
        d = d + (ids + ex).float() * 0.0
    if mode in ("carry_n1", "carry6"):
        d = d + (dn + nc).float() * 0.0
    return d


def lane_ops_cuda(x: torch.Tensor, mode: str, iters: int = ITERS) -> torch.Tensor:
    """Launch ``probe_lanes_kernel<mode>`` (a warp per row)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    device = x.device
    _kernels.require_cuda(x, "x", torch.float32, device)
    if x.dim() != 2 or x.shape[1] != W or x.shape[0] == 0:
        raise ValueError(f"x {tuple(x.shape)}: expected (rows, {W})")
    out = torch.empty_like(x)
    with torch.cuda.device(device):
        code = _kernels.library().expann_probe_lanes(x.data_ptr(), out.data_ptr(), x.shape[0], int(iters),
                                                     MODES.index(mode), _kernels.stream_ptr(device))
    _kernels.check(code, "probe_lanes")
    _kernels.launches["probe_lanes"] += 1
    return out


def lane_ops(x: torch.Tensor, mode: str, iters: int = ITERS) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.is_cuda:
        return lane_ops_cuda(x, mode, iters)
    if x.device.type != "cpu":
        raise ValueError(f"lane_ops runs on CUDA or CPU tensors, not {x.device}")
    return lane_ops_plain(x, mode, iters)


def inputs(device) -> torch.Tensor:
    """x (T*G, W) f32, N(0, 1) from a seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn((T * G, W), generator=gen, device=device)


def run(mode: str, device="cuda") -> dict:
    """ms per call at ITERS/2 and ITERS, and ns per step from the slope."""
    x = inputs(device)
    ms = [event_ms(lambda: lane_ops_cuda(x, mode, it), reps=20) for it in (ITERS // 2, ITERS)]
    return dict(mode=mode, ms_half=ms[0], ms=ms[1], ns_per_step=(ms[1] - ms[0]) * 1e6 / (ITERS - ITERS // 2))


def main(device="cuda") -> list:
    print(f"card: {card_name()}", flush=True)
    rows = []
    for mode in MODES:
        r = run(mode, device)
        rows.append(r)
        print(f"{mode:>14s} W={W:4d}: {r['ns_per_step']:8.2f} ns/step  ({ITERS // 2} steps {r['ms_half'] * 1e3:.2f} us, "
              f"{ITERS} steps {r['ms'] * 1e3:.2f} us)", flush=True)
    return rows


if __name__ == "__main__":
    main()
