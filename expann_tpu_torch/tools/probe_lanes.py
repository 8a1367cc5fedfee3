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
one warp (4 values a lane), T=4 warps a block (``warps``, 1-8, a launch
argument), G blocks; a row's min is one ``redux.sync`` on orderable keys, not
a shuffle butterfly.  ITERS is a launch argument and each step depends on
the one before, so nothing folds.  ``main()`` reports ns per step from the
slope between ITERS=256 and 512: with G=128 blocks all tiles run at once, a
warp to each of an SM's four schedulers, so the slope is one step's latency.
(The TPU tool's T=8, 64 blocks of 8 warps, put two warps on a scheduler; on
an NVIDIA H100 80GB HBM3 at 700.00 W that was up to 7% slower a step for the
reductions and 14-27% for the compare-exchange stages and the broadcast.)

    python -m expann_tpu_torch.tools.probe_lanes
    python -m expann_tpu_torch.tools.probe_lanes --ab

``--ab`` prints one JSON line a mode: ns a step by the same slope, µs at
256 and 512 steps, whether the result is identical to the plain version's
at the tool's shape and on ``edge_rows``, the ns a step at each launch
shape of ``WARPS_SWEEP`` (T*G rows either way), and the card with its power
limit and its SM clock as nvidia-smi reads it after the mode's timings.  It
times this checkout only; another checkout's P4 is timed by its own tool,
``PYTHONPATH=<checkout> python <checkout>/expann_tpu_torch/tools/probe_lanes.py``,
whose ``main()`` takes the same slope.

    python -m expann_tpu_torch.tools.probe_lanes --sass [--library <.so>]

``--sass`` reads the SASS of each mode's kernel instance in the built
library (``cuobjdump``; another checkout's with ``--library``) and prints one
JSON line a mode: for each loop of the instance (a backward branch), its
instructions a trip, their opcodes, the steps a trip (its ``FADD`` count over
the mode's rounded adds a step, ``FADDS_PER_STEP``: the same in every
version of the kernel) and the longest chain of dependent instructions in a
trip (through registers and predicates, counted in instructions, with its
opcodes in order); then the chain a step, from a loop of one step a trip
where the compiler left one (the remainder of an unrolled loop), else from
the longest loop over its steps.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from expann_tpu_torch.ops import _kernels
from expann_tpu_torch.utils.profiling import card_name, event_ms

T = 4  # warps (rows) a block
ITERS = 512
G = 128
W = 128
WARPS_SWEEP = (8, 4, 1)  # launch shapes of --ab: T*G rows as 64 x 8 (the TPU tool's T), 128 x 4, 512 x 1 warps
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


def lane_ops_cuda(x: torch.Tensor, mode: str, iters: int = ITERS, warps: int = T) -> torch.Tensor:
    """Launch ``probe_lanes_kernel<mode>`` (a warp per row, ``warps`` a block)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    if not 1 <= warps <= 8:
        raise ValueError(f"warps={warps}: 1-8 warps a block")
    device = x.device
    _kernels.require_cuda(x, "x", torch.float32, device)
    if x.dim() != 2 or x.shape[1] != W or x.shape[0] == 0:
        raise ValueError(f"x {tuple(x.shape)}: expected (rows, {W})")
    out = torch.empty_like(x)
    with torch.cuda.device(device):
        code = _kernels.library().expann_probe_lanes(x.data_ptr(), out.data_ptr(), x.shape[0], int(iters),
                                                     MODES.index(mode), warps, _kernels.stream_ptr(device))
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


def edge_rows(device) -> torch.Tensor:
    """(16, W) f32 rows on which a min by keys could go wrong, then the same
    rows rolled by 37 columns (other lanes, other places in a lane): the
    min tied across three lanes; tied within one lane's 4 values and with
    another lane; every value negative; a zero min, -0.0 beside +0.0 in one
    lane and in another; +inf beside finite values; a row of +inf; a row of
    equal values; the min tied at the first and the last column.  Every
    tie and every sign of zero survives the steps: tied values take the
    same addend."""
    rng = np.random.default_rng(3)
    r = rng.uniform(1.0, 2.0, (8, W)).astype(np.float32)
    r[0, [5, 70, 127]] = 0.5
    r[1, [9, 10, 11, 100]] = 0.25
    r[2] = -1e3 * np.abs(rng.standard_normal(W)).astype(np.float32)
    r[2, 40] = -5e3
    r[3, [10, 51]] = -0.0
    r[3, [11, 50]] = 0.0
    r[4, ::3] = np.inf
    r[5] = np.inf
    r[6] = 1.5
    r[7] = rng.standard_normal(W).astype(np.float32)
    r[7, [0, 127]] = -4.0
    return torch.from_numpy(np.concatenate([r, np.roll(r, 37, axis=1)])).to(device)


def run(mode: str, device="cuda", warps: int = T) -> dict:
    """ms per call at ITERS/2 and ITERS, and ns per step from the slope."""
    x = inputs(device)
    ms = [event_ms(lambda: lane_ops_cuda(x, mode, it, warps), reps=20) for it in (ITERS // 2, ITERS)]
    return dict(mode=mode, warps=warps, ms_half=ms[0], ms=ms[1],
                ns_per_step=(ms[1] - ms[0]) * 1e6 / (ITERS - ITERS // 2))


def main(device="cuda") -> list:
    print(f"card: {card_name()}", flush=True)
    rows = []
    for mode in MODES:
        r = run(mode, device)
        rows.append(r)
        print(f"{mode:>14s} W={W:4d}: {r['ns_per_step']:8.2f} ns/step  ({ITERS // 2} steps {r['ms_half'] * 1e3:.2f} us, "
              f"{ITERS} steps {r['ms'] * 1e3:.2f} us)", flush=True)
    return rows


def sm_clock_mhz() -> float:
    """The first card's SM clock now, as nvidia-smi reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.split()[0])


def ab(argv=None) -> list:
    """The A/B reading of every mode at the tool's shape, one JSON line a
    mode (see the module's docstring)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ab", action="store_true")
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_lanes --ab times the kernel on an NVIDIA GPU; none is present")
    dev = torch.device("cuda")
    card = card_name()
    x, edges = inputs(dev), edge_rows(dev)
    x[:, 3] = x[:, 70]  # ties with lane 3 for bcast
    rows = []
    for mode in MODES:
        got, ref = lane_ops_cuda(x, mode), lane_ops_plain(x, mode)
        edge_same = torch.equal(lane_ops_cuda(edges, mode), lane_ops_plain(edges, mode))
        by_warps = {w: run(mode, dev, w) for w in WARPS_SWEEP}
        r, mhz = by_warps[T], sm_clock_mhz()
        row = {"kernel": "probe_lanes", "mode": mode, "warps": T, "ns_per_step": r["ns_per_step"],
               "us_half": r["ms_half"] * 1e3, "us": r["ms"] * 1e3, "identical": bool(torch.equal(got, ref)),
               "max_abs_err": float((got - ref).abs().max()), "edge_rows_identical": bool(edge_same),
               "ns_per_step_by_warps": {str(w): v["ns_per_step"] for w, v in by_warps.items()},
               "sm_clock_mhz": mhz, "clocks_per_step": r["ns_per_step"] * mhz * 1e-3, "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


# rounded f32 adds a step (csrc/probes.cu): 4 a row's lane; the prefix sum's
# 3 in-lane, 5 scan and 4 + 4 final adds
FADDS_PER_STEP = {mode: 16 if mode == "matmul_cumsum" else 4 for mode in MODES}
_SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRANCH = re.compile(r"\bBRA(?:\.\w+)*\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
_REG = re.compile(r"\b(U?R\d+|U?P\d+)\b")
_NO_DEST = {"BRA", "EXIT", "STG", "STS", "STL", "ST", "RED", "BAR", "NOP", "WARPSYNC", "BSYNC", "BSSY", "RET",
            "CALL", "MEMBAR", "DEPBAR", "YIELD"}
_CARRY_OUT = {"IADD3", "LEA", "IMAD", "IADD"}  # a predicate written beside the register (a carry)


def _writes_reads(insn: str) -> tuple:
    """(registers written, registers read) of one SASS instruction; a
    guarded instruction also reads what it may leave unwritten."""
    guard = re.match(r"@!?(U?P\d+)\s+", insn)
    reads = [guard.group(1)] if guard else []
    body = insn[guard.end():] if guard else insn
    op, _, rest = body.partition(" ")
    base = op.split(".")[0]
    ops = [o.strip() for o in rest.split(",")] if rest else []
    if base in _NO_DEST or not ops:
        n_dest = 0
    elif base.endswith("SETP") or base in ("PLOP3", "SHFL"):  # SHFL: the lane-valid predicate, then the value
        n_dest = 2
    else:
        n_dest = 1
        while base in _CARRY_OUT and n_dest < len(ops) and re.fullmatch(r"U?P(\d+|T)", ops[n_dest]):
            n_dest += 1
    writes = [r for o in ops[:n_dest] for r in _REG.findall(o)]
    reads += [r for o in ops[n_dest:] for r in _REG.findall(o)]
    return writes, reads + (writes if guard else [])


def loop_chain(insns: list) -> dict:
    """The longest chain of dependent instructions in one trip of a loop
    body (values live at the trip's start count as ready)."""
    depth, prev, last = {}, {}, {}
    for i, insn in enumerate(insns):
        writes, reads = _writes_reads(insn)
        src = [last[r] for r in reads if r in last]
        best = max(src, key=lambda j: depth[j], default=None)
        depth[i] = 1 + (depth[best] if best is not None else 0)
        prev[i] = best
        for r in writes:
            last[r] = i
    end = max(depth, key=depth.get, default=None)
    chain = []
    while end is not None:
        chain.append(_opcode(insns[end]))
        end = prev[end]
    return dict(chain_instructions=len(chain), chain=" ".join(reversed(chain)))


def loops(sass: str) -> list:
    """The instructions of every loop of one function's SASS: from a
    branch's target to the branch, for each branch back to an earlier
    instruction (by label, as nvdisasm prints, or by address, as cuobjdump
    does)."""
    insns, at, labels, found = [], {}, {}, []
    for line in sass.splitlines():
        m = _LABEL.match(line)
        if m:
            labels[m.group(1)] = len(insns)
            continue
        m = _SASS_LINE.match(line)
        if not m:
            continue
        at[int(m.group(1), 16)] = len(insns)
        b = _BRANCH.search(m.group(2))
        if b:
            target = labels.get(b.group(1)) if b.group(1) else at.get(int(b.group(2), 16))
            if target is not None and target < len(insns):
                found.append((target, len(insns) + 1))
        insns.append(m.group(2))
    return [insns[a:b] for a, b in found]


def _opcode(insn: str) -> str:
    return insn.split()[1] if insn.startswith("@") else insn.split()[0]


def sass(argv=None) -> list:
    """The step loop of every mode's kernel instance (see the module's
    docstring); one JSON line a mode."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--library", default=None, help="a built kernel library (default: this checkout's, built if missing)")
    args = ap.parse_args(argv)
    lib = args.library or _kernels.library()._name
    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n(?=\s*Function : )", dump)
    rows = []
    for i, mode in enumerate(MODES):
        (fn,) = [f for f in funcs if re.match(rf"\s*Function : \S*probe_lanes_kernelILi{i}EE", f)]
        found = []
        for body in loops(fn):
            ops = collections.Counter(_opcode(insn).split(".")[0] for insn in body)
            found.append({"trip_instructions": len(body), "steps": ops["FADD"] / FADDS_PER_STEP[mode],
                          **loop_chain(body), "opcodes": dict(ops.most_common()), "trip": body})
        steps = [f for f in found if f["steps"] >= 1]
        one = [f for f in steps if f["steps"] == 1]
        best = one[0] if one else max(steps, key=lambda f: f["trip_instructions"], default=None)
        row = {"mode": mode, "chain_per_step": best and best["chain_instructions"] / best["steps"],
               "chain_of_a_step": best and best["chain"] if one else None, "loops": found,
               "library": os.path.basename(lib)}
        if not found:
            row["function"] = fn
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    if "--ab" in sys.argv[1:]:
        ab(sys.argv[1:])
    elif "--sass" in sys.argv[1:]:
        sass(sys.argv[1:])
    else:
        main()
