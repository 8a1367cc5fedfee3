"""Time the per-iteration block scorer (K4, ``ops/packed.packed_score``) on
the card.

A random packed layout of the canonical shape (n=56000 N(0, 1) rows of
D=128, R=120 random neighbours: RS = R_tile = 128, 32 KB a block, the last
8 slots of each node +inf pads), built by
``build_packed`` on the card; then milliseconds per call of
``packed_score`` at B in {1, 8, 32, 64, 16384} queries of E=2 random real
nodes each, topt 8 (the engines' ``packed_topt``) and 0, by CUDA events
(``utils/profiling.event_ms``), beside the call's bound (the larger of its
bytes over 3.35 TB/s and its bf16 operations over 989 TFLOP/s: one block,
two aux rows and one selection entry a pair read, the outputs written).
Prints one JSON line per reading, with the card's name and power limit and
the package it timed.

    python -m expann_tpu_torch.tools.perf_packed_score [--n 56000] [--reps 200]

It uses only the package's public ``build_packed`` and ``packed_score``, so
the same file can time another checkout's kernel:
``PYTHONPATH=<checkout> python <this file>``.
"""

from __future__ import annotations

import argparse
import json

import torch

import expann_tpu_torch
from expann_tpu_torch.ops.packed import build_packed, packed_score
from expann_tpu_torch.utils.profiling import card_name, event_ms

D, R, E = 128, 120, 2
BS = (1, 8, 32, 64, 16384)
TOPTS = (8, 0)
HBM_BPS, BF16_OPS = 3.35e12, 989e12  # NVIDIA H100 SXM data sheet, dense


def bound_ms(B: int, rs: int, rt: int, topt: int) -> tuple:
    pairs = B * E
    nbytes = pairs * (rs * D * 2 + rt * 8 + 4 + (topt or rt) * 8) + B * D * 4
    tb, to = nbytes / HBM_BPS * 1e3, pairs * rs * D * 2.0 / BF16_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=56000)
    ap.add_argument("--reps", type=int, default=200, help="calls timed at B < 1024 (a tenth of it above)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("perf_packed_score times the kernel on an NVIDIA GPU; none is present")
    dev = torch.device("cuda")
    card = card_name()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n = args.n
    vecs = torch.cat([torch.randn((n, D), generator=gen, device=dev), torch.zeros((1, D), device=dev)])
    norms = (vecs * vecs).sum(1)
    norms[n] = float("inf")
    adj = torch.randint(0, n, (n + 1, R), generator=gen, device=dev, dtype=torch.int32)
    adj[n] = n
    packed, pn, pi = build_packed(vecs, norms, adj)
    del vecs, adj
    rs, rt = packed.shape[1], pn.shape[1]
    out = []
    for topt in TOPTS:
        for B in BS:
            q = torch.randn((B, D), generator=gen, device=dev)
            sel = torch.randint(0, n, (B, E), generator=gen, device=dev, dtype=torch.int32)
            d, _ = packed_score(packed, pn, pi, sel, q, topt=topt)
            if not bool(torch.isfinite(d.view(B, E, -1)[:, :, : min(R, topt or R)]).all()):
                raise SystemExit(f"packed_score gave a non-finite distance in a real slot at B={B} topt={topt}")
            reps = args.reps if B < 1024 else max(2, args.reps // 10)
            ms = event_ms(lambda: packed_score(packed, pn, pi, sel, q, topt=topt), reps=reps)
            b_ms, b_by = bound_ms(B, rs, rt, topt)
            row = {"kernel": "packed_score", "B": B, "E": E, "topt": topt, "D": D, "RS": rs, "R_tile": rt,
                   "n": n, "ms": ms, "bound_ms": b_ms, "bound_by": b_by, "reps": reps, "card": card,
                   "package": expann_tpu_torch.__file__}
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


if __name__ == "__main__":
    main()
