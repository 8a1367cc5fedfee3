"""Attribute one wave of the million-row one-shot distributed build
(counterpart of tools/probe_wave_cost.py).

On an N(0,1) corpus (numpy seed 0) laid out as ``build_distributed`` lays
it out on one device, each part of a wave of W rows is timed on its own,
every timed rep on other wave rows (rows r W .. (r + 1) W):

  (a) the segmented flat scans alone, as ``parallel/distbuild._flat_candidates``
      issues them (``flat_segments``: n_seg segments at k = min(C + 1, 128),
      the flat top-k kernel K2 in ``--topk-mode``, default the builder's
      "count"), with their merge;
  (b) the whole forward step, ``_dist_wave_step(reverse=False)``: the
      candidates, the anti-topo prune and the forward-row writes; then the
      same wave's steps one by one, split by CUDA events: candidates, the
      prune's gathers (candidate rows and norms), its co-distance product,
      its ``cap`` lockstep steps, the row writes;
  (c) the reverse step, ``_dist_reverse_step``, over the rows (b) wrote;

and the projected build, waves x ((b) + (c)).  Each time is the median of
``--reps`` (host clock after a device sync; the split: CUDA events on the
card, the host clock on the CPU, where every op is synchronous).  No wave
rows repeat, so nothing can be served from a cache of an earlier rep::

    python -m expann_tpu_torch.tools.probe_wave_cost [--n 1000000] [--C 300] [--cap 96] [--W 4096]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from expann_tpu_torch.bench.harness import sync
from expann_tpu_torch.models.build import BuildConfig, _round_up
from expann_tpu_torch.models.graph import make_corpus
from expann_tpu_torch.models.prune import antitopo_prune, pairwise_co_dist
from expann_tpu_torch.ops.topk import MODES
from expann_tpu_torch.parallel.distbuild import (
    INF,
    _dist_reverse_step,
    _dist_wave_step,
    _flat_candidates,
    _prune_args,
    _write_rows,
    flat_segments,
)
from expann_tpu_torch.utils.profiling import card_name

D = 128
SLACK = 64  # build_distributed's row slack above the cap


class Marks:
    """Named points of one run of work: CUDA events on the card, the host
    clock elsewhere; ``ms()`` the milliseconds between consecutive marks."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.names, self.points = [], []

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.points.append(ev)
        else:
            self.points.append(time.perf_counter())
        self.names.append(name)

    def ms(self) -> dict:
        if self.cuda:
            self.points[-1].synchronize()
            return {n: a.elapsed_time(b) for n, a, b in zip(self.names[1:], self.points, self.points[1:])}
        return {n: (b - a) * 1e3 for n, a, b in zip(self.names[1:], self.points, self.points[1:])}


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--C", type=int, default=300, help="candidates a row (prune_cand)")
    ap.add_argument("--cap", type=int, default=96, help="edge cap (M0)")
    ap.add_argument("--W", type=int, default=4096, help="wave rows")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--topk-mode", choices=MODES, default="count")
    args = ap.parse_args(argv)
    n, C, cap, W = args.n, args.C, args.cap, args.W
    if (args.reps + 2) * W > n:
        raise SystemExit(f"n={n} holds fewer than reps + 2 = {args.reps + 2} waves of {W} rows")
    device = torch.device(device)
    card = card_name() if device.type == "cuda" else "cpu"
    cfg = BuildConfig(M=cap // 2, M0=cap, ef_construction=C, prune_cand=C)
    overflow_rows = min(128, n)

    x = np.random.default_rng(0).standard_normal((n, D)).astype(np.float32)
    vectors, norms = make_corpus(x, device)
    del x
    xs = vectors[:n].to(torch.bfloat16)
    adj = torch.full((n + 1, _round_up(cap + SLACK, 16)), n, dtype=torch.int32, device=device)
    counts = torch.zeros((n + 1,), dtype=torch.int32, device=device)
    seg_rows, kk = flat_segments(n, C)
    n_seg = (n + seg_rows - 1) // seg_rows
    print(f"n={n} C={C} cap={cap} W={W}: {n_seg} segments of {seg_rows} rows at k={kk}, "
          f"topk_mode={args.topk_mode}, device={device}", flush=True)

    def wave(r: int) -> torch.Tensor:
        return torch.arange(r * W, (r + 1) * W, dtype=torch.int32, device=device)

    def timed(fn) -> float:
        """Median seconds of fn(rep) over reps 1..reps after fn(0)."""
        fn(0)
        ts = []
        for r in range(1, args.reps + 1):
            sync(device)
            t0 = time.perf_counter()
            fn(r)
            sync(device)
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    t_cand = timed(lambda r: _flat_candidates(xs, vectors[wave(r).long()], wave(r), C, args.topk_mode))
    t_fwd = timed(lambda r: _dist_wave_step(vectors, norms, adj, counts, vectors[wave(r).long()], wave(r), n, C, cap,
                                            cfg, overflow_rows, reverse=False, xs=(xs,), topk_mode=args.topk_mode))
    t_rev = timed(lambda r: _dist_reverse_step(vectors, norms, adj, counts, wave(r), cap, cfg, overflow_rows))

    # the forward step's parts on a wave of its own, one mark between each
    gids = wave(args.reps + 1)
    split = []
    for _ in range(args.reps):
        mk = Marks(device)
        sync(device)
        mk.mark("start")
        cand_ids, cand_d = _flat_candidates(xs, vectors[gids.long()], gids, C, args.topk_mode)
        mk.mark("candidates")
        ids = torch.clamp_max(cand_ids, n).long()
        cand_vecs = vectors[ids]
        cand_norms = torch.where(torch.isfinite(cand_d), norms[ids], INF)
        mk.mark("gathers")
        co = pairwise_co_dist(cand_vecs, cand_norms)
        mk.mark("co_distances")
        sel_ids, _ = antitopo_prune(ids, cand_d, co, cap, *_prune_args(cfg), n)
        mk.mark("lockstep")
        _write_rows(adj, counts, gids.long(), sel_ids)
        mk.mark("row_writes")
        split.append(mk.ms())
        del cand_vecs, co
    split_ms = {name: float(np.median([s[name] for s in split])) for name in split[0]}

    waves = (n + W - 1) // W
    out = {"n": n, "C": C, "cap": cap, "W": W, "segments": n_seg, "k": kk, "topk_mode": args.topk_mode,
           "candidates_s": t_cand, "forward_s": t_fwd, "prune_and_writes_s": t_fwd - t_cand, "reverse_s": t_rev,
           "forward_split_ms": split_ms, "waves": waves, "projected_build_s": waves * (t_fwd + t_rev),
           "timer": "cuda events" if device.type == "cuda" else "host clock", "card": card}
    print(f"(a) candidates only ({n_seg} segs, k={kk}): {t_cand:8.4f} s/wave", flush=True)
    print(f"(b) forward wave step:              {t_fwd:8.4f} s/wave   (prune+writes ~= {t_fwd - t_cand:.4f})",
          flush=True)
    print("    split (ms): " + " ".join(f"{k}={v:.2f}" for k, v in split_ms.items()), flush=True)
    print(f"(c) reverse step:                   {t_rev:8.4f} s/wave", flush=True)
    print(f"projected build: {waves} waves x (fwd {t_fwd:.3f} + rev {t_rev:.3f}) = {waves * (t_fwd + t_rev):.1f} s",
          flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
