"""Refine a saved index with the two-pass refinement and save the result
(counterpart of tools/refine_1m.py).

``models/wavebuild.refine_index_wave`` re-inserts the first ``--frac`` of
the corpus against the finished graph; the A/B is then two
``tools/bench_1m.py --skip-build`` serving runs over the same corpus and
ground truth, one on each index file:

    python -m expann_tpu_torch.tools.refine_1m --idx build/bench_1m/idx_M48_efc300_clustered_wave.npz \\
        --out build/bench_1m/idx_M48_efc300_clustered_wave_refined.npz --M 48 --efc 300 [--frac 0.5] [--wave 4096]
"""

from __future__ import annotations

import argparse
import time

import torch

from expann_tpu_torch.models.build import BuildConfig
from expann_tpu_torch.models.wavebuild import refine_index_wave
from expann_tpu_torch.utils.persist import load_index, save_index


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--idx", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--M", type=int, required=True)
    ap.add_argument("--efc", type=int, required=True)
    ap.add_argument("--frac", type=float, default=0.5)
    ap.add_argument("--wave", type=int, default=4096)
    ap.add_argument("--refine-ef", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a small rehearsal")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("refine_1m runs on an NVIDIA GPU; none is present (--device cpu rehearses)")

    graph, meta = load_index(args.idx, device)
    print(f"loaded {args.idx}: n={graph.n} R0={graph.adj_bottom.shape[1]}", flush=True)
    cfg = BuildConfig(M=args.M, ef_construction=args.efc, prune_cand=args.efc)
    stats = {}
    t0 = time.perf_counter()
    refined = refine_index_wave(graph, cfg, frac=args.frac, wave_size=args.wave, refine_ef=args.refine_ef,
                                verbose=True, stats=stats)
    seconds = time.perf_counter() - t0
    print(f"refine: {seconds:.1f}s (frac={args.frac}, wave={args.wave})", flush=True)
    save_index(args.out, refined, dict(meta))
    print(f"saved {args.out}", flush=True)
    return {"seconds": seconds, **stats}


if __name__ == "__main__":
    main()
