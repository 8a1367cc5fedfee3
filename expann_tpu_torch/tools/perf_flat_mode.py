"""A/B the flat top-k kernels on the card (counterpart of
tools/perf_flat_mode.py).

For each kernel of ``ops/topk.flat_topk`` — K2 (``mode="count"``) and K3
(``mode="fixed"``) on a bf16 corpus, K2-s8 and K3-s8 on its int8 codes — at
n=56000, d=128: recall@10 of 400 host queries against exact float64 ground
truth (the s8 kernels at k=30, reranked in f32 as ``fused_i8`` does), and
milliseconds per call of B queries made on the card (16384: the flat
engine's chunk) at k=10 and k=128 (bf16) or k=30 and k=128 (s8), by CUDA
events (``utils/profiling.event_ms``).  Prints one JSON line per reading,
with the card's name and power limit.

    python -m expann_tpu_torch.tools.perf_flat_mode [--n 56000] [--B 16384] [--reps 5]

It uses only the package's public flat top-k functions, so the same file
can time another checkout's kernels: ``PYTHONPATH=<checkout> python <this
file>``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from expann_tpu_torch.ops.topk import flat_topk, quantize_corpus_i8, quantize_query_i8
from expann_tpu_torch.utils.profiling import card_name, event_ms

D = 128
KS = {"bf16": (10, 128), "s8": (30, 128)}


def recall(ids: np.ndarray, gt: np.ndarray) -> float:
    k = gt.shape[1]
    return float(np.mean([len(set(a[:k].tolist()) & set(b.tolist())) / k for a, b in zip(ids, gt)]))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=56000)
    ap.add_argument("--B", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("perf_flat_mode times the kernels on an NVIDIA GPU; none is present")
    dev = torch.device("cuda")
    card = card_name()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((args.n, D)).astype(np.float32)
    q_host = rng.standard_normal((400, D)).astype(np.float32)
    q64, x64 = q_host.astype(np.float64), x.astype(np.float64)
    d2 = (q64 * q64).sum(1)[:, None] + (x64 * x64).sum(1)[None, :] - 2.0 * q64 @ x64.T
    gt = np.argsort(d2, axis=1)[:, :10]

    xb = torch.from_numpy(x).to(dev, torch.bfloat16)
    x8, center, scale, _ = quantize_corpus_i8(x, dev)
    xf = torch.from_numpy(x).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    qb = torch.randn((args.B, D), generator=gen, device=dev).to(torch.bfloat16)
    q8 = torch.randint(-127, 128, (args.B, D), generator=gen, device=dev, dtype=torch.int32).to(torch.int8)
    corpora = {"bf16": (xb, qb, torch.from_numpy(q_host).to(dev)),
               "s8": (x8, q8, torch.from_numpy(quantize_query_i8(q_host, center, scale)).to(dev))}
    out = []
    for dtype, (xc, qc, q400) in corpora.items():
        for mode in ("count", "fixed"):
            if dtype == "bf16":
                ids = flat_topk(q400, xc, 10, mode=mode)[0].cpu().numpy()
            else:  # the s8 scan's 30 candidates, reranked in f32
                cand = flat_topk(q400, xc, 30, mode=mode)[0].long()
                qf = torch.from_numpy(q_host).to(dev)
                dd = ((qf[:, None, :] - xf[cand]) ** 2).sum(-1)
                ids = cand.gather(1, torch.argsort(dd, dim=1, stable=True))[:, :10].cpu().numpy()
            for k in KS[dtype]:
                ms = event_ms(lambda: flat_topk(qc, xc, k, mode=mode), reps=args.reps)
                row = {"dtype": dtype, "mode": mode, "n": args.n, "B": args.B, "k": k, "ms": ms,
                       "qps": args.B / (ms * 1e-3), "recall_at_10": recall(ids, gt), "card": card}
                print(json.dumps(row), flush=True)
                out.append(row)
    return out


if __name__ == "__main__":
    main()
