"""Interleaved A/B runs of serving configurations on the canonical 56k index
(counterpart of tools/perf_ab_serving.py).

Host-clock QPS on the card spreads from run to run (29% flat, 74%
``fused_i8`` over PERF.md's runs), so the modes run in turns, A, B, A, B,
..., each turn one ``query_k_batch`` of Q fresh N(0,1) queries, and drift
lands on every mode alike.  Sweeps:

  * ``compression``: bf16 blocks, s8 blocks (``packed_dtype="i8"``) and
    ``use_compression=True`` (s8 blocks with the uint8 codes attached),
    which issue the same fused calls at this batch size;
  * ``qt``: ``fused_qt`` 64 against 128.  On the card ``fused_qt`` only sets
    the bucket below which a chunk takes the per-iteration route (the TPU
    kernel's query tile it also was has no counterpart: K1 runs one block a
    query), so at Q >= 128 both run the same fused calls: an A/A reading of
    the turns' spread.

Each mode is served by ``tools/perf_e2e_graph.canonical_graph`` (8 entry
seeds, expand 2, cand 16, query_block 8192) and warmed first; prints one
JSON line per (mode, turn) and a summary of each mode's median and best::

    python -m expann_tpu_torch.tools.perf_ab_serving --sweep compression [--Q 65536] [--reps 5]
    python -m expann_tpu_torch.tools.perf_ab_serving --sweep qt
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from expann_tpu_torch.tools.perf_e2e_graph import canonical_graph
from expann_tpu_torch.tools.perf_trace import IDX
from expann_tpu_torch.utils.profiling import card_name

D, K = 128, 10
SWEEPS = {
    "compression": {"bf16": {"packed_dtype": "bf16"}, "i8": {"packed_dtype": "i8"},
                    "compressed": {"packed_dtype": "i8", "use_compression": True}},
    "qt": {"qt64": {"packed_dtype": "i8", "fused_qt": 64}, "qt128": {"packed_dtype": "i8", "fused_qt": 128}},
}


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", choices=tuple(SWEEPS), default="compression")
    ap.add_argument("--Q", type=int, default=65536)
    ap.add_argument("--ef", type=int, default=100)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--n", type=int, default=56000)
    ap.add_argument("--index", default=IDX)
    args = ap.parse_args(argv)
    device = torch.device(device)
    card = card_name() if device.type == "cuda" else "cpu"
    modes = {
        name: canonical_graph(args.index, args.n, device, query_expand=2, fused_cand=16, query_block=8192,
                              ef_search=args.ef, use_packed=True, use_fused=True, **cfg)
        for name, cfg in SWEEPS[args.sweep].items()
    }
    rng = np.random.default_rng(11)

    def batch():
        return rng.standard_normal((args.Q, D)).astype(np.float32)

    for name, eng in modes.items():  # warm every mode first
        eng.query_k_batch(batch(), K)
        print(f"warmed {name}", flush=True)
    results = {name: [] for name in modes}
    for rep in range(args.reps):
        for name, eng in modes.items():  # in turns: drift cancels
            b = batch()
            t0 = time.perf_counter()
            eng.query_k_batch(b, K)  # numpy out: the device work is done
            qps = args.Q / (time.perf_counter() - t0)
            results[name].append(qps)
            print(json.dumps({"mode": name, "rep": rep, "qps": round(qps, 1)}), flush=True)
    summary = {"ab_summary": {name: {"median_qps": round(float(np.median(v)), 1), "best_qps": round(max(v), 1)}
                              for name, v in results.items()},
               "sweep": args.sweep, "Q": args.Q, "ef": args.ef, "card": card}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
