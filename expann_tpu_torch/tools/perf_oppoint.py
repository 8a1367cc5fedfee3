"""The fused traversal's operating points, (expand, cand) x ef (counterpart
of tools/perf_oppoint.py).

For each (E, C) of ``--grid`` and each ef of ``--efs``, on the canonical
56k index on s8 blocks with 8 entry seeds
(``tools/perf_e2e_graph.canonical_graph``): recall@10 of the 400 canonical
queries through the engine (``query_k_batch``, the fused route), and the
card's microseconds a query of the traversal (K1-s8 from the seed beams of
B resident queries, plus the f32 rerank) by ``perf_latency``'s instrument,
the slope of serially dependent chains timed by CUDA events.  The port's
K1 runs one block per query with a topt merge and ends each query on its
own (``csrc/fused_search.cu``), so its best point may differ from the TPU
kernel's expand=2, cand=16 of bench.py; this tool records it and changes
no default::

    python -m expann_tpu_torch.tools.perf_oppoint [--grid 1x16,2x8,2x16,2x32,4x8,4x16] [--efs 80,100,120] [--B 512]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from expann_tpu_torch.models.search import entry_beam, rerank
from expann_tpu_torch.tools.bench_1m import recall
from expann_tpu_torch.tools.perf_e2e_graph import canonical_data, canonical_graph
from expann_tpu_torch.tools.perf_latency import slope_seconds
from expann_tpu_torch.tools.perf_trace import IDX
from expann_tpu_torch.utils.profiling import card_name

D, K, SEEDS = 128, 10, 8


def main(argv=None, device="cuda") -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", default="1x16,2x8,2x16,2x32,4x8,4x16", help="expand x cand pairs")
    ap.add_argument("--efs", default="80,100,120")
    ap.add_argument("--B", type=int, default=512, help="resident queries of the timed chains")
    ap.add_argument("--n", type=int, default=56000)
    ap.add_argument("--index", default=IDX, help="index file (e.g. one written by truncate_index)")
    ap.add_argument("--window", type=float, default=0.5, help="seconds the longer chain must take")
    args = ap.parse_args(argv)
    grid = [tuple(int(v) for v in g.split("x")) for g in args.grid.split(",")]
    efs = [int(v) for v in args.efs.split(",")]
    device = torch.device(device)
    card = card_name() if device.type == "cuda" else "cpu"

    eng = canonical_graph(args.index, args.n, device, packed_dtype="i8", use_packed=True, use_fused=True)
    eng._layout()
    g = eng.graph
    ds = canonical_data(args.n, device)
    rng = np.random.default_rng(7)
    qb = torch.from_numpy(rng.standard_normal((args.B, D)).astype(np.float32)).to(device)
    out = []
    for E, C in grid:
        eng.cfg.query_expand, eng.cfg.fused_cand = E, C
        for ef in efs:
            eng.set_ef_search(ef)
            rec = recall(eng.query_k_batch(ds.queries, K), ds.ground_truth)
            EF = ef + (-ef) % 128  # the engine's beam width
            bd0, bi0, _ = entry_beam(g, qb, EF, SEEDS)

            def trav(q, ef=ef, bd0=bd0, bi0=bi0):
                ids = g.layout.traverse(q, bd0, bi0, ef, E, C)[0]
                return rerank(g, q, ids, K)[0]

            lat, _, r2 = slope_seconds(trav, qb, device, args.window)
            us_q = lat / args.B * 1e6
            row = {"expand": E, "cand": C, "ef": ef, "recall_at_10": rec, "us_per_query": us_q,
                   "qps": 1e6 / us_q, "B": args.B, "reps": [4, r2], "card": card}
            print(f"E={E} C={C} ef={ef}: recall={rec:.4f} {us_q:8.2f} us/query ({1e6 / us_q:.0f} QPS on "
                  f"{device}, reps 4->{r2})", flush=True)
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


if __name__ == "__main__":
    main()
