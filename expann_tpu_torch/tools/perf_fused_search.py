"""Time the fused traversal (K1 on bf16 blocks, K1-s8 on s8 blocks,
``ops/fused.fused_search``; with ``--dtype rows`` K1-rows over the bf16
rows layout of the same graph, ``ops/fused.fused_search_rows``) on the card.

The canonical graph (``tools/perf_e2e_graph.canonical_graph``: n=56000,
d=128, bench.py's build, read from ``--index`` or built there), served as
the canonical bench serves it: 8 entry seeds by the dense scan
(``models/search.entry_beam``), EF=128, expand E=2, cand=8.  For each block
type, B in {8, 512, 16384} fresh N(0, 1) queries (numpy seed) and ef in
{100, 120}: milliseconds per call by CUDA events
(``utils/profiling.event_ms``), beside the call's bound, the larger of

  * bytes: every input byte once (``traversal_bytes``: the distinct blocks
    the call expands, with their norm and id rows, as the plain version
    records them, ``expanded_blocks``; the queries, the seed beams in and
    the beams out) over 3.35 TB/s, and
  * operations: two per multiply-add of every expansion (RS x D of them)
    over the operands' tensor peak (bf16 989 TFLOP/s, int8 1,979 TOP/s),

and the gathered rate: a block and its rows for every expansion, over the
call's time (P2's random-gather rate at the same block size,
``tools/perf_pallas_gather``, is its yardstick).  A digest of the returned
ids and the distance and iteration counts let two checkouts' lines be
compared for identical results (K1-rows' ids, distances and iterations
equal K1's; its ``ncomp`` counts rows, and its gathered bytes are those
rows with their ids and norms).  Prints one JSON line per reading, with the
card's name and power limit and the package it timed.

    python -m expann_tpu_torch.tools.perf_fused_search [--B 8,512,16384] [--ef 100,120]

It uses only the package's public functions, so the same file can time
another checkout's kernels: ``PYTHONPATH=<checkout> python <this file>``
(pass the same ``--index`` to both).  A checkout whose plain version does
not record the expanded blocks gets no bound (null).
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
from typing import Optional, Tuple

import numpy as np
import torch

import expann_tpu_torch
from expann_tpu_torch.models.search import entry_beam, kernel_query
from expann_tpu_torch.ops import fused
from expann_tpu_torch.utils.profiling import card_name, event_ms

D, EF, E, CAND, SEEDS = 128, 128, 2, 8, 8
HBM_BPS = 3.35e12  # NVIDIA H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "s8": 1979e12}  # dense tensor rates of the operands' type
# P2's random-gather rate at the block size (tools/perf_pallas_gather on an H100, 700 W)
YARDSTICK = {"bf16": "P2 R=128 (32 KB), 2.88-2.99 TB/s", "s8": "P2 R=64 (16 KB), 2.91-3.00 TB/s"}


def traversal_bytes(expansions: int, blocks: int, rs: int, d: int, rt: int, elem_bytes: int, B: int,
                    ef_width: int) -> Tuple[int, int]:
    """Bytes of one traversal call: ``(once, gathered)``.  ``once`` counts
    every input byte once: the ``blocks`` distinct packed blocks the call
    expands (RS x D elements) with their norm and id rows (R_tile x 4 B
    each), the f32 queries, the seed beams in and the beams out (EF x 8 B
    each), and the two counts a query.  ``gathered`` counts a block and its
    rows for every expansion, as the kernel reads them."""
    block = rs * d * elem_bytes + 2 * rt * 4
    io = B * (d * 4 + 2 * ef_width * 8 + 8)
    return blocks * block + io, expansions * block


def traversal_bound(expansions: int, blocks: int, rs: int, d: int, rt: int, dtype: str, B: int,
                    ef_width: int) -> dict:
    """The call's bound in ms, both terms, and the bytes behind them."""
    once, gathered = traversal_bytes(expansions, blocks, rs, d, rt, 1 if dtype == "s8" else 2, B, ef_width)
    bytes_ms = once / HBM_BPS * 1e3
    ops_ms = 2.0 * expansions * rs * d / PEAK_OPS[dtype] * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "operations_bound_ms": ops_ms, "once_bytes": once,
            "gathered_bytes": gathered, "blocks": blocks}


def expanded_blocks(packed, packed_norms, packed_ids, q, beam_d0, beam_ids0, ef: int, expand: int, topt: int,
                    max_iters: int) -> Optional[int]:
    """The distinct blocks a traversal call expands (never the sentinel's),
    as the plain version records them on the same inputs; None where the
    package's plain version does not record them."""
    if "expanded" not in inspect.signature(fused.fused_search_plain).parameters:
        return None
    mask = torch.zeros(packed.shape[0], dtype=torch.bool, device=packed.device)
    fused.fused_search_plain(packed, packed_norms, packed_ids, q, beam_d0, beam_ids0, ef, expand, topt, max_iters,
                             expanded=mask)
    return int(mask.sum())


def digest(*ts: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ring_name(dtype: str, B: int, rs: int, rt: int) -> str:
    """``SLOTSxBYTES`` of the ring the launcher takes, where the checkout
    tells it (``ops/fused.ring_for``)."""
    if not hasattr(fused, "ring_for"):
        return "default"
    nslot, slot, _ = fused.ring_for(("bf16", "s8", "rows").index(dtype), B, D, rs, rt, EF, E)
    return f"{nslot}x{slot}"


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", default="8,512,16384")
    ap.add_argument("--ef", default="100,120")
    ap.add_argument("--dtype", default="bf16,s8", help="comma-separated: bf16, s8, rows")
    ap.add_argument("--index", default="", help="graph index file (default: the canonical one)")
    ap.add_argument("--reps", type=int, default=200, help="calls timed at B < 1024 (5 at larger B)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("perf_fused_search times the kernel on an NVIDIA GPU; none is present")
    from expann_tpu_torch.tools.perf_e2e_graph import canonical_graph
    from expann_tpu_torch.tools.perf_trace import IDX

    dev = torch.device("cuda")
    card = card_name()
    out = []
    for dtype in args.dtype.split(","):
        eng = canonical_graph(args.index or IDX, 56000, dev, packed_dtype="i8" if dtype == "s8" else "bf16",
                              use_packed=True, use_fused=True, query_expand=E, fused_cand=CAND,
                              entry_seeds=SEEDS)
        eng._resolve_packed()
        g = eng.graph
        n1, rs, _ = g.packed.shape
        rt = g.packed_norms.shape[1]
        if dtype == "rows":
            from expann_tpu_torch.ops.packed import build_rows

            rows = build_rows(g.vectors, g.norms, g.adj_bottom)[0]
        rng = np.random.default_rng(args.seed)
        for B in (int(v) for v in args.B.split(",")):
            qh = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
            bd0, bi0, _ = entry_beam(g, qh, EF, SEEDS)
            qk = kernel_query(g, qh)
            reps = args.reps if B < 1024 else 5
            for ef in (int(v) for v in args.ef.split(",")):
                def call():
                    if dtype == "rows":
                        return fused.fused_search_rows(rows, g.packed_norms, g.packed_ids, rs, qk, bd0, bi0, ef=ef,
                                                       expand=E, cand=CAND)
                    return fused.fused_search(g.packed, g.packed_norms, g.packed_ids, qk, bd0, bi0, ef=ef,
                                              expand=E, cand=CAND)

                ids, dist, ncomp, iters = call()
                if not bool(torch.isfinite(dist[:, :ef]).all()) or bool((ids[:, :ef] >= n1 - 1).any()):
                    raise SystemExit(f"{dtype} B={B} ef={ef}: a live lane without a real entry")
                ms = event_ms(call, reps=reps)
                if dtype == "rows":  # ncomp counts rows; a row brings its id and norm
                    expansions, blocks = None, None
                    gathered = int(ncomp.sum()) * (D * 2 + 8)
                else:
                    expansions = int(ncomp.sum()) // rs
                    blocks = expanded_blocks(g.packed, g.packed_norms, g.packed_ids, qk, bd0, bi0, ef, E,
                                             fused.topt_for(CAND, E, rs), 8 * ef + 16)
                    gathered = traversal_bytes(expansions, 0, rs, D, rt, 1 if dtype == "s8" else 2, B, EF)[1]
                kernel = {"s8": "fused_search_s8", "rows": "fused_search_rows"}.get(dtype, "fused_search")
                row = {"kernel": kernel, "dtype": dtype,
                       "B": B, "ef": ef, "EF": EF, "E": E, "cand": CAND, "RS": rs, "R_tile": rt,
                       "n": n1 - 1, "ms": ms, "blocks": blocks,
                       "gathered_tb_per_s": gathered / (ms * 1e-3) / 1e12,
                       "gathered_yardstick": YARDSTICK.get(dtype), "expansions": expansions,
                       "expansions_per_query": None if expansions is None else expansions / B,
                       "iters_mean": float(iters.float().mean()), "iters_max": int(iters.max()),
                       "ncomp_sum": int(ncomp.sum()), "result_digest": digest(ids, dist, ncomp, iters),
                       "ring": ring_name(dtype, B, rs, rt),
                       "reps": reps, "card": card, "package": expann_tpu_torch.__file__}
                if blocks is not None:
                    bnd = traversal_bound(expansions, blocks, rs, D, rt, dtype, B, EF)
                    row.update(bnd, share=bnd["bound_ms"] / ms)
                print(json.dumps(row), flush=True)
                out.append(row)
        del eng, g
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
