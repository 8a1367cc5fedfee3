"""Wall-clock attribution of the canonical 56k one-shot graph build
(counterpart of tools/profile_build.py).

Builds the canonical corpus through ``AntitopoEngine`` with the JAX tool's
config (bench.py's build: M=60, ef_construction = prune_cand = 500,
prune_overflow=1) ``--reps`` times, the first cold (the process's first
cuBLAS and allocator work) and the rest warm; then runs the one-shot
builder's steps one by one on the same corpus, each clock read after a
device sync: the corpus upload, the level draw, the bottom layer's exact
k-NN, its anti-topo prune and its reverse pass (incoming edges, the lazy
merge and the re-prune of overflowing rows), and the upper layers.  The
bottom rows the steps give must equal the engine's::

    python -m expann_tpu_torch.tools.profile_build [--n 56000] [--reps 2]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from expann_tpu_torch.bench.harness import sync
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.models.build import (
    INF,
    BuildConfig,
    _round_up,
    build_upper_layers,
    draw_levels,
    exact_knn,
    finish_rows,
    incoming_edges,
    merge_lazy,
    prune_all,
)
from expann_tpu_torch.models.graph import make_corpus
from expann_tpu_torch.tools.perf_e2e_graph import canonical_data
from expann_tpu_torch.utils.profiling import card_name


def engine_config() -> AntitopoConfig:
    """The JAX tool's config (tools/profile_build.py:36-45)."""
    return AntitopoConfig(M=60, ef_construction=500, ortho_count=1, prune_overflow=1, prune_cand=500,
                          query_expand=2, packed_topt=8, fused_cand=8, fused_qt=128, query_block=16384,
                          entry_seeds=8, precision="default")


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=56000)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    device = torch.device(device)
    card = card_name() if device.type == "cuda" else "cpu"
    x = canonical_data(args.n, device).vecs
    n = x.shape[0]

    totals = []
    for rep in range(args.reps):
        eng = AntitopoEngine(config=engine_config(), device=device)
        eng.store_many_vectors(x)
        sync(device)
        t0 = time.perf_counter()
        eng.build()  # returns a finished index (synchronized)
        totals.append(time.perf_counter() - t0)
        print(f"rep {rep} ({'cold' if rep == 0 else 'warm'}): build total {totals[-1]:.2f}s", flush=True)
    engine_adj = eng.graph.adj_bottom[:n]
    del eng

    cfg = BuildConfig(M=60, ef_construction=500, ortho_count=1, prune_overflow=1, prune_cand=500, builder="oneshot")
    secs = {}
    t = [time.perf_counter()]

    def lap(name: str) -> None:
        sync(device)
        t.append(time.perf_counter())
        secs[name] = t[-1] - t[-2]

    vectors, norms = make_corpus(x, device)
    lap("corpus_upload")
    levels, max_layer, _ = draw_levels(n, cfg.M, cfg.seed)
    lap("level_draw")
    cap = cfg.M0
    knn_ids, knn_d = exact_knn(vectors[:n], norms[:n], min(cfg.prune_cand, max(n - 1, 1)), cfg.row_block)
    lap("exact_knn")
    vec_s = torch.cat([vectors[:n], torch.zeros((1, vectors.shape[1]), device=device)])
    norm_s = torch.cat([norms[:n], torch.full((1,), INF, device=device)])
    pargs = (cfg.ortho_factor, cfg.ortho_bias, cfg.prune_overflow, cfg.prune_block)
    sel_ids, sel_d = prune_all(vec_s, norm_s, knn_ids, knn_d, cap, *pargs)
    lap("prune")
    inc_src, inc_d = incoming_edges(sel_ids, sel_d, A=min(2 * cap, 4096), sentinel=n)
    merged_ids, merged_d, count = merge_lazy(sel_ids, sel_d, inc_src, inc_d)
    adj0 = finish_rows(vec_s, norm_s, merged_ids, merged_d, count, cap, _round_up(cap, 16), *pargs)
    lap("reverse_pass")
    upper = build_upper_layers(vectors, norms, levels, max_layer, cfg)
    lap("upper_layers")
    same = int((adj0 == engine_adj).all(dim=1).sum())
    out = {"n": n, "build_s": totals, "phases_s": secs, "phases_total_s": t[-1] - t[0], "layers": len(upper),
           "rows_equal_engine_build": f"{same}/{n}", "card": card}
    print("phases: " + "  ".join(f"{k} {v:.3f}s" for k, v in secs.items())
          + f"  (raw graph total {t[-1] - t[0]:.2f}s; {same}/{n} rows equal the engine's)", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
