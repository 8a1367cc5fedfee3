"""Wave-batched incremental construction (counterpart of
expann_tpu/models/wavebuild.py).

The reference inserts one vector at a time: beam-search the live graph for
ef_construction candidates, anti-topo prune, append reverse edges with a
lazy prune (src/antitopo_engine.h:310-465).  As in the JAX package, the
vectors go in *waves* of W inserts against the graph built so far, each
wave plain tensor code on the index's device:

  * one beam search per wave node from the build's medoid
    (``models/search.beam_search``, ``E = wave_expand`` entries a step,
    ``max_iters = 4 * ef_construction + 32``); with ``ortho_count > 1`` the
    penalized passes, each seeded by the previous pass's beam and scored
    against the earlier passes' first places, and their union keeping each
    id's best score (``models/build.ortho_union``);
  * the first C = min(prune_cand, ef_construction) candidates, the
    anti-topo prune (models/prune.py), the forward rows written;
  * the reverse edges appended to the destinations' rows with the
    edge-exists check, and the ``wave_overflow_rows`` fullest rows above
    the cap re-pruned (the deferred lazy prune, src/antitopo_engine.h:
    270-307).  These three steps are the distributed builder's helpers
    (parallel/distbuild.py ``_write_rows``, ``_reverse_scatter``,
    ``_prune_fullest``), the JAX wave module's ``_write_forward``,
    ``_reverse_append`` and ``_overflow_prune``.

Design deviations from the reference, kept from the JAX package: wave
members link only to the graph built before their wave (a bootstrap prefix
is built exactly by the one-shot builder); construction runs on the bottom
layer only, from a fixed medoid, and the upper layers are built one-shot
afterwards; the lazy prune is deferred to wave granularity, with a final
sweep that enforces the cap everywhere.

``extend_index_wave`` continues the waves over a built index (store ->
build -> store -> build accumulates, as the reference's live inserts do);
``refine_index_wave`` re-inserts the first ``frac`` of the corpus against
the finished graph (two-pass Vamana style).

The adjacency and counts are updated in place (the JAX steps donate them).
Not ported: the per-wave and per-sweep ``jax.block_until_ready`` (a
TPU-host workaround), and the padding of a ragged last wave to W rows with
sentinel ids: a sentinel wave row scores +inf everywhere, selects nothing
and is never written, so the ragged wave gives the same graph.  On a CUDA
device every tensor of the build stays on the card; the host reads only
the loop conditions (one per beam iteration) and the sweep's row list.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from expann_tpu_torch.models.build import (
    BuildConfig,
    _round_up,
    best_union,
    build_layer,
    build_upper_layers,
    draw_levels,
    ortho_union,
)
from expann_tpu_torch.models.graph import GraphIndex, make_corpus
from expann_tpu_torch.models.prune import prune_candidates
from expann_tpu_torch.models.search import _gather_dist2, beam_search
from expann_tpu_torch.ops.distance import LANE, pad_dim, squared_norms
from expann_tpu_torch.parallel.distbuild import (
    _dist_overflow_prune,
    _prune_fullest,
    _reverse_scatter,
    _sync,
    _write_rows,
)

INF = float("inf")
BUILD_SWEEP_ROWS = 128  # rows per batch of the build's and extend's cap sweep
REFINE_SWEEP_ROWS = 1024  # rows per batch of refinement's cap sweep


def _insert(vectors, norms, adj, counts, wave_ids, cand_ids, cand_d, cap: int, C: int, cfg: BuildConfig) -> None:
    """The first C candidates (ordered by score) of each wave node pruned
    into its forward row, then the reverse edges and the overflow prune of
    the fullest rows.  Updates ``adj`` and ``counts`` in place."""
    sentinel = vectors.shape[0] - 1
    sel_ids, sel_d = prune_candidates(vectors, norms, cand_ids[:, :C], cand_d[:, :C], cap, cfg.ortho_factor,
                                      cfg.ortho_bias, cfg.prune_overflow, sentinel)
    _write_rows(adj, counts, wave_ids.long(), sel_ids)
    _reverse_scatter(adj, counts, wave_ids, sel_ids, sel_d)
    _prune_fullest(vectors, norms, adj, counts, cap, cfg, cfg.wave_overflow_rows)


def _wave_step(vectors, norms, adj, counts, wave_ids, medoid, cap: int, C: int, ef_c: int, max_iters: int,
               cfg: BuildConfig) -> int:
    """One wave insert (wavebuild.py:151): a beam search per wave node from
    the medoid (``ortho_count`` passes and their union when > 1), the
    prune, the forward rows, the reverse edges and the overflow prune.
    Updates ``adj`` and ``counts`` in place; returns the beam iterations
    the wave's searches ran."""
    sentinel = vectors.shape[0] - 1
    g = wave_ids.long()
    wq, wqn = vectors[g], norms[g]
    iters: List[int] = []
    search = dict(ef=ef_c, max_iters=max_iters, sentinel=sentinel, expand=cfg.wave_expand, iters=iters)
    ep = medoid.reshape(1, 1).expand(wave_ids.shape[0], 1)
    cand_ids, cand_d, _ = beam_search(vectors, norms, adj, wq, wqn, ep, **search)
    if cfg.ortho_count > 1:
        seeds = [cand_ids]

        def penalized(chosen, chosen_valid):
            # each pass starts from the previous pass's beam
            ids, d, _ = beam_search(vectors, norms, adj, wq, wqn, seeds[-1], **search, ortho_chosen=chosen,
                                    ortho_valid=chosen_valid, ortho_factor=cfg.ortho_factor,
                                    ortho_bias=cfg.ortho_bias)
            seeds.append(ids)
            return ids, d

        cand_ids, cand_d = ortho_union(cand_ids, cand_d, cfg.ortho_count, penalized, C, sentinel)
    _insert(vectors, norms, adj, counts, wave_ids, cand_ids, cand_d, cap, C, cfg)
    return sum(iters)


def _refine_step(vectors, norms, adj, counts, wave_ids, medoid, cap: int, C: int, ef_c: int, max_iters: int,
                 cfg: BuildConfig) -> int:
    """One refinement wave (wavebuild.py:526): each node's search is seeded
    by its current row and the medoid; the beam joins the current row at
    exact distances, the node itself masked, each id keeping its best
    score; the prune's result replaces the row; then the reverse edges and
    the overflow prune as in a build wave.  Returns the beam iterations."""
    sentinel = vectors.shape[0] - 1
    g = wave_ids.long()
    wq, wqn = vectors[g], norms[g]
    row = adj[g]  # (W, R) the current edges, sentinel-padded
    iters: List[int] = []
    seeds = torch.cat([row, medoid.reshape(1, 1).expand(row.shape[0], 1)], dim=1)
    cand_ids, cand_d, _ = beam_search(vectors, norms, adj, wq, wqn, seeds, ef_c, max_iters, sentinel,
                                      expand=cfg.wave_expand, iters=iters)
    u_ids = torch.cat([cand_ids, row], dim=1)
    u_d = torch.cat([cand_d, _gather_dist2(vectors, norms, row, wq, wqn)], dim=1)
    drop = (u_ids == wave_ids[:, None]) | (u_ids >= sentinel)
    cand_ids, cand_d = best_union(torch.where(drop, sentinel, u_ids), torch.where(drop, INF, u_d), sentinel)
    _insert(vectors, norms, adj, counts, wave_ids, cand_ids, cand_d, cap, C, cfg)
    return sum(iters)


def _cap_sweep(vectors, norms, adj, counts, cap: int, cfg: BuildConfig, batch: int) -> int:
    """Re-prune every row above the cap, ``batch`` rows at a time, until no
    row is (a pruned row holds at most ``cap`` edges, so one pass does it;
    each row is pruned from its own list alone, so the batch does not change
    the graph).  Returns the rows pruned."""
    n = adj.shape[0] - 1
    total = 0
    while True:
        over = torch.nonzero(counts[:n] > cap).flatten()
        if over.numel() == 0:
            return total
        for r0 in range(0, over.numel(), batch):
            _dist_overflow_prune(vectors, norms, adj, counts, over[r0 : r0 + batch], cap, cfg)
        total += over.numel()


def _working_adjacency(adj_bottom: torch.Tensor, n_old: int, n: int, R: int):
    """The first ``n_old`` rows of ``adj_bottom`` with their sentinel
    ``n_old`` re-written to ``n``, cut or widened with sentinels to R slots,
    as rows of an (n + 1, R) adjacency; and its edge counts."""
    dev = adj_bottom.device
    old = adj_bottom[:n_old, :R]
    adj = torch.full((n + 1, R), n, dtype=torch.int32, device=dev)
    adj[:n_old, : old.shape[1]] = torch.where(old == n_old, n, old)
    return adj, (adj != n).sum(dim=1, dtype=torch.int32)


def _finish(vectors, norms, adj, cap: int, cfg: BuildConfig, fallback_sv, seconds: dict, stats: Optional[dict],
            verbose: bool, label: str) -> GraphIndex:
    """The bottom rows cut to ``round_up(cap, 16)`` slots, the upper layers
    over the whole corpus, and the start vertex: the first member at level
    >= max_layer - 1, else ``fallback_sv``."""
    t0 = time.perf_counter()
    n = vectors.shape[0] - 1
    adj_bottom = adj[:, : _round_up(cap, 16)].contiguous()
    del adj
    levels, max_layer, _ = draw_levels(n, cfg.M, cfg.seed)
    upper = build_upper_layers(vectors, norms, levels, max_layer, cfg)
    members = np.nonzero(levels >= max_layer - 1)[0]
    sv = int(members[0]) if upper and members.size else int(fallback_sv)
    _sync(vectors.device)
    seconds["upper"] = time.perf_counter() - t0
    if stats is not None:
        stats["seconds"] = seconds
    if verbose:
        print(f"{label} seconds: " + " ".join(f"{k}={v:.2f}" for k, v in seconds.items()), flush=True)
    return GraphIndex(vectors=vectors, norms=norms, adj_bottom=adj_bottom, layers=upper, starting_vertex=sv)


def _waves_and_sweep(step: Callable, vectors, norms, adj, counts, medoid, start: int, wave_size: int, ef_c: int,
                     C: int, cfg: BuildConfig, sweep_rows: int, seconds: dict, stats: Optional[dict], label: str,
                     verbose: bool, stop: Optional[int] = None) -> None:
    """``step`` over the rows [start, stop) in waves of ``wave_size`` ids
    (the last one ragged), then the cap sweep, each timed after a device
    sync; each wave's beam iterations and the swept rows go to ``stats``."""
    n = vectors.shape[0] - 1
    stop = n if stop is None else stop
    max_iters = 4 * ef_c + 32  # the JAX convergence bound
    t0 = time.perf_counter()
    iters = []
    for w, i in enumerate(range(start, stop, wave_size)):
        ids = torch.arange(i, min(i + wave_size, stop), dtype=torch.int32, device=adj.device)
        iters.append(step(vectors, norms, adj, counts, ids, medoid, cfg.M0, C, ef_c, max_iters, cfg))
        if verbose and w % 32 == 0:
            print(f"{label}: {i}/{stop} {time.perf_counter() - t0:.1f}s", flush=True)
    _sync(vectors.device)
    seconds["waves"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    swept = _cap_sweep(vectors, norms, adj, counts, cfg.M0, cfg, sweep_rows)
    _sync(vectors.device)
    seconds["cap_sweep"] = time.perf_counter() - t0
    if stats is not None:
        stats.update(waves=len(iters), wave_iterations=iters, swept_rows=swept)
    if verbose:
        print(f"{label}: {len(iters)} waves, {swept} rows swept", flush=True)


def build_index_wave(
    x: np.ndarray,
    cfg: Optional[BuildConfig] = None,
    device="cuda",
    wave_size: int = 1024,
    bootstrap: int = 2048,
    slack: int = 64,
    verbose: bool = False,
    stats: Optional[dict] = None,
) -> GraphIndex:
    """Incremental wave-batched build over the host corpus ``x`` (n, D) on
    ``device`` (wavebuild.py:259): a one-shot bootstrap of the first
    ``min(n, max(bootstrap, 2 * M0))`` rows, then waves of ``wave_size``
    inserts from the bootstrap's medoid in a working adjacency of
    ``round_up(M0 + slack, 16)`` slots, the cap sweep, and the upper layers.
    ``stats``, when given, receives the stage seconds (bootstrap, waves,
    cap_sweep, upper; each read after a device sync), the waves, each
    wave's beam iterations and the swept rows."""
    cfg = cfg or BuildConfig()
    device = torch.device(device)
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n == 0:
        raise ValueError("no vectors to build from")
    cap = cfg.M0
    R = _round_up(cap + slack, 16)
    seconds = {}
    t0 = time.perf_counter()
    vectors, norms = make_corpus(x, device)
    adj = torch.full((n + 1, R), n, dtype=torch.int32, device=device)
    counts = torch.zeros((n + 1,), dtype=torch.int32, device=device)

    # the bootstrap prefix, built exactly; its local sentinel n0 -> n
    n0 = min(n, max(bootstrap, 2 * cap))
    boot = build_layer(vectors[:n0], norms[:n0], cap, cfg)
    _write_rows(adj, counts, torch.arange(n0, device=device), torch.where(boot == n0, n, boot))
    # the build's entry: the bootstrap row nearest the bootstrap's mean
    mean = vectors[:n0].mean(dim=0, keepdim=True)
    ids = torch.arange(n0, dtype=torch.int32, device=device)[None, :]
    medoid = torch.argmin(_gather_dist2(vectors, norms, ids, mean, squared_norms(mean))[0]).to(torch.int32)
    _sync(device)
    seconds["bootstrap"] = time.perf_counter() - t0

    C = min(cfg.prune_cand, cfg.ef_construction)
    _waves_and_sweep(_wave_step, vectors, norms, adj, counts, medoid, n0, wave_size, cfg.ef_construction, C, cfg,
                     BUILD_SWEEP_ROWS, seconds, stats, "wave build", verbose)
    return _finish(vectors, norms, adj, cap, cfg, medoid, seconds, stats, verbose, "wave build")


def extend_index_wave(
    graph: GraphIndex,
    new_x: np.ndarray,
    cfg: Optional[BuildConfig] = None,
    wave_size: int = 1024,
    slack: int = 64,
    verbose: bool = False,
    stats: Optional[dict] = None,
) -> GraphIndex:
    """Extend a built index with the host rows ``new_x`` (wavebuild.py:392):
    the combined corpus on the index's device, the old bottom rows (their
    sentinel re-written, widened to the working width), waves of the new
    rows from ``graph.starting_vertex``, the cap sweep over every row, and
    the upper layers over the combined corpus (``draw_levels`` is
    prefix-stable, so the old rows draw the levels of the original build).
    The serving caches (packed layout, codes) are not carried over: the
    engine rebuilds them on demand.  Raises ``ValueError`` when the new
    rows pad to another width than the index's."""
    cfg = cfg or BuildConfig()
    new_x = np.asarray(new_x, np.float32)
    if new_x.ndim != 2 or new_x.shape[0] == 0:
        raise ValueError("new_x must be a non-empty (n, D) array")
    device = graph.vectors.device
    n_old = graph.n
    n = n_old + new_x.shape[0]
    cap = cfg.M0
    d_pad = graph.vectors.shape[1]
    new_rows = pad_dim(new_x, LANE)
    if new_rows.shape[1] != d_pad:
        raise ValueError(f"dimension mismatch: the index pads to {d_pad}, the new rows to {new_rows.shape[1]}")
    seconds = {}
    t0 = time.perf_counter()
    vectors = torch.cat([graph.vectors[:n_old], torch.from_numpy(new_rows).to(device),
                         torch.zeros((1, d_pad), dtype=torch.float32, device=device)])
    norms = squared_norms(vectors)
    norms[n] = INF
    adj, counts = _working_adjacency(graph.adj_bottom, n_old, n, _round_up(cap + slack, 16))
    medoid = torch.tensor(graph.starting_vertex, dtype=torch.int32, device=device)
    _sync(device)
    seconds["corpus"] = time.perf_counter() - t0

    C = min(cfg.prune_cand, cfg.ef_construction)
    _waves_and_sweep(_wave_step, vectors, norms, adj, counts, medoid, n_old, wave_size, cfg.ef_construction, C, cfg,
                     BUILD_SWEEP_ROWS, seconds, stats, "extend build", verbose)
    return _finish(vectors, norms, adj, cap, cfg, graph.starting_vertex, seconds, stats, verbose, "extend build")


def refine_index_wave(
    graph: GraphIndex,
    cfg: Optional[BuildConfig] = None,
    frac: float = 0.5,
    wave_size: int = 4096,
    refine_ef: int = 0,
    slack: int = 64,
    verbose: bool = False,
    stats: Optional[dict] = None,
) -> GraphIndex:
    """Second-pass refinement (wavebuild.py:609): the first ``int(n *
    frac)`` rows re-inserted against the finished graph in waves of
    ``wave_size`` (``_refine_step``, at ``refine_ef``, default
    ``ef_construction``), the cap sweep in batches of 1024 until no row is
    above the cap, the rows cut to the serving width, the upper layers
    rebuilt.  The serving caches are not carried over."""
    cfg = cfg or BuildConfig()
    vectors, norms = graph.vectors, graph.norms
    n = graph.n
    ef_c = refine_ef or cfg.ef_construction
    C = min(cfg.prune_cand or ef_c, ef_c)
    seconds = {}
    adj, counts = _working_adjacency(graph.adj_bottom, n, n, _round_up(cfg.M0 + slack, 16))
    medoid = torch.tensor(graph.starting_vertex, dtype=torch.int32, device=vectors.device)
    _waves_and_sweep(_refine_step, vectors, norms, adj, counts, medoid, 0, wave_size, ef_c, C, cfg,
                     REFINE_SWEEP_ROWS, seconds, stats, "refine", verbose, stop=int(n * frac))
    return _finish(vectors, norms, adj, cfg.M0, cfg, graph.starting_vertex, seconds, stats, verbose, "refine")
