"""Construction of ONE global graph over a mesh of devices (counterpart of
expann_tpu/parallel/distbuild.py).

``mesh`` is a device or a tuple of devices (``parallel/sharded.make_mesh``);
with S devices the corpus and the adjacency are row-sharded: shard s, on
``mesh[s]``, holds the global rows ``s * n_shard`` onward plus its own
sentinel row, the last shard padded with +inf-norm rows
(``sharded.ShardedRows``, the JAX ``_g2sl`` global -> (shard, local) map).
Adjacency entries are global ids, the global sentinel ``S * n_shard``.  One
device is S = 1 (a global id is a row, the sentinel row n), the route
``build_index`` takes above ``auto_wave_threshold`` rows.  The function
names are the JAX ones.

  * phase 1, waves of W rows in id order: candidates for every wave node,
    the anti-topo prune (models/prune.py, on ``mesh[0]``), the pruned rows
    written as the nodes' forward rows on their owners.  Candidates come
    from every shard on its device and merge by (d, id) (``merge_lists``):
    either a dense exact scan of the wave against the shard in column
    blocks (models/build.penalized_topk; with ``ortho_count > 1`` the
    penalized passes, merged per pass, and their union, models/build.ortho_union)
    or, above 65536 rows a shard, flat scans of each shard in segments
    through ``ops.topk.flat_topk`` (the flat top-k kernel K2 on the card):
    ``n_seg = ceil((C + 1) / 128)`` segments of each shard at ``k = min(C +
    1, 128)``, so memory stays O(W * C) whatever the corpus size.  A segment
    contributes at most its 128 best, so a list wider than 128 is
    near-exact on shuffled data, as in the JAX package.
  * phase 2 (one-shot), the same waves again: each node's final forward
    row, its edge distances recomputed, appended as reverse edges to the
    destinations' rows (``_reverse_scatter``; an edge already present is
    skipped, src/antitopo_engine.h:442-450); then the ``overflow_rows``
    fullest rows above the cap are re-pruned (the deferred lazy prune,
    src/antitopo_engine.h:270-307).
  * a final sweep re-prunes every row still above the cap; the bottom rows
    are cut to ``round_up(cap, 16)`` slots and assembled into one graph on
    ``mesh[0]``; the upper layers come from the one-shot builder; the start
    vertex is the first member of the top layer, or the medoid of the first
    4096 rows.

The steps below index the corpus and the adjacency by global id; on one
device they are tensors, on S devices ``ShardedRows``, which gather onto
``mesh[0]`` and write to each id's owner, so the same steps serve both.

``mode="incremental"`` mirrors the reference's insertion order instead: a
one-shot bootstrap prefix, then waves whose dense candidates come only from
rows already inserted, with the reverse edges and the overflow prune inside
each wave.

The adjacency and counts are updated in place (the JAX steps donate them).
Not ported: the per-wave ``block_until_ready`` (a TPU-host workaround; a
wave here syncs the host where a mask's size is read), the ``interpret``
switch, and the 1e4-valued pad rows of the JAX flat corpus: the kernel
masks a ragged last tile itself, so a shard's flat corpus holds its real
rows only.  The final sweep prunes 2048 rows a batch (the
JAX package: 128); each row is pruned from its own list alone, so the
batch does not change the graph.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from expann_tpu_torch.models.build import (
    BuildConfig,
    _round_up,
    _stable_order,
    build_layer,
    build_upper_layers,
    draw_levels,
    ortho_union,
    penalized_topk,
    sort_rows,
)
from expann_tpu_torch.models.graph import GraphIndex, make_corpus
from expann_tpu_torch.models.prune import prune_candidates
from expann_tpu_torch.ops.distance import LANE, pad_dim, squared_norms
from expann_tpu_torch.ops.topk import K_MAX, flat_topk
from expann_tpu_torch.parallel.sharded import as_mesh, merge_lists, table, table_parts

INF = float("inf")
FLAT_BLOCK = 1024  # segment alignment: the JAX flat kernel's corpus block
FLAT_MIN_ROWS = 65536  # candidates="auto" scans flat above this many rows
SWEEP_ROWS = 2048  # rows per batch of the final cap sweep


def _prune_args(cfg: BuildConfig) -> tuple:
    return cfg.ortho_factor, cfg.ortho_bias, cfg.prune_overflow


def _dense_candidates(
    vectors, norms, wq, wave_gids, frontier: int, C: int, cfg: BuildConfig, chosen=None, chosen_valid=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense candidates of one wave (distbuild.py:104-162, 226-231): on each
    shard of the corpus, its rows below ``frontier`` scored against the
    wave (the plain distance, or with ``chosen`` ids the ortho-penalized
    score against their rows) by ``penalized_topk`` in column blocks of
    ``cfg.col_block``, the wave node itself excluded, its C best by
    (score, id); the shards' lists merged.  Non-finite slots carry the
    sentinel."""
    parts_v, ns = table_parts(vectors)
    parts_n, _ = table_parts(norms)
    G = len(parts_v) * ns
    qn = squared_norms(wq)
    if chosen is not None:
        ch = torch.clamp_max(chosen.long(), G)
        chosen = (vectors[ch], norms[ch])
    lists = []
    for s, (v, nm) in enumerate(zip(parts_v, parts_n)):
        off, dev = s * ns, v.device
        ids, d = penalized_topk(
            wq.to(dev), qn.to(dev), (wave_gids - off).to(dev), v, nm, min(max(frontier - off, 0), ns), C,
            cfg.col_block, None if chosen is None else (chosen[0].to(dev), chosen[1].to(dev)),
            None if chosen_valid is None else chosen_valid.to(dev), cfg.ortho_factor, cfg.ortho_bias,
        )
        d, ids = _pad_to(d, ids.to(torch.int32) + off, C, G)
        lists.append((torch.where(torch.isfinite(d), ids, G).to(wq.device), d.to(wq.device)))
    ids, d = merge_lists(lists, C)
    return torch.where(torch.isfinite(d), ids, G), d


def _pad_to(d, ids, C: int, sentinel: int):
    """Pad (d, ids) to C columns with (+inf, sentinel)."""
    if d.shape[1] >= C:
        return d, ids
    pad = C - d.shape[1]
    return (torch.nn.functional.pad(d, (0, pad), value=INF),
            torch.nn.functional.pad(ids, (0, pad), value=sentinel))


def flat_segments(n: int, C: int) -> Tuple[int, int]:
    """``(seg_rows, kk)`` of the flat scan of n rows for C candidates: the
    JAX boundaries (rows padded to 1024, ``n_seg = ceil((C + 1) / 128)``
    segments, ``seg_rows`` rounded up to 1024) and ``kk = min(C + 1, 128)``
    candidates a segment."""
    n_seg = (C + 1 + K_MAX - 1) // K_MAX
    return _round_up(_round_up(n, FLAT_BLOCK) // n_seg, FLAT_BLOCK), min(C + 1, K_MAX)


def _flat_candidates(
    xs, wq, wave_gids, C: int, topk_mode: str, seg_n: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat-scan candidates of one wave on one corpus (distbuild.py:163-224):
    ``xs`` (n, D) bf16 in the segments ``flat_segments(seg_n or n, C)``
    gives (a shard's segments follow the JAX boundaries of its padded
    width), each scanned by ``flat_topk`` at ``kk`` (K2 on the card, its
    plain version on the CPU); empty slots (id -1), ids >= n and the wave
    node itself are masked to (+inf, sentinel n), and the segments' lists
    merged by (d, id) to C."""
    n = xs.shape[0]
    seg_rows, kk = flat_segments(seg_n or n, C)
    parts_d, parts_i = [], []
    for s0 in range(0, n, seg_rows):
        ids, d = flat_topk(wq, xs[s0 : s0 + seg_rows], kk, mode=topk_mode)
        gid = ids + s0
        bad = (ids < 0) | (gid >= n) | (gid == wave_gids[:, None])
        parts_d.append(torch.where(bad, INF, d))
        parts_i.append(torch.where(bad, n, gid))
    d, ids = _pad_to(torch.cat(parts_d, dim=1), torch.cat(parts_i, dim=1), C, n)
    # segments ascend in id and each is (d, id)-ordered: a stable sort by d
    # orders the concatenation by (d, id)
    d, o = torch.sort(d, dim=1, stable=True)
    d, ids = d[:, :C], ids.gather(1, o[:, :C])
    return torch.where(torch.isfinite(d), ids, n), d


def _sharded_flat_candidates(
    xs, n_shard: int, wq, wave_gids, C: int, topk_mode: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat-scan candidates of one wave over the shards' flat corpora ``xs``
    (shard s's real rows, on its device): every shard's scans enqueued, then
    the lists moved to the wave's device and merged by (d, id) to C;
    non-finite slots carry the global sentinel."""
    G = len(xs) * n_shard
    lists = []
    for s, x in enumerate(xs):
        off, dev = s * n_shard, x.device
        ids, d = _flat_candidates(x, wq.to(dev), (wave_gids - off).to(dev), C, topk_mode, seg_n=n_shard)
        lists.append((torch.where(torch.isfinite(d), ids + off, G).to(wq.device), d.to(wq.device)))
    return merge_lists(lists, C)


def _write_rows(adj, counts, rows, sel_ids) -> None:
    """Rows ``rows`` of ``adj`` become ``sel_ids`` padded with the sentinel;
    their counts the number of real ids."""
    sentinel = adj.shape[0] - 1
    R, cap = adj.shape[1], sel_ids.shape[1]
    adj[rows] = torch.nn.functional.pad(sel_ids, (0, R - cap), value=sentinel)
    counts[rows] = (sel_ids != sentinel).sum(dim=1, dtype=torch.int32)


def _dist_wave_step(
    vectors, norms, adj, counts, wq, wave_gids, frontier: int, C: int, cap: int, cfg: BuildConfig,
    overflow_rows: int, reverse: bool = True, xs=None, topk_mode: str = "count",
) -> None:
    """One insert wave (distbuild.py:79): candidates (dense, or flat scans
    of the shards' flat corpora ``xs`` when given), the prune, the forward
    rows, and with ``reverse`` the reverse edges and the overflow prune.
    Updates ``adj`` and ``counts`` in place."""
    sentinel = vectors.shape[0] - 1
    if xs is None:
        cand_ids, cand_d = _dense_candidates(vectors, norms, wq, wave_gids, frontier, C, cfg)
        if cfg.ortho_count > 1:

            def penalized(chosen, chosen_valid):
                return _dense_candidates(vectors, norms, wq, wave_gids, frontier, C, cfg, chosen, chosen_valid)

            cand_ids, cand_d = ortho_union(cand_ids, cand_d, cfg.ortho_count, penalized, C, sentinel)
    else:
        if cfg.ortho_count > 1:
            raise ValueError("ortho_count > 1 needs dense candidates: the flat scan ranks raw distances only")
        cand_ids, cand_d = _sharded_flat_candidates(xs, table_parts(vectors)[1], wq, wave_gids, C, topk_mode)
    sel_ids, sel_d = prune_candidates(vectors, norms, cand_ids, cand_d, cap, *_prune_args(cfg), sentinel)
    _write_rows(adj, counts, wave_gids.long(), sel_ids)
    if reverse:
        _reverse_scatter(adj, counts, wave_gids, sel_ids, sel_d)
        _prune_fullest(vectors, norms, adj, counts, cap, cfg, overflow_rows)


def _dist_reverse_step(vectors, norms, adj, counts, wave_gids, cap: int, cfg: BuildConfig, overflow_rows: int) -> None:
    """One-shot phase 2 for one wave (distbuild.py:310): the wave nodes'
    forward rows, their distances recomputed, appended as reverse edges;
    then the fullest rows re-pruned."""
    sentinel = vectors.shape[0] - 1
    g = wave_gids.long()
    fwd = adj[g][:, :cap]
    fl = fwd.long()
    sel_d = norms[g][:, None] + norms[fl] - 2.0 * torch.einsum("wd,wcd->wc", vectors[g], vectors[fl])
    sel_d = torch.where(fwd == sentinel, INF, sel_d)
    _reverse_scatter(adj, counts, wave_gids, fwd, sel_d)
    _prune_fullest(vectors, norms, adj, counts, cap, cfg, overflow_rows)


def _reverse_scatter(adj, counts, src_gids, sel_ids, sel_d) -> None:
    """Append the reverse edges dst <- src of the edges ``sel_ids`` of the
    rows ``src_gids`` into free slots of the destinations' rows
    (distbuild.py:346): edges sorted by (dst, d, src); an edge whose source
    is already in the destination's row is skipped; the kept ones of a
    destination go to consecutive slots from its count.  Each (dst, slot)
    is written at most once, and slots past the row width are dropped
    before the write.  Updates ``adj`` and ``counts`` in place."""
    sentinel = adj.shape[0] - 1
    R = adj.shape[1]
    W, cap = sel_ids.shape
    src = src_gids[:, None].expand(W, cap).reshape(-1)
    d = sel_d.reshape(-1)
    dst = torch.where(torch.isfinite(d) & (src < sentinel), sel_ids.reshape(-1), sentinel)
    order = _stable_order(dst, d, src)
    dst_s, src_s = dst[order].long(), src[order]
    idx = torch.arange(dst_s.shape[0], device=adj.device)
    first = torch.ones_like(dst_s, dtype=torch.bool)
    first[1:] = dst_s[1:] != dst_s[:-1]
    group_start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    exists = (adj[dst_s] == src_s[:, None]).any(dim=1)
    keep = (dst_s != sentinel) & ~exists
    kint = keep.long()
    ecs = torch.cumsum(kint, dim=0) - kint  # exclusive prefix count of kept edges
    write_pos = counts[dst_s].long() + ecs - ecs[group_start]
    ok = keep & (write_pos < R)
    rows, cols = dst_s[ok], write_pos[ok]
    adj[rows, cols] = src_s[ok].to(adj.dtype)
    counts.index_add_(0, rows, torch.ones_like(rows, dtype=counts.dtype))


def _prune_fullest(vectors, norms, adj, counts, cap: int, cfg: BuildConfig, overflow_rows: int) -> None:
    """Re-prune the ``overflow_rows`` fullest rows that are above the cap
    (distbuild.py:293-303): ties in the count go to the lower row, as
    ``jax.lax.top_k`` breaks them."""
    n = adj.shape[0] - 1
    order = torch.sort(-counts[:n], stable=True).indices[:overflow_rows]
    rows = order[counts[order] > cap]
    if rows.numel():
        _dist_overflow_prune(vectors, norms, adj, counts, rows, cap, cfg)


def _dist_overflow_prune(vectors, norms, adj, counts, rows, cap: int, cfg: BuildConfig) -> None:
    """Re-prune rows ``rows`` over their full edge lists, ordered by
    (d, id) (distbuild.py:386).  Updates ``adj`` and ``counts`` in place."""
    sentinel = adj.shape[0] - 1
    cand_ids = adj[rows]
    cl = cand_ids.long()
    cand_d = norms[rows][:, None] + norms[cl] - 2.0 * torch.einsum("pd,prd->pr", vectors[rows], vectors[cl])
    cand_d = torch.where(cand_ids == sentinel, INF, cand_d)
    cand_d, cand_ids = sort_rows(cand_d, cand_ids)
    sel_ids, _ = prune_candidates(vectors, norms, cand_ids, cand_d, cap, *_prune_args(cfg), sentinel)
    _write_rows(adj, counts, rows, sel_ids)


def _sync(*devices: torch.device) -> None:
    for device in set(devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _shard_corpus(x: np.ndarray, mesh, n_shard: int):
    """Per shard s, on ``mesh[s]``: the corpus rows ``s * n_shard`` onward
    as ``make_corpus`` lays them out (row ``n_shard`` the +inf-norm
    sentinel), the last shard's missing rows +inf-norm padding; and its
    real row count."""
    out = []
    for s, dev in enumerate(mesh):
        v, nm = make_corpus(x[s * n_shard : (s + 1) * n_shard], dev)
        real = v.shape[0] - 1
        pad = n_shard - real
        if pad:
            v = torch.cat([v, torch.zeros((pad, v.shape[1]), device=dev)])
            nm = torch.cat([nm, torch.full((pad,), INF, device=dev)])
        out.append((v, nm, real))
    return out


def build_distributed(
    x: np.ndarray,
    cfg: Optional[BuildConfig] = None,
    mesh=None,
    wave_size: int = 1024,
    bootstrap: int = 2048,
    slack: int = 64,
    mode: str = "oneshot",
    candidates: str = "auto",
    verbose: bool = False,
    topk_mode: str = "count",
) -> Tuple[GraphIndex, dict]:
    """Build one graph over the host corpus ``x`` (n, D) on ``mesh`` (a
    device, or a tuple of S devices, the rows split into S contiguous
    shards; by default every visible CUDA device) in waves of
    ``wave_size`` (distbuild.py:435).  ``mode``: "oneshot" (candidates over
    the whole corpus; forward rows first, reverse edges from the final
    forward rows) or "incremental" (a one-shot bootstrap of ``min(n,
    max(bootstrap, 2 cap), n_shard)`` rows, then candidates among rows
    already inserted).  ``candidates``: "dense", "flat" (one-shot only; the
    flat top-k scan in ``topk_mode``, K2 with "count") or "auto" (flat above
    65536 rows a shard in one-shot mode); ``ortho_count > 1`` forces dense.
    Returns the index, on ``mesh[0]``, and stats: ``n_shards``,
    ``n_shard``, ``candidates``, ``waves`` (the JAX keys) and ``seconds`` per
    stage (bootstrap, forward, reverse, cap_sweep, upper), each read after
    a device sync."""
    if mode not in ("oneshot", "incremental"):
        raise ValueError(f"mode={mode!r}: 'oneshot' or 'incremental'")
    if candidates not in ("auto", "dense", "flat"):
        raise ValueError(f"candidates={candidates!r}: 'auto', 'dense' or 'flat'")
    cfg = cfg or BuildConfig()
    mesh = as_mesh(mesh)
    dev0, S = mesh[0], len(mesh)
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    ns = (n + S - 1) // S
    G = S * ns  # the global sentinel
    cap = cfg.M0
    R = _round_up(cap + slack, 16)
    C = min(cfg.prune_cand, cfg.ef_construction) if cfg.prune_cand else min(cfg.ef_construction, 4 * cap)
    overflow_rows = min(128, G)

    shards = _shard_corpus(x, mesh, ns)
    vectors = table([v for v, _, _ in shards], ns)
    norms = table([nm for _, nm, _ in shards], ns)
    adj = table([torch.full((ns + 1, R), G, dtype=torch.int32, device=dev) for dev in mesh], ns)
    counts = table([torch.zeros((ns + 1,), dtype=torch.int32, device=dev) for dev in mesh], ns)
    levels, max_layer, _ = draw_levels(n, cfg.M, cfg.seed)
    seconds = {}
    t0 = time.perf_counter()

    n0 = 0
    if mode == "incremental":
        # the bootstrap rows lie in shard 0
        n0 = min(n, max(bootstrap, 2 * cap), ns)
        v0, nm0, _ = shards[0]
        boot = build_layer(v0[:n0], nm0[:n0], cap, cfg)
        _write_rows(adj, counts, torch.arange(n0, device=dev0), torch.where(boot == n0, G, boot))
    _sync(*mesh)
    seconds["bootstrap"] = time.perf_counter() - t0

    if candidates == "auto":
        candidates = "flat" if (mode == "oneshot" and ns > FLAT_MIN_ROWS) else "dense"
    if cfg.ortho_count > 1 and candidates == "flat":
        candidates = "dense"  # the penalized passes need dense scoring
    xs = None
    if candidates == "flat":
        if mode != "oneshot":
            raise ValueError("flat candidates need mode='oneshot'")
        if wave_size % 256:
            raise ValueError(f"flat candidates need wave_size % 256 == 0, not {wave_size}")
        xs = tuple(v[:real].to(torch.bfloat16) for v, _, real in shards)
    del shards

    def waves(start: int):
        for i in range(start, n, wave_size):
            yield i, torch.arange(i, min(i + wave_size, n), dtype=torch.int32, device=dev0)

    # ---- phase 1: candidates, prune, forward rows ----
    t0 = time.perf_counter()
    for w, (i, gids) in enumerate(waves(n0)):
        _dist_wave_step(
            vectors, norms, adj, counts, vectors[gids.long()], gids,
            i if mode == "incremental" else n, C, cap, cfg, overflow_rows,
            reverse=mode == "incremental", xs=xs, topk_mode=topk_mode,
        )
        if verbose and w % 32 == 0:
            print(f"distributed build fwd: {i}/{n} {time.perf_counter() - t0:.1f}s", flush=True)
    _sync(*mesh)
    seconds["forward"] = time.perf_counter() - t0
    del xs

    # ---- phase 2 (one-shot): reverse edges from the final forward rows ----
    t0 = time.perf_counter()
    if mode == "oneshot":
        for w, (i, gids) in enumerate(waves(0)):
            _dist_reverse_step(vectors, norms, adj, counts, gids, cap, cfg, overflow_rows)
            if verbose and w % 32 == 0:
                print(f"distributed build rev: {i}/{n} {time.perf_counter() - t0:.1f}s", flush=True)
    _sync(*mesh)
    seconds["reverse"] = time.perf_counter() - t0

    # ---- final sweep: enforce the cap everywhere ----
    t0 = time.perf_counter()
    over = torch.nonzero(counts[:G] > cap).flatten()
    for r0 in range(0, over.numel(), SWEEP_ROWS):
        _dist_overflow_prune(vectors, norms, adj, counts, over[r0 : r0 + SWEEP_ROWS], cap, cfg)
    _sync(*mesh)
    seconds["cap_sweep"] = time.perf_counter() - t0

    # ---- assemble the graph on mesh[0] ----
    t0 = time.perf_counter()
    R0 = _round_up(cap, 16)
    rows = torch.cat([a[:ns, :R0].to(dev0) for a in table_parts(adj)[0]])[:n]
    # ids >= n are the last shard's padding rows or the global sentinel
    adj_bottom = torch.cat([torch.where(rows >= n, n, rows), torch.full((1, R0), n, dtype=torch.int32, device=dev0)])
    del adj, counts, rows
    if S > 1:
        del vectors, norms
        vectors, norms = make_corpus(x, dev0)
    upper = build_upper_layers(vectors, norms, levels, max_layer, cfg)
    if upper:
        members = np.nonzero(levels >= max_layer - 1)[0]
        sv = int(members[0])
    else:
        vf = pad_dim(x[: max(n0, min(n, 4096))], LANE)
        sv = int(np.argmin(((vf - vf.mean(0, keepdims=True)) ** 2).sum(1)))
    _sync(*mesh)
    seconds["upper"] = time.perf_counter() - t0
    if verbose:
        print("distributed build seconds: " + " ".join(f"{k}={v:.2f}" for k, v in seconds.items()), flush=True)

    graph = GraphIndex(vectors=vectors, norms=norms, adj_bottom=adj_bottom, layers=upper, starting_vertex=sv)
    stats = {"n_shards": S, "n_shard": ns, "candidates": candidates,
             "waves": (n - n0 + wave_size - 1) // wave_size, "seconds": seconds}
    return graph, stats
