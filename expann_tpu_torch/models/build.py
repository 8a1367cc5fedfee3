"""One-shot index construction (counterpart of the one-shot route of
expann_tpu/models/build.py).

The reference inserts one vector at a time (src/antitopo_engine.h:310-465
``_store_vector``).  As in the JAX package, the build is restructured into
dense passes, each plain tensor code on the index's device:

  1. draw every node's HNSW layer up front (numpy, the JAX package's exact
     draws: floor(-ln U / ln M), src/antitopo_engine.h:323),
  2. per layer, exact k-NN candidates among the layer's members, ordered
     by (d, id),
  3. the batched anti-topo prune (models/prune.py) over all members,
  4. one reverse pass: incoming edges are appended after the forward ones
     (skipping edges already present, src/antitopo_engine.h:442-450);
     rows within the edge cap keep append order, overflowing rows are
     re-pruned over their (d, id)-sorted union.

With ``ortho_count > 1`` step 2 runs ``ortho_count`` passes, as the
reference runs that many searches per insert (src/antitopo_engine.h:396-423):
pass 0 is the plain k-NN, pass i an exact scan by the ortho-penalized score
against the first-place ids of the earlier passes (``ortho_knn``), and the
union keeps each id's best carried score.

Controlled divergence kept from the JAX package (reverse-pass cap):
incoming edges per destination go into A = min(2*cap, 4096) slots in
(source chunk of 8192 rows, d, source) order; a hub receiving more drops
the excess.

``build_index`` sends a corpus above ``auto_wave_threshold`` rows (or
``builder="dist"``) to the one-device distributed builder
(parallel/distbuild.py), as the JAX package does, and ``builder="wave"`` to
the wave builder (models/wavebuild.py); either may be followed by the
refinement pass (``refine_frac``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from expann_tpu_torch.models.graph import GraphIndex, UpperLayer, make_corpus
from expann_tpu_torch.models.prune import prune_candidates
from expann_tpu_torch.ops.distance import pairwise_dist2
from expann_tpu_torch.utils.profiling import StageClock, no_stage

INF = float("inf")
REVERSE_CHUNK_ROWS = 8192  # source-row chunk of the JAX reverse pass


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def draw_levels(n: int, M: int, seed: int = 0) -> Tuple[np.ndarray, int, int]:
    """Per-node geometric layer draws + resulting max_layer/starting_vertex.

    Same law as the reference (floor(-ln U / ln M),
    src/antitopo_engine.h:323) and the same numpy draws as the JAX package;
    starting_vertex replays the sequential update rule
    (src/antitopo_engine.h:459-462).
    """
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    u = np.clip(u, 1e-300, 1.0 - 1e-16)
    levels = np.floor(-np.log(u) / math.log(M)).astype(np.int32)
    max_layer = 0
    sv = 0
    for i in range(n):
        while levels[i] >= max_layer:
            max_layer += 1
            sv = i
    return levels, max_layer, sv


def exact_knn(
    vecs: torch.Tensor, norms: torch.Tensor, C: int, row_block: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact C nearest neighbours of every row among all rows (self
    excluded), ordered by (d, id): returns ``(ids, d)`` of shape (n, C)."""
    n = vecs.shape[0]
    dev = vecs.device
    ids = torch.empty((n, C), dtype=torch.int32, device=dev)
    dist = torch.empty((n, C), dtype=torch.float32, device=dev)
    for s in range(0, n, row_block):
        e = min(s + row_block, n)
        d2 = pairwise_dist2(vecs[s:e], vecs, x_norms=norms, q_norms=norms[s:e])
        r = torch.arange(e - s, device=dev)
        d2[r, s + r] = INF
        d_s, idx = torch.sort(d2, dim=1, stable=True)
        ids[s:e] = idx[:, :C].to(torch.int32)
        dist[s:e] = d_s[:, :C]
    return ids, dist


def sort_rows(primary: torch.Tensor, secondary: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each row of ``(primary, secondary)`` lexicographically
    (``jax.lax.sort`` with ``num_keys=2``): returns both, reordered."""
    o = torch.sort(secondary, dim=1, stable=True).indices
    p, s = primary.gather(1, o), secondary.gather(1, o)
    o = torch.sort(p, dim=1, stable=True).indices
    return p.gather(1, o), s.gather(1, o)


def penalized_topk(
    qv: torch.Tensor,  # (r, D) query rows
    qn: torch.Tensor,  # (r,) their squared norms
    qids: torch.Tensor,  # (r,) their own ids, scored +inf
    vecs: torch.Tensor,  # (>= frontier, D) candidate rows
    norms: torch.Tensor,
    frontier: int,
    C: int,
    col_block: int,
    chosen: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # rows (r, OC, D), norms (r, OC)
    chosen_valid: Optional[torch.Tensor] = None,  # (r, OC) bool
    ortho_factor: float = 0.0,
    ortho_bias: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-C of the rows ``qv`` among rows [0, frontier) of ``vecs``
    by the squared distance or, with ``chosen`` (the rows and norms of
    previously chosen entry points), the ortho-penalized score
    (src/antitopo_engine.h:342-351):

        score(c) = d2(q, c) + sum over valid chosen p of
                   [d2(p, c) < d2(q, c)] * (ortho_factor * (d2(q, c) - d2(p, c)) + ortho_bias)

    streamed over blocks of ``col_block`` columns with a running top-C, so
    memory is O(r * (C + OC * col_block)) whatever the corpus size.  A
    row's own id scores +inf.  Returns ``(ids, score)`` int64 / f32 of shape
    (r, min(C, frontier)), ordered by (score, id)."""
    r = qv.shape[0]
    dev = qv.device
    if chosen is not None:
        pv, pn = chosen[0].float(), chosen[1]
    run_s = torch.empty((r, 0), dtype=torch.float32, device=dev)
    run_i = torch.empty((r, 0), dtype=torch.int64, device=dev)
    rows = torch.arange(r, device=dev)
    for c in range(0, frontier, col_block):
        ce = min(c + col_block, frontier)
        xv, xn = vecs[c:ce], norms[c:ce]
        score = pairwise_dist2(qv, xv, x_norms=xn, q_norms=qn)
        if chosen is not None:
            co = pn[:, :, None] + xn[None, None, :] - 2.0 * torch.einsum("rod,cd->roc", pv, xv.float())
            hit = (co < score[:, None, :]) & chosen_valid[:, :, None]
            pen = torch.where(hit, ortho_factor * (score[:, None, :] - co) + ortho_bias, 0.0)
            score = score + pen.sum(dim=1)
        own = (qids >= c) & (qids < ce)
        score[rows[own], (qids[own] - c).long()] = INF
        # columns ascend, so a stable sort of [running, block] by score
        # keeps ties in id order
        blk_s, idx = torch.sort(score, dim=1, stable=True)
        kk = min(C, ce - c)
        run_s = torch.cat([run_s, blk_s[:, :kk]], dim=1)
        run_i = torch.cat([run_i, idx[:, :kk] + c], dim=1)
        o = torch.sort(run_s, dim=1, stable=True).indices[:, :C]
        run_s, run_i = run_s.gather(1, o), run_i.gather(1, o)
    return run_i, run_s


def ortho_knn(
    vecs: torch.Tensor,  # (n, D)
    norms: torch.Tensor,  # (n,)
    chosen: torch.Tensor,  # (n, OC) ids of previously chosen entry points
    chosen_valid: torch.Tensor,  # (n, OC) bool
    ortho_factor: float,
    ortho_bias: float,
    C: int,
    row_block: int,
    col_block: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-C of every row among all rows by the ortho-penalized score
    (counterpart of ``ortho_knn_device``): ``penalized_topk`` over blocks of
    ``row_block`` rows, the self column +inf.  Returns ``(ids, score)`` of
    shape (n, C) ordered by (score, id); the carried value is the penalized
    score, which feeds the prune (src/antitopo_engine.h:415-423)."""
    n = vecs.shape[0]
    dev = vecs.device
    ids_out = torch.full((n, C), n, dtype=torch.int32, device=dev)
    s_out = torch.full((n, C), INF, dtype=torch.float32, device=dev)
    for s in range(0, n, row_block):
        e = min(s + row_block, n)
        ch = torch.clamp_max(chosen[s:e].long(), n - 1)
        ids, sc = penalized_topk(vecs[s:e], norms[s:e], torch.arange(s, e, device=dev), vecs, norms, n, C,
                                 col_block, (vecs[ch], norms[ch]), chosen_valid[s:e], ortho_factor, ortho_bias)
        s_out[s:e, : sc.shape[1]] = sc
        ids_out[s:e, : sc.shape[1]] = ids.to(torch.int32)
    return ids_out, s_out


def best_union(ids: torch.Tensor, d: torch.Tensor, sentinel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's ids deduplicated, each id keeping its best score: a sort
    by (id, d), repeats masked to (+inf, sentinel), a sort by (d, id).
    Returns ``(ids, d)`` of the input's width."""
    i_s, d_s = sort_rows(ids, d)
    rep = torch.zeros_like(i_s, dtype=torch.bool)
    rep[:, 1:] = i_s[:, 1:] == i_s[:, :-1]
    d_u, i_u = sort_rows(torch.where(rep, INF, d_s), torch.where(rep, sentinel, i_s))
    return i_u, d_u


def ortho_union(
    ids0: torch.Tensor,
    d0: torch.Tensor,
    ortho_count: int,
    penalized_pass,
    C: int,
    sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``ortho_count`` candidate passes and their union
    (expann_tpu/models/build.py:521-563, parallel/distbuild.py:235-264,
    models/wavebuild.py:180-214).
    Pass 0 is ``(ids0, d0)``, ordered by (d, id); pass i is
    ``penalized_pass(chosen, chosen_valid)`` against the first-place ids of
    passes 0..i-1 (a repeat of an earlier one is marked invalid).  The union
    keeps each id's best carried score, ordered by (score, id), cut to C."""
    all_ids, all_d = [ids0], [d0]
    chosen_cols = [ids0[:, 0]]
    for i in range(1, ortho_count):
        valid_cols = [torch.ones_like(chosen_cols[0], dtype=torch.bool)]
        for j in range(1, i):
            dup = torch.zeros_like(valid_cols[0])
            for k in range(j):
                dup |= chosen_cols[j] == chosen_cols[k]
            valid_cols.append(~dup)
        ids_i, d_i = penalized_pass(torch.stack(chosen_cols, dim=1), torch.stack(valid_cols, dim=1))
        all_ids.append(ids_i)
        all_d.append(d_i)
        chosen_cols.append(ids_i[:, 0])
    i_u, d_u = best_union(torch.cat(all_ids, dim=1), torch.cat(all_d, dim=1), sentinel)
    return i_u[:, :C], d_u[:, :C]


def prune_all(
    vec_s: torch.Tensor,  # (n + 1, D) corpus with sentinel row
    norm_s: torch.Tensor,
    cand_ids: torch.Tensor,  # (W, C) sorted by (d, id)
    cand_d: torch.Tensor,
    cap: int,
    ortho_factor: float,
    ortho_bias: float,
    prune_overflow: int,
    prune_block: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anti-topo prune of every row's candidate list, in row blocks
    (bounded co-distance memory)."""
    sentinel = vec_s.shape[0] - 1
    out_ids, out_d = [], []
    for s in range(0, cand_ids.shape[0], prune_block):
        i, d = prune_candidates(
            vec_s, norm_s, cand_ids[s : s + prune_block], cand_d[s : s + prune_block],
            cap, ortho_factor, ortho_bias, prune_overflow, sentinel,
        )
        out_ids.append(i)
        out_d.append(d)
    return torch.cat(out_ids), torch.cat(out_d)


def _stable_order(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting 1-D ``keys`` lexicographically (first key most
    significant), ties kept in input order: stable sorts, least significant
    key first."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def incoming_edges(
    sel_ids: torch.Tensor, sel_d: torch.Tensor, A: int, sentinel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group the forward edges by destination: per-node incoming (src, d)
    lists of width A (the one-shot analogue of the reference's sequential
    reverse-edge appends, src/antitopo_engine.h:441-455), in (source chunk,
    d, src) order; edges past A per destination are dropped."""
    W, cap = sel_ids.shape
    dev = sel_ids.device
    src = torch.arange(W, device=dev).repeat_interleave(cap)
    dst = torch.clamp_max(sel_ids.reshape(-1), sentinel).long()
    d = sel_d.reshape(-1)
    keep = torch.isfinite(d) & (dst != sentinel)
    src, dst, d = src[keep], dst[keep], d[keep]
    order = _stable_order(dst, src // REVERSE_CHUNK_ROWS, d)
    src, dst, d = src[order], dst[order], d[order]
    idx = torch.arange(dst.shape[0], device=dev)
    first = torch.ones_like(dst, dtype=torch.bool)
    first[1:] = dst[1:] != dst[:-1]
    group_start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    pos = idx - group_start
    ok = pos < A
    inc_src = torch.full((W, A), sentinel, dtype=torch.int32, device=dev)
    inc_d = torch.full((W, A), INF, dtype=torch.float32, device=dev)
    inc_src[dst[ok], pos[ok]] = src[ok].to(torch.int32)
    inc_d[dst[ok], pos[ok]] = d[ok]
    return inc_src, inc_d


def merge_lazy(
    sel_ids: torch.Tensor,
    sel_d: torch.Tensor,
    inc_src: torch.Tensor,
    inc_d: torch.Tensor,
    chunk: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Append incoming edges after forward edges (the reference's lazy prune
    branch keeps append order, src/antitopo_engine.h:270-273), masking
    incoming edges already present in the forward list (:442-450).
    Returns ``(ids, d, live_count)``."""
    W = sel_ids.shape[0]
    ids_out, d_out = [], []
    for s in range(0, W, chunk):
        s_ids, i_src, i_d = sel_ids[s : s + chunk], inc_src[s : s + chunk], inc_d[s : s + chunk]
        dup = (i_src[:, :, None] == s_ids[:, None, :]).any(-1)
        ids_out.append(torch.cat([s_ids, torch.where(dup, W, i_src)], dim=1))
        d_out.append(torch.cat([sel_d[s : s + chunk], torch.where(dup, INF, i_d)], dim=1))
    ids, d = torch.cat(ids_out), torch.cat(d_out)
    return ids, d, torch.isfinite(d).sum(dim=1)


def finish_rows(
    vec_s: torch.Tensor,
    norm_s: torch.Tensor,
    merged_ids: torch.Tensor,  # (W, C2) forward ++ incoming, dups masked
    merged_d: torch.Tensor,  # (W, C2), +inf on invalid
    count: torch.Tensor,  # (W,) live edges per row
    cap: int,
    R: int,
    ortho_factor: float,
    ortho_bias: float,
    prune_overflow: int,
    prune_block: int,
) -> torch.Tensor:
    """Rows within the cap keep append order (src/antitopo_engine.h:270-273);
    overflowing rows are re-pruned over their (d, id)-sorted union
    (:441-455).  Returns the final ``(W, R)`` adjacency, sentinel-padded."""
    W, C2 = merged_ids.shape
    sentinel = vec_s.shape[0] - 1
    ids_min = torch.clamp_max(merged_ids, sentinel)

    invalid = ~torch.isfinite(merged_d)
    order = torch.sort(invalid.to(torch.int8), dim=1, stable=True).indices
    adj = torch.where(invalid.gather(1, order), sentinel, ids_min.gather(1, order))
    if C2 < R:
        adj = torch.nn.functional.pad(adj, (0, R - C2), value=sentinel)
    adj = adj[:, :R].contiguous()

    rows = torch.nonzero(count > cap).flatten()
    if rows.numel():
        o_id = torch.sort(ids_min[rows], dim=1, stable=True).indices
        d_by_id = merged_d[rows].gather(1, o_id)
        o_d = torch.sort(d_by_id, dim=1, stable=True).indices
        u_ids = ids_min[rows].gather(1, o_id).gather(1, o_d)
        u_d = d_by_id.gather(1, o_d)
        over, _ = prune_all(
            vec_s, norm_s, u_ids, u_d, cap, ortho_factor, ortho_bias,
            prune_overflow, prune_block,
        )
        adj[rows] = torch.nn.functional.pad(over, (0, R - cap), value=sentinel)[:, :R]
    return adj


@dataclasses.dataclass
class BuildConfig:
    M: int = 60
    M0: int = 0  # 0 -> 2 * M (reference constructor default)
    ef_construction: int = 500
    ortho_count: int = 1
    ortho_factor: float = 0.5
    ortho_bias: float = 0.0
    prune_overflow: int = 0
    prune_cand: int = 0  # 0 -> min(ef_construction, 256)
    seed: int = 0
    # rows per exact-kNN distance block and per prune block, columns per
    # ortho-penalized scan block: memory bounds only, the graph does not
    # depend on them
    row_block: int = 2048
    col_block: int = 8192
    prune_block: int = 2048
    # "oneshot", "dist" (parallel/distbuild.py), "wave" (models/wavebuild.py)
    # or "auto": the distributed builder above auto_wave_threshold rows
    builder: str = "auto"
    wave_size: int = 1024
    auto_wave_threshold: int = 131072
    # the wave builder's beam entries expanded per iteration, and how many of
    # the fullest rows get the deferred lazy prune each wave
    wave_expand: int = 4
    wave_overflow_rows: int = 128
    # > 0: after a wave or distributed build, re-insert the first
    # refine_frac of the corpus against the finished graph
    # (models/wavebuild.refine_index_wave)
    refine_frac: float = 0.0

    def __post_init__(self):
        if self.M0 == 0:
            self.M0 = 2 * self.M
        if self.prune_cand == 0:
            self.prune_cand = min(self.ef_construction, 256)


def build_layer(
    member_vecs: torch.Tensor, member_norms: torch.Tensor, cap: int, cfg: BuildConfig,
    clock: Optional[StageClock] = None,
) -> torch.Tensor:
    """One layer's adjacency over its member set: ``(n_l, R)`` int32 of
    layer-local slots, sentinel n_l, R = cap rounded up to 16.  ``clock``,
    when given, times the stages ``scan`` (candidates), ``prune`` and
    ``rows`` (the reverse pass and the finished rows)."""
    stage = clock.stage if clock is not None else no_stage
    n = member_vecs.shape[0]
    C = min(cfg.prune_cand, max(n - 1, 1))
    with stage("scan"):
        knn_ids, knn_d = exact_knn(member_vecs, member_norms, C, cfg.row_block)
        if cfg.ortho_count > 1:

            def penalized(chosen, chosen_valid):
                return ortho_knn(member_vecs, member_norms, chosen, chosen_valid, cfg.ortho_factor,
                                 cfg.ortho_bias, C, cfg.row_block, cfg.col_block)

            knn_ids, knn_d = ortho_union(knn_ids, knn_d, cfg.ortho_count, penalized, C, n)

    with stage("prune"):
        zero = torch.zeros((1, member_vecs.shape[1]), dtype=torch.float32, device=member_vecs.device)
        inf = torch.full((1,), INF, dtype=torch.float32, device=member_vecs.device)
        vec_s = torch.cat([member_vecs, zero])
        norm_s = torch.cat([member_norms, inf])
        args = (cfg.ortho_factor, cfg.ortho_bias, cfg.prune_overflow, cfg.prune_block)
        sel_ids, sel_d = prune_all(vec_s, norm_s, knn_ids, knn_d, cap, *args)
    with stage("rows"):
        inc_src, inc_d = incoming_edges(sel_ids, sel_d, A=min(2 * cap, 4096), sentinel=n)
        merged_ids, merged_d, count = merge_lazy(sel_ids, sel_d, inc_src, inc_d)
        return finish_rows(vec_s, norm_s, merged_ids, merged_d, count, cap, _round_up(cap, 16), *args)


def build_upper_layers(
    vectors: torch.Tensor,
    norms: torch.Tensor,
    levels: np.ndarray,
    max_layer: int,
    cfg: BuildConfig,
) -> Tuple[UpperLayer, ...]:
    """The compact upper HNSW layers (1 .. max_layer - 1) over the level-draw
    member sets, each a small one-shot exact-kNN + prune."""
    n = vectors.shape[0] - 1
    dev = vectors.device
    upper: List[UpperLayer] = []
    for layer in range(1, max_layer):
        members = np.nonzero(levels >= layer)[0].astype(np.int32)
        n_l = members.size
        if n_l == 0:
            break
        members_t = torch.from_numpy(members).to(dev)
        adj_local = build_layer(vectors[members_t.long()], norms[members_t.long()], cfg.M, cfg)
        Ru = adj_local.shape[1]
        # local slots -> global ids; local sentinel n_l -> global sentinel n
        lut = torch.cat([members_t, torch.tensor([n], dtype=torch.int32, device=dev)])
        adj_global = torch.cat(
            [
                lut[torch.clamp_max(adj_local, n_l).long()],
                torch.full((1, Ru), n, dtype=torch.int32, device=dev),
            ]
        )
        slot = np.full(n + 1, n_l, np.int32)
        slot[members] = np.arange(n_l, dtype=np.int32)
        upper.append(UpperLayer(slot=torch.from_numpy(slot).to(dev), adj=adj_global))
    return tuple(upper)


def wave_size_for(cfg: BuildConfig, n: int) -> int:
    """The wave builders' wave size (expann_tpu/models/build.py:670-676):
    ``cfg.wave_size``, or 4096 where it is the default 1024 and the corpus
    has at least 4 x ``auto_wave_threshold`` rows (per-wave costs are paid
    ~1000 times at 1M rows and 1024)."""
    if cfg.wave_size == 1024 and n >= 4 * cfg.auto_wave_threshold:
        return 4096
    return cfg.wave_size


def build_index(x: np.ndarray, cfg: Optional[BuildConfig], device, verbose: bool = False,
                stats: Optional[dict] = None) -> GraphIndex:
    """Build a GraphIndex over the host corpus ``x`` ``(N, D)`` on ``device``
    (expann_tpu/models/build.py:659-703): the one-shot builder; the wave
    builder with ``builder="wave"``; or above ``cfg.auto_wave_threshold``
    rows (or with ``builder="dist"``) the one-device distributed builder.
    After a wave or distributed build, ``refine_frac > 0`` runs the
    refinement pass.  ``verbose`` prints the wave and distributed builders'
    progress and stage seconds; ``stats``, when given, receives the
    builder's stats, among them ``seconds`` a stage (the one-shot builder's:
    ``scan``, ``prune`` and ``rows`` of the bottom layer, then ``upper``,
    tiling the build after the corpus upload and the layer draw)."""
    cfg = cfg or BuildConfig()
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    if n == 0:
        raise ValueError("no vectors to build from")
    if cfg.builder not in ("auto", "oneshot", "dist", "wave"):
        raise ValueError(f"builder={cfg.builder!r}: one of 'auto', 'oneshot', 'dist', 'wave'")
    if cfg.builder in ("wave", "dist") or (cfg.builder == "auto" and n > cfg.auto_wave_threshold):
        ws = wave_size_for(cfg, n)
        if cfg.builder == "wave":
            from expann_tpu_torch.models.wavebuild import build_index_wave

            graph = build_index_wave(x, cfg, device, wave_size=ws, verbose=verbose, stats=stats)
        else:
            from expann_tpu_torch.parallel.distbuild import build_distributed

            # waves of 4096 at least: a million-row corpus pays per-wave costs
            # ~245 times against ~1000 at 1024
            graph, dstats = build_distributed(x, cfg, device, wave_size=max(ws, 4096), mode="oneshot",
                                              candidates="auto", verbose=verbose)
            if stats is not None:
                stats.update(dstats)
        if cfg.refine_frac > 0.0:
            from expann_tpu_torch.models.wavebuild import refine_index_wave

            graph = refine_index_wave(graph, cfg, frac=cfg.refine_frac, wave_size=ws, verbose=verbose)
        return graph
    device = torch.device(device)
    vectors, norms = make_corpus(x, device)
    levels, max_layer, sv = draw_levels(n, cfg.M, cfg.seed)

    clock = StageClock(device)
    # the bottom layer's local sentinel (n) is the global sentinel
    adj0 = build_layer(vectors[:n], norms[:n], cfg.M0, cfg, clock)
    adj_bottom = torch.cat([adj0, torch.full((1, adj0.shape[1]), n, dtype=torch.int32, device=device)])
    with clock.stage("upper"):
        upper = build_upper_layers(vectors, norms, levels, max_layer, cfg)
    clock.stop()
    if device.type == "cuda":
        # build returns a finished index (src/basic_bench.h:62-71)
        torch.cuda.synchronize(device)
    if stats is not None:
        stats["seconds"] = clock.seconds()
    return GraphIndex(
        vectors=vectors,
        norms=norms,
        adj_bottom=adj_bottom,
        layers=upper,
        starting_vertex=int(sv),
    )
