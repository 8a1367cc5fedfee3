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

Controlled divergence kept from the JAX package (reverse-pass cap):
incoming edges per destination go into A = min(2*cap, 4096) slots in
(source chunk of 8192 rows, d, source) order; a hub receiving more drops
the excess.

Not ported yet: ``ortho_count > 1`` (the ortho-penalized candidate scans)
and the wave / distributed builders for n > 131072; both raise
``NotImplementedError``.
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
    # rows per exact-kNN distance block and per prune block: memory bounds
    # only, the graph does not depend on them
    row_block: int = 2048
    prune_block: int = 2048
    builder: str = "auto"  # "oneshot" | "auto" (wave builders not ported)
    auto_wave_threshold: int = 131072

    def __post_init__(self):
        if self.M0 == 0:
            self.M0 = 2 * self.M
        if self.prune_cand == 0:
            self.prune_cand = min(self.ef_construction, 256)


def build_layer(
    member_vecs: torch.Tensor, member_norms: torch.Tensor, cap: int, cfg: BuildConfig
) -> torch.Tensor:
    """One layer's adjacency over its member set: ``(n_l, R)`` int32 of
    layer-local slots, sentinel n_l, R = cap rounded up to 16."""
    if cfg.ortho_count > 1:
        raise NotImplementedError(
            "ortho_count > 1 (ortho-penalized candidate scans) is not ported yet: ROADMAP.md queue 1"
        )
    n = member_vecs.shape[0]
    C = min(cfg.prune_cand, max(n - 1, 1))
    knn_ids, knn_d = exact_knn(member_vecs, member_norms, C, cfg.row_block)

    zero = torch.zeros((1, member_vecs.shape[1]), dtype=torch.float32, device=member_vecs.device)
    inf = torch.full((1,), INF, dtype=torch.float32, device=member_vecs.device)
    vec_s = torch.cat([member_vecs, zero])
    norm_s = torch.cat([member_norms, inf])

    args = (cfg.ortho_factor, cfg.ortho_bias, cfg.prune_overflow, cfg.prune_block)
    sel_ids, sel_d = prune_all(vec_s, norm_s, knn_ids, knn_d, cap, *args)
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


def build_index(x: np.ndarray, cfg: Optional[BuildConfig], device) -> GraphIndex:
    """Build a GraphIndex over the host corpus ``x`` ``(N, D)`` on ``device``
    with the one-shot builder (n <= ``cfg.auto_wave_threshold``)."""
    cfg = cfg or BuildConfig()
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    if n == 0:
        raise ValueError("no vectors to build from")
    if cfg.builder not in ("auto", "oneshot") or n > cfg.auto_wave_threshold:
        raise NotImplementedError(
            f"builder={cfg.builder!r} at n={n}: only the one-shot builder for "
            f"n <= {cfg.auto_wave_threshold} is ported (wave / distributed builders: ROADMAP.md queue 1)"
        )
    device = torch.device(device)
    vectors, norms = make_corpus(x, device)
    levels, max_layer, sv = draw_levels(n, cfg.M, cfg.seed)

    # the bottom layer's local sentinel (n) is the global sentinel
    adj0 = build_layer(vectors[:n], norms[:n], cfg.M0, cfg)
    adj_bottom = torch.cat([adj0, torch.full((1, adj0.shape[1]), n, dtype=torch.int32, device=device)])
    upper = build_upper_layers(vectors, norms, levels, max_layer, cfg)
    if device.type == "cuda":
        # build returns a finished index (src/basic_bench.h:62-71)
        torch.cuda.synchronize(device)
    return GraphIndex(
        vectors=vectors,
        norms=norms,
        adj_bottom=adj_bottom,
        layers=upper,
        starting_vertex=int(sv),
    )
