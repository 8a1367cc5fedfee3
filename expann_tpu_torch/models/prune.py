"""Batched anti-topological edge pruning (counterpart of
expann_tpu/models/prune.py).

Semantics (reference: src/antitopo_engine.h:262-308 ``prune_edges``): from
a candidate list sorted by (distance, id), greedily select up to ``cap``
edges; a candidate's score is its distance plus
``ortho_factor * (d - co_dist) + ortho_bias`` for every already-selected
edge closer to it than the new vertex (``co_dist < d``), and a candidate is
disqualified once more than ``prune_overflow`` selected edges hit it.

W rows are pruned in lockstep: each of the ``cap`` steps is an argmin and
a masked penalty update over the whole ``(W, C)`` block.
"""

from __future__ import annotations

from typing import Tuple

import torch

INF = float("inf")


def pairwise_co_dist(cand_vecs: torch.Tensor, cand_norms: torch.Tensor) -> torch.Tensor:
    """All-pairs squared L2 among each row's candidates:
    ``(W, C, D) -> (W, C, C)`` via one batched matmul, clamped at 0."""
    cand_vecs = cand_vecs.float()
    dots = torch.bmm(cand_vecs, cand_vecs.transpose(1, 2))
    co = cand_norms[:, :, None] + cand_norms[:, None, :] - 2.0 * dots
    return torch.clamp_min(co, 0.0)


def antitopo_prune(
    cand_ids: torch.Tensor,  # (W, C) int32, sorted by (d, id); sentinel padding
    cand_d: torch.Tensor,  # (W, C) f32, +inf padding
    co: torch.Tensor,  # (W, C, C) f32 pairwise candidate distances
    cap: int,
    ortho_factor: float,
    ortho_bias: float,
    prune_overflow: int,
    sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy anti-topo selection.

    Returns ``(sel_ids, sel_d)`` of shape ``(W, cap)`` in selection order,
    padded with ``sentinel`` / +inf once selection stops (all remaining
    candidates disqualified or exhausted, src/antitopo_engine.h:297-303).
    """
    W, C = cand_d.shape
    dev = cand_d.device
    valid = torch.isfinite(cand_d)
    rows = torch.arange(W, device=dev)
    penalty = torch.zeros((W, C), dtype=torch.float32, device=dev)
    hits = torch.zeros((W, C), dtype=torch.int32, device=dev)
    chosen = torch.zeros((W, C), dtype=torch.bool, device=dev)
    stopped = torch.zeros((W,), dtype=torch.bool, device=dev)
    sel_ids = torch.full((W, cap), sentinel, dtype=torch.int32, device=dev)
    sel_d = torch.full((W, cap), INF, dtype=torch.float32, device=dev)
    for j in range(cap):
        score = cand_d + penalty
        score = torch.where(hits > prune_overflow, INF, score)
        score = torch.where(chosen | ~valid, INF, score)
        # candidates are pre-sorted by (d, id) and argmin returns the first
        # minimum: the reference's std::set order breaks ties
        # (src/antitopo_engine.h:276,298)
        pick = torch.argmin(score, dim=1)
        ok = torch.isfinite(score[rows, pick]) & ~stopped
        stopped |= ~ok
        sel_ids[:, j] = torch.where(ok, cand_ids[rows, pick].to(torch.int32), sentinel)
        sel_d[:, j] = torch.where(ok, cand_d[rows, pick], INF)
        chosen[rows, pick] |= ok
        co_row = co[rows, pick]  # (W, C)
        hit = (co_row < cand_d) & ok[:, None]
        penalty = penalty + torch.where(hit, ortho_factor * (cand_d - co_row) + ortho_bias, 0.0)
        hits = hits + hit.to(torch.int32)
    return sel_ids, sel_d


def prune_candidates(
    vectors: torch.Tensor,
    norms: torch.Tensor,
    cand_ids: torch.Tensor,
    cand_d: torch.Tensor,
    cap: int,
    ortho_factor: float,
    ortho_bias: float,
    prune_overflow: int,
    sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the candidate vectors, build the co-distance matrix, run the
    batched prune.  ``cand_ids`` / ``cand_d`` must already be sorted
    ascending by (d, id) with sentinel / +inf padding."""
    cand_ids = torch.clamp_max(cand_ids, sentinel).long()
    cand_vecs = vectors[cand_ids]
    cand_norms = torch.where(torch.isfinite(cand_d), norms[cand_ids], INF)
    co = pairwise_co_dist(cand_vecs, cand_norms)
    return antitopo_prune(
        cand_ids, cand_d, co, cap, float(ortho_factor), float(ortho_bias),
        int(prune_overflow), sentinel,
    )
