"""Batched graph queries (counterpart of the fused path of
expann_tpu/models/search.py).

A query batch is seeded either by a dense scan of the largest upper
layer's members (``seeds > 0``) or by greedy descent through the upper
layers (the reference's ``_query_k`` flow, src/antitopo_engine.h:853-928);
the whole bottom-layer beam search then runs in the fused traversal
(ops/fused.py), and the final beam is reranked in exact f32
(src/antitopo_engine.h:845-848).
"""

from __future__ import annotations

from typing import Tuple

import torch

from expann_tpu_torch.models.graph import GraphIndex
from expann_tpu_torch.ops.distance import batched_neighbour_dist2, squared_norms
from expann_tpu_torch.ops.fused import fused_search

INF = float("inf")


def _gather_dist2(data, data_norms, ids, q, qn):
    """Score rows ``ids`` (B, R) of ``data`` against q; sentinel rows carry a
    +inf norm and come out at +inf."""
    ids = ids.long()
    return batched_neighbour_dist2(q, data[ids], data_norms[ids], q_norms=qn)


def greedy_descent(
    data: torch.Tensor,
    data_norms: torch.Tensor,
    layer_slot: torch.Tensor,
    layer_adj: torch.Tensor,
    q: torch.Tensor,
    qn: torch.Tensor,
    ep: torch.Tensor,
    ep_d: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy walk on one upper layer: each step every query moves
    to its best neighbour if that improves, until no query improves
    (src/antitopo_engine.h:878-893)."""
    while True:
        nbrs = layer_adj[layer_slot[ep.long()].long()]  # (B, Ru) global ids
        nd = _gather_dist2(data, data_norms, nbrs, q, qn)
        j = torch.argmin(nd, dim=1, keepdim=True)
        nd_min = nd.gather(1, j)[:, 0]
        best = nbrs.gather(1, j)[:, 0]
        better = nd_min < ep_d
        if not bool(better.any()):
            return ep, ep_d
        ep = torch.where(better, best, ep)
        ep_d = torch.where(better, nd_min, ep_d)


def entry_beam(
    graph: GraphIndex, q: torch.Tensor, EF: int, seeds: int
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Seed beams ``(bd0, bi0)`` of width EF for queries ``q`` (f32), and the
    distance computations the seeding costs per query.

    ``seeds > 0`` with entry members: the exact top-``seeds`` of a dense
    scan of the members (the JAX package takes ``approx_max_k``, which is
    exact off-TPU); the scan costs the real member count, not the sentinel
    lane padding.  Otherwise one entry from greedy descent, not counted
    (as in the JAX package's fused path)."""
    B = q.shape[0]
    dev = q.device
    qn = squared_norms(q)
    bd0 = torch.full((B, EF), INF, dtype=torch.float32, device=dev)
    bi0 = torch.full((B, EF), graph.sentinel, dtype=torch.int32, device=dev)
    if graph.entry_members is not None and seeds > 0:
        mem = graph.entry_members.long()
        md = (graph.norms[mem][None, :] + qn[:, None]) - 2.0 * (q @ graph.vectors[mem].T)
        S = min(seeds, EF, mem.shape[0])
        seed_d, idx = torch.sort(md, dim=1, stable=True)
        bd0[:, :S] = seed_d[:, :S]
        bi0[:, :S] = graph.entry_members[idx[:, :S]]
        return bd0, bi0, graph.entry_members_n
    ep = torch.full((B,), graph.starting_vertex, dtype=torch.int32, device=dev)
    ep_d = _gather_dist2(graph.vectors, graph.norms, ep[:, None], q, qn)[:, 0]
    for layer in reversed(graph.layers):
        ep, ep_d = greedy_descent(graph.vectors, graph.norms, layer.slot, layer.adj, q, qn, ep, ep_d)
    bd0[:, 0] = ep_d
    bi0[:, 0] = ep
    return bd0, bi0, 0


def rerank(graph: GraphIndex, q: torch.Tensor, beam_ids: torch.Tensor, k: int):
    """Exact f32 rerank of unsorted beams: ``(ids, d)`` ``(B, k)`` ascending
    by distance (stable, so equal distances keep beam order); sentinel
    lanes sort last."""
    beam_d = _gather_dist2(graph.vectors, graph.norms, beam_ids, q, squared_norms(q))
    beam_d, order = torch.sort(beam_d, dim=1, stable=True)
    return beam_ids.gather(1, order)[:, :k], beam_d[:, :k]


def fused_query_batch(
    graph: GraphIndex,
    q: torch.Tensor,
    ef: int,
    k: int,
    ef_cap: int = 128,
    expand: int = 2,
    cand: int = 16,
    seeds: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full batched query through the fused traversal over the bf16 packed
    layout: entry seeds, traversal, exact f32 rerank.  Returns
    ``(ids, d, ncomp)`` with ids / d ``(B, k)`` and per-query distance
    computations ``(B,)``.

    The beam width is ``EF = roundup(ef_cap, 128)``, as the JAX package
    sizes it, so that both packages run the same beams.
    """
    if graph.packed is None:
        raise ValueError("index has no packed-neighbour arrays")
    q = q.float()
    EF = ef_cap + ((-ef_cap) % 128)
    bd0, bi0, ncomp_seed = entry_beam(graph, q, EF, seeds)
    beam_ids, _, ncomp, _ = fused_search(
        graph.packed, graph.packed_norms, graph.packed_ids, q, bd0, bi0,
        ef=min(max(int(ef), k), EF), expand=expand, cand=cand,
    )
    ids, d = rerank(graph, q, beam_ids, k)
    return ids, d, ncomp + ncomp_seed
