"""Batched graph queries (counterpart of expann_tpu/models/search.py).

Two routes through the bottom layer, both after an entry from the upper
layers (the reference's ``_query_k`` flow, src/antitopo_engine.h:853-928):

  * ``fused_query_batch``: entry seeds by a dense scan of the largest
    upper layer's members (``seeds > 0``) or by greedy descent; the whole
    bottom-layer beam search in one launch of the fused traversal
    (ops/fused.py); an exact f32 rerank of the final beam
    (src/antitopo_engine.h:845-848).  Over s8 blocks (``build_packed_i8``)
    the seeds and the traversal are in code space.
  * ``query_batch``: greedy descent, then ``beam_search``, which runs one
    traversal iteration per loop step on the host: select the best
    unexpanded beam entries, score their neighbours (row gathers, or the
    packed block scorer ops/packed.py ``packed_score`` with
    ``use_packed``), and merge by a stable sort.  The packed route reranks
    the final beam in exact f32; the gather route scores in exact f32
    already, or, with ``compressed``, gathers the uint8 codes and reranks.
    One host sync per iteration (``done.all()``).  ``beam_search`` is also
    the wave builders' construction search (models/wavebuild.py), with the
    ortho-penalized score for their extra passes.

Spans (``utils/profiling.annotate``, recorded only under a profiler):
``expann.search.entry`` (the entry scan or descent of the fused route),
``expann.search.descend``, ``expann.search.traverse`` (the fused launch, or
the whole ``beam_search`` of the per-iteration route),
``expann.search.rerank``, and ``expann.sync`` around each blocking device
read: one a descent step and one a beam iteration.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from expann_tpu_torch.models.graph import GraphIndex
from expann_tpu_torch.ops.distance import batched_neighbour_dist2, squared_norms
from expann_tpu_torch.ops.fused import fused_search
from expann_tpu_torch.ops.packed import packed_score
from expann_tpu_torch.utils.profiling import annotate

INF = float("inf")


def _gather_dist2(data, data_norms, ids, q, qn):
    """Score rows ``ids`` (B, R) of ``data`` against q; sentinel rows carry a
    +inf norm and come out at +inf."""
    ids = ids.long()
    return batched_neighbour_dist2(q, data[ids], data_norms[ids], q_norms=qn)


def _gather_score_ortho(data, data_norms, ids, q, qn, chosen_v, chosen_n, chosen_valid, ortho_factor, ortho_bias):
    """Ortho-penalized scores of rows ``ids`` (B, K) against q (the
    construction-time ``use_ortho`` branch, src/antitopo_engine.h:342-351):

        score(c) = d2(q, c) + sum over valid chosen p of
                   [d2(p, c) < d2(q, c)] * (ortho_factor * (d2(q, c) - d2(p, c)) + ortho_bias)

    ``chosen_v`` / ``chosen_n`` (B, OC, D) / (B, OC) are the chosen points'
    rows and norms, ``chosen_valid`` (B, OC) masks repeats.  A candidate at
    +inf (the sentinel row) stays +inf."""
    ids = ids.long()
    nvecs, nnorms = data[ids].float(), data_norms[ids]
    d2 = batched_neighbour_dist2(q, nvecs, nnorms, q_norms=qn)
    co = chosen_n[:, :, None] + nnorms[:, None, :] - 2.0 * torch.einsum("bod,bkd->bok", chosen_v, nvecs)
    d2b = d2[:, None, :]
    hit = (co < d2b) & chosen_valid[:, :, None] & torch.isfinite(d2b)
    pen = torch.where(hit, ortho_factor * (d2b - co) + ortho_bias, 0.0)
    return d2 + pen.sum(dim=1)


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
        with annotate("expann.sync"):
            improved = bool(better.any())
        if not improved:
            return ep, ep_d
        ep = torch.where(better, best, ep)
        ep_d = torch.where(better, nd_min, ep_d)


def descend(graph: GraphIndex, q: torch.Tensor, qn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy descent from the starting vertex through the upper layers:
    one entry ``(ep, ep_d)`` ``(B,)`` per query."""
    with annotate("expann.search.descend"):
        ep = torch.full((q.shape[0],), graph.starting_vertex, dtype=torch.int32, device=q.device)
        ep_d = _gather_dist2(graph.vectors, graph.norms, ep[:, None], q, qn)[:, 0]
        for layer in reversed(graph.layers):
            ep, ep_d = greedy_descent(graph.vectors, graph.norms, layer.slot, layer.adj, q, qn, ep, ep_d)
    return ep, ep_d


def kernel_query(graph: GraphIndex, q: torch.Tensor) -> torch.Tensor:
    """The query the packed blocks are scored against: ``q`` itself (bf16
    blocks), or over s8 blocks its codes ``clip(round((q - center) *
    scale), -127, 127)`` as integer-valued f32 (search.py:537-541)."""
    if graph.packed_codes is None:
        return q
    return torch.clamp(torch.round((q - graph.packed_center) * graph.packed_scale), -127.0, 127.0)


def entry_beam(
    graph: GraphIndex, q: torch.Tensor, EF: int, seeds: int
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Seed beams ``(bd0, bi0)`` of width EF for queries ``q`` (f32), and the
    distance computations the seeding costs per query.

    ``seeds > 0`` with entry members: the exact top-``seeds`` of a dense
    scan of the members (the JAX package takes ``approx_max_k``, which is
    exact off-TPU; ties keep member order); the scan costs the real member
    count, not the sentinel lane padding.  Otherwise one entry from greedy
    descent (in f32), not counted (as in the JAX package's fused path).
    Over s8 blocks the seed distances are code-space distances of the
    ``kernel_query`` (search.py:563-572, :596-604), so the traversal's
    comparisons stay in one space."""
    B = q.shape[0]
    dev = q.device
    bd0 = torch.full((B, EF), INF, dtype=torch.float32, device=dev)
    bi0 = torch.full((B, EF), graph.sentinel, dtype=torch.int32, device=dev)
    qn = squared_norms(q)
    if graph.packed_codes is not None:
        qk, data, data_norms = kernel_query(graph, q), graph.packed_codes, graph.packed_code_norms
        qkn = squared_norms(qk)
    else:
        qk, qkn, data, data_norms = q, qn, graph.vectors, graph.norms
    if graph.entry_members is not None and seeds > 0:
        mem = graph.entry_members.long()
        md = (data_norms[mem][None, :] + qkn[:, None]) - 2.0 * (qk @ data[mem].float().T)
        S = min(seeds, EF, mem.shape[0])
        seed_d, idx = torch.sort(md, dim=1, stable=True)
        bd0[:, :S] = seed_d[:, :S]
        bi0[:, :S] = graph.entry_members[idx[:, :S]]
        return bd0, bi0, graph.entry_members_n
    ep, ep_d = descend(graph, q, qn)
    if graph.packed_codes is not None:
        ep_d = (qkn + data_norms[ep.long()]) - 2.0 * torch.sum(qk * data[ep.long()].float(), dim=1)
    bd0[:, 0] = ep_d
    bi0[:, 0] = ep
    return bd0, bi0, 0


def rerank(graph: GraphIndex, q: torch.Tensor, beam_ids: torch.Tensor, k: int):
    """Exact f32 rerank of unsorted beams: ``(ids, d)`` ``(B, k)`` ascending
    by distance (stable, so equal distances keep beam order); sentinel
    lanes sort last."""
    with annotate("expann.search.rerank"):
        beam_d = _gather_dist2(graph.vectors, graph.norms, beam_ids, q, squared_norms(q))
        beam_d, order = torch.sort(beam_d, dim=1, stable=True)
        return beam_ids.gather(1, order)[:, :k], beam_d[:, :k]


def _earlier_dup(ids: torch.Tensor) -> torch.Tensor:
    """``(B, K)`` bool: the id already occurs earlier in its row.  A stable
    sort by id keeps equal ids in position order, so an entry is a repeat
    iff its predecessor in sorted order has its id: the same mask as
    comparing all pairs, in O(K log K) rather than O(K^2) memory."""
    s, order = torch.sort(ids, dim=1, stable=True)
    rep = torch.zeros_like(s, dtype=torch.bool)
    rep[:, 1:] = s[:, 1:] == s[:, :-1]
    return torch.zeros_like(rep).scatter_(1, order, rep)


def beam_search(
    data: torch.Tensor,
    data_norms: torch.Tensor,
    adj: torch.Tensor,
    q: torch.Tensor,
    qn: torch.Tensor,
    ep_ids: torch.Tensor,
    ef: int,
    max_iters: int,
    sentinel: int,
    expand: int = 1,
    packed: Optional[torch.Tensor] = None,
    packed_norms: Optional[torch.Tensor] = None,
    packed_ids: Optional[torch.Tensor] = None,
    packed_topt: int = 0,
    ortho_chosen: Optional[torch.Tensor] = None,
    ortho_valid: Optional[torch.Tensor] = None,
    ortho_factor: float = 0.5,
    ortho_bias: float = 0.0,
    iters: Optional[List[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched best-first beam search on the bottom layer, one iteration
    per loop step (search.py ``beam_search`` of the JAX package).

    ``data``/``data_norms`` ``(N+1, D)`` / ``(N+1,)`` with the +inf-norm
    sentinel row, ``adj`` ``(N+1, R)``, ``q``/``qn`` ``(B, D)`` / ``(B,)``,
    ``ep_ids`` ``(B, E0)`` entry points.  With ``packed`` (and its norms and
    ids) each iteration scores the selected nodes' packed blocks through
    ``packed_score`` (top-``packed_topt`` per node when > 0); otherwise it
    gathers the neighbours' rows and scores them in f32.  With
    ``ortho_chosen`` (B, OC) previously chosen ids (clamped to the sentinel)
    and ``ortho_valid`` (B, OC), entry points and neighbours alike are
    scored by ``_gather_score_ortho`` (the wave builder's penalized passes;
    not with ``packed``).

    Per iteration and query: select the ``E = min(expand, ef)`` best
    unexpanded entries by (d, position); the query is done once the best
    one is worse than the beam's last entry or not finite (the reference's
    break rule, src/antitopo_engine.h:588-590); score the selected nodes'
    neighbours; mask those whose id is anywhere in the beam (sentinel
    included) or repeated earlier in the block (the JAX package skips the
    second test for one full adjacency row, which holds no id twice, so the
    masks agree); merge by a stable sort on d and keep
    ``ef``.  A done query is inert.  The loop runs while a query is not done
    and fewer than ``max_iters`` iterations have run.

    Returns ``(beam_ids, beam_d, ncomp)``: beams ``(B, ef)`` ascending,
    sentinel / +inf padded, and per-query distance computations ``(B,)``:
    ``E0``, plus RS per selected non-sentinel node (packed) or the count of
    non-sentinel neighbours (gather).  ``iters``, when given, receives the
    iterations the loop ran."""
    B, E0 = ep_ids.shape
    dev = q.device
    R = packed.shape[1] if packed is not None else adj.shape[1]
    ep_ids = ep_ids.to(torch.int32)
    if ortho_chosen is not None:
        if packed is not None:
            raise ValueError("ortho scoring gathers rows: it takes no packed layout")
        safe = torch.clamp_max(ortho_chosen.long(), sentinel)
        chosen_v, chosen_n = data[safe].float(), data_norms[safe]

        def score(ids):
            return _gather_score_ortho(data, data_norms, ids, q, qn, chosen_v, chosen_n, ortho_valid,
                                       ortho_factor, ortho_bias)
    else:

        def score(ids):
            return _gather_dist2(data, data_norms, ids, q, qn)

    ep_d = score(ep_ids)
    if E0 > 1:  # duplicate seeds would defeat the beam's dedup
        ep_d = torch.where(_earlier_dup(ep_ids), INF, ep_d)
    pad = max(ef - E0, 0)
    beam_ids = torch.cat([ep_ids, torch.full((B, pad), sentinel, dtype=torch.int32, device=dev)], 1)
    beam_d, order = torch.sort(torch.cat([ep_d, torch.full((B, pad), INF, device=dev)], 1), dim=1, stable=True)
    beam_d, beam_ids = beam_d[:, :ef], beam_ids.gather(1, order[:, :ef])
    beam_exp = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    ncomp = torch.full((B,), E0, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    E = max(1, min(expand, ef))

    # a query is done once an iteration finds nothing to expand: the loop
    # reads that after each iteration (a fresh beam is never done)
    it = 0
    while it < max_iters and B > 0:
        masked = torch.where(beam_exp, INF, beam_d)
        # the E best by (d, position): lax.top_k's tie order
        best_pos = torch.sort(masked, dim=1, stable=True).indices[:, :E]
        sel_d = masked.gather(1, best_pos)
        done = done | (sel_d[:, 0] > beam_d[:, -1]) | torch.isinf(sel_d[:, 0])
        valid = torch.isfinite(sel_d) & ~done[:, None]
        sel = torch.where(valid, beam_ids.gather(1, best_pos), sentinel)
        beam_exp = beam_exp | torch.zeros_like(beam_exp).scatter_(1, best_pos, valid)

        if packed is not None:
            raw_d, nbrs = packed_score(packed, packed_norms, packed_ids, sel, q, packed_topt)
            nd = raw_d + qn[:, None]
            ncomp += R * (sel != sentinel).sum(1, dtype=torch.int32)
        else:
            nbrs = adj[sel.long()].reshape(B, E * R)
            nd = score(nbrs)
            ncomp += (nbrs != sentinel).sum(1, dtype=torch.int32)
        # mask a neighbour whose id is in the beam (sentinel included) or
        # earlier in the block: with the beam ahead of the block, an id
        # repeated earlier in the row (the beam's own sentinel repeats are
        # dropped by the slice)
        dup = _earlier_dup(torch.cat([beam_ids, nbrs], 1))[:, ef:]
        nd = torch.where(dup, INF, nd)

        all_d, order = torch.sort(torch.cat([beam_d, nd], 1), dim=1, stable=True)
        order = order[:, :ef]
        beam_d = all_d[:, :ef]
        beam_ids = torch.cat([beam_ids, nbrs], 1).gather(1, order)
        beam_exp = torch.cat([beam_exp, torch.zeros_like(dup)], 1).gather(1, order)
        it += 1
        with annotate("expann.sync"):
            finished = bool(done.all())
        if finished:
            break
    if iters is not None:
        iters.append(it)
    return beam_ids, beam_d, ncomp


def query_batch(
    graph: GraphIndex,
    q: torch.Tensor,
    k: int,
    ef: int,
    max_iters: int = 0,
    expand: int = 1,
    use_packed: bool = False,
    packed_topt: int = 0,
    compressed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full batched query on the per-iteration route: greedy descent,
    ``beam_search`` with beam width ``max(ef, k)``, and ``(ids, d, ncomp)``
    with ids / d ``(B, k)`` and per-query distance computations ``(B,)``
    (descent not counted).  ``compressed`` (it takes priority) scores the
    uint8 codes (``graph.codes``) against the query's codes: ``floor(q)``
    for "simple" codes, as the reference's integer cast
    (src/antitopo_engine.h:726-737), or the affine transform for "ranged"
    ones; ``use_packed`` scores the packed bf16 blocks (``graph.packed``);
    both rerank the final beam in exact f32.  Otherwise the beam is scored
    in exact f32 throughout.  ``q`` is used as given (f32): only the packed
    scorer rounds it, to the block dtype."""
    ef = max(int(ef), k)
    if max_iters <= 0:
        max_iters = 8 * ef + 16
    q = q.float()
    qn = squared_norms(q)
    ep, _ = descend(graph, q, qn)
    args = (graph.vectors, graph.norms, graph.adj_bottom, q, qn, ep[:, None], ef, max_iters, graph.sentinel, expand)
    if compressed:
        if graph.codes is None:
            raise ValueError("index was built without codes")
        if graph.quant_scale is not None:
            qc = torch.clamp(torch.round(q * graph.quant_scale + graph.quant_offset), 0.0, 255.0)
        else:
            qc = torch.floor(q)
        with annotate("expann.search.traverse"):
            beam_ids, _, ncomp = beam_search(
                graph.codes, graph.code_norms, graph.adj_bottom, qc, squared_norms(qc), ep[:, None], ef, max_iters,
                graph.sentinel, expand,
            )
        ids, d = rerank(graph, q, beam_ids, k)
        return ids, d, ncomp
    if not use_packed:
        with annotate("expann.search.traverse"):
            beam_ids, beam_d, ncomp = beam_search(*args)
        return beam_ids[:, :k], beam_d[:, :k], ncomp
    if graph.packed is None:
        raise ValueError("index has no packed-neighbour arrays")
    with annotate("expann.search.traverse"):
        beam_ids, _, ncomp = beam_search(
            *args, packed=graph.packed, packed_norms=graph.packed_norms, packed_ids=graph.packed_ids,
            packed_topt=packed_topt,
        )
    ids, d = rerank(graph, q, beam_ids, k)
    return ids, d, ncomp


def fused_query_batch(
    graph: GraphIndex,
    q: torch.Tensor,
    ef: int,
    k: int,
    ef_cap: int = 128,
    expand: int = 2,
    cand: int = 16,
    seeds: int = 0,
    q_inv_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full batched query through the fused traversal over the packed
    layout (bf16 or s8 blocks): entry seeds, traversal, exact f32 rerank
    against the f32 query.  Returns ``(ids, d, ncomp)`` with ids / d
    ``(B, k)`` and per-query distance computations ``(B,)``.

    ``q`` is f32, or int8 codes of the i8 query wire with their per-query
    ``q_inv_scale`` ``(B, 1)``: the query is then ``codes * q_inv_scale``
    (search.py:519-522), and descent, seeds, traversal and rerank all see
    that f32 query.  The beam width is ``EF = roundup(ef_cap, 128)``, as the
    JAX package sizes it, so that both packages run the same beams.
    """
    if graph.packed is None:
        raise ValueError("index has no packed-neighbour arrays")
    if q.dtype == torch.int8:
        if q_inv_scale is None:
            raise ValueError("the i8 query wire needs q_inv_scale")
        q = q.float() * q_inv_scale
    q = q.float()
    EF = ef_cap + ((-ef_cap) % 128)
    with annotate("expann.search.entry"):
        bd0, bi0, ncomp_seed = entry_beam(graph, q, EF, seeds)
    with annotate("expann.search.traverse"):
        beam_ids, _, ncomp, _ = fused_search(
            graph.packed, graph.packed_norms, graph.packed_ids, kernel_query(graph, q), bd0, bi0,
            ef=min(max(int(ef), k), EF), expand=expand, cand=cand,
        )
    ids, d = rerank(graph, q, beam_ids, k)
    return ids, d, ncomp + ncomp_seed
