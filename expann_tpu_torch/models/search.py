"""Batched graph queries (counterpart of expann_tpu/models/search.py).

Two routes through the bottom layer, both after an entry from the upper
layers (the reference's ``_query_k`` flow, src/antitopo_engine.h:853-928):

  * ``fused_query_batch``: entry seeds by a dense scan of the largest
    upper layer's members (``seeds > 0``) or by greedy descent; the whole
    bottom-layer beam search in one launch of the fused traversal
    (ops/fused.py: over the packed blocks, or over the rows layout by
    neighbour id where the engine built that one); an exact f32 rerank of
    the final beam (src/antitopo_engine.h:845-848).  Over s8 blocks
    (``build_packed_i8``) the seeds and the traversal are in code space.
  * ``query_batch``: greedy descent, then ``beam_search``, which runs one
    traversal iteration per loop step on the host: select the best
    unexpanded beam entries, score their neighbours (row gathers, or the
    packed block scorer ops/packed.py ``packed_score`` with
    ``use_packed``), and merge by a stable sort.  The packed route reranks
    the final beam in exact f32; the gather route scores in exact f32
    already, or, with ``compressed``, gathers the uint8 codes and reranks.
    One host sync per iteration (``done.all()``), except on the packed
    route on a CUDA device, which replays ``BEAM_BLOCK`` iterations
    captured as a CUDA graph and syncs once a replay.  ``beam_search`` is
    also the wave builders' construction search (models/wavebuild.py), with
    the ortho-penalized score for their extra passes.

Spans (``utils/profiling.annotate``, recorded only under a profiler):
``expann.search.entry`` (the entry scan or descent of the fused route),
``expann.search.descend``, ``expann.search.traverse`` (the fused launch, or
the whole ``beam_search`` of the per-iteration route),
``expann.search.replay`` (a replay of the captured beam),
``expann.search.rerank``, and ``expann.sync`` around each blocking device
read: one a descent step and one a beam iteration or replay.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Tuple

import torch

from expann_tpu_torch.models.graph import GraphIndex
from expann_tpu_torch.ops import _kernels
from expann_tpu_torch.ops.distance import batched_neighbour_dist2, squared_norms
from expann_tpu_torch.ops.fused import fused_search, fused_search_rows
from expann_tpu_torch.ops.packed import packed_score, packed_widths
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


def entry_cost(graph: GraphIndex, seeds: int) -> int:
    """The distance computations ``entry_beam`` costs a query: the entry
    members' scan, or none after greedy descent."""
    return graph.entry_members_n if graph.entry_members is not None and seeds > 0 else 0


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
        return bd0, bi0, entry_cost(graph, seeds)
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


@dataclasses.dataclass
class BeamState:
    """The beams of a batch, which ``beam_step`` updates in place: ``d``
    ``(B, ef)`` f32 ascending, ``ids`` ``(B, ef)`` int32, ``exp`` ``(B, ef)``
    bool (expanded), ``ncomp`` ``(B,)`` int32 distance computations and
    ``done`` ``(B,)`` bool."""

    d: torch.Tensor
    ids: torch.Tensor
    exp: torch.Tensor
    ncomp: torch.Tensor
    done: torch.Tensor

    def fields(self) -> Tuple[torch.Tensor, ...]:
        return (self.d, self.ids, self.exp, self.ncomp, self.done)


def beam_step(s: BeamState, neighbours: Callable, ef: int, E: int, sentinel: int) -> None:
    """One iteration of the beam, in place on ``s``: select the ``E`` best
    unexpanded entries by (d, position); a query is done once the best one
    is worse than its beam's last entry or not finite; score the selected
    nodes' neighbours, ``neighbours(sel) -> (d, ids, computations)``, mask
    repeats and merge by a stable sort, keeping ``ef``.  A done query is
    inert: it selects only the sentinel, whose neighbours are all at +inf,
    and the stable merge keeps its (ascending) beam as it is."""
    masked = torch.where(s.exp, INF, s.d)
    # the E best by (d, position): lax.top_k's tie order
    best_pos = torch.sort(masked, dim=1, stable=True).indices[:, :E]
    sel_d = masked.gather(1, best_pos)
    s.done |= (sel_d[:, 0] > s.d[:, -1]) | torch.isinf(sel_d[:, 0])
    valid = torch.isfinite(sel_d) & ~s.done[:, None]
    sel = torch.where(valid, s.ids.gather(1, best_pos), sentinel)
    exp = s.exp | torch.zeros_like(s.exp).scatter_(1, best_pos, valid)
    nd, nbrs, comps = neighbours(sel)
    s.ncomp += comps
    # mask a neighbour whose id is in the beam (sentinel included) or
    # earlier in the block: with the beam ahead of the block, an id
    # repeated earlier in the row (the beam's own sentinel repeats are
    # dropped by the slice)
    cand = torch.cat([s.ids, nbrs], 1)
    dup = _earlier_dup(cand)[:, ef:]
    nd = torch.where(dup, INF, nd)
    all_d, order = torch.sort(torch.cat([s.d, nd], 1), dim=1, stable=True)
    order = order[:, :ef]
    s.d.copy_(all_d[:, :ef])
    torch.gather(cand, 1, order, out=s.ids)
    torch.gather(torch.cat([exp, torch.zeros_like(dup)], 1), 1, order, out=s.exp)


def _packed_neighbours(packed, packed_norms, packed_ids, topt: int, q, qn, sentinel: int) -> Callable:
    """``neighbours`` of ``beam_step`` over the packed blocks: the block
    scorer's ``(B, E * (topt or R_tile))`` distances and ids, and RS
    computations per selected non-sentinel node."""
    R = packed.shape[1]

    def neighbours(sel):
        raw_d, nbrs = packed_score(packed, packed_norms, packed_ids, sel, q, topt)
        return raw_d + qn[:, None], nbrs, R * (sel != sentinel).sum(1, dtype=torch.int32)

    return neighbours


# Iterations a replay of the captured beam runs before the host reads
# ``done`` (the sweep over 1, 2, 4, 8 on the card: PERF.md §6), and the
# captured beams an index keeps at once (each holds its static buffers and
# the device memory of its intermediates): a batch is captured at the
# power of two at or above its size, so one ``(ef, E, topt)`` takes 7
# graphs for the chunks of 1 to 64 queries that the engine sends down
# this route at its default ``fused_qt`` of 128.
BEAM_BLOCK = 4
GRAPH_CACHE = 8


class _BeamGraph:
    """``BEAM_BLOCK`` iterations of the packed beam captured as one CUDA
    graph over static buffers of ``B`` rows: the query ``q`` / ``qn`` and a
    ``BeamState``, which a call loads, replays and reads back.  ``step``
    runs one iteration eagerly on the same buffers."""

    def __init__(self, packed, packed_norms, packed_ids, topt: int, B: int, ef: int, E: int, sentinel: int):
        dev = packed.device
        self.block, self.sentinel = BEAM_BLOCK, sentinel
        self.q = torch.zeros((B, packed.shape[2]), dtype=torch.float32, device=dev)
        self.qn = torch.zeros((B,), dtype=torch.float32, device=dev)
        self.state = BeamState(
            torch.empty((B, ef), device=dev), torch.empty((B, ef), dtype=torch.int32, device=dev),
            torch.empty((B, ef), dtype=torch.bool, device=dev), torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.bool, device=dev),
        )
        # an all-sentinel beam, done at its first step: the warm-up reads
        # only the sentinel's blocks
        self._inert(0)
        neighbours = _packed_neighbours(packed, packed_norms, packed_ids, topt, self.q, self.qn, sentinel)
        self.step = functools.partial(beam_step, self.state, neighbours, ef, E, sentinel)
        self.graph = self._capture(dev)

    def _capture(self, dev):
        # one eager step first, on a side stream: the kernels' lazy set-up
        # (module load, shared-memory attribute) stays out of the capture
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.step()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(self.block):
                    self.step()
        return graph

    def _inert(self, b: int) -> None:
        """Rows ``b:`` as done all-sentinel beams: every step leaves them as
        they are."""
        s = self.state
        s.d[b:], s.ids[b:], s.exp[b:], s.ncomp[b:], s.done[b:] = INF, self.sentinel, False, 0, True

    def load(self, q, qn, state: BeamState) -> None:
        """The call's ``b`` queries and entry beams into the first ``b``
        rows, the rest inert."""
        b = q.shape[0]
        self.q[:b].copy_(q)
        self.qn[:b].copy_(qn)
        for dst, src in zip(self.state.fields(), state.fields()):
            dst[:b].copy_(src)
        if b < self.q.shape[0]:
            self._inert(b)

    def replay(self) -> None:
        with annotate("expann.search.replay"):
            self.graph.replay()
        _kernels.launches["packed_score"] += self.block  # one K4 a captured step


def _replays(q, packed, ortho_chosen) -> bool:
    """Whether ``beam_search`` replays captured iterations: the packed
    route on a CUDA device."""
    return q.is_cuda and packed is not None and ortho_chosen is None


def _beam_graph(graphs: dict, packed, packed_norms, packed_ids, topt: int, B: int, ef: int, E: int,
                sentinel: int) -> _BeamGraph:
    """The captured beam of ``B`` queries (rounded up to a power of two)
    over these packed arrays, from ``graphs``, the cache that goes with
    them (``GraphIndex.beam_graphs``), captured on first use; the least
    recently used one goes beyond ``GRAPH_CACHE``."""
    key = (1 << (B - 1).bit_length(), ef, E, topt)
    g = graphs.pop(key, None)
    if g is None:
        while len(graphs) >= GRAPH_CACHE:
            graphs.pop(next(iter(graphs)))
        g = _BeamGraph(packed, packed_norms, packed_ids, topt, key[0], ef, E, sentinel)
    graphs[key] = g
    return g


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
    graphs: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched best-first beam search on the bottom layer, one ``beam_step``
    an iteration (search.py ``beam_search`` of the JAX package).

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

    ``beam_step`` gives the iteration: ``E = min(expand, ef)`` selections a
    query, the reference's break rule (src/antitopo_engine.h:588-590), a
    neighbour masked when its id is anywhere in the beam (sentinel
    included) or repeated earlier in the block (the JAX package skips the
    second test for one full adjacency row, which holds no id twice, so the
    masks agree).  The loop runs while a query is not done and fewer than
    ``max_iters`` iterations have run, and reads ``done`` on the host once
    an iteration; on the packed route on a CUDA device, given ``graphs``,
    the cache of captured beams that goes with the packed arrays
    (``GraphIndex.beam_graphs``), it replays ``BEAM_BLOCK`` captured
    iterations and reads ``done`` once a replay, then steps eagerly where
    fewer than ``BEAM_BLOCK`` are left before ``max_iters``.  The
    iterations past the last query's end, and the rows that pad the batch
    to the captured size, are inert, so both give the same beams and
    counts.

    Returns ``(beam_ids, beam_d, ncomp)``: beams ``(B, ef)`` ascending,
    sentinel / +inf padded, and per-query distance computations ``(B,)``:
    ``E0``, plus RS per selected non-sentinel node (packed) or the count of
    non-sentinel neighbours (gather).  ``iters``, when given, receives the
    iterations the loop ran (on the replayed route a multiple of
    ``BEAM_BLOCK`` but for an eager tail)."""
    B, E0 = ep_ids.shape
    dev = q.device
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
    s = BeamState(
        beam_d[:, :ef], beam_ids.gather(1, order[:, :ef]), torch.zeros((B, ef), dtype=torch.bool, device=dev),
        torch.full((B,), E0, dtype=torch.int32, device=dev), torch.zeros((B,), dtype=torch.bool, device=dev),
    )
    E = max(1, min(expand, ef))

    replayed = graphs is not None and _replays(q, packed, ortho_chosen) and B > 0
    if replayed:
        g = _beam_graph(graphs, packed, packed_norms, packed_ids, packed_topt, B, ef, E, sentinel)
        g.load(q, qn, s)
        s, block, run_block, step = g.state, g.block, g.replay, g.step
    else:
        if packed is not None:
            neighbours = _packed_neighbours(packed, packed_norms, packed_ids, packed_topt, q, qn, sentinel)
        else:

            def neighbours(sel):
                nbrs = adj[sel.long()].reshape(B, -1)
                return score(nbrs), nbrs, (nbrs != sentinel).sum(1, dtype=torch.int32)

        step = functools.partial(beam_step, s, neighbours, ef, E, sentinel)
        block, run_block = 1, step

    # a query is done once an iteration finds nothing to expand: the loop
    # reads that after each block of iterations (a fresh beam is never done)
    it = 0
    finished = B == 0
    while not finished and it + block <= max_iters:
        run_block()
        it += block
        with annotate("expann.sync"):
            finished = bool(s.done.all())
    while not finished and it < max_iters:
        step()
        it += 1
        with annotate("expann.sync"):
            finished = bool(s.done.all())
    if iters is not None:
        iters.append(it)
    if replayed:  # the static buffers serve the next call
        return s.ids[:B].clone(), s.d[:B].clone(), s.ncomp[:B].clone()
    return s.ids, s.d, s.ncomp


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
    if graph.beam_graphs is None:
        graph.beam_graphs = {}
    with annotate("expann.search.traverse"):
        beam_ids, _, ncomp = beam_search(
            *args, packed=graph.packed, packed_norms=graph.packed_norms, packed_ids=graph.packed_ids,
            packed_topt=packed_topt, graphs=graph.beam_graphs,
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
    layout (bf16 or s8 blocks: K1 / K1-s8; the rows layout: K1-rows):
    entry seeds, traversal, exact f32 rerank against the f32 query.
    Returns ``(ids, d, ncomp)`` with ids / d ``(B, k)`` and per-query
    distance computations ``(B,)``: the seeding's ``entry_cost`` and the
    traversal's, which on the rows layout are the rows it read.

    ``q`` is f32, or int8 codes of the i8 query wire with their per-query
    ``q_inv_scale`` ``(B, 1)``: the query is then ``codes * q_inv_scale``
    (search.py:519-522), and descent, seeds, traversal and rerank all see
    that f32 query.  The beam width is ``EF = roundup(ef_cap, 128)``, as the
    JAX package sizes it, so that both packages run the same beams.
    """
    if graph.packed is None and graph.packed_rows is None:
        raise ValueError("index has no packed-neighbour arrays")
    if q.dtype == torch.int8:
        if q_inv_scale is None:
            raise ValueError("the i8 query wire needs q_inv_scale")
        q = q.float() * q_inv_scale
    q = q.float()
    EF = ef_cap + ((-ef_cap) % 128)
    with annotate("expann.search.entry"):
        bd0, bi0, ncomp_seed = entry_beam(graph, q, EF, seeds)
    ef = min(max(int(ef), k), EF)
    with annotate("expann.search.traverse"):
        if graph.packed is not None:
            beam_ids, _, ncomp, _ = fused_search(
                graph.packed, graph.packed_norms, graph.packed_ids, kernel_query(graph, q), bd0, bi0,
                ef=ef, expand=expand, cand=cand,
            )
        else:
            beam_ids, _, ncomp, _ = fused_search_rows(
                graph.packed_rows, graph.packed_norms, graph.packed_ids, packed_widths(graph.adj_bottom.shape[1])[0],
                q, bd0, bi0, ef=ef, expand=expand, cand=cand,
            )
    ids, d = rerank(graph, q, beam_ids, k)
    return ids, d, ncomp + ncomp_seed
