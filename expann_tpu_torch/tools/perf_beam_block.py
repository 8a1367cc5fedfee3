"""Single-query latency of the per-iteration route by the block of beam
iterations a replay runs (``models/search.BEAM_BLOCK``), against the eager
loop; the cost of one capture; and a stream of mixed batch sizes.

Builds the canonical 56k index (N(0,1) rows, d=128, drawn from ``--seed``)
with the graph settings of the benchmark's single-query cell (M=60,
efc=prune_cand=500, expand 2, topt 8, bf16 blocks, ef=120) and times calls
through ``query_k_batch`` in arms that take turns, the order rotated each
round so that a drift of the shared host falls on all:

  * ``eager``: one iteration and one ``done`` read at a time (the replayed
    route switched off in ``search._replays``);
  * ``U=<u>``: ``BEAM_BLOCK`` set to u, the graph captured anew before the
    arm's timed calls.

Per arm: the median and p95 of the host-clock milliseconds a call of one
query over all rounds, the beam iterations a query ran, whether every list
equals the eager arm's, and for the replayed arms the card's milliseconds a
replay (CUDA events, ``profiling.event_ms``) and so a beam iteration.

``capture_ms``: per captured batch size (1 to 64, the powers of two the
per-iteration route captures at ``fused_qt`` 128), the host-clock
milliseconds the first call of a batch of that size takes beyond the
second, over an empty cache: the capture (a warm-up step, ``BEAM_BLOCK``
captured steps and the graph's instantiation), median of three.

``mixed``: ``--mixed`` calls of 1 to 32 queries each (sizes drawn from
``--seed``), eager and at the module's ``BEAM_BLOCK`` from an empty cache,
in turns: milliseconds a call and a query, the graphs captured on the way
(at most the 6 sizes 1 to 32 round up to, if none is evicted), and whether
every list equals the eager arm's::

    python -m expann_tpu_torch.tools.perf_beam_block [--n 56000] [--rounds 4] [--queries 64]
        [--blocks 1,2,4,8] [--mixed 96] [--seed 0] [--device cuda]

Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from expann_tpu_torch.models import search
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.tools.perf_span_cost import GRAPH
from expann_tpu_torch.utils import profiling

CAPTURE_SIZES = (1, 2, 3, 5, 9, 17, 33)  # captured at 1, 2, 4, 8, 16, 32, 64 rows
MIXED_MAX = 32


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _calls(eng, batches, block, device, captures=None):
    """``(ms a call, lists, iterations a call)`` of one arm over ``batches``;
    ``block`` None is the eager loop, else ``BEAM_BLOCK`` = block over the
    engine's cache as it stands, and ``captures`` counts the graphs made."""
    iters = []
    real_replays, real_beam, real_graph = search._replays, search.beam_search, search._BeamGraph
    if block is None:
        search._replays = lambda q, packed, ortho_chosen: False
    else:
        search.BEAM_BLOCK = block

        class Counted(real_graph):
            def __init__(self, *a, **kw):
                captures.append(1)
                super().__init__(*a, **kw)

        if captures is not None:
            search._BeamGraph = Counted
    search.beam_search = lambda *a, **kw: real_beam(*a, **kw, iters=iters)
    ms, lists = [], []
    try:
        for qb in batches:
            _sync(device)
            t0 = time.perf_counter()
            lists.append(eng.query_k_batch(qb, 10))
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        search._replays, search.beam_search, search._BeamGraph = real_replays, real_beam, real_graph
    return ms, np.concatenate(lists), iters


def _forget_captures(eng) -> None:
    """Drop the captured beams the engine's layout keeps (on the CPU it
    has no layout)."""
    getattr(eng.graph.layout, "beam_graphs", {}).clear()


def _replay_ms(eng, device) -> float:
    """Card milliseconds of one replay of the captured beam (its state is
    the last call's, whose queries are done: the same kernels on the same
    shapes, inert)."""
    (g,) = eng.graph.layout.beam_graphs.values()
    return profiling.event_ms(g.replay, reps=50) if device.type == "cuda" else float("nan")


def _capture_ms(eng, pool, device) -> dict:
    out = {}
    for b in CAPTURE_SIZES:
        extra = []
        for r in range(3):
            qb = pool[r * b : (r + 1) * b]
            _forget_captures(eng)
            first, _, _ = _calls(eng, [qb, qb], search.BEAM_BLOCK, device)
            extra.append(first[0] - first[1])
        out[str(1 << (b - 1).bit_length())] = statistics.median(extra)
    return out


def _summary(ms) -> dict:
    return {"median_ms": statistics.median(ms), "p95_ms": float(np.percentile(ms, 95)),
            "ms_quartiles": statistics.quantiles(ms, n=4)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=56000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--ef", type=int, default=120)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--blocks", default="1,2,4,8")
    ap.add_argument("--mixed", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = torch.device(a.device)
    on_card = device.type == "cuda"
    blocks = [int(b) for b in a.blocks.split(",")] if on_card else []  # nothing is captured on the CPU

    gen = torch.Generator(device=device).manual_seed(a.seed)
    x = torch.randn((a.n, a.d), generator=gen, device=device).cpu().numpy()
    pool = torch.randn((a.rounds * a.queries, a.d), generator=gen, device=device).cpu().numpy()
    sizes = np.random.default_rng(a.seed).integers(1, MIXED_MAX + 1, a.mixed)
    starts = np.concatenate([[0], np.cumsum(sizes)]) % max(1, len(pool) - MIXED_MAX)
    mixed_batches = [pool[s : s + b] for s, b in zip(starts, sizes)]
    eng = AntitopoEngine(config=AntitopoConfig(**GRAPH, ef_search=a.ef), device=device)
    eng.store_many_vectors(x)
    eng.build()
    eng.query_k_batch(pool[:1], 10)  # the packed layout

    arms = [None] + blocks
    names = ["eager"] + [f"U={b}" for b in blocks]
    ms = {k: [] for k in names}
    iters = {k: [] for k in names}
    identical = {k: True for k in names}
    replay_ms = {k: [] for k in names[1:]}
    mixed_arms = ["eager"] + (["replayed"] if on_card else [])
    mixed = {k: {"ms": [], "captures": []} for k in mixed_arms}
    mixed_identical = True
    block0 = search.BEAM_BLOCK
    try:
        for r in range(a.rounds):
            qs = pool[r * a.queries : (r + 1) * a.queries]
            order = list(range(len(arms)))
            order = order[r % len(order):] + order[: r % len(order)]
            lists = {}
            for i in order:
                block = arms[i]
                if block is not None:  # the capture, outside the timed calls
                    _forget_captures(eng)
                    _calls(eng, [qs[:1]], block, device)
                ms_i, lists[names[i]], it = _calls(eng, [q[None] for q in qs], block, device)
                ms[names[i]] += ms_i
                iters[names[i]] += it
                if block is not None:
                    replay_ms[names[i]].append(_replay_ms(eng, device))
            for k in names:
                identical[k] &= bool(np.array_equal(lists[k], lists["eager"]))
        search.BEAM_BLOCK = block0
        capture_ms = _capture_ms(eng, pool, device) if on_card else {}
        for r in range(2):
            lists = {}
            for k in (mixed_arms if r % 2 == 0 else mixed_arms[::-1]):
                captures = []
                _forget_captures(eng)
                ms_k, lists[k], _ = _calls(eng, mixed_batches, None if k == "eager" else block0, device, captures)
                mixed[k]["ms"] += ms_k
                mixed[k]["captures"].append(len(captures))
            mixed_identical &= all(np.array_equal(lists[k], lists["eager"]) for k in mixed_arms)
    finally:
        search.BEAM_BLOCK = block0
        _forget_captures(eng)

    out = {"card": profiling.card_name() if on_card else "cpu", "torch": torch.__version__,
           "n": a.n, "ef": a.ef, "rounds": a.rounds, "queries": a.queries, "arms": {}}
    for k, b in zip(names, arms):
        row = dict(_summary(ms[k]), iterations=statistics.mean(iters[k]), identical_to_eager=identical[k])
        if b is not None:
            rep = statistics.median(replay_ms[k])
            row.update(replay_ms=rep, iteration_ms=rep / b)
        out["arms"][k] = row
    out["capture_ms"] = capture_ms
    out["mixed"] = {"calls": a.mixed, "queries": int(sizes.sum()), "block": block0,
                    "identical_to_eager": mixed_identical}
    for k in mixed_arms:
        out["mixed"][k] = dict(_summary(mixed[k]["ms"]), ms_a_query=sum(mixed[k]["ms"]) / (2 * int(sizes.sum())),
                               captures=mixed[k]["captures"])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
