"""The reader of ``graph_replays_per_query.single`` on hand-worked synthetic
traces: the ``expann.search.replay`` spans inside the traced calls per
traced query, and nothing from a program that records no query span."""

from __future__ import annotations

import types
from pathlib import Path

from annbench import devtrace
from annbench.manifest import load_module

REPO = Path(__file__).resolve().parents[2]
NAME = "graph_replays_per_query.single"


def _ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _read(events, traced_queries=2):
    ctx = types.SimpleNamespace(trace=devtrace.Trace(events), traced_calls=2, traced_queries=traced_queries,
                                counters={}, stages={}, batch=1, n=1000, d=128, k=10, on_card=True)
    return load_module(REPO / "annbench" / "metrics" / f"{NAME}.py", "test_replay_metric").read(ctx)


CALLS = [_ev(devtrace.CALL, 0, 100), _ev(devtrace.CALL, 200, 100)]
QUERIES = [_ev("expann.engine.query", 1, 98), _ev("expann.engine.query", 201, 98)]


def test_replays_per_traced_query():
    replays = [_ev("expann.search.replay", ts, 5) for ts in (10, 20, 30, 210)]
    others = [
        _ev("expann.sync", 16, 3),                                   # another span: no replay
        _ev("expann.search.replay", 400, 5),                         # after the calls: left out
        _ev("expann.search.replay", 40, 5, cat="gpu_user_annotation"),  # a device record of the name
    ]
    assert _read(CALLS + QUERIES + replays + others) == 2.0  # 4 replays / 2 queries


def test_the_eager_loop_reads_zero_replays():
    assert _read(CALLS + QUERIES + [_ev("expann.sync", 16, 3), _ev("expann.sync", 216, 3)]) == 0


def test_nothing_without_a_query_span():
    """A program without spans: its calls hold only the profiler's own records."""
    tr = CALLS + [_ev("aten::copy_", 10, 20, cat="cpu_op"), _ev("cudaGraphLaunch", 40, 10, cat="cuda_runtime")]
    assert _read(tr) is None
    assert _read(CALLS + QUERIES, traced_queries=0) is None
