"""The readers of the program's spans and stage seconds, on hand-worked
synthetic traces: each reads the ``expann.*`` host records inside the
traced calls or the builder's ``seconds``, and reads nothing from a program
that records neither."""

from __future__ import annotations

import types
from pathlib import Path

import pytest

from annbench import devtrace
from annbench.manifest import load_module

REPO = Path(__file__).resolve().parents[2]
NEW = ("host_cast_us_per_query", "host_syncs_per_query.single", "sync_wait_us_per_query.single",
       "host_dispatch_us_per_query.single", "build_scan_s", "build_prune_s")


def _ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def single_query_trace():
    """Two traced single-query calls, each one ``expann.engine.query`` span
    holding its casts and syncs."""
    return devtrace.Trace([
        _ev(devtrace.CALL, 100, 100),                    # call 1: [100, 200]
        _ev(devtrace.CALL, 300, 100),                    # call 2: [300, 400]
        _ev("expann.engine.query", 102, 96),             # [102, 198]
        _ev("expann.engine.cast", 103, 2),               # [103, 105]
        _ev("expann.sync", 120, 10),                     # [120, 130]
        _ev("expann.sync", 150, 20),                     # [150, 170]
        _ev("expann.engine.query", 301, 98),             # [301, 399]
        _ev("expann.engine.cast", 302, 3),               # [302, 305]
        _ev("expann.engine.cast", 304, 2),               # [304, 306]: overlaps, the union counts it once
        _ev("expann.sync", 340, 30),                     # [340, 370]
        _ev("expann.search.rerank", 130, 20),            # another span: no sync
        _ev("expann.sync", 500, 10),                     # after the calls: left out
        _ev("expann.sync", 160, 5, cat="gpu_user_annotation"),  # a device record of the name: not a host sync
    ])


def _ctx(tr, **kw):
    base = dict(trace=tr, traced_calls=2, traced_queries=2, counters={}, stages={}, batch=1, n=1000, d=128, k=10,
                on_card=True)
    base.update(kw)
    return types.SimpleNamespace(**base)


def reader(name):
    return load_module(REPO / "annbench" / "metrics" / f"{name}.py", f"test_span_metric_{name}")


def test_span_readers_on_the_synthetic_trace():
    ctx = _ctx(single_query_trace())
    assert reader("host_syncs_per_query.single").read(ctx) == 1.5  # 3 syncs inside the calls / 2
    assert reader("sync_wait_us_per_query.single").read(ctx) == pytest.approx(30.0)  # (10 + 20 + 30) / 2
    # the query spans' union 96 + 98 less the 60 µs of syncs inside them, per query
    assert reader("host_dispatch_us_per_query.single").read(ctx) == pytest.approx(67.0)
    assert reader("host_cast_us_per_query").read(ctx) == pytest.approx(3.0)  # (2 + 4) / 2
    wait = reader("sync_wait_us_per_query.single").read(ctx)
    dispatch = reader("host_dispatch_us_per_query.single").read(ctx)
    assert (wait + dispatch) * ctx.traced_queries == pytest.approx(96 + 98)


def test_dispatch_counts_a_sync_outside_the_query_span_once():
    tr = devtrace.Trace([_ev(devtrace.CALL, 0, 100), _ev("expann.engine.query", 10, 50), _ev("expann.sync", 40, 40)])
    ctx = _ctx(tr, traced_queries=1)
    assert reader("host_dispatch_us_per_query.single").read(ctx) == pytest.approx(30.0)  # [10, 40]
    assert reader("sync_wait_us_per_query.single").read(ctx) == pytest.approx(40.0)


def test_a_query_without_syncs_reads_zero_syncs():
    tr = devtrace.Trace([_ev(devtrace.CALL, 0, 100), _ev("expann.engine.query", 10, 50)])
    ctx = _ctx(tr, traced_queries=1)
    assert reader("host_syncs_per_query.single").read(ctx) == 0
    assert reader("sync_wait_us_per_query.single").read(ctx) == 0
    assert reader("host_dispatch_us_per_query.single").read(ctx) == pytest.approx(50.0)


def test_build_stage_readers():
    ctx = _ctx(single_query_trace(), stages={"forward": 27.0, "scan": 16.5, "prune": 8.25, "rows": 2.0})
    assert reader("build_scan_s").read(ctx) == 16.5
    assert reader("build_prune_s").read(ctx) == 8.25


def test_span_readers_read_nothing_from_a_program_without_spans():
    """The parent of the spans: its traced calls hold only the profiler's own
    records, and its builder keeps no ``scan`` or ``prune`` seconds."""
    tr = devtrace.Trace([_ev(devtrace.CALL, 0, 100), _ev("aten::copy_", 10, 20, cat="cpu_op"),
                         _ev("cudaMemcpyAsync", 40, 10, cat="cuda_runtime")])
    for stages in ({}, {"forward": 27.0, "reverse": 11.0}):
        ctx = _ctx(tr, stages=stages)
        for name in NEW:
            assert reader(name).read(ctx) is None, name
