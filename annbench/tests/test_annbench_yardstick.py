"""The yardstick's arithmetic on hand-worked cases: the plain reference's
exact top-k, the recall and the other compared numbers, the flat bound,
the trace reader, and the control, which has to fail a cell's limits."""

from __future__ import annotations

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from annbench import check, devtrace, peaks, reference
from annbench.manifest import load_module

REPO = Path(__file__).resolve().parents[2]


def test_exact_topk_matches_numpy_with_ties_by_id():
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, size=(300, 16)).astype(np.float32)
    x[150:] = x[:150]  # every row twice: ties everywhere
    q = rng.integers(-3, 4, size=(40, 16)).astype(np.float32)
    ids, d = reference.exact_topk(torch.from_numpy(x), torch.from_numpy(q), 10)
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    want = np.lexsort((np.broadcast_to(np.arange(300), d2.shape), d2), axis=1)[:, :10]
    assert np.array_equal(ids.numpy(), want)
    assert np.array_equal(d.numpy(), np.take_along_axis(d2, want, 1))


def test_exact_topk_in_blocks(monkeypatch):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((500, 8)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((33, 8)).astype(np.float32))
    whole = reference.exact_topk(x, q, 5)[0]
    monkeypatch.setattr(reference, "BLOCK_ELEMS", 500 * 4)  # 4 queries a block
    assert torch.equal(reference.exact_topk(x, q, 5)[0], whole)


def test_recall_arithmetic():
    gt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    ids = torch.tensor([[4, 3, 9, 9], [5, 6, 7, 8]])
    assert check.recall(ids, gt) == (6, 8)
    assert check.recall(gt, gt) == (8, 8)


def test_judge_counts_misses_order_and_bad_ids():
    x = torch.tensor([[float(i), 0.0] for i in range(10)])
    pool = torch.zeros((2, 2))  # distance of row i is i * i
    gt = torch.tensor([[0, 1, 2], [0, 1, 2]])
    good = np.array([[0, 1, 2], [0, 1, 2]])
    out = check.judge([(0, good), (0, good.copy())], x, pool, gt, 2, 3)
    assert out == {"miss_at_10": 0.0, "order_gap": 0.0, "bad_ids": 0, "bad_rows": 0}
    swapped = np.array([[0, 2, 1], [0, 1, 3]])  # 4 -> 1 backwards: (4 - 1) / 4; one miss of six
    out = check.judge([(0, swapped)], x, pool, gt, 2, 3)
    assert out["order_gap"] == pytest.approx(0.75) and out["miss_at_10"] == pytest.approx(1 / 6)
    bad = np.array([[0, 0, 1], [0, 1, 10]])  # a repeat, an id past n
    out = check.judge([(0, bad)], x, pool, gt, 2, 3)
    assert out["bad_ids"] == 2 and out["bad_rows"] == 2
    out = check.judge([(0, good[:1])], x, pool, gt, 2, 3)  # a list missing
    assert out["bad_ids"] == 6 and out["miss_at_10"] == 1.0
    assert not check.passes(out, {"miss_at_10": 1.0, "order_gap": 1.0, "bad_ids": 0})


def test_unique_lists_count_repeats():
    a, b = np.arange(4).reshape(2, 2), np.arange(4).reshape(2, 2) + 1
    got = check.unique_lists([(0, a), (1, b), (0, a.copy()), (0, b)])
    assert sorted((s, c) for s, _, c in got) == [(0, 1), (0, 2), (1, 1)]


def test_flat_bound_hand_worked():
    # 16384 x 1M x 128: 2 * 16384 * 1e6 * 128 = 4.194304e12 operations at 989 TFLOP/s
    assert peaks.flat_bound_s(16384, 1_000_000, 128, 10) == pytest.approx(4.194304e12 / 989e12)
    # 1 query over 1M rows is bound by bytes: 256e6 + 4e6 + 256 + 80 bytes at 3.35 TB/s
    assert peaks.flat_bound_s(1, 1_000_000, 128, 10) == pytest.approx((256e6 + 4e6 + 256 + 80) / 3.35e12)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def synthetic_trace():
    return devtrace.Trace([
        _ev("user_annotation", devtrace.CALL, 100, 100),   # call 1: [100, 200]
        _ev("user_annotation", devtrace.CALL, 250, 50),    # call 2: [250, 300]
        _ev("kernel", "(anonymous namespace)::fused_search_kernel(x)", 110, 40),  # [110, 150]
        _ev("kernel", "fused_search_s8_kernel(x)", 140, 30),  # overlaps: union [110, 170]
        _ev("kernel", "not_fused_search_kernel(x)", 150, 10),  # another kernel inside the union
        _ev("kernel", "rerank", 260, 20),                  # [260, 280]
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 100, 5),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 195, 10),  # [195, 205]
        _ev("kernel", "outside", 400, 10),                 # after the span: left out
        _ev("cpu_op", "aten::copy_", 170, 25),             # the host during [170, 195]
        _ev("cpu_op", "busy_host", 150, 150),              # covers the later gaps
    ])


def test_trace_reader_unions_overlaps_and_names_gaps():
    tr = synthetic_trace()
    assert tr.span_us == 200 and tr.calls == 2
    assert devtrace.union_us(tr.kernels) == 80  # 60 + 20, the overlap once
    assert tr.busy_us() == 95  # kernels 80, copies 5 + 10
    assert dict(tr.device_ops())["fused_search_s8_kernel(x)"] == pytest.approx(30e-6)
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(25e-6)  # [170, 195]
    assert gaps["busy_host"] == pytest.approx(75e-6)  # [205, 260] and [280, 300]
    assert gaps["host (no record)"] == pytest.approx(5e-6)  # [105, 110]
    assert sum(gaps.values()) == pytest.approx((200 - 95) * 1e-6)


def _ctx(tr, **kw):
    base = dict(trace=tr, traced_calls=2, traced_queries=10, counters={"distcomps": 50, "distcomps_compressed": 0},
                stages={"forward": 1.5}, batch=5, n=1000, d=128, k=10, on_card=True)
    base.update(kw)
    return types.SimpleNamespace(**base)


def reader(name):
    return load_module(REPO / "annbench" / "metrics" / f"{name}.py", f"test_metric_{name}")


def test_readers_on_the_synthetic_trace():
    tr = synthetic_trace()
    ctx = _ctx(tr)
    assert reader("traversal_us_per_query").read(ctx) == pytest.approx(6.0)  # 60 us / 10
    assert reader("copy_us_per_query").read(ctx) == pytest.approx(1.5)  # (5 + 10) us / 10
    assert reader("idle_share.batch").read(ctx) == pytest.approx(1 - 95 / 200)
    assert reader("distcomps_per_query.batch").read(ctx) == 5.0
    assert reader("build_forward_s").read(ctx) == 1.5
    assert reader("build_reverse_s").read(ctx) is None
    want = 100 * 2 * peaks.flat_bound_s(5, 1000, 128, 10) / 80e-6
    assert reader("flat_scan_roofline").read(ctx) == pytest.approx(want)


def test_readers_find_nothing_and_return_nothing():
    empty = devtrace.Trace([_ev("user_annotation", devtrace.CALL, 0, 10)])
    ctx = _ctx(empty, counters={}, stages={}, on_card=False)
    for name in ("traversal_us_per_query", "copy_us_per_query", "idle_share.batch", "idle_share.single",
                 "flat_scan_roofline", "distcomps_per_query.batch", "build_forward_s"):
        assert reader(name).read(ctx) is None, name


@pytest.mark.parametrize("prec", ["fp8", "int4"])
def test_control_fails_the_cells_limits(prec):
    """The control (the reference in the next precision down) comes out not
    correct against every limit set that names it, here at 4000 x 128 rows."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((4000, 128), generator=g)
    q = torch.randn((256, 128), generator=g)
    gt = reference.exact_topk(x, q, 10)[0]
    ids = reference.lowprec_topk(x, q, 10, prec).numpy()
    numbers = check.judge([(0, ids)], x, q, gt, 256, 10)
    assert numbers["bad_ids"] == 0
    cells = [json.loads(p.read_text()) for p in (REPO / "annbench" / "workloads").glob("*.json")]
    for spec in cells:
        if spec["control"] == prec:
            assert not check.passes(numbers, spec["limits"]), (spec, numbers)
    exact = check.judge([(0, gt.numpy())], x, q, gt, 256, 10)
    assert exact["miss_at_10"] == 0.0 and exact["order_gap"] == 0.0
