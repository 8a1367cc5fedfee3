"""The reader of ``rows_traversal_roofline`` on hand-worked synthetic
contexts, and CPU runs of throwaway cells through the two engine adapters
``graph_gather`` (the rows route) and ``flat_i8``."""

from __future__ import annotations

import json
import types
from pathlib import Path

import pytest

from annbench import devtrace
from annbench.harness import run_cell
from annbench.manifest import load_module
from annbench.peaks import HBM_BYTES_S

REPO = Path(__file__).resolve().parents[2]
NAME = "rows_traversal_roofline"
SEED = 2**31 + 1021
ROWS_KERNEL = "(anonymous namespace)::fused_search_rows_kernel(__nv_bfloat16 const*, float const*, int const*)"
K1 = "(anonymous namespace)::fused_search_kernel(__nv_bfloat16 const*, float const*, int const*)"


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def reader():
    return load_module(REPO / "annbench" / "metrics" / f"{NAME}.py", "test_rows_roofline_metric")


def _ctx(events, counters, traced_queries=2000, d=960, on_card=True):
    return types.SimpleNamespace(trace=devtrace.Trace(events), traced_calls=2, traced_queries=traced_queries,
                                 counters=counters, stages={}, batch=1000, n=10**6, d=d, k=10, on_card=on_card)


CALLS = [_ev(devtrace.CALL, 0, 1000, "user_annotation"), _ev(devtrace.CALL, 2000, 1000, "user_annotation")]
# K1-rows 100 + 150 µs in call 1 (overlapping records count once: [100, 300]), 300 µs in call 2;
# K1 and a record after the calls are left out
KERNELS = [_ev(ROWS_KERNEL, 100, 150), _ev(ROWS_KERNEL, 200, 100), _ev(ROWS_KERNEL, 2100, 300),
           _ev(K1, 400, 100), _ev(ROWS_KERNEL, 5000, 100)]


def test_share_of_the_rows_bound():
    """Counters over three calls (one untraced before the two traced): the
    rows a query is their ratio, so the extra call cancels.  12,000 rows a
    query of 960 dims (1928 B each) at 3.35 TB/s take 6.906 µs; the
    traced calls' 500 µs of K1-rows over 2000 queries are 0.25 µs a query."""
    ctx = _ctx(CALLS + KERNELS, {"rows_gathered": 3000 * 12000, "queries": 3000})
    bound_us = 12000 * (2 * 960 + 8) / HBM_BYTES_S * 1e6
    assert reader().read(ctx) == pytest.approx(100.0 * bound_us / 0.25)
    assert reader().row_bytes(960) == 1928
    # the same counters over the traced calls alone read the same
    assert reader().read(_ctx(CALLS + KERNELS, {"rows_gathered": 2000 * 12000, "queries": 2000})) == pytest.approx(
        reader().read(ctx))


def test_the_configurations_width_not_the_padded_one():
    a = reader().read(_ctx(CALLS + KERNELS, {"rows_gathered": 2000 * 100, "queries": 2000}, d=960))
    b = reader().read(_ctx(CALLS + KERNELS, {"rows_gathered": 2000 * 100, "queries": 2000}, d=1024))
    assert a / b == pytest.approx((2 * 960 + 8) / (2 * 1024 + 8))


@pytest.mark.parametrize("events,counters,on_card", [
    (CALLS + KERNELS, {"rows_gathered": 0, "queries": 0}, True),         # an engine without the counters
    (CALLS + KERNELS, {}, True),
    (CALLS + [_ev(K1, 100, 200)], {"rows_gathered": 10, "queries": 2}, True),  # K1 only: no rows route
    (CALLS + KERNELS, {"rows_gathered": 10, "queries": 2}, False),      # a CPU run
])
def test_nothing_to_read(events, counters, on_card):
    assert reader().read(_ctx(events, counters, on_card=on_card)) is None


def _add_cells(root: Path) -> None:
    """A 256-dim tiny configuration served through the rows route where the
    budget sends it there, and two cells: graph_gather on it, flat_i8 on the
    tiny configuration."""
    from conftest import TINY_CONFIG, add_tiny  # noqa: E402  (this directory's fixtures module)

    add_tiny(root)
    base = root / "annbench"
    wide = {**TINY_CONFIG, "name": "tiny-wide", "data": {"distribution": "clustered", "n": 2000, "d": 256,
                                                         "clusters": 20, "sigma": 0.3},
            "graph": {**TINY_CONFIG["graph"], "use_packed": True, "use_fused": True}}
    (base / "configs" / "tiny-wide.json").write_text(json.dumps(wide))
    limits = {"miss_at_10": 0.3, "order_gap": 0.01, "bad_ids": 0}
    (base / "workloads" / "tiny-rows.json").write_text(json.dumps(
        {"engine": "graph_gather", "ef": 40, "control": "fp8", "limits": limits}))
    (base / "workloads" / "tiny-flat-i8.json").write_text(json.dumps(
        {"engine": "flat_i8", "control": "int4", "limits": limits}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-wide", "source": "https://example.org/tiny",
                             "file": "annbench/configs/tiny-wide.json", "reduced": ["n"], "why": "CPU-sized"})
    bench["workloads"] += [{"name": "tiny-rows", "config": "tiny-wide", "traffic": "tiny-b64", "chips": 1, "why": "CPU"},
                           {"name": "tiny-flat-i8", "config": "tiny", "traffic": "tiny-b16", "chips": 1, "why": "CPU"}]
    (base / "traffic" / "tiny-b16.json").write_text(json.dumps(
        {"driver": "closed_loop", "clients": 1, "batch": 16, "pool": 64, "warmup_calls": 1, "trace_calls": 2}))
    for m in bench["end_to_end"]:
        if m["name"] == "qps":
            m["workloads"] += ["tiny-rows", "tiny-flat-i8"]
    for m in bench["per_layer"]:
        if m["name"] == NAME:
            m["workloads"].append("tiny-rows")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def test_rows_and_i8_cells_run_on_cpu(tmp_path, monkeypatch):
    """Both adapters through whole runs: the graph engine under a budget
    that admits the rows and not the blocks reads rows and counts them and
    its queries; the i8 flat engine quantizes and reranks.  Both correct;
    the traced run carries no roofline from a CPU trace."""
    from conftest import copy_benchmark  # noqa: E402

    from expann_tpu_torch.models import antitopo
    from expann_tpu_torch.ops.packed import rows_bytes

    root = copy_benchmark(tmp_path)
    _add_cells(root)
    monkeypatch.setattr(antitopo, "PACKED_BUDGET_BYTES", rows_bytes(2001, 256))
    seen = []
    real = antitopo.AntitopoEngine._query

    def spy(self, queries, k):
        out = real(self, queries, k)
        seen.append((self.graph.packed is None and self.graph.packed_rows is not None, self.num_rows_gathered,
                     self.num_queries))
        return out

    monkeypatch.setattr(antitopo.AntitopoEngine, "_query", spy)
    result, _ = run_cell("tiny-rows", SEED, 0.3, True, root=root, device="cpu", log=lambda line: None)
    assert result["correct"] and result["failed"] == 0
    assert NAME not in result["metrics"]
    assert all(rows for rows, _, _ in seen) and seen[-1][1] > 0 and seen[-1][2] == 64 * len(seen)
    flat, _ = run_cell("tiny-flat-i8", SEED, 0.3, False, root=root, device="cpu", log=lambda line: None)
    assert flat["correct"] and flat["failed"] == 0 and flat["attempted"] >= 16
