"""The reader of ``rows_s8_traversal_roofline`` on hand-worked synthetic
contexts, and CPU runs of throwaway cells through the code rows route
(``graph_gather`` on an s8 configuration) and the ``graph_wire_i8``
adapter."""

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
NAME = "rows_s8_traversal_roofline"
SEED = 2**31 + 2029
S8_KERNEL = "(anonymous namespace)::fused_search_rows_s8_kernel(signed char const*, float const*, int const*)"
ROWS_KERNEL = "(anonymous namespace)::fused_search_rows_kernel(__nv_bfloat16 const*, float const*, int const*)"


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def reader():
    return load_module(REPO / "annbench" / "metrics" / f"{NAME}.py", "test_rows_s8_roofline_metric")


def _ctx(events, counters, traced_queries=2000, d=960, on_card=True):
    return types.SimpleNamespace(trace=devtrace.Trace(events), traced_calls=2, traced_queries=traced_queries,
                                 counters=counters, stages={}, batch=1000, n=10**6, d=d, k=10, on_card=on_card)


CALLS = [_ev(devtrace.CALL, 0, 1000, "user_annotation"), _ev(devtrace.CALL, 2000, 1000, "user_annotation")]
# K1-rows-s8 100 + 150 µs in call 1 (overlapping records count once: [100, 300]), 300 µs in call 2;
# K1-rows (bf16) and a record after the calls are left out
KERNELS = [_ev(S8_KERNEL, 100, 150), _ev(S8_KERNEL, 200, 100), _ev(S8_KERNEL, 2100, 300),
           _ev(ROWS_KERNEL, 400, 100), _ev(S8_KERNEL, 5000, 100)]


def test_share_of_the_code_rows_bound():
    """Counters over three calls (one untraced before the two traced): the
    rows a query is their ratio, so the extra call cancels.  12,000 rows a
    query of 960 codes (968 B each) at 3.35 TB/s take 3.467 µs; the traced
    calls' 500 µs of K1-rows-s8 over 2000 queries are 0.25 µs a query."""
    ctx = _ctx(CALLS + KERNELS, {"rows_gathered": 3000 * 12000, "queries": 3000})
    bound_us = 12000 * (960 + 8) / HBM_BYTES_S * 1e6
    assert reader().read(ctx) == pytest.approx(100.0 * bound_us / 0.25)
    assert reader().row_bytes(960) == 968
    assert reader().read(_ctx(CALLS + KERNELS, {"rows_gathered": 2000 * 12000, "queries": 2000})) == pytest.approx(
        reader().read(ctx))


def test_the_configurations_width_not_the_padded_one():
    a = reader().read(_ctx(CALLS + KERNELS, {"rows_gathered": 2000 * 100, "queries": 2000}, d=960))
    b = reader().read(_ctx(CALLS + KERNELS, {"rows_gathered": 2000 * 100, "queries": 2000}, d=1024))
    assert a / b == pytest.approx((960 + 8) / (1024 + 8))


@pytest.mark.parametrize("events,counters,on_card", [
    (CALLS + KERNELS, {"rows_gathered": 0, "queries": 0}, True),          # an engine without the counters
    (CALLS + KERNELS, {}, True),
    (CALLS + [_ev(ROWS_KERNEL, 100, 200)], {"rows_gathered": 10, "queries": 2}, True),  # bf16 rows: not K1-rows-s8
    (CALLS + KERNELS, {"rows_gathered": 10, "queries": 2}, False),       # a CPU run
])
def test_nothing_to_read(events, counters, on_card):
    assert reader().read(_ctx(events, counters, on_card=on_card)) is None


def _add_cells(root: Path) -> None:
    """A 256-dim s8 configuration served through the code rows where the
    budget sends it there, the tiny configuration on the fused route, and
    two cells: graph_gather on the first, graph_wire_i8 on the second."""
    from conftest import TINY_CONFIG, add_tiny  # noqa: E402  (this directory's fixtures module)

    add_tiny(root)
    base = root / "annbench"
    wide = {**TINY_CONFIG, "name": "tiny-wide-s8", "data": {"distribution": "clustered", "n": 2000, "d": 256,
                                                            "clusters": 20, "sigma": 0.3},
            "graph": {**TINY_CONFIG["graph"], "packed_dtype": "i8", "use_packed": True, "use_fused": True}}
    (base / "configs" / "tiny-wide-s8.json").write_text(json.dumps(wide))
    fused = {**TINY_CONFIG, "name": "tiny-fused", "graph": {**TINY_CONFIG["graph"], "use_packed": True,
                                                            "use_fused": True}}
    (base / "configs" / "tiny-fused.json").write_text(json.dumps(fused))
    limits = {"miss_at_10": 0.3, "order_gap": 0.05, "bad_ids": 0}
    (base / "workloads" / "tiny-code-rows.json").write_text(json.dumps(
        {"engine": "graph_gather", "ef": 40, "control": "int4", "limits": limits}))
    (base / "workloads" / "tiny-wire-i8.json").write_text(json.dumps(
        {"engine": "graph_wire_i8", "ef": 40, "control": "int4", "limits": limits}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-wide-s8", "source": "https://example.org/tiny",
                             "file": "annbench/configs/tiny-wide-s8.json", "reduced": ["n"], "why": "CPU-sized"})
    bench["configs"].append({"name": "tiny-fused", "source": "https://example.org/tiny",
                             "file": "annbench/configs/tiny-fused.json", "reduced": ["n"], "why": "CPU-sized"})
    bench["workloads"] += [
        {"name": "tiny-code-rows", "config": "tiny-wide-s8", "traffic": "tiny-b64", "chips": 1, "why": "CPU"},
        {"name": "tiny-wire-i8", "config": "tiny-fused", "traffic": "tiny-b64", "chips": 1, "why": "CPU"}]
    for m in bench["end_to_end"]:
        if m["name"] == "qps":
            m["workloads"] += ["tiny-code-rows", "tiny-wire-i8"]
    for m in bench["per_layer"]:
        if m["name"] == NAME:
            m["workloads"].append("tiny-code-rows")
        if m["name"] == "distcomps_per_query.batch":
            m["workloads"].append("tiny-wire-i8")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def test_code_rows_and_wire_cells_run_on_cpu(tmp_path, monkeypatch):
    """Both through whole runs: the s8 graph engine under a budget that
    admits the code rows and not the s8 blocks reads code rows and counts
    them and its queries; the wire adapter ships int8 queries on the fused
    route and counts its distance computations.  Both correct; the traced
    runs carry no roofline from a CPU trace, and the wire cell its distance
    count."""
    from conftest import copy_benchmark  # noqa: E402

    from expann_tpu_torch.models import antitopo
    from expann_tpu_torch.models.layout import CodeRows
    from expann_tpu_torch.ops.packed import code_rows_bytes

    root = copy_benchmark(tmp_path)
    _add_cells(root)
    budget = antitopo.PACKED_BUDGET_BYTES
    monkeypatch.setattr(antitopo, "PACKED_BUDGET_BYTES", code_rows_bytes(2001, 256))
    seen = []
    real = antitopo.AntitopoEngine._query

    def spy(self, queries, k):
        out = real(self, queries, k)
        seen.append((type(self.graph.layout), self.cfg.query_wire, self.num_rows_gathered, self.num_queries))
        return out

    monkeypatch.setattr(antitopo.AntitopoEngine, "_query", spy)
    result, _ = run_cell("tiny-code-rows", SEED, 0.3, True, root=root, device="cpu", log=lambda line: None)
    assert result["correct"] and result["failed"] == 0
    assert NAME not in result["metrics"]
    assert all(kind is CodeRows for kind, *_ in seen) and seen[-1][2] > 0 and seen[-1][3] == 64 * len(seen)
    seen.clear()
    monkeypatch.setattr(antitopo, "PACKED_BUDGET_BYTES", budget)
    wire, _ = run_cell("tiny-wire-i8", SEED, 0.3, True, root=root, device="cpu", log=lambda line: None)
    assert wire["correct"] and wire["failed"] == 0 and wire["attempted"] >= 64
    assert seen and all(w == "i8" and kind is not CodeRows for kind, w, *_ in seen)
    assert wire["metrics"]["distcomps_per_query.batch"]["value"] > 0
