"""The port's spans and stage seconds (utils/profiling.py): ``annotate`` is
free without a profiler and a ``user_annotation`` under one; every query
route records its spans inside one ``expann.engine.query``; one
``expann.sync`` a blocking device read; and the builders' stage seconds
``scan`` / ``prune`` / ``rows`` tile their phase.  CPU only, at a few
thousand rows."""

from __future__ import annotations

import json
import time
from collections import Counter

import numpy as np
import pytest
import torch

from expann_tpu_torch.models import build as tbuild
from expann_tpu_torch.models import search
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.models.brute_force import BruteForceEngine
from expann_tpu_torch.parallel import distbuild as tdist
from expann_tpu_torch.utils import profiling

N, D, NQ = 1500, 32, 6
GRAPH = dict(M=8, ef_construction=40, ef_search=20, query_expand=2, query_block=64)
ROUTES = {
    # route: (engine knobs, the spans the call must hold besides the engine's own)
    "per-iteration-packed": (dict(use_packed=True, use_fused=False),
                             {"expann.search.descend", "expann.search.traverse", "expann.sync", "expann.search.rerank"}),
    "per-iteration-gather": (dict(use_packed=False, use_fused=False),
                             {"expann.search.descend", "expann.search.traverse", "expann.sync"}),
    "fused-seeds": (dict(use_packed=True, use_fused=True, entry_seeds=4),
                    {"expann.search.entry", "expann.search.traverse", "expann.search.rerank"}),
    "fused-descent": (dict(use_packed=True, use_fused=True),
                      {"expann.search.entry", "expann.search.descend", "expann.sync", "expann.search.traverse",
                       "expann.search.rerank"}),
    "flat-fused": ("fused", {"expann.search.traverse"}),
    "flat-exact": ("exact", {"expann.search.traverse"}),
    "flat-fused-i8": ("fused_i8", {"expann.search.traverse", "expann.search.rerank"}),
}
ENGINE_SPANS = {"expann.engine.query", "expann.engine.cast", "expann.engine.upload", "expann.engine.download"}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return rng.standard_normal((N, D)).astype(np.float32), rng.standard_normal((NQ, D)).astype(np.float32)


@pytest.fixture(scope="module")
def graph(data):
    return tbuild.build_index(data[0], tbuild.BuildConfig(M=GRAPH["M"], ef_construction=GRAPH["ef_construction"]),
                              "cpu")


def _engine(route, data, graph):
    knobs = ROUTES[route][0]
    if isinstance(knobs, str):
        eng = BruteForceEngine(mode=knobs, device="cpu")
        eng.store_many_vectors(data[0])
        eng.build()
        return eng
    eng = AntitopoEngine(config=AntitopoConfig(**GRAPH, **knobs), device="cpu")
    eng.graph, eng.n, eng.dim = graph, N, D
    eng.query_k_batch(data[1][:1], 10)  # the packed layout and the entry members, before any trace
    return eng


def _spans(tmp_path, fn):
    """``[(name, start, end)]`` of the ``expann.*`` spans that ``fn`` records
    under ``profiling.trace`` (µs, the profiler's clock)."""
    with profiling.trace(str(tmp_path), device="cpu"):
        fn()
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith("expann.")]


def test_annotate_without_a_profiler_is_the_shared_null_context(data, graph, monkeypatch):
    assert profiling.annotate("expann.a") is profiling.annotate("expann.b")
    assert profiling.annotate("expann.a").__enter__() is None
    made = []

    def counting(*args, **kwargs):
        made.append(args)
        raise AssertionError("a span was made with no profiler recording")

    engines = [_engine(route, data, graph) for route in ("per-iteration-packed", "fused-descent", "flat-fused")]
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    for eng in engines:
        assert eng.query_k_batch(data[1], 10).shape == (NQ, 10)
    stats = {}
    tbuild.build_index(data[0][:300], tbuild.BuildConfig(M=6, ef_construction=20), "cpu", stats=stats)
    assert made == [] and set(stats["seconds"]) == {"scan", "prune", "rows", "upper"}


@pytest.mark.parametrize("route", list(ROUTES))
def test_every_span_of_a_call_nests_in_one_query_span(tmp_path, data, graph, route):
    eng = _engine(route, data, graph)
    spans = _spans(tmp_path, lambda: eng.query_k_batch(data[1], 10))
    names = {name for name, _, _ in spans}
    assert names == ENGINE_SPANS | ROUTES[route][1], names
    (root,) = [(s, e) for name, s, e in spans if name == "expann.engine.query"]
    assert all(root[0] <= s <= e <= root[1] for _, s, e in spans)


def test_sync_spans_are_descent_steps_plus_beam_iterations(tmp_path, data, graph, monkeypatch):
    """One ``expann.sync`` a blocking read: a descent step's ``better.any()``
    (the only ``any`` of the route) and a beam iteration's ``done.all()``."""
    eng = _engine("per-iteration-packed", data, graph)
    iters, steps = [], []
    beam_search, tensor_any = search.beam_search, torch.Tensor.any

    def counted_beam(*args, **kwargs):
        return beam_search(*args, **kwargs, iters=iters)

    def counted_any(self, *args, **kwargs):
        steps.append(1)
        return tensor_any(self, *args, **kwargs)

    monkeypatch.setattr(search, "beam_search", counted_beam)
    monkeypatch.setattr(torch.Tensor, "any", counted_any)
    spans = Counter(name for name, _, _ in _spans(tmp_path, lambda: eng.query_k_batch(data[1], 10)))
    monkeypatch.undo()
    assert len(iters) == 1 and iters[0] > 1 and len(steps) >= len(graph.layers) > 0
    assert spans["expann.sync"] == len(steps) + iters[0]


def test_one_shot_build_records_its_stage_seconds(tmp_path, data):
    stats = {}
    t0 = time.perf_counter()
    spans = _spans(tmp_path, lambda: tbuild.build_index(
        data[0], tbuild.BuildConfig(M=GRAPH["M"], ef_construction=GRAPH["ef_construction"]), "cpu", stats=stats))
    whole = time.perf_counter() - t0
    seconds = stats["seconds"]
    assert set(seconds) == {"scan", "prune", "rows", "upper"} and min(seconds.values()) > 0
    assert sum(seconds.values()) <= whole
    assert {"expann.build.scan", "expann.build.prune", "expann.build.rows",
            "expann.build.upper"} <= {name for name, _, _ in spans}


@pytest.mark.parametrize("mode,candidates", [("oneshot", "flat"), ("incremental", "dense")])
def test_distributed_build_splits_its_forward_stage(tmp_path, data, mode, candidates):
    stats = {}

    def build():
        _, out = tdist.build_distributed(data[0], tbuild.BuildConfig(M=GRAPH["M"], ef_construction=40), "cpu",
                                         wave_size=256, bootstrap=256, mode=mode, candidates=candidates)
        stats.update(out)

    spans = Counter(name for name, _, _ in _spans(tmp_path, build))
    seconds = stats["seconds"]
    assert {"bootstrap", "forward", "scan", "prune", "rows", "reverse", "cap_sweep", "upper"} == set(seconds)
    assert min(seconds[k] for k in ("scan", "prune", "rows")) > 0
    assert seconds["scan"] + seconds["prune"] + seconds["rows"] <= seconds["forward"]
    assert spans["expann.build.scan"] == spans["expann.build.prune"] == spans["expann.build.rows"] == stats["waves"]


def test_stage_clock_tiles_and_sums_repeated_stages(monkeypatch):
    ticks = iter([1.0, 3.0, 4.0, 8.0, 9.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(ticks))
    clock = profiling.StageClock("cpu")
    for name in ("scan", "prune", "scan", "rows"):
        with clock.stage(name):
            pass
    clock.stop()
    assert clock.seconds() == {"scan": 2.0 + 4.0, "prune": 1.0, "rows": 1.0}
    assert profiling.no_stage("scan") is profiling.annotate("expann.off")
