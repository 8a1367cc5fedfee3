"""What the program's spans (``utils/profiling.annotate``) cost a single
query, traced and untraced.

Builds the canonical 56k index (N(0,1) rows, d=128, drawn from ``--seed``)
with the graph settings of the benchmark's single-query cell (M=60,
efc=prune_cand=500, expand 2, bf16 blocks, ef=120) and times calls of one
query each, the per-iteration route, in two arms that alternate in ABBA
order so that a drift of the shared host falls on both:

  * ``spans``: the package's ``annotate`` as it is;
  * ``none``: ``annotate`` swapped for ``profiling.no_stage`` (the shared
    null context) in every module that opens a query span.

Each arm runs ``--per-arm`` queries, once under a ``torch.profiler`` session
recording the host and the card (as the benchmark's traced calls are) and
once without one.  Per traced arm it counts the profiler's host records a
query (the spans, and the ops and runtime calls; not the card's records),
and it times one record alone under the same profiler: an empty span, and
a one-element op.  The spans' cost a traced query should then be the span
records a query times the cost of one, and the untraced cost a flag check
a span::

    python -m expann_tpu_torch.tools.perf_span_cost [--n 56000] [--pairs 16] [--per-arm 4]
        [--seed 0] [--device cuda]

Prints one JSON object: per mode the per-pair milliseconds a query of
each arm, their differences with quartiles, the record counts, and the
cost of one record.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from expann_tpu_torch.models import antitopo, search
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.utils import profiling

# the canonical configuration of the single-query cell (annbench/configs/canonical-56k.json)
GRAPH = dict(M=60, ef_construction=500, prune_cand=500, ortho_count=1, prune_overflow=1, query_expand=2,
             packed_topt=8, fused_cand=8, fused_qt=128, query_block=16384, entry_seeds=8, packed_dtype="bf16")
SPAN_MODULES = (antitopo, search)


def _activities(device):
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])


def _profile(device):
    return torch.profiler.profile(activities=_activities(device))


def _set_spans(on: bool) -> None:
    for mod in SPAN_MODULES:
        mod.annotate = profiling.annotate if on else profiling.no_stage


def _arm(eng, queries, traced: bool, device):
    """``(ms a query, span records a query, other host records a query)``."""
    def run():
        t0 = time.perf_counter()
        for q in queries:
            eng.query_k_batch(q[None], 10)
        return (time.perf_counter() - t0) * 1e3 / len(queries)

    if not traced:
        return run(), None, None
    with _profile(device) as prof:
        ms = run()
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]  # the card's records left out
    spans = sum(1 for e in events if e.name.startswith("expann."))
    return ms, spans / len(queries), (len(events) - spans) / len(queries)


def _record_us(device, reps: int = 2000) -> dict:
    """µs of one empty span and of one one-element op (an aten record and,
    on the card, a launch), each alone under the profiler."""
    t = torch.zeros(1, device=device)

    def span():
        with profiling.annotate("expann.cost"):
            pass

    def op():
        t.add_(1)

    out = {}
    with _profile(device):
        for name, fn in (("span", span), ("op", op)):
            fn()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out[name] = (time.perf_counter() - t0) * 1e6 / reps
    return out


def _summary(rows) -> dict:
    diff = [r["spans_ms"] - r["none_ms"] for r in rows]
    return {
        "pairs": rows,
        "spans_ms_median": statistics.median(r["spans_ms"] for r in rows),
        "none_ms_median": statistics.median(r["none_ms"] for r in rows),
        "diff_ms_quartiles": statistics.quantiles(diff, n=4),
        "diff_positive": sum(d > 0 for d in diff),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=56000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--ef", type=int, default=120)
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--per-arm", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = torch.device(a.device)

    gen = torch.Generator(device=device).manual_seed(a.seed)
    x = torch.randn((a.n, a.d), generator=gen, device=device).cpu().numpy()
    pool = torch.randn((4 * a.per_arm, a.d), generator=gen, device=device).cpu().numpy().astype(np.float32)
    eng = AntitopoEngine(config=AntitopoConfig(**GRAPH, ef_search=a.ef), device=device)
    eng.store_many_vectors(x)
    t0 = time.perf_counter()
    eng.build()
    build_s = time.perf_counter() - t0
    eng.query_k_batch(pool[:1], 10)  # the packed layout
    with _profile(device):  # the first session in a process pays the tracer's start-up
        eng.query_k_batch(pool[:1], 10)

    out = {"card": profiling.card_name() if device.type == "cuda" else "cpu", "torch": torch.__version__,
           "n": a.n, "ef": a.ef, "per_arm": a.per_arm, "build_s": build_s, "record_us": _record_us(device)}
    try:
        for traced in (True, False):
            rows = []
            for i in range(a.pairs):
                qs = pool[(i % 4) * a.per_arm : (i % 4 + 1) * a.per_arm]
                row = {}
                for on in ((True, False) if i % 2 == 0 else (False, True)):
                    _set_spans(on)
                    ms, spans, other = _arm(eng, qs, traced, device)
                    key = "spans" if on else "none"
                    row[f"{key}_ms"] = ms
                    if traced:
                        row[f"{key}_span_records"], row[f"{key}_other_records"] = spans, other
                rows.append(row)
            out["traced" if traced else "untraced"] = _summary(rows)
    finally:
        _set_spans(True)
    tr = out["traced"]
    span_records = statistics.median(r["spans_span_records"] for r in tr["pairs"])
    out["predicted_traced_diff_ms"] = span_records * out["record_us"]["span"] * 1e-3
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
