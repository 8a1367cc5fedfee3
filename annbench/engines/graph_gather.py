"""The graph engine on an index whose packed blocks do not fit the card:
``AntitopoEngine`` built and served as ``engines/graph.py`` does, its fused
route reading each neighbour's row by id (K1-rows).  Its counters are the
rows that route gathered and the queries answered; an engine without those
counters reads 0 for each."""

from __future__ import annotations

from annbench.engines.graph import build, prepare, stages  # noqa: F401  (the same engine, the same build)


def counters(eng) -> dict:
    return {"rows_gathered": getattr(eng, "num_rows_gathered", 0), "queries": getattr(eng, "num_queries", 0)}
