"""The graph engine under test with the int8 query wire: ``AntitopoEngine``
built and served as ``engines/graph.py`` does, with ``query_wire="i8"``, so
each fused-route chunk is shipped as absmax int8 codes (1 B a dimension)
with one scale a query, quantized on the host, and the card searches and
reranks the dequantized query."""

from __future__ import annotations

from annbench.engines import graph
from annbench.engines.graph import counters, prepare, stages  # noqa: F401  (the same engine's counters and stages)


def build(config: dict, spec: dict, x, device):
    """``(engine, build seconds)``: ``engines/graph.build`` with the int8
    query wire."""
    return graph.build({**config, "graph": {**config["graph"], "query_wire": "i8"}}, spec, x, device)
