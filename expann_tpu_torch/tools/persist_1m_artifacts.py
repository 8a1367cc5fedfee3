"""Persist a million-row run as reference-schema artifacts (counterpart of
tools/persist_1m_artifacts.py).

``tools/bench_1m.py`` prints one JSON line per point and a final
``{"summary_1m": [...]}`` line; this tool turns that summary into the
reference's bench-data layout, ``<root>/<dataset>/data/all.json`` (appended)
and ``latest.json`` (overwritten) (reference: src/bench_data_manager.h:64-88,
src/main.cpp:105-106), through this package's ``bench/manager.py``, and
draws the recall-against-time pareto PNG with ``pyplotter.static_plot``.
Each record names the card its point was measured on (``param_list["card"]``).
The JAX tool's ``--builtin`` replays two TPU runs and is not carried::

    python -m expann_tpu_torch.tools.persist_1m_artifacts --log bench_1m.log \\
        --dataset million_row_clustered_hardened_n1000000_d128_k10_h100
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Optional

from expann_tpu_torch.bench.bench_data import BenchData
from expann_tpu_torch.bench.manager import BenchDataManager
from expann_tpu_torch.pyplotter import load_records, static_plot

_GRAPH = re.compile(r"antitopo_ef(?P<ef>\d+)_e(?P<e>\d+)_c(?P<c>\d+)_(?P<dt>\w+)")


def to_records(build: dict, points: list, M: int, efc: int, k: int) -> list:
    """bench_1m's points as reference-schema records: the graph points
    (``antitopo_ef*``) with the build's time and parameters, the flat points
    (``gpu_flat_*``) with their own build time."""
    build_ns = float(build.get("build_s", 0.0)) * 1e9
    n = int(build.get("n", 0))
    recs = []
    for pt in points:
        bd = BenchData(recall=float(pt["recall"]), time_per_query_ns=1e9 / float(pt["qps"]))
        m = _GRAPH.fullmatch(pt["point"])
        if m:
            bd.engine_name = "Anti-Topo Engine+"
            bd.time_to_build_ns = build_ns
            bd.param_list = {
                "M": str(M), "M0": str(2 * M), "ef_search": m.group("ef"), "ef_construction": str(efc),
                "expand": m.group("e"), "cand": m.group("c"), "packed_dtype": m.group("dt"),
                "build_waves": str(build.get("waves", "")), "build_candidates": str(build.get("candidates", "")),
                "num_distcomps": str(int(pt.get("distcomps", 0))), "k": str(k),
            }
        else:
            bd.engine_name = "GPU-Flat (i8+rerank)" if pt["point"].endswith("_i8") else "GPU-Flat"
            bd.time_to_build_ns = float(pt.get("build_s", 0.0)) * 1e9
            bd.param_list = {"k": str(k), "num_distcomps": str(n)}
        bd.param_list["card"] = str(pt.get("card", ""))
        recs.append(bd)
    return recs


def parse_log(path: str) -> tuple:
    """``(build, points)`` from the ``summary_1m`` line of a bench_1m log;
    points without a QPS (a run off the card) are left out."""
    summary = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{") and "summary_1m" in line:
                summary = json.loads(line)["summary_1m"]
    if summary is None:
        raise SystemExit(f"no summary_1m line in {path}")
    build = next((p for p in summary if p["point"] == "build"), {})
    points = [p for p in summary if p["point"] not in ("build", "refine") and p.get("qps")]
    return build, points


def persist(root: str, ds_name: str, build: dict, points: list, M: int, efc: int, k: int) -> Optional[str]:
    """Write the records and the PNG under ``<root>/<ds_name>/``; returns the
    PNG's path, or None where matplotlib is not installed (the records are
    written either way)."""
    mgr = BenchDataManager(ds_name)
    for bd in to_records(build, points, M, efc, k):
        mgr.add(bd)
    prefix = os.path.join(root, ds_name) + os.sep
    mgr.save(prefix=prefix)
    png = os.path.join(prefix, "pareto.png")
    try:
        static_plot(load_records(os.path.join(prefix, "data"), "all.json"), "recall", "time_per_query_ns", png)
    except ModuleNotFoundError as e:
        print(f"pareto PNG not drawn: {e}", flush=True)
        return None
    return png


def main(argv=None) -> Optional[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", required=True, help="bench_1m log holding a summary_1m line")
    ap.add_argument("--dataset", required=True, help="directory name under --root")
    ap.add_argument("--root", default="data")
    ap.add_argument("--k", type=int, default=10)
    args = ap.parse_args(argv)
    build, points = parse_log(args.log)
    M, efc = int(build.get("M", 48)), int(build.get("efc", 300))
    png = persist(args.root, args.dataset, build, points, M, efc, args.k)
    print(f"{args.dataset}: {len(points)} points -> {os.path.join(args.root, args.dataset, 'data')}/"
          + (f" + {png}" if png else ""), flush=True)
    return png


if __name__ == "__main__":
    main()
