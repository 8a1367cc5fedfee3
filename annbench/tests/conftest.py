"""Fixtures of the benchmark's own tests (``python -m pytest annbench/tests``).

``tiny_root`` is a throwaway copy of the benchmark (``BENCHMARK.json`` and
``annbench/``) with one more configuration, traffic mix and pair of cells
at a size the CPU runs in a second: added as files and manifest entries
only, as a later change would add them.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "name": "tiny", "source": "a CPU-sized copy of canonical-56k", "data": {"distribution": "gaussian", "n": 2000,
                                                                          "d": 128},
    "k": 10,
    "graph": {"M": 8, "ef_construction": 40, "prune_cand": 40, "ortho_count": 1, "prune_overflow": 1,
              "query_expand": 2, "fused_cand": 8, "entry_seeds": 8, "query_block": 64, "packed_dtype": "bf16"},
    "flat": {"mode": "fused"}, "assumed": {}, "reduced": ["n"],
}
TINY_TRAFFIC = {"driver": "closed_loop", "clients": 1, "batch": 64, "pool": 128, "warmup_calls": 2, "trace_calls": 2}
LIMITS = {"miss_at_10": 0.2, "order_gap": 0.01, "bad_ids": 0}
CELLS = {
    "tiny-graph": {"engine": "graph", "ef": 40, "control": "fp8", "limits": LIMITS},
    "tiny-flat": {"engine": "flat", "control": "fp8", "limits": LIMITS},
}


def copy_benchmark(dst: Path) -> Path:
    """A copy of the committed benchmark under ``dst`` (caches left out)."""
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "annbench", dst / "annbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__", "tests"))
    return dst


def add_tiny(root: Path) -> None:
    """Add the tiny configuration, traffic and cells as new files, and name
    them in the copy's manifest."""
    base = root / "annbench"
    (base / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (base / "traffic" / "tiny-b64.json").write_text(json.dumps(TINY_TRAFFIC))
    for name, spec in CELLS.items():
        (base / "workloads" / f"{name}.json").write_text(json.dumps(spec))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny", "file": "annbench/configs/tiny.json",
                             "reduced": ["n"], "why": "CPU-sized"})
    for name in CELLS:
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": "tiny-b64", "chips": 1, "why": "CPU"})
    for m in bench["end_to_end"]:
        if m["name"] == "qps":
            m["workloads"] += list(CELLS)
    for m in bench["per_layer"]:
        if m["name"] in ("idle_share.batch", "copy_us_per_query"):
            m["workloads"] += list(CELLS)
        if m["name"] == "distcomps_per_query.batch":
            m["workloads"].append("tiny-graph")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture
def tiny_root(tmp_path):
    root = copy_benchmark(tmp_path)
    add_tiny(root)
    return root


@pytest.fixture
def cuda_card():
    """Skip where there is no CUDA card (decided here, never at import)."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with python -m pytest -m cuda annbench/tests")
