"""Whole runs of the harness: a throwaway cell found without an edit, the
faults that have to make ``correct`` false, the import guard, and (on the
card only) each real cell at the benchmark's window."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from annbench import guard
from annbench.harness import run_cell

REPO = Path(__file__).resolve().parents[2]
SEED = 2**31 + 977  # more than 32 signed bits hold


def _quiet(_line):
    pass


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "annbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("cell", ["tiny-graph", "tiny-flat"])
def test_a_new_cell_is_new_files_only(tmp_path, cell):
    from conftest import add_tiny, copy_benchmark  # noqa: E402  (this directory's fixtures module)

    root = copy_benchmark(tmp_path)
    before = _digests(root)
    add_tiny(root)
    # and a per-layer metric of its own, as one more file
    (root / "annbench" / "metrics" / "calls_traced.py").write_text("def read(ctx):\n    return ctx.traced_calls\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "lower", "source": "host_clock",
                               "layer": "engine", "moves": "qps", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())  # no file of the copy changed

    result, lines = run_cell(cell, SEED, 0.3, False, root=root, device="cpu", log=_quiet)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 64
    assert set(result["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    assert list(result)[-1] == "checks" and len(lines) == 3
    traced, _ = run_cell(cell, SEED, 0.3, True, root=root, device="cpu", log=_quiet)
    assert traced["metrics"]["calls_traced"]["value"] == 2
    assert traced["correct"] and "busy_s" in traced["device"] and "breakdown" in traced


def _fault(monkeypatch, kind):
    """Break the engines' query path underneath the harness."""
    from expann_tpu_torch.models.antitopo import AntitopoEngine
    from expann_tpu_torch.models.brute_force import BruteForceEngine

    for cls in (AntitopoEngine, BruteForceEngine):
        orig = cls.query_k_batch

        def broken(self, queries, k, _orig=orig):
            ids = _orig(self, queries, k)
            if kind == "half_left_out":  # only the first half answered, its answers reused for the rest
                half = max(1, ids.shape[0] // 2)
                ids = np.concatenate([ids[:half], ids[:half]])[: ids.shape[0]]
            elif kind == "answer_altered":  # the nearest id of each list replaced where it is produced
                ids = ids.copy()
                ids[:, 0] = (ids[:, 0] + 1) % self.n
            return ids

        monkeypatch.setattr(cls, "query_k_batch", broken)


@pytest.mark.parametrize("cell", ["tiny-graph", "tiny-flat"])
@pytest.mark.parametrize("kind", ["half_left_out", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, kind):
    _fault(monkeypatch, kind)
    result, _ = run_cell(cell, SEED, 0.3, False, root=tiny_root, device="cpu", log=_quiet)
    assert result["correct"] is False


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden(["expann_tpu_torch", "expann_tpu_torch.models.search", "jaxtyping", "numpy"]) == []
    assert guard.forbidden(["expann_tpu.models", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "expann_tpu", "flax", "jax", "jaxlib"]


def test_the_yardstick_imports_nothing_of_the_program():
    for name in ("reference.py", "check.py", "data.py", "peaks.py", "devtrace.py", "guard.py", "manifest.py"):
        assert not _imports(REPO / "annbench" / name) & {"expann_tpu_torch", "expann_tpu", "jax", "jaxlib"}, name


def test_a_run_loads_no_jax(tiny_root):
    """A whole run in a fresh process leaves no JAX module and no module of
    the JAX package loaded; the plain reference alone loads nothing of the
    program."""
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from annbench import reference, check, data, guard\n"
        "assert 'expann_tpu_torch' not in sys.modules\n"
        "from annbench.harness import run_cell\n"
        "res, _ = run_cell('tiny-graph', 5, 0.2, True, root=__import__('pathlib').Path(sys.argv[1]), device='cpu',"
        " log=lambda s: None)\n"
        "assert 'expann_tpu_torch' in sys.modules and res['correct']\n"
        "print(guard.forbidden())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(tiny_root), str(REPO)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_the_program_a_run_prints_no_result(tmp_path):
    """In a directory that holds only the benchmark, a run fails and prints
    no result line."""
    from conftest import copy_benchmark  # noqa: E402

    root = copy_benchmark(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "annbench/run.py", "--workload", "c56k-graph-batch", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0 and '"correct"' not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["c56k-graph-batch", "s1m-graph-s8-batch", "c56k-graph-single", "s1m-flat-batch"])
def test_cell_runs_on_the_card(cuda_card, cell):
    """A whole run at the benchmark's window: the limits hold for the lists a
    full window returns (a 2 s window of the single cell judges ~40 lists,
    too few for its recall limit)."""
    seconds = json.loads((REPO / "BENCHMARK.json").read_text())["run_seconds"]
    out = subprocess.run([sys.executable, "annbench/run.py", "--workload", cell, "--seed", str(SEED), "--seconds",
                          str(seconds), "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-1000:]
    assert result["device"]["platform"] == "gpu"
