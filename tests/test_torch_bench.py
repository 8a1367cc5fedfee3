"""The benchmark layer of the port (expann_tpu_torch.bench, .cli,
.utils.config, .pyplotter, .tools.cpu_baseline) against the JAX package's
on the same numpy inputs, on the CPU at small sizes; and the port's own
repairs: a reused build served through views of its own, and the
duplicate check on every job."""

import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import expann_tpu.bench.runner as j_runner
from expann_tpu.bench.bench_data import BenchData as JBenchData
from expann_tpu.bench.harness import get_benchmark_data as j_get_benchmark_data
from expann_tpu.bench.manager import BenchDataManager as JBenchDataManager
from expann_tpu.cli import main as j_cli_main
from expann_tpu.data.dataset import TestDataset as JTestDataset
from expann_tpu.models.antitopo import AntitopoConfig as JAntitopoConfig
from expann_tpu.models.brute_force import BruteForceEngine as JBruteForceEngine
from expann_tpu.pyplotter import prepare_data as j_prepare_data
from expann_tpu.utils import config as j_config

import expann_tpu_torch.bench.runner as runner
from expann_tpu_torch import cli
from expann_tpu_torch.bench import canonical
from expann_tpu_torch.bench.bench_data import BenchData
from expann_tpu_torch.bench.harness import get_benchmark_data
from expann_tpu_torch.bench.manager import BenchDataManager
from expann_tpu_torch.data.dataset import TestDataset
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.models.brute_force import BruteForceEngine
from expann_tpu_torch.pyplotter import prepare_data
from expann_tpu_torch.tools import cpu_baseline
from expann_tpu_torch.utils import config

ROOT = Path(__file__).resolve().parents[1]

RECORDS = [
    dict(time_per_query_ns=1e6, time_to_build_ns=2e9, average_distance=1.0, average_squared_distance=1.0,
         recall=0.9, engine_name="Anti-Topo Engine+", param_list={"M": "60", "ef_search_mult": "3"}),
    dict(time_per_query_ns=5e5, time_to_build_ns=1e9, average_distance=1.1, average_squared_distance=1.2,
         recall=0.95, engine_name="Anti-Topo Engine+", param_list={"M": "60", "ef_search_mult": "6"}),
    dict(time_per_query_ns=2.5e4, time_to_build_ns=3e8, average_distance=0.9, average_squared_distance=0.81,
         recall=1.0, engine_name="Brute-Force Engine", param_list={}),
]


def _clustered(n, m, d, k, seed=7):
    """Easy-ANN clustered data and its exact ground truth (ties by id)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, d)).astype(np.float32)
    base = (centers[rng.integers(0, 40, n)] + 0.15 * rng.standard_normal((n, d))).astype(np.float32)
    queries = (centers[rng.integers(0, 40, m)] + 0.15 * rng.standard_normal((m, d))).astype(np.float32)
    d2 = ((queries[:, None, :].astype(np.float64) - base[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return base, queries, gt


def test_bench_data_matches_jax():
    for rec in RECORDS:
        bd, jbd = BenchData(**rec), JBenchData(**rec)
        assert bd.to_dict() == jbd.to_dict()
        assert bd.to_string() == jbd.to_string()
        assert BenchData.from_dict(json.loads(bd.to_string())) == bd
        assert bd.qps == jbd.qps


def test_manager_files_identical_to_jax(tmp_path):
    """The same records give byte-identical all.json and latest.json (two
    saves: all.json appends, latest.json is overwritten)."""
    for cls, BD, sub in ((BenchDataManager, BenchData, "port"), (JBenchDataManager, JBenchData, "jax")):
        bdm = cls("ds")
        for rec in RECORDS:
            bdm.add(BD(**rec))
        bdm.add("an error string is printed, not saved")
        bdm.save(str(tmp_path / sub) + "/")
        bdm.save(str(tmp_path / sub) + "/")
    for name in ("all.json", "latest.json"):
        port = (tmp_path / "port" / "data" / name).read_bytes()
        assert port == (tmp_path / "jax" / "data" / name).read_bytes()
    assert len(json.loads((tmp_path / "port" / "data" / "all.json").read_text())) == 2 * len(RECORDS)
    assert [r.to_dict() for r in BenchDataManager("ds").get_all(str(tmp_path / "port") + "/")] == 2 * RECORDS


@pytest.mark.parametrize(
    "argv, cfg, kwargs, want",
    [
        (["--n", "5"], {"n": 7}, {}, 5),  # a flag beats the config file
        ([], {"n": 7}, {}, 7),
        ([], {}, dict(interactive=False, default=3), 3),
        ([], {}, dict(interactive=False), KeyError),
        (["--n"], {"n": 7}, {}, 7),  # a flag without a value is no flag
        ([], {}, {}, 11),  # the prompt
    ],
)
def test_get_parameter_matches_jax(monkeypatch, argv, cfg, kwargs, want):
    monkeypatch.setattr("builtins.input", lambda: "11")
    for mod in (config, j_config):
        if want is KeyError:
            with pytest.raises(KeyError):
                mod.get_parameter(argv, cfg, "n", "Enter n: ", int, **kwargs)
        else:
            assert mod.get_parameter(argv, cfg, "n", "Enter n: ", int, **kwargs) == want


def test_load_config_file_matches_jax(tmp_path):
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"dataset": "Synthetic", "n": 56000}))
    for argv in (["--config", str(path)], ["--config", str(tmp_path / "missing.json")]):
        assert config.load_config_file(argv) == j_config.load_config_file(argv)
    (tmp_path / "bad.json").write_text("{not json")
    assert config.load_config_file(["--config", str(tmp_path / "bad.json")]) == {}


def test_harness_brute_force_matches_jax():
    """Exact brute force in both packages: recall 1.0, the same top-1
    distances, and both clocks running."""
    base, queries, gt = _clustered(500, 30, 16, 10, seed=3)
    bd = get_benchmark_data(BruteForceEngine(mode="exact", device="cpu"),
                            TestDataset(name="t", vecs=base, queries=queries, ground_truth=gt))
    jbd = j_get_benchmark_data(JBruteForceEngine(), JTestDataset(name="t", vecs=base, queries=queries, ground_truth=gt))
    assert bd.recall == jbd.recall == 1.0
    assert abs(bd.average_distance - jbd.average_distance) <= 1e-6
    assert abs(bd.average_squared_distance - jbd.average_squared_distance) <= 1e-6
    assert bd.engine_name == jbd.engine_name and bd.param_list == jbd.param_list
    assert bd.time_to_build_ns > 0 and bd.time_per_query_ns > 0


@pytest.mark.parametrize(
    "x, y, px, py",
    [("recall", "time_per_query_ns", False, False), ("time_to_build_ns", "average_distance", False, False),
     ("ef_search_mult", "recall", True, False), ("recall", "M", False, True)],
)
def test_prepare_data_matches_jax(x, y, px, py):
    assert prepare_data(RECORDS, x, y, px, py) == j_prepare_data(RECORDS, x, y, px, py)


def _write_vecs(path, mat, as_int=False):
    with open(path, "wb") as f:
        for row in mat:
            np.int32(mat.shape[1]).tofile(f)
            (row.astype(np.int32) if as_int else row.astype(np.float32)).tofile(f)


def _tiny_grid(cfg_cls, index_dir="index"):
    """test_bench.py's two-job grid: one build key, uncompressed then
    compressed."""
    return [
        cfg_cls(M=6, M0=12, ef_search_mult=3, ef_construction=24, prune_cand=24, use_compression=c,
                index_filename=f"{index_dir}/sift_tiny", read_index=True, write_index=True)
        for c in (False, True)
    ]


def test_cli_serves_the_jax_built_index(tmp_path, monkeypatch):
    """The JAX CLI builds and serves the tiny SIFT files; the port's CLI, run
    next in the same directory, reads the index the JAX one wrote (the
    shared npz) and serves it: the same records, recall within 0.01."""
    base, queries, gt = _clustered(400, 20, 16, 10)
    sift = tmp_path / "datasets" / "sift"
    sift.mkdir(parents=True)
    _write_vecs(str(sift / "sift_base.fvecs"), base)
    _write_vecs(str(sift / "sift_query.fvecs"), queries)
    _write_vecs(str(sift / "sift_groundtruth.ivecs"), gt, as_int=True)
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "Sift1M", "--k", "10", "--ds_name", "sift_tiny"]
    latest = tmp_path / "data" / "sift_tiny" / "data" / "latest.json"

    monkeypatch.setattr(j_runner, "canonical_job_grid", lambda index_dir="index": _tiny_grid(JAntitopoConfig, index_dir))
    assert j_cli_main(argv) == 0
    jax_recs = json.loads(latest.read_text())
    index_bytes = (tmp_path / "index" / "sift_tiny").read_bytes()

    monkeypatch.setattr(runner, "canonical_job_grid", lambda index_dir="index": _tiny_grid(AntitopoConfig, index_dir))
    assert cli.main(argv, device="cpu") == 0
    recs = json.loads(latest.read_text())
    assert (tmp_path / "index" / "sift_tiny").read_bytes() == index_bytes  # read, not rebuilt
    assert len(json.loads((tmp_path / "data" / "sift_tiny" / "data" / "all.json").read_text())) == 4
    assert len(recs) == len(jax_recs) == 2
    for r, jr in zip(recs, jax_recs):
        assert r["engine_name"] == jr["engine_name"] == "Anti-Topo Engine+"
        assert r["param_list"] == jr["param_list"]
        assert abs(r["recall"] - jr["recall"]) <= 0.01, (r, jr)
        assert r["recall"] > 0.4


def _grid_on_one_build(tmp_path, flags, mults=None, **kw):
    mults = mults or [3] * len(flags)
    return [
        AntitopoConfig(M=6, M0=12, ef_search_mult=m, ef_construction=24, prune_cand=24, use_compression=c,
                       index_filename=str(tmp_path / "index" / "g"), read_index=True, write_index=True, **kw)
        for c, m in zip(flags, mults)
    ]


def _dataset(n=300, m=20, d=16, k=10):
    base, queries, gt = _clustered(n, m, d, k, seed=5)
    return TestDataset(name="tiny", vecs=base, queries=queries, ground_truth=gt)


def test_runner_reused_build_keeps_each_layout(tmp_path, monkeypatch):
    """Uncompressed, compressed, uncompressed on one build key, packed and
    fused on the CPU: the compressed job's s8 blocks stay in a view of its
    own, so the third job serves bf16 blocks and answers as the first."""
    served = []

    class Recording(AntitopoEngine):
        def query_k_batch(self, queries, k):
            ids = super().query_k_batch(queries, k)
            served.append((self.cfg.use_compression, self.graph.layout.packed.dtype, ids))
            return ids

    monkeypatch.setattr(runner, "AntitopoEngine", Recording)
    jobs = _grid_on_one_build(tmp_path, [False, True, False], use_packed=True, use_fused=True)
    bdm = runner.perform_benchmarks(_dataset(), jobs=jobs, verbose=False, device="cpu")
    assert len(bdm.latest) == 3
    assert [(c, dt) for c, dt, _ in served] == [(False, torch.bfloat16)] * 2 + [(True, torch.int8)] * 2 + [
        (False, torch.bfloat16)] * 2
    np.testing.assert_array_equal(served[5][2], served[1][2])
    assert bdm.latest[2].recall == bdm.latest[0].recall
    assert bdm.latest[2].average_distance == bdm.latest[0].average_distance


@pytest.mark.parametrize("path", ["first", "reused"])
def test_runner_duplicates_fail_the_job(tmp_path, monkeypatch, capsys, path):
    """A job whose answers repeat an id becomes an error record, on the
    path that builds and on the path that reuses a build alike."""
    bad_mult = 1 if path == "first" else 2

    class Duplicating(AntitopoEngine):
        def query_k_batch(self, queries, k):
            ids = super().query_k_batch(queries, k)
            if self.cfg.ef_search_mult == bad_mult:
                ids[:, 1] = ids[:, 0]
            return ids

    monkeypatch.setattr(runner, "AntitopoEngine", Duplicating)
    jobs = _grid_on_one_build(tmp_path, [False, False], mults=[1, 2])
    bdm = runner.perform_benchmarks(_dataset(), jobs=jobs, verbose=False, device="cpu")
    failed = 0 if path == "first" else 1
    assert len(bdm.latest) == 1 and bdm.latest[0].param_list["ef_search_mult"] == str(3 - bad_mult)
    assert f"job {failed} failed: AssertionError('Duplicates detected, engine is buggy.')" in capsys.readouterr().out


def bench_py_keys() -> tuple:
    """The keys of bench.py's ``out`` dict and of its pareto entries, read
    from its source (bench.py imports JAX; it is not run)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    out = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "out" for t in n.targets))
    keys = [k.value for k in out.keys]
    return keys, [k.value for k in out.values[keys.index("pareto")].elt.keys]


def test_canonical_run_small(tmp_path):
    out = canonical.run(600, 40, 32, 10, qps_queries=256, reps=2, device="cpu", cache_dir=str(tmp_path))
    keys, pareto_keys = bench_py_keys()  # read from bench.py's source: it imports JAX, it is not run
    assert list(out) == keys
    assert all(list(p) == pareto_keys for p in out["pareto"])
    assert [p["engine"] for p in out["pareto"]] == [
        "gpu_flat", "gpu_flat_i8", "antitopo_ef40", "antitopo_ef60", "antitopo_ef100", "antitopo_ef120",
        "antitopo_compressed_ef100", "antitopo_compressed_ef110", "antitopo_compressed_ef120",
        "antitopo_wire_i8_ef110", "antitopo_wire_i8_ef120"]
    ok = [p for p in out["pareto"] if p["recall"] >= canonical.RECALL_TARGET]
    best = max(ok, key=lambda p: p["qps"]) if ok else max(out["pareto"], key=lambda p: p["recall"])
    assert out["value"] == best["qps"] and out["best_engine"] == best["engine"]
    # off the card no device QPS is reported; no TPU-host constant is divided by
    assert out["flat_device_qps"] is out["graph_device_qps"] is out["graph_device_qps_i8"] is None
    assert out["vs_baseline_est10k"] == round(out["value"] / 1e4, 3)
    # the CPU baseline, where there is one, was measured at the canonical config, not this one
    assert out["vs_baseline"] is None and out["vs_baseline_build"] is None
    assert out["pareto"][0]["recall"] >= 0.99 and out["pareto"][5]["recall"] >= 0.95


BASELINE = {"config": {"n": 56000, "m": 400, "d": 128, "k": 10}, "host_cpu": "a CPU",
            "denominator": {"ef": 100, "recall": 0.952, "qps": 800.0}, "build_s": 600.0}


@pytest.mark.parametrize(
    "base, cfg, want",
    [
        (None, BASELINE["config"], (None, None, "is missing")),
        (BASELINE, {"n": 600, "m": 40, "d": 32, "k": 10}, (None, None, "measured at")),
        (BASELINE, BASELINE["config"], (800.0, 600.0, "600.0 s")),
        (dict(BASELINE, build_s=None, build_note="did not finish"), BASELINE["config"], (800.0, None, "did not finish")),
    ],
)
def test_canonical_denominators(base, cfg, want):
    qps, build_s, note = canonical._denominators(base, cfg)
    assert (qps, build_s) == want[:2] and want[2] in note


def test_cpu_baseline_denominator_rule():
    """The lowest ef whose recall@10 is at least 0.95 (bench.py's rule),
    from the lines baseline_search prints."""
    text = "\n".join(json.dumps({"ef": ef, "recall": r, "qps": q}) for ef, r, q in
                     ((20, 0.63, 1900.0), (110, 0.9603, 550.0), (100, 0.952, 600.0), (250, 0.9952, 263.0)))
    sweep = cpu_baseline.json_lines("n=56000 d=128\n" + text)
    assert len(sweep) == 4
    assert cpu_baseline.denominator(sweep) == {"ef": 100, "recall": 0.952, "qps": 600.0}
    assert cpu_baseline.denominator(sweep, target=0.999) is None


def test_cpu_baseline_median_of_rotated_sweeps():
    """Each sweep runs every ef once, in its own order; an ef's QPS is its
    median over the sweeps, and a median that rises with ef is flagged."""
    efs = (20, 100, 110, 120)
    orders = [cpu_baseline.sweep_order(efs, s) for s in range(5)]
    assert orders[1] == [100, 110, 120, 20] and orders[4] == orders[0] == list(efs)
    qps = {20: [1800.0, 1100.0, 1750.0], 100: [250.0, 280.0, 270.0], 110: [320.0, 240.0, 260.0],
           120: [215.0, 230.0, 225.0]}
    runs = [[{"ef": ef, "recall": ef / 1000.0, "qps": qps[ef][s], "distcomps_per_query": 10.0 * ef}
             for ef in cpu_baseline.sweep_order(efs, s)] for s in range(3)]
    sweep = cpu_baseline.median_sweep(runs)
    assert [p["ef"] for p in sweep] == list(efs)
    assert [p["qps"] for p in sweep] == [1750.0, 270.0, 260.0, 225.0]
    assert sweep[1]["qps_sweeps"] == qps[100] and sweep[1]["us_per_query"] == round(1e6 / 270.0, 2)
    assert cpu_baseline.rising(sweep) == []
    assert cpu_baseline.rising([{"ef": 100, "qps": 254.0}, {"ef": 110, "qps": 318.0}, {"ef": 120, "qps": 214.0}]) == [110]
    runs[2][0]["recall"] = 0.5  # a pass that found other neighbours: not the same search
    with pytest.raises(ValueError):
        cpu_baseline.median_sweep(runs)


def test_committed_cpu_baseline_is_the_canonical_config():
    base = canonical.load_cpu_baseline()
    if base is None:
        pytest.fail("expann_tpu_torch/bench/cpu_baseline.json is missing")
    assert base["config"] == dict(zip("nmdk", canonical.CANONICAL))
    assert base["denominator"] == cpu_baseline.denominator(base["sweep"])
    # each ef's QPS is the median of the rotated sweeps, and a rise with ef is on record
    assert all(len(p["qps_sweeps"]) == cpu_baseline.SWEEPS for p in base["sweep"])
    assert base["sweep"] == cpu_baseline.median_sweep([[dict(p, qps=p["qps_sweeps"][s]) for p in base["sweep"]]
                                                       for s in range(cpu_baseline.SWEEPS)])
    assert base["qps_rises_with_ef_at"] == cpu_baseline.rising(base["sweep"])
    assert "H100" in base["card"] and base["host_cpu"]


@pytest.mark.parametrize("entry", ["cli", "canonical_run", "canonical_main"])
def test_entry_points_need_a_card_by_default(tmp_path, monkeypatch, entry):
    """Without a card the entry points fail; none carries on on the CPU."""
    monkeypatch.chdir(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    if entry == "canonical_main":
        with pytest.raises(SystemExit):
            canonical.main()
        return
    with pytest.raises((AssertionError, RuntimeError)):
        if entry == "cli":
            cli.main(["--dataset", "Synthetic", "--n", "50", "--m", "5", "--d", "8", "--k", "3"])
        else:
            canonical.run(50, 5, 8, 3, qps_queries=8, reps=1, cache_dir=str(tmp_path))
    assert not os.path.exists(tmp_path / "data" / "Synthetic")
