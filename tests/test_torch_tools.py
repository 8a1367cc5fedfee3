"""The port's tools (expann_tpu_torch/tools/) against the JAX package's
tools (tools/*.py, loaded from their files) on the same numpy inputs, and
each tool's ``main`` driven to its last line on the CPU at a tiny size."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.tools import (
    bench_bigflat,
    make_sift_like,
    perf_ab_serving,
    perf_e2e_graph,
    perf_latency,
    perf_oppoint,
    persist_1m_artifacts,
    probe_flat_overhead,
    probe_wave_cost,
    profile_build,
)
from expann_tpu_torch.utils.persist import save_index

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TINY = 600  # rows of the canonical-shaped corpus the graph tools serve here


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_to_u8_box_matches_jax_tool():
    jt = _jax_tool("make_sift_like")
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3000, 128)) * 2 + 0.3).astype(np.float32)
    q = rng.standard_normal((40, 128)).astype(np.float32) * 3
    ours, b = make_sift_like.to_u8_box(x)
    theirs, jb = jt.to_u8_box(x)
    assert b == jb and ours.tobytes() == theirs.tobytes()
    assert make_sift_like.to_u8_box(q, bounds=b)[0].tobytes() == jt.to_u8_box(q, bounds=jb)[0].tobytes()
    assert ours.min() >= 0 and ours.max() <= 255 and (ours == np.rint(ours)).all()


def test_exact_gt_matches_jax_tool_except_ties():
    """On u8-valued data every distance is an exact integer, so ties are
    common: where the ids differ, the distances must be equal."""
    jt = _jax_tool("make_sift_like")
    from expann_tpu_torch.data.loader import generate_synthetic_clustered

    x, q = generate_synthetic_clustered(3000, 600, 128, seed=7)
    x, b = make_sift_like.to_u8_box(x)
    q, _ = make_sift_like.to_u8_box(q, bounds=b)
    k = 100
    ours = make_sift_like.exact_gt(x, q, k, device="cpu")
    theirs = np.asarray(jt.exact_gt(x, q, k))
    assert ours.shape == theirs.shape == (600, k)
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    d_ours = ((q64[:, None, :] - x64[ours]) ** 2).sum(-1)
    d_theirs = ((q64[:, None, :] - x64[theirs]) ** 2).sum(-1)
    np.testing.assert_array_equal(d_ours, d_theirs)
    assert (np.diff(d_ours, axis=1) >= 0).all()
    assert (ours == theirs).mean() > 0.99


def test_bigflat_corpus_and_ground_truth_match_jax_tool(tmp_path):
    jt = _jax_tool("bench_bigflat")
    x = bench_bigflat.gen_corpus(5000, 128)
    np.testing.assert_array_equal(x, jt.gen_corpus(5000, 128))
    q = np.random.default_rng(1).standard_normal((30, 128)).astype(np.float32)
    ours = bench_bigflat.host_gt(x, q, 10, str(tmp_path / "gt.npz"))
    np.testing.assert_array_equal(ours, jt.host_gt(x, q, 10, str(tmp_path / "jax_gt.npz")))
    np.testing.assert_array_equal(bench_bigflat.host_gt(x, q, 10, str(tmp_path / "gt.npz")), ours)  # cached


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A canonical-shaped corpus of N_TINY rows in a scratch cache (the
    tools' ``canonical_data``), and a small graph over it written where the
    graph tools read their index."""
    root = tmp_path_factory.mktemp("tools")
    saved = perf_e2e_graph.DATA
    perf_e2e_graph.DATA = str(root / "data")
    ds = perf_e2e_graph.canonical_data(N_TINY, "cpu")
    eng = AntitopoEngine(config=AntitopoConfig(M=8, ef_construction=40, prune_overflow=1), device="cpu")
    eng.store_many_vectors(ds.vecs)
    eng.build()
    idx = str(root / "idx.npz")
    save_index(idx, eng.graph, {"dim": 128})
    log = root / "bench_1m.log"
    log.write_text(json.dumps({"summary_1m": [
        {"point": "build", "build_s": 1.5, "n": 1000, "M": 8, "efc": 40, "waves": 1, "candidates": "flat",
         "card": "cpu"},
        {"point": "antitopo_ef40_e2_c16_i8", "recall": 0.9, "qps": 1000.0, "distcomps": 120.5, "card": "cpu"},
        {"point": "gpu_flat_fused", "recall": 0.99, "qps": 500.0, "build_s": 0.1, "card": "cpu"},
        {"point": "gpu_flat_fused_i8", "recall": 0.98, "qps": None, "build_s": 0.1, "card": "cpu"},
    ]}) + "\n")
    yield root, idx
    perf_e2e_graph.DATA = saved


def _tools(root, idx):
    n = str(N_TINY)
    return {
        "make_sift_like": (make_sift_like, ["--n", "2000", "--m", "20", "--out", str(root / "sift")]),
        "bench_bigflat": (bench_bigflat, ["--n", "3000", "--m", "20", "--Q", "128", "--reps", "2", "--cache", ""]),
        "bench_bigflat_i8": (bench_bigflat, ["--n", "3000", "--m", "20", "--Q", "128", "--reps", "2", "--cache", "",
                                             "--mode", "fused_i8"]),
        "perf_latency_flat": (perf_latency, ["--engine", "flat", "--n", n, "--B", "8,64", "--window", "0.001"]),
        "perf_latency_flat_i8": (perf_latency, ["--engine", "flat_i8", "--n", n, "--B", "8", "--window", "0.001"]),
        "perf_latency_graph": (perf_latency, ["--engine", "graph", "--n", n, "--B", "4", "--index", idx,
                                              "--window", "0.001"]),
        "probe_wave_cost": (probe_wave_cost, ["--n", "3000", "--C", "40", "--cap", "16", "--W", "256", "--reps", "2"]),
        "profile_build": (profile_build, ["--n", "300", "--reps", "1"]),
        "perf_oppoint": (perf_oppoint, ["--grid", "2x8,1x16", "--efs", "20,40", "--B", "8", "--n", n, "--index", idx,
                                        "--window", "0.001"]),
        "perf_e2e_graph": (perf_e2e_graph, ["--n", n, "--Q", "64", "--reps", "2", "--index", idx, "--ef", "40"]),
        "perf_ab_serving": (perf_ab_serving, ["--n", n, "--Q", "64", "--reps", "2", "--index", idx, "--ef", "40"]),
        "perf_ab_serving_qt": (perf_ab_serving, ["--sweep", "qt", "--n", n, "--Q", "64", "--reps", "2",
                                                 "--index", idx, "--ef", "40"]),
        "probe_flat_overhead": (probe_flat_overhead, ["--n", "2000", "--B", "256"]),
    }


TOOL_CASES = ["make_sift_like", "bench_bigflat", "bench_bigflat_i8", "perf_latency_flat", "perf_latency_flat_i8",
              "perf_latency_graph", "probe_wave_cost", "profile_build", "perf_oppoint", "perf_e2e_graph",
              "perf_ab_serving", "perf_ab_serving_qt", "probe_flat_overhead"]


@pytest.mark.parametrize("case", TOOL_CASES)
def test_tool_main_runs_on_cpu(tiny, case, capsys):
    root, idx = tiny
    mod, argv = _tools(root, idx)[case]
    out = mod.main(argv, device="cpu")
    assert out
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines, case
    if case not in ("make_sift_like", "perf_e2e_graph"):
        last = json.loads(lines[-1])
        assert "cpu" in json.dumps(last)


def test_tool_results_on_cpu(tiny, capsys):
    """What the tiny runs compute: the SIFT-like files read back through
    the native reader, bigflat's recall and result ids, the wave split's
    parts, profile_build's steps equal to the engine's build."""
    from expann_tpu_torch.data.loader import load_sift1m
    from expann_tpu_torch.utils import io_native

    root, idx = tiny
    out = str(root / "sift2")
    make_sift_like.main(["--n", "1500", "--m", "30", "--k", "20", "--out", out], device="cpu")
    before = io_native.reads
    ds = load_sift1m(*(os.path.join(out, f) for f in ("sift_base.fvecs", "sift_query.fvecs",
                                                      "sift_groundtruth.ivecs")), k_custom=20)
    assert io_native.reads == before + 3
    assert ds.vecs.shape == (1500, 128) and ds.queries.shape == (30, 128) and ds.ground_truth.shape == (30, 20)
    assert ds.vecs.min() >= 0 and ds.vecs.max() <= 255
    np.testing.assert_array_equal(ds.ground_truth, make_sift_like.exact_gt(ds.vecs, ds.queries, 20, "cpu"))

    res = bench_bigflat.main(["--n", "4000", "--m", "25", "--Q", "64", "--reps", "1", "--cache", ""], device="cpu")
    assert res["recall"] >= 0.99 and res["ids_ge_2_24"] == 0 and res["card"] == "cpu"
    wave = probe_wave_cost.main(["--n", "3000", "--C", "40", "--cap", "16", "--W", "256", "--reps", "1"],
                                device="cpu")
    assert set(wave["forward_split_ms"]) == {"candidates", "gathers", "co_distances", "lockstep", "row_writes"}
    assert wave["waves"] == 12
    prof = profile_build.main(["--n", "300", "--reps", "1"], device="cpu")
    assert prof["rows_equal_engine_build"] == "300/300"
    capsys.readouterr()


def test_perf_beam_block_runs_on_cpu(capsys):
    """The block sweep's eager arms on the CPU, where nothing is captured:
    every list equal to itself, no capture timed, one JSON line naming the
    CPU."""
    from expann_tpu_torch.tools import perf_beam_block

    out = perf_beam_block.main(["--device", "cpu", "--n", "800", "--rounds", "2", "--queries", "3", "--mixed", "3"])
    assert out["card"] == "cpu" and set(out["arms"]) == {"eager"} and out["capture_ms"] == {}
    eager = out["arms"]["eager"]
    assert eager["identical_to_eager"] and eager["median_ms"] > 0 and eager["iterations"] > 1
    mixed = out["mixed"]
    assert mixed["identical_to_eager"] and mixed["calls"] == 3 and mixed["eager"]["captures"] == [0, 0]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["arms"]["eager"] == eager


def test_persist_1m_artifacts(tiny):
    root, _ = tiny
    png = persist_1m_artifacts.main(["--log", str(root / "bench_1m.log"), "--dataset", "ds", "--root",
                                     str(root / "data_out")])
    assert os.path.getsize(png) > 0
    with open(root / "data_out" / "ds" / "data" / "latest.json") as f:
        recs = json.load(f)
    assert [r["engine_name"] for r in recs] == ["Anti-Topo Engine+", "GPU-Flat"]  # the point with no QPS is left out
    assert recs[0]["param_list"]["ef_search"] == "40" and recs[0]["param_list"]["card"] == "cpu"
    assert recs[0]["time_to_build_ns"] == 1.5e9 and recs[1]["time_per_query_ns"] == 1e9 / 500.0
