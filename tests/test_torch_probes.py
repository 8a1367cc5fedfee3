"""The port's probe tools (expann_tpu_torch/tools/) against the repo's TPU
probes (tools/), and the port's profiling hooks.

The same numpy inputs from a seed go through the tools' own Pallas kernels,
run in TPU interpret mode, and the port's plain versions, at cut sizes
(module constants the kernels read at trace time are patched).  Where a
tool only prints (P1's ``main``, P4's ``run``), the test makes the
``pallas_call`` with the tool's kernel body and block specs
(tools/probe_fused.py:60-79, tools/probe_lanes.py:134-140).  ``tools/``
has no ``__init__.py``, so the tools are imported by path."""

import gzip
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from expann_tpu_torch.ops.fused import fused_search
from expann_tpu_torch.tools import (
    perf_flat_mode, perf_packed_score, perf_pallas_gather, perf_trace, probe_fused, probe_lanes, probe_step_overhead,
)
from expann_tpu_torch.utils import profiling

torch.set_num_threads(2)

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"tpu_tool_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def test_probe_fused_matches_tpu_kernel(interpret):
    """P1: the copied table entry and the loop count, identical."""
    tool = _tool("probe_fused")
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        tab = rng.standard_normal((64, 8, 128)).astype(np.float32)
        x = rng.standard_normal((8, 128)).astype(np.float32)
        x[0, :8] += seed * 3.5  # loop counts of ~100, ~104 and ~107
        out, wout = pl.pallas_call(
            tool.probe_kernel,
            grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec((8, 128), lambda i: (0, 0))],
            out_specs=[pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec((8, 128), lambda i: (0, 0))],
            out_shape=[jax.ShapeDtypeStruct((8, 128), jnp.float32), jax.ShapeDtypeStruct((8, 128), jnp.float32)],
            scratch_shapes=[pltpu.VMEM((8, 128), jnp.int32), pltpu.SemaphoreType.DMA(())],
        )(jnp.asarray(tab), jnp.asarray(x))
        o, w = probe_fused.probe_fused(torch.from_numpy(tab), torch.from_numpy(x))
        np.testing.assert_array_equal(o.numpy(), np.asarray(out))
        np.testing.assert_array_equal(w.numpy(), np.asarray(wout))


@pytest.mark.parametrize("kind,seed", [("tie", 8), ("lane127", 9)])
def test_probe_fused_cases_match_tpu_kernel(interpret, kind, seed):
    """P1's tied and column-127 minima (``probe_fused.case_inputs``, on the
    TPU kernel's 64-entry table and uncapped loop): identical arrays."""
    tool = _tool("probe_fused")
    tab, x, _, entry = probe_fused.case_inputs("cpu", kind, seed)
    out, wout = pl.pallas_call(
        tool.probe_kernel,
        grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec((8, 128), lambda i: (0, 0))],
        out_specs=[pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec((8, 128), lambda i: (0, 0))],
        out_shape=[jax.ShapeDtypeStruct((8, 128), jnp.float32), jax.ShapeDtypeStruct((8, 128), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((8, 128), jnp.int32), pltpu.SemaphoreType.DMA(())],
    )(jnp.asarray(tab.numpy()), jnp.asarray(x.numpy()))
    o, w = probe_fused.probe_fused(tab, x)
    np.testing.assert_array_equal(o.numpy(), np.asarray(out))
    np.testing.assert_array_equal(w.numpy(), np.asarray(wout))
    np.testing.assert_array_equal(o.numpy(), tab[entry].numpy())


def test_probe_fused_main_on_cpu(capsys):
    res = probe_fused.main("cpu")
    assert res["ok_dma"] and res["ok_while"] and 90 <= res["iters"] <= 110
    out = capsys.readouterr().out
    assert "dma-by-in-kernel-scalar: OK" in out and "while-loop: OK" in out


@pytest.mark.parametrize("nbuf", [2, 4])
@pytest.mark.parametrize("R", [16, 32])
def test_block_gather_matches_tpu_kernel(interpret, R, nbuf):
    """P2: the TPU function's (1, R) row against the port's, and every step's
    row against a float64 numpy product; |d| <= 1e-4 (1 + |ref|): bf16
    inputs, f32 sums of 128 products in another order."""
    tool = _tool("perf_pallas_gather")
    G, NB = 32, 64
    rng = np.random.default_rng(R + nbuf)
    packed = rng.standard_normal((NB, R, 128)).astype(np.float32).astype(ml_dtypes.bfloat16)
    ids = rng.integers(0, NB, G).astype(np.int32)
    q = rng.standard_normal((1, 128)).astype(np.float32).astype(ml_dtypes.bfloat16)
    ref = np.asarray(tool.run_block_gather(jnp.asarray(packed), jnp.asarray(ids), jnp.asarray(q), G=G, NBUF=nbuf))
    t = [torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) for a in (packed, q)]
    got = perf_pallas_gather.run_block_gather(t[0], torch.from_numpy(ids), t[1], nbuf)
    assert got.shape == (1, R)
    np.testing.assert_array_less(np.abs(got.numpy() - ref), 1e-4 * (1 + np.abs(ref)))
    every = perf_pallas_gather.block_gather_scores(t[0], torch.from_numpy(ids), t[1], nbuf).numpy()
    exact = np.einsum("grd,d->gr", packed[ids].astype(np.float64), q[0].astype(np.float64))
    np.testing.assert_array_less(np.abs(every - exact), 1e-4 * (1 + np.abs(exact)))


@pytest.fixture(scope="module")
def step_tool():
    tool = _tool("probe_step_overhead")
    tool.B, tool.ITERS, tool.RS = 64, 4, 16
    rng = np.random.default_rng(5)
    q = rng.standard_normal((64, 128)).astype(np.float32)
    bd0 = rng.standard_normal((64, 128)).astype(np.float32)
    packed = rng.standard_normal((4097, 16, 128)).astype(np.float32).astype(ml_dtypes.bfloat16)
    aux = rng.standard_normal((4097, 2, 128)).astype(np.float32)
    return tool, q, bd0, packed, aux


@pytest.mark.parametrize("feat", probe_step_overhead.FEATURES)
def test_step_overhead_matches_tpu_kernel(interpret, step_tool, feat):
    """P3, every feature: rtol = atol = 1e-6 (the same elementwise chain,
    which XLA may contract into an FMA)."""
    tool, q, bd0, packed, aux = step_tool
    ref = np.asarray(tool.make(feat)(jnp.asarray(q), jnp.asarray(bd0), jnp.asarray(packed), jnp.asarray(aux)))
    tp = torch.from_numpy(packed.view(np.int16)).view(torch.bfloat16)
    got = probe_step_overhead.step_overhead(torch.from_numpy(q), torch.from_numpy(bd0), tp, feat, iters=4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    if "dma" in feat:  # the copied row moves the result
        plain = probe_step_overhead.step_overhead(torch.from_numpy(q), torch.from_numpy(bd0), tp, "", iters=4)
        assert not torch.equal(got, plain)


def test_step_overhead_features_and_bytes():
    assert probe_step_overhead.parse_feature("dma,while6") == (True, False, 6)
    assert probe_step_overhead.parse_feature("scratch,while1") == (False, True, 1)
    with pytest.raises(ValueError):
        probe_step_overhead.parse_feature("dma,while7")
    # 24 steps x 32 copies at stride 131 mod 4096: 768 distinct blocks
    extra = probe_step_overhead.step_bytes("dma") - probe_step_overhead.step_bytes("")
    assert extra == 768 * 128 * 128 * 2


def test_step_overhead_grid_clusters_and_l2_bytes():
    """P3's host side: the grid padded to a multiple of the cluster size,
    the cluster sizes offered for a tile count, the ring-only footprint
    (under half of an SM's 228 KB; the card tests hold two tiles an SM by
    CUDA's occupancy calculator), and the L2 bytes a ``dma`` call reads
    (once a cluster, padded clusters included)."""
    ps = probe_step_overhead
    assert ps.grid_blocks(8, 1) == 1 and ps.grid_blocks(8, 16) == 16
    assert [ps.grid_blocks(1000, c) for c in ps.CLUSTER_SWEEP] == [125, 126, 128, 128, 128]
    assert all(ps.grid_blocks(8192, c) == 1024 for c in ps.CLUSTER_SWEEP)
    assert ps.cluster_sizes(1) == (1,) and ps.cluster_sizes(5) == (1, 2, 4)
    assert ps.cluster_sizes(125) == ps.CLUSTER_SWEEP and ps.CLUSTER in ps.CLUSTER_SWEEP
    assert ps.ring_bytes(128) == 128 + ps.NSLOT * 128 * 128 * 2 <= 113 * 1024
    per_tile = 24 * 32 * 128 * 128 * 2  # one tile's copies at ITERS=24
    assert ps.l2_bytes(8192, 24, 1) == 1024 * per_tile  # ~25.8 GB
    assert all(ps.l2_bytes(8192, 24, c) * c == 1024 * per_tile for c in ps.CLUSTER_SWEEP)
    assert ps.l2_bytes(1000, 24, 8) == 16 * per_tile and ps.l2_bytes(8, 24, 16) == per_tile
    assert ps.l2_bytes(8192, 0, 4) == 0


def test_probe_fused_plain_caps_the_loop():
    """P1's plain version counts at most ``max_iters`` steps."""
    tab, x = probe_fused.inputs("cpu")
    full = int(probe_fused.probe_fused_plain(tab, x)[1][0, 0])
    assert 90 <= full <= 110
    for cap in (0, 1, full - 1, full, full + 1):
        o, w = probe_fused.probe_fused(tab, x, cap)
        assert bool((w == min(cap, full)).all()) and torch.equal(o, tab[int(torch.argmin(x[0])) % 64])


@pytest.mark.parametrize("tool", [probe_fused, probe_step_overhead, probe_lanes, perf_pallas_gather])
def test_probe_ab_refuses_without_a_card(monkeypatch, tool):
    """The A/B timing entries measure the card or nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="GPU"):
        tool.ab(["--ab"])


def test_fused_companion_inputs_run_to_the_cap():
    """K1's companion layout at a cut batch through the plain traversal:
    valid ids, norms >= 0, a sentinel block as every packed layout has one
    (+inf norms, sentinel ids), distinct seeds, and the traversal is still
    going at either cap, so the cap sets the iteration count."""
    packed, norms, ids, q, bd0, bi0 = probe_step_overhead.fused_inputs("cpu", b=4)
    n = probe_step_overhead.NODES
    assert packed.shape == (4097, 128, 128) and bool((norms >= 0).all())
    assert int(ids[:n].min()) >= 0 and int(ids[:n].max()) < n
    assert bool(torch.isinf(norms[n]).all()) and bool((ids[n] == n).all())
    assert all(len(set(row.tolist())) == row.numel() for row in bi0)
    for cap in (2, 6):
        iters = fused_search(packed, norms, ids, q, bd0, bi0, ef=120, expand=4, cand=32, max_iters=cap)[3]
        assert bool((iters == cap).all())


def test_fused_agreement_counts_what_differs():
    """The K1 companion's comparison: a result agrees with itself in every
    measure, and one row's swapped-in id and changed iteration count show
    as that row alone."""
    packed, norms, ids, q, bd0, bi0 = probe_step_overhead.fused_inputs("cpu", b=4)
    ref = fused_search(packed, norms, ids, q, bd0, bi0, ef=120, expand=4, cand=32, max_iters=3)
    same = probe_step_overhead.fused_agreement(ref, ref, sentinel=probe_step_overhead.NODES)
    assert same["same_beams"] == same["overlap"] == same["same_iters"] == 1.0
    assert same["dist_err"] == 0.0 and same["dist_max"] > 0 and same["iters_ratio"] == same["ncomp_ratio"] == 1.0
    gi, gd, gn, gt = (t.clone() for t in ref)
    gi[1, 0] = int(gi[1].max()) + 1 if int(gi[1].max()) + 1 < probe_step_overhead.NODES else int(gi[1].min()) - 1
    gd[0] += 1.0
    gt[2] += 3
    agree = probe_step_overhead.fused_agreement((gi, gd, gn, gt), ref, sentinel=probe_step_overhead.NODES)
    assert agree["same_beams"] == 0.75 and agree["same_iters"] == 0.75
    assert agree["overlap"] == pytest.approx(1 - 0.25 / 120)
    assert agree["dist_err"] == pytest.approx(1.0)
    assert agree["iters_ratio"] == pytest.approx(1 + 3 / float(ref[3].sum()))


@pytest.mark.parametrize("mode", probe_lanes.MODES)
def test_lane_ops_match_tpu_kernel(interpret, mode):
    """P4, every mode at W=128: exact for the compare-exchange stages and
    the broadcast, rtol 1e-6 for the reductions and carries, 1e-5 for the
    prefix sum (another summation order)."""
    tool = _tool("probe_lanes")
    tool.ITERS, tool.G = 16, 2
    x = np.random.default_rng(11).standard_normal((16, 128)).astype(np.float32)
    x[:, 3] = x[:, 40]  # ties with lane 3 for bcast
    ref = np.asarray(
        pl.pallas_call(
            tool.make_kernel(mode, 128),
            grid=(2,),
            in_specs=[pl.BlockSpec((8, 128), lambda i: (i, 0))],
            out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((16, 128), jnp.float32),
        )(jnp.asarray(x))
    )
    got = probe_lanes.lane_ops(torch.from_numpy(x), mode, iters=16).numpy()
    if mode in ("stage", "stage64", "bcast"):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5 if mode == "matmul_cumsum" else 1e-6)
    assert not np.array_equal(got, x)


@pytest.mark.parametrize("mode", ["reduce", "reduce3", "carry6"])
def test_lane_ops_edge_rows_match_tpu_kernel(interpret, mode):
    """P4's plain version on the edge rows (ties across and within lanes,
    negative rows, -0 beside +0, +inf, equal values) against the TPU
    kernel, with the tolerance of the test above; every tie survives the
    steps, so the rows stay a test of the reductions to the last step."""
    tool = _tool("probe_lanes")
    tool.ITERS, tool.G = 16, 2
    x = probe_lanes.edge_rows("cpu").numpy()
    ref = np.asarray(
        pl.pallas_call(
            tool.make_kernel(mode, 128),
            grid=(2,),
            in_specs=[pl.BlockSpec((8, 128), lambda i: (i, 0))],
            out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((16, 128), jnp.float32),
        )(jnp.asarray(x))
    )
    got = probe_lanes.lane_ops(torch.from_numpy(x), mode, iters=16).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert np.isinf(got[5]).all() and (got[6] == got[6, 0]).all()
    for r in range(16):
        m = x[r].min()
        assert np.array_equal(got[r] == got[r].min(), x[r] == m), r


def test_wrappers_raise_on_other_devices():
    meta = torch.empty((8, 128), device="meta")
    with pytest.raises(ValueError):
        probe_lanes.lane_ops(meta, "reduce")
    with pytest.raises(ValueError):
        probe_lanes.lane_ops(torch.zeros((8, 128)), "sort")
    for warps in (0, 9):
        with pytest.raises(ValueError, match="warps"):
            probe_lanes.lane_ops_cuda(torch.zeros((8, 128)), "reduce", warps=warps)


SASS_OF_A_STEP = """
        Function : _ZN41_GLOBAL__N__probes_cu18probe_lanes_kernelILi0EEEvPKfPfii
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
        /*0010*/                   ISETP.GE.AND P0, PT, R0, UR4, PT ;      /* 0x000fe2000bf06270 */
.L_x_1:
        /*0020*/                   FMNMX R6, R2, R3, PT ;                  /* 0x0 */
        /*0030*/                   FMNMX R7, R4, R5, PT ;                  /* 0x0 */
        /*0040*/                   IADD3 R0, P2, R0, 0x1, RZ ;             /* 0x0 */
        /*0050*/                   FMNMX R6, R6, R7, PT ;                  /* 0x0 */
        /*0060*/                   ISETP.NE.AND P1, PT, R6, -0x80000000, PT ; /* 0x0 */
        /*0070*/              @!P1 MOV R6, RZ ;                            /* 0x0 */
        /*0080*/                   REDUX.MIN UR5, R6 ;                     /* 0x0 */
        /*0090*/                   MOV R8, UR5 ;                           /* 0x0 */
        /*00a0*/                   FMUL R8, R8, 9.9999999747524270788e-07 ; /* 0x0 */
        /*00b0*/                   FADD R2, R2, R8 ;                       /* 0x0 */
        /*00c0*/                   ISETP.GE.AND P0, PT, R0, R9, PT ;       /* 0x0 */
        /*00d0*/              @!P0 BRA `(.L_x_1) ;                         /* 0x0 */
        /*00e0*/                   STG.E [R10.64], R2 ;                    /* 0x0 */
        /*00f0*/                   EXIT ;                                  /* 0x0 */
        /*0100*/                   BRA 0x100 ;                             /* 0x0 */
"""


def test_lane_sass_reader_finds_the_step_chain():
    """--sass's reader: the loop between a branch's earlier target (a label,
    as nvdisasm prints it, or an address, as cuobjdump does; not the branch
    to itself after EXIT) and the branch, and its longest chain through
    registers, predicates (a guarded write also reads the old value) and
    uniform registers; the counter's carry predicate and the loop's own
    compare are off the chain."""
    (body,) = probe_lanes.loops(SASS_OF_A_STEP)
    assert len(body) == 12 and body[0].startswith("FMNMX") and body[-1].endswith("BRA `(.L_x_1)")
    by_address = SASS_OF_A_STEP.replace(".L_x_1:\n", "").replace("`(.L_x_1)", "0x20")
    assert probe_lanes.loops(by_address) == [body[:-1] + ["@!P0 BRA 0x20"]]
    got = probe_lanes.loop_chain(body)
    assert got == {"chain_instructions": 8, "chain": "FMNMX FMNMX ISETP.NE.AND MOV REDUX.MIN MOV FMUL FADD"}
    assert probe_lanes._writes_reads("IADD3 R0, P2, R0, 0x1, RZ") == (["R0", "P2"], ["R0"])
    assert probe_lanes._writes_reads("@!P1 MOV R6, RZ") == (["R6"], ["P1", "R6"])
    assert probe_lanes._writes_reads("STG.E [R10.64], R2") == ([], ["R10", "R2"])
    assert probe_lanes._writes_reads("SHFL.BFLY PT, R3, R2, 0x10, 0x1f") == (["R3"], ["R2"])


def test_perf_trace_corpus_is_the_canonical_one(tmp_path, monkeypatch):
    """perf_trace serves the bytes the canonical dataset loader returns as
    ``vecs`` (the same draws as the JAX package's generator), drawn alone:
    no ground truth is computed and no file is written."""
    from expann_tpu.data.loader import generate_synthetic as jax_generate
    from expann_tpu_torch.data import loader

    def refuse(*a, **k):
        raise AssertionError("the dataset loader was called")

    monkeypatch.setattr(loader, "load_synthetic_uniform_sphere_points", refuse)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    got = perf_trace.canonical_corpus()
    assert list(tmp_path.iterdir()) == []
    want = loader.generate_synthetic(56000, 400, 128, None)[0]
    assert got.dtype == np.float32 and got.shape == (56000, 128)
    assert got.tobytes() == want.tobytes() == jax_generate(56000, 400, 128, None)[0].tobytes()


def test_trace_on_cpu_holds_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        with profiling.annotate("probe_region"):
            torch.ones(64).sum()
    assert prof is not None
    (path,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "probe_region" in names
    with profiling.trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()


def test_parse_trace_ranks_kernels(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "fused_search_s8_kernel", "dur": 900.0},
        {"ph": "X", "cat": "kernel", "name": "rerank_gather", "dur": 60.0},
        {"ph": "X", "cat": "kernel", "name": "fused_search_s8_kernel", "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "entry_scan", "dur": 40.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 5000.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 700.0},
        {"ph": "i", "cat": "kernel", "name": "marker"},
    ]
    with gzip.open(tmp_path / "old.json.gz", "wt") as f:
        json.dump({"traceEvents": events[:1]}, f)
    (tmp_path / "new.json").write_text(json.dumps({"traceEvents": events}))
    ranked, total = perf_trace.parse_trace(str(tmp_path), top=2)
    assert ranked == [("fused_search_s8_kernel", 1000.0), ("rerank_gather", 60.0)]
    assert total == 1100.0
    assert perf_trace.parse_trace(str(tmp_path / "none"), top=2) == (None, None)


def test_perf_flat_mode_refuses_without_a_card(monkeypatch):
    """The flat timing tool measures the card or nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="GPU"):
        perf_flat_mode.main([])


def test_perf_packed_score_refuses_without_a_card(monkeypatch):
    """The block scorer's timing tool measures the card or nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="GPU"):
        perf_packed_score.main([])


def test_perf_packed_score_bound():
    """The bound of a call: one 32 KB block, two aux rows, one selection
    entry and the selected (d, id) pairs a pair, the f32 queries, over HBM's
    3.35 TB/s (the bf16 operations take far less)."""
    nbytes = 64 * (128 * 128 * 2 + 128 * 8 + 4 + 8 * 8) + 32 * 128 * 4
    assert perf_packed_score.bound_ms(32, 128, 128, 8) == (nbytes / 3.35e12 * 1e3, "bytes")
    full = 64 * (128 * 128 * 2 + 128 * 8 + 4 + 128 * 8) + 32 * 128 * 4
    assert perf_packed_score.bound_ms(32, 128, 128, 0) == (full / 3.35e12 * 1e3, "bytes")


def test_parse_copies_sums_copies_and_the_region(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "flat_topk_kernel", "dur": 900.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "dur": 300.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "dur": 100.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "dur": 5.0},
        {"ph": "X", "cat": "user_annotation", "name": perf_trace.REGION, "dur": 2500.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": perf_trace.REGION, "dur": 1400.0},
        {"ph": "X", "cat": "user_annotation", "name": "other", "dur": 9000.0},
    ]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": events}))
    copies, total, span = perf_trace.parse_copies(str(tmp_path), perf_trace.REGION)
    assert copies == {"Memcpy HtoD (Pageable -> Device)": 400.0, "Memcpy DtoH (Device -> Pageable)": 20.0,
                      "Memset (Device)": 5.0}
    assert list(copies)[0].startswith("Memcpy HtoD")
    assert total == 425.0 and span == 2500.0
    assert perf_trace.parse_copies(str(tmp_path), "missing")[2] is None
    assert perf_trace.parse_copies(str(tmp_path / "none"), perf_trace.REGION) == (None, None, None)
