"""The port's quantized serving against the JAX package: the quantizers, the
s8 flat scan (K2-s8 / K3-s8 plain version), the s8 traversal (K1-s8 plain
version), the fused_i8 flat engine, the graph engine on s8 blocks and on
the uint8 gather beam, the counter split, the layout flip and the packed
memory guard.  JAX's Pallas kernels run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from expann_tpu.models.antitopo import AntitopoConfig as JConfig
from expann_tpu.models.antitopo import AntitopoEngine as JEngine
from expann_tpu.models.brute_force import BruteForceEngine as JBruteForceEngine
from expann_tpu.models.search import query_batch as j_query_batch
from expann_tpu.ops import quantize as j_quantize
from expann_tpu.ops.pallas_beam import build_packed_i8 as j_build_packed_i8
from expann_tpu.ops.pallas_beam import decode_ids_f32
from expann_tpu.ops.pallas_fused import fused_search as j_fused_search
from expann_tpu.ops.pallas_topk import flat_topk as j_flat_topk
from expann_tpu.ops.pallas_topk import quantize_corpus_i8 as j_quantize_corpus_i8
from expann_tpu.ops.pallas_topk import quantize_query_i8 as j_quantize_query_i8
from expann_tpu.utils.persist import save_index as j_save_index
from expann_tpu_torch.models import antitopo as t_antitopo
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.models.brute_force import BruteForceEngine
from expann_tpu_torch.models.layout import Blocks, CodeBlocks
from expann_tpu_torch.models.search import query_batch
from expann_tpu_torch.ops import quantize as t_quantize
from expann_tpu_torch.ops.fused import fused_search
from expann_tpu_torch.ops.packed import build_packed_i8, code_rows_bytes, pack_blocks, packed_bytes
from expann_tpu_torch.ops.topk import flat_topk, flat_topk_plain, quantize_corpus_i8, quantize_query_i8
from expann_tpu_torch.utils.persist import graph_from_numpy, graph_to_numpy, load_index

torch.set_num_threads(2)

N, D, K, EF = 800, 32, 10, 40


def _recall(ids, gt):
    return np.mean([len(set(a[:K].tolist()) & set(b[:K].tolist())) / K for a, b in zip(ids, gt)])


def _overlap(a_ids, b_ids):
    return np.mean([len(set(a[:K].tolist()) & set(b[:K].tolist())) / K for a, b in zip(a_ids, b_ids)])


def _gt(x, q):
    d2 = ((q[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :K]


@pytest.fixture(scope="module")
def gauss():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((40, D)).astype(np.float32)
    return x, q, _gt(x, q)


def _padded(x):
    """The padded ``(N + 1, 128)`` corpus with its zero dummy row."""
    return np.concatenate([np.pad(x, ((0, 0), (0, 128 - x.shape[1]))), np.zeros((1, 128), np.float32)])


# ---- 1. quantizers ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["simple", "ranged"])
def test_uint8_quantizers_match_jax(mode):
    """Codes and norms of both packages on the padded corpus: the cast is
    exact; the affine round (half to even in both) may differ where XLA
    and PyTorch round ``x * scale + offset`` in another last bit: at most 1
    code in 10^4, by at most 1."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((600, D)) * 40 + 60).astype(np.float32)
    vp = _padded(x)
    if mode == "simple":
        jc, jn = j_quantize.quantize_simple(jnp.asarray(vp))
        tc, tn = t_quantize.quantize_simple(torch.from_numpy(vp))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        return
    assert t_quantize.ranged_scale_offset(x) == j_quantize.ranged_scale_offset(x)
    scale, offset = t_quantize.ranged_scale_offset(x)
    jc, jn = j_quantize.quantize_ranged(jnp.asarray(vp), scale, offset)
    tc, tn = t_quantize.quantize_ranged(torch.from_numpy(vp), scale, offset)
    jc, tc = np.asarray(jc).astype(np.int32), tc.numpy().astype(np.int32)
    assert np.abs(tc - jc).max() <= 1
    assert (tc != jc).mean() <= 1e-4
    same = (tc == jc).all(1)
    np.testing.assert_array_equal(tn.numpy()[same], np.asarray(jn)[same])
    assert np.isinf(tn[-1].item())


def test_i8_flat_quantizers_bit_identical():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((700, 128)) * 3 + 1.5).astype(np.float32)
    q = (rng.standard_normal((50, 128)) * 3 + 1.5).astype(np.float32)
    tc, tcen, tscale, n = quantize_corpus_i8(x, "cpu")
    jc, jcen, jscale, jn = j_quantize_corpus_i8(x)
    assert n == jn == 700 and tscale == jscale
    np.testing.assert_array_equal(tcen, jcen)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[:n])
    np.testing.assert_array_equal(quantize_query_i8(q, tcen, tscale), j_quantize_query_i8(q, jcen, jscale))


def _toy_graph(n, r, seed, d=D):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    vp = _padded(x)
    adj = np.stack([rng.choice(n, size=r, replace=False) for _ in range(n)] + [np.full(r, n)]).astype(np.int32)
    adj[::7, -5:] = n  # short rows: sentinel padding inside blocks
    return rng, x, vp, adj


def _jax_i8_arrays(vp, adj):
    """JAX's build_packed_i8 as writable host arrays, ids decoded."""
    jp, ja, jc, jcn, jcen, jsc = j_build_packed_i8(jnp.asarray(vp), jnp.asarray(adj))
    ja = np.array(ja)
    return dict(
        packed=np.array(jp), packed_norms=ja[:, 0], packed_ids=np.array(decode_ids_f32(jnp.asarray(ja[:, 1]))),
        packed_codes=np.array(jc), packed_code_norms=np.array(jcn), packed_center=np.array(jcen),
        packed_scale=np.array(jsc),
    )


def test_build_packed_i8_matches_jax():
    """The port's s8 layout: center and scale within 1e-6 relative of the
    JAX device mean and absmax, codes off by at most 1 where the mean's
    last bit flips a .5 boundary, and the block layout equal to JAX's when
    it packs JAX's codes."""
    _, _, vp, adj = _toy_graph(300, 40, seed=3)
    j = _jax_i8_arrays(vp, adj)
    packed, pn, pi, codes, cn, center, scale = build_packed_i8(torch.from_numpy(vp), torch.from_numpy(adj))
    assert packed.dtype == torch.int8 and packed.shape == (301, 64, 128) and pn.shape == pi.shape == (301, 128)
    np.testing.assert_allclose(center.numpy(), j["packed_center"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(scale.item(), float(j["packed_scale"]), rtol=1e-6)
    diff = codes.numpy().astype(np.int32) - j["packed_codes"]
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 1e-4
    assert np.isinf(cn[-1].item())
    lp, ln, li = pack_blocks(torch.from_numpy(j["packed_codes"]), torch.from_numpy(j["packed_code_norms"]),
                             torch.from_numpy(adj), align=32)
    np.testing.assert_array_equal(lp.numpy(), j["packed"])
    np.testing.assert_array_equal(ln.numpy(), j["packed_norms"])
    np.testing.assert_array_equal(li.numpy(), j["packed_ids"])
    np.testing.assert_array_equal(pi.numpy(), li.numpy())


# ---- 2. the s8 flat scan -----------------------------------------------------


def test_flat_topk_plain_s8_is_the_integer_oracle():
    """The plain s8 scan against a numpy int64 oracle, ids and distances
    exactly, on codes with duplicated rows (exact integer ties, by id)."""
    rng = np.random.default_rng(4)
    base = rng.integers(-127, 128, (200, 128)).astype(np.int8)
    x = np.concatenate([base, base[:40], base[5:25]])
    q = np.concatenate([base[:10], rng.integers(-127, 128, (20, 128)).astype(np.int8)])
    for k in (1, 30, 128):
        ids, d = flat_topk(torch.from_numpy(q), torch.from_numpy(x), k)
        d64 = ((q[:, None].astype(np.int64) - x[None].astype(np.int64)) ** 2).sum(-1)
        want = np.argsort(d64, axis=1, kind="stable")[:, :k]
        np.testing.assert_array_equal(ids.numpy(), want)
        np.testing.assert_array_equal(d.numpy(), np.take_along_axis(d64, want, 1).astype(np.float32))
    with pytest.raises(TypeError):  # an s8 corpus needs s8 queries
        flat_topk_plain(torch.from_numpy(q).float(), torch.from_numpy(x), 5)


@pytest.mark.parametrize("mode", ["count", "fixed"])
def test_flat_topk_s8_matches_jax_kernel(mode):
    """The same s8 codes through the plain scan and the JAX kernel
    (interpret): the JAX kernel pools each 1024-row block to 128 lanes
    (~C(k, 2) / (blocks * 128) lost entries per query: 0.04 with 8 blocks at
    k=10) and, in count mode, clobbers low key bits, so the gate is recall
    of the port against JAX >= 0.99 and, where ids agree, distances within
    2^-13 relative."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8100, 128)).astype(np.float32)
    q = rng.standard_normal((256, 128)).astype(np.float32)
    jc, cen, sc, n = j_quantize_corpus_i8(x)
    qk = j_quantize_query_i8(q, cen, sc)
    k = 10
    ids, d = flat_topk(torch.from_numpy(qk), torch.from_numpy(np.asarray(jc)[:n]), k, mode=mode)
    jids, jd = j_flat_topk(jnp.asarray(qk), jc, n_real=n, k=k, interpret=True, mode=mode)
    jids, jd = np.asarray(jids), np.asarray(jd)
    assert np.mean([len(set(a) & set(b)) / k for a, b in zip(ids.numpy(), jids)]) >= 0.99
    same = ids.numpy() == jids
    np.testing.assert_allclose(d.numpy()[same], jd[same], rtol=2.0**-13)


# ---- 3. the s8 traversal -------------------------------------------------------


@pytest.mark.parametrize("expand", [1, 2])
def test_fused_search_s8_matches_jax_kernel(expand):
    """JAX's build_packed_i8 arrays carried across; the same code-space
    queries and seed beams through the plain s8 traversal and the JAX kernel
    in interpret mode.  Gates of tests/test_torch_fused.py: whole-beam
    agreement on >= 7/8 queries, >= 99% of entries, distcomps within 1%;
    where ids agree the JAX distances carry its <= 2^-15 key clobber."""
    n, r, B, EF_, ef = 300, 40, 8, 128, 60
    rng, x, vp, adj = _toy_graph(n, r, seed=10 + expand)
    j = _jax_i8_arrays(vp, adj)
    q = np.pad(rng.standard_normal((B, D)).astype(np.float32), ((0, 0), (0, 128 - D)))
    qk = np.clip(np.round((q - j["packed_center"]) * j["packed_scale"]), -127, 127).astype(np.float32)
    codes = j["packed_codes"].astype(np.float32)
    bd0 = np.full((B, EF_), np.inf, np.float32)
    bd0[:, 0] = ((qk - codes[0]) ** 2).sum(1)
    bi0 = np.full((B, EF_), n, np.int32)
    bi0[:, 0] = 0
    ti, td, tn, _ = fused_search(torch.from_numpy(j["packed"]), torch.from_numpy(j["packed_norms"]),
                                 torch.from_numpy(j["packed_ids"]), torch.from_numpy(qk), torch.from_numpy(bd0),
                                 torch.from_numpy(bi0), ef, expand=expand, cand=8)
    jp, ja, *_ = j_build_packed_i8(jnp.asarray(vp), jnp.asarray(adj))
    ji, jd, jn, _ = j_fused_search(jp, ja, jnp.asarray(qk), jnp.asarray(bd0), jnp.asarray(bi0), ef=ef,
                                   expand=expand, cand=8, qt=8, interpret=True, merge="topt")
    ti, td, tn = ti.numpy(), td.numpy(), tn.numpy()
    ji, jd, jn = np.asarray(ji), np.asarray(jd), np.asarray(jn)
    assert np.mean([set(a) == set(b) for a, b in zip(ti, ji)]) >= 7 / 8
    overlap = np.mean([len((set(a) & set(b)) - {n}) / len(set(b) - {n}) for a, b in zip(ti, ji)])
    assert overlap >= 0.99, overlap
    assert abs(int(tn.sum()) - int(jn.sum())) <= 0.01 * int(jn.sum())
    fin = (ti < n) & (ti == ji)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=2.0**-15)
    assert (td[ti < n] == np.round(td[ti < n])).all()  # exact integers


# ---- 4. the fused_i8 flat engine ---------------------------------------------------


@pytest.mark.parametrize("topk_mode", ["count", "fixed"])
@pytest.mark.parametrize("rerank_store", ["f32", "bf16"])
@pytest.mark.parametrize("wire", ["bf16", "i8"])
def test_fused_i8_engine_matches_jax(wire, rerank_store, topk_mode):
    """Both flat engines in mode fused_i8 on the same data: top-10 overlap
    >= 0.98, recall within 0.01, and the port's recall against the exact
    oracle at least the JAX tests' floors (tests/test_brute_force.py:61-105:
    0.97 with the defaults, 0.95 with a bf16 rerank corpus, 0.93 on the i8
    wire).  The JAX scan pools each 1024-row block to 128 lanes and loses
    ~C(k, 2) / (blocks * 128) of a query's top-10 (the port's scan is
    exact), so the corpus spans 8 blocks."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((8100, D)) * 3 + 1.5).astype(np.float32)
    q = (rng.standard_normal((40, D)) * 3 + 1.5).astype(np.float32)
    kw = dict(mode="fused_i8", rerank_store=rerank_store, topk_mode=topk_mode, query_wire=wire)
    out = {}
    for name, eng in (("port", BruteForceEngine(device="cpu", **kw)), ("jax", JBruteForceEngine(**kw))):
        eng.store_many_vectors(x)
        eng.build()
        out[name] = eng.query_k_batch(q, K)
    gt = _gt(x, q)
    assert _overlap(out["port"], out["jax"]) >= 0.98
    assert abs(_recall(out["port"], gt) - _recall(out["jax"], gt)) <= 0.01
    floor = 0.93 if wire == "i8" else 0.95 if rerank_store == "bf16" else 0.97
    assert _recall(out["port"], gt) >= floor
    assert all(len(set(r.tolist())) == K for r in out["port"])


# ---- 5. the graph engine on s8 blocks (fused route) -----------------------------


@pytest.fixture(scope="module")
def jax_compressed(gauss, tmp_path_factory):
    """One JAX-built index with uint8 codes (M=12, ef_construction=60),
    saved so that the port serves the identical graph."""
    x, _, _ = gauss
    cfg = JConfig(M=12, ef_construction=60, ef_search=EF, query_expand=2, fused_cand=8, fused_qt=8,
                  use_packed=True, use_fused=True, use_compression=True, seed=0)
    eng = JEngine(config=cfg)
    eng.store_many_vectors(x)
    eng.build()
    path = str(tmp_path_factory.mktemp("idx") / "index.npz")
    j_save_index(path, eng.graph, {"dim": D})
    return eng, path


def _port_engine(path, **knobs):
    cfg = AntitopoConfig(M=12, ef_search=EF, query_expand=2, fused_cand=8, index_filename=path, read_index=True,
                         **knobs)
    eng = AntitopoEngine(config=cfg, device="cpu")
    eng.build()
    return eng


@pytest.mark.parametrize("wire", ["bf16", "i8"])
@pytest.mark.parametrize("seeds", [0, 8])
def test_compressed_engine_fused_route_matches_jax(gauss, jax_compressed, seeds, wire):
    """s8 blocks on both engines (each builds its own layout; the JAX codes
    may differ in a .5-boundary code), code-space seeds and traversal,
    exact f32 rerank.  Gates: top-10 overlap >= 0.99, recall within 0.005,
    num_distcomps equal (real * ef), num_distcomps_compressed within 1%."""
    _, q, gt = gauss
    jeng, path = jax_compressed
    jeng.cfg.entry_seeds, jeng.cfg.query_wire = seeds, wire
    jeng.set_ef_search(EF)
    j_ids = jeng.query_k_batch(q, K)
    teng = _port_engine(path, use_packed=True, use_fused=True, use_compression=True, entry_seeds=seeds,
                        query_wire=wire)
    t_ids = teng.query_k_batch(q, K)
    g = teng.graph
    assert type(g.layout) is CodeBlocks and g.packed.dtype == torch.int8 and g.packed.shape[1] % 32 == 0
    assert g.codes.dtype == torch.uint8
    assert _overlap(t_ids, j_ids) >= 0.99
    assert abs(_recall(t_ids, gt) - _recall(j_ids, gt)) <= 0.005
    assert teng.num_distcomps == jeng.num_distcomps == q.shape[0] * EF
    assert abs(teng.num_distcomps_compressed - jeng.num_distcomps_compressed) <= 0.01 * jeng.num_distcomps_compressed
    assert all(len(set(r.tolist())) == K for r in t_ids)


# ---- 6. the uint8 gather beam (per-iteration route) -----------------------------


@pytest.fixture(scope="module")
def sift_like(tmp_path_factory):
    """SIFT-like non-negative integer data (tests/test_antitopo.py:127-130),
    where the cast quantizer is sane, and its JAX-built index."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 200, (N, D)).astype(np.float32)
    q = rng.integers(0, 200, (40, D)).astype(np.float32)
    eng = JEngine(config=JConfig(M=12, ef_construction=60, seed=0))
    eng.store_many_vectors(x)
    eng.build()
    path = str(tmp_path_factory.mktemp("sift") / "index.npz")
    j_save_index(path, eng.graph, {"dim": D})
    return x, q, path


@pytest.mark.parametrize("quant_mode", ["simple", "ranged"])
def test_compressed_gather_route_matches_jax(gauss, sift_like, tmp_path, quant_mode):
    """query_batch(compressed=True) of both packages on the same index and
    the same codes: ids row for row and per-query distance counts equal;
    then both engines (CPU defaults: the gather beam) agree id for id with
    equal counters.  "simple" codes on SIFT-like integer data, "ranged"
    codes on Gaussian data."""
    if quant_mode == "simple":
        x, q, path = sift_like
    else:
        x, q, _ = gauss
        jb = JEngine(config=JConfig(M=12, ef_construction=60, seed=0))
        jb.store_many_vectors(x)
        jb.build()
        path = str(tmp_path / "index.npz")
        j_save_index(path, jb.graph, {"dim": D})
    common = dict(M=12, ef_search=EF, query_expand=2, use_compression=True, quant_mode=quant_mode,
                  index_filename=path, read_index=True)
    jeng = JEngine(config=JConfig(**common))
    jeng.build()
    teng = AntitopoEngine(config=AntitopoConfig(**common), device="cpu")
    teng.build()
    qp = np.pad(q, ((0, 0), (0, 128 - D)))
    ti, _, tn = query_batch(teng.graph, torch.from_numpy(qp), K, EF, expand=2, compressed=True)
    ji, _, jn = j_query_batch(jeng.graph, jnp.asarray(qp), k=K, ef=EF, expand=2, compressed=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(teng.query_k_batch(q, K), jeng.query_k_batch(q, K))
    assert teng.num_distcomps_compressed == jeng.num_distcomps_compressed > 0
    assert teng.num_distcomps == jeng.num_distcomps == q.shape[0] * EF
    if quant_mode == "simple":
        assert _recall(ti.numpy(), _gt(x, q)) >= 0.85  # integer data: the cast is lossless


def test_graph_carries_jax_codes(sift_like):
    """graph_from_numpy takes the JAX package's uint8 codes and s8 layout
    as numpy arrays, so both packages can score identical codes."""
    _, _, path = sift_like
    jeng = JEngine(config=JConfig(M=12, use_compression=True, index_filename=path, read_index=True))
    jeng.build()
    tg, _ = load_index(path, "cpu")
    arrays = graph_to_numpy(tg)
    arrays.update(codes=np.asarray(jeng.graph.codes), code_norms=np.asarray(jeng.graph.code_norms))
    arrays.update(_jax_i8_arrays(np.asarray(jeng.graph.vectors), np.asarray(jeng.graph.adj_bottom)))
    g = graph_from_numpy(arrays, "cpu")
    assert type(g.layout) is CodeBlocks and g.layout.scale.shape == ()
    assert g.codes.dtype == torch.uint8 and g.packed.dtype == torch.int8
    np.testing.assert_array_equal(g.codes.numpy(), np.asarray(jeng.graph.codes))
    assert g.quant_scale is None and g.layout.center.shape == (128,)


# ---- 7. the layout flip and the memory guard ---------------------------------------


def test_compression_flip_rebuilds_an_s8_layout(gauss, jax_compressed):
    """bench.py's flow (bench.py:300-302) on a built bf16 engine: the bf16
    layout is dropped before the next query and the s8 one built, and the
    ids equal those of an engine built compressed."""
    _, q, _ = gauss
    _, path = jax_compressed
    knobs = dict(use_packed=True, use_fused=True)
    eng = _port_engine(path, **knobs)
    eng.query_k_batch(q, K)
    assert type(eng.graph.layout) is Blocks and eng.graph.packed.dtype == torch.bfloat16
    eng.cfg.use_compression = True
    eng._attach_codes()
    assert type(eng.graph.layout) is Blocks  # dropped lazily, at the next query
    flipped = eng.query_k_batch(q, K)
    assert eng.graph.packed.dtype == torch.int8 and eng.cfg.packed_dtype == "i8"
    assert type(eng.graph.layout) is CodeBlocks
    fresh = _port_engine(path, use_compression=True, **knobs)
    np.testing.assert_array_equal(flipped, fresh.query_k_batch(q, K))
    eng.set_packed_dtype("bf16")  # dropped at once; the next query rebuilds s8 (use_compression)
    assert eng.graph.layout is None and eng.graph.packed is None
    with pytest.raises(ValueError):
        eng.set_packed_dtype("i4")


def test_packed_budget_sends_queries_to_the_gather_route(gauss, jax_compressed, monkeypatch):
    """Over PACKED_BUDGET_BYTES no layout is built and every chunk takes
    the per-iteration gather route, as the JAX engine's guard does
    (antitopo.py:362-381): for a compressed engine the uint8 beam.  A
    budget below the s8 blocks still admits the s8 code rows, so the
    budget here is below those too."""
    _, q, _ = gauss
    _, path = jax_compressed
    calls = []
    real = t_antitopo.query_batch
    monkeypatch.setattr(t_antitopo, "query_batch", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    eng = _port_engine(path, use_packed=True, use_fused=True, use_compression=True)
    need = packed_bytes(N + 1, eng.graph.adj_bottom.shape[1], 128, "i8")
    monkeypatch.setattr(t_antitopo, "PACKED_BUDGET_BYTES", code_rows_bytes(N + 1, 128) - 1)
    ids = eng.query_k_batch(q, K)
    assert eng.graph.layout is None and calls and all(kw["compressed"] for kw in calls)
    monkeypatch.setattr(t_antitopo, "PACKED_BUDGET_BYTES", need)
    gather = _port_engine(path, use_compression=True)  # the CPU default route
    np.testing.assert_array_equal(ids, gather.query_k_batch(q, K))
    eng.query_k_batch(q[:8], K)
    assert type(eng.graph.layout) is CodeBlocks  # within the budget the layout is built
