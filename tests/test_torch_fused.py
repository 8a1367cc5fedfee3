"""The port's fused traversal against the JAX kernel (interpret mode) and
the port's graph engine against the JAX engine on the same index."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from expann_tpu.models.antitopo import AntitopoConfig as JConfig
from expann_tpu.models.antitopo import AntitopoEngine as JEngine
from expann_tpu.ops.pallas_beam import build_packed as j_build_packed
from expann_tpu.ops.pallas_fused import fused_search as j_fused_search
from expann_tpu.utils.persist import save_index as j_save_index
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.ops.fused import fused_search
from expann_tpu_torch.ops.packed import build_packed

torch.set_num_threads(2)

N, D, K = 800, 32, 10


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((40, D)).astype(np.float32)
    d2 = ((q[:, None] - x[None]) ** 2).sum(-1)
    return x, q, np.argsort(d2, axis=1, kind="stable")[:, :K]


@pytest.fixture(scope="module")
def jax_engine(data, tmp_path_factory):
    """One JAX-built index (M=12, ef_construction=60), also saved to disk so
    the port can serve the identical graph."""
    x, _, _ = data
    cfg = JConfig(M=12, ef_construction=60, use_packed=True, use_fused=True, fused_qt=8, seed=0)
    eng = JEngine(config=cfg)
    eng.store_many_vectors(x)
    eng.build()
    path = str(tmp_path_factory.mktemp("idx") / "index.npz")
    j_save_index(path, eng.graph, {"dim": D})
    return eng, path


def _complete_graph(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    vecs = np.concatenate([np.pad(x, ((0, 0), (0, 128 - D))), np.zeros((1, 128), np.float32)])
    norms = np.concatenate([(vecs[:n] ** 2).sum(1), [np.inf]]).astype(np.float32)
    adj = np.tile(np.arange(n, dtype=np.int32), (n + 1, 1))
    return rng, x, vecs, norms, adj


def _seed_beam(q, x, B, EF, n):
    bd0 = np.full((B, EF), np.inf, np.float32)
    bd0[:, 0] = ((q - x[0]) ** 2).sum(1)
    bi0 = np.full((B, EF), n, np.int32)
    bi0[:, 0] = 0
    return bd0, bi0


def _both(vecs, norms, adj, qp, bd0, bi0, ef, expand, cand, dtype):
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}[dtype]
    packed, pn, pi = build_packed(torch.from_numpy(vecs), torch.from_numpy(norms), torch.from_numpy(adj), dtype=tdt)
    t = fused_search(packed, pn, pi, torch.from_numpy(qp), torch.from_numpy(bd0), torch.from_numpy(bi0),
                     ef, expand=expand, cand=cand)
    jp, ja = j_build_packed(jnp.asarray(vecs), jnp.asarray(norms), jnp.asarray(adj), dtype=jdt)
    j = j_fused_search(jp, ja, jnp.asarray(qp), jnp.asarray(bd0), jnp.asarray(bi0), ef=ef,
                       expand=expand, cand=cand, qt=8, interpret=True, merge="topt")
    return [a.numpy() for a in t], [np.asarray(a) for a in j]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("expand", [1, 2])
def test_fused_search_matches_jax_kernel(dtype, expand):
    """Identical packed arrays and seed beams through both traversals.  The
    JAX kernel ranks f32 keys whose low bits hold the lane (a 2^-15
    relative clobber) and the two libraries sum q.x in another order, so a
    near-tie may resolve differently; the gate is whole-beam agreement on
    at least 7 of 8 queries, 99% of the real beam entries, and distance
    counts within 1%."""
    n, R, B, EF, ef = 300, 40, 8, 128, 60
    rng = np.random.default_rng(expand)
    x = rng.standard_normal((n, D)).astype(np.float32)
    vecs = np.concatenate([np.pad(x, ((0, 0), (0, 128 - D))), np.zeros((1, 128), np.float32)])
    norms = np.concatenate([(vecs[:n] ** 2).sum(1), [np.inf]]).astype(np.float32)
    adj = np.stack([rng.choice(n, size=R, replace=False) for _ in range(n)] + [np.full(R, n)]).astype(np.int32)
    adj[::7, -5:] = n  # short rows: sentinel padding inside blocks
    q = rng.standard_normal((B, D)).astype(np.float32)
    qp = np.pad(q, ((0, 0), (0, 128 - D)))
    bd0, bi0 = _seed_beam(q, x, B, EF, n)
    (ti, td, tn, tit), (ji, jd, jn, jit) = _both(vecs, norms, adj, qp, bd0, bi0, ef, expand, 8, dtype)
    same = [set(a) == set(b) for a, b in zip(ti, ji)]
    assert np.mean(same) >= 7 / 8, same
    overlap = np.mean([len((set(a) & set(b)) - {n}) / len(set(b) - {n}) for a, b in zip(ti, ji)])
    assert overlap >= 0.99, overlap
    assert abs(int(tn.sum()) - int(jn.sum())) <= 0.01 * int(jn.sum())
    # iterations: per query here, per 8-query tile there
    assert tit.max() == jit.max()
    fin = (ti < n) & (ji < n) & (ti == ji)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-4)
    assert ((ti == n) == ~np.isfinite(td)).all()


@pytest.mark.parametrize("expand,cand", [(1, 64), (2, 256)])
def test_fused_search_complete_graph(expand, cand):
    """With ef >= n and a complete adjacency one expansion wave reaches
    everything: the beam is the whole corpus, duplicate-free, with exact
    (f32 block) distances; with expand=2 both expanded blocks offer the
    same candidates every iteration (maximal cross-segment overlap)."""
    n, B, EF, ef = 60, 8, 128, 120
    rng, x, vecs, norms, adj = _complete_graph(n, 5 + expand)
    q = rng.standard_normal((B, D)).astype(np.float32)
    qp = np.pad(q, ((0, 0), (0, 128 - D)))
    bd0, bi0 = _seed_beam(q, x, B, EF, n)
    (ti, td, _, tit), (ji, _, _, _) = _both(vecs, norms, adj, qp, bd0, bi0, ef, expand, cand, "f32")
    d2 = ((q[:, None] - x[None]) ** 2).sum(-1)
    for b in range(B):
        got = [int(i) for i in ti[b] if i < n]
        assert sorted(got) == list(range(n))
        assert sorted(int(i) for i in ji[b] if i < n) == list(range(n))
        np.testing.assert_allclose(np.sort(td[b][ti[b] < n]), np.sort(d2[b]), rtol=1e-4, atol=1e-3)
    assert int(tit.max()) <= n + 2


def test_fused_search_dedup_small_cand():
    """Small cand on a complete graph: the per-node quota is spent on nodes
    already in the beam, so the beam may stall early but stays
    duplicate-free, as in the JAX kernel."""
    n, B, EF, ef = 60, 8, 128, 120
    rng, x, vecs, norms, adj = _complete_graph(n, 17)
    q = rng.standard_normal((B, D)).astype(np.float32)
    qp = np.pad(q, ((0, 0), (0, 128 - D)))
    bd0, bi0 = _seed_beam(q, x, B, EF, n)
    (ti, _, _, _), (ji, _, _, _) = _both(vecs, norms, adj, qp, bd0, bi0, ef, 2, 16, "f32")
    for a, b in zip(ti, ji):
        got = [int(i) for i in a if i < n]
        assert len(set(got)) == len(got)
        assert set(got) == {int(i) for i in b if i < n}


@pytest.mark.parametrize("seeds", [0, 8])
def test_engine_matches_jax_engine_on_the_same_index(data, jax_engine, seeds):
    """The JAX-built index served by both engines (bf16 packed blocks,
    expand=2, cand=8).  Gates: mean top-k overlap >= 0.99, recall within
    0.005, total distance computations within 1%, duplicate-free rows."""
    x, q, gt = data
    jeng, path = jax_engine
    jeng.cfg.entry_seeds = seeds
    jeng.cfg.query_expand = 2
    jeng.set_ef_search(40)
    j_ids = jeng.query_k_batch(q, K)
    cfg = AntitopoConfig(
        M=12, ef_search=40, query_expand=2, fused_cand=8, entry_seeds=seeds,
        index_filename=path, read_index=True, use_packed=True, use_fused=True,
    )
    eng = AntitopoEngine(config=cfg, device="cpu")
    eng.build()
    assert eng.n == N and eng.dim == D
    t_ids = eng.query_k_batch(q, K)

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, gt)])

    overlap = np.mean([len(set(a) & set(b)) / K for a, b in zip(t_ids, j_ids)])
    assert overlap >= 0.99, overlap
    assert abs(recall(t_ids) - recall(j_ids)) <= 0.005
    assert recall(t_ids) >= 0.9
    assert abs(eng.num_distcomps - jeng.num_distcomps) <= 0.01 * jeng.num_distcomps
    for row in t_ids:
        assert len(set(row.tolist())) == K
    if seeds:
        assert eng.graph.entry_members_n == int(jeng.graph.entry_members_n)


def test_engine_self_queries_index_file_and_unported_options(data, tmp_path):
    x, q, _ = data
    path = str(tmp_path / "port_index")
    cfg = dict(M=12, ef_construction=60, ef_search=40, index_filename=path, read_index=True, write_index=True)
    eng = AntitopoEngine(config=AntitopoConfig(**cfg), device="cpu")
    eng.store_many_vectors(x[:300])
    eng.build()  # no file yet: builds and writes it
    probe = [3, 57, 211]
    assert [eng.query_k(x[i], 5)[0] for i in probe] == probe
    assert eng.num_distcomps > 0
    eng.set_ef_search(20)
    assert eng.num_distcomps == 0
    again = AntitopoEngine(config=AntitopoConfig(**cfg), device="cpu")
    again.build()  # the file exists: reads it
    assert not again.cfg.write_index and again.dim == D
    eng.set_ef_search(40)
    np.testing.assert_array_equal(again.query_k_batch(q, K), eng.query_k_batch(q, K))
    # the quantized options (unported before) now serve the same index;
    # unknown values still raise
    for kw in (dict(use_compression=True), dict(packed_dtype="i8"), dict(query_wire="i8")):
        opt = AntitopoEngine(config=AntitopoConfig(**{**cfg, "write_index": False, **kw}), device="cpu")
        opt.build()
        assert [opt.query_k(x[i], 5)[0] for i in probe] == probe
        assert opt.query_k_batch(q, K).shape == (q.shape[0], K)
    for kw in (dict(packed_dtype="i4"), dict(query_wire="f32"), dict(quant_mode="log")):
        with pytest.raises(ValueError):
            AntitopoEngine(config=AntitopoConfig(**kw), device="cpu")
