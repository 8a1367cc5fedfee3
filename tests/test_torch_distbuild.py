"""The port's distributed builder against the JAX package's: on one device
(``build_distributed`` on ``make_mesh(1)``), and with the shard axis on a
mesh of 8 CPU devices (``[cpu] * 8`` against ``make_mesh(8)``, the JAX
tests' 8 virtual devices); and the clustered generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from expann_tpu.data.loader import generate_synthetic_clustered as j_clustered
from expann_tpu.models import build as jbuild
from expann_tpu.parallel import distbuild as jdist
from expann_tpu.parallel.sharded import make_mesh
from expann_tpu_torch.data.loader import generate_synthetic_clustered as t_clustered
from expann_tpu_torch.models import build as tbuild
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.models.graph import GraphIndex, make_corpus
from expann_tpu_torch.parallel import distbuild as tdist
from expann_tpu_torch.utils.persist import graph_from_numpy

torch.set_num_threads(2)

N, D, NQ = 2048, 32, 60
# C = 160: C + 1 > 128, so the flat route scans the corpus in two segments
CFG = dict(M=8, ef_construction=160, prune_cand=160)
WAVE, BOOT = 512, 500
# with ortho_bias < 0 a penalty can be negative, so the penalized passes
# change the candidate lists (at bias 0 the union is the plain list)
ORTHO = {1: dict(ortho_count=1), 2: dict(ortho_count=2, ortho_bias=-1.0)}


@pytest.mark.parametrize("uniform", [False, True], ids=["hardened", "uniform"])
@pytest.mark.parametrize("seed", [0, 7])
def test_clustered_generator_byte_identical(seed, uniform):
    """The copied generator gives the JAX package's bytes, both branches."""
    a = t_clustered(3000, 50, 24, seed=seed, uniform=uniform)
    b = j_clustered(3000, 50, 24, seed=seed, uniform=uniform)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape and u.tobytes() == v.tobytes()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    d2 = ((q[:, None] - x[None]) ** 2).sum(-1)
    return x, q, np.argsort(d2, axis=1, kind="stable")[:, :10]


@pytest.fixture(scope="module")
def jax_graphs(data):
    """The JAX builds: one-shot dense, and incremental with ortho_count=2."""
    x = data[0]
    mesh = make_mesh(1)
    out = {}
    for mode, oc in (("oneshot", 1), ("incremental", 2)):
        cfg = jbuild.BuildConfig(**CFG, **ORTHO[oc])
        out[mode] = jdist.build_distributed(x, cfg, mesh, wave_size=WAVE, bootstrap=BOOT, mode=mode,
                                            candidates="dense")
    return out


def _as_port(jg) -> GraphIndex:
    arrays = {"vectors": jg.vectors, "norms": jg.norms, "adj_bottom": jg.adj_bottom,
              "starting_vertex": jg.starting_vertex}
    for i, layer in enumerate(jg.layers):
        arrays[f"layer{i}_slot"] = layer.slot
        arrays[f"layer{i}_adj"] = layer.adj
    return graph_from_numpy({k: np.asarray(v) for k, v in arrays.items()}, "cpu")


def _recall(graph: GraphIndex, q: np.ndarray, gt: np.ndarray) -> float:
    eng = AntitopoEngine(config=AntitopoConfig(M=CFG["M"], ef_search=40, query_expand=2), device="cpu")
    eng.graph, eng.n, eng.dim = graph, graph.n, q.shape[1]
    ids = eng.query_k_batch(q, 10)
    return float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, gt)]))


def _invariants(adj: np.ndarray, n: int, cap: int) -> None:
    for i, row in enumerate(adj[:n]):
        real = row[row < n]
        assert 1 <= len(real) <= cap and i not in real
        assert len(set(real.tolist())) == len(real)
        assert (row[len(real):] == n).all()


@pytest.mark.parametrize("mode,ortho_count", [("oneshot", 1), ("incremental", 2)])
def test_distributed_build_tracks_jax(data, jax_graphs, mode, ortho_count):
    """Dense candidates, one-shot, and incremental with ortho_count=2 and
    ortho_bias=-1 (the penalized passes in every wave and in the bootstrap,
    changing the graph against ortho_count=1's), against the JAX build on
    the same data.  The two sum f32 matmuls in another order, so a near-tie
    may change a candidate order and with it a row: gate 95% of bottom rows
    identical (all matched when the gate was set), the same start vertex
    and layers, the same recall@10 within 0.01."""
    x, q, gt = data
    jg, jstats = jax_graphs[mode]
    kw = dict(wave_size=WAVE, bootstrap=BOOT, mode=mode, candidates="dense")
    tg, tstats = tdist.build_distributed(x, tbuild.BuildConfig(**CFG, **ORTHO[ortho_count]), "cpu", **kw)
    if ortho_count > 1:
        plain, _ = tdist.build_distributed(x, tbuild.BuildConfig(**CFG, **{**ORTHO[ortho_count], "ortho_count": 1}),
                                           "cpu", **kw)
        # measured: 44% of rows differ from ortho_count=1's; gate: at least 10%
        assert (tg.adj_bottom == plain.adj_bottom).all(1).float().mean() < 0.9
    assert {k: v for k, v in tstats.items() if k != "seconds"} == jstats
    assert set(tstats["seconds"]) == {"bootstrap", "forward", "reverse", "cap_sweep", "upper"}
    assert tg.starting_vertex == int(jg.starting_vertex) and len(tg.layers) == len(jg.layers)
    same = (tg.adj_bottom.numpy() == np.asarray(jg.adj_bottom)).all(1).mean()
    assert same >= 0.95, same
    _invariants(tg.adj_bottom.numpy(), N, 2 * CFG["M"])
    r_port, r_jax = _recall(tg, q, gt), _recall(_as_port(jg), q, gt)
    assert r_port >= 0.9 and abs(r_port - r_jax) <= 0.01, (r_port, r_jax)


def test_flat_candidates_track_jax_dense(data, jax_graphs):
    """The segmented flat route (C + 1 = 161 > 128: two segments at k=128,
    through flat_topk's plain version here) against the JAX dense route:
    bf16 candidate distances and at most 128 candidates a segment, so the
    gate is recall@10 within 0.02 of the JAX dense graph."""
    x, q, gt = data
    tg, tstats = tdist.build_distributed(x, tbuild.BuildConfig(**CFG), "cpu", wave_size=WAVE, mode="oneshot",
                                         candidates="flat")
    assert tstats["candidates"] == "flat"
    _invariants(tg.adj_bottom.numpy(), N, 2 * CFG["M"])
    r_port, r_jax = _recall(tg, q, gt), _recall(_as_port(jax_graphs["oneshot"][0]), q, gt)
    assert r_port >= r_jax - 0.02, (r_port, r_jax)


@pytest.mark.parametrize("ortho", [False, True], ids=["plain", "penalized"])
def test_dense_candidates_blocked_match_one_block(data, ortho):
    """The dense wave scan in column blocks of 300 (seven blocks, a ragged
    last one, a frontier inside a block) against one block over the whole
    frontier: the running top-C keeps (score, id) order across blocks, so
    ids are identical and scores within 1e-5 relative (each block is its
    own matmul).  With ``chosen`` the ortho-penalized score at bias -1."""
    x = data[0]
    vectors, norms = make_corpus(x, "cpu")
    gids = torch.arange(1000, 1128, dtype=torch.int32)
    wq = vectors[1000:1128]
    chosen = valid = None
    if ortho:
        rng = np.random.default_rng(5)
        chosen = torch.from_numpy(rng.integers(0, N, (128, 2)).astype(np.int32))
        valid = torch.from_numpy(rng.random((128, 2)) > 0.3)
    for frontier in (N, 1100):
        out = {}
        for col_block in (300, 8192):
            cfg = tbuild.BuildConfig(**CFG, ortho_bias=-1.0, col_block=col_block)
            out[col_block] = tdist._dense_candidates(vectors, norms, wq, gids, frontier, 160, cfg, chosen, valid)
        (bi, bd), (ui, ud) = out[300], out[8192]
        np.testing.assert_array_equal(bi.numpy(), ui.numpy())
        np.testing.assert_allclose(bd.numpy(), ud.numpy(), rtol=1e-5)
        assert not bool((bi == gids[:, None]).any())
        assert bool(((bi < frontier) | (bi == N)).all())


def test_flat_segments_follow_jax_boundaries(data):
    """The flat scan at C=300 (three segments at k=128 by the JAX rule):
    n=2048 gives seg_rows 1024, so two segments; n=2100 three, the last of
    52 rows, shorter than k, whose empty slots (id -1) are masked, never
    read as ids of the previous segment.  Every list: no self, no
    duplicate, (d, id) order, the sentinel exactly where d is +inf."""
    x = torch.from_numpy(data[0])
    for n in (2048, 2100):
        xs = torch.cat([x, x[: n - N]]).to(torch.bfloat16) if n > N else x.to(torch.bfloat16)
        gids = torch.arange(0, 64, dtype=torch.int32)
        ids, d = tdist._flat_candidates(xs, xs[:64].float(), gids, 300, "count")
        assert ids.shape == (64, 300)
        assert not bool((ids == gids[:, None]).any()) and bool((ids <= n).all())
        fin = torch.isfinite(d)
        assert bool((ids[fin] < n).all()) and bool((ids[~fin] == n).all())
        assert bool((d[:, 1:] >= d[:, :-1]).all())
        for row in ids:
            real = row[row < n]
            assert len(set(real.tolist())) == len(real)


def test_reverse_scatter_and_overflow_prune_identical():
    """Identical inputs into the JAX and the port's reverse scatter, the
    overflow prune of the fullest rows and the final sweep: forward rows of
    each node's nearest, plus edges to five hubs that overflow the row
    width, mutual pairs that hit the edge-exists check, short rows.  Every
    step is integer bookkeeping on the same sort order, so adjacency and
    counts must be identical."""
    rng = np.random.default_rng(11)
    n, Dd, cap, R, W = 400, 16, 8, 24, 128
    x = rng.standard_normal((n, Dd)).astype(np.float32)
    vec = np.concatenate([x, np.zeros((1, Dd), np.float32)])
    nrm = np.concatenate([(x * x).sum(1), [np.inf]]).astype(np.float32)
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1).astype(np.float32)
    np.fill_diagonal(d2, np.inf)
    near = np.argsort(d2, axis=1, kind="stable")
    adj = np.full((n + 1, R), n, np.int32)
    adj[:n, :cap] = near[:, :cap]
    adj[:50, 5:cap] = n  # short rows
    counts = (adj != n).sum(1).astype(np.int32)
    src = np.arange(100, 100 + W, dtype=np.int32)
    sel = near[src, :cap].astype(np.int32)
    sel[:, -3:] = rng.integers(0, 5, (W, 3))  # hubs, may repeat: made unique below
    for r in range(W):
        seen = set()
        for c in range(cap):
            if sel[r, c] in seen or sel[r, c] == src[r]:
                sel[r, c] = n
            seen.add(int(sel[r, c]))
    sel_d = np.where(sel == n, np.inf, d2[src[:, None], np.minimum(sel, n - 1)]).astype(np.float32)
    sel_d[:10, 6:] = np.inf  # stopped selections
    sel[:10, 6:] = n

    ja, jc = jdist._reverse_scatter(jnp.asarray(adj)[None], jnp.asarray(counts)[None], jnp.asarray(src),
                                    jnp.asarray(sel), jnp.asarray(sel_d), n)
    ta, tc = torch.from_numpy(adj.copy()), torch.from_numpy(counts.copy())
    tdist._reverse_scatter(ta, tc, torch.from_numpy(src), torch.from_numpy(sel), torch.from_numpy(sel_d))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja)[0])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[0])
    assert int((tc[:5] == R).sum()) == 5 and int((tc > cap).sum()) > 16  # hubs full, overflow real

    cfg = tbuild.BuildConfig(M=cap // 2, prune_overflow=1)
    prune = dict(cap=cap, ortho_factor=cfg.ortho_factor, ortho_bias=cfg.ortho_bias,
                 prune_overflow=cfg.prune_overflow, n_shard=n, precision="highest")
    jv, jn = jnp.asarray(vec)[None], jnp.asarray(nrm)[None]
    tv, tn = torch.from_numpy(vec), torch.from_numpy(nrm)
    top, rows = jax.lax.top_k(jc[0, :n], 16)
    rows = jnp.where(top > cap, rows, n)
    ja, jc = jdist._dist_overflow_prune_jit(jv, jn, ja, jc, rows, **prune)
    tdist._prune_fullest(tv, tn, ta, tc, cap, cfg, 16)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja)[0])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[0])

    over = np.nonzero(np.asarray(jc)[0, :n] > cap)[0].astype(np.int32)
    assert over.size > 0
    ja, jc = jdist._dist_overflow_prune_jit(jv, jn, ja, jc, jnp.asarray(over), **prune)
    tdist._dist_overflow_prune(tv, tn, ta, tc, torch.from_numpy(over).long(), cap, cfg)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja)[0])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[0])
    assert int((tc[:n] > cap).sum()) == 0


def test_engine_routes_to_distributed_builder(data, monkeypatch):
    """``build_index`` above a lowered auto_wave_threshold calls the
    distributed builder (one-shot, candidates "auto", waves of 4096) and
    returns its graph, at or below it the one-shot builder's; the engine's
    ``builder="dist"`` forces the distributed route, its default takes the
    one-shot builder at this size."""
    x = data[0]
    calls = []
    build_distributed = tdist.build_distributed

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return build_distributed(*args, **kwargs)

    monkeypatch.setattr(tdist, "build_distributed", spy)
    direct, _ = build_distributed(x, tbuild.BuildConfig(**CFG), "cpu", wave_size=4096, mode="oneshot")
    oneshot = tbuild.build_index(x, tbuild.BuildConfig(**CFG), "cpu")
    assert not calls
    routed = dict(wave_size=4096, mode="oneshot", candidates="auto", verbose=False)
    for threshold, want in ((N - 1, direct), (N, oneshot)):
        calls.clear()
        g = tbuild.build_index(x, tbuild.BuildConfig(**CFG, auto_wave_threshold=threshold), "cpu")
        assert calls == ([routed] if want is direct else []), threshold
        assert torch.equal(g.adj_bottom, want.adj_bottom) and g.starting_vertex == want.starting_vertex, threshold
    for builder, want in (("dist", direct), ("auto", oneshot)):
        calls.clear()
        eng = AntitopoEngine(config=AntitopoConfig(**CFG, builder=builder), device="cpu")
        eng.store_many_vectors(x)
        eng.build()
        assert calls == ([routed] if want is direct else []), builder
        assert torch.equal(eng.graph.adj_bottom, want.adj_bottom), builder
        assert eng.graph.starting_vertex == want.starting_vertex


MESH8 = ["cpu"] * 8


def _data8(n, m, seed):
    """The JAX S = 8 tests' data (tests/test_distbuild.py): n x 32 and m
    queries from one seed, with exact top-10 ground truth."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    q = rng.standard_normal((m, D)).astype(np.float32)
    d2 = ((q[:, None] - x[None]) ** 2).sum(-1)
    return x, q, np.argsort(d2, axis=1, kind="stable")[:, :10]


def _both8(x, cfg: dict, **kw):
    """The JAX build on make_mesh(8) and the port's on [cpu] * 8, with the
    same stats (n_shards 8) but the port's stage seconds."""
    jg, jstats = jdist.build_distributed(x, jbuild.BuildConfig(**cfg), make_mesh(8), **kw)
    tg, tstats = tdist.build_distributed(x, tbuild.BuildConfig(**cfg), MESH8, **kw)
    assert {k: v for k, v in tstats.items() if k != "seconds"} == jstats and jstats["n_shards"] == 8
    _invariants(tg.adj_bottom.numpy(), x.shape[0], 2 * cfg["M"])
    adj = tg.adj_bottom.numpy()[: x.shape[0]]
    src = np.arange(x.shape[0])[:, None] // tstats["n_shard"]
    dst = np.where(adj == x.shape[0], -1, adj // tstats["n_shard"])
    assert ((dst >= 0) & (dst != src)).any(), "no cross-shard edges: not one global graph"
    return tg, jg


@pytest.mark.parametrize("mode", ["oneshot", "incremental"])
def test_distributed_build_one_global_graph_on_8_devices(mode):
    """The JAX test of one global graph over 8 shards (n = 4000, waves of
    512, bootstrap 500 capped at n_shard), dense candidates from every
    shard merged by (d, id): the same stats, >= 95% of bottom rows
    identical (all matched when the gate was set), cross-shard edges, the
    same start vertex and levels, recall@10 within 0.01 of the JAX graph's."""
    x, q, gt = _data8(4000, 60, 0)
    cfg = dict(M=10, ef_construction=80, prune_cand=64)
    tg, jg = _both8(x, cfg, wave_size=512, bootstrap=500, mode=mode)
    assert tg.starting_vertex == int(jg.starting_vertex) and len(tg.layers) == len(jg.layers)
    same = (tg.adj_bottom.numpy() == np.asarray(jg.adj_bottom)).all(1).mean()
    assert same >= 0.95, same
    r_port, r_jax = _recall(tg, q, gt), _recall(_as_port(jg), q, gt)
    assert r_port >= 0.85 and abs(r_port - r_jax) <= 0.01, (r_port, r_jax)


@pytest.mark.parametrize("efc,m,seed", [(48, 40, 5), (160, 30, 8)], ids=["flat", "wide_flat"])
def test_distributed_flat_candidates_on_8_devices(efc, m, seed):
    """Flat candidates over 8 shards of 256 rows (one segment a shard at
    C = 48, two at C = 160 > 127), K2's plain version here, against the
    JAX flat build (its kernel in interpret mode).  The JAX kernel pools
    each block to 128 lanes and the port's selection is exact, so rows
    differ where a pooled lane dropped a candidate (86% / 76% identical
    when the gate was set): the gate is recall@10 within 0.02."""
    x, q, gt = _data8(2048, m, seed)
    cfg = dict(M=8, ef_construction=efc, prune_cand=efc)
    tg, jg = _both8(x, cfg, wave_size=256, mode="oneshot", candidates="flat")
    r_port, r_jax = _recall(tg, q, gt), _recall(_as_port(jg), q, gt)
    assert r_port >= 0.8 and abs(r_port - r_jax) <= 0.02, (r_port, r_jax)


def test_distributed_build_ortho2_on_8_devices():
    """ortho_count=2 at ortho_bias=-1 over 8 shards (incremental, the
    penalized pass scored on every shard against the chosen rows gathered
    from their owners and merged per pass): the same stats, >= 95% of
    bottom rows identical, recall@10 within 0.01."""
    x, q, gt = _data8(3000, 50, 11)
    cfg = dict(M=10, ef_construction=80, prune_cand=64, ortho_count=2, ortho_bias=-1.0)
    tg, jg = _both8(x, cfg, wave_size=512, bootstrap=500, mode="incremental")
    same = (tg.adj_bottom.numpy() == np.asarray(jg.adj_bottom)).all(1).mean()
    assert same >= 0.95, same
    r_port, r_jax = _recall(tg, q, gt), _recall(_as_port(jg), q, gt)
    assert r_port >= 0.85 and abs(r_port - r_jax) <= 0.01, (r_port, r_jax)
