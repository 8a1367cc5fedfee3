"""The port's wave builders (models/wavebuild.py) and beam_search's ortho
scoring against the JAX package's, on the same numpy inputs.

Whole builds are held by recall: the two packages sum f32 products in
another order, so a tie decided otherwise in one wave changes every wave
after it.  Exact parity is held one step at a time, from identical state."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from expann_tpu.models import build as jbuild
from expann_tpu.models import wavebuild as jwave
from expann_tpu.models.graph import GraphIndex as JGraphIndex
from expann_tpu.models.graph import make_corpus as j_make_corpus
from expann_tpu.models.search import _gather_score_ortho as j_gather_score_ortho
from expann_tpu.models.search import beam_search as j_beam_search
from expann_tpu_torch.models import build as tbuild
from expann_tpu_torch.models import wavebuild as twave
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.models.graph import GraphIndex, make_corpus
from expann_tpu_torch.models.search import _earlier_dup, _gather_score_ortho, beam_search, descend, query_batch
from expann_tpu_torch.ops.distance import squared_norms
from expann_tpu_torch.parallel import distbuild as tdist
from expann_tpu_torch.tools import bench_1m, refine_1m
from expann_tpu_torch.utils.persist import graph_from_numpy

torch.set_num_threads(2)

# one corpus and one config for every JAX build, so the JAX steps compile
# once per shape: N > 2048, so the default bootstrap leaves waves to run
N, D, NQ, K, EF = 3000, 32, 60, 10, 40
CFG = dict(M=8, ef_construction=40)
# SPLIT: the first build of an extension is the bootstrap alone, as in the
# JAX package's engine test (2000 rows, bootstrap 2048)
W, SPLIT = 256, 2048
CAP = 2 * CFG["M"]
R = tbuild._round_up(CAP + 64, 16)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    d2 = ((q[:, None] - x[None]) ** 2).sum(-1)
    return x, q, np.argsort(d2, axis=1, kind="stable")[:, :K]


def _as_port(jg) -> GraphIndex:
    arrays = {"vectors": jg.vectors, "norms": jg.norms, "adj_bottom": jg.adj_bottom,
              "starting_vertex": jg.starting_vertex}
    for i, layer in enumerate(jg.layers):
        arrays[f"layer{i}_slot"] = layer.slot
        arrays[f"layer{i}_adj"] = layer.adj
    return graph_from_numpy({k: np.asarray(v) for k, v in arrays.items()}, "cpu")


def _recall(graph: GraphIndex, q: np.ndarray, gt: np.ndarray) -> float:
    """recall@10 of the port's gather route at ef=40 (the JAX tests' ef)."""
    qp = torch.from_numpy(np.pad(q, ((0, 0), (0, graph.vectors.shape[1] - q.shape[1]))))
    ids = query_batch(graph, qp, k=K, ef=EF)[0].numpy()
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K for a, b in zip(ids, gt)]))


def _invariants(adj: np.ndarray, n: int, cap: int) -> None:
    """No self edge, no duplicate, 1..cap edges, sentinel only after the
    last edge."""
    for i, row in enumerate(adj[:n]):
        real = row[row < n]
        assert 1 <= len(real) <= cap and i not in real, i
        assert len(set(real.tolist())) == len(real), i
        assert (row[len(real):] == n).all(), i


def _jcfg(**over):
    return jbuild.BuildConfig(**{**CFG, **over})


def _tcfg(**over):
    return tbuild.BuildConfig(**{**CFG, **over})


# ---- the JAX builds (module-scoped: each compiles its steps once) ---------

@pytest.fixture(scope="module")
def j_wave(data):
    return jwave.build_index_wave(data[0], _jcfg(), wave_size=W)


@pytest.fixture(scope="module")
def j_ortho(data):
    return jwave.build_index_wave(data[0], _jcfg(ortho_count=2), wave_size=W)


@pytest.fixture(scope="module")
def j_extend(data):
    """The JAX wave build of the first SPLIT rows, which is its bootstrap
    (the one-shot bottom layer, and the start vertex from the level draws;
    the upper layers, which extension rebuilds over the whole corpus, are
    left out), and its JAX extension by the other rows."""
    x, cfg = data[0], _jcfg()
    vectors, norms = j_make_corpus(x[:SPLIT])
    boot = jbuild._build_layer(vectors[:SPLIT], norms[:SPLIT], cap=CAP, cfg=cfg)
    levels, max_layer, _ = jbuild.draw_levels(SPLIT, cfg.M, cfg.seed)
    assert max_layer > 1
    g0 = JGraphIndex(vectors=vectors, norms=norms, layers=(),
                     adj_bottom=jnp.concatenate([boot, jnp.full((1, boot.shape[1]), SPLIT, jnp.int32)]),
                     starting_vertex=jnp.int32(np.nonzero(levels >= max_layer - 1)[0][0]))
    return g0, jwave.extend_index_wave(g0, x[SPLIT:], cfg, wave_size=W)


@pytest.fixture(scope="module")
def t_wave(data):
    stats = {}
    g = twave.build_index_wave(data[0], _tcfg(), "cpu", wave_size=W, stats=stats)
    return g, stats


@pytest.fixture(scope="module")
def t_extend(data):
    x = data[0]
    g0 = twave.build_index_wave(x[:SPLIT], _tcfg(), "cpu", wave_size=W)
    return g0, twave.extend_index_wave(g0, x[SPLIT:], _tcfg(), wave_size=W)


# ---- (1) ortho scoring ----------------------------------------------------

def test_gather_score_ortho_matches_jax():
    """The penalized score of gathered rows against JAX's: random ids with
    sentinels among them (scored +inf, kept +inf), chosen points with
    invalid columns, bias -1 so that penalties change sign."""
    rng = np.random.default_rng(4)
    n, B, Kc, OC = 500, 64, 48, 3
    x = rng.standard_normal((n, D)).astype(np.float32)
    jv, jn = j_make_corpus(x)
    tv, tn = make_corpus(x, "cpu")
    ids = rng.integers(0, n + 1, (B, Kc)).astype(np.int32)
    ids[:, :3] = n
    q = np.pad(rng.standard_normal((B, D)).astype(np.float32), ((0, 0), (0, 128 - D)))
    chosen = rng.integers(0, n, (B, OC)).astype(np.int32)
    valid = rng.random((B, OC)) > 0.3
    for bias in (0.0, -1.0):
        tq = torch.from_numpy(q)
        ch = torch.from_numpy(chosen).long()
        t = _gather_score_ortho(tv, tn, torch.from_numpy(ids), tq, squared_norms(tq), tv[ch], tn[ch],
                                torch.from_numpy(valid), 0.5, bias).numpy()
        jq = jnp.asarray(q)
        j = np.asarray(j_gather_score_ortho(jv, jn, jnp.asarray(ids), jq, jnp.sum(jq * jq, 1), jv[chosen],
                                            jn[chosen], jnp.asarray(valid), 0.5, bias, "highest"))
        np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
        assert np.isinf(t[:, :3]).all()
        fin = np.isfinite(j)
        np.testing.assert_allclose(t[fin], j[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bias", [0.0, -1.0])
def test_ortho_beam_search_matches_jax(data, j_wave, bias):
    """beam_search with ortho_chosen on the JAX wave graph, loaded into the
    port: 256 wave-like queries (corpus rows) seeded by a beam of 40 ids,
    E=4 as in the wave builder, two chosen points a query (a third of the
    second column invalid).  At least 99% of the beams identical, their
    distances within rtol 1e-5, the per-query distance counts identical."""
    tg = _as_port(j_wave)
    rng = np.random.default_rng(9)
    B = 256
    rows = rng.choice(N, B, replace=False)
    q = np.asarray(j_wave.vectors)[rows]
    seeds = rng.integers(0, N, (B, EF)).astype(np.int32)
    seeds[::3, 5] = seeds[::3, 4]  # duplicate seeds are masked
    chosen = rng.integers(0, N, (B, 2)).astype(np.int32)
    valid = np.ones((B, 2), bool)
    valid[::3, 1] = False
    max_iters = 4 * EF + 32
    tq = torch.from_numpy(q)
    t_ids, t_d, t_n = beam_search(tg.vectors, tg.norms, tg.adj_bottom, tq, squared_norms(tq),
                                  torch.from_numpy(seeds), EF, max_iters, N, expand=4,
                                  ortho_chosen=torch.from_numpy(chosen), ortho_valid=torch.from_numpy(valid),
                                  ortho_bias=bias)
    jfn = jax.jit(functools.partial(j_beam_search, ef=EF, max_iters=max_iters, sentinel=N, expand=4))
    jq = jnp.asarray(q)
    out = jfn(j_wave.vectors, j_wave.norms, j_wave.adj_bottom, jq, jnp.sum(jq * jq, 1), jnp.asarray(seeds),
              ortho_chosen=jnp.asarray(chosen), ortho_valid=jnp.asarray(valid), ortho_factor=0.5, ortho_bias=bias)
    j_ids, j_d, j_n = (np.asarray(a) for a in out)
    t_ids, t_d, t_n = t_ids.numpy(), t_d.numpy(), t_n.numpy()
    same = (t_ids == j_ids).all(1)
    assert same.mean() >= 0.99, same.mean()
    fin = np.isfinite(j_d) & same[:, None]
    np.testing.assert_allclose(t_d[fin], j_d[fin], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(t_n, j_n)


@pytest.mark.parametrize("ef,kn", [(40, 320), (120, 16), (7, 7)])
def test_beam_dedup_equals_all_pairs_masks(ef, kn):
    """beam_search's dedup (a stable sort of beam ++ block by id, an entry
    masked when its predecessor has its id) against the JAX package's two
    all-pairs masks (search.py:270-276): identical masks, on ids with many
    repeats and sentinels, in the beam and in the block."""
    rng = np.random.default_rng(ef + kn)
    n = 50
    beam = torch.from_numpy(rng.integers(0, n + 1, (64, ef)).astype(np.int32))
    nbrs = torch.from_numpy(rng.integers(0, n + 1, (64, kn)).astype(np.int32))
    nbrs[::4, -3:] = n
    earlier = torch.ones((kn, kn), dtype=torch.bool).tril(-1)
    want = (nbrs[:, :, None] == beam[:, None, :]).any(-1) | ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier).any(-1)
    assert torch.equal(_earlier_dup(torch.cat([beam, nbrs], 1))[:, ef:], want)


def test_ortho_scoring_and_packed_are_exclusive(data):
    g = make_corpus(data[0][:50], "cpu")
    adj = torch.full((51, 16), 50, dtype=torch.int32)
    q = g[0][:2]
    with pytest.raises(ValueError):
        beam_search(g[0], g[1], adj, q, squared_norms(q), torch.zeros((2, 1), dtype=torch.int32), 8, 8, 50,
                    packed=torch.zeros((51, 16, 128)), ortho_chosen=torch.zeros((2, 1), dtype=torch.int32),
                    ortho_valid=torch.ones((2, 1), dtype=torch.bool))


# ---- (2) one wave, (3) one refinement wave, from identical state ----------

def _state(jg, n: int):
    """(adj, counts) of the working adjacency built from the JAX graph's
    bottom rows: its sentinel re-written to N, widened to R."""
    old = np.asarray(jg.adj_bottom)[: jg.n]
    adj = np.full((N + 1, R), N, np.int32)
    adj[: jg.n, : old.shape[1]] = np.where(old == jg.n, N, old)
    return adj, (adj != N).sum(1).astype(np.int32)


def _held(t_adj, t_counts, j_adj, j_counts, wave: np.ndarray) -> None:
    """The wave's rows identical on at least 99%, as are all rows; the
    counts identical on identical rows."""
    rows_same = (t_adj == j_adj).all(1)
    assert rows_same[wave].mean() >= 0.99, rows_same[wave].mean()
    assert rows_same.mean() >= 0.99, rows_same.mean()
    np.testing.assert_array_equal(t_counts[rows_same], j_counts[rows_same])


def _step_args(cfg, ef_c: int):
    return dict(cap=CAP, C=min(cfg.prune_cand, cfg.ef_construction), ef_c=ef_c, max_iters=4 * ef_c + 32,
                ortho_factor=cfg.ortho_factor, ortho_bias=cfg.ortho_bias, prune_overflow=cfg.prune_overflow,
                overflow_rows=cfg.wave_overflow_rows, precision="highest", expand=cfg.wave_expand, sentinel=N)


@pytest.mark.parametrize("ortho_count", [1, 2])
def test_wave_step_matches_jax(data, j_extend, ortho_count):
    """The first wave of an extension (rows SPLIT.. SPLIT+W inserted into the
    JAX wave build of the first SPLIT rows, its bootstrap) through each package's
    ``_wave_step``, from the same (adj, counts); with ortho_count=2 at
    ortho_bias=-1, so the penalized pass changes the candidates."""
    over = dict(ortho_count=ortho_count, ortho_bias=-1.0 if ortho_count > 1 else 0.0)
    jcfg, tcfg = _jcfg(**over), _tcfg(**over)
    g0 = j_extend[0]
    adj, counts = _state(g0, N)
    jv, jn = j_make_corpus(data[0])
    ids = np.arange(SPLIT, SPLIT + W, dtype=np.int32)
    ja, jc = jwave._wave_step(jv, jn, jnp.asarray(adj), jnp.asarray(counts), jnp.asarray(ids),
                              jnp.asarray(g0.starting_vertex).astype(jnp.int32),
                              ortho_count=ortho_count, **_step_args(jcfg, jcfg.ef_construction))
    tv, tn = make_corpus(data[0], "cpu")
    ta, tc = torch.from_numpy(adj.copy()), torch.from_numpy(counts.copy())
    twave._wave_step(tv, tn, ta, tc, torch.from_numpy(ids), torch.tensor(int(g0.starting_vertex), dtype=torch.int32),
                     CAP, min(tcfg.prune_cand, tcfg.ef_construction), tcfg.ef_construction,
                     4 * tcfg.ef_construction + 32, tcfg)
    _held(ta.numpy(), tc.numpy(), np.asarray(ja), np.asarray(jc), ids)
    assert (ta.numpy()[ids] != N).any(1).all()


def test_refine_step_matches_jax(data, j_wave):
    """The first refinement wave (rows 0.. W of the JAX wave graph, seeded by
    their rows and the start vertex) through each package's ``_refine_step``
    from the same (adj, counts)."""
    cfg = _jcfg()
    adj, counts = _state(j_wave, N)
    ids = np.arange(0, W, dtype=np.int32)
    ja, jc = jwave._refine_step(j_wave.vectors, j_wave.norms, jnp.asarray(adj), jnp.asarray(counts),
                                jnp.asarray(ids), jnp.asarray(j_wave.starting_vertex, jnp.int32),
                                **_step_args(cfg, cfg.ef_construction))
    tg = _as_port(j_wave)
    ta, tc = torch.from_numpy(adj.copy()), torch.from_numpy(counts.copy())
    tcfg = _tcfg()
    twave._refine_step(tg.vectors, tg.norms, ta, tc, torch.from_numpy(ids),
                       torch.tensor(tg.starting_vertex, dtype=torch.int32), CAP, tcfg.prune_cand,
                       tcfg.ef_construction, 4 * tcfg.ef_construction + 32, tcfg)
    _held(ta.numpy(), tc.numpy(), np.asarray(ja), np.asarray(jc), ids)


# ---- (4) the helpers shared with the distributed builder ------------------

def test_shared_helpers_match_jax_wave_module():
    """The distributed builder's row write, reverse scatter and overflow
    prunes against the JAX wave module's ``_write_forward``,
    ``_reverse_append`` and ``_overflow_prune`` on identical inputs: edges
    to five hubs that overflow the row width, mutual pairs that hit the
    edge-exists check, short rows, stopped selections.  Integer bookkeeping
    on the same sort orders: identical arrays."""
    rng = np.random.default_rng(11)
    n, Dd, cap, Rw, Wv = 400, 16, 8, 24, 128
    x = rng.standard_normal((n, Dd)).astype(np.float32)
    vec = np.concatenate([np.pad(x, ((0, 0), (0, 128 - Dd))), np.zeros((1, 128), np.float32)])
    nrm = np.concatenate([(x * x).sum(1), [np.inf]]).astype(np.float32)
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1).astype(np.float32)
    np.fill_diagonal(d2, np.inf)
    near = np.argsort(d2, axis=1, kind="stable")
    adj = np.full((n + 1, Rw), n, np.int32)
    adj[:n, :cap] = near[:, :cap]
    adj[:50, 5:cap] = n  # short rows
    counts = (adj != n).sum(1).astype(np.int32)
    src = np.arange(100, 100 + Wv, dtype=np.int32)
    sel = near[src, :cap].astype(np.int32)
    sel[:, -3:] = rng.integers(0, 5, (Wv, 3))  # hubs; repeats made sentinel below
    for r in range(Wv):
        seen = set()
        for c in range(cap):
            if sel[r, c] in seen or sel[r, c] == src[r]:
                sel[r, c] = n
            seen.add(int(sel[r, c]))
    sel_d = np.where(sel == n, np.inf, d2[src[:, None], np.minimum(sel, n - 1)]).astype(np.float32)
    sel_d[:10, 6:] = np.inf  # stopped selections
    sel[:10, 6:] = n

    write = jax.jit(jwave._write_forward, static_argnums=(4, 5))
    append = jax.jit(jwave._reverse_append, static_argnums=5)
    ja, jc = write(jnp.asarray(adj), jnp.asarray(counts), jnp.asarray(src), jnp.asarray(sel), cap, n)
    ja, jc = append(ja, jc, jnp.asarray(src), jnp.asarray(sel), jnp.asarray(sel_d), n)
    ta, tc = torch.from_numpy(adj.copy()), torch.from_numpy(counts.copy())
    tdist._write_rows(ta, tc, torch.from_numpy(src).long(), torch.from_numpy(sel))
    tdist._reverse_scatter(ta, tc, torch.from_numpy(src), torch.from_numpy(sel), torch.from_numpy(sel_d))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int((tc[:5] == Rw).sum()) == 5 and int((tc > cap).sum()) > 16  # hubs full, overflow real

    cfg = tbuild.BuildConfig(M=cap // 2, prune_overflow=1)
    prune = dict(cap=cap, ortho_factor=cfg.ortho_factor, ortho_bias=cfg.ortho_bias,
                 prune_overflow=cfg.prune_overflow, sentinel=n, precision="highest")
    jv, jn = jnp.asarray(vec), jnp.asarray(nrm)
    tv, tn = torch.from_numpy(vec), torch.from_numpy(nrm)
    top, rows = jax.lax.top_k(jc[:n], 16)  # the wave step's fullest rows
    ja, jc = jwave._overflow_prune_jit(jv, jn, ja, jc, jnp.where(top > cap, rows, n), **prune)
    tdist._prune_fullest(tv, tn, ta, tc, cap, cfg, 16)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

    over = np.nonzero(np.asarray(jc)[:n] > cap)[0].astype(np.int32)  # the final sweep
    assert over.size > 0
    ja, jc = jwave._overflow_prune_jit(jv, jn, ja, jc, jnp.asarray(over), **prune)
    assert twave._cap_sweep(tv, tn, ta, tc, cap, cfg, 7) == over.size
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int((tc[:n] > cap).sum()) == 0


# ---- (5) the JAX package's nine wave tests, each through both packages ----

def test_wave_build_recall_parity_with_oneshot(data, j_wave, t_wave):
    """Recall@10 >= 0.85, within 0.01 of the JAX wave graph's on the same
    data, and within 0.08 of the port's one-shot graph."""
    x, q, gt = data
    g, stats = t_wave
    r_port, r_jax = _recall(g, q, gt), _recall(_as_port(j_wave), q, gt)
    r_one = _recall(tbuild.build_index(x, _tcfg(), "cpu"), q, gt)
    assert r_port >= 0.85 and abs(r_port - r_jax) <= 0.01, (r_port, r_jax)
    assert r_port >= r_one - 0.08, (r_port, r_one)
    assert stats["waves"] == -(-(N - 2048) // W) and len(stats["wave_iterations"]) == stats["waves"]
    assert set(stats["seconds"]) == {"bootstrap", "waves", "cap_sweep", "upper"}


def test_wave_build_ortho_count_recall_parity_with_oneshot(data, j_ortho):
    """ortho_count=2 (the penalized beam passes): recall@10 >= 0.85, within
    0.01 of the JAX ortho wave graph's, within 0.08 of the one-shot ortho
    graph's."""
    x, q, gt = data
    g = twave.build_index_wave(x, _tcfg(ortho_count=2), "cpu", wave_size=W)
    r_port, r_jax = _recall(g, q, gt), _recall(_as_port(j_ortho), q, gt)
    r_one = _recall(tbuild.build_index(x, _tcfg(ortho_count=2), "cpu"), q, gt)
    assert r_port >= 0.85 and abs(r_port - r_jax) <= 0.01, (r_port, r_jax)
    assert r_port >= r_one - 0.08, (r_port, r_one)
    _invariants(g.adj_bottom.numpy(), N, CAP)


def test_wave_build_edge_caps_respected(j_wave, t_wave):
    """Both packages' wave graphs: degrees 1..M0, no self edge, no duplicate;
    the serving width round_up(M0, 16) and the all-sentinel last row."""
    for adj in (t_wave[0].adj_bottom.numpy(), np.asarray(j_wave.adj_bottom)):
        assert adj.shape == (N + 1, tbuild._round_up(CAP, 16))
        assert (adj[N] == N).all()
        _invariants(adj, N, CAP)


def test_wave_build_via_engine_builder_flag(data, j_wave, t_wave):
    """The engine with builder="wave" builds the graph build_index_wave
    builds (waves of 256 after the default 2048-row bootstrap), answers at
    recall@10 >= 0.85, within 0.01 of the JAX wave graph's."""
    x, q, gt = data
    eng = AntitopoEngine(config=AntitopoConfig(**CFG, ef_search=EF, builder="wave", wave_size=W), device="cpu")
    eng.store_many_vectors(x)
    eng.build()
    assert torch.equal(eng.graph.adj_bottom, t_wave[0].adj_bottom)
    assert eng.build_stats["waves"] == t_wave[1]["waves"]
    ans = eng.query_k_batch(q, K)
    r = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K for a, b in zip(ans, gt)]))
    r_jax = _recall(_as_port(j_wave), q, gt)
    assert r >= 0.85 and abs(r - r_jax) <= 0.01, (r, r_jax)


def test_wave_hierarchy_routing_isolated(data, j_wave, t_wave):
    """The upper layers, built after the bottom one, route as well as an
    oracle: the bottom beam from greedy descent's entries is within 0.03
    recall of the beam from each query's true nearest row, on both
    packages' graphs (searched by the port)."""
    _, q, gt = data
    for g in (t_wave[0], _as_port(j_wave)):
        assert len(g.layers) >= 1
        qp = torch.from_numpy(np.pad(q, ((0, 0), (0, 128 - D))))
        qn = squared_norms(qp)

        def bottom_recall(ep):
            ids = beam_search(g.vectors, g.norms, g.adj_bottom, qp, qn, ep, EF, 8 * EF + 16, N)[0][:, :K].numpy()
            return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K for a, b in zip(ids, gt)]))

        rec_hier = bottom_recall(descend(g, qp, qn)[0][:, None])
        rec_oracle = bottom_recall(torch.from_numpy(gt[:, :1].astype(np.int32)))
        assert rec_hier >= 0.85 and rec_hier >= rec_oracle - 0.03, (rec_hier, rec_oracle)


def test_extend_index_wave_accumulates(data, j_extend, t_extend, t_wave):
    """store -> build -> store -> build accumulates: the extended index holds
    both corpora, answers from both halves, recall@10 >= 0.85, within 0.01
    of the JAX extended graph's and within 0.08 of a from-scratch build;
    the caps and no duplicate hold everywhere; the old rows draw the
    original build's levels (prefix-stable draws)."""
    x, q, gt = data
    g0, g = t_extend
    assert g.n == N and torch.equal(g.vectors[:SPLIT], g0.vectors[:SPLIT])
    ids = query_batch(g, torch.from_numpy(np.pad(q, ((0, 0), (0, 128 - D)))), k=K, ef=EF)[0].numpy()
    assert (ids < SPLIT).any() and ((ids >= SPLIT) & (ids < N)).any()
    r_ext, r_jax, r_full = _recall(g, q, gt), _recall(_as_port(j_extend[1]), q, gt), _recall(t_wave[0], q, gt)
    assert r_ext >= 0.85 and abs(r_ext - r_jax) <= 0.01, (r_ext, r_jax)
    assert r_ext >= r_full - 0.08, (r_ext, r_full)
    _invariants(g.adj_bottom.numpy(), N, CAP)
    assert g.packed is None and g.codes is None

    def layer1(graph):  # the old rows' membership of the first upper layer
        return graph.layers[0].slot[:SPLIT] < graph.layers[0].adj.shape[0] - 1

    assert torch.equal(layer1(g), layer1(g0))


def test_engine_store_build_store_build(data, j_extend, t_extend):
    """The engine's second build after more stores extends the index by
    waves: the graph extend_index_wave gives, n grows, second-round vectors
    are answered, recall@10 >= 0.85 and within 0.01 of the JAX extended
    graph's; a dimension mismatch raises ValueError."""
    x, q, gt = data
    eng = AntitopoEngine(config=AntitopoConfig(**CFG, ef_search=EF, builder="wave", wave_size=W), device="cpu")
    eng.store_many_vectors(x[:SPLIT])
    eng.build()
    assert eng.n == SPLIT
    eng.store_many_vectors(x[SPLIT:])
    eng.build()
    assert eng.n == N and torch.equal(eng.graph.adj_bottom, t_extend[1].adj_bottom)
    assert eng.build_stats["waves"] == -(-(N - SPLIT) // W)
    ans = eng.query_k_batch(q, K)
    assert ((ans >= SPLIT) & (ans < N)).any(), "second-round vectors never returned"
    r = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K for a, b in zip(ans, gt)]))
    r_jax = _recall(_as_port(j_extend[1]), q, gt)
    assert r >= 0.85 and abs(r - r_jax) <= 0.01, (r, r_jax)
    eng.store_many_vectors(np.zeros((3, D + 1), np.float32))
    with pytest.raises(ValueError):
        eng.build()


def test_engine_extend_reattaches_codes(data):
    """With use_compression the codes are attached again after an
    extension, over the extended corpus."""
    x = data[0]
    eng = AntitopoEngine(config=AntitopoConfig(M=4, ef_construction=16, use_compression=True), device="cpu")
    eng.store_many_vectors(x[:300])
    eng.build()
    eng.store_many_vectors(x[300:400])
    eng.build()
    assert eng.n == 400 and eng.graph.codes.shape[0] == 401 and eng.graph.code_norms.shape == (401,)
    ans = eng.query_k_batch(x[300:310], 5)
    assert ans.shape == (10, 5) and (ans < 400).all()


@pytest.fixture(scope="module")
def weak(data):
    """A deliberately weak wave build (bootstrap 128, waves of 256) and its
    refinement of the first half, in each package."""
    x = data[0]
    jg = jwave.build_index_wave(x, _jcfg(), wave_size=W, bootstrap=128)
    jr = jwave.refine_index_wave(jg, _jcfg(), frac=0.5, wave_size=W)
    tg = twave.build_index_wave(x, _tcfg(), "cpu", wave_size=W, bootstrap=128)
    stats = {}
    tr = twave.refine_index_wave(tg, _tcfg(), frac=0.5, wave_size=W, stats=stats)
    return jg, jr, tg, tr, stats


def test_refine_pass_improves_weak_prefix(data, weak):
    """Refinement of the weak build's first half loses at most 0.01 recall
    and reaches >= 0.85, in both packages; the port's refined graph is
    within 0.01 of the JAX refined graph's."""
    _, q, gt = data
    jg, jr, tg, tr, stats = weak
    r0, r1 = _recall(tg, q, gt), _recall(tr, q, gt)
    j0, j1 = _recall(_as_port(jg), q, gt), _recall(_as_port(jr), q, gt)
    assert r1 >= r0 - 0.01 and r1 >= 0.85, (r0, r1)
    assert j1 >= j0 - 0.01, (j0, j1)
    assert abs(r1 - j1) <= 0.01, (r1, j1)
    assert stats["waves"] == -(-(N // 2) // W)


def test_refine_pass_row_invariants(weak, t_wave):
    """Refined rows keep the invariants (no self edge, no duplicate, degrees
    1..M0, sentinel padding): both packages' refinements of the weak build's
    first half, and the port's of every row of the default wave build."""
    _invariants(weak[3].adj_bottom.numpy(), N, CAP)
    _invariants(np.asarray(weak[1].adj_bottom), N, CAP)
    full = twave.refine_index_wave(t_wave[0], _tcfg(), frac=1.0, wave_size=W)
    _invariants(full.adj_bottom.numpy(), N, CAP)


# ---- (6) prefix-stable level draws ----------------------------------------

@pytest.mark.parametrize("n,m,M", [(3000, 2100, 8), (1000, 1, 12), (56000, 28000, 60)])
def test_draw_levels_prefix_stable(n, m, M):
    """The first m draws of an n-row corpus are an m-row corpus's draws, in
    both packages alike."""
    lv_n, _, _ = tbuild.draw_levels(n, M)
    lv_m, _, _ = tbuild.draw_levels(m, M)
    np.testing.assert_array_equal(lv_n[:m], lv_m)
    np.testing.assert_array_equal(lv_n, jbuild.draw_levels(n, M)[0])


# ---- the tools --------------------------------------------------------------

def test_bench_1m_and_refine_1m_tools(tmp_path):
    """bench_1m with --builder wave --refine-frac on the CPU at 2500 rows
    (cache in a temporary directory, named apart from the distributed
    build's), then refine_1m on the index it saved."""
    common = ["--device", "cpu", "--n", "2500", "--m", "20", "--d", "16", "--M", "6", "--efc", "32",
              "--skip-flat", "--ef-list", "40", "--cache", str(tmp_path)]
    res = bench_1m.main(common + ["--builder", "wave", "--refine-frac", "0.5"])
    build = next(r for r in res if r["point"] == "build")
    refine = next(r for r in res if r["point"] == "refine")
    assert build["builder"] == "wave" and build["waves"] == 1 and build["flat_topk_launches"] == 0
    assert refine["waves"] == 2 and res[-1]["recall"] >= 0.8
    files = sorted(p.name for p in tmp_path.glob("idx_*.npz"))
    assert files == ["idx_M6_efc32_gaussian_n2500_wave_rf0.5.npz"]
    out = tmp_path / "refined.npz"
    st = refine_1m.main(["--idx", str(tmp_path / files[0]), "--out", str(out), "--M", "6", "--efc", "32",
                         "--wave", "512", "--device", "cpu"])
    assert out.exists() and st["waves"] == 3
