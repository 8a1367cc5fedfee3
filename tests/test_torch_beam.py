"""The port's per-iteration graph route against the JAX package: the packed
block scorer (K4's plain version against the Pallas kernel in interpret
mode), ``beam_search`` in gather and packed mode, ``query_batch``, the
engines on that route, and the chunk routing rule; and the replayed route's
blocks of iterations against one iteration a read."""

import dataclasses
import functools
import gc
import inspect
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from expann_tpu.models.antitopo import AntitopoConfig as JConfig
from expann_tpu.models.antitopo import AntitopoEngine as JEngine
from expann_tpu.models.search import beam_search as j_beam_search
from expann_tpu.models.search import query_batch as j_query_batch
from expann_tpu.ops.pallas_beam import build_packed as j_build_packed
from expann_tpu.ops.pallas_beam import packed_score as j_packed_score
from expann_tpu.utils.persist import load_index as j_load_index
from expann_tpu.utils.persist import save_index as j_save_index
from expann_tpu_torch.data.loader import load_synthetic_uniform_sphere_points
from expann_tpu_torch.models import antitopo as t_antitopo
from expann_tpu_torch.models import search as t_search
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine, route_fused
from expann_tpu_torch.models.brute_force import BruteForceEngine
from expann_tpu_torch.models.search import beam_search, query_batch
from expann_tpu_torch.ops.packed import build_packed, packed_score
from expann_tpu_torch.ops.distance import squared_norms
from expann_tpu_torch.utils.persist import load_index

torch.set_num_threads(2)

N, D, K, EF = 800, 32, 10, 40
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((40, D)).astype(np.float32)
    d2 = ((q[:, None] - x[None]) ** 2).sum(-1)
    return x, q, np.argsort(d2, axis=1, kind="stable")[:, :K]


@pytest.fixture(scope="module")
def index(data, tmp_path_factory):
    """One JAX-built index (M=12, ef_construction=60) on disk, loaded into
    both packages with their packed layouts (bf16)."""
    x, _, _ = data
    eng = JEngine(config=JConfig(M=12, ef_construction=60, seed=0))
    eng.store_many_vectors(x)
    eng.build()
    path = str(tmp_path_factory.mktemp("idx") / "index.npz")
    j_save_index(path, eng.graph, {"dim": D})
    jg, _ = j_load_index(path)
    jp, ja = j_build_packed(jg.vectors, jg.norms, jg.adj_bottom)
    jg = dataclasses.replace(jg, packed=jp, packed_aux=ja)
    tg, _ = load_index(path, "cpu")
    tg.packed, tg.packed_norms, tg.packed_ids = build_packed(tg.vectors, tg.norms, tg.adj_bottom)
    return path, jg, tg


def _toy_packed(dtype, seed, vecs=None):
    """n=300 rows of D=32 padded to 128, r=40 (RS=48 < R_tile=128), with
    short rows (sentinel tails) and a few rows of three neighbours; the rows
    are N(0, 1) unless ``vecs`` (301, 128) gives them, sentinel row last."""
    n, r = 300, 40
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    if vecs is None:
        vecs = np.concatenate([np.pad(x, ((0, 0), (0, 128 - D))), np.zeros((1, 128), np.float32)])
    norms = np.concatenate([(vecs[:n] ** 2).sum(1), [np.inf]]).astype(np.float32)
    adj = np.stack([rng.choice(n, size=r, replace=False) for _ in range(n)] + [np.full(r, n)]).astype(np.int32)
    adj[::7, -9:] = n
    adj[::11, 3:] = n
    tdt, jdt = DTYPES[dtype]
    t = build_packed(torch.from_numpy(vecs), torch.from_numpy(norms), torch.from_numpy(adj), dtype=tdt)
    j = j_build_packed(jnp.asarray(vecs), jnp.asarray(norms), jnp.asarray(adj), dtype=jdt)
    return rng, n, t, j


def _hold_to_jax_kernel(t, j, sel, q, topt):
    """K4's plain version against the Pallas kernel in interpret mode on the
    same packed arrays, selections and queries: ids identical (including the
    lane-0 id of passes past a row's finite slots), distances within the
    tolerance of tests/test_pallas_beam.py (sums in another order).  Returns
    the plain version's ``(d, ids)`` as numpy arrays."""
    (packed, pn, pi), (jp, ja) = t, j
    B, E = sel.shape
    td, ti = packed_score(packed, pn, pi, torch.from_numpy(sel), torch.from_numpy(q), topt=topt)
    jd, ji = j_packed_score(jp, ja, jnp.asarray(sel), jnp.asarray(q), topt=topt, interpret=True)
    jd, ji = np.asarray(jd), np.asarray(ji)
    assert td.shape == jd.shape == (B, E * (topt or 128))
    np.testing.assert_array_equal(ti.numpy(), ji)
    fin = np.isfinite(jd)
    assert (np.isfinite(td.numpy()) == fin).all()
    np.testing.assert_allclose(td.numpy()[fin], jd[fin], rtol=2e-5, atol=1e-3)
    if topt:  # passes past the finite slots: +inf with the node's lane-0 id
        past = ~fin.reshape(B, E, topt)
        lane0 = pi.numpy()[sel][:, :, :1].repeat(topt, 2)
        np.testing.assert_array_equal(ti.numpy().reshape(B, E, topt)[past], lane0[past])
    return td.numpy(), ti.numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("topt", [0, 8])
@pytest.mark.parametrize("E", [1, 2, 4])
def test_packed_score_matches_jax_kernel(dtype, topt, E):
    """Same packed arrays, selections and queries through K4's plain version
    and the Pallas kernel in interpret mode (``_hold_to_jax_kernel``)."""
    rng, n, t, j = _toy_packed(dtype, seed=E + topt)
    B = 8
    sel = rng.integers(0, n + 1, (B, E)).astype(np.int32)
    sel[::3, -1] = n  # sentinel selections
    sel[1, 0] = 0  # a row of three neighbours
    q = np.pad(rng.standard_normal((B, D)).astype(np.float32), ((0, 0), (0, 128 - D)))
    _hold_to_jax_kernel(t, j, sel, q, topt)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("topt", [0, 8])
def test_packed_score_negative_distances_match_jax_kernel(dtype, topt):
    """Queries that are scaled copies of a selected node's neighbours, so
    that 2 q.x > |x|^2: the partial distances of those blocks go negative
    (no |q|^2, no clamp), and the order must still be the (d, lane) order."""
    rng, n, t, j = _toy_packed(dtype, seed=20 + topt)
    B, E = 8, 2
    sel = rng.integers(0, n, (B, E)).astype(np.int32)
    sel[3, 1] = n
    rows = t[0][sel[:, 0], rng.integers(0, 3, B)].float().numpy()  # a neighbour of each first node
    q = 3.0 * rows
    d, _ = _hold_to_jax_kernel(t, j, sel, q, topt)
    assert (d < 0).sum() >= B


@pytest.mark.parametrize("topt", [1, 16, 128])
def test_packed_score_topt_widths_match_jax_kernel(topt):
    """One pass, 16 passes, and as many passes as R_tile (every slot of the
    node, the +inf ones by the lane-0 rule)."""
    rng, n, t, j = _toy_packed("bf16", seed=30 + topt)
    B, E = 8, 2
    sel = rng.integers(0, n + 1, (B, E)).astype(np.int32)
    sel[::3, -1] = n
    sel[1, 0] = 0
    q = np.pad(rng.standard_normal((B, D)).astype(np.float32), ((0, 0), (0, 128 - D)))
    _hold_to_jax_kernel(t, j, sel, q, topt)


@pytest.mark.parametrize("topt", [0, 8, 128])
def test_packed_score_all_tie_block_matches_jax_kernel(topt):
    """Every row is a copy of one integer-valued vector, so every finite
    slot of a node has the same distance, exactly: the ids come out in lane
    order, in both versions."""
    v = np.zeros((1, 128), np.float32)
    v[0, :D] = np.arange(D) % 5 - 2
    vecs = np.concatenate([np.repeat(v, 300, axis=0), np.zeros((1, 128), np.float32)])
    rng, n, t, j = _toy_packed("bf16", seed=40 + topt, vecs=vecs)
    B, E = 8, 2
    sel = rng.integers(0, n, (B, E)).astype(np.int32)
    sel[1, 0] = 0  # a row of three neighbours
    q = np.pad(rng.integers(-3, 4, (B, D)).astype(np.float32), ((0, 0), (0, 128 - D)))
    d, ids = _hold_to_jax_kernel(t, j, sel, q, topt)
    w = topt or 128
    d, ids = d.reshape(B, E, w), ids.reshape(B, E, w)
    fin = np.isfinite(d)
    assert (np.where(fin, d, d[:, :, :1]) == d[:, :, :1]).all()
    lanes = t[2].numpy()[sel][:, :, :w]
    np.testing.assert_array_equal(ids[fin], lanes[fin])


def _agreement(t_ids, j_ids, sentinel):
    """Share of rows whose id sets agree, and the mean overlap of real ids."""
    same = np.mean([set(a) == set(b) for a, b in zip(t_ids, j_ids)])
    overlap = np.mean(
        [len((set(a) & set(b)) - {sentinel}) / max(1, len(set(b) - {sentinel})) for a, b in zip(t_ids, j_ids)]
    )
    return same, overlap


@pytest.mark.parametrize("mode,expand", [("gather", 1), ("gather", 2), ("packed0", 1), ("packed8", 2)])
def test_beam_search_matches_jax(data, index, mode, expand):
    """beam_search of both packages from the same entry points on the same
    index: whole-beam agreement on at least 7 of 8 queries, overlap of the
    real entries >= 0.99, distance counts within 1%.  The two libraries sum
    in another order and the JAX merge sort need not be stable, so a
    near-tie may resolve differently."""
    _, q, _ = data
    _, jg, tg = index
    rng = np.random.default_rng(expand)
    qp = np.pad(q, ((0, 0), (0, 128 - D)))
    ep = rng.integers(0, N, (q.shape[0], 1)).astype(np.int32)
    ep[::4] = int(jg.starting_vertex)
    packed = mode != "gather"
    topt = 8 if mode == "packed8" else 0
    max_iters = 8 * EF + 16
    tq = torch.from_numpy(qp)
    t_ids, t_d, t_n = beam_search(
        tg.vectors, tg.norms, tg.adj_bottom, tq, squared_norms(tq), torch.from_numpy(ep), EF, max_iters, N,
        expand=expand, packed=tg.packed if packed else None, packed_norms=tg.packed_norms,
        packed_ids=tg.packed_ids, packed_topt=topt,
    )
    jfn = jax.jit(
        functools.partial(
            j_beam_search, ef=EF, max_iters=max_iters, sentinel=N, expand=expand,
            packed=jg.packed if packed else None, packed_aux=jg.packed_aux if packed else None,
            packed_topt=topt, interpret=True,
        )
    )
    jq = jnp.asarray(qp)
    j_ids, j_d, j_n = (np.asarray(a) for a in jfn(jg.vectors, jg.norms, jg.adj_bottom, jq, jnp.sum(jq * jq, 1),
                                                  jnp.asarray(ep)))
    t_ids, t_d, t_n = t_ids.numpy(), t_d.numpy(), t_n.numpy()
    same, overlap = _agreement(t_ids, j_ids, N)
    assert same >= 7 / 8, same
    assert overlap >= 0.99, overlap
    assert abs(int(t_n.sum()) - int(j_n.sum())) <= 0.01 * int(j_n.sum())
    both = (t_ids == j_ids) & np.isfinite(j_d)
    np.testing.assert_allclose(t_d[both], j_d[both], rtol=1e-4, atol=1e-3)
    for row in t_ids:
        real = row[row < N]
        assert len(set(real.tolist())) == len(real)


class _EagerBlock(t_search._BeamGraph):
    """The captured block as ``BEAM_BLOCK`` eager steps on the same static
    buffers: the replayed route's loop where nothing can be captured."""

    def _capture(self, dev):
        return None

    def replay(self):
        for _ in range(t_search.BEAM_BLOCK):
            self.step()


@pytest.mark.parametrize("max_iters", [11, 8 * EF + 19])
@pytest.mark.parametrize("E", [1, 2])
@pytest.mark.parametrize("topt", [0, 8])
@pytest.mark.parametrize("U", [1, 2, 4, 8])
def test_blocks_of_iterations_match_one_read_an_iteration(data, index, monkeypatch, U, topt, E, max_iters):
    """The replayed route's loop (blocks of U iterations, one ``done`` read a
    block, eager steps where fewer than U are left before ``max_iters``)
    over the packed plain scorer: the beams, distances and counts of one
    read an iteration, bit for bit, since a done query is inert; the
    iterations run are the last query's end rounded up to a block, or the
    tail's.  ``max_iters`` 11 cuts every beam short; 339 is no multiple of
    U and lets every query end."""
    _, q, _ = data
    _, _, tg = index
    rng = np.random.default_rng(U + topt + E)
    qp = torch.from_numpy(np.pad(q, ((0, 0), (0, 128 - D))))
    ep = torch.from_numpy(rng.integers(0, N, (q.shape[0], 1)).astype(np.int32))
    args = (tg.vectors, tg.norms, tg.adj_bottom, qp, squared_norms(qp), ep, EF, max_iters, N)
    kw = dict(expand=E, packed=tg.packed, packed_norms=tg.packed_norms, packed_ids=tg.packed_ids, packed_topt=topt)
    one, blocks = [], []
    want = beam_search(*args, **kw, iters=one)
    monkeypatch.setattr(t_search, "BEAM_BLOCK", U)
    monkeypatch.setattr(t_search, "_BeamGraph", _EagerBlock)
    monkeypatch.setattr(t_search, "_replays", lambda q, packed, ortho_chosen: packed is not None)
    graphs = {}
    got = beam_search(*args, **kw, iters=blocks, graphs=graphs)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    rounded = -(-one[0] // U) * U
    assert blocks[0] == (rounded if rounded <= max_iters else one[0]), (one, blocks)
    assert (one[0] == max_iters) == (max_iters == 11)
    # the results are the caller's, not the static buffers the next call loads
    (g,) = graphs.values()
    assert {t.data_ptr() for t in got}.isdisjoint(t.data_ptr() for t in g.state.fields())
    again = beam_search(*args, **kw, graphs=graphs)
    assert len(graphs) == 1 and all(torch.equal(a, b) for a, b in zip(again, want))


@pytest.mark.parametrize("U", [1, 4])
def test_batches_share_a_padded_capture(data, index, monkeypatch, U):
    """Batches of 7, 5, 8, 5, 3 and 1 queries through one cache, the odd
    calls cut short by ``max_iters`` 11: a batch is captured at the power of
    two at or above it (8, 4 and 1 here), and the rows past it are reset to
    inert beams on every load, so a row that the last call left unfinished
    neither changes the lists (the eager loop's, bit for bit) nor keeps the
    loop running (its iterations are the eager loop's rounded up to a
    block)."""
    _, q, _ = data
    _, _, tg = index
    rng = np.random.default_rng(U)
    qp = torch.from_numpy(np.pad(q, ((0, 0), (0, 128 - D))))
    kw = dict(expand=2, packed=tg.packed, packed_norms=tg.packed_norms, packed_ids=tg.packed_ids, packed_topt=8)
    calls = []
    for i, b in enumerate((7, 5, 8, 5, 3, 1)):
        start = int(rng.integers(0, q.shape[0] - b))
        ep = torch.from_numpy(rng.integers(0, N, (b, 1)).astype(np.int32))
        qb = qp[start : start + b]
        calls.append((tg.vectors, tg.norms, tg.adj_bottom, qb, squared_norms(qb), ep, EF, 11 if i % 2 == 0 else 8 * EF + 19, N))
    one = []
    want = [beam_search(*args, **kw, iters=one) for args in calls]
    monkeypatch.setattr(t_search, "BEAM_BLOCK", U)
    monkeypatch.setattr(t_search, "_BeamGraph", _EagerBlock)
    monkeypatch.setattr(t_search, "_replays", lambda q, packed, ortho_chosen: packed is not None)
    graphs, blocks = {}, []
    for args, w in zip(calls, want):
        got = beam_search(*args, **kw, graphs=graphs, iters=blocks)
        for a, b in zip(got, w):
            assert a.shape == b.shape and torch.equal(a, b)
        pad = list(graphs.values())[-1].state
        b = args[3].shape[0]
        assert bool((pad.ids[b:] == N).all() & (pad.ncomp[b:] == 0).all() & pad.done[b:].all())
    assert [k[0] for k in graphs] == [8, 4, 1]
    assert one[::2] == [11] * 3 and max(one[1::2]) < 8 * EF + 19 - U
    assert blocks == [min(-(-n // U) * U, args[7]) for n, args in zip(one, calls)], (one, blocks)


def test_captured_beams_go_with_the_packed_arrays(data, index, monkeypatch):
    """``query_batch`` keeps the captured beams on the index it serves: a
    copy made by ``dataclasses.replace`` starts without them, and
    ``drop_packed`` frees them with the arrays they read."""
    _, q, _ = data
    _, _, tg = index
    monkeypatch.setattr(t_search, "_BeamGraph", _EagerBlock)
    monkeypatch.setattr(t_search, "_replays", lambda q, packed, ortho_chosen: packed is not None)
    g = dataclasses.replace(tg)
    qp = torch.from_numpy(np.pad(q[:3], ((0, 0), (0, 128 - D))))
    want = query_batch(g, qp, K, EF, use_packed=True, packed_topt=8)
    (captured,) = g.beam_graphs.values()
    assert tg.beam_graphs is None and dataclasses.replace(g).beam_graphs is None
    again = query_batch(g, qp, K, EF, use_packed=True, packed_topt=8)
    assert all(torch.equal(a, b) for a, b in zip(again, want)) and list(g.beam_graphs.values()) == [captured]
    ref = weakref.ref(captured)
    del captured
    g.drop_packed()
    gc.collect()
    assert g.beam_graphs is None and ref() is None


@pytest.mark.parametrize("use_packed", [False, True])
def test_query_batch_matches_jax(data, index, use_packed):
    """Descent, beam and (packed) rerank: top-k agreement on at least 7 of 8
    queries, overlap >= 0.99, recall within 0.005, distance counts within
    1%."""
    _, q, gt = data
    _, jg, tg = index
    qp = np.pad(q, ((0, 0), (0, 128 - D)))
    t_ids, _, t_n = query_batch(tg, torch.from_numpy(qp), K, EF, expand=2, use_packed=use_packed, packed_topt=8)
    j_ids, _, j_n = j_query_batch(jg, jnp.asarray(qp), k=K, ef=EF, expand=2, use_packed=use_packed,
                                  packed_topt=8, interpret=True)
    t_ids, j_ids = t_ids.numpy(), np.asarray(j_ids)
    same, overlap = _agreement(t_ids, j_ids, N)
    assert same >= 7 / 8 and overlap >= 0.99, (same, overlap)
    assert abs(_recall(t_ids, gt) - _recall(j_ids, gt)) <= 0.005
    assert _recall(t_ids, gt) >= 0.9
    assert abs(int(t_n.sum()) - int(np.asarray(j_n).sum())) <= 0.01 * int(np.asarray(j_n).sum())


def _recall(ids, gt):
    return np.mean([len(set(a[:K].tolist()) & set(b.tolist())) / K for a, b in zip(ids, gt)])


def _engines(path, **knobs):
    """Both engines serving the index file with the same query knobs."""
    common = dict(M=12, ef_search=EF, query_expand=2, index_filename=path, read_index=True, **knobs)
    jeng = JEngine(config=JConfig(**common))
    jeng.build()
    teng = AntitopoEngine(config=AntitopoConfig(**common), device="cpu")
    teng.build()
    return jeng, teng


@pytest.mark.parametrize(
    "knobs", [dict(use_packed=True, use_fused=False), dict()], ids=["packed_per_iteration", "defaults_gather"]
)
def test_engines_per_iteration_route_match(data, index, knobs):
    """``query_k`` and a 40-query batch through both engines on the
    per-iteration route: with use_packed=True, use_fused=False (K4's route),
    and with the defaults, which on the CPU take the gather beam in both
    packages."""
    x, q, gt = data
    path, _, _ = index
    jeng, teng = _engines(path, **knobs)
    assert teng._resolve_packed() == bool(knobs)
    for i in (5, 123, 777):
        assert teng.query_k(x[i], K) == jeng.query_k(x[i], K)
    assert teng.query_k(q[0], K)[:5] == jeng.query_k(q[0], K)[:5]
    assert abs(teng.num_distcomps - jeng.num_distcomps) <= 0.01 * jeng.num_distcomps
    teng.set_ef_search(EF)
    jeng.set_ef_search(EF)
    t_ids, j_ids = teng.query_k_batch(q, K), jeng.query_k_batch(q, K)
    same, overlap = _agreement(t_ids, j_ids, N)
    assert same >= 7 / 8 and overlap >= 0.99, (same, overlap)
    assert abs(_recall(t_ids, gt) - _recall(j_ids, gt)) <= 0.005
    assert abs(teng.num_distcomps - jeng.num_distcomps) <= 0.01 * jeng.num_distcomps
    for row in t_ids:
        assert len(set(row.tolist())) == K


# (real, query_block, use_fused resolved, use_fused is True, fused_qt) -> fused,
# worked by hand from expann_tpu/models/antitopo.py:467-488
ROUTES = [
    ((1, 1024, True, False, 128), False),  # bucket 8
    ((8, 1024, True, False, 128), False),
    ((9, 1024, True, False, 128), False),  # bucket 16
    ((32, 16384, True, False, 128), False),
    ((64, 1024, True, False, 128), False),  # bucket 64
    ((65, 1024, True, False, 128), True),  # bucket 128
    ((128, 1024, True, False, 128), True),
    ((400, 16384, True, False, 128), True),  # bucket 512
    ((1, 1024, True, True, 128), True),  # use_fused=True fuses every chunk
    ((1, 1024, False, False, 128), False),
    ((500, 1024, False, True, 128), False),  # fused needs packed
    ((3000, 3000, True, False, 128), True),  # bucket 4096 capped at 3000
    ((100, 3000, True, False, 128), True),  # bucket 128
    ((100, 100, True, False, 128), False),  # bucket 128 capped at 100
    ((3000, 3000, True, False, 4096), False),  # the cap stays below fused_qt
    ((17, 1024, True, False, 32), True),  # bucket 32
]


@pytest.mark.parametrize("args,fused", ROUTES)
def test_route_fused_matches_jax_rule(args, fused):
    assert route_fused(*args) is fused


@pytest.mark.parametrize("use_fused,route", [(True, "fused"), (False, "iter"), ("auto", "iter")])
def test_engine_routes_every_chunk(data, index, monkeypatch, use_fused, route):
    """query_k_batch sends each chunk (query_block=16, so 16/16/8 rows) to
    the route the rule picks; on the CPU "auto" resolves to off."""
    _, q, _ = data
    path, _, _ = index
    seen = []
    for name, tag in (("fused_query_batch", "fused"), ("query_batch", "iter")):
        real = getattr(t_antitopo, name)

        def spy(graph, qc, *a, _real=real, _tag=tag, **kw):
            seen.append((_tag, qc))
            return _real(graph, qc, *a, **kw)

        monkeypatch.setattr(t_antitopo, name, spy)
    cfg = AntitopoConfig(M=12, ef_search=EF, query_expand=2, query_block=16, index_filename=path, read_index=True,
                         use_packed=True, use_fused=use_fused)
    eng = AntitopoEngine(config=cfg, device="cpu")
    eng.build()
    eng.query_k_batch(q, K)
    assert [(r, qc.shape[0]) for r, qc in seen] == [(route, 16), (route, 16), (route, 8)]
    # the per-iteration route takes the f32 query as it is; the fused
    # route's wire rounds it to bf16
    sent = torch.cat([qc for _, qc in seen])
    want = torch.from_numpy(np.pad(q, ((0, 0), (0, 128 - D))))
    if route == "fused":
        want = want.to(torch.bfloat16).float()
    assert sent.dtype == torch.float32 and torch.equal(sent, want)


def test_device_defaults_to_the_card(tmp_path):
    for fn in (AntitopoEngine, BruteForceEngine, load_synthetic_uniform_sphere_points):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    eng = AntitopoEngine(8, 40, 1, 0, False)  # the reference's positional signature
    flat = BruteForceEngine(mode="fused")
    assert eng.device.type == flat.device.type == "cuda"
    if not torch.cuda.is_available():  # no card: reaching it raises, never falls back
        eng.store_many_vectors(np.zeros((20, 8), np.float32))
        flat.store_many_vectors(np.zeros((20, 8), np.float32))
        for call in (eng.build, flat.build):
            with pytest.raises((RuntimeError, AssertionError)):
                call()
        with pytest.raises((RuntimeError, AssertionError)):
            load_synthetic_uniform_sphere_points(50, 5, 3, 8, cache_dir=str(tmp_path))
