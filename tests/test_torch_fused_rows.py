"""The rows layout and the traversal over it (``ops/fused.fused_search_rows``,
``ops/packed.build_rows``), on the CPU against the block traversal.

K1-rows reads each expanded node's neighbour rows from the corpus by id
where K1 reads the node's packed block; both score the same rows in the
same order, so over the same graph their beams, distances and iteration
counts are identical, and only ``ncomp`` differs: RS a node against the
non-sentinel rows.  The engine builds the rows layout where the blocks
would pass ``PACKED_BUDGET_BYTES`` (``serving_layout``).
"""

import numpy as np
import pytest
import torch

from expann_tpu_torch.models import antitopo, search
from expann_tpu_torch.models.antitopo import PACKED_BUDGET_BYTES, AntitopoConfig, AntitopoEngine, serving_layout
from expann_tpu_torch.ops.fused import fused_search_plain, fused_search_rows, fused_search_rows_plain, topt_for
from expann_tpu_torch.ops.packed import build_packed, build_rows, packed_bytes, packed_widths, rows_bytes

K = 10


def _graph(n, R, d, seed):
    """A random graph over N(0, 1) rows with the zero sentinel row; every
    fifth node's last third of neighbours is the sentinel."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    vecs = torch.from_numpy(np.concatenate([x, np.zeros((1, d), np.float32)]))
    norms = (vecs * vecs).sum(1)
    norms[n] = float("inf")
    adj = np.stack([rng.choice(n, size=R, replace=False) for _ in range(n)] + [np.full(R, n)]).astype(np.int32)
    adj[::5, R - R // 3 :] = n
    return vecs, norms, torch.from_numpy(adj), rng


def _seeds(vecs, q, n, EF, rng):
    B = q.shape[0]
    bd0 = torch.full((B, EF), float("inf"))
    bi0 = torch.full((B, EF), n, dtype=torch.int32)
    seeds = torch.from_numpy(rng.integers(0, n, size=(B, 3)).astype(np.int32))
    bi0[:, :3] = seeds
    bd0[:, :3] = ((q[:, None, :] - vecs[seeds.long()]) ** 2).sum(-1)
    return bd0, bi0


# (d, R, E, cand, EF, ef): the canonical width and GIST's (unpadded), E 1 and 2
CASES = [(128, 40, 2, 8, 128, 100), (128, 20, 1, 4, 128, 64), (960, 24, 2, 8, 128, 120), (960, 40, 2, 16, 256, 200)]


@pytest.mark.parametrize("d,R,E,cand,EF,ef", CASES)
def test_rows_plain_matches_blocks_plain(d, R, E, cand, EF, ef):
    """The plain K1-rows against the plain K1 over the blocks packed from
    the same graph: beams, distances and iterations identical; K1 counts
    RS a expanded node, K1-rows the node's non-sentinel slots.  Each
    query runs alone as well, so its expanded nodes are known."""
    n, B = 600, 12
    vecs, norms, adj, rng = _graph(n, R, d, seed=d + R + E)
    packed, pn, pi = build_packed(vecs, norms, adj)
    rows, rn, ri = build_rows(vecs, norms, adj)
    assert torch.equal(rn, pn) and torch.equal(ri, pi) and rows.dtype == torch.bfloat16
    assert torch.equal(rows[n].float(), torch.zeros(d))
    rs = packed.shape[1]
    assert rs == packed_widths(R)[0]
    q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32))
    bd0, bi0 = _seeds(vecs, q, n, EF, rng)
    topt = topt_for(cand, E, rs)
    got = fused_search_rows_plain(rows, rn, ri, rs, q, bd0, bi0, ef, E, topt, 8 * ef + 16)
    ref = fused_search_plain(packed, pn, pi, q, bd0, bi0, ef, E, topt, 8 * ef + 16)
    for name, a, b in zip(("ids", "dist", "iters"), (got[0], got[1], got[3]), (ref[0], ref[1], ref[3])):
        assert torch.equal(a, b), name
    assert bool((got[3] >= 2).all())
    real = (pi[:, :rs] != n).sum(1)
    for b in range(B):
        seen = torch.zeros(n + 1, dtype=torch.bool)
        one = fused_search_rows_plain(rows, rn, ri, rs, q[b : b + 1], bd0[b : b + 1], bi0[b : b + 1], ef, E, topt,
                                      8 * ef + 16, expanded=seen)
        assert torch.equal(one[0][0], got[0][b])
        assert int(got[2][b]) == int(real[seen].sum()) == int(one[2][0])
        assert int(ref[2][b]) == rs * int(seen.sum())
    assert int(got[2].sum()) < int(ref[2].sum())  # every fifth node has sentinel slots


def test_rows_dispatch_takes_the_plain_version_on_cpu():
    """``fused_search_rows`` on CPU tensors is its plain version, with
    ``topt`` from ``cand`` and the default iteration cap."""
    n, R, d, EF, ef = 300, 24, 64, 128, 50
    vecs, norms, adj, rng = _graph(n, R, d, seed=3)
    rows, rn, ri = build_rows(vecs, norms, adj)
    q = torch.from_numpy(rng.standard_normal((5, d)).astype(np.float32))
    bd0, bi0 = _seeds(vecs, q, n, EF, rng)
    rs = packed_widths(R)[0]
    got = fused_search_rows(rows, rn, ri, rs, q, bd0, bi0, ef, expand=2, cand=8)
    ref = fused_search_rows_plain(rows, rn, ri, rs, q, bd0, bi0, ef, 2, topt_for(8, 2, rs), 8 * ef + 16)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def wide():
    """3000 rows of 960 dims (padded to 1024 on the index) and 40 queries."""
    rng = np.random.default_rng(21)
    return rng.standard_normal((3000, 960)).astype(np.float32), rng.standard_normal((40, 960)).astype(np.float32)


def _engine(x, **knobs):
    cfg = AntitopoConfig(M=8, ef_construction=40, prune_cand=40, query_expand=2, fused_cand=8, entry_seeds=8,
                         ef_search=40, **knobs)
    eng = AntitopoEngine(config=cfg, device="cpu")
    eng.store_many_vectors(x)
    eng.build()
    return eng


def test_engine_takes_the_rows_route_over_the_budget(wide, monkeypatch):
    """With the budget below the blocks and above the rows, the engine
    builds the rows layout, every chunk takes the rows traversal and counts
    its rows and queries, and the lists equal the block route's on the same
    graph."""
    x, q = wide
    calls = []  # each rows traversal's count of the rows it read
    real = search.fused_search_rows

    def counted(*a, **kw):
        out = real(*a, **kw)
        calls.append(int(out[2].sum()))
        return out

    monkeypatch.setattr(search, "fused_search_rows", counted)
    eng = _engine(x, use_packed=True, use_fused=True, query_block=16)
    blocks = eng.query_k_batch(q, K)
    g = eng.graph
    assert g.packed is not None and g.packed_rows is None and not calls
    assert eng.num_rows_gathered == 0 and eng.num_queries == 40
    np1, r, d = g.vectors.shape[0], g.adj_bottom.shape[1], g.vectors.shape[1]
    assert d == 1024
    monkeypatch.setattr(antitopo, "PACKED_BUDGET_BYTES", rows_bytes(np1, d))
    assert packed_bytes(np1, r, d, "bf16") > antitopo.PACKED_BUDGET_BYTES
    g.drop_packed()
    eng.set_ef_search(40)
    got = eng.query_k_batch(q, K)
    assert g.packed is None and g.packed_rows is not None and g.packed_rows.shape == (np1, d)
    assert len(calls) == 3  # chunks of 16, 16 and 8
    np.testing.assert_array_equal(got, blocks)
    assert eng.num_queries == 40
    # every query expands at least its entry: the rows it read, fewer than
    # RS a node but more than none, and the traversals' own count
    assert eng.num_rows_gathered == sum(calls)
    assert 40 * 16 < eng.num_rows_gathered < eng.num_distcomps
    for row in got:
        assert len(set(row.tolist())) == K


def test_rows_layout_sends_small_chunks_to_the_gather_beam(wide, monkeypatch):
    """The per-iteration route needs blocks: on the rows layout it takes the
    f32 gather beam, and returns what an engine without a layout returns."""
    x, q = wide
    eng = _engine(x, use_packed=True, use_fused=False)
    monkeypatch.setattr(antitopo, "PACKED_BUDGET_BYTES", rows_bytes(eng.graph.vectors.shape[0], 1024))
    got = eng.query_k_batch(q[:8], K)
    assert eng.graph.packed_rows is not None and eng.num_rows_gathered == 0
    eng.graph.drop_packed()
    eng.cfg.use_packed = False
    np.testing.assert_array_equal(got, eng.query_k_batch(q[:8], K))


# (N+1, R, D, dtype): canonical 56k (bf16 and s8 blocks), sift1m-clustered
# (s8, as served, and bf16), GIST1M at its padded width (bf16, s8), 20M
# rows of 128 dims
SHAPES = [(56001, 128, 128, "bf16"), (56001, 128, 128, "i8"), (1000001, 96, 128, "i8"), (1000001, 96, 128, "bf16"),
          (1000001, 96, 1024, "bf16"), (1000001, 96, 1024, "i8"), (20000001, 96, 128, "bf16")]


@pytest.mark.parametrize("np1,r,d,dtype", SHAPES)
def test_layout_follows_the_budget(np1, r, d, dtype):
    """Under the real budget: blocks exactly where ``packed_bytes`` fits,
    and otherwise the rows for bf16 (their bytes fit at every shape here)
    and no layout for s8."""
    fits = packed_bytes(np1, r, d, dtype) <= PACKED_BUDGET_BYTES
    assert rows_bytes(np1, d) <= PACKED_BUDGET_BYTES
    assert serving_layout(np1, r, d, dtype) == ("blocks" if fits else "rows" if dtype == "bf16" else None)


def test_gist_shape_takes_rows_and_small_engines_take_blocks(wide):
    assert serving_layout(1000001, 96, 1024, "bf16") == "rows"
    assert serving_layout(1000001, 96, 128, "i8") == "blocks"
    x, q = wide
    eng = _engine(x, use_packed=True, use_fused=True)
    eng.query_k_batch(q[:4], K)
    assert eng.graph.packed is not None and eng.graph.packed_rows is None


@pytest.mark.parametrize("knobs", [dict(use_packed=True, use_fused=True), dict(use_packed=True, use_fused=True,
                                                                                 query_wire="i8"), dict()],
                         ids=["fused_bf16_wire", "fused_i8_wire", "gather"])
def test_queries_narrower_than_the_index_are_padded_on_the_device(wide, knobs):
    """960-dim queries on the 1024-wide index: padded after the upload, they
    return what the same queries padded on the host return, on either
    route and either wire."""
    x, q = wide
    eng = _engine(x, **knobs)
    np.testing.assert_array_equal(eng.query_k_batch(q, K), eng.query_k_batch(np.pad(q, ((0, 0), (0, 64))), K))
