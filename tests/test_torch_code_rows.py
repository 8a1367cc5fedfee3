"""The code rows layout and K1-rows-s8's plain version (``ops/packed.
build_code_rows``, ``models/layout.CodeRows``, ``ops/fused.
fused_search_rows`` over int8 rows), on the CPU.

Over the same graph the code rows hold the s8 blocks' codes, norms and ids,
and the traversal scores the same rows in the same order as K1-s8, so below
D = 512, where both are exact, their beams, distances and iterations are
identical.  Above it K1-s8's f32 combination ``|x|^2 + |q|^2 - 2 q.x``
passes 2^24 and rounds; K1-rows-s8 keeps every distance an exact integer.
The engine builds the code rows where s8 blocks pass ``PACKED_BUDGET_BYTES``
and the code rows do not.
"""

import numpy as np
import pytest
import torch

from expann_tpu_torch.models import antitopo
from expann_tpu_torch.models import layout as layouts
from expann_tpu_torch.models.antitopo import PACKED_BUDGET_BYTES, AntitopoConfig, AntitopoEngine
from expann_tpu_torch.models.layout import CodeBlocks, CodeRows, choose
from expann_tpu_torch.models.search import entry_beam
from expann_tpu_torch.ops.fused import (fused_search_plain, fused_search_rows, fused_search_rows_plain,
                                        topt_for)
from expann_tpu_torch.ops.packed import (build_code_rows, build_packed_i8, code_rows_bytes, neighbour_rows,
                                         packed_bytes, packed_widths)

torch.set_num_threads(2)

K = 10


def _graph(n, R, d, seed, short=True):
    """N(0, 1) rows with the zero sentinel row and a random graph; with
    ``short`` every fifth node's last third of neighbours is the
    sentinel."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    vecs = torch.from_numpy(np.concatenate([x, np.zeros((1, d), np.float32)]))
    adj = np.stack([rng.choice(n, size=R, replace=False) for _ in range(n)] + [np.full(R, n)]).astype(np.int32)
    if short:
        adj[::5, R - R // 3 :] = n
    return vecs, torch.from_numpy(adj), rng


def _code_seeds(codes, qk, n, EF, rng):
    """Three random seeds a query at their exact code-space distances."""
    B = qk.shape[0]
    bd0 = torch.full((B, EF), float("inf"))
    bi0 = torch.full((B, EF), n, dtype=torch.int32)
    seeds = torch.from_numpy(rng.integers(0, n, size=(B, 3)).astype(np.int32))
    bi0[:, :3] = seeds
    bd0[:, :3] = ((qk[:, None, :] - codes[seeds.long()].float()) ** 2).sum(-1)
    return bd0, bi0


def test_code_rows_hold_the_s8_blocks_codes_bit_for_bit():
    """One recipe: the code rows' codes, norms, transform, norm and id rows
    are the s8 blocks' (``build_packed_i8``), bit for bit; the layout
    builds them with RS aligned to 32, as the s8 blocks are."""
    n, R, d = 500, 40, 96
    vecs, adj, _ = _graph(n, R, d, seed=7)
    packed, pn, pi, codes, cn, center, scale = build_packed_i8(vecs, adj)
    rows, rn, ri, rcn, rcenter, rscale = build_code_rows(vecs, adj)
    for name, a, b in (("codes", rows, codes), ("norms", rn, pn), ("ids", ri, pi), ("code_norms", rcn, cn),
                       ("center", rcenter, center), ("scale", rscale, scale)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert rows.dtype == torch.int8 and float(rcn[n]) == float("inf")
    assert torch.equal(rcn[:n], (rows[:n].long() ** 2).sum(1).float())
    # the layout types over a graph's own corpus: the same arrays
    g = type("G", (), {"vectors": vecs, "adj_bottom": adj})()
    cr, cb = CodeRows.build(g), CodeBlocks.build(g)
    assert cr.rs == packed.shape[1] == packed_widths(R, 32)[0]
    for name in ("codes", "code_norms", "norms", "ids", "center", "scale"):
        assert torch.equal(getattr(cr, name), getattr(cb, name)), name
    assert cr.code_space and cr.counts_rows and cr.beam_blocks is None
    q = torch.from_numpy(np.random.default_rng(1).standard_normal((4, d)).astype(np.float32))
    assert torch.equal(cr.kernel_query(q), cb.kernel_query(q))


# (R, E, cand, EF, ef, short): full neighbour lists (RS = R, so both count
# the same rows) and lists with sentinel slots; E 1 and 2
CASES = [(64, 2, 8, 128, 100, False), (32, 1, 4, 128, 64, False), (40, 2, 8, 128, 120, True),
         (96, 2, 16, 256, 200, True)]


@pytest.mark.parametrize("R,E,cand,EF,ef,short", CASES)
def test_code_rows_plain_matches_s8_blocks_plain(R, E, cand, EF, ef, short):
    """At d=128, where K1-s8's f32 distances are exact too: the plain
    K1-rows-s8 against the plain K1-s8 over the blocks of the same graph,
    beams, distances and iterations identical; with full neighbour lists
    the distance computations too, else the code rows count each expanded
    node's non-sentinel rows where the blocks count RS."""
    n, B, d = 600, 12, 128
    vecs, adj, rng = _graph(n, R, d, seed=R + E, short=short)
    packed, pn, pi, codes, _, center, scale = build_packed_i8(vecs, adj)
    rows, rn, ri, *_ = build_code_rows(vecs, adj)
    rs = packed.shape[1]
    q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32))
    qk = torch.clamp(torch.round((q - center) * scale), -127.0, 127.0)
    bd0, bi0 = _code_seeds(codes, qk, n, EF, rng)
    topt = topt_for(cand, E, rs)
    got = fused_search_rows_plain(rows, rn, ri, rs, qk, bd0, bi0, ef, E, topt, 8 * ef + 16)
    ref = fused_search_plain(packed, pn, pi, qk, bd0, bi0, ef, E, topt, 8 * ef + 16)
    for name, a, b in zip(("ids", "dist", "iters"), (got[0], got[1], got[3]), (ref[0], ref[1], ref[3])):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert bool((got[3] >= 2).all())
    if short:
        assert int(got[2].sum()) < int(ref[2].sum())
    else:
        assert torch.equal(got[2], ref[2])
    assert torch.equal(fused_search_rows(rows, rn, ri, rs, qk, bd0, bi0, ef, expand=E, cand=cand)[0], got[0])


D = 1024
FULL = 127 * 127 * D  # |q|^2 of the all-127 query: 16,516,096


def _tie_layout(order):
    """Four s8 code rows at D=1024 around the all-127 query: S all -127 (the
    seed, at the widest distance 4 * 127^2 * 1024), A one code 126 (d = 1),
    B two codes 126 (d = 2), a filler all 0; S's neighbours in ``order``
    (ids of A and B), the others' none.  For A, |x|^2 + |q|^2 =
    33,031,939 is odd and above 2^24, so f32 rounds it up by one and A's
    f32 distance is B's, 2: the f32 combination ties them and its (d, row)
    order takes whichever comes first in S's list."""
    n = 4
    codes = torch.zeros((n + 1, D), dtype=torch.int8)
    codes[0] = -127
    codes[1] = 127
    codes[1, 5] = 126
    codes[2] = 127
    codes[2, 5:7] = 126
    cn = (codes.long() ** 2).sum(1).float()
    cn[n] = float("inf")
    adj = torch.full((n + 1, 32), n, dtype=torch.int32)
    adj[0, : len(order)] = torch.tensor(order, dtype=torch.int32)
    norms, ids = neighbour_rows(cn, adj, 32)
    return codes, cn, norms, ids


@pytest.mark.parametrize("order", [[2, 1], [1, 2]], ids=["b_first", "a_first"])
def test_exact_distances_past_2_24_rank_by_the_integers(order):
    """K1-rows-s8's plain version at D=1024, ef=1 from the seed S: A
    (exact distance 1) wins over B (2) whichever row of S's list holds it,
    though the f32 combination ties them at 2 (checked here) and, taking
    the first row on the tie, would keep B when B comes first.  The
    distances returned are the exact integers."""
    codes, cn, norms, ids = _tie_layout(order)
    n = codes.shape[0] - 1
    q = torch.full((3, D), 127.0)
    assert int(cn[0]) == FULL and 2**24 < int(cn[1]) + FULL < 2**25
    xf = codes[:2 + 1].float()
    f32 = (cn[:3] + torch.tensor(float(FULL))) - 2.0 * (xf @ q[0])
    assert f32[1] == f32[2] == 2.0 and int(cn[1]) + FULL - 2 * int((xf[1] @ q[0]).item()) == 1
    EF = 128
    bd0 = torch.full((3, EF), float("inf"))
    bi0 = torch.full((3, EF), n, dtype=torch.int32)
    bi0[:, 0] = 0
    bd0[:, 0] = float(4 * FULL)
    got = fused_search_rows(codes, norms, ids, 32, q, bd0, bi0, 1, expand=1, cand=2)
    assert got[0][:, 0].tolist() == [1, 1, 1] and got[1][:, 0].tolist() == [1.0, 1.0, 1.0]
    assert got[3].tolist() == [3, 3, 3] and got[2].tolist() == [2 + 0, 2, 2]
    # ef=2 keeps both, each at its own integer distance
    two = fused_search_rows(codes, norms, ids, 32, q, bd0, bi0, 2, expand=1, cand=2)
    assert sorted(zip(two[1][0, :2].tolist(), two[0][0, :2].tolist())) == [(1.0, 1), (2.0, 2)]


def test_exact_distances_refuse_a_width_past_the_exact_norms():
    """The code norms are exact integers in f32 only to D=1024; the plain
    version refuses wider rows as the kernel does."""
    codes = torch.zeros((3, D + 16), dtype=torch.int8)
    norms, ids = neighbour_rows(torch.tensor([0.0, 0.0, float("inf")]), torch.full((3, 16), 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="D <= 1024"):
        fused_search_rows(codes, norms, ids, 16, torch.zeros((1, D + 16)), torch.zeros((1, 128)),
                          torch.zeros((1, 128), dtype=torch.int32), 4)


# (N+1, R, D, dtype): the shapes of tests/test_torch_fused_rows.py, GIST1M
# in s8 (1M x 960 padded to 1024), and s8 rows past the exact width
SHAPES = [(56001, 128, 128, "bf16", layouts.Blocks), (56001, 128, 128, "i8", CodeBlocks),
          (1000001, 96, 128, "i8", CodeBlocks), (1000001, 96, 128, "bf16", layouts.Blocks),
          (1000001, 96, 1024, "bf16", layouts.Rows), (1000001, 96, 1024, "i8", CodeRows),
          (20000001, 96, 128, "bf16", layouts.Rows), (1000001, 96, 2048, "i8", None)]


@pytest.mark.parametrize("np1,r,d,dtype,kind", SHAPES)
def test_choose_under_the_real_budget(np1, r, d, dtype, kind):
    """s8 blocks where they fit, else the s8 code rows up to D=1024; GIST1M
    in s8 (98 GB of blocks, 1.02 GB of code rows) takes the code rows."""
    assert choose(np1, r, d, dtype, PACKED_BUDGET_BYTES) is kind
    if kind is CodeRows:
        assert packed_bytes(np1, r, d, "i8") > PACKED_BUDGET_BYTES >= code_rows_bytes(np1, d)
        assert choose(np1, r, d, dtype, code_rows_bytes(np1, d) - 1) is None


@pytest.fixture(scope="module")
def narrow():
    """2000 rows of 128 dims and 40 queries."""
    rng = np.random.default_rng(25)
    return rng.standard_normal((2000, 128)).astype(np.float32), rng.standard_normal((40, 128)).astype(np.float32)


def _engine(x, **knobs):
    cfg = AntitopoConfig(M=8, ef_construction=40, prune_cand=40, query_expand=2, fused_cand=8, entry_seeds=8,
                         ef_search=40, packed_dtype="i8", **knobs)
    eng = AntitopoEngine(config=cfg, device="cpu")
    eng.store_many_vectors(x)
    eng.build()
    return eng


def test_engine_takes_the_code_rows_route_over_the_budget(narrow, monkeypatch):
    """With the budget below the s8 blocks and at the code rows, the engine
    builds the code rows, every chunk takes the code-rows traversal and
    counts its rows and queries, and the lists equal the s8 block route's
    on the same graph (d=128: both exact)."""
    x, q = narrow
    calls = []
    real = layouts.fused_search_rows

    def counted(*a, **kw):
        out = real(*a, **kw)
        calls.append(int(out[2].sum()))
        return out

    monkeypatch.setattr(layouts, "fused_search_rows", counted)
    eng = _engine(x, use_packed=True, use_fused=True, query_block=16)
    blocks = eng.query_k_batch(q, K)
    g = eng.graph
    assert type(g.layout) is CodeBlocks and not calls and eng.num_rows_gathered == 0
    np1, r, d = g.vectors.shape[0], g.adj_bottom.shape[1], g.vectors.shape[1]
    monkeypatch.setattr(antitopo, "PACKED_BUDGET_BYTES", code_rows_bytes(np1, d))
    assert packed_bytes(np1, r, d, "i8") > antitopo.PACKED_BUDGET_BYTES
    g.layout = None
    eng.set_ef_search(40)
    got = eng.query_k_batch(q, K)
    assert type(g.layout) is CodeRows and g.packed is None and g.packed_rows.dtype == torch.int8
    assert len(calls) == 3  # chunks of 16, 16 and 8
    np.testing.assert_array_equal(got, blocks)
    assert eng.num_queries == 40 and eng.num_rows_gathered == sum(calls)
    assert 40 * 8 < eng.num_rows_gathered < eng.num_distcomps


def test_code_rows_send_small_chunks_to_the_gather_beam(narrow, monkeypatch):
    """The per-iteration route has no code-space block scorer: on the code
    rows it takes the f32 gather beam and returns what an engine without a
    layout returns, reading no rows."""
    x, q = narrow
    eng = _engine(x, use_packed=True, use_fused=False)
    monkeypatch.setattr(antitopo, "PACKED_BUDGET_BYTES", code_rows_bytes(eng.graph.vectors.shape[0], 128))
    got = eng.query_k_batch(q[:8], K)
    assert type(eng.graph.layout) is CodeRows and eng.num_rows_gathered == 0
    eng.graph.layout = None
    eng.cfg.use_packed = False
    np.testing.assert_array_equal(got, eng.query_k_batch(q[:8], K))


def test_code_rows_seed_as_the_s8_blocks_do_at_d1024():
    """The entry scan in code space at D=1024, where its f32 sums may round
    above 2^24: the code rows' seeds equal the s8 blocks' on the same graph
    (one scan over the same operands), and the plain selection's over the
    scan's product."""
    from expann_tpu_torch.ops.entry import entry_select_plain

    rng = np.random.default_rng(9)
    x = rng.standard_normal((1500, 960)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((24, 960)).astype(np.float32))
    cfg = AntitopoConfig(M=8, ef_construction=40, prune_cand=40, entry_seeds=8, packed_dtype="i8")
    eng = AntitopoEngine(config=cfg, device="cpu")
    eng.store_many_vectors(x)
    eng.build()
    g = eng.graph
    qp = torch.nn.functional.pad(q, (0, 64))
    g.layout = CodeRows.build(g)
    rows_seeds = entry_beam(g, qp, 128, 8)
    g.layout = CodeBlocks.build(g)
    assert g.entry_members is not None
    blocks_seeds = entry_beam(g, qp, 128, 8)
    for a, b in zip(rows_seeds[:2], blocks_seeds[:2]):
        assert torch.equal(a, b)
    qk = g.layout.kernel_query(qp)
    mem = g.entry_members
    bd, bi = entry_select_plain(qk @ g.layout.codes[mem.long()].float().T, g.layout.code_norms[mem.long()],
                                (qk * qk).sum(1), mem, 8)
    assert torch.equal(rows_seeds[0][:, :8], bd) and torch.equal(rows_seeds[1][:, :8], bi)
