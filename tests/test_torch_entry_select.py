"""The entry seeds' selection (``ops/entry.py``) on the CPU: the plain
version against an independent (distance, position) oracle and against
a full stable sort of the distance matrix, the wrapper's checks, and
``entry_beam``'s seeds on every layout of the fused route.  K5 itself
runs on the card (tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.models.layout import CodeBlocks, Rows
from expann_tpu_torch.models.search import entry_beam, entry_members
from expann_tpu_torch.ops import _kernels, entry
from expann_tpu_torch.ops.distance import squared_norms
from expann_tpu_torch.ops.entry import S_MAX, entry_select, entry_select_plain

torch.set_num_threads(2)


def _inputs(B, n, seed, ties, tail=0):
    """``(G, xn, qn, members)`` of B queries over n members.  With ``ties``
    the operands are small integers (the s8 layout's exact distances), so
    many distances repeat; the last ``tail`` members are the sentinel
    (norm +inf, a zero row)."""
    rng = np.random.default_rng(seed)
    if ties:
        x = rng.integers(-2, 3, (n, 8)).astype(np.float32)
        q = rng.integers(-2, 3, (B, 8)).astype(np.float32)
    else:
        x = rng.standard_normal((n, 16)).astype(np.float32)
        q = rng.standard_normal((B, 16)).astype(np.float32)
    if tail:
        x[n - tail :] = 0.0
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    xn = squared_norms(xt)
    if tail:
        xn[n - tail :] = float("inf")
    members = torch.from_numpy(rng.permutation(10 * n)[:n].astype(np.int32))
    return qt @ xt.T, xn, squared_norms(qt), members


def _oracle(G, xn, qn, members, S):
    """numpy f32: d = (xn + qn) - 2 G, the S least by (d, position)."""
    g, x, q = G.numpy(), xn.numpy(), qn.numpy()
    d = (x[None, :] + q[:, None]) - np.float32(2.0) * g
    pos = np.broadcast_to(np.arange(d.shape[1]), d.shape)
    order = np.lexsort((pos, d), axis=1)[:, :S]
    return np.take_along_axis(d, order, 1), members.numpy()[order]


def _sorted_seeds(G, xn, qn, members, S, EF):
    """Beams of width EF seeded by the elementwise passes and a full stable
    sort of the distance matrix, the rest at (+inf, -7)."""
    B = G.shape[0]
    bd0 = torch.full((B, EF), float("inf"))
    bi0 = torch.full((B, EF), -7, dtype=torch.int32)
    md = (xn[None, :] + qn[:, None]) - 2.0 * G
    seed_d, idx = torch.sort(md, dim=1, stable=True)
    bd0[:, :S] = seed_d[:, :S]
    bi0[:, :S] = members[idx[:, :S]]
    return bd0, bi0


CASES = [  # (B, n, ties, tail)
    (7, 1024, True, 91),
    (5, 37, True, 0),
    (9, 200, True, 3),
    (3, 1000, False, 40),
    (4, 4100, True, 128),
    (1, 96, False, 0),
]


@pytest.mark.parametrize("B,n,ties,tail", CASES)
@pytest.mark.parametrize("S", [1, 8, "n"])
def test_plain_matches_the_oracle_and_the_full_sort(B, n, ties, tail, S):
    S = n if S == "n" else min(S, n)
    G, xn, qn, members = _inputs(B, n, seed=n + B, ties=ties, tail=tail)
    d, ids = entry_select_plain(G, xn, qn, members, S)
    od, oi = _oracle(G, xn, qn, members, S)
    np.testing.assert_array_equal(d.numpy(), od)
    np.testing.assert_array_equal(ids.numpy(), oi)
    if ties:  # the ties the order has to keep are there
        assert len(np.unique(od[0])) < S or S == 1
    pd, pi = _sorted_seeds(G, xn, qn, members, S, EF=max(S, 16))
    assert torch.equal(d, pd[:, :S]) and torch.equal(ids, pi[:, :S])


@pytest.mark.parametrize("B,n,ties,tail", CASES[:4])
def test_wrapper_on_cpu_runs_the_plain_version(B, n, ties, tail, monkeypatch):
    """The seeds land in the first S columns; the rest of the beams is left
    as it was; no kernel is launched."""

    def no_kernel(*a, **kw):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(entry, "entry_select_cuda", no_kernel)
    G, xn, qn, members = _inputs(B, n, seed=7 * n, ties=ties, tail=tail)
    S, EF = min(8, n), 128
    bd0 = torch.full((B, EF), float("inf"))
    bi0 = torch.full((B, EF), -7, dtype=torch.int32)
    before = _kernels.launches["entry_select"]
    entry_select(G, xn, qn, members, S, bd0, bi0)
    assert _kernels.launches["entry_select"] == before
    pd, pi = _sorted_seeds(G, xn, qn, members, S, EF)
    assert torch.equal(bd0, pd) and torch.equal(bi0, pi)


def _bad(case):
    """The wrapper's arguments with one of them broken."""
    G, xn, qn, members = _inputs(6, 64, seed=3, ties=True)
    bd0 = torch.full((6, 128), float("inf"))
    bi0 = torch.zeros((6, 128), dtype=torch.int32)
    S = 8
    if case == "G_dtype":
        G = G.double()
    elif case == "members_dtype":
        members = members.long()
    elif case == "bd0_dtype":
        bd0 = bd0.half()
    elif case == "xn_shape":
        xn = xn[:-1]
    elif case == "qn_shape":
        qn = qn[:-1]
    elif case == "G_dim":
        G = G[None]
    elif case == "beam_rows":
        bd0, bi0 = bd0[:-1], bi0[:-1]
    elif case == "beam_narrow":
        bd0, bi0 = bd0[:, :4], bi0[:, :4]
    elif case == "S_above_cap":
        G, xn, qn, members = _inputs(6, 64, seed=3, ties=True)
        S = S_MAX + 1
    elif case == "S_above_n":
        G, xn, qn, members = G[:, :5].contiguous(), xn[:5], qn, members[:5]
    elif case == "S_zero":
        S = 0
    elif case == "G_strided":
        G = G.T.contiguous().T
    elif case == "xn_device":
        xn = xn.to("meta")
    elif case == "G_device":
        G, xn, qn, members, bd0, bi0 = (t.to("meta") for t in (G, xn, qn, members, bd0, bi0))
    return G, xn, qn, members, S, bd0, bi0


BAD = {
    "G_dtype": TypeError, "members_dtype": TypeError, "bd0_dtype": TypeError, "xn_shape": ValueError,
    "qn_shape": ValueError, "G_dim": ValueError, "beam_rows": ValueError, "beam_narrow": ValueError,
    "S_above_cap": ValueError, "S_above_n": ValueError, "S_zero": ValueError, "G_strided": ValueError,
    "xn_device": ValueError, "G_device": ValueError,
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    G, xn, qn, members, S, bd0, bi0 = _bad(case)
    assert not G.is_cuda
    with pytest.raises(BAD[case]):
        entry_select(G, xn, qn, members, S, bd0, bi0)


@pytest.fixture(scope="module")
def small_graph():
    """A 1500-row index with entry members, its bf16 blocks built, and 40
    queries padded to its width."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1500, 32)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((40, 32)).astype(np.float32))
    cfg = AntitopoConfig(M=8, ef_construction=40, prune_cand=40, query_expand=2, fused_cand=8, entry_seeds=8,
                         use_packed=True, use_fused=True)
    eng = AntitopoEngine(config=cfg, device="cpu")
    eng.store_many_vectors(x)
    eng.build()
    eng._layout()
    assert entry_members(eng.graph) is not None and eng.graph.entry_members_n > 8
    return eng.graph, torch.nn.functional.pad(q, (0, eng.graph.vectors.shape[1] - 32))


@pytest.mark.parametrize("layout", ["bf16", "s8", "rows"])
def test_entry_beam_seeds_are_the_full_sorts(small_graph, layout, monkeypatch):
    """``entry_beam`` on bf16 blocks, s8 blocks (code-space distances) and
    the rows layout: the full stable sort's seeds, 8 of them, the rest of
    the beam at (+inf, sentinel)."""
    g, q = small_graph
    if layout == "s8":
        monkeypatch.setattr(g, "layout", CodeBlocks.build(g))
    elif layout == "rows":
        monkeypatch.setattr(g, "layout", Rows.build(g))
    bd0, bi0, cost = entry_beam(g, q, 128, 8)
    mem = g.entry_members.long()
    if layout == "s8":
        qk, data, norms = g.layout.kernel_query(q), g.layout.codes, g.layout.code_norms
    else:
        qk, data, norms = q, g.vectors, g.norms
    pd, pi = _sorted_seeds(qk @ data[mem].float().T, norms[mem], squared_norms(qk), g.entry_members, 8, 128)
    pi[:, 8:] = g.sentinel
    assert cost == g.entry_members_n
    assert torch.equal(bd0, pd) and torch.equal(bi0, pi)
    assert bool((bi0[:, :8] < g.sentinel).all())
