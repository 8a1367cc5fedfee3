"""The byte count of the fused traversal's bound
(``tools/perf_fused_search.traversal_bytes`` / ``traversal_bound``), and the
plain version's record of the blocks a call expands
(``fused_search_plain(expanded=)``, ``expanded_blocks``), on the CPU: every
input byte once, however often the call expands a block."""

import numpy as np
import pytest
import torch

from expann_tpu_torch.ops.fused import fused_search_plain, topt_for
from expann_tpu_torch.ops.packed import pack_blocks
from expann_tpu_torch.tools.perf_fused_search import expanded_blocks, traversal_bound, traversal_bytes

# the canonical widths: RS = R_tile = D = 128, EF = 128, 16384 queries
IO = 16384 * (128 * 4 + 2 * 128 * 8 + 8)


@pytest.mark.parametrize("elem,block", [(2, 128 * 128 * 2 + 2 * 128 * 4), (1, 128 * 128 + 2 * 128 * 4)])
def test_traversal_bytes_counts_each_block_once(elem, block):
    """The 56000 blocks the call expands with their norm and id rows once,
    plus the queries (f32), the beams in and out and two counts a query;
    the gathered bytes a block an expansion."""
    once, gathered = traversal_bytes(1_982_464, 56000, 128, 128, 128, elem, 16384, 128)
    assert once == 56000 * block + IO
    assert gathered == 1_982_464 * block


@pytest.mark.parametrize("expansions", [0, 1, 1000, 56000])
def test_traversal_bytes_of_a_call_that_reads_few_blocks(expansions):
    """A call that expands each of its blocks once reads those alone: once
    and gathered agree but for the queries and beams."""
    once, gathered = traversal_bytes(expansions, expansions, 128, 128, 128, 2, 8, 128)
    assert gathered == expansions * (128 * 128 * 2 + 2 * 128 * 4)
    assert once == gathered + 8 * (128 * 4 + 2 * 128 * 8 + 8)


def test_traversal_bytes_takes_the_layouts_widths():
    """RS and D set the block, R_tile its norm and id rows, EF the beams."""
    once, gathered = traversal_bytes(10, 7, 32, 64, 128, 1, 3, 256)
    assert gathered == 10 * (32 * 64 + 2 * 128 * 4)
    assert once == 7 * (32 * 64 + 2 * 128 * 4) + 3 * (64 * 4 + 2 * 256 * 8 + 8)


def test_traversal_bound_takes_the_larger_term():
    """bf16 at the canonical call is bound by bytes (~0.58 ms); a call that
    expands a few blocks many times over is bound by operations."""
    b = traversal_bound(1_982_464, 56000, 128, 128, 128, "bf16", 16384, 128)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == b["bytes_bound_ms"]
    assert b["bound_ms"] == pytest.approx(b["once_bytes"] / 3.35e12 * 1e3)
    assert 0.5 < b["bound_ms"] < 0.7
    assert b["operations_bound_ms"] == pytest.approx(2.0 * 1_982_464 * 128 * 128 / 989e12 * 1e3)
    s = traversal_bound(10**9, 2, 128, 128, 128, "s8", 1, 128)
    assert s["bound_by"] == "operations" and s["bound_ms"] == s["operations_bound_ms"]
    assert s["operations_bound_ms"] == pytest.approx(2.0 * 10**9 * 128 * 128 / 1979e12 * 1e3)


def _traversal(s8, B, seed=0, n=400, R=24, d=32, EF=32):
    """A random layout (every fifth node's last neighbours the sentinel) and
    B queries seeded from four random entries each: the plain version's
    arguments at ef = 24, E = 2, cand = 8."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n + 1, d)).astype(np.float32)
    x[n] = 0
    rows = torch.from_numpy(np.round(x * 20) if s8 else x)
    norms = (rows * rows).sum(1)
    norms[n] = float("inf")
    adj = np.stack([rng.choice(n, size=R, replace=False) for _ in range(n)] + [np.full(R, n)]).astype(np.int32)
    adj[::5, R - 6 :] = n
    packed, pn, pi = pack_blocks(rows.to(torch.int8) if s8 else rows, norms, torch.from_numpy(adj),
                                 32 if s8 else 16, None if s8 else torch.bfloat16)
    q = torch.from_numpy(np.round(rng.standard_normal((B, d)) * (20 if s8 else 1)).astype(np.float32))
    bd0 = torch.full((B, EF), float("inf"))
    bi0 = torch.full((B, EF), n, dtype=torch.int32)
    seeds = torch.from_numpy(rng.integers(0, n, size=(B, 4)).astype(np.int32))
    bi0[:, :4] = seeds
    bd0[:, :4] = ((q[:, None, :] - rows[seeds.long()]) ** 2).sum(-1)
    return (packed, pn, pi, q, bd0, bi0, 24, 2, topt_for(8, 2, packed.shape[1]), 8 * 24 + 16)


@pytest.mark.parametrize("s8", [False, True])
def test_plain_records_the_blocks_it_expands(s8):
    """The record leaves the results as they are, never holds the
    sentinel, and is the union of each query's own record; here no query
    expands a block twice, so each query's record counts its expansions."""
    args = _traversal(s8, 6)
    packed, rs, sentinel = args[0], args[0].shape[1], args[0].shape[0] - 1
    mask = torch.zeros(packed.shape[0], dtype=torch.bool)
    got = fused_search_plain(*args, expanded=mask)
    for a, b in zip(got, fused_search_plain(*args)):
        assert torch.equal(a, b)
    assert not bool(mask[sentinel]) and int(mask.sum()) > 0
    union = torch.zeros_like(mask)
    for i in range(6):
        one = torch.zeros_like(mask)
        qargs = (*args[:3], *(t[i : i + 1] for t in args[3:6]), *args[6:])
        ncomp = fused_search_plain(*qargs, expanded=one)[2]
        assert int(one.sum()) == int(ncomp[0]) // rs
        union |= one
    assert torch.equal(union, mask)
    assert expanded_blocks(*args) == int(mask.sum()) <= int(got[2].sum()) // rs


def test_expanded_blocks_counts_a_block_once_however_often_it_is_read():
    """Three copies of a batch expand three times the blocks of one, and
    the same distinct blocks."""
    one = _traversal(False, 5, seed=3)
    three = (*one[:3], *(t.repeat(3, 1) for t in one[3:6]), *one[6:])
    rs = one[0].shape[1]
    assert expanded_blocks(*three) == expanded_blocks(*one)
    assert int(fused_search_plain(*three)[2].sum()) == 3 * int(fused_search_plain(*one)[2].sum())
    assert expanded_blocks(*one) < int(fused_search_plain(*three)[2].sum()) // rs
