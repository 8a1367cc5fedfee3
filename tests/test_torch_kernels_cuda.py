"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; every test skips where no CUDA device is present.  This
file imports neither JAX nor expann_tpu, so it runs on a machine without
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import gc
import json
import subprocess
import sys
import weakref
from collections import Counter

import numpy as np
import pytest
import torch

from expann_tpu_torch.models import search
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.models.build import BuildConfig, build_index
from expann_tpu_torch.models.layout import Blocks, CodeBlocks, CodeRows, Rows
from expann_tpu_torch.models.search import beam_search, query_batch
from expann_tpu_torch.ops import _kernels
from expann_tpu_torch.models import antitopo
from expann_tpu_torch.models.search import entry_beam
from expann_tpu_torch.ops.fused import (fused_search, fused_search_cuda, fused_search_plain, fused_search_rows,
                                        fused_search_rows_cuda, fused_search_rows_plain, ring_for, topt_for)
from expann_tpu_torch.ops.packed import (build_packed, build_packed_i8, build_rows, code_rows_bytes, neighbour_rows,
                                         pack_blocks, packed_score, packed_score_plain, rows_bytes)
from expann_tpu_torch.ops.topk import flat_topk, flat_topk_plain, flat_topk_plan
from expann_tpu_torch.ops.topk import pass_counter as flat_pass_counter
from expann_tpu_torch.parallel import distbuild
from expann_tpu_torch.ops.distance import squared_norms
from expann_tpu_torch.ops.entry import S_MAX, entry_select, entry_select_cuda, entry_select_plain
from expann_tpu_torch.tools import perf_pallas_gather, probe_fused, probe_lanes, probe_step_overhead
from expann_tpu_torch.utils import profiling
from expann_tpu_torch.utils.persist import graph_from_numpy, graph_to_numpy

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_kernels_build(dev):
    lib = _kernels.library()
    report = _kernels.build_report()
    for name in ("flat_topk_kernel", "flat_topk_fixed_kernel", "fused_search_kernel", "packed_score_kernel",
                 "flat_topk_s8_kernel", "flat_topk_fixed_s8_kernel", "fused_search_s8_kernel", "fused_search_rows_kernel",
                 "fused_search_rows_s8_kernel",
                 "probe_fused_kernel", "block_gather_kernel", "step_overhead_kernel", "probe_lanes_kernel",
                 "entry_select_kernel"):
        assert name in report
    assert lib.expann_flat_topk_smem_bytes(128, 10) > 0


FLAT_BF16_SHAPES = [(5000, 300, 10, 128), (777, 70, 128, 128), (64, 5, 100, 128), (4097, 1, 10, 128),
                    (1000, 37, 30, 64), (3001, 129, 1, 256), (200, 65, 128, 256), (100, 3, 128, 64)]
FLAT_S8_SHAPES = [(5000, 301, 30, 128), (3001, 129, 1, 128), (777, 71, 128, 128), (64, 5, 100, 128),
                  (4097, 1, 10, 128), (1000, 37, 30, 64), (2000, 65, 10, 256), (300, 200, 128, 512)]
FLAT_LAUNCHES = {("count", False): "flat_topk", ("fixed", False): "flat_topk_fixed",
                 ("count", True): "flat_topk_s8", ("fixed", True): "flat_topk_fixed_s8"}


def _flat_bf16_inputs(dev, n, B, D, seed):
    """A bf16 corpus with duplicated rows (exact ties) and f32 queries, a
    third of them equal to corpus rows."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((n, D)).astype(np.float32)
    xh[n // 2 : n // 2 + n // 8] = xh[: n // 8]
    qh = rng.standard_normal((B, D)).astype(np.float32)
    m = min(B // 3, n - n // 4)
    qh[:m] = xh[n // 4 : n // 4 + m]
    return torch.from_numpy(qh).to(dev), torch.from_numpy(xh).to(dev, torch.bfloat16)


def _flat_s8_inputs(dev, n, B, D, seed):
    """int8 codes over the full range with duplicated rows, a third of the
    queries equal to corpus rows."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (n, D)).astype(np.int8)
    x[n // 2 : n // 2 + n // 8] = x[: n // 8]
    q = rng.integers(-127, 128, (B, D)).astype(np.int8)
    m = min(B // 3, n - n // 4)
    q[:m] = x[n // 4 : n // 4 + m]
    return torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)


def _flat_launch(q, x, k, mode):
    """flat_topk on the card; asserts that it launched its kernel once."""
    name = FLAT_LAUNCHES[mode, x.dtype == torch.int8]
    before = _kernels.launches[name]
    ids, d = flat_topk(q, x, k, mode=mode)
    assert _kernels.launches[name] == before + 1
    return ids, d


def _assert_bf16_matches_plain(q, x, k, ids, d):
    n = x.shape[0]
    pids, pd = flat_topk_plain(q, x, k)
    torch.cuda.synchronize()
    # f32 sums in another order: distances agree to a few ulps of |x|^2 ~ 2D
    kk = min(k, n)
    torch.testing.assert_close(d[:, :kk], pd[:, :kk], rtol=1e-5, atol=1e-3)
    # ids agree except where two candidates tie within that tolerance: the
    # kernel's id at a differing slot lies at the plain version's distance
    diff = ids[:, :kk] != pids[:, :kk]
    assert float(diff.float().mean()) < 0.01
    if bool(diff.any()):
        qb, xb = q.to(torch.bfloat16).float(), x.float()
        own = ((qb[:, None, :] - xb[ids[:, :kk].long()]) ** 2).sum(-1)
        torch.testing.assert_close(own[diff], pd[:, :kk][diff], rtol=1e-5, atol=1e-3)
    if k > n:
        assert bool((ids[:, n:] == -1).all()) and bool(torch.isinf(d[:, n:]).all())


def _assert_s8_identical_to_plain(q, x, k, ids, d):
    pids, pd = flat_topk_plain(q, x, k)
    torch.cuda.synchronize()
    assert torch.equal(d, pd), float((d - pd).abs().nan_to_num().max())
    assert torch.equal(ids, pids), int((ids != pids).sum())


@pytest.mark.parametrize("s8", [False, True], ids=["bf16", "s8"])
def test_flat_topk_past_2_24_rows(dev, s8):
    """K2 / K2-s8 over 2^24 + 4096 rows at D=64, integer-valued so that every
    distance is exact on both sides: each query's three nearest rows are
    planted past row 2^24 (the query itself, then +1 on one and on two
    coordinates), and a copy of the first below 2^24 ties with it at d=0.
    Ids and distances identical to the plain version, the planted ids (f32
    could not hold them) at their places."""
    n, B, D, big = (1 << 24) + 4096, 96, 64, 1 << 24
    k = 30 if s8 else 10
    gen = torch.Generator(device=dev).manual_seed(24)
    lim = 127 if s8 else 8
    x = torch.randint(-lim, lim + 1, (n, D), generator=gen, device=dev, dtype=torch.int8)
    q = torch.randint(-lim + 2, lim - 1, (B, D), generator=gen, device=dev, dtype=torch.int8)
    rows = big + 17 + 40 * torch.arange(B, device=dev)
    bump = torch.zeros((B, D), dtype=torch.int8, device=dev)
    x[rows] = q
    bump[:, 0] = 1
    x[rows + 1] = q + bump
    bump[:, 1] = 1
    x[rows + 2] = q + bump
    low = 5 + torch.arange(B, device=dev)
    x[low] = q
    if not s8:
        x, q = x.to(torch.bfloat16), q.float()
    ids, d = _flat_launch(q, x, k, "count")
    pids, pd = flat_topk_plain(q, x, k)
    torch.cuda.synchronize()
    assert torch.equal(d, pd), float((d - pd).abs().nan_to_num().max())
    assert torch.equal(ids, pids), int((ids != pids).sum())
    want = torch.stack([low, rows, rows + 1, rows + 2], 1).to(torch.int32)
    assert torch.equal(ids[:, :4], want)
    assert torch.equal(d[:, :4], torch.tensor([0.0, 0.0, 1.0, 2.0], device=dev).expand(B, 4))
    assert int((ids >= big).sum()) >= 3 * B


@pytest.mark.parametrize("mode", ["count", "fixed"])
@pytest.mark.parametrize("n,B,k,D", FLAT_BF16_SHAPES)
def test_flat_topk_matches_plain(dev, n, B, k, D, mode):
    """K2 / K3 against the plain version: n and B off the tile sizes (64 rows,
    64 queries), B = 1, D in {64, 128, 256} (256: two ring chunks per tile),
    k up to 128 and above n, duplicated corpus rows (exact ties) and queries
    equal to corpus rows."""
    q, x = _flat_bf16_inputs(dev, n, B, D, seed=n + D)
    ids, d = _flat_launch(q, x, k, mode)
    _assert_bf16_matches_plain(q, x, k, ids, d)


@pytest.mark.parametrize("mode", ["count", "fixed"])
@pytest.mark.parametrize("n,B,k,D", FLAT_S8_SHAPES)
def test_flat_topk_s8_identical_to_plain(dev, n, B, k, D, mode):
    """K2-s8 / K3-s8 against the plain version on int8 codes over the full
    range, with duplicated rows (exact integer ties), n and B off the tile
    sizes, D in {64, 128, 256, 512} (512: two ring chunks per tile):
    distances are exact integers on both sides and ties go by id, so ids and
    distances are identical."""
    q, x = _flat_s8_inputs(dev, n, B, D, seed=n + k + D)
    ids, d = _flat_launch(q, x, k, mode)
    _assert_s8_identical_to_plain(q, x, k, ids, d)


@pytest.mark.parametrize("s8", [False, True], ids=["bf16", "s8"])
@pytest.mark.parametrize("mode", ["count", "fixed"])
@pytest.mark.parametrize("D", [64, 128, 256, 512])
@pytest.mark.parametrize("k", [1, 10, 16, 17, 30, 32, 33, 64, 65, 100, 128])
def test_flat_topk_over_k_and_width(dev, k, D, mode, s8):
    """Every k against every width, in both modes and both types: k on both
    sides of the powers of two that size K3's merge network (the running
    list padded to 1, 2, 4, ..., 128 slots), rows from a quarter of a
    256-byte ring chunk (s8, D=64) to four (bf16, D=512)."""
    n, B = 2000, 131
    if s8:
        q, x = _flat_s8_inputs(dev, n, B, D, seed=k + D)
        ids, d = _flat_launch(q, x, k, mode)
        _assert_s8_identical_to_plain(q, x, k, ids, d)
    else:
        q, x = _flat_bf16_inputs(dev, n, B, D, seed=k + D)
        ids, d = _flat_launch(q, x, k, mode)
        _assert_bf16_matches_plain(q, x, k, ids, d)


@pytest.mark.parametrize("s8", [False, True], ids=["bf16", "s8"])
@pytest.mark.parametrize("mode", ["count", "fixed"])
@pytest.mark.parametrize("n,k", [(1000, 10), (300, 128), (100, 128)])
def test_flat_topk_all_rows_equal(dev, n, k, mode, s8):
    """Every corpus row the same, so every candidate of every tile ties:
    the distances of a query are one value and the ids are 0, 1, ... in
    order (ties by id), then -1 / +inf past n."""
    rng = np.random.default_rng(n + k)
    D, B = 128, 67
    if s8:
        x = torch.from_numpy(np.repeat(rng.integers(-127, 128, (1, D)), n, 0).astype(np.int8)).to(dev)
        q = torch.from_numpy(rng.integers(-127, 128, (B, D)).astype(np.int8)).to(dev)
    else:
        x = torch.from_numpy(np.repeat(rng.standard_normal((1, D)), n, 0).astype(np.float32)).to(dev, torch.bfloat16)
        q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
    ids, d = _flat_launch(q, x, k, mode)
    torch.cuda.synchronize()
    kk = min(k, n)
    want = torch.arange(kk, dtype=torch.int32, device=dev).expand(B, kk)
    assert torch.equal(ids[:, :kk], want)
    assert bool((d[:, :kk] == d[:, :1]).all())
    assert bool((ids[:, kk:] == -1).all()) and bool(torch.isinf(d[:, kk:]).all())
    if s8:
        _assert_s8_identical_to_plain(q, x, k, ids, d)
    else:  # the ids are checked above; the plain version's product may round its columns apart
        torch.testing.assert_close(d[:, :kk], flat_topk_plain(q, x, k)[1][:, :kk], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("s8", [False, True], ids=["bf16", "s8"])
@pytest.mark.parametrize("mode", ["count", "fixed"])
@pytest.mark.parametrize("n,k", [(1, 1), (1, 10), (17, 10), (63, 30), (63, 128), (40, 33)])
def test_flat_topk_corpus_below_one_tile(dev, n, k, mode, s8):
    """n < 64: the only tile is ragged, and k may exceed n (id -1, +inf)."""
    B, D = 70, 64
    if s8:
        q, x = _flat_s8_inputs(dev, n, B, D, seed=n + k)
        ids, d = _flat_launch(q, x, k, mode)
        _assert_s8_identical_to_plain(q, x, k, ids, d)
    else:
        q, x = _flat_bf16_inputs(dev, n, B, D, seed=n + k)
        ids, d = _flat_launch(q, x, k, mode)
        _assert_bf16_matches_plain(q, x, k, ids, d)


@pytest.mark.parametrize(
    "s8,n,B,k,D", [(False, *shape) for shape in FLAT_BF16_SHAPES] + [(True, *shape) for shape in FLAT_S8_SHAPES]
)
def test_flat_topk_fixed_identical_to_count(dev, s8, n, B, k, D):
    """K3-s8 and K2-s8 share one distance tile, so they compute the same
    distances bit for bit and, ordering by (d, id), return the very same ids
    and distances.  On bf16, K2's wgmma tile sums in another order than K3's
    mma.sync tile: each is held to the plain version, and their ids are equal
    but where two candidates tie within that tolerance."""
    q, x = (_flat_s8_inputs if s8 else _flat_bf16_inputs)(dev, n, B, D, seed=n + k + D + 1)
    ids_c, d_c = _flat_launch(q, x, k, "count")
    ids_f, d_f = _flat_launch(q, x, k, "fixed")
    torch.cuda.synchronize()
    if s8:
        assert torch.equal(d_f, d_c), float((d_f - d_c).abs().nan_to_num().max())
        assert torch.equal(ids_f, ids_c), int((ids_f != ids_c).sum())
        return
    _assert_bf16_matches_plain(q, x, k, ids_c, d_c)
    _assert_bf16_matches_plain(q, x, k, ids_f, d_f)
    kk = min(k, n)
    diff = ids_c[:, :kk] != ids_f[:, :kk]
    if bool(diff.any()):  # a tie: the two distances at the slot agree within the plain tolerance
        torch.testing.assert_close(d_c[:, :kk][diff], d_f[:, :kk][diff], rtol=1e-5, atol=1e-3)


def _flat_passes(q, x, k):
    """K2's ids, distances and the candidates its filter passed in the call."""
    counter = flat_pass_counter(x.device)
    before = int(counter.item())
    ids, d = _flat_launch(q, x, k, "count")
    return ids, d, int(counter.item()) - before


@pytest.mark.parametrize("n,B,k", [(300_000, 200, 10), (300_000, 512, 128), (300_000, 512, 10), (20_000, 1, 128)])
def test_flat_topk_splits_the_corpus_at_a_small_batch(dev, n, B, k):
    """A small batch leaves most SMs without a query group, so K2 splits the
    corpus across blocks and the last split of each group to finish merges
    the others' lists: its plan splits, and the lists match the plain
    version's."""
    plan = flat_topk_plan(n, B, 128, k)
    assert plan["split"] > 1, plan
    q, x = _flat_bf16_inputs(dev, n, B, 128, seed=n + B + k)
    ids, d = _flat_launch(q, x, k, "count")
    _assert_bf16_matches_plain(q, x, k, ids, d)


def test_flat_topk_d1024_k128(dev):
    """D=1024 at k=128, the wide builder's scan: the queries stream beside
    the corpus chunk by chunk (16 chunks a tile), one consumer warpgroup a
    block, the corpus split.  An f32 sum of 1024 products in another order
    differs by more ulps than at D <= 512: a self-match, whose distance
    cancels |q|^2 + |x|^2 ~ 2048 down to ~0, read 0.0039 against the plain
    version's 0.0015 on the card, so the distances are held to 32 ulps of
    the largest |q|^2 + |x|^2; ids equal but on ties within it."""
    n, B, k, D = 5000, 256, 128, 1024
    plan = flat_topk_plan(n, B, D, k)
    assert plan["resident"] == 0 and plan["split"] > 1, plan
    q, x = _flat_bf16_inputs(dev, n, B, D, seed=1024)
    ids, d = _flat_launch(q, x, k, "count")
    pids, pd = flat_topk_plain(q, x, k)
    qb, xb = q.to(torch.bfloat16).float(), x.float()
    atol = 32 * float(torch.finfo(torch.float32).eps) * float((qb * qb).sum(1).max() + (xb * xb).sum(1).max())
    torch.testing.assert_close(d, pd, rtol=1e-5, atol=atol)
    diff = ids != pids
    assert float(diff.float().mean()) < 0.01
    if bool(diff.any()):
        own = ((qb[:, None, :] - xb[ids.long()]) ** 2).sum(-1)
        torch.testing.assert_close(own[diff], pd[diff], rtol=1e-5, atol=atol)


@pytest.mark.parametrize("k", [10, 128])
def test_flat_topk_tied_first_tiles_overflow_the_buffer(dev, k):
    """The first 1024 corpus rows are one row x0, so on the first tiles every
    candidate of every query ties and passes the filter (the list is not full
    yet, or the tie is below its k-th): far more than a query's buffer of 32
    holds, merged as the buffer fills.  Half the queries lie near x0 and take
    the tied rows 0 .. k-1 in id order (the plain version's product may round
    identical columns apart, so their distances alone are held to it); the
    other half lie near -x0, where no tied row is among the nearest, and
    match the plain version."""
    n, B, D = 6000, 130, 128
    rng = np.random.default_rng(k)
    xh = rng.standard_normal((n, D)).astype(np.float32)
    xh[:1024] = xh[0]
    qh = (xh[0] + 0.05 * rng.standard_normal((B, D))).astype(np.float32)
    qh[B // 2 :] = -xh[0] + rng.standard_normal((B - B // 2, D))
    q, x = torch.from_numpy(qh).to(dev), torch.from_numpy(xh).to(dev, torch.bfloat16)
    ids, d, passes = _flat_passes(q, x, k)
    assert passes >= B * k
    near, far = slice(0, B // 2), slice(B // 2, B)
    assert torch.equal(ids[near], torch.arange(k, dtype=torch.int32, device=dev).expand(B // 2, k))
    torch.testing.assert_close(d[near], flat_topk_plain(q[near], x, k)[1], rtol=1e-5, atol=1e-3)
    _assert_bf16_matches_plain(q[far], x, k, ids[far], d[far])


@pytest.mark.parametrize("n,B,k", [(5000, 300, 10), (300_000, 200, 10), (777, 70, 128), (60, 5, 100)])
def test_flat_topk_pass_counter(dev, n, B, k):
    """The filter's pass counter: at least every query's first min(k, n)
    candidates pass (its list is not yet full), at most every candidate
    once, and two runs on the same inputs count the same."""
    q, x = _flat_bf16_inputs(dev, n, B, 128, seed=n + k)
    ids, d, first = _flat_passes(q, x, k)
    ids2, d2, second = _flat_passes(q, x, k)
    assert B * min(k, n) <= first <= B * n, (first, B * min(k, n), B * n)
    assert first == second
    assert torch.equal(ids, ids2) and torch.equal(d, d2)


@pytest.mark.parametrize("n,C,n_seg", [(5000, 128, 2), (5000, 300, 3), (4150, 300, 3), (3000, 128, 2)])
def test_build_candidate_scan_matches_plain(dev, n, C, n_seg):
    """The distributed builder's candidate scan (K2 over the corpus in
    segments at k = min(C + 1, 128)) on the card against the same scan on
    CPU tensors (flat_topk's plain version): n not a multiple of 1024, C + 1
    of 129 and 301 (two and three segments), each wave node a corpus row
    that must not be in its own list, and at n=4150 a last segment of 54
    rows, shorter than k, whose empty slots must stay masked.  Distances
    within the flat kernels' tolerance, ids equal but on ties."""
    rng = np.random.default_rng(n + C)
    x = torch.from_numpy(rng.standard_normal((n, 128)).astype(np.float32)).to(dev)
    gids = torch.from_numpy(np.sort(rng.choice(n, 256, replace=False)).astype(np.int32)).to(dev)
    xs, wq = x.to(torch.bfloat16), x[gids.long()]
    before = _kernels.launches["flat_topk"]
    ids, d = distbuild._flat_candidates(xs, wq, gids, C, "count")
    assert _kernels.launches["flat_topk"] - before == n_seg
    pids, pd = distbuild._flat_candidates(xs.cpu(), wq.cpu(), gids.cpu(), C, "count")
    ids, d, gids = ids.cpu(), d.cpu(), gids.cpu()
    assert ids.shape == (256, C) and not bool((ids == gids[:, None]).any())
    assert bool(torch.isfinite(d).all()) and bool((ids < n).all())
    torch.testing.assert_close(d, pd, rtol=1e-5, atol=1e-3)
    diff = ids != pids
    assert float(diff.float().mean()) < 0.01
    if bool(diff.any()):
        qb, xb = wq.cpu().to(torch.bfloat16).float(), xs.cpu().float()
        own = ((qb[:, None, :] - xb[ids.long()]) ** 2).sum(-1)
        torch.testing.assert_close(own[diff], pd[diff], rtol=1e-5, atol=1e-3)


def _random_graph(dev, n, R, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    vecs = torch.from_numpy(np.concatenate([x, np.zeros((1, d), np.float32)])).to(dev)
    norms = (vecs * vecs).sum(1)
    norms[n] = float("inf")
    adj = np.stack([rng.choice(n, size=R, replace=False) for _ in range(n)] + [np.full(R, n)])
    adj = torch.from_numpy(adj.astype(np.int32)).to(dev)
    return vecs, norms, adj, rng


@pytest.mark.parametrize(
    "expand,cand,R,d,EF,ef",
    [(2, 8, 128, 128, 128, 100), (1, 8, 60, 128, 128, 100), (2, 32, 128, 128, 128, 100), (2, 8, 120, 256, 256, 200)],
)
def test_fused_search_matches_plain(dev, expand, cand, R, d, EF, ef):
    n, B = 4000, 256
    vecs, norms, adj, rng = _random_graph(dev, n, R, d, seed=R + cand)
    packed, pn, pi = build_packed(vecs, norms, adj)
    q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).to(dev)
    bd0 = torch.full((B, EF), float("inf"), device=dev)
    bi0 = torch.full((B, EF), n, dtype=torch.int32, device=dev)
    seeds = torch.from_numpy(rng.integers(0, n, size=(B, 1)).astype(np.int32)).to(dev)
    bi0[:, :1] = seeds
    bd0[:, 0] = ((q - vecs[seeds[:, 0].long()]) ** 2).sum(1)
    ids, dist, ncomp, iters = fused_search(packed, pn, pi, q, bd0, bi0, ef, expand=expand, cand=cand)
    topt = topt_for(cand, expand, packed.shape[1])
    pids, pdist, pncomp, piters = fused_search_plain(
        packed, pn, pi, q, bd0, bi0, ef, expand, topt, 8 * ef + 16
    )
    torch.cuda.synchronize()
    # the kernel and the plain version sum q.x in another order, so a
    # near-tie can flip an insertion; whole-beam agreement is the gate
    same_rows = [set(a.tolist()) == set(b.tolist()) for a, b in zip(ids.cpu(), pids.cpu())]
    assert np.mean(same_rows) >= 0.95, np.mean(same_rows)
    overlap = [
        len((set(a.tolist()) & set(b.tolist())) - {n}) / len(set(b.tolist()) - {n})
        for a, b in zip(ids.cpu(), pids.cpu())
    ]
    assert np.mean(overlap) >= 0.99, np.mean(overlap)
    assert abs(int(ncomp.sum()) - int(pncomp.sum())) <= 0.01 * int(pncomp.sum())
    for row in ids.cpu():
        real = row[row < n].tolist()
        assert len(set(real)) == len(real)
    assert bool((iters >= 1).all())


@pytest.mark.parametrize(
    "expand,R,d,EF,ef", [(2, 128, 128, 128, 120), (1, 20, 128, 128, 100), (2, 30, 128, 128, 60), (2, 120, 256, 256, 200)]
)
def test_fused_search_s8_identical_to_plain(dev, expand, R, d, EF, ef):
    """K1-s8 against its plain version on the s8 layout (RS 32 or 128) from
    code-space seed beams at an odd batch: every distance is an exact
    integer and both break ties by (d, lane), so the beams, distances,
    distance counts and iteration counts are identical."""
    n, B = 4000, 257
    vecs, norms, adj, rng = _random_graph(dev, n, R, d, seed=R + expand)
    packed, pn, pi, codes, cn, center, scale = build_packed_i8(vecs, adj)
    assert packed.dtype == torch.int8 and packed.shape[1] == (32 if R <= 32 else 128)
    q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).to(dev)
    qk = torch.clamp(torch.round((q - center) * scale), -127, 127)
    seeds = torch.from_numpy(rng.integers(0, n, size=(B,)).astype(np.int32)).to(dev)
    bd0 = torch.full((B, EF), float("inf"), device=dev)
    bi0 = torch.full((B, EF), n, dtype=torch.int32, device=dev)
    bi0[:, 0] = seeds
    bd0[:, 0] = ((qk - codes[seeds.long()].float()) ** 2).sum(1)
    before = _kernels.launches["fused_search_s8"]
    ids, dist, ncomp, iters = fused_search(packed, pn, pi, qk, bd0, bi0, ef, expand=expand, cand=8)
    assert _kernels.launches["fused_search_s8"] == before + 1
    topt = topt_for(8, expand, packed.shape[1])
    pids, pdist, pncomp, piters = fused_search_plain(packed, pn, pi, qk, bd0, bi0, ef, expand, topt, 8 * ef + 16)
    torch.cuda.synchronize()
    assert torch.equal(ids, pids), int((ids != pids).any(1).sum())
    assert torch.equal(dist, pdist)
    assert torch.equal(ncomp, pncomp) and torch.equal(iters, piters)
    real = dist[ids < n]
    assert bool((real == torch.round(real)).all())


def _int_layout(dev, s8, n, R, d, seed, tie=False):
    """A packed layout over integer-valued rows (bf16: entries in [-3, 3];
    s8: codes in [-20, 20]), so every distance is an exact integer in both
    the kernel and the plain version and only the tie rules decide; every
    seventh node's last quarter of neighbours is the sentinel.  ``tie``:
    every row is the same, so all of a node's real neighbours tie."""
    rng = np.random.default_rng(seed)
    lim = 20 if s8 else 3
    x = rng.integers(-lim, lim + 1, size=(n, d)).astype(np.float32)
    if tie:
        x[:] = x[0]
    rows = torch.from_numpy(np.concatenate([x, np.zeros((1, d), np.float32)])).to(dev)
    norms = (rows * rows).sum(1)
    norms[n] = float("inf")
    adj = np.stack([rng.choice(n, size=R, replace=False) for _ in range(n)] + [np.full(R, n)]).astype(np.int32)
    adj[::7, R - R // 4 :] = n
    adj = torch.from_numpy(adj).to(dev)
    if s8:
        packed, pn, pi = pack_blocks(rows.to(torch.int8), norms, adj, 32)
    else:
        packed, pn, pi = pack_blocks(rows, norms, adj, 16, torch.bfloat16)
    return packed, pn, pi, rows, rng


# (B, E, cand, R, EF, ef, beams, tie): B=1 and an odd B; E 1 / 2 / 4; topt
# (= ceil(cand / E), at most RS) 1, 4 and RS; RS 16 (s8: 32), 128 and 256;
# ef = EF; seed beams of sentinels only, or half of them so (those queries
# stop at their first iteration, the others run on); all-tie blocks
FUSED_EDGES = [
    (1, 2, 8, 120, 128, 120, "seeded", False),
    (37, 1, 1, 16, 128, 64, "seeded", False),
    (37, 4, 16, 120, 128, 128, "seeded", False),
    (37, 2, 512, 16, 64, 48, "seeded", False),
    (37, 2, 8, 250, 256, 200, "seeded", False),
    (37, 2, 8, 120, 128, 120, "sentinels", False),
    (37, 2, 8, 120, 128, 100, "half_sentinels", False),
    (37, 2, 8, 120, 128, 120, "seeded", True),
    (37, 1, 256, 16, 64, 64, "seeded", True),
]


@pytest.mark.parametrize("s8", [False, True])
@pytest.mark.parametrize("B,E,cand,R,EF,ef,beams,tie", FUSED_EDGES)
def test_fused_search_edges_identical_to_plain(dev, B, E, cand, R, EF, ef, beams, tie, s8):
    """K1 and K1-s8 against the plain version on integer-valued layouts,
    where both compute the same exact distances, so beams, distances,
    distance counts and iteration counts must be identical."""
    n, d = 1500, 128
    packed, pn, pi, rows, rng = _int_layout(dev, s8, n, R, d, seed=R + E + cand, tie=tie)
    lim = 20 if s8 else 3
    q = torch.from_numpy(rng.integers(-lim, lim + 1, size=(B, d)).astype(np.float32)).to(dev)
    bd0 = torch.full((B, EF), float("inf"), device=dev)
    bi0 = torch.full((B, EF), n, dtype=torch.int32, device=dev)
    if beams != "sentinels":
        seeds = torch.from_numpy(rng.integers(0, n, size=(B, 4)).astype(np.int32)).to(dev)
        bi0[:, 3 : 3 + 4] = seeds
        bd0[:, 3 : 3 + 4] = ((q[:, None, :] - rows[seeds.long()]) ** 2).sum(-1)
        if beams == "half_sentinels":
            bd0[::2], bi0[::2] = float("inf"), n
    name = "fused_search_s8" if s8 else "fused_search"
    before = _kernels.launches[name]
    ids, dist, ncomp, iters = fused_search(packed, pn, pi, q, bd0, bi0, ef, expand=E, cand=cand)
    assert _kernels.launches[name] == before + 1
    topt = topt_for(cand, E, packed.shape[1])
    pids, pdist, pncomp, piters = fused_search_plain(packed, pn, pi, q, bd0, bi0, ef, E, topt, 8 * ef + 16)
    torch.cuda.synchronize()
    assert torch.equal(ids, pids), int((ids != pids).any(1).sum())
    assert torch.equal(dist, pdist)
    assert torch.equal(ncomp, pncomp) and torch.equal(iters, piters)
    if beams == "sentinels":
        assert bool((iters == 1).all()) and not bool(ncomp.any()) and bool((ids == n).all())
    if beams == "half_sentinels":
        assert bool((iters[::2] == 1).all()) and int(iters[1::2].min()) >= 10


@pytest.mark.parametrize("s8,R,d", [(False, 120, 128), (True, 120, 128), (False, 250, 128), (True, 250, 128),
                                     (False, 120, 112), (True, 120, 112)])
def test_fused_search_rings_identical_to_plain(dev, s8, R, d):
    """Every shared-memory ring the launcher takes, reached through B (the
    largest batch of a sweep that takes it): the iteration's blocks all in
    flight, two 16 KB slots, one 16 KB slot and the default 8 KB slot; a
    block over several chunks, and at d = 112 (224 / 112 B rows) chunks
    cut short by the block's end.  Integer-valued layouts: identical to
    the plain version."""
    n, E, cand, ef = 1500, 2, 8, 120
    packed, pn, pi, rows, rng = _int_layout(dev, s8, n, R, d, seed=R + d)
    RS, Rt = packed.shape[1], pn.shape[1]
    EF = 256 if R > 128 else 128
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    largest = {}
    for B in [1] + [k * sms for k in (1, 2, 3, 4, 6, 8, 10, 12, 16, 20)]:
        largest[ring_for(int(s8), B, d, RS, Rt, EF, E)[:2]] = B
    assert len(largest) >= 3, largest
    assert (1, 8192 // (d * (1 if s8 else 2)) * d * (1 if s8 else 2)) in largest, largest
    lim = 20 if s8 else 3
    topt = topt_for(cand, E, RS)
    for B in largest.values():
        q = torch.from_numpy(rng.integers(-lim, lim + 1, size=(B, d)).astype(np.float32)).to(dev)
        bd0 = torch.full((B, EF), float("inf"), device=dev)
        bi0 = torch.full((B, EF), n, dtype=torch.int32, device=dev)
        seeds = torch.from_numpy(rng.integers(0, n, size=(B, 4)).astype(np.int32)).to(dev)
        bi0[:, :4] = seeds
        bd0[:, :4] = ((q[:, None, :] - rows[seeds.long()]) ** 2).sum(-1)
        got = fused_search_cuda(packed, pn, pi, q, bd0, bi0, ef, E, topt, 8 * ef + 16)
        ref = fused_search_plain(packed, pn, pi, q, bd0, bi0, ef, E, topt, 8 * ef + 16)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b), B


def test_fused_search_ring_follows_the_batch(dev):
    """The launcher's ring: the iteration's blocks all in flight for a
    batch of one query an SM, two 16 KB slots at four an SM, the default
    8 KB slot (16 resident queries an SM) for a batch the card cannot hold
    at once; each choice keeps the whole batch resident where it can."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for s8, block in ((False, 128 * 128 * 2), (True, 128 * 128)):
        assert ring_for(int(s8), 1, 128, 128, 128, 128, 2)[:2] == (2, block)
        for B in (1, sms, 4 * sms, 8 * sms, 16384):
            nslot, slot, ctas = ring_for(int(s8), B, 128, 128, 128, 128, 2)
            assert ctas * sms >= B or (nslot, slot, ctas) == (1, 8192, 16)
        assert ring_for(int(s8), 16384, 128, 128, 128, 128, 2) == (1, 8192, 16)


@pytest.fixture(scope="module")
def canonical_rows(tmp_path_factory):
    """The canonical 56k graph (bench.py's build) with its bf16 blocks and
    its rows layout, which shares the blocks' norm and id rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from expann_tpu_torch.tools.perf_e2e_graph import canonical_graph

    eng = canonical_graph(str(tmp_path_factory.mktemp("idx") / "canonical.npz"), 56000, "cuda", use_packed=True,
                          use_fused=True, query_expand=2, fused_cand=8)
    eng._layout()
    g = eng.graph
    rows = Rows.build(g)
    assert torch.equal(rows.norms, g.layout.norms) and torch.equal(rows.ids, g.layout.ids)
    return g, rows


@pytest.mark.parametrize("B", [8, 512, 16384])
def test_fused_search_rows_identical_to_k1_on_canonical(dev, canonical_rows, B):
    """K1-rows against K1 on the canonical index from the engine's seed
    beams (8 seeds, EF=128, ef=120, E=2, cand=8): beam ids, distances and
    iteration counts identical (both score the same bf16 rows in the same
    order); K1-rows counts no more rows than K1's RS a node."""
    g, rows = canonical_rows
    rng = np.random.default_rng(B)
    q = torch.from_numpy(rng.standard_normal((B, 128)).astype(np.float32)).to(dev)
    bd0, bi0, _ = entry_beam(g, q, 128, 8)
    before = _kernels.launches["fused_search_rows"], _kernels.launches["fused_search"]
    assert rows.rs == g.layout.packed.shape[1]
    got = fused_search_rows(rows.rows, rows.norms, rows.ids, rows.rs, q, bd0, bi0, 120, expand=2, cand=8)
    assert _kernels.launches["fused_search_rows"] == before[0] + 1
    ref = fused_search(g.layout.packed, g.layout.norms, g.layout.ids, q, bd0, bi0, 120, expand=2, cand=8)
    assert _kernels.launches["fused_search"] == before[1] + 1
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]), int((got[0] != ref[0]).any(1).sum())
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[3], ref[3])
    assert bool((got[2] <= ref[2]).all()) and int(got[2].sum()) > 0


def _int_rows(dev, n, R, d, seed):
    """Integer-valued rows in [-3, 3] (every distance exact in both
    versions), the rows layout over a random graph whose every seventh
    node's last quarter of neighbours is the sentinel."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    vecs = torch.from_numpy(np.concatenate([x, np.zeros((1, d), np.float32)])).to(dev)
    norms = (vecs * vecs).sum(1)
    norms[n] = float("inf")
    adj = np.stack([rng.choice(n, size=R, replace=False) for _ in range(n)] + [np.full(R, n)]).astype(np.int32)
    adj[::7, R - R // 4 :] = n
    rows, rn, ri = build_rows(vecs, norms, torch.from_numpy(adj).to(dev))
    return vecs, rows, rn, ri, rng


@pytest.mark.parametrize("B,E,cand,R,EF,ef", [(1, 2, 8, 96, 128, 120), (37, 2, 8, 96, 256, 200),
                                              (700, 1, 4, 48, 128, 64), (3000, 2, 8, 96, 128, 120)])
def test_fused_search_rows_wide_identical_to_plain(dev, B, E, cand, R, EF, ef):
    """K1-rows at D=1024 (GIST's 960 padded; RS 96 and 48) against its plain
    version on integer-valued rows, through the rings the batches take (the
    iteration's rows all in flight at B=1, the default 8 KB slot of 4 rows
    at B=3000): beams, distances, row counts and iterations identical."""
    n, d = 2000, 1024
    vecs, rows, rn, ri, rng = _int_rows(dev, n, R, d, seed=B + R)
    rs = R + (-R) % 16
    q = torch.from_numpy(rng.integers(-3, 4, size=(B, d)).astype(np.float32)).to(dev)
    bd0 = torch.full((B, EF), float("inf"), device=dev)
    bi0 = torch.full((B, EF), n, dtype=torch.int32, device=dev)
    seeds = torch.from_numpy(rng.integers(0, n, size=(B, 4)).astype(np.int32)).to(dev)
    bi0[:, :4] = seeds
    bd0[:, :4] = ((q[:, None, :] - vecs[seeds.long()]) ** 2).sum(-1)
    topt = topt_for(cand, E, rs)
    before = _kernels.launches["fused_search_rows"]
    got = fused_search_rows_cuda(rows, rn, ri, rs, q, bd0, bi0, ef, E, topt, 8 * ef + 16)
    assert _kernels.launches["fused_search_rows"] == before + 1
    ref = fused_search_rows_plain(rows, rn, ri, rs, q, bd0, bi0, ef, E, topt, 8 * ef + 16)
    torch.cuda.synchronize()
    for name, a, b in zip(("ids", "dist", "ncomp", "iters"), got, ref):
        assert torch.equal(a, b), (name, int((a != b).sum()))
    assert int(got[3].min()) >= 2


def test_fused_search_rows_copy_timeout_traps(dev):
    """A wait for a copy that never lands traps, as K1's does, instead of
    hanging the card: K1-rows with its ``stall`` test hook (the id rows'
    barrier expects 16 bytes more than it is sent) fails the launch, and
    the process's next synchronize raises, after the 2 s timeout.  In a
    process of its own: a trap leaves the CUDA context unusable."""
    code = """
import sys, time, torch
from expann_tpu_torch.ops.fused import fused_search_rows_cuda
from expann_tpu_torch.ops.packed import build_rows
dev = torch.device("cuda")
n, R, d = 64, 16, 128
x = torch.randn((n + 1, d), device=dev)
x[n] = 0
nm = (x * x).sum(1)
nm[n] = float("inf")
adj = torch.randint(0, n, (n + 1, R), dtype=torch.int32, device=dev)
adj[n] = n
rows, rn, ri = build_rows(x, nm, adj)
q = torch.randn((4, d), device=dev)
bd0 = torch.full((4, 128), float("inf"), device=dev)
bi0 = torch.full((4, 128), n, dtype=torch.int32, device=dev)
bi0[:, 0] = 0
bd0[:, 0] = 1.0
t0 = time.perf_counter()
try:
    fused_search_rows_cuda(rows, rn, ri, 16, q, bd0, bi0, 64, 2, 4, 100, stall=16)
    torch.cuda.synchronize()
except RuntimeError as err:
    print("raised after %.2f s: %s" % (time.perf_counter() - t0, str(err).splitlines()[0]))
    sys.exit(0)
print("no error")
sys.exit(1)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    secs = float(proc.stdout.split("raised after ")[1].split(" s")[0])
    assert secs >= 1.9, proc.stdout


def test_engine_serves_the_rows_layout_on_the_card(dev, monkeypatch):
    """An engine at 3000 x 960 (padded to 1024) whose budget admits the rows
    and not the blocks: the fused route launches K1-rows and no K1, counts
    its rows and queries, and returns the block route's lists on the same
    graph."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((3000, 960)).astype(np.float32)
    q = rng.standard_normal((300, 960)).astype(np.float32)
    cfg = AntitopoConfig(M=8, ef_construction=40, prune_cand=40, query_expand=2, fused_cand=8, entry_seeds=8,
                         ef_search=60)
    eng = AntitopoEngine(config=cfg, device="cuda")
    eng.store_many_vectors(x)
    eng.build()
    blocks = eng.query_k_batch(q, 10)
    assert type(eng.graph.layout) is Blocks
    eng.graph.layout = None
    monkeypatch.setattr(antitopo, "PACKED_BUDGET_BYTES", rows_bytes(3001, 1024))
    eng.set_ef_search(60)
    before = _kernels.launches["fused_search_rows"], _kernels.launches["fused_search"]
    got = eng.query_k_batch(q, 10)
    assert type(eng.graph.layout) is Rows and eng.graph.packed is None
    assert _kernels.launches["fused_search_rows"] == before[0] + 1 and _kernels.launches["fused_search"] == before[1]
    assert eng.num_queries == 300 and 300 * 16 < eng.num_rows_gathered < eng.num_distcomps
    np.testing.assert_array_equal(got, blocks)


def _code_rows_wide(dev, n, R, seed):
    """s8 code rows at D=1024 that sit near one another: a shared pattern of
    +-120 plus noise in [-7, 7], so |x|^2 + |q|^2 is ~29.5M, past 2^24,
    while the distances are ~40,000 and tie or differ by 1 often; a random
    graph whose every seventh node's last quarter is the sentinel.  The
    code-space norm and id rows as the code rows layout holds them."""
    d = 1024
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = 120 * (2 * torch.randint(0, 2, (d,), generator=gen, device=dev) - 1)
    codes = torch.zeros((n + 1, d), dtype=torch.int8, device=dev)
    codes[:n] = torch.clamp(base + torch.randint(-7, 8, (n, d), generator=gen, device=dev), -127, 127).to(torch.int8)
    cn = (codes.float() ** 2).sum(1)
    cn[n] = float("inf")
    rng = np.random.default_rng(seed)
    adj = np.stack([rng.choice(n, size=R, replace=False) for _ in range(n)] + [np.full(R, n)]).astype(np.int32)
    adj[::7, R - R // 4 :] = n
    rn, ri = neighbour_rows(cn, torch.from_numpy(adj).to(dev), 32)
    return codes, cn, rn, ri, base, gen


@pytest.mark.parametrize("B", [8, 512, 16384])
def test_fused_search_rows_s8_exact_at_d1024_identical_to_plain(dev, B):
    """K1-rows-s8 at D=1024 against its plain version where the f32
    combination of |x|^2 + |q|^2 - 2 q.x would round (the sums pass 2^24,
    checked) and exact distances tie or differ by 1: beams, distances, row
    counts and iterations identical, one launch counted, through the rings
    of B = 8, 512 and 16384."""
    n, R, EF, ef, E, cand = 20000, 96, 128, 80, 2, 8
    codes, cn, rn, ri, base, gen = _code_rows_wide(dev, n, R, seed=B)
    q = torch.clamp(base + torch.randint(-7, 8, (B, 1024), generator=gen, device=dev), -127, 127).float()
    assert float((cn[:n].min() + (q * q).sum(1).min())) > 2**24
    seeds = torch.randint(0, n, (B, 4), generator=gen, device=dev, dtype=torch.int32)
    bd0 = torch.full((B, EF), float("inf"), device=dev)
    bi0 = torch.full((B, EF), n, dtype=torch.int32, device=dev)
    bi0[:, :4] = seeds
    bd0[:, :4] = ((q[:, None, :] - codes[seeds.long()].float()) ** 2).sum(-1)
    rs = 96
    topt = topt_for(cand, E, rs)
    before = _kernels.launches["fused_search_rows_s8"]
    got = fused_search_rows(codes, rn, ri, rs, q, bd0, bi0, ef, expand=E, cand=cand)
    assert _kernels.launches["fused_search_rows_s8"] == before + 1
    ref = fused_search_rows_plain(codes, rn, ri, rs, q, bd0, bi0, ef, E, topt, 8 * ef + 16)
    torch.cuda.synchronize()
    for name, a, b in zip(("ids", "dist", "ncomp", "iters"), got, ref):
        assert torch.equal(a, b), (name, int((a != b).sum()))
    assert int(got[3].min()) >= 2


def test_fused_search_rows_s8_identical_to_k1_s8_on_canonical(dev, canonical_rows):
    """K1-rows-s8 against K1-s8 on the canonical index's s8 layouts from the
    code-space seed beams (8 seeds, EF=128, ef=120, E=2, cand=8; d=128,
    where both are exact): beam ids, distances and iteration counts
    identical; K1-rows-s8 counts no more rows than K1-s8's RS a node."""
    g, _ = canonical_rows
    blocks, rows = CodeBlocks.build(g), CodeRows.build(g)
    assert rows.rs == blocks.packed.shape[1] and torch.equal(rows.ids, blocks.ids)
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.standard_normal((16384, 128)).astype(np.float32)).to(dev)
    saved = g.layout
    try:
        g.layout = blocks
        bd0, bi0, _ = entry_beam(g, q, 128, 8)
    finally:
        g.layout = saved
    qk = blocks.kernel_query(q)
    before = _kernels.launches["fused_search_rows_s8"], _kernels.launches["fused_search_s8"]
    got = fused_search_rows(rows.rows, rows.norms, rows.ids, rows.rs, qk, bd0, bi0, 120, expand=2, cand=8)
    ref = fused_search(blocks.packed, blocks.norms, blocks.ids, qk, bd0, bi0, 120, expand=2, cand=8)
    assert (_kernels.launches["fused_search_rows_s8"], _kernels.launches["fused_search_s8"]) == (before[0] + 1,
                                                                                               before[1] + 1)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]), int((got[0] != ref[0]).any(1).sum())
    assert torch.equal(got[1], ref[1]) and torch.equal(got[3], ref[3])
    assert bool((got[2] <= ref[2]).all()) and int(got[2].sum()) > 0


def test_engine_serves_the_code_rows_on_the_card(dev, monkeypatch):
    """An s8 engine at 3000 x 960 (padded to 1024) whose budget admits the
    code rows and not the s8 blocks: the fused route launches K1-rows-s8
    and no K1-s8, counts its rows and queries, and returns the lists the
    same engine returns with the traversal run by the plain version."""
    rng = np.random.default_rng(29)
    x = rng.standard_normal((3000, 960)).astype(np.float32)
    q = rng.standard_normal((300, 960)).astype(np.float32)
    cfg = AntitopoConfig(M=8, ef_construction=40, prune_cand=40, query_expand=2, fused_cand=8, entry_seeds=8,
                         ef_search=60, packed_dtype="i8")
    eng = AntitopoEngine(config=cfg, device="cuda")
    eng.store_many_vectors(x)
    eng.build()
    monkeypatch.setattr(antitopo, "PACKED_BUDGET_BYTES", code_rows_bytes(3001, 1024))
    before = _kernels.launches["fused_search_rows_s8"], _kernels.launches["fused_search_s8"]
    got = eng.query_k_batch(q, 10)
    assert type(eng.graph.layout) is CodeRows and eng.graph.packed is None
    assert (_kernels.launches["fused_search_rows_s8"], _kernels.launches["fused_search_s8"]) == (before[0] + 1,
                                                                                               before[1])
    assert eng.num_queries == 300 and 300 * 16 < eng.num_rows_gathered < eng.num_distcomps
    from expann_tpu_torch.models import layout as layouts

    def plain(rows, norms, ids, rs, q, bd0, bi0, ef, expand, cand, max_iters=0):
        return fused_search_rows_plain(rows, norms, ids, rs, q, bd0, bi0, ef, expand, topt_for(cand, expand, rs),
                                       8 * ef + 16)

    monkeypatch.setattr(layouts, "fused_search_rows", plain)
    np.testing.assert_array_equal(eng.query_k_batch(q, 10), got)


def _entry_inputs(dev, B, n, ties, seed):
    """K5's operands at (B, n): the raw product G of B queries against n
    members, their norms (the last n // 17 members the sentinel: a zero
    row at +inf), the queries' norms and the members' ids.  With ``ties``
    the rows are small integers, as s8 codes are, an eighth of them
    repeated, so that many distances are exactly equal; otherwise N(0,1)
    rows, whose sums round."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    D = 8 if ties else 128
    if ties:
        x = torch.randint(-2, 3, (n, D), generator=gen, device=dev).float()
        x[n // 2 : n // 2 + n // 8] = x[: n // 8]
        q = torch.randint(-2, 3, (B, D), generator=gen, device=dev).float()
    else:
        x = torch.randn((n, D), generator=gen, device=dev)
        q = torch.randn((B, D), generator=gen, device=dev)
    tail = n // 17
    x[n - tail :] = 0.0
    xn = squared_norms(x)
    xn[n - tail :] = float("inf")
    members = torch.randperm(4 * n, generator=gen, device=dev)[:n].to(torch.int32)
    return q @ x.T, xn, squared_norms(q), members


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "rounded"])
@pytest.mark.parametrize("S", [1, 8, S_MAX])
@pytest.mark.parametrize("B", [1, 8, 8192])
@pytest.mark.parametrize("n", [1024, 20864, 65536, 1001, 4100])
def test_entry_select_identical_to_plain(dev, n, B, S, ties):
    """K5 against its plain version (the full stable sort of the same f32
    distances), bit for bit in distances and ids, at the widths of the
    canonical (1024) and the million-row (20,864) entry layers, the most
    the dense scan takes (65,536), and ragged widths (1001: scalar loads;
    4100: a last pass whose 16-byte loads end inside the lanes' reach);
    the beams' columns past S untouched."""
    G, xn, qn, members = _entry_inputs(dev, B, n, ties, seed=n + B + S)
    EF = 128
    bd0 = torch.full((B, EF), -1.0, device=dev)
    bi0 = torch.full((B, EF), -7, dtype=torch.int32, device=dev)
    before = _kernels.launches["entry_select"]
    entry_select(G, xn, qn, members, S, bd0, bi0)
    assert _kernels.launches["entry_select"] == before + 1
    pd, pi = entry_select_plain(G, xn, qn, members, S)
    torch.cuda.synchronize()
    assert torch.equal(bd0[:, :S].view(torch.int32), pd.view(torch.int32)), float((bd0[:, :S] - pd).abs().max())
    assert torch.equal(bi0[:, :S], pi), int((bi0[:, :S] != pi).sum())
    assert bool((bd0[:, S:] == -1.0).all()) and bool((bi0[:, S:] == -7).all())
    if ties and S > 1 and B > 1:  # the rows hold the ties the order has to keep
        assert bool((pd[:, 1:] == pd[:, :-1]).any())


def test_entry_select_refuses_a_misaligned_or_strided_operand(dev):
    G, xn, qn, members = _entry_inputs(dev, 8, 1024, True, seed=1)
    beams = torch.zeros((8, 129), device=dev), torch.zeros((8, 129), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # 4-byte offset: not 16-byte aligned
        entry_select_cuda(G, xn[1:], qn, members[1:], 8, *beams)
    with pytest.raises(ValueError):
        entry_select(G.T.contiguous().T, xn, qn, members, 8, *beams)
    with pytest.raises(ValueError):
        entry_select(G, xn, qn, members, S_MAX + 1, *beams)
    with pytest.raises(ValueError):
        entry_select(G, xn.cpu(), qn, members, 8, *beams)


def _plain_entry_select(G, xn, qn, members, S, bd0, bi0):
    """The plain version on the card in place of K5."""
    bd0[:, :S], bi0[:, :S] = entry_select_plain(G, xn, qn, members, S)


@pytest.mark.parametrize("layout", ["bf16", "s8", "rows", "code_rows"])
def test_fused_query_batch_identical_with_entry_select(dev, canonical_rows, layout, monkeypatch):
    """The fused route on the canonical graph (933 entry members, 8 seeds)
    over bf16 blocks, s8 blocks, the rows layout and the s8 code rows: seeds, ids, distances
    and distance computations identical with K5 and with the full stable
    sort it replaces; one K5 launch a call."""
    g, rows = canonical_rows
    if layout == "s8":
        monkeypatch.setattr(g, "layout", CodeBlocks.build(g))
    elif layout == "rows":
        monkeypatch.setattr(g, "layout", rows)
    elif layout == "code_rows":
        monkeypatch.setattr(g, "layout", CodeRows.build(g))
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((4096, 128)).astype(np.float32)).to(dev)
    before = _kernels.launches["entry_select"]
    seeds = entry_beam(g, q, 128, 8)
    got = search.fused_query_batch(g, q, ef=120, k=10, ef_cap=128, expand=2, cand=8, seeds=8)
    assert _kernels.launches["entry_select"] == before + 2
    monkeypatch.setattr(search, "entry_select", _plain_entry_select)
    ref_seeds = entry_beam(g, q, 128, 8)
    ref = search.fused_query_batch(g, q, ef=120, k=10, ef_cap=128, expand=2, cand=8, seeds=8)
    assert _kernels.launches["entry_select"] == before + 2
    torch.cuda.synchronize()
    assert g.entry_members_n < g.entry_members.shape[0] == 1024
    for a, b in zip(seeds[:2], ref_seeds[:2]):
        assert torch.equal(a, b)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_entry_select_launches_once_a_chunk(dev):
    """An engine on the fused route seeds each chunk through one K5 launch,
    beside its one traversal."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((6000, 128)).astype(np.float32)
    q = rng.standard_normal((1000, 128)).astype(np.float32)
    cfg = AntitopoConfig(M=8, ef_construction=40, prune_cand=40, query_expand=2, fused_cand=8, entry_seeds=8,
                         ef_search=60, use_packed=True, use_fused=True, query_block=128)
    eng = AntitopoEngine(config=cfg, device="cuda")
    eng.store_many_vectors(x)
    eng.build()
    eng.query_k_batch(q[:10], 10)
    assert eng.graph.entry_members is not None
    before = _kernels.launches["entry_select"], _kernels.launches["fused_search"]
    eng.query_k_batch(q, 10)
    chunks = -(-1000 // 128)
    assert (_kernels.launches["entry_select"], _kernels.launches["fused_search"]) == (before[0] + chunks,
                                                                                       before[1] + chunks)


def _assert_packed_matches_plain(packed, pn, pi, sel, q, topt, exact=False):
    """One K4 launch against its plain version on the same CUDA tensors:
    the same +inf pattern, distances within rtol 1e-5 / atol 1e-3 (equal
    with ``exact``), ids equal at topt=0 or with ``exact``, else differing
    only on ties (and in under 1% of the slots); every pass past a node's
    finite slots gives the node's lane-0 id.  Returns the kernel's output."""
    B, E = sel.shape
    before = _kernels.launches["packed_score"]
    d, ids = packed_score(packed, pn, pi, sel, q, topt=topt)
    assert _kernels.launches["packed_score"] == before + 1
    pd, pids = packed_score_plain(packed, pn, pi, sel, q, topt=topt)
    torch.cuda.synchronize()
    fin = torch.isfinite(pd)
    assert torch.equal(torch.isfinite(d), fin)
    if exact:
        assert torch.equal(d[fin], pd[fin]), float((d[fin] - pd[fin]).abs().max())
        assert torch.equal(ids, pids), int((ids != pids).sum())
    else:
        torch.testing.assert_close(d[fin], pd[fin], rtol=1e-5, atol=1e-3)
    if topt == 0:
        assert torch.equal(ids, pids)
        return d, ids
    # an id may differ from the plain one only on a tie: each kernel id's
    # distance, looked up in the node's full row, is the distance it reports
    full_d, full_i = packed_score_plain(packed, pn, pi, sel, q, topt=0)
    full_d, full_i = full_d.view(B, E, -1), full_i.view(B, E, -1)
    kd, ki = d.view(B, E, topt), ids.view(B, E, topt)
    hit = (full_i[:, :, None, :] == ki[:, :, :, None]) & torch.isfinite(kd)[:, :, :, None]
    looked_up = torch.where(hit, full_d[:, :, None, :], 0.0).sum(-1)
    ok = torch.isfinite(kd)
    torch.testing.assert_close(looked_up[ok], kd[ok], rtol=1e-5, atol=1e-3)
    assert float((ids != pids).float().mean()) < 0.01
    # passes past the finite slots give the node's lane-0 id
    lane0 = pi[sel.long()][:, :, :1].expand(B, E, topt)
    assert torch.equal(ki[~ok], lane0[~ok])
    return d, ids


@pytest.mark.parametrize("topt", [0, 8])
@pytest.mark.parametrize("R", [40, 128])
@pytest.mark.parametrize("B", [1, 37, 256])
def test_packed_score_matches_plain(dev, B, R, topt):
    """K4 against its plain version on the same CUDA tensors, RS = 48 or 128
    (R_tile 128), sentinel selections and short rows included."""
    n, E = 4000, 2
    vecs, norms, adj, rng = _random_graph(dev, n, R, 128, seed=B + R + topt)
    adj[::7, R - 9 :] = n
    adj[::11, 3:] = n
    packed, pn, pi = build_packed(vecs, norms, adj)
    sel = torch.from_numpy(rng.integers(0, n + 1, (B, E)).astype(np.int32)).to(dev)
    sel[::3, -1] = n
    sel[0, 0] = 0  # a row of three neighbours
    q = torch.from_numpy(rng.standard_normal((B, 128)).astype(np.float32)).to(dev)
    _assert_packed_matches_plain(packed, pn, pi, sel, q, topt)


def _packed_case(dev, n, R, D, B, E, seed, vecs=None):
    """A random layout of n nodes of R neighbours at width D (short rows and
    rows of three neighbours included), B x E selections (sentinels
    included) and N(0, 1) queries; ``vecs`` (n + 1, D) replaces the rows."""
    rng = np.random.default_rng(seed)
    if vecs is None:
        vecs, norms, adj, rng = _random_graph(dev, n, R, D, seed)
    else:
        norms = (vecs * vecs).sum(1)
        norms[n] = float("inf")
        adj = np.stack([rng.choice(n, size=R, replace=False) for _ in range(n)] + [np.full(R, n)])
        adj = torch.from_numpy(adj.astype(np.int32)).to(dev)
    adj[::7, R - 9 :] = n
    adj[::11, 3:] = n
    packed, pn, pi = build_packed(vecs, norms, adj)
    sel = torch.from_numpy(rng.integers(0, n + 1, (B, E)).astype(np.int32)).to(dev)
    sel[::3, -1] = n
    sel[0, 0] = 0  # a row of three neighbours
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
    return packed, pn, pi, sel, q


@pytest.mark.parametrize("D", [8, 64, 128, 512])
@pytest.mark.parametrize("E", [1, 2, 4])
@pytest.mark.parametrize("topt", [1, 8, 16, 128])
def test_packed_score_over_topt_e_and_width(dev, topt, E, D):
    """K4 at every selection width up to R_tile, E 1-4, and D from one
    16-byte column to four 32 KB chunks a block (D = 512: two slots)."""
    case = _packed_case(dev, 1000, 120, D, 33, E, seed=topt + 10 * E + D)
    _assert_packed_matches_plain(*case, topt)


@pytest.mark.parametrize(
    "n,R,D,topt", [(600, 250, 512, 0), (600, 250, 512, 8), (600, 250, 512, 256), (200, 32, 4096, 0), (200, 32, 4096, 8)]
)
def test_packed_score_block_above_one_slot(dev, n, R, D, topt):
    """Blocks larger than one 32 KB staging slot: RS = 256 rows of D = 512
    (256 KB, R_tile 256: two keys a thread) in eight 32-row chunks through
    two slots; RS = 32 rows of D = 4096 (256 KB) in two 16-row chunks
    through one slot, as two 128 KB slots would not fit."""
    packed, pn, pi, sel, q = _packed_case(dev, n, R, D, 17, 2, seed=topt + D)
    assert packed.shape[1] * D * 2 > 32768
    _assert_packed_matches_plain(packed, pn, pi, sel, q, topt)


def _integer_rows(dev, n, D, seed, levels=9):
    """n integer-valued rows in [-(levels // 2), levels // 2] and a zero
    sentinel row: bf16 holds them exactly and every dot is an exact f32 sum,
    in any order."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-(levels // 2), levels // 2 + 1, (n, D)).astype(np.float32)
    return torch.from_numpy(np.concatenate([x, np.zeros((1, D), np.float32)])).to(dev)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("topt", [0, 8, 128])
def test_packed_score_negative_distances(dev, topt, D):
    """Queries that are scaled copies of one of their node's rows, so that
    2 q.x > |x|^2: the partial distances go negative (no |q|^2, no clamp).
    Integer rows make every distance exact, ties included, so the ids must
    equal the plain version's: the key's sign-aware order is the float
    order."""
    n, B, E = 1000, 64, 2
    vecs = _integer_rows(dev, n, D, seed=topt + D)
    packed, pn, pi, sel, _ = _packed_case(dev, n, 120, D, B, E, seed=topt + D, vecs=vecs)
    sel[:, 0] = torch.arange(1, B + 1, device=dev, dtype=torch.int32)  # real nodes, short rows among them
    q = 3.0 * packed[sel[:, 0].long(), 1].float()
    d, _ = _assert_packed_matches_plain(packed, pn, pi, sel, q, topt, exact=True)
    assert int((d < 0).sum()) >= B


@pytest.mark.parametrize("topt", [0, 1, 8, 128])
def test_packed_score_all_tie_blocks(dev, topt):
    """Every row a copy of one vector: every finite slot of a node ties, so
    the ids come out in lane order, identical to the plain version's."""
    n, D, B, E = 500, 128, 40, 2
    vecs = _integer_rows(dev, 1, D, seed=5)[:1].expand(n + 1, D).clone()
    vecs[n] = 0
    packed, pn, pi, sel, _ = _packed_case(dev, n, 120, D, B, E, seed=topt, vecs=vecs)
    q = _integer_rows(dev, B, D, seed=6, levels=5)[:B]
    d, ids = _assert_packed_matches_plain(packed, pn, pi, sel, q, topt, exact=True)
    w = topt or pn.shape[1]
    d3, i3 = d.view(B, E, w), ids.view(B, E, w)
    fin = torch.isfinite(d3)
    lanes = pi[sel.long()][:, :, :w]
    assert torch.equal(i3[fin], lanes[fin])


@pytest.mark.parametrize("topt", [8, 16, 128])
def test_packed_score_exhausted_passes(dev, topt):
    """All-sentinel selections, and nodes with fewer finite slots than topt
    (three neighbours, or nine sentinel tails): every pass past the finite
    slots gives (+inf, ids[node, 0])."""
    n, B, E = 1000, 32, 4
    packed, pn, pi, sel, q = _packed_case(dev, n, 120, 128, B, E, seed=topt)
    sel[: B // 2] = n  # queries whose every selection is the sentinel
    sel[B // 2 :, :2] = torch.arange(0, 11 * (B // 2), 11, device=dev, dtype=torch.int32)[:, None]  # three neighbours
    d, ids = _assert_packed_matches_plain(packed, pn, pi, sel, q, topt)
    d3, i3 = d.view(B, E, topt), ids.view(B, E, topt)
    assert not torch.isfinite(d3[: B // 2]).any()
    assert int(torch.isfinite(d3[B // 2 :, :2]).sum(-1).max()) == 3
    lane0 = pi[sel.long()][:, :, :1].expand(B, E, topt)
    assert torch.equal(i3[~torch.isfinite(d3)], lane0[~torch.isfinite(d3)])


def test_packed_score_large_batch(dev):
    """B = 16384 pairs of two (the large-B shape of the timing), topt 8."""
    case = _packed_case(dev, 4000, 120, 128, 16384, 2, seed=16384)
    _assert_packed_matches_plain(*case, 8)


@pytest.mark.parametrize("use_packed", [True, False])
def test_query_batch_matches_cpu(dev, use_packed):
    """The per-iteration route on the card (K4 with use_packed) against the
    same call on CPU tensors (plain versions), on one graph."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3000, 64)).astype(np.float32)
    q = rng.standard_normal((64, 128)).astype(np.float32)
    q[:, 64:] = 0
    g_dev = build_index(x, BuildConfig(M=16, ef_construction=80), dev)
    g_cpu = graph_from_numpy(graph_to_numpy(g_dev), "cpu")
    out = {}
    for g in (g_dev, g_cpu):
        if use_packed:
            g.layout = Blocks.build(g)
        before = _kernels.launches["packed_score"]
        qg = torch.from_numpy(q).to(g.vectors.device)
        ids, _, ncomp = query_batch(g, qg, 10, 64, expand=2, use_packed=use_packed, packed_topt=8)
        launched = _kernels.launches["packed_score"] - before
        assert (launched > 0) == (use_packed and g is g_dev)
        out[g.vectors.device.type] = (ids.cpu().numpy(), int(ncomp.sum()))
    (a, na), (b, nb) = out["cuda"], out["cpu"]
    overlap = np.mean([len(set(r) & set(s)) / 10 for r, s in zip(a, b)])
    assert overlap >= 0.99, overlap
    assert abs(na - nb) <= 0.01 * nb


@pytest.fixture(scope="module")
def beam_graph_case():
    """A 3000-row graph (D=64 padded to 128) on the card with its bf16
    packed layout, and 66 queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(19)
    x = rng.standard_normal((3000, 64)).astype(np.float32)
    q = np.pad(rng.standard_normal((66, 64)).astype(np.float32), ((0, 0), (0, 64)))
    g = build_index(x, BuildConfig(M=16, ef_construction=80), "cuda")
    g.layout = Blocks.build(g)
    return x, torch.from_numpy(q).cuda(), g


def _eager(monkeypatch):
    monkeypatch.setattr(search, "_replays", lambda q, packed, ortho_chosen: False)


@pytest.mark.parametrize("max_iters", [13, 8 * 64 + 16])
@pytest.mark.parametrize("E", [1, 2])
@pytest.mark.parametrize("topt", [0, 8])
@pytest.mark.parametrize("B", [1, 8, 33])
def test_beam_graph_identical_to_eager(beam_graph_case, monkeypatch, B, topt, E, max_iters):
    """The packed beam replayed from its captured graph against the eager
    loop on the same arrays: ids, distances and counts bit for bit, on the
    call that captures and on a second call that replays over new queries
    and entries; ``max_iters`` 13 is no multiple of the block, and 33
    queries run in a capture of 64 rows."""
    _, q, g = beam_graph_case
    rng = np.random.default_rng(B + topt + E)
    graphs = {}
    kw = dict(expand=E, packed=g.layout.packed, packed_norms=g.layout.norms, packed_ids=g.layout.ids, packed_topt=topt)
    got = []
    for start in (0, B):
        qb = q[start : start + B]
        ep = torch.from_numpy(rng.integers(0, g.n, (B, 1)).astype(np.int32)).cuda()
        args = (g.vectors, g.norms, g.adj_bottom, qb, squared_norms(qb), ep, 64, max_iters, g.sentinel)
        iters = []
        got.append((args, beam_search(*args, **kw, iters=iters, graphs=graphs), iters[0]))
        assert iters[0] % search.BEAM_BLOCK == 0 or iters[0] == max_iters
    assert list(graphs) == [(1 << (B - 1).bit_length(), 64, E, topt)]
    _eager(monkeypatch)
    for args, replayed, it in got:
        iters = []
        want = beam_search(*args, **kw, iters=iters)
        for a, b in zip(replayed, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert iters[0] <= it < iters[0] + search.BEAM_BLOCK


def _engine_lists(eng, q, monkeypatch):
    """The engine's lists of ``q`` replayed, then on the eager loop."""
    replayed = eng.query_k_batch(q, 10)
    with monkeypatch.context() as m:
        _eager(m)
        return replayed, eng.query_k_batch(q, 10)


def test_beam_graph_recaptured_after_a_new_layout(beam_graph_case, monkeypatch):
    """A captured beam is dropped with the packed arrays it reads: after
    ``set_packed_dtype`` and after a second ``build`` the next small call
    captures a fresh graph over the new arrays, and its lists equal the
    eager loop's; the engine's graphs go with the engine."""
    x, q, _ = beam_graph_case
    qh = q[:8].cpu().numpy()
    eng = AntitopoEngine(config=AntitopoConfig(M=16, ef_construction=80, ef_search=64, query_expand=2,
                                               packed_topt=8, wave_size=512), device="cuda")
    eng.store_many_vectors(x[:2500])
    eng.build()
    prev = None
    for change in ("first", "packed_dtype", "build"):
        if change == "packed_dtype":
            eng.set_packed_dtype("i8")
            assert eng.graph.layout is None
            eng.query_k_batch(qh, 10)  # the gather beam over the s8 layout: no graph
            assert type(eng.graph.layout) is CodeBlocks and not eng.graph.layout.beam_graphs
            eng.set_packed_dtype("bf16")
        elif change == "build":
            eng.store_many_vectors(x[2500:])
            eng.build()
            assert eng.graph.layout is None
        replayed, eager = _engine_lists(eng, qh, monkeypatch)
        np.testing.assert_array_equal(replayed, eager)
        (captured,) = eng.graph.layout.beam_graphs.values()
        assert captured is not prev, change
        prev = captured
    ref = weakref.ref(captured)
    del eng, prev, captured
    gc.collect()
    assert ref() is None


def test_traced_call_syncs_are_descent_steps_and_replays(beam_graph_case, tmp_path, monkeypatch):
    """On a traced single-query engine call: one ``expann.sync`` a descent
    step and one a replay (or an eager tail step), one
    ``expann.search.replay`` a replay, the replays run the call's
    iterations in blocks, and the K4 launches counted are the
    iterations."""
    x, q, _ = beam_graph_case
    eng = AntitopoEngine(config=AntitopoConfig(M=16, ef_construction=80, ef_search=64, query_expand=2,
                                               packed_topt=8), device="cuda")
    eng.store_many_vectors(x)
    eng.build()
    qh = q[:1].cpu().numpy()
    eng.query_k_batch(qh, 10)  # the packed layout and the capture, before the trace
    iters, steps = [], []
    real_beam, real_any = search.beam_search, torch.Tensor.any

    def counted_beam(*args, **kwargs):
        return real_beam(*args, **kwargs, iters=iters)

    def counted_any(self, *args, **kwargs):
        steps.append(1)
        return real_any(self, *args, **kwargs)

    monkeypatch.setattr(search, "beam_search", counted_beam)
    monkeypatch.setattr(torch.Tensor, "any", counted_any)
    k4 = _kernels.launches["packed_score"]
    with profiling.trace(str(tmp_path), device="cuda"):
        eng.query_k_batch(qh, 10)
    monkeypatch.undo()
    assert _kernels.launches["packed_score"] - k4 == iters[0]
    (path,) = tmp_path.glob("trace_*.json")
    spans = Counter(e["name"] for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("cat") == "user_annotation" and e.get("name", "").startswith("expann."))
    replays = spans["expann.search.replay"]
    tail = iters[0] - replays * search.BEAM_BLOCK
    assert len(iters) == 1 and replays > 0 and 0 <= tail < search.BEAM_BLOCK
    assert len(steps) > 0 and spans["expann.sync"] == len(steps) + replays + tail


@pytest.mark.parametrize("kind,seed", probe_fused.CASES, ids=[f"{k}-{s}" for k, s in probe_fused.CASES])
def test_probe_fused_identical_to_plain(dev, kind, seed):
    """P1: the bulk copy by an in-kernel index and the data-dependent loop
    give exactly the plain version's arrays (``probe_fused.CASES``: 8
    seeds, ties in row 0, the minimum in column 127, an entry in the
    table's last row, loop caps of 0 and 1)."""
    tab, x, max_iters, entry = probe_fused.case_inputs(dev, kind, seed)
    before = _kernels.launches["probe_fused"]
    o, w = probe_fused.probe_fused(tab, x, max_iters)
    assert _kernels.launches["probe_fused"] == before + 1
    po, pw = probe_fused.probe_fused_plain(tab, x, max_iters)
    torch.cuda.synchronize()
    assert torch.equal(o, po) and torch.equal(w, pw), (float(w[0, 0]), float(pw[0, 0]))
    if entry is not None:
        assert torch.equal(o, tab[entry])
    if max_iters < probe_fused.MAX_ITERS:
        assert float(w[0, 0]) == max_iters


@pytest.mark.parametrize(
    "R,nbuf", [(R, nbuf) for R in (16, 32, 64, 128) for nbuf in (2, 4, 8) if (R, nbuf) != (128, 8)]
)
def test_block_gather_matches_plain(dev, R, nbuf):
    """P2 at every ring of the sweep that fits, at an odd step count that
    wraps each block's ring several times (the grid is at most 8 blocks of
    256 threads per SM, so ~31 steps per block on 132 SMs): every step's row
    against the plain version, |d| <= 1e-4 (1 + |ref|) (bf16 inputs, f32
    sums in another order)."""
    NB, G = 4096, 33001
    gen = torch.Generator(device=dev).manual_seed(R + nbuf)
    packed = torch.randn((NB, R, 128), generator=gen, device=dev).to(torch.bfloat16)
    ids = torch.randint(0, NB, (G,), generator=gen, device=dev, dtype=torch.int32)
    q = torch.randn((1, 128), generator=gen, device=dev).to(torch.bfloat16)
    before = _kernels.launches["block_gather"]
    got = perf_pallas_gather.block_gather_scores(packed, ids, q, nbuf)
    assert _kernels.launches["block_gather"] == before + 1
    ref = perf_pallas_gather.block_gather_scores_plain(packed, ids, q)
    torch.cuda.synchronize()
    assert got.shape == (G, R)
    assert bool(((got - ref).abs() <= 1e-4 * (1 + ref.abs())).all()), float((got - ref).abs().max())
    assert torch.equal(perf_pallas_gather.run_block_gather(packed, ids, q, nbuf), got[-1:])


def test_block_gather_refuses_a_ring_that_does_not_fit(dev):
    packed = torch.zeros((16, 128, 128), dtype=torch.bfloat16, device=dev)
    ids = torch.zeros((8,), dtype=torch.int32, device=dev)
    q = torch.zeros((1, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        perf_pallas_gather.block_gather_scores(packed, ids, q, 8)


@pytest.mark.parametrize("max_iters", probe_step_overhead.FUSED_ITERS)
def test_fused_search_matches_plain_on_probe_layout(dev, max_iters):
    """K1 as P3's companion drives it (random 4097-block layout, ef=120,
    expand=4, cand=32) against its plain version on a slice of the queries,
    at both iteration caps: beams, distances, distance counts and iteration
    counts.  The two sum q.x in another order, so a near-tie may flip an
    insertion; whole-beam agreement is the gate."""
    packed, norms, ids, q, bd0, bi0 = probe_step_overhead.fused_inputs(dev, b=256)
    n = probe_step_overhead.NODES
    got = fused_search(packed, norms, ids, q, bd0, bi0, ef=120, expand=4, cand=32, max_iters=max_iters)
    ref = fused_search_plain(packed, norms, ids, q, bd0, bi0, 120, 4, topt_for(32, 4, 128), max_iters)
    torch.cuda.synchronize()
    agree = probe_step_overhead.fused_agreement(got, ref, sentinel=n)
    assert agree["same_beams"] >= 0.95 and agree["overlap"] >= 0.99, agree
    assert agree["dist_err"] <= 2e-3 + 1e-5 * agree["dist_max"], agree
    assert agree["same_iters"] >= 0.95 and abs(agree["iters_ratio"] - 1) <= 0.01, agree
    assert abs(agree["ncomp_ratio"] - 1) <= 0.01, agree
    assert int(got[3].max()) <= max_iters


@pytest.fixture(scope="module")
def step_inputs():
    """P3's inputs at the tool's shape, made once for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return probe_step_overhead.inputs(torch.device("cuda"))


@pytest.mark.parametrize("cluster", probe_step_overhead.CLUSTER_SWEEP)
@pytest.mark.parametrize("iters", [0, 1, 24])
@pytest.mark.parametrize("B", [8, 1000, 8192])
@pytest.mark.parametrize("feat", probe_step_overhead.FEATURES)
def test_step_overhead_matches_plain(dev, step_inputs, feat, B, iters, cluster):
    """P3, every feature, at B = 8 (one tile: at cluster c > 1 the other
    c - 1 blocks are padding), 1000 (125 tiles, not a multiple of any c > 1)
    and 8192, at 0, 1 and 24 steps and every cluster size: rtol = atol =
    1e-6, and identical (the kernel rounds every multiply and add as the
    plain version does)."""
    q, bd0, packed = step_inputs
    q, bd0 = q[:B], bd0[:B]
    before = _kernels.launches["step_overhead"]
    got = probe_step_overhead.step_overhead(q, bd0, packed, feat, iters, cluster)
    assert _kernels.launches["step_overhead"] == before + 1
    ref = probe_step_overhead.step_overhead_plain(q, bd0, packed, feat, iters)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("cluster", probe_step_overhead.CLUSTER_SWEEP)
def test_step_overhead_ring_phases_wrap(dev, step_inputs, cluster):
    """P3 with ``dma`` at 2 * NSLOT + 1 steps: each step sends 32 copies
    through the NSLOT-slot ring, so every slot's full and empty barriers
    complete ~75 phases and flip their parity each time; a wrong parity
    hangs a wait (NaN after the timeout) or reads a slot early.  Every
    step's copied row moves the result, so the last step's copy is read."""
    q, bd0, packed = step_inputs
    iters = 2 * probe_step_overhead.NSLOT + 1
    got = probe_step_overhead.step_overhead(q, bd0, packed, "dma", iters, cluster)
    ref = probe_step_overhead.step_overhead_plain(q, bd0, packed, "dma", iters)
    short = probe_step_overhead.step_overhead_plain(q, bd0, packed, "dma", iters - 1)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert not torch.equal(got, short)


@pytest.mark.parametrize("cluster", probe_step_overhead.CLUSTER_SWEEP)
@pytest.mark.parametrize("B", [8, 1000, 8192])
def test_step_overhead_copies_are_visible(dev, step_inputs, B, cluster):
    """P3 with ``dma`` on a beam of ~1e-7: each step's copied row (times
    1e-9) then moves every value by many ulps, so a copy of the wrong
    block, a slot read before its copy lands or a copy that never happens
    changes the result.  Identical to the plain version, which differs
    from the run without copies in nearly every value."""
    q, bd0, packed = step_inputs
    q, bd0 = q[:B], bd0[:B] * 1e-7
    got = probe_step_overhead.step_overhead(q, bd0, packed, "dma", probe_step_overhead.ITERS, cluster)
    ref = probe_step_overhead.step_overhead_plain(q, bd0, packed, "dma")
    bare = probe_step_overhead.step_overhead_plain(q, bd0, packed, "")
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert float((ref != bare).float().mean()) > 0.99


def test_step_overhead_footprint_and_clusters(dev):
    """The ``dma`` footprint is the ring alone and the Python mirror of it
    is the kernel's; at least two tiles reside on an SM (CUDA's occupancy
    calculator: two clusters of one block an SM); the card holds clusters
    of every size of the sweep."""
    lib = _kernels.library()
    assert lib.expann_step_overhead_smem_bytes(128) == probe_step_overhead.ring_bytes(128)
    for c in probe_step_overhead.CLUSTER_SWEEP:
        assert probe_step_overhead.active_clusters(128, True, c, dev) >= 1, c
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert probe_step_overhead.active_clusters(128, True, 1, dev) >= 2 * sms


@pytest.mark.parametrize("mode", probe_lanes.MODES)
def test_lane_ops_match_plain(dev, mode):
    """P4, every mode at the tool's shape (512 rows, 512 steps): identical
    (every min, add and multiply rounds as the plain version's), but the
    prefix sum, within rtol 1e-5 (another summation order) and atol 1e-6
    where a value passes near 0."""
    x = probe_lanes.inputs(dev)
    x[:, 3] = x[:, 70]
    before = _kernels.launches["probe_lanes"]
    got = probe_lanes.lane_ops(x, mode)
    assert _kernels.launches["probe_lanes"] == before + 1
    ref = probe_lanes.lane_ops_plain(x, mode)
    torch.cuda.synchronize()
    if mode == "matmul_cumsum":
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got, ref)


@pytest.mark.parametrize("warps", probe_lanes.WARPS_SWEEP)
@pytest.mark.parametrize("mode", ["reduce", "reduce3", "carry6"])
def test_lane_ops_edge_rows(dev, mode, warps):
    """P4's reductions by keys on the edge rows (the min tied across lanes
    and within a lane's 4 values, a negative row, -0.0 beside +0.0, +inf, a
    row of +inf, a row of equal values), 512 steps, at every launch shape:
    identical to the plain version."""
    x = probe_lanes.edge_rows(dev)
    got = probe_lanes.lane_ops_cuda(x, mode, warps=warps)
    ref = probe_lanes.lane_ops_plain(x, mode)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("warps", probe_lanes.WARPS_SWEEP)
def test_lane_ops_launch_shapes(dev, warps):
    """P4 at every launch shape of --ab, every mode but the prefix sum, on
    a row count that leaves the last block part-filled: identical."""
    x = probe_lanes.inputs(dev)[:509]
    for mode in probe_lanes.MODES:
        if mode != "matmul_cumsum":
            got = probe_lanes.lane_ops_cuda(x, mode, 64, warps)
            assert torch.equal(got, probe_lanes.lane_ops_plain(x, mode, 64)), mode


@pytest.fixture
def two_cards():
    """cuda:0 and cuda:1; skips where fewer than two cards are visible."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (a launch on cuda:1 while cuda:0 is current)")
    return torch.device("cuda:0"), torch.device("cuda:1")


def test_kernels_launch_on_the_operands_device(two_cards):
    """K2, K1 and K4 with their operands on cuda:1 while cuda:0 is the
    current device: each wrapper makes the operands' device current for
    its launch (the shared-memory limit is set per device, and K2 at
    k=128, K1 at EF=256, K4 at R=128 need more than the default), so each
    result equals the same call on cuda:0 and the current device is left
    as it was."""
    d0, d1 = two_cards
    torch.cuda.set_device(d0)
    q, x = _flat_bf16_inputs(d0, 5000, 300, 128, seed=12)
    vecs, norms, adj, rng = _random_graph(d0, 4000, 120, 256, seed=13)
    packed, pn, pi = build_packed(vecs, norms, adj)
    B, EF = 64, 256
    qg = torch.from_numpy(rng.standard_normal((B, 256)).astype(np.float32)).to(d0)
    bd0 = torch.full((B, EF), float("inf"), device=d0)
    bi0 = torch.full((B, EF), 4000, dtype=torch.int32, device=d0)
    bi0[:, 0] = torch.from_numpy(rng.integers(0, 4000, B).astype(np.int32)).to(d0)
    bd0[:, 0] = ((qg - vecs[bi0[:, 0].long()]) ** 2).sum(1)
    sel = torch.from_numpy(rng.integers(0, 4001, (B, 2)).astype(np.int32)).to(d0)
    calls = {
        "flat_topk": lambda t: flat_topk(t(q), t(x), 128),
        "fused_search": lambda t: fused_search(t(packed), t(pn), t(pi), t(qg), t(bd0), t(bi0), 200, expand=2, cand=8),
        "packed_score": lambda t: packed_score(t(packed), t(pn), t(pi), t(sel), t(qg), 8),
    }
    for name, call in calls.items():
        before = _kernels.launches[name]
        on0 = call(lambda a: a)
        on1 = call(lambda a: a.to(d1))
        torch.cuda.synchronize(d0)
        torch.cuda.synchronize(d1)
        assert torch.cuda.current_device() == 0
        assert _kernels.launches[name] == before + 2
        for a, b in zip(on0, on1):
            assert b.device == d1 and torch.equal(a, b.to(d0)), name
