"""The port's multi-device layer (``expann_tpu_torch/parallel/sharded.py``)
on a mesh of 8 CPU devices, ``[cpu] * 8``, against the JAX package's on its
8 virtual CPU devices (tests/conftest.py), at the sizes and seeds of
tests/test_sharded.py: the same numpy inputs through both packages."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from expann_tpu.models.antitopo import AntitopoConfig as JEngineConfig
from expann_tpu.models.antitopo import AntitopoEngine as JEngine
from expann_tpu.models.build import BuildConfig as JConfig
from expann_tpu.models.build import build_index as j_build_index
from expann_tpu.ops.pallas_beam import build_packed as j_build_packed
from expann_tpu.parallel import sharded as js
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.models.build import BuildConfig, build_index
from expann_tpu_torch.models.layout import Blocks
from expann_tpu_torch.models.search import fused_query_batch, query_batch
from expann_tpu_torch.ops.topk import flat_topk_plain
from expann_tpu_torch.parallel import sharded as ts
from expann_tpu_torch.tools.dryrun_multichip import dryrun_multichip

torch.set_num_threads(2)

MESH = ts.make_mesh(devices=["cpu"] * 8)


def _data(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32), rng.standard_normal((m, d)).astype(np.float32)


def _gt(x, q, k):
    d2 = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :k]


def _recall(ans, gt):
    k = gt.shape[1]
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(ans, gt)]))


def _rows_unique(ans):
    return all(len(set(r[r >= 0].tolist())) == int((r >= 0).sum()) for r in ans)


@functools.lru_cache(maxsize=None)
def _built(n, m, d, seed, efc):
    """One corpus, its queries, and the sharded index of both packages
    (M=8, ``efc``), shared by the tests that use the same JAX test data."""
    x, q = _data(n, m, d, seed)
    jidx = js.build_sharded(x, JConfig(M=8, ef_construction=efc), js.make_mesh(8))
    tidx = ts.build_sharded(x, BuildConfig(M=8, ef_construction=efc), MESH)
    return x, q, jidx, tidx


def _jax_arrays(jidx) -> dict:
    return {"vectors": np.asarray(jidx.vectors), "norms": np.asarray(jidx.norms), "adj": np.asarray(jidx.adj),
            "start": np.asarray(jidx.start), "layer_slots": [np.asarray(a) for a in jidx.layer_slots],
            "layer_adjs": [np.asarray(a) for a in jidx.layer_adjs], "n_total": jidx.n_total}


def _agreement(t_ids, j_ids, gt):
    """Rows identical, top-k overlap, recall difference."""
    k = gt.shape[1]
    same = float((t_ids == j_ids).all(1).mean())
    overlap = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(t_ids, j_ids)]))
    return same, overlap, _recall(t_ids, gt) - _recall(j_ids, gt)


def test_mesh_has_8_devices():
    """Both meshes have 8 devices; the port's default mesh is the visible
    CUDA devices, and asking for more than are visible raises."""
    assert len(jax.devices()) == 8
    assert len(MESH) == 8 and all(d.type == "cpu" for d in MESH)
    count = torch.cuda.device_count()
    with pytest.raises(ValueError):
        ts.make_mesh(n_devices=count + 1)
    if count == 0:
        with pytest.raises(ValueError):
            ts.make_mesh()
    else:
        assert ts.make_mesh() == tuple(torch.device("cuda", i) for i in range(count))
    assert ts.as_mesh("cpu") == (torch.device("cpu"),)


def test_sharded_query_recall():
    """Recall@10 at ef=40 >= 0.9 in both packages, each on its own build;
    the builds sum f32 matmuls in another order, so the gate between them is
    recall within 0.01."""
    x, q, jidx, tidx = _built(2400, 50, 32, 0, 60)
    gt = _gt(x, q, 10)
    r_t = _recall(ts.sharded_query_batch(tidx, q, k=10, ef=40), gt)
    r_j = _recall(js.sharded_query_batch(jidx, q, k=10, ef=40), gt)
    assert r_t >= 0.9 and abs(r_t - r_j) <= 0.01, (r_t, r_j)


def test_sharded_query_no_duplicate_global_ids():
    x, q, jidx, tidx = _built(1600, 20, 16, 2, 40)
    t_ans = ts.sharded_query_batch(tidx, q, k=10, ef=30)
    assert _rows_unique(t_ans) and _rows_unique(js.sharded_query_batch(jidx, q, k=10, ef=30))
    assert ((t_ans >= 0) & (t_ans < x.shape[0])).all()


def test_sharded_uneven_corpus():
    """n = 1001 over 8 shards: the last shard's 119 rows padded to 126 with
    +inf-norm rows whose adjacency is all sentinel, laid out as the JAX
    index lays them; no padding row is ever answered."""
    x, q, jidx, tidx = _built(1001, 10, 16, 3, 40)
    ns = tidx.n_shard
    assert ns == jidx.n_shard == 126 and tidx.n_total == 1001
    real = 1001 - 7 * ns
    for arrays in (ts.sharded_to_numpy(tidx), _jax_arrays(jidx)):
        assert np.isinf(arrays["norms"][7, real:]).all() and (arrays["vectors"][7, real:] == 0).all()
        assert (arrays["adj"][7, real:] == ns).all() and (arrays["adj"][7, :real] <= ns).all()
        for sl, al in zip(arrays["layer_slots"], arrays["layer_adjs"]):
            assert (sl[7, real:] == al.shape[1] - 1).all()  # the common sentinel slot nl_max
    t_ans = ts.sharded_query_batch(tidx, q, k=5, ef=20)
    assert (t_ans[t_ans >= 0] < 1001).all()
    j_ans = js.sharded_query_batch(jidx, q, k=5, ef=20)
    assert (j_ans[j_ans >= 0] < 1001).all()


def test_sharded_build_step_matches_local_prune():
    """Each wave vector's nearest neighbour is its first selected edge
    (the top-C is globally exact), in both packages."""
    x, _ = _data(800, 1, 16, seed=4)
    wave, _ = _data(16, 1, 16, seed=5)
    _, _, jidx, tidx = _built(800, 1, 16, 4, 40)
    nn = ((wave[:, None, :] - x[None]) ** 2).sum(-1).argmin(1)
    wp = np.pad(wave, ((0, 0), (0, 128 - 16)))
    t_ids, _ = ts.sharded_build_step(tidx.vectors, tidx.norms, torch.from_numpy(wp), C=32, cap=8, ortho_factor=0.5,
                                     ortho_bias=0.0, prune_overflow=0, n_shard=tidx.n_shard, mesh=MESH)
    j_ids, _ = js.sharded_build_step(jidx.vectors, jidx.norms, jnp.asarray(wp), C=32, cap=8, ortho_factor=0.5,
                                     ortho_bias=0.0, prune_overflow=0, n_shard=jidx.n_shard, mesh=js.make_mesh(8),
                                     precision="highest")
    assert (t_ids[:, 0].numpy() == nn).all() and (np.asarray(j_ids)[:, 0] == nn).all()


@pytest.mark.parametrize("ortho_bias", [0.0, -1.0])
def test_sharded_build_step_ids_equal_jax(ortho_bias):
    """The same stacked corpus (the JAX index's) and the same wave into
    both build steps: the selected ids are identical, the distances within
    1e-4 relative (exact where the ids are; the sums differ in order)."""
    _, _, jidx, _ = _built(800, 1, 16, 4, 40)
    wave = np.pad(_data(16, 1, 16, seed=5)[0], ((0, 0), (0, 112)))
    args = dict(C=32, cap=8, ortho_factor=0.5, ortho_bias=ortho_bias, prune_overflow=0, n_shard=jidx.n_shard)
    j_ids, j_d = js.sharded_build_step(jidx.vectors, jidx.norms, jnp.asarray(wave), mesh=js.make_mesh(8),
                                       precision="highest", **args)
    vec, nrm = torch.from_numpy(np.array(jidx.vectors)), torch.from_numpy(np.array(jidx.norms))
    t_ids, t_d = ts.sharded_build_step(list(vec), list(nrm), torch.from_numpy(wave), mesh=MESH, **args)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    fin = np.isfinite(np.asarray(j_d))
    assert (np.isfinite(t_d.numpy()) == fin).all()
    np.testing.assert_allclose(t_d.numpy()[fin], np.asarray(j_d)[fin], rtol=1e-4, atol=1e-4)


def test_replicated_dp_query():
    """The row-gather route, data-parallel: recall@5 >= 0.9 in both
    packages; the port's ids equal one ``query_batch`` call on the whole
    batch (each query's beam is its own)."""
    x, q = _data(1200, 40, 16, seed=6)
    gt = _gt(x, q, 5)
    jeng = JEngine(config=JEngineConfig(M=8, ef_construction=60))
    jeng.store_many_vectors(x)
    jeng.build()
    assert _recall(js.replicated_query_dp(jeng.graph, q, k=5, ef=30, mesh=js.make_mesh(8)), gt) >= 0.9
    teng = AntitopoEngine(config=AntitopoConfig(M=8, ef_construction=60), device="cpu")
    teng.store_many_vectors(x)
    teng.build()
    ans = ts.replicated_query_dp(teng.graph, q, k=5, ef=30, mesh=MESH)
    assert _recall(ans, gt) >= 0.9
    whole = query_batch(teng.graph, torch.from_numpy(np.pad(q, ((0, 0), (0, 112)))), 5, 30)[0].numpy()
    np.testing.assert_array_equal(ans, whole)


def test_sharded_index_has_stacked_upper_layers():
    """Upper levels stacked per level across shards, in the JAX layout;
    the slots depend only on the seeded level draws, so they equal the
    JAX index's exactly."""
    _, _, jidx, tidx = _built(2400, 10, 16, 3, 40)
    S = tidx.num_shards
    assert len(tidx.layer_slots) >= 1 and len(tidx.layer_slots) == len(jidx.layer_slots)
    for sl, al, jsl, jal in zip(tidx.layer_slots, tidx.layer_adjs, jidx.layer_slots, jidx.layer_adjs):
        assert sl.shape == (S, tidx.n_shard + 1) and al.shape[0] == S
        assert int(sl.max()) <= al.shape[1] - 1 and int(al.max()) <= tidx.n_shard
        np.testing.assert_array_equal(sl.numpy(), np.asarray(jsl))
        assert tuple(al.shape) == tuple(jal.shape)
    np.testing.assert_array_equal(tidx.start.numpy(), np.asarray(jidx.start))


def test_sharded_packed_query_matches_row_gather_path():
    """The per-shard fused traversal against the row-gather path on the
    same index, in both packages (the JAX kernel in interpret mode):
    recall within 0.05 of it and >= 0.9, global ids unique per query."""
    x, q, jidx, tidx = _built(2400, 40, 32, 11, 60)
    gt = _gt(x, q, 10)
    for pkg, idx in ((ts, tidx), (js, jidx)):
        base = _recall(pkg.sharded_query_batch(idx, q, k=10, ef=40), gt)
        ans = pkg.sharded_packed_query(pkg.pack_sharded(idx), q, k=10, ef=40, expand=1, cand=8)
        rec = _recall(ans, gt)
        assert rec >= base - 0.05 and rec >= 0.9, (pkg.__name__, rec, base)
        assert _rows_unique(ans)


def test_jax_built_index_served_by_port():
    """A JAX-built ShardedIndex carried across (``sharded_from_numpy``) and
    served by both packages: the row-gather path and the per-shard fused
    traversal (bf16 blocks packed by each package) agree at the tolerance
    of the port's single-graph parity tests for the same searches: >= 7/8
    of rows identical, top-10 overlap >= 0.99, recall within 0.005.  The
    arrays come back out unchanged."""
    x, q, jidx, _ = _built(2400, 40, 32, 11, 60)
    gt = _gt(x, q, 10)
    arrays = _jax_arrays(jidx)
    tidx = ts.sharded_from_numpy(arrays, MESH)
    back = ts.sharded_to_numpy(tidx)
    for key in ("vectors", "norms", "adj", "start"):
        np.testing.assert_array_equal(back[key], arrays[key])
    for a, b in zip(back["layer_slots"] + back["layer_adjs"], arrays["layer_slots"] + arrays["layer_adjs"]):
        np.testing.assert_array_equal(a, b)
    pairs = (
        (ts.sharded_query_batch(tidx, q, k=10, ef=40), js.sharded_query_batch(jidx, q, k=10, ef=40)),
        (ts.sharded_packed_query(ts.pack_sharded(tidx), q, k=10, ef=40, expand=1, cand=8),
         js.sharded_packed_query(js.pack_sharded(jidx), q, k=10, ef=40, expand=1, cand=8)),
    )
    for t_ids, j_ids in pairs:
        same, overlap, r_diff = _agreement(t_ids, j_ids, gt)
        assert same >= 7 / 8 and overlap >= 0.99 and abs(r_diff) <= 0.005, (same, overlap, r_diff)


def test_sharded_flat_query_exact():
    """Recall@5 >= 0.95 in both packages, no padding id; the port's ids
    equal its plain flat top-k over the whole bf16 corpus (the merge keeps
    (d, id) order across shards)."""
    x, q = _data(2100, 24, 16, seed=7)
    gt = _gt(x, q, 5)
    j_ans = js.sharded_flat_query(js.build_sharded_flat(x, js.make_mesh(8), block=128), q, k=5)
    flat = ts.build_sharded_flat(x, MESH)
    assert flat.n_shard == 263 and flat.x[-1].shape[0] == 2100 - 7 * 263
    ans = ts.sharded_flat_query(flat, q, k=5)
    assert _recall(ans, gt) >= 0.95 and _recall(j_ans, gt) >= 0.95
    assert (ans >= 0).all() and (ans < 2100).all() and (j_ans[j_ans >= 0] < 2100).all()
    xb = torch.from_numpy(np.pad(x, ((0, 0), (0, 112)))).to(torch.bfloat16)
    whole = flat_topk_plain(torch.from_numpy(np.pad(q, ((0, 0), (0, 112)))), xb, 5)[0].numpy()
    np.testing.assert_array_equal(ans, whole)


def test_sharded_flat_query_k_above_a_shard():
    """k above the last shard's real rows: its empty slots are (-1, +inf)
    and merge last, so the ids still equal the whole-corpus scan's."""
    x, q = _data(100, 6, 16, seed=8)
    flat = ts.build_sharded_flat(x, MESH)
    assert flat.x[-1].shape[0] == 100 - 7 * 13
    ans = ts.sharded_flat_query(flat, q, k=20)
    xb = torch.from_numpy(np.pad(x, ((0, 0), (0, 112)))).to(torch.bfloat16)
    whole = flat_topk_plain(torch.from_numpy(np.pad(q, ((0, 0), (0, 112)))), xb, 20)[0].numpy()
    np.testing.assert_array_equal(ans, whole)


def test_replicated_fused_query_dp():
    """The fused traversal, data-parallel: recall@10 >= 0.9 in both
    packages (the JAX kernel in interpret mode); the port's ids equal one
    ``fused_query_batch`` call on the whole batch (K1 ends each query on
    its own)."""
    x, q = _data(1500, 48, 32, seed=9)
    gt = _gt(x, q, 10)
    jg = j_build_index(x, JConfig(M=8, ef_construction=60, prune_cand=60))
    packed, aux = j_build_packed(jg.vectors, jg.norms, jg.adj_bottom)
    jg = dataclasses.replace(jg, packed=packed, packed_aux=aux)
    j_ans = js.replicated_fused_query_dp(jg, q, k=10, ef=40, mesh=js.make_mesh(8), qt=8, expand=2, cand=16)
    assert j_ans.shape == (48, 10) and _recall(j_ans, gt) >= 0.9
    g = build_index(x, BuildConfig(M=8, ef_construction=60, prune_cand=60), "cpu")
    g.layout = Blocks.build(g)
    ans = ts.replicated_fused_query_dp(g, q, k=10, ef=40, mesh=MESH, qt=8, expand=2, cand=16)
    assert ans.shape == (48, 10) and _recall(ans, gt) >= 0.9
    whole = fused_query_batch(g, torch.from_numpy(np.pad(q, ((0, 0), (0, 96)))), 40, 10, expand=2, cand=16)[0]
    np.testing.assert_array_equal(ans, whole.numpy())


def test_sharded_rows_index_like_one_tensor():
    """``ShardedRows`` over 3 parts (the last padded) against the one
    tensor it stands for: gathers of 1-D and 2-D ids (the global sentinel
    reads the last part's sentinel row), the ``[:S * n_shard]`` slice, row
    and (row, column) assignment and ``index_add_``, sentinel writes
    dropped."""
    rng = np.random.default_rng(0)
    S, ns, n = 3, 7, 19
    G = S * ns
    full = torch.from_numpy(rng.standard_normal((G + 1, 4)).astype(np.float32))
    full[n:G] = 0.0
    full[G] = -1.0
    parts = [torch.cat([full[s * ns : (s + 1) * ns], full[G:]]) for s in range(S)]
    rows = ts.ShardedRows(parts, ns)
    assert rows.shape == (G + 1, 4)
    ids = torch.from_numpy(rng.integers(0, G + 1, (5, 6)))
    assert torch.equal(rows[ids], full[ids]) and torch.equal(rows[ids[0]], full[ids[0]])
    assert torch.equal(rows[:G], full[:G])
    gids = torch.tensor([0, 6, 7, 13, 20, G])
    vals = torch.arange(24, dtype=torch.float32).view(6, 4)
    rows[gids] = vals
    full[gids[:-1]] = vals[:-1]
    assert torch.equal(rows[torch.arange(G)], full[:G]) and torch.equal(rows[torch.tensor([G])], full[G:])
    cols = torch.tensor([0, 3, 1, 2, 0, 1])
    rows[gids, cols] = -vals[:, 0]
    full[gids[:-1], cols[:-1]] = -vals[:-1, 0]
    counts = ts.ShardedRows([torch.zeros(ns + 1, dtype=torch.int32) for _ in range(S)], ns)
    counts.index_add_(0, torch.tensor([1, 1, 8, 20, G]), torch.ones(5, dtype=torch.int32))
    assert torch.equal(rows[torch.arange(G)], full[:G])
    assert counts[:G].tolist() == [1 if i == 8 or i == 20 else (2 if i == 1 else 0) for i in range(G)]


def test_dryrun_multichip_on_8_cpu_devices():
    """``tools/dryrun_multichip`` (the counterpart of
    ``__graft_entry__.dryrun_multichip``) on 8 CPU devices: n = 512 rows,
    every multi-device path driven once and checked."""
    out = dryrun_multichip(MESH)
    assert out["shards"] == 8 and out["n"] == 512 and out["n_shard"] == 64
    assert out["dist_n_shards"] == 8 and out["build_step"] == (16, 8)
