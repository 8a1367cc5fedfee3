"""The port's flat engines against the JAX package and the exact oracle."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from expann_tpu.models.brute_force import BruteForceEngine as JBruteForceEngine
from expann_tpu.ops.pallas_topk import flat_topk as j_flat_topk
from expann_tpu.ops.pallas_topk import flat_topk_prepare as j_flat_topk_prepare
from expann_tpu_torch.data.dataset import TestDataset
from expann_tpu_torch.data.loader import generate_synthetic, load_synthetic_uniform_sphere_points
from expann_tpu_torch.models.brute_force import BruteForceEngine, exact_topk
from expann_tpu_torch.ops.distance import squared_norms
from expann_tpu_torch.ops.topk import flat_topk, flat_topk_plain

torch.set_num_threads(2)

CACHED = os.path.join(
    os.path.dirname(__file__), "..", "data", "synthetic_uniform_sphere_n8000_dim128_m200_k10.dataset"
)


def _recall(ids, gt):
    k = gt.shape[1]
    return np.mean([len(set(a[:k].tolist()) & set(b.tolist())) / k for a, b in zip(ids, gt)])


def test_exact_engine_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1000, 32)).astype(np.float32)
    q = rng.standard_normal((64, 32)).astype(np.float32)
    eng = BruteForceEngine(mode="exact", batch_size=40, device="cpu")
    eng.store_many_vectors(x)
    eng.build()
    jeng = JBruteForceEngine(mode="exact")
    jeng.store_many_vectors(x)
    jeng.build()
    np.testing.assert_array_equal(eng.query_k_batch(q, 10), jeng.query_k_batch(q, 10))


def test_ground_truth_matches_cached_dataset():
    """The port's oracle reproduces the cached ids of the reference-era
    n=8000 dataset, and the port's generator its vectors."""
    ds = TestDataset.load_json(CACHED)
    eng = BruteForceEngine(mode="exact", device="cpu")
    eng.store_many_vectors(ds.vecs)
    eng.build()
    np.testing.assert_array_equal(eng.query_k_batch(ds.queries, ds.k), ds.ground_truth)
    vecs, queries = generate_synthetic(ds.n, ds.m, ds.dim)
    np.testing.assert_array_equal(vecs, ds.vecs)
    np.testing.assert_array_equal(queries, ds.queries)


def test_loader_caches_port_ground_truth(tmp_path):
    ds = load_synthetic_uniform_sphere_points(300, 20, 5, 16, cache_dir=str(tmp_path), device="cpu")
    again = load_synthetic_uniform_sphere_points(300, 20, 5, 16, cache_dir=str(tmp_path), device="cpu")
    np.testing.assert_array_equal(ds.ground_truth, again.ground_truth)
    d2 = ((ds.queries[:, None] - ds.vecs[None]) ** 2).sum(-1)
    assert _recall(ds.ground_truth, np.argsort(d2, axis=1, kind="stable")[:, :5]) == 1.0


def test_flat_topk_plain_is_the_exact_oracle_with_ties():
    """On an f32 corpus the plain flat top-k IS the exact oracle, including
    ties: duplicated corpus rows tie exactly and must come back by id."""
    rng = np.random.default_rng(1)
    base = rng.standard_normal((100, 128)).astype(np.float32)
    x = np.concatenate([base, base[:30], base[10:20]])  # ids 100.. duplicate 0..29, 130.. 10..19
    q = np.concatenate([base[:12] + 1e-3, rng.standard_normal((20, 128)).astype(np.float32)])
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    ids, d = flat_topk(qt, xt, 20)
    want, want_d = exact_topk(qt, xt, squared_norms(xt), 20)
    np.testing.assert_array_equal(ids.numpy(), want.numpy())
    np.testing.assert_array_equal(d.numpy(), want_d.numpy())
    # each duplicated pair is adjacent and ordered by id
    for row_i, row_d in zip(ids.numpy(), d.numpy()):
        assert all(
            (a < b) if da == db else (da < db) for a, b, da, db in zip(row_i, row_i[1:], row_d, row_d[1:])
        )
    # k beyond the corpus pads with id -1 / +inf
    ids, d = flat_topk_plain(qt[:2], xt[:5], 8)
    assert (ids[:, 5:] == -1).all() and torch.isinf(d[:, 5:]).all()


def test_flat_topk_bf16_recall_matches_jax_kernel():
    """The JAX count-mode kernel pools each 1024-row corpus block to 128
    lanes and ranks packed keys; the port selects exactly.  Both score the
    same bf16-rounded corpus, so their recall against the exact f32 oracle
    differs only by the pooling loss, ~C(k, 2) / (blocks * 128) of the
    queries: with 8 blocks, at most 0.01."""
    rng = np.random.default_rng(2)
    n, B, k = 8100, 256, 10
    x = rng.standard_normal((n, 128)).astype(np.float32)
    q = rng.standard_normal((B, 128)).astype(np.float32)
    xt = torch.from_numpy(x)
    gt, _ = exact_topk(torch.from_numpy(q), xt, squared_norms(xt), k)
    ids, _ = flat_topk(torch.from_numpy(q), xt.to(torch.bfloat16), k)
    jx, jn = j_flat_topk_prepare(x)
    jids, _ = j_flat_topk(jnp.asarray(q), jx, n_real=jn, k=k, interpret=True, mode="count")
    r_port, r_jax = _recall(ids.numpy(), gt.numpy()), _recall(np.asarray(jids), gt.numpy())
    assert r_port >= 0.97, r_port
    assert abs(r_port - r_jax) <= 0.01, (r_port, r_jax)


def test_flat_topk_fixed_mode_recall_matches_jax_kernel():
    """The fixed k-pass mode (K3) against the JAX fixed kernel in interpret
    mode: the same function as the count mode, so the plain version serves
    both; the JAX kernel pools each 1024-row block to 128 lanes, so the gate
    is the count test's recall gate."""
    rng = np.random.default_rng(4)
    n, B, k = 8100, 256, 10
    x = rng.standard_normal((n, 128)).astype(np.float32)
    q = rng.standard_normal((B, 128)).astype(np.float32)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    gt, _ = exact_topk(qt, xt, squared_norms(xt), k)
    ids, d = flat_topk(qt, xt.to(torch.bfloat16), k, mode="fixed")
    c_ids, c_d = flat_topk(qt, xt.to(torch.bfloat16), k, mode="count")
    assert torch.equal(ids, c_ids) and torch.equal(d, c_d)
    jx, jn = j_flat_topk_prepare(x)
    jids, _ = j_flat_topk(jnp.asarray(q), jx, n_real=jn, k=k, interpret=True, mode="fixed")
    r_port, r_jax = _recall(ids.numpy(), gt.numpy()), _recall(np.asarray(jids), gt.numpy())
    assert r_port >= 0.97, r_port
    assert abs(r_port - r_jax) <= 0.01, (r_port, r_jax)
    with pytest.raises(ValueError):
        flat_topk(qt, xt, k, mode="pooled")


def test_fused_engine_topk_mode():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((700, 64)).astype(np.float32)
    q = rng.standard_normal((30, 64)).astype(np.float32)
    out = {}
    for mode in ("count", "fixed"):
        eng = BruteForceEngine(mode="fused", topk_mode=mode, device="cpu")
        assert eng.topk_mode == mode
        eng.store_many_vectors(x)
        eng.build()
        out[mode] = eng.query_k_batch(q, 10)
    np.testing.assert_array_equal(out["fixed"], out["count"])
    with pytest.raises(ValueError):
        BruteForceEngine(mode="fused", topk_mode="pooled", device="cpu")


def test_fused_engine_recall():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1500, 100)).astype(np.float32)
    q = rng.standard_normal((80, 100)).astype(np.float32)
    exact = BruteForceEngine(mode="exact", device="cpu")
    fused = BruteForceEngine(mode="fused", batch_size=32, device="cpu")
    for e in (exact, fused):
        e.store_many_vectors(x)
        e.build()
    ids = fused.query_k_batch(q, 10)
    assert ids.shape == (80, 10)
    assert _recall(ids, exact.query_k_batch(q, 10)) >= 0.97


def test_unported_mode_raises():
    """``fused_i8`` (unported before) now serves; unknown values of the
    engine's options still raise."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((300, 32)).astype(np.float32)
    q = rng.standard_normal((12, 32)).astype(np.float32)
    eng = BruteForceEngine(mode="fused_i8", device="cpu")
    eng.store_many_vectors(x)
    eng.build()
    assert eng._x_fused.dtype == torch.int8
    ids = eng.query_k_batch(q, 5)
    assert ids.shape == (12, 5) and all(len(set(r.tolist())) == 5 for r in ids)
    for kw in (dict(mode="fused_i4"), dict(rerank_store="f16"), dict(query_wire="i4"), dict(topk_mode="pooled")):
        with pytest.raises(ValueError):
            BruteForceEngine(device="cpu", **{"mode": "fused_i8", **kw})
