"""Serving-R truncation (the counterpart of tests/test_truncate.py): a
JAX-built index cut by the port's ``tools/truncate_index`` to a smaller
bottom-layer degree equals the JAX tool's file, and the port serves it with
the JAX engine's answers on the same truncated file, within the gates of
the port's other serve-parity tests."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from expann_tpu.models.antitopo import AntitopoConfig as JConfig
from expann_tpu.models.antitopo import AntitopoEngine as JEngine
from expann_tpu.utils.persist import save_index as j_save_index
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.tools.truncate_index import main as truncate_main
from expann_tpu_torch.tools.truncate_index import truncate_index

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, K = 500, 32, 5


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """The JAX test's index (n=500, d=32, M=16, ef_construction=64), its
    truncation to R0=16 by the port's tool, and the exact top-5."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, D)).astype(np.float32)
    eng = JEngine(config=JConfig(M=16, ef_construction=64, ef_search_mult=6))
    eng.store_many_vectors(x)
    eng.build()
    root = tmp_path_factory.mktemp("trunc")
    full, trunc = str(root / "full.npz"), str(root / "trunc.npz")
    j_save_index(full, eng.graph, {"dim": D})
    old, new = truncate_main(["--in", full, "--r0", "16", "--out", trunc])
    assert old[1] >= 32 and new == (old[0], 16)
    d2 = np.sum(x**2, 1)[None, :] + np.sum(x**2, 1)[:, None] - 2 * (x @ x.T)
    return x, full, trunc, np.argsort(d2, axis=1, kind="stable")[:, :K]


def test_truncated_file_equals_the_jax_tools(indexes, tmp_path):
    _, full, trunc, _ = indexes
    jax_out = str(tmp_path / "jax_trunc.npz")
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "truncate_index.py"), "--in", full, "--r0", "16",
                    "--out", jax_out], check=True, timeout=120)
    with np.load(trunc) as ours, np.load(jax_out) as theirs:
        assert sorted(ours.files) == sorted(theirs.files)
        for key in theirs.files:
            np.testing.assert_array_equal(ours[key], theirs[key])
    with np.load(full) as z:
        with np.load(trunc) as t:
            np.testing.assert_array_equal(t["adj_bottom"], z["adj_bottom"][:, :16])


def test_truncate_rejects_a_wider_r0(indexes, tmp_path):
    _, full, _, _ = indexes
    with np.load(full) as z:
        r = z["adj_bottom"].shape[1]
    for r0 in (0, r, r + 16):
        with pytest.raises(ValueError):
            truncate_index(full, str(tmp_path / "bad.npz"), r0)


def _recall(ids, gt):
    return float(np.mean([len(set(map(int, a)) & set(map(int, b))) / K for a, b in zip(ids, gt)]))


@pytest.mark.parametrize("route", ["gather", "fused"])
def test_truncated_index_serves_like_jax(indexes, route):
    """Both engines serve the truncated file (the JAX test's config,
    ef_search_mult=8) on their CPU route (the gather beam), and the port
    also on its fused route over RS=16 packed blocks.  Each port route
    against the JAX gather beam: mean overlap >= 0.99, recall within 0.005;
    and the JAX test's own gates against the full graph (>= 0.7, at most
    0.15 below)."""
    x, full, trunc, gt = indexes

    def jax_ids(path):
        e = JEngine(config=JConfig(M=16, ef_construction=64, ef_search_mult=8, index_filename=path,
                                   read_index=True))
        e.store_many_vectors(x)
        e.build()
        return e.query_k_batch(x, K)

    knobs = {"use_packed": True, "use_fused": True} if route == "fused" else {}
    eng = AntitopoEngine(config=AntitopoConfig(M=16, ef_construction=64, ef_search_mult=8, index_filename=trunc,
                                               read_index=True, **knobs), device="cpu")
    eng.build()
    assert eng.graph.adj_bottom.shape[1] == 16
    t_ids = eng.query_k_batch(x, K)
    j_ids, j_full = jax_ids(trunc), jax_ids(full)
    overlap = np.mean([len(set(map(int, a)) & set(map(int, b))) / K for a, b in zip(t_ids, j_ids)])
    assert overlap >= 0.99, overlap
    assert abs(_recall(t_ids, gt) - _recall(j_ids, gt)) <= 0.005
    r_full = _recall(j_full, gt)
    assert r_full >= 0.9
    assert _recall(t_ids, gt) >= r_full - 0.15
    assert _recall(t_ids, gt) >= 0.7
    for row in t_ids:
        assert len(set(row.tolist())) == K
