"""Dataset loaders: synthetic Gaussian, the clustered million-row corpus
and SIFT1M fvecs/ivecs (copy of expann_tpu/data/loader.py; ground truth
from this package's exact engine).

Counterpart of the reference dataset_loader (src/dataset_loader.h):
synthetic N(0,1) vectors with brute-force ground truth cached to JSON
keyed by (n, dim, m, k) (:10-95), and the fvecs/ivecs readers for SIFT1M
(:96-182).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from expann_tpu_torch.data.dataset import TestDataset


def read_vecs(filename: str, dtype=np.float32) -> np.ndarray:
    """Read an fvecs/ivecs file: each record is (int32 d, d * 4-byte items)
    (reference: src/dataset_loader.h:96-125)."""
    raw = np.fromfile(filename, dtype=np.int32)
    if raw.size == 0:
        raise IOError(f"empty vecs file: {filename}")
    d = int(raw[0])
    rec = d + 1
    if raw.size % rec != 0:
        raise IOError(f"corrupt vecs file: {filename}")
    mat = raw.reshape(-1, rec)[:, 1:]
    if dtype == np.float32:
        mat = mat.view(np.float32)
    return np.ascontiguousarray(mat.astype(dtype))


def generate_synthetic(
    n: int, m: int, d: int, seed: Optional[int] = None
) -> tuple[np.ndarray, np.ndarray]:
    """Per-coordinate N(0,1) vectors, rejecting near-zero norms
    (reference: src/randomgeometry.h:73-96 vec_generator), seed 42 by
    default — the same draws as the JAX package's generator."""
    rng = np.random.default_rng(42 if seed is None else seed)
    eps = 1e-7
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((m, d)).astype(np.float32)
    for arr in (vecs, queries):
        while True:
            bad = np.einsum("ij,ij->i", arr, arr) < eps
            if not bad.any():
                break
            arr[bad] = rng.standard_normal((int(bad.sum()), d)).astype(np.float32)
    return vecs, queries


def generate_synthetic_clustered(
    n: int,
    m: int,
    d: int,
    n_clusters: int = 1000,
    sigma: float = 0.3,
    seed: Optional[int] = None,
    uniform: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Mixture-of-Gaussians synthetic data modeling the LOW intrinsic
    dimension of real ANN corpora (SIFT1M: ~15).  No reference counterpart
    (its synthetic generator is isotropic Gaussian,
    src/randomgeometry.h:73-96); isotropic Gaussian d=128 at N=1e6 is a
    curse-of-dimensionality regime where every graph method degrades
    (BENCH_NOTES million-row section).

    Deliberately NOT flattering to graph search (round-2 VERDICT asked
    for a harder stand-in than equal isotropic clusters):

      * cluster masses are Zipf-ish (``(rank + 3)^-0.6``) — some clusters
        hold ~30x the mass of others, like real corpora,
      * per-cluster ANISOTROPY: each cluster's spread is scaled per-axis
        by lognormal factors (sigma_eff in ~[sigma/3, 3*sigma]), so local
        neighbourhood geometry varies across the corpus,
      * per-cluster overall scale also varies (lognormal), producing both
        tight and diffuse regions,
      * queries are drawn from the SAME mixture but with 1.5x the
        within-cluster spread, so queries are NOT near-corpus-points
        (SIFT queries are held-out images, not corpus perturbations), and
        a 10% slice is drawn from between-cluster interpolations (off-mode
        queries with no dominant basin).

    ``uniform=True`` restores the round-2 equal-mass isotropic generator
    (for reproducing earlier numbers)."""
    rng = np.random.default_rng(42 if seed is None else seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    if uniform:

        def draw(count, spread=1.0):
            which = rng.integers(0, n_clusters, size=count)
            return (
                centers[which]
                + sigma * rng.standard_normal((count, d)).astype(np.float32)
            ).astype(np.float32)

        return draw(n), draw(m)

    # Zipf-ish masses, anisotropic per-axis scales, per-cluster size factor
    mass = (np.arange(n_clusters) + 3.0) ** -0.6
    mass = mass / mass.sum()
    axis_scale = np.exp(
        rng.normal(0.0, 0.45, size=(n_clusters, d))
    ).astype(np.float32)
    clus_scale = np.exp(rng.normal(0.0, 0.35, size=(n_clusters, 1))).astype(
        np.float32
    )

    def draw(count, spread=1.0):
        which = rng.choice(n_clusters, size=count, p=mass)
        noise = rng.standard_normal((count, d)).astype(np.float32)
        return (
            centers[which]
            + sigma
            * spread
            * clus_scale[which]
            * axis_scale[which]
            * noise
        ).astype(np.float32)

    vecs = draw(n)
    m_mix = m // 10
    q_main = draw(m - m_mix, spread=1.5)
    # between-cluster interpolations: no dominant basin
    a = rng.integers(0, n_clusters, size=m_mix)
    b = rng.integers(0, n_clusters, size=m_mix)
    t = rng.uniform(0.25, 0.75, size=(m_mix, 1)).astype(np.float32)
    q_between = (
        centers[a] * t
        + centers[b] * (1.0 - t)
        + sigma * rng.standard_normal((m_mix, d)).astype(np.float32)
    ).astype(np.float32)
    queries = np.concatenate([q_main, q_between], axis=0)
    return vecs, queries


def load_synthetic_uniform_sphere_points(
    n: int,
    m: int,
    k: int,
    d: int,
    cache_dir: str = "./data",
    seed: Optional[int] = None,
    *,
    device="cuda",
) -> TestDataset:
    """Synthetic Gaussian dataset with exact ground truth, JSON-cached by
    parameters (reference: src/dataset_loader.h:77-95; same cache filename
    scheme).  Ground truth is computed on ``device`` (the card by default)
    by the exact engine."""
    name = f"synthetic_uniform_sphere_n{n}_dim{d}_m{m}_k{k}"
    filename = os.path.join(cache_dir, name + ".dataset")
    if os.path.exists(filename):
        return TestDataset.load_json(filename)

    vecs, queries = generate_synthetic(n, m, d, seed)

    from expann_tpu_torch.models.brute_force import BruteForceEngine

    eng = BruteForceEngine(mode="exact", device=device)
    eng.store_many_vectors(vecs)
    eng.build()
    gt = eng.query_k_batch(queries, k).astype(np.int64)

    ds = TestDataset(name=name, vecs=vecs, queries=queries, ground_truth=gt)
    try:
        ds.save_json(filename)
    except OSError:
        pass
    return ds


def load_sift1m(
    filename_base: str,
    filename_query: str,
    filename_groundtruth: str,
    k_custom: int = 100,
) -> TestDataset:
    """SIFT1M from fvecs/ivecs files; ground truth truncated to k_custom
    (reference: src/dataset_loader.h:127-168)."""
    base = read_vecs(filename_base, np.float32)
    query = read_vecs(filename_query, np.float32)
    gt = read_vecs(filename_groundtruth, np.int64)
    k = min(k_custom, gt.shape[1])
    gt = gt[:, :k]
    name = f"sift1m_full_k{k}"
    return TestDataset(name=name, vecs=base, queries=query, ground_truth=gt)


def load_sift1m_custom(
    filename_base: str,
    filename_query: str,
    filename_groundtruth: str,
    k_custom: int = 100,
    m_custom: int = 2,
) -> TestDataset:
    """SIFT1M with a truncated query set for quick runs
    (reference: src/dataset_loader.h:169-182)."""
    ds = load_sift1m(filename_base, filename_query, filename_groundtruth, k_custom)
    m = min(m_custom, ds.m)
    return TestDataset(
        name=ds.name + f"_m{m}",
        vecs=ds.vecs,
        queries=ds.queries[:m],
        ground_truth=ds.ground_truth[:m],
    )
