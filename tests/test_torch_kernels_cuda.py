"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; every test skips where no CUDA device is present.  This
file imports neither JAX nor expann_tpu, so it runs on a machine without
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from expann_tpu_torch.ops import _kernels
from expann_tpu_torch.ops.fused import fused_search, fused_search_plain, topt_for
from expann_tpu_torch.ops.packed import build_packed
from expann_tpu_torch.ops.topk import flat_topk, flat_topk_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_kernels_build(dev):
    lib = _kernels.library()
    report = _kernels.build_report()
    assert "flat_topk_kernel" in report and "fused_search_kernel" in report
    assert lib.expann_flat_topk_smem_bytes(128, 10) > 0


@pytest.mark.parametrize("n,B,k", [(5000, 300, 10), (777, 70, 128), (64, 5, 100)])
def test_flat_topk_matches_plain(dev, n, B, k):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((n, 128)).astype(np.float32)).to(dev, torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((B, 128)).astype(np.float32)).to(dev)
    ids, d = flat_topk(q, x, k)
    pids, pd = flat_topk_plain(q, x, k)
    torch.cuda.synchronize()
    # f32 sums in another order: distances agree to a few ulps of |x|^2 ~ 256
    kk = min(k, n)
    torch.testing.assert_close(d[:, :kk], pd[:, :kk], rtol=1e-5, atol=1e-3)
    # ids agree except where two candidates tie within that tolerance
    diff = ids[:, :kk] != pids[:, :kk]
    assert float(diff.float().mean()) < 0.01
    if k > n:
        assert bool((ids[:, n:] == -1).all()) and bool(torch.isinf(d[:, n:]).all())


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
