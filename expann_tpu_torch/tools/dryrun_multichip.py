"""Drive every multi-device path once at a tiny size (counterpart of
``__graft_entry__.dryrun_multichip``, at its sizes: n = 64 S rows, d=128,
M=4, efc = prune_cand = 16).

In order: ``build_sharded``; one ``sharded_build_step``;
``sharded_query_batch``; ``build_sharded_flat`` and ``sharded_flat_query``;
a global ``build_distributed`` (waves of 64, bootstrap 128) and a query over
it; ``build_index``, its packed layout and ``replicated_fused_query_dp``.
Each answer is checked for its shape and for ids below n.

    python -m expann_tpu_torch.tools.dryrun_multichip --shards 4
    python -m expann_tpu_torch.tools.dryrun_multichip --shards 8 --device cpu

``--shards S`` takes the visible CUDA devices round-robin (one card gives
S shards on it), or S copies of ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from expann_tpu_torch.models.build import BuildConfig, build_index
from expann_tpu_torch.models.layout import Blocks
from expann_tpu_torch.models.search import query_batch
from expann_tpu_torch.parallel.distbuild import build_distributed
from expann_tpu_torch.parallel.sharded import (
    Mesh,
    build_sharded,
    build_sharded_flat,
    make_mesh,
    replicated_fused_query_dp,
    sharded_build_step,
    sharded_flat_query,
    sharded_query_batch,
)


def tiny_corpus(n: int = 768, d: int = 128, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def round_robin(shards: int, device: str = "cuda") -> Mesh:
    """``shards`` devices: the visible CUDA devices in turn, or ``device``
    repeated."""
    if device == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise SystemExit("dryrun_multichip: no CUDA device visible (pass --device cpu)")
        return make_mesh(devices=[f"cuda:{s % count}" for s in range(shards)])
    return make_mesh(devices=[device] * shards)


def _ids_ok(ids: np.ndarray, shape: tuple, n: int, what: str) -> None:
    if ids.shape != shape or not (ids[ids >= 0] < n).all():
        raise AssertionError(f"{what}: shape {ids.shape} (expected {shape}) or an id >= {n}")


def dryrun_multichip(mesh: Mesh) -> dict:
    """The sequence of ``__graft_entry__.dryrun_multichip`` on ``mesh``.
    Returns the shapes it checked."""
    S = len(mesh)
    n, d = 64 * S, 128
    cfg = BuildConfig(M=4, ef_construction=16, prune_cand=16)
    x = tiny_corpus(n=n, d=d)
    index = build_sharded(x, cfg, mesh)

    # one sharded construction step: corpus-sharded candidates, the prune
    wave = torch.from_numpy(tiny_corpus(n=16, d=d, seed=2))
    sel_ids, sel_d = sharded_build_step(index.vectors, index.norms, wave, C=16, cap=8, ortho_factor=0.5,
                                        ortho_bias=0.0, prune_overflow=0, n_shard=index.n_shard, mesh=mesh)
    if tuple(sel_ids.shape) != (16, 8) or not bool((sel_ids <= S * index.n_shard).all()):
        raise AssertionError(f"sharded_build_step: {tuple(sel_ids.shape)}")

    q = tiny_corpus(n=32, d=d, seed=3)
    _ids_ok(sharded_query_batch(index, q, k=5, ef=16), (32, 5), n, "sharded_query_batch")
    _ids_ok(sharded_flat_query(build_sharded_flat(x, mesh), q, k=5), (32, 5), n, "sharded_flat_query")

    # one global graph over the mesh, and a query over it
    dgraph, stats = build_distributed(x, cfg, mesh, wave_size=64, bootstrap=128)
    bids = query_batch(dgraph, torch.from_numpy(q).to(mesh[0]), k=5, ef=16)[0].cpu().numpy()
    _ids_ok(bids, (32, 5), n, "build_distributed + query_batch")

    # data-parallel serving over the fused traversal
    graph = build_index(x, cfg, mesh[0])
    graph.layout = Blocks.build(graph)
    _ids_ok(replicated_fused_query_dp(graph, q, k=5, ef=16, mesh=mesh, qt=8), (32, 5), n,
            "replicated_fused_query_dp")
    return {"shards": S, "n": n, "n_shard": index.n_shard, "layers": len(index.shards[0].layers),
            "dist_n_shards": stats["n_shards"], "build_step": tuple(sel_ids.shape)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=0, help="shards (default: one a visible card)")
    ap.add_argument("--device", default="cuda", help="'cuda' (round-robin over the cards) or a device to repeat")
    args = ap.parse_args(argv)
    shards = args.shards or (torch.cuda.device_count() if args.device == "cuda" else 1)
    mesh = round_robin(shards, args.device)
    out = dryrun_multichip(mesh)
    print("dryrun_multichip " + " ".join(f"{k}={v}" for k, v in out.items())
          + " devices=" + ",".join(str(d) for d in mesh), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
