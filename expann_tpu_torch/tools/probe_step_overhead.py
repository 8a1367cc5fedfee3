"""P3: the fixed cost of one step of a traversal-shaped kernel (counterpart
of tools/probe_step_overhead.py, kernel built by ``make(feat)`` :30, body
:33, call :98, timing loop ``run`` :113), and its companion: the port's fused
traversal (K1) at 24 and 96 iterations, whose slope is K1's cost per
iteration.

Per T=8-row tile of a (B, 128) f32 beam, ITERS steps of
``d += rowmin(d) * 1e-6``; the features, named as in the TPU tool and
combined with commas (``"dma,while6"``), add to each step:

  * ``dma``: the copies of the T*E = 32 blocks
    ``packed[(i*131 + qi*E + e) % 4096]``, each waited for, then
    ``d += packed[(i*131) % 4096, 0, :] * 1e-9`` (row 0 of the first);
  * ``scratch``: the kernel allocates the shared memory the TPU kernel's
    scratch stood for (``dma`` allocates it too) and does not use it;
  * ``while1`` / ``while6``: the loop as a while loop with 1 / 5 more
    carried values (on this card a counted loop and a while loop compile
    alike; ``while6``'s carries are XORed each step and add
    ``(ids + ex + dn + nc) * 0.0`` at the end).

The result is ``d + q[tile*T, 0] * 0.0``.  The kernel
(``step_overhead_kernel`` in ``csrc/probes.cu``) runs one block per tile
and one warp per row, in thread-block clusters of ``cluster`` blocks (the
grid padded to a multiple; a padded block writes no row).  ``dma`` sends
the 32 copies of 32 KB through a ring of NSLOT slots; the copy indices do
not depend on the tile, so all tiles read the same <= 768 blocks (~24 MB),
which stay in L2, and a cluster's blocks share each read: every copy is
one multicast that lands in every block of the cluster (a plain copy in a
one-block cluster).  A call therefore
reads ``l2_bytes`` from L2, once a cluster, while the bound counts the
distinct blocks once.

    python -m expann_tpu_torch.tools.probe_step_overhead
    python -m expann_tpu_torch.tools.probe_step_overhead --ab

``--ab`` prints JSON lines: ``dma`` at B=8192 for each cluster size (ms a
call, ns a step by the slope between ITERS and 4 * ITERS, L2 bytes a call,
clusters resident at once), the fixed cost of a step alone on an SM (B=8,
one tile, cluster 1, with and without ``dma``), and K1's cost per iteration
at B=8.  An older checkout's kernel is timed by that checkout's own copy of
this file: ``PYTHONPATH=<checkout> python <checkout>/expann_tpu_torch/tools/
probe_step_overhead.py`` (every feature at B=8192).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Tuple

import torch

import expann_tpu_torch
from expann_tpu_torch.ops import _kernels
from expann_tpu_torch.ops.fused import fused_search
from expann_tpu_torch.utils.profiling import card_name, event_ms

T, EF, D, E, RS, R = 8, 128, 128, 4, 128, 128
B = 8192
ITERS = 24
NODES = 4096  # copy indices are taken mod NODES; layouts hold NODES + 1 blocks
FEATURES = ("", "scratch", "dma", "while1", "while6", "dma,while6")
FUSED_ITERS = (24, 96)
COPIES = T * E  # copies a step
NSLOT = 3  # the ring's slots (ST_NSLOT in csrc/probes.cu)
BAR_BYTES = 128  # the ring's barriers, ahead of its slots
CLUSTER_SWEEP = (1, 2, 4, 8, 16)  # 16: a non-portable cluster size
CLUSTER = 4  # the cluster size the tool and chip_smoke time


def parse_feature(feat: str) -> Tuple[bool, bool, int]:
    """(dma, scratch, carry): carry 0 for the counted loop, 1 for
    ``while1``, 6 for ``while6``."""
    parts = {p for p in feat.split(",") if p}
    unknown = parts - {"dma", "scratch", "while1", "while6"}
    if unknown:
        raise ValueError(f"unknown feature {sorted(unknown)} in {feat!r}")
    return "dma" in parts, "scratch" in parts, 6 if "while6" in parts else 1 if "while1" in parts else 0


def step_overhead_plain(q: torch.Tensor, bd0: torch.Tensor, packed: torch.Tensor, feat: str,
                        iters: int = ITERS) -> torch.Tensor:
    """Plain PyTorch version, all tiles at once: (B, EF) f32."""
    dma, _, carry = parse_feature(feat)
    d = bd0.float().clone()
    if carry == 6:
        ids = torch.zeros(d.shape, dtype=torch.int32, device=d.device)
        ex = torch.zeros_like(ids)
        dn = torch.zeros((d.shape[0], 1), dtype=torch.int32, device=d.device)
        nc = torch.zeros_like(dn)
    for i in range(iters):
        d = d + d.min(dim=1, keepdim=True).values * 1e-6
        if dma:
            d = d + packed[(i * 131) % NODES, 0, :].float() * 1e-9
        if carry == 6:
            ids, ex, dn, nc = ids ^ 1, ex ^ 1, dn ^ 1, nc + 1
    if carry == 6:
        d = d + (ids[:, :1] + ex[:, :1] + dn + nc).float() * 0.0
    return d + q[::T, :1].float().repeat_interleave(T, dim=0) * 0.0


def ring_bytes(rs: int) -> int:
    """The ``dma`` (and ``scratch``) footprint of one block: the barriers
    and NSLOT slots of an (rs, D) bf16 block."""
    return BAR_BYTES + NSLOT * rs * D * 2


def grid_blocks(b: int, cluster: int) -> int:
    """Blocks a launch of ``b`` rows runs: its b / T tiles padded to a
    multiple of the cluster size."""
    tiles = b // T
    return -(-tiles // cluster) * cluster


def cluster_sizes(tiles: int) -> Tuple[int, ...]:
    """The sweep's cluster sizes for a tile count: those no larger than it
    (a larger cluster only adds padded blocks)."""
    return tuple(c for c in CLUSTER_SWEEP if c <= max(1, tiles))


def l2_bytes(b: int, iters: int, cluster: int, rs: int = RS) -> int:
    """Bytes a ``dma`` call reads from L2: every cluster (padded ones
    included) copies each step's 32 blocks once."""
    return grid_blocks(b, cluster) // cluster * iters * COPIES * rs * D * 2


def active_clusters(rs: int, smem_on: bool, cluster: int, device="cuda") -> int:
    """Clusters of ``cluster`` blocks the card holds at once (CUDA's
    occupancy calculator), with or without the ring."""
    with torch.cuda.device(device):
        n = _kernels.library().expann_step_overhead_clusters(rs, int(smem_on), cluster)
    if n < 0:
        _kernels.check(-n, "step_overhead clusters")
    return n


def step_overhead_cuda(q: torch.Tensor, bd0: torch.Tensor, packed: torch.Tensor, feat: str,
                       iters: int = ITERS, cluster: int = CLUSTER) -> torch.Tensor:
    """Launch ``step_overhead_kernel`` (one block per T-row tile, clusters
    of ``cluster`` blocks)."""
    dma, scratch, carry = parse_feature(feat)
    device = bd0.device
    _kernels.require_cuda(q, "q", torch.float32, device)
    _kernels.require_cuda(bd0, "bd0", torch.float32, device)
    _kernels.require_cuda(packed, "packed", torch.bfloat16, device)
    Bq, ef = bd0.shape
    if ef != EF or q.shape != (Bq, D) or Bq % T or packed.dim() != 3 or packed.shape[2] != D:
        raise ValueError(f"q {tuple(q.shape)}, bd0 {tuple(bd0.shape)}, packed {tuple(packed.shape)}: "
                         f"expected (B, {D}), (B, {EF}) with B % {T} == 0, (n, RS, {D})")
    if dma and packed.shape[0] < NODES:
        raise ValueError(f"packed has {packed.shape[0]} blocks; the copies read {NODES}")
    if cluster not in CLUSTER_SWEEP:
        raise ValueError(f"cluster {cluster}: expected one of {CLUSTER_SWEEP}")
    lib = _kernels.library()
    rs = packed.shape[1]
    out = torch.empty_like(bd0)
    with torch.cuda.device(device):  # the limit and the shared-memory setting are the current device's
        if (dma or scratch) and lib.expann_step_overhead_smem_bytes(rs) > lib.expann_smem_optin():
            raise ValueError(f"the scratch for RS={rs} does not fit one block's shared memory")
        code = lib.expann_step_overhead(q.data_ptr(), bd0.data_ptr(), packed.data_ptr(), out.data_ptr(), Bq, rs,
                                        int(iters), NODES, int(dma), int(scratch), carry, cluster,
                                        _kernels.stream_ptr(device))
    _kernels.check(code, "step_overhead")
    _kernels.launches["step_overhead"] += 1
    return out


def step_overhead(q: torch.Tensor, bd0: torch.Tensor, packed: torch.Tensor, feat: str = "",
                  iters: int = ITERS, cluster: int = CLUSTER) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors (which
    has no clusters: ``cluster`` changes no result)."""
    if bd0.is_cuda:
        return step_overhead_cuda(q, bd0, packed, feat, iters, cluster)
    if bd0.device.type != "cpu":
        raise ValueError(f"step_overhead runs on CUDA or CPU tensors, not {bd0.device}")
    return step_overhead_plain(q, bd0, packed, feat, iters)


def inputs(device):
    """q (B, D), bd0 (B, EF) f32 and packed (NODES + 1, RS, D) bf16, N(0, 1)
    from a seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((B, D), generator=gen, device=device)
    bd0 = torch.randn((B, EF), generator=gen, device=device)
    packed = torch.randn((NODES + 1, RS, D), generator=gen, device=device).to(torch.bfloat16)
    return q, bd0, packed


def step_bytes(feat: str) -> int:
    """Bytes the function must move at the tool's shape: the beam in and
    out, each tile's q[tile*T, 0], and with ``dma`` every distinct block
    copied once."""
    dma, _, _ = parse_feature(feat)
    blocks = len({(i * 131 + c) % NODES for i in range(ITERS) for c in range(T * E)}) if dma else 0
    return 2 * B * EF * 4 + (B // T) * 4 + blocks * RS * D * 2


def run(feat: str, device="cuda", cluster: int = CLUSTER, b: int = B) -> dict:
    """Time one feature at ``b`` rows (the tool's shape by default) in
    clusters of ``cluster`` blocks: ms per call at ITERS (and µs per tile,
    the TPU tool's unit: its grid steps ran one after another), and ns per
    step from the slope between ITERS and 4 * ITERS steps (all tiles run at
    once here, so the slope is one step of the whole grid)."""
    q, bd0, packed = inputs(device)
    q, bd0 = q[:b], bd0[:b]
    ms = [event_ms(lambda: step_overhead_cuda(q, bd0, packed, feat, it, cluster), reps=5) for it in (ITERS, 4 * ITERS)]
    return dict(feat=feat, B=b, cluster=cluster, ms=ms[0], us_per_tile=ms[0] * 1e3 / (b // T),
                ns_per_step=(ms[1] - ms[0]) * 1e6 / (3 * ITERS),
                l2_bytes=l2_bytes(b, ITERS, cluster) if parse_feature(feat)[0] else 0)


def fused_inputs(device, b: int = B):
    """K1's arguments at the tool's shape: a random 4097-block bf16 layout
    (RS = R = 128; norms >= 0, ids random and valid), whose block NODES is
    the sentinel as in every packed layout (+inf norms, sentinel ids: a
    sentinel selection adds nothing), b queries, and seed beams of EF
    distinct valid ids at distances above any candidate (1e4 + |N(0, 1)|),
    so the beam fills with real candidates and the traversal runs as on a
    graph until its own stopping rule or the cap."""
    gen = torch.Generator(device=device).manual_seed(0)
    packed = torch.randn((NODES + 1, RS, D), generator=gen, device=device).to(torch.bfloat16)
    norms = torch.randn((NODES + 1, R), generator=gen, device=device).abs()
    ids = torch.randint(0, NODES, (NODES + 1, R), generator=gen, device=device, dtype=torch.int32)
    norms[NODES] = float("inf")
    ids[NODES] = NODES
    q = torch.randn((b, D), generator=gen, device=device)
    bd0 = 1e4 + torch.randn((b, EF), generator=gen, device=device).abs()
    bi0 = torch.rand((b, NODES), generator=gen, device=device).argsort(dim=1)[:, :EF].to(torch.int32)
    return packed, norms, ids, q, bd0, bi0


def run_fused(device="cuda", b: int = B) -> list:
    """K1 at the tool's shape (B=8192, or ``b`` queries; ef=120, expand=4,
    cand=32) under each iteration cap of FUSED_ITERS: ms per call and the
    iterations the queries ran."""
    args = fused_inputs(device, b)
    rows = []
    for cap in FUSED_ITERS:
        def call():
            return fused_search(*args, ef=120, expand=4, cand=32, max_iters=cap)

        ms = event_ms(call, reps=3 if b >= 1024 else 20)
        it = call()[3].float()
        rows.append(dict(B=b, max_iters=cap, ms=ms, iters_mean=float(it.mean()), iters_max=int(it.max())))
    return rows


def fused_agreement(got, ref, sentinel: int) -> dict:
    """How far two ``fused_search`` results agree, row by row: the share
    of rows with the same beam (ids as a set) and the mean overlap of the
    beams' real ids; the largest distance difference of one id within the
    same beams (and the largest distance there); the share of rows with
    the same iteration count; total iterations and distance counts as a
    ratio to ``ref``'s."""
    gi, gd, gn, gt = (t.cpu() for t in got)
    ri, rd, rn, rt = (t.cpu() for t in ref)
    gs, go = gi.sort(dim=1)
    rs, ro = ri.sort(dim=1)
    same = (gs == rs).all(dim=1)
    gd, rd = gd.gather(1, go), rd.gather(1, ro)
    fin = same[:, None] & torch.isfinite(rd)
    overlap = [len((set(a.tolist()) & set(b.tolist())) - {sentinel}) / max(1, len(set(b.tolist()) - {sentinel}))
               for a, b in zip(gi, ri)]
    return dict(same_beams=float(same.float().mean()), overlap=sum(overlap) / len(overlap),
                dist_err=float((gd - rd).abs()[fin].max()) if bool(fin.any()) else 0.0,
                dist_max=float(rd.abs()[fin].max()) if bool(fin.any()) else 0.0,
                same_iters=float((gt == rt).float().mean()), iters_ratio=float(gt.sum()) / float(rt.sum()),
                ncomp_ratio=float(gn.sum()) / float(rn.sum()))


def fused_slope(rows: list) -> float:
    """K1's ms per iteration from the first and last rows of ``run_fused``."""
    a, b = rows[0], rows[-1]
    di = b["iters_mean"] - a["iters_mean"]
    return (b["ms"] - a["ms"]) / di if di > 0 else float("nan")


def main(device="cuda") -> dict:
    print(f"card: {card_name()}", flush=True)
    feats = []
    for feat in FEATURES:
        r = run(feat, device)
        feats.append(r)
        print(f"{feat or 'base':>10s}: {r['ms']:8.4f} ms -> {r['us_per_tile']:7.4f} us/tile, "
              f"{r['ns_per_step']:8.2f} ns/step (slope {ITERS}->{4 * ITERS}), cluster {r['cluster']}, "
              f"L2 {r['l2_bytes'] / 1e9:.3f} GB", flush=True)
    fused = run_fused(device)
    for r in fused:
        print(f"fused iters<={r['max_iters']}: {r['ms']:8.3f} ms, iterations mean {r['iters_mean']:.1f} "
              f"max {r['iters_max']}", flush=True)
    print(f"fused: {fused_slope(fused):.4f} ms per iteration", flush=True)
    return dict(features=feats, fused=fused)


def ab(argv=None) -> list:
    """The A/B reading (JSON lines): ``dma`` at B=8192 for each cluster
    size, the fixed cost of a step at B=8 with and without ``dma``, and K1
    at B=8."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ab", action="store_true")
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_step_overhead --ab times the kernel on an NVIDIA GPU; none is present")
    dev = torch.device("cuda")
    base = dict(card=card_name(), package=expann_tpu_torch.__file__)
    q, bd0, packed = inputs(dev)
    out = []

    def emit(row):
        row.update(base)
        print(json.dumps(row), flush=True)
        out.append(row)

    for c in cluster_sizes(B // T):
        got = step_overhead_cuda(q, bd0, packed, "dma", ITERS, c)
        ref = step_overhead_plain(q, bd0, packed, "dma", ITERS)
        emit(dict(run("dma", dev, c, B), identical=bool(torch.equal(got, ref)),
                  clusters_at_once=active_clusters(RS, True, c, dev)))
    for feat in ("", "dma"):  # one tile alone on an SM
        emit(dict(run(feat, dev, 1, T), fixed_cost=True))
    fused = run_fused(dev, T)
    emit(dict(kernel="fused_search", B=T, rows=fused, ms_per_iteration=fused_slope(fused)))
    return out


if __name__ == "__main__":
    if "--ab" in sys.argv[1:]:
        ab(sys.argv[1:])
    else:
        main()
