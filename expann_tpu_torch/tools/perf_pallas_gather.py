"""P2: the achievable rate of random block gathers (counterpart of
tools/perf_pallas_gather.py, kernel ``_kernel`` :34, launcher
``run_block_gather`` :63, call :78).

The access pattern is the packed-neighbour layout's: one expansion of the
graph traversal reads one contiguous R x D bf16 block at a data-dependent
address (K1 reads R=128 bf16 blocks, 32 KB; K1-s8 16 KB, the size of R=64
here; K4 32 KB).  Step i of G copies ``packed[ids[i]]`` into shared memory
and scores it against one bf16 query in f32:
``scores[i] = q . packed[ids[i]]^T``; ``run_block_gather`` returns the last
step's row, the TPU function's (1, R) result.  The kernel
(``block_gather_kernel`` in ``csrc/probes.cu``) keeps an NBUF-slot ring of
bulk copies in flight per block, on a persistent grid.

``main()`` sweeps R in {16, 32, 64, 128} and NBUF in {2, 4, 8}.  As the TPU
tool does, it times two grid sizes with fresh ids per call, best of 4, and
takes GB/s from the slope, which cancels the per-call overhead.  The table
is 2 GiB at every R (NB = 524288 blocks at R=16 down to 65536 at R=128),
~43x the card's 50 MB L2: random ids then hit L2 ~2% of the time, so the
reading is HBM's.  (The TPU tool's NB=8192 would fit L2 whole at R=16; a
268 MB table, 5x L2, still read above 3.35 TB/s at R=16 on an H100 through
its ~19% L2 hits.)  A ring that does not fit a block's shared memory
(R=128, NBUF=8: 256 KB) is reported as not launchable.

    python -m expann_tpu_torch.tools.perf_pallas_gather
    python -m expann_tpu_torch.tools.perf_pallas_gather --ab

``--ab`` prints one JSON line: the kernel's ms a call at R=128, NBUF=4,
G=G_LO on a 2 GiB table (CUDA events, ``--samples`` readings of ``--reps``
calls each), a digest of its scores, and their largest difference from the
plain version relative to 1 + |score| (the kernel sums in its own order, so
it is not bit-equal to the plain product).  It uses only the package's
public functions, so the same file times another checkout's kernel:
``PYTHONPATH=<checkout> python <this file> --ab``; equal digests mean equal
scores.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import torch

from expann_tpu_torch.ops import _kernels
from expann_tpu_torch.utils.profiling import card_name, event_ms

D = 128
TABLE_BYTES = 1 << 31  # every R: 2 GiB of blocks
R_SWEEP = (16, 32, 64, 128)
NBUF_SWEEP = (2, 4, 8)
G_LO, G_HI = 16384, 98304
HBM_BPS = 3.35e12  # NVIDIA H100 SXM data sheet


def block_gather_scores_plain(packed: torch.Tensor, ids: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (G, R) f32 scores of every step."""
    return torch.einsum("grd,d->gr", packed[ids.long()].float(), q.reshape(-1).float())


def ring_fits(R: int, nbuf: int, d: int = D) -> bool:
    """Whether an NBUF-slot ring of R x d bf16 blocks fits one block's
    shared memory on this card (R=128, NBUF=8 does not: 256 KB)."""
    lib = _kernels.library()
    return lib.expann_block_gather_smem_bytes(R, d, nbuf) <= lib.expann_smem_optin()


def block_gather_scores_cuda(packed: torch.Tensor, ids: torch.Tensor, q: torch.Tensor, nbuf: int) -> torch.Tensor:
    """Launch ``block_gather_kernel``; raises ValueError when the NBUF-slot
    ring does not fit one block's shared memory.  ids must lie in
    [0, packed.shape[0])."""
    device = packed.device
    q = q.reshape(-1)
    _kernels.require_cuda(packed, "packed", torch.bfloat16, device)
    _kernels.require_cuda(ids, "ids", torch.int32, device)
    _kernels.require_cuda(q, "q", torch.bfloat16, device)
    if packed.dim() != 3 or ids.dim() != 1 or q.shape[0] != packed.shape[2]:
        raise ValueError(f"packed {tuple(packed.shape)}, ids {tuple(ids.shape)}, q {tuple(q.shape)}")
    _, R, Dp = packed.shape
    G = ids.shape[0]
    if Dp % 8 or not 1 <= nbuf <= 16:
        raise ValueError(f"unsupported shape: D={Dp} (a multiple of 8), nbuf={nbuf} (1..16)")
    out = torch.empty((G, R), dtype=torch.float32, device=device)
    # the limit, the launcher's shared-memory setting and its grid are the
    # current device's
    with torch.cuda.device(device):
        if not ring_fits(R, nbuf, Dp):
            lib = _kernels.library()
            raise ValueError(f"a ring of {nbuf} blocks of {R} x {Dp} bf16 needs "
                             f"{lib.expann_block_gather_smem_bytes(R, Dp, nbuf)} bytes of shared memory; "
                             f"a block may use {lib.expann_smem_optin()}")
        if G == 0:
            return out
        code = _kernels.library().expann_block_gather(packed.data_ptr(), ids.data_ptr(), q.data_ptr(), out.data_ptr(),
                                                      G, R, Dp, nbuf, _kernels.stream_ptr(device))
    _kernels.check(code, "block_gather")
    _kernels.launches["block_gather"] += 1
    return out


def block_gather_scores(packed: torch.Tensor, ids: torch.Tensor, q: torch.Tensor, nbuf: int = 4) -> torch.Tensor:
    """(G, R) scores: the kernel on CUDA tensors, the plain version on CPU
    tensors (which has no ring and ignores ``nbuf``)."""
    if packed.is_cuda:
        return block_gather_scores_cuda(packed, ids, q, nbuf)
    if packed.device.type != "cpu":
        raise ValueError(f"block_gather runs on CUDA or CPU tensors, not {packed.device}")
    return block_gather_scores_plain(packed, ids, q)


def run_block_gather(packed: torch.Tensor, ids: torch.Tensor, q: torch.Tensor, nbuf: int = 4) -> torch.Tensor:
    """The TPU function's result: the last step's (1, R) row."""
    return block_gather_scores(packed, ids, q, nbuf)[-1:]


def library_chain(packed: torch.Tensor, ids: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The same scores by a gather and one bf16 product with f32 results
    (a yardstick; the port never calls it)."""
    _, R, Dp = packed.shape
    return torch.mm(packed[ids.long()].view(-1, Dp), q.reshape(Dp, 1), out_dtype=torch.float32).view(-1, R)


def table_blocks(R: int) -> int:
    """Blocks of the sweep's table at R: TABLE_BYTES of R x D bf16 blocks."""
    return TABLE_BYTES // (R * D * 2)


def _best_ms(fn, nb: int, G: int, gen: torch.Generator) -> float:
    """Best of 4 calls by CUDA events, each with fresh ids, after one."""
    fresh = lambda: torch.randint(0, nb, (G,), generator=gen, device=gen.device, dtype=torch.int32)  # noqa: E731
    fn(fresh())
    best = float("inf")
    for _ in range(4):
        ids = fresh()
        best = min(best, event_ms(lambda: fn(ids), reps=1, warmup=0))
    return best


def sweep(device="cuda", log=print) -> list:
    """The tool's sweep on the card; one dict per (R, NBUF) with GB/s and
    ns per block from the slope between G_LO and G_HI steps, the share of
    the card's 3.35 TB/s, and the library chain's GB/s at that R."""
    g_lo, g_hi = G_LO, G_HI
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((1, D), generator=gen, device=device).to(torch.bfloat16)
    rows = []
    for R in R_SWEEP:
        nb = table_blocks(R)
        packed = torch.randn((nb, R, D), generator=gen, device=device, dtype=torch.bfloat16)
        blk = R * D * 2
        lib = [_best_ms(lambda ids: library_chain(packed, ids, q), nb, G, gen) for G in (g_lo, g_hi)]
        lib_gbs = (g_hi - g_lo) * blk / (lib[1] - lib[0]) / 1e6
        for nbuf in NBUF_SWEEP:
            if not ring_fits(R, nbuf):
                log(f"R={R:4d} ({blk // 1024:3d}KB/blk) NBUF={nbuf}: not launchable: the ring does not fit "
                    "one block's shared memory")
                rows.append(dict(R=R, nbuf=nbuf, launchable=False))
                continue
            t = [_best_ms(lambda ids: block_gather_scores_cuda(packed, ids, q, nbuf), nb, G, gen)
                 for G in (g_lo, g_hi)]
            dt = t[1] - t[0]
            gbs = (g_hi - g_lo) * blk / dt / 1e6
            row = dict(R=R, nbuf=nbuf, launchable=True, block_kb=blk / 1024, gb_per_s=gbs,
                       ns_per_block=dt * 1e6 / (g_hi - g_lo), hbm_share=gbs * 1e9 / HBM_BPS,
                       t_lo_ms=t[0], t_hi_ms=t[1], library_gb_per_s=lib_gbs)
            rows.append(row)
            log(f"R={R:4d} ({blk // 1024:3d}KB/blk) NBUF={nbuf}: {gbs:7.1f} GB/s  {row['ns_per_block']:7.2f} ns/blk  "
                f"{100 * row['hbm_share']:5.1f}% of 3.35 TB/s  (t_lo={t[0]:.3f}ms t_hi={t[1]:.3f}ms; "
                f"library chain {lib_gbs:.1f} GB/s)")
        del packed
    return rows


def main(device="cuda") -> list:
    print(f"card: {card_name()}", flush=True)
    return sweep(device, log=lambda s: print(s, flush=True))


def ab(argv=None) -> dict:
    """The A/B reading (see the module's docstring); one JSON line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ab", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--samples", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("perf_pallas_gather --ab times the kernel on an NVIDIA GPU; none is present")
    import expann_tpu_torch
    from expann_tpu_torch.tools import perf_pallas_gather as pkg  # the checkout on the path

    dev = torch.device("cuda")
    R, nbuf, G = 128, 4, pkg.G_LO
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((1, pkg.D), generator=gen, device=dev).to(torch.bfloat16)
    packed = torch.randn((pkg.table_blocks(R), R, pkg.D), generator=gen, device=dev, dtype=torch.bfloat16)
    ids = torch.randint(0, packed.shape[0], (G,), generator=gen, device=dev, dtype=torch.int32)
    got = pkg.block_gather_scores_cuda(packed, ids, q, nbuf)
    ref = pkg.block_gather_scores_plain(packed, ids, q)
    ms = [event_ms(lambda: pkg.block_gather_scores_cuda(packed, ids, q, nbuf), reps=args.reps)
          for _ in range(args.samples)]
    row = {"kernel": "block_gather", "R": R, "nbuf": nbuf, "G": G, "ms": ms, "reps": args.reps,
           "digest": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16],
           "worst_relative": float(((got - ref).abs() / (1 + ref.abs())).max()),
           "card": card_name(), "package": expann_tpu_torch.__file__}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    if "--ab" in sys.argv[1:]:
        ab(sys.argv[1:])
    else:
        main()
