"""Flat exact k-NN over a bf16 or s8 corpus (counterpart of
expann_tpu/ops/pallas_topk.py ``flat_topk``, ``quantize_corpus_i8`` and
``quantize_query_i8``).

``flat_topk`` returns, for every query, the k nearest corpus rows by
(distance, id): distances are ``(|q|^2 + |x|^2) - 2 q.x`` clamped at 0,
with all sums in f32.  A bf16 corpus takes any float query and rounds it
to bf16; an int8 corpus (centered codes from ``quantize_corpus_i8``) needs
int8 queries (``quantize_query_i8``), as the JAX launcher asserts, and its
distances are exact integers (every partial sum stays below 2^24).  On a
CUDA tensor it launches a hand-written kernel of ``csrc/flat_topk.cu``,
each in a bf16 and an s8 version, all four on one tensor-core distance
tile: the count-then-insert kernel (``mode="count"``, the default: a ballot
admits only the candidates below a query's k-th) or the fixed-pass kernel
(``mode="fixed"``, the counterpart of the TPU kernel's k passes per tile: a
compare-exchange network that sorts each tile's 64 candidates and merges
them into the list, the same stages whatever the data).  Both modes
compute the same distances and return the same ids.  On a CPU tensor it
runs ``flat_topk_plain``, the plain PyTorch version of all four.

The selection is exact: the TPU kernel's 128-lane pooling and packed keys
are not reproduced, so both versions agree with the exact oracle
(``BruteForceEngine(mode="exact")``) on the rounded corpus, and on s8
codes the kernels and the plain version return identical ids and
distances.  Slots beyond the corpus size (k > n) hold id -1 and distance
+inf.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from expann_tpu_torch.ops import _kernels

K_MAX = 128  # the kernels keep up to 128 list slots per query
MODES = ("count", "fixed")


def flat_topk_prepare(x: np.ndarray, device, dtype=torch.bfloat16) -> Tuple[torch.Tensor, int]:
    """Upload a host corpus ``(n, D)`` for flat_topk: returns ``(x_dev, n)``.
    No row padding is needed: the kernel masks the ragged last tile."""
    x = np.asarray(x, np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype).contiguous(), x.shape[0]


def quantize_corpus_i8(x: np.ndarray, device) -> Tuple[torch.Tensor, np.ndarray, float, int]:
    """Symmetric centered int8 codes of a host corpus ``(n, D)`` for the s8
    flat scan: ``round((x - mean) * 127 / absmax)``, half to even.
    Distances are shift-invariant and the scale is common, so integer
    distances rank like true ones.  Returns ``(codes_dev, center, scale,
    n)``; quantize queries with ``quantize_query_i8(q, center, scale)``.
    Host numpy, as in the JAX package, so the codes are bit-identical (no
    row padding here)."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    center = x.mean(axis=0)
    xc = x - center
    absmax = float(np.abs(xc).max()) or 1.0
    scale = 127.0 / absmax
    codes = np.clip(np.rint(xc * scale), -127, 127).astype(np.int8)
    return torch.from_numpy(codes).to(device), center, scale, n


def quantize_query_i8(q: np.ndarray, center: np.ndarray, scale: float) -> np.ndarray:
    """int8 codes of host queries with a corpus's ``center`` and ``scale``."""
    return np.clip(np.rint((np.asarray(q, np.float32) - center) * scale), -127, 127).astype(np.int8)


def flat_topk_plain(
    q: torch.Tensor, x: torch.Tensor, k: int, chunk: int = 1024, col_block: int = 1 << 20
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernels: the same distances, an exact
    (d, id)-ordered selection by stable sort.  Returns ``(ids, d)``
    ``(B, k)`` int32 / f32.  On int8 codes every f32 product and partial
    sum is an exact integer, so the distances equal the kernels' bit for
    bit.  The corpus is scored in blocks of ``col_block`` rows (queries in
    chunks of ``chunk``), each block's k best merged into the running list
    by a stable sort: the earlier blocks hold the lower ids, so the merged
    list stays ordered by (d, id) and memory stays bounded at tens of
    millions of rows."""
    _check_query_dtype(q, x)
    B = q.shape[0]
    n = x.shape[0]
    qf = q.to(x.dtype).float()
    qn = torch.sum(qf * qf, dim=1)
    ids = torch.empty((B, 0), dtype=torch.int32, device=x.device)
    d = torch.empty((B, 0), device=x.device)
    for c0 in range(0, n, col_block):
        xf = x[c0 : c0 + col_block].float()
        xn = torch.sum(xf * xf, dim=1)
        ids_b, d_b = [], []
        for s in range(0, B, chunk):
            d2 = torch.clamp_min((qn[s : s + chunk, None] + xn[None, :]) - 2.0 * (qf[s : s + chunk] @ xf.T), 0.0)
            d_s, idx = torch.sort(d2, dim=1, stable=True)
            ids_b.append(idx[:, :k].to(torch.int32) + c0)
            d_b.append(d_s[:, :k].clone())  # not a view: it would hold the whole block's sort
        if not ids_b:  # B == 0
            return torch.empty((0, k), dtype=torch.int32, device=x.device), torch.empty((0, k), device=x.device)
        ids, d = torch.cat([ids, torch.cat(ids_b)], 1), torch.cat([d, torch.cat(d_b)], 1)
        if c0:
            d, order = torch.sort(d, dim=1, stable=True)
            ids, d = ids.gather(1, order[:, :k]), d[:, :k]
    if k > n:
        ids = torch.cat([ids, torch.full((B, k - n), -1, dtype=torch.int32, device=ids.device)], 1)
        d = torch.cat([d, torch.full((B, k - n), float("inf"), device=d.device)], 1)
    return ids, d


def _check_query_dtype(q: torch.Tensor, x: torch.Tensor) -> None:
    if (x.dtype == torch.int8) != (q.dtype == torch.int8):
        raise TypeError(f"an int8 corpus needs int8 queries and only it does: q {q.dtype}, x {x.dtype}")


def _launch(name: str, q: torch.Tensor, x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    device = x.device
    _check_query_dtype(q, x)
    s8 = x.dtype == torch.int8
    dtype = torch.int8 if s8 else torch.bfloat16
    q = q.to(dtype).contiguous()
    _kernels.require_cuda(x, "x", dtype, device)
    _kernels.require_cuda(q, "q", dtype, device)
    B, D = q.shape
    n, Dx = x.shape
    if D != Dx or D % 64 != 0:
        raise ValueError(f"query dim {D} / corpus dim {Dx}: both equal and a multiple of 64")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k={k} outside 1..{K_MAX}")
    ids = torch.empty((B, k), dtype=torch.int32, device=device)
    d = torch.empty((B, k), dtype=torch.float32, device=device)
    if B == 0:
        return ids, d
    name = f"{name}_s8" if s8 else name
    with torch.cuda.device(device):  # the launcher sets its shared memory on the current device
        code = getattr(_kernels.library(), f"expann_{name}" if s8 else f"expann_{name}_bf16")(
            q.data_ptr(), x.data_ptr(), n, B, D, k, ids.data_ptr(), d.data_ptr(),
            _kernels.stream_ptr(device),
        )
    _kernels.check(code, name)
    _kernels.launches[name] += 1
    return ids, d


def flat_topk_cuda(q: torch.Tensor, x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the count-mode kernel (K2, or K2-s8 on an int8 corpus;
    ``csrc/flat_topk.cu``) on CUDA tensors."""
    return _launch("flat_topk", q, x, k)


def flat_topk_fixed_cuda(q: torch.Tensor, x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fixed-pass kernel (K3, or K3-s8 on an int8 corpus;
    ``csrc/flat_topk.cu``: K2's tile, a compare-exchange network) on CUDA
    tensors."""
    return _launch("flat_topk_fixed", q, x, k)


def flat_topk(q: torch.Tensor, x: torch.Tensor, k: int, mode: str = "count") -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest rows of ``x`` (n, D), bf16 or int8, for each query ``q``
    (B, D): ``(ids, d)`` of shape (B, k), ascending by (d, id).  ``mode``
    picks the kernel on CUDA tensors (``"count"`` or ``"fixed"``); CPU
    tensors run the plain version, which is both."""
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: one of {MODES}")
    if x.is_cuda:
        return (flat_topk_cuda if mode == "count" else flat_topk_fixed_cuda)(q, x, k)
    if x.device.type != "cpu":
        raise ValueError(f"flat_topk runs on CUDA or CPU tensors, not {x.device}")
    return flat_topk_plain(q, x, k)
