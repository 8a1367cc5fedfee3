"""Packed-neighbour serving layout and the per-iteration block scorer
(counterpart of expann_tpu/ops/pallas_beam.py ``build_packed`` and
``packed_score``).

Each node's neighbour vectors are stored contiguously, so one expansion
reads one ``(RS, D)`` block instead of RS scattered rows:

  * ``packed`` ``(N+1, RS, D)`` in the serving dtype (bf16; f32 for tests),
    ``RS = roundup(R, 16)``;
  * ``packed_norms`` ``(N+1, R_tile)`` f32 — the neighbours' squared norms,
    +inf at sentinel and pad slots so padding masks itself;
  * ``packed_ids`` ``(N+1, R_tile)`` int32 — the neighbour ids, sentinel
    padded; ``R_tile = roundup(RS, 128)`` as in the JAX layout.

The JAX layout carries ids as biased f32 bit patterns inside one aux
array (``ID_BIAS``) because TPU copies flush f32 denormals; here ids are a
plain int32 array.

``packed_score`` scores the blocks of selected nodes for one traversal
iteration of the per-iteration beam search (models/search.py
``beam_search``): on CUDA tensors the hand-written kernel
``csrc/packed_score.cu``, on CPU tensors ``packed_score_plain``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from expann_tpu_torch.ops import _kernels

def packed_widths(r: int) -> Tuple[int, int]:
    """``(RS, R_tile)`` for an adjacency of width ``r``."""
    rs = r + ((-r) % 16)
    return rs, rs + ((-rs) % 128)


def build_packed(
    vectors: torch.Tensor,  # (N+1, D) f32 corpus with sentinel row
    norms: torch.Tensor,  # (N+1,) f32, norms[N] = +inf
    adj: torch.Tensor,  # (N+1, R) int32, sentinel N padding
    dtype: torch.dtype = torch.bfloat16,
    chunk: int = 32768,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Materialize ``(packed, packed_norms, packed_ids)`` from a built graph,
    in row chunks so the f32 gather never exceeds ``chunk * RS * D * 4``
    bytes."""
    np1, r = adj.shape
    sentinel = np1 - 1
    rs, r_tile = packed_widths(r)
    ids = torch.full((np1, r_tile), sentinel, dtype=torch.int32, device=adj.device)
    ids[:, :r] = adj
    packed = torch.empty((np1, rs, vectors.shape[1]), dtype=dtype, device=vectors.device)
    for s in range(0, np1, chunk):
        packed[s : s + chunk] = vectors[ids[s : s + chunk, :rs].long()].to(dtype)
    return packed, norms[ids.long()], ids


def packed_score_plain(
    packed: torch.Tensor,
    packed_norms: torch.Tensor,
    packed_ids: torch.Tensor,
    sel: torch.Tensor,
    q: torch.Tensor,
    topt: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same function, batched."""
    B, E = sel.shape
    RS = packed.shape[1]
    Rt = packed_norms.shape[1]
    s = sel.long()
    qc = q.float().to(packed.dtype).float()
    dots = torch.einsum("bd,berd->ber", qc, packed[s].float())  # (B, E, RS)
    d = packed_norms[s].clone()  # (B, E, Rt); slots >= RS keep their +inf norm
    d[:, :, :RS] -= 2.0 * dots
    ids = packed_ids[s]
    if topt:
        # t passes of (min d, lowest lane): a stable sort; once a row's
        # finite slots are used up, every lane is +inf and lane 0 wins
        order = torch.sort(d, dim=2, stable=True).indices[:, :, :topt]
        d = d.gather(2, order)
        ids = torch.where(torch.isfinite(d), ids.gather(2, order), ids[:, :, :1])
    return d.reshape(B, -1), ids.reshape(B, -1)


def packed_score_cuda(
    packed: torch.Tensor,
    packed_norms: torch.Tensor,
    packed_ids: torch.Tensor,
    sel: torch.Tensor,
    q: torch.Tensor,
    topt: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the block scorer (``csrc/packed_score.cu``) on CUDA tensors.
    ``sel`` must hold node ids in ``[0, N]``; the kernel does not check."""
    device = packed.device
    q = q.float().contiguous()
    for t, name, dtype in (
        (packed, "packed", torch.bfloat16),
        (packed_norms, "packed_norms", torch.float32),
        (packed_ids, "packed_ids", torch.int32),
        (sel, "sel", torch.int32),
        (q, "q", torch.float32),
    ):
        _kernels.require_cuda(t, name, dtype, device)
    n1, RS, D = packed.shape
    Rt = packed_norms.shape[1]
    B, E = sel.shape
    if packed_norms.shape != (n1, Rt) or packed_ids.shape != (n1, Rt) or Rt < RS:
        raise ValueError("packed_norms / packed_ids must be (N+1, R_tile) with R_tile >= RS")
    if q.shape != (B, D):
        raise ValueError(f"q {tuple(q.shape)} does not match ({B}, {D})")
    if D % 8 or RS % 16 or not 0 <= topt <= Rt:
        raise ValueError(f"unsupported shape: D={D} RS={RS} topt={topt} R_tile={Rt}")
    K = topt or Rt
    out_d = torch.empty((B, E * K), dtype=torch.float32, device=device)
    out_i = torch.empty((B, E * K), dtype=torch.int32, device=device)
    if B * E == 0:
        return out_d, out_i
    lib = _kernels.library()
    code = lib.expann_packed_score_bf16(
        packed.data_ptr(), packed_norms.data_ptr(), packed_ids.data_ptr(), sel.data_ptr(),
        q.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
        B, E, D, RS, Rt, int(topt), n1 - 1,
        _kernels.stream_ptr(device),
    )
    _kernels.check(code, "packed_score")
    _kernels.launches["packed_score"] += 1
    return out_d, out_i


def packed_score(
    packed: torch.Tensor,  # (N+1, RS, D) bf16 (f32 accepted on CPU)
    packed_norms: torch.Tensor,  # (N+1, R_tile) f32, +inf at pad slots
    packed_ids: torch.Tensor,  # (N+1, R_tile) int32
    sel: torch.Tensor,  # (B, E) int32 nodes to expand, sentinel allowed
    q: torch.Tensor,  # (B, D) f32
    topt: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score the packed neighbours of each selected node against its query.

    Returns ``(partial_d, ids)`` of shape ``(B, E * R_tile)``, or
    ``(B, E * topt)`` with ``topt > 0``: ``partial_d = |x|^2 - 2 q.x`` with
    q rounded to the block dtype and f32 sums (no ``|q|^2``, no clamp; the
    caller adds ``|q|^2``); slots ``>= RS`` and sentinel slots are +inf and
    carry their id from ``packed_ids``.  With ``topt = t`` each node keeps
    only its t best by (d, lane), ascending; once its finite slots are used
    up, each further pass gives ``(+inf, packed_ids[node, 0])``.  The
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if packed.is_cuda:
        return packed_score_cuda(packed, packed_norms, packed_ids, sel, q, topt)
    if packed.device.type != "cpu":
        raise ValueError(f"packed_score runs on CUDA or CPU tensors, not {packed.device}")
    return packed_score_plain(packed, packed_norms, packed_ids, sel, q, topt)
