"""Packed-neighbour serving layout and the per-iteration block scorer
(counterpart of expann_tpu/ops/pallas_beam.py ``build_packed``,
``build_packed_i8`` and ``packed_score``).

Each node's neighbour vectors are stored contiguously, so one expansion
reads one ``(RS, D)`` block instead of RS scattered rows:

  * ``packed`` ``(N+1, RS, D)`` in the serving dtype (bf16, f32 for tests,
    or centered s8 codes from ``build_packed_i8``), ``RS = roundup(R, 16)``
    (32 for s8);
  * ``packed_norms`` ``(N+1, R_tile)`` f32 — the neighbours' squared norms
    (code-space norms for s8), +inf at sentinel and pad slots so padding
    masks itself;
  * ``packed_ids`` ``(N+1, R_tile)`` int32 — the neighbour ids, sentinel
    padded; ``R_tile = roundup(RS, 128)`` as in the JAX layout.

The JAX layout carries ids as biased f32 bit patterns inside one aux
array (``ID_BIAS``) because TPU copies flush f32 denormals; here ids are a
plain int32 array.

Where the blocks do not fit the card (1M rows of 960 dims: 201 GB of bf16
blocks), ``build_rows`` gives the rows layout instead: the bf16 corpus
``(N+1, D)`` once (its row N zeros) with the same norm and id rows; the
fused traversal then reads each neighbour's row by its id
(ops/fused.py ``fused_search_rows``).  Where s8 blocks do not fit (1M rows
of 1024 padded dims: 98 GB), ``build_code_rows`` gives the same over the
centred s8 code corpus (1 GB), with the s8 blocks' code-space norm and id
rows.

``packed_score`` scores the blocks of selected nodes for one traversal
iteration of the per-iteration beam search (models/search.py
``beam_search``): on CUDA tensors the hand-written kernel
``csrc/packed_score.cu``, on CPU tensors ``packed_score_plain``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from expann_tpu_torch.ops import _kernels

PACKED_SCORE_MAX_RT = 2048  # the kernel sorts at most 16 keys a thread of 128


def packed_widths(r: int, align: int = 16) -> Tuple[int, int]:
    """``(RS, R_tile)`` for an adjacency of width ``r``; blocks of s8 codes
    align RS to 32 (pallas_beam.py:348), bf16 ones to 16."""
    rs = r + ((-r) % align)
    return rs, rs + ((-rs) % 128)


def packed_bytes(np1: int, r: int, d: int, dtype: str) -> int:
    """Device bytes of the packed blocks of ``np1`` nodes of width ``r``:
    ``"i8"`` (1 B per element, RS aligned to 32) or ``"bf16"``."""
    if dtype == "i8":
        return np1 * packed_widths(r, 32)[0] * d
    return np1 * packed_widths(r)[0] * d * 2


def rows_bytes(np1: int, d: int) -> int:
    """Device bytes of the rows layout's bf16 corpus of ``np1`` rows."""
    return np1 * d * 2


def code_rows_bytes(np1: int, d: int) -> int:
    """Device bytes of the code rows layout's s8 corpus of ``np1`` rows."""
    return np1 * d


def neighbour_rows(
    row_norms: torch.Tensor,  # (N+1,) squared norms, +inf at N
    adj: torch.Tensor,  # (N+1, R) int32, sentinel N padding
    align: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(packed_norms, packed_ids)`` ``(N+1, R_tile)``: each node's
    neighbour ids, sentinel padded to R_tile, and their norms (+inf at the
    sentinel slots)."""
    np1, r = adj.shape
    r_tile = packed_widths(r, align)[1]
    ids = torch.full((np1, r_tile), np1 - 1, dtype=torch.int32, device=adj.device)
    ids[:, :r] = adj
    return row_norms[ids.long()], ids


def build_rows(
    vectors: torch.Tensor,  # (N+1, D) f32 corpus with sentinel row
    norms: torch.Tensor,  # (N+1,) f32, norms[N] = +inf
    adj: torch.Tensor,  # (N+1, R) int32, sentinel N padding
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rows layout: ``(rows, packed_norms, packed_ids)``, the bf16
    corpus and ``build_packed``'s norm and id rows, without the blocks."""
    return (vectors.to(torch.bfloat16), *neighbour_rows(norms, adj))


def pack_blocks(
    rows: torch.Tensor,  # (N+1, D) corpus or codes, sentinel row last
    row_norms: torch.Tensor,  # (N+1,) their squared norms, +inf at N
    adj: torch.Tensor,  # (N+1, R) int32, sentinel N padding
    align: int = 16,
    dtype: torch.dtype | None = None,
    chunk: int = 32768,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(packed, packed_norms, packed_ids)`` of ``rows`` (cast to
    ``dtype``) with RS aligned to ``align``, gathered in row chunks so a
    gather never holds more than ``chunk * RS * D`` elements."""
    np1, r = adj.shape
    rs = packed_widths(r, align)[0]
    packed_norms, ids = neighbour_rows(row_norms, adj, align)
    packed = torch.empty((np1, rs, rows.shape[1]), dtype=dtype or rows.dtype, device=rows.device)
    for s in range(0, np1, chunk):
        packed[s : s + chunk] = rows[ids[s : s + chunk, :rs].long()].to(packed.dtype)
    return packed, packed_norms, ids


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
    return pack_blocks(vectors, norms, adj, 16, dtype, chunk)


def code_corpus(
    vectors: torch.Tensor,  # (N+1, D) f32 corpus with sentinel row
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The centred s8 code corpus of both s8 layouts: ``(codes, code_norms,
    center, scale)``, the codes ``(N+1, D)`` int8 with their norms
    ``(N+1,)`` (integer-valued f32, exact while ``127^2 D < 2^24``, i.e. up
    to D = 1024; +inf at the sentinel) and the f32 query transform
    ``qc = clip(round((q - center) * scale), -127, 127)``: ``center``
    ``(D,)`` and ``scale`` ``()``.  Centering by the corpus mean and one
    absmax scale is the ``quantize_corpus_i8`` recipe.  The mean is a
    device f32 mean, as in the JAX package; its last bit may differ there,
    so tests that need the JAX codes carry them across (utils/persist.py)."""
    sentinel = vectors.shape[0] - 1
    vf = vectors.float()
    center = vf[:sentinel].mean(dim=0)
    absmax = torch.clamp_min(torch.max(torch.abs(vf[:sentinel] - center)), 1e-30)
    scale = 127.0 / absmax
    codes = torch.clamp(torch.round((vf - center) * scale), -127, 127).to(torch.int8)
    cf = codes.float()
    code_norms = torch.sum(cf * cf, dim=1)
    code_norms[sentinel] = float("inf")
    return codes, code_norms, center, scale


def build_packed_i8(
    vectors: torch.Tensor,  # (N+1, D) f32 corpus with sentinel row
    adj: torch.Tensor,  # (N+1, R) int32, sentinel N padding
    chunk: int = 32768,
):
    """The packed layout over CENTERED s8 codes (``code_corpus``): half the
    bytes per expansion of the bf16 layout, scored exactly in code space
    (|code| <= 127 and D <= 512 keep integer distances below 2^24).

    Returns ``(packed, packed_norms, packed_ids, codes, code_norms, center,
    scale)``: int8 blocks ``(N+1, RS, D)`` with ``RS = roundup(R, 32)``,
    their CODE-SPACE norms and ids ``(N+1, R_tile)`` (+inf / sentinel at
    pad slots), and ``code_corpus``'s codes, norms (for entry-point
    scoring) and query transform."""
    codes, code_norms, center, scale = code_corpus(vectors)
    packed, packed_norms, packed_ids = pack_blocks(codes, code_norms, adj, 32, chunk=chunk)
    return packed, packed_norms, packed_ids, codes, code_norms, center, scale


def build_code_rows(
    vectors: torch.Tensor,  # (N+1, D) f32 corpus with sentinel row
    adj: torch.Tensor,  # (N+1, R) int32, sentinel N padding
):
    """The code rows layout: ``(codes, packed_norms, packed_ids, code_norms,
    center, scale)``, ``code_corpus``'s codes and transform with the s8
    blocks' code-space norm and id rows (RS aligned to 32), without the
    blocks: the traversal reads each neighbour's code row by its id."""
    codes, code_norms, center, scale = code_corpus(vectors)
    return (codes, *neighbour_rows(code_norms, adj, 32), code_norms, center, scale)


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


@functools.lru_cache(maxsize=None)
def _smem_bytes(D: int, RS: int, Rt: int) -> Tuple[int, int]:
    """The block scorer's shared memory at these widths, and the card's
    limit per block."""
    lib = _kernels.library()
    return lib.expann_packed_score_smem_bytes(D, RS, Rt), lib.expann_smem_optin()


def packed_score_cuda(
    packed: torch.Tensor,
    packed_norms: torch.Tensor,
    packed_ids: torch.Tensor,
    sel: torch.Tensor,
    q: torch.Tensor,
    topt: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the block scorer (``csrc/packed_score.cu``) on CUDA tensors.
    ``sel`` must hold node ids in ``[0, N]``; the kernel does not check.
    Raises ValueError on a shape the kernel does not take: R_tile above
    ``PACKED_SCORE_MAX_RT``, or widths whose staging needs more shared
    memory than a block may use (D above ~6000 at R_tile = 128)."""
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
    if D % 8 or RS % 16 or RS == 0 or not 0 <= topt <= Rt or Rt > PACKED_SCORE_MAX_RT:
        raise ValueError(f"unsupported shape: D={D} RS={RS} topt={topt} R_tile={Rt}")
    K = topt or Rt
    out_d = torch.empty((B, E * K), dtype=torch.float32, device=device)
    out_i = torch.empty((B, E * K), dtype=torch.int32, device=device)
    # the card's limit, and the launcher's shared-memory setting, are the
    # current device's
    with torch.cuda.device(device):
        smem, allowed = _smem_bytes(D, RS, Rt)
        if smem > allowed:
            raise ValueError(f"packed_score at D={D} RS={RS} R_tile={Rt} needs {smem} bytes of shared memory; "
                             f"a block may use {allowed}")
        if B * E == 0:
            return out_d, out_i
        code = _kernels.library().expann_packed_score_bf16(
            packed.data_ptr(), packed_norms.data_ptr(), packed_ids.data_ptr(), sel.data_ptr(),
            q.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            B, E, D, RS, Rt, int(topt), n1 - 1,
            _kernels.stream_ptr(device),
        )
    _kernels.check(code, "packed_score")
    # a captured call launches nothing: its replays count their launches
    if not torch.cuda.is_current_stream_capturing():
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
