"""Packed-neighbour serving layout (counterpart of
expann_tpu/ops/pallas_beam.py ``build_packed``).

Each node's neighbour vectors are stored contiguously, so one expansion of
the fused traversal reads one ``(RS, D)`` block instead of RS scattered
rows:

  * ``packed`` ``(N+1, RS, D)`` in the serving dtype (bf16; f32 for tests),
    ``RS = roundup(R, 16)``;
  * ``packed_norms`` ``(N+1, R_tile)`` f32 — the neighbours' squared norms,
    +inf at sentinel and pad slots so padding masks itself;
  * ``packed_ids`` ``(N+1, R_tile)`` int32 — the neighbour ids, sentinel
    padded; ``R_tile = roundup(RS, 128)`` as in the JAX layout.

The JAX layout carries ids as biased f32 bit patterns inside one aux
array (``ID_BIAS``) because TPU copies flush f32 denormals; here ids are a
plain int32 array.
"""

from __future__ import annotations

from typing import Tuple

import torch


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
