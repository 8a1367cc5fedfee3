"""Matmul-distance primitives (counterpart of expann_tpu/ops/distance.py).

Every distance is ``d2(q, x) = |q|^2 + |x|^2 - 2 q.x`` in float32; the
feature dimension is zero-padded to a multiple of 128, which leaves L2
distances unchanged and keeps the index layout identical to the JAX
package's.
"""

from __future__ import annotations

import numpy as np
import torch

LANE = 128  # feature-dim padding target (the JAX package's layout)
SUBLANE = 8  # row padding target for 2-D tiles


def pad_dim(x, multiple: int = LANE):
    """Zero-pad the last (feature) dimension up to ``multiple``."""
    pad = (-x.shape[-1]) % multiple
    if pad == 0:
        return x
    if isinstance(x, np.ndarray):
        return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    return torch.nn.functional.pad(x, (0, pad))


def pad_rows(x, multiple: int = SUBLANE, fill=0):
    """Pad the first (row) dimension up to ``multiple`` with ``fill``."""
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    if isinstance(x, np.ndarray):
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1), constant_values=fill)
    tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail], dim=0)


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms of an ``(N, D)`` tensor -> ``(N,)`` f32."""
    x = x.float()
    return torch.sum(x * x, dim=-1)


def pairwise_dist2(
    q: torch.Tensor,
    x: torch.Tensor,
    x_norms: torch.Tensor | None = None,
    q_norms: torch.Tensor | None = None,
) -> torch.Tensor:
    """All-pairs squared L2 distances ``(B, D) x (N, D) -> (B, N)``, f32,
    clamped at 0 (cancellation can leave tiny negatives)."""
    q = q.float()
    x = x.float()
    if q_norms is None:
        q_norms = squared_norms(q)
    if x_norms is None:
        x_norms = squared_norms(x)
    d2 = q_norms[:, None] + x_norms[None, :] - 2.0 * (q @ x.T)
    return torch.clamp_min(d2, 0.0)


def batched_neighbour_dist2(
    q: torch.Tensor,
    nbr_vecs: torch.Tensor,
    nbr_norms: torch.Tensor,
    q_norms: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-query candidate distances ``(B, D) x (B, M, D) -> (B, M)``.

    Neighbours carrying a +inf norm (the sentinel row) come out at +inf.
    """
    q = q.float()
    nbr_vecs = nbr_vecs.float()
    if q_norms is None:
        q_norms = squared_norms(q)
    dots = torch.einsum("bd,bmd->bm", q, nbr_vecs)
    return torch.clamp_min(q_norms[:, None] + nbr_norms - 2.0 * dots, 0.0)
