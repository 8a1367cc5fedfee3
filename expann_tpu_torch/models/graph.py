"""Device-resident layered graph index (counterpart of
expann_tpu/models/graph.py).

Every array is a dense, padded tensor on one device:

  * ``vectors``: ``(N + 1, D_pad)`` f32.  Row ``N`` is an all-zeros dummy
    row whose stored norm is ``+inf``, so ``|q|^2 + |x|^2 - 2 q.x`` against
    it is ``+inf`` and sentinel neighbours mask themselves.
  * ``adj_bottom``: ``(N + 1, R0)`` int32 edge ids, sentinel ``N`` padding;
    row ``N`` is all-sentinel.
  * upper layers keep only their members: ``adj`` indexed by slot (global
    ids inside) plus a global-id -> slot lookup table.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from expann_tpu_torch.ops.distance import LANE, pad_dim, squared_norms


@dataclasses.dataclass
class UpperLayer:
    """One HNSW layer above the bottom.  ``slot`` maps a global vector id to
    its row in ``adj`` (non-members map to the sentinel row ``n_l``)."""

    slot: torch.Tensor  # (N + 1,) int32 -> row in adj, sentinel n_l
    adj: torch.Tensor  # (n_l + 1, Ru) int32 global ids, sentinel N


@dataclasses.dataclass
class GraphIndex:
    """A built index: corpus + layered adjacency (+ the serving layout)."""

    vectors: torch.Tensor  # (N + 1, D_pad) f32, dummy last row
    norms: torch.Tensor  # (N + 1,) f32, norms[N] = +inf
    adj_bottom: torch.Tensor  # (N + 1, R0) int32, sentinel N
    layers: Tuple[UpperLayer, ...]  # layer 1 .. max_layer - 1 (may be empty)
    starting_vertex: int
    # uint8 codes of the compressed beam (ops/quantize.py), attached when
    # use_compression is on
    codes: Optional[torch.Tensor] = None  # (N + 1, D_pad) uint8
    code_norms: Optional[torch.Tensor] = None  # (N + 1,) f32, +inf at N
    # affine parameters of "ranged" codes; None for "simple" (cast) codes
    quant_scale: Optional[torch.Tensor] = None  # () f32
    quant_offset: Optional[torch.Tensor] = None  # () f32
    # members of the largest upper layer (dense entry-seed scan,
    # models/search.entry_members), sentinel-padded to a multiple of 128
    entry_members: Optional[torch.Tensor] = None  # (n_l_pad,) int32
    entry_members_n: int = 0  # real (unpadded) member count
    # the serving layout (models/layout.py: Blocks, CodeBlocks, Rows or
    # CodeRows),
    # built on the first query, never persisted; None drops it
    layout: Optional[object] = None

    @property
    def n(self) -> int:
        return self.vectors.shape[0] - 1

    @property
    def sentinel(self) -> int:
        return self.vectors.shape[0] - 1

    @property
    def packed(self) -> Optional[torch.Tensor]:
        """The layout's blocks (bf16 or s8), or None."""
        return getattr(self.layout, "packed", None)

    @property
    def packed_rows(self) -> Optional[torch.Tensor]:
        """The rows layout's corpus (bf16 rows or s8 code rows), or None."""
        return getattr(self.layout, "rows", None)


def make_corpus(x: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad an ``(N, D)`` host array into the ``(N + 1, D_pad)`` device corpus
    with the +inf-norm dummy row used for sentinel masking."""
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    xp = pad_dim(x, LANE)
    xp = np.concatenate([xp, np.zeros((1, xp.shape[1]), np.float32)], axis=0)
    vectors = torch.from_numpy(xp).to(device)
    norms = squared_norms(vectors)
    norms[n] = float("inf")
    return vectors, norms
