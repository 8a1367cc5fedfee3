"""The serving layout of a built index (``GraphIndex.layout``): which arrays
the query routes read, and which kernel traverses them.

  * ``Blocks``: bf16 neighbour blocks with their norm and id rows
    (ops/packed.py ``build_packed``), traversed by K1 and scored by K4 on
    the per-iteration route, whose captured beams (models/search.py) the
    layout keeps in ``beam_graphs``;
  * ``CodeBlocks``: centred s8 blocks (``build_packed_i8``) with the code
    corpus and the query transform, traversed by K1-s8 in code space;
  * ``Rows``: the bf16 corpus with the same norm and id rows
    (``build_rows``), traversed by K1-rows, which counts the rows it reads;
  * ``CodeRows``: the s8 code corpus with the s8 blocks' norm and id rows
    and ``CodeBlocks``' query transform (``build_code_rows``), traversed by
    K1-rows-s8 in code space with exact integer distances to D = 1024.

``choose`` picks one within a byte budget: the blocks where they fit, else
the rows of the same precision where they fit, else none (the gather
route).
"""

from __future__ import annotations

import dataclasses

import torch

from expann_tpu_torch.ops.distance import squared_norms
from expann_tpu_torch.ops.fused import EXACT_MAX_D, fused_search, fused_search_rows
from expann_tpu_torch.ops.packed import (build_code_rows, build_packed, build_packed_i8, build_rows, code_rows_bytes,
                                         packed_bytes, packed_widths, rows_bytes)


class _Layout:
    code_space = False  # the entry scan and the traversal score codes, not the f32 query
    counts_rows = False  # the traversal's count is the corpus rows it read
    beam_blocks = None  # the blocks the per-iteration beam may score with K4

    def kernel_query(self, q: torch.Tensor) -> torch.Tensor:
        """The f32 query in the layout's space."""
        return q

    def entry_space(self, graph, q, qn):
        """The entry scan's operands: the query and its squared norms in the
        layout's space, and the rows and norms they are scored against."""
        return q, qn, graph.vectors, graph.norms

    def to(self, device):
        """A copy on ``device``, without captured beams."""
        return dataclasses.replace(self, **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
                                            if isinstance(getattr(self, f.name), torch.Tensor)})


@dataclasses.dataclass(eq=False)
class Blocks(_Layout):
    packed: torch.Tensor  # (N + 1, RS, D_pad) bf16 (f32 in CPU tests)
    norms: torch.Tensor  # (N + 1, R_tile) f32, +inf at sentinel and pad slots
    ids: torch.Tensor  # (N + 1, R_tile) int32, sentinel padded
    beam_graphs: dict = dataclasses.field(default_factory=dict, init=False, repr=False)

    @classmethod
    def build(cls, graph, dtype: torch.dtype = torch.bfloat16):
        return cls(*build_packed(graph.vectors, graph.norms, graph.adj_bottom, dtype=dtype))

    @property
    def beam_blocks(self):
        return self

    def traverse(self, q, bd0, bi0, ef: int, expand: int, cand: int, max_iters: int = 0):
        """The fused traversal of the f32 queries ``q`` from the seed beams:
        ``(beam_ids, ncomp)``."""
        beam_ids, _, ncomp, _ = fused_search(self.packed, self.norms, self.ids, self.kernel_query(q), bd0, bi0,
                                             ef=ef, expand=expand, cand=cand, max_iters=max_iters)
        return beam_ids, ncomp


class _Codes:
    """Code space (``ops/packed.code_corpus``), for a layout with ``codes``,
    ``code_norms``, ``center`` and ``scale``: the entry scan and the
    traversal score the query's s8 codes against the corpus codes."""

    code_space = True

    def kernel_query(self, q):
        """``clip(round((q - center) * scale), -127, 127)`` as integer-valued
        f32 (search.py:537-541)."""
        return torch.clamp(torch.round((q - self.center) * self.scale), -127.0, 127.0)

    def entry_space(self, graph, q, qn):
        qk = self.kernel_query(q)
        return qk, squared_norms(qk), self.codes, self.code_norms


@dataclasses.dataclass(eq=False)
class CodeBlocks(_Codes, Blocks):
    codes: torch.Tensor  # (N + 1, D_pad) int8
    code_norms: torch.Tensor  # (N + 1,) f32, +inf at N
    center: torch.Tensor  # (D_pad,) f32
    scale: torch.Tensor  # () f32

    beam_blocks = None  # K4 has no code-space transform

    @classmethod
    def build(cls, graph):
        return cls(*build_packed_i8(graph.vectors, graph.adj_bottom))


@dataclasses.dataclass(eq=False)
class Rows(_Layout):
    rows: torch.Tensor  # (N + 1, D_pad) bf16, row N zeros
    norms: torch.Tensor  # as Blocks'
    ids: torch.Tensor  # as Blocks'
    rs: int  # id slots scored a node: RS of the blocks the rows stand in for

    counts_rows = True

    @classmethod
    def build(cls, graph):
        rs = packed_widths(graph.adj_bottom.shape[1])[0]
        return cls(*build_rows(graph.vectors, graph.norms, graph.adj_bottom), rs)

    def traverse(self, q, bd0, bi0, ef: int, expand: int, cand: int, max_iters: int = 0):
        beam_ids, _, ncomp, _ = fused_search_rows(self.rows, self.norms, self.ids, self.rs, self.kernel_query(q), bd0,
                                                  bi0, ef=ef, expand=expand, cand=cand, max_iters=max_iters)
        return beam_ids, ncomp


@dataclasses.dataclass(eq=False)
class CodeRows(_Codes, Rows):
    # rows: (N + 1, D_pad) int8 codes, row N the sentinel's; norms / ids:
    # CodeBlocks' code-space rows; rs: their RS (R aligned to 32)
    code_norms: torch.Tensor  # (N + 1,) integer-valued f32, +inf at N
    center: torch.Tensor  # (D_pad,) f32
    scale: torch.Tensor  # () f32

    @property
    def codes(self) -> torch.Tensor:
        return self.rows

    @classmethod
    def build(cls, graph):
        codes, norms, ids, code_norms, center, scale = build_code_rows(graph.vectors, graph.adj_bottom)
        return cls(codes, norms, ids, packed_widths(graph.adj_bottom.shape[1], 32)[0], code_norms, center, scale)


def choose(np1: int, r: int, d: int, dtype: str, budget: int):
    """The layout type for ``np1`` rows of ``d`` dims, adjacency width ``r``
    and blocks of ``dtype`` ("bf16" or "i8") within ``budget`` bytes, or
    None: the blocks where they fit, else the rows of ``dtype`` (the s8
    code rows up to ``EXACT_MAX_D``, where K1-rows-s8 stays exact)."""
    if packed_bytes(np1, r, d, dtype) <= budget:
        return CodeBlocks if dtype == "i8" else Blocks
    if dtype == "i8":
        return CodeRows if d <= EXACT_MAX_D and code_rows_bytes(np1, d) <= budget else None
    return Rows if rows_bytes(np1, d) <= budget else None
