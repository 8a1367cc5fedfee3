"""Brute-force k-NN engine (counterpart of expann_tpu/models/brute_force.py).

Two modes:
  * ``mode="exact"``: one f32 ``(B, N)`` matmul-distance and an exact
    selection ordered by (d, id) — the ground-truth oracle (reference:
    src/brute_force_engine.h:29-46).  Plain tensor code: the JAX package
    leaves this path to XLA too, so it has no kernel.
  * ``mode="fused"``: a flat top-k kernel (ops/topk.py) over a bf16
    corpus; never materializes the ``(B, N)`` distances.  Exact selection
    on the bf16-rounded vectors, so recall@10 is ~1 minus bf16 rounding.
    ``topk_mode`` picks the kernel: ``"count"`` (count-then-insert, the
    default) or ``"fixed"`` (k passes per corpus tile); same results.

``mode="fused_i8"`` of the JAX package is not ported yet.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from expann_tpu_torch.models.base import Engine, ParamList, _concat_pending
from expann_tpu_torch.ops.distance import pad_dim, pairwise_dist2, squared_norms
from expann_tpu_torch.ops.topk import MODES, flat_topk, flat_topk_prepare


def exact_topk(q: torch.Tensor, x: torch.Tensor, x_norms: torch.Tensor, k: int):
    """Exact k nearest rows of ``x`` per query, ordered by (d, id):
    returns ``(ids, d)``.  A stable sort keeps the lower id first on ties
    (``torch.topk`` does not)."""
    d2 = pairwise_dist2(q, x, x_norms=x_norms)
    d_s, idx = torch.sort(d2, dim=1, stable=True)
    return idx[:, :k], d_s[:, :k]


class BruteForceEngine(Engine):
    """Nearest neighbours over a corpus held on ``device`` (the card by
    default; ``device="cpu"`` runs the plain versions)."""

    def __init__(
        self,
        batch_size: int = 1024,
        precision: str = "highest",
        mode: str = "exact",
        topk_mode: str = "count",
        *,
        device="cuda",
    ):
        if mode not in ("exact", "fused"):
            raise NotImplementedError(
                f"mode={mode!r}: only 'exact' and 'fused' are ported (fused_i8 is on the roadmap)"
            )
        if topk_mode not in MODES:
            raise ValueError(f"topk_mode={topk_mode!r}: one of {MODES}")
        self.device = torch.device(device)
        self._pending: List[np.ndarray] = []
        self._x = None
        self._x_norms = None
        self._x_fused = None
        self.n = 0
        self.dim = 0
        self.batch_size = batch_size
        # "default" and "highest" both mean full f32 here (TF32 is off)
        self.precision = precision
        self.mode = mode
        self.topk_mode = topk_mode

    def name(self) -> str:
        return "Brute-Force Engine"

    def param_list(self) -> ParamList:
        return {}

    def store_vector(self, v: np.ndarray) -> None:
        self._pending.append(np.asarray(v, dtype=np.float32).reshape(1, -1))

    def store_many_vectors(self, vs: np.ndarray, take_norms: bool = False) -> None:
        vs = np.asarray(vs, dtype=np.float32)
        if vs.ndim != 2:
            raise ValueError("Input should be a 2D array")
        if take_norms:
            norms = np.linalg.norm(vs, axis=1, keepdims=True)
            vs = vs / np.maximum(norms, 1e-30)
        self._pending.append(vs)

    def build(self) -> None:
        if not self._pending and self._x is None and self._x_fused is None:
            raise RuntimeError("no vectors stored")
        if self._pending:
            x = _concat_pending(self._pending)
            self._pending = []
            self.n, self.dim = x.shape
            x = pad_dim(x)
            if self.mode == "fused":
                self._x_fused, _ = flat_topk_prepare(x, self.device)
            else:
                self._x = torch.from_numpy(x).to(self.device)
                self._x_norms = squared_norms(self._x)

    def _width(self) -> int:
        return (self._x if self._x is not None else self._x_fused).shape[-1]

    def query_k_batch(self, queries: np.ndarray, k: int) -> np.ndarray:
        if self._x is None and self._x_fused is None:
            raise RuntimeError("build() must be called before queries")
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim != 2:
            raise ValueError("queries must be 2D")
        width = self._width()
        q = pad_dim(q, width)
        if q.shape[-1] != width:
            raise ValueError("query dim exceeds corpus dim")
        out = []
        if self.mode == "fused":
            # queries travel as bf16: the kernel rounds them to the corpus
            # dtype anyway, and it halves the host-to-device bytes
            bs = max(self.batch_size, min(q.shape[0], 16384))
            for start in range(0, q.shape[0], bs):
                chunk = torch.from_numpy(q[start : start + bs]).to(torch.bfloat16)
                ids, _ = flat_topk(chunk.to(self.device), self._x_fused, k, mode=self.topk_mode)
                out.append(ids)
        else:
            for start in range(0, q.shape[0], self.batch_size):
                chunk = torch.from_numpy(q[start : start + self.batch_size]).to(self.device)
                ids, _ = exact_topk(chunk, self._x, self._x_norms, k)
                out.append(ids)
        return torch.cat(out).cpu().numpy()
