"""Brute-force k-NN engine (counterpart of expann_tpu/models/brute_force.py).

Three modes:
  * ``mode="exact"``: one f32 ``(B, N)`` matmul-distance and an exact
    selection ordered by (d, id) — the ground-truth oracle (reference:
    src/brute_force_engine.h:29-46).  Plain tensor code: the JAX package
    leaves this path to XLA too, so it has no kernel.
  * ``mode="fused"``: a flat top-k kernel (ops/topk.py) over a bf16
    corpus; never materializes the ``(B, N)`` distances.  Exact selection
    on the bf16-rounded vectors, so recall@10 is ~1 minus bf16 rounding.
  * ``mode="fused_i8"``: the same kernels over centered int8 codes
    (``quantize_corpus_i8``), scanning for ``min(rerank_mult * k, 128)``
    candidates, then an exact f32 rerank of those against the corpus held
    in f32 or, with ``rerank_store="bf16"``, in bf16 (norms from the host
    f32 copy).  ``query_wire="bf16"`` reranks against the bf16-rounded
    query; ``"i8"`` against the dequantized codes ``codes / scale +
    center``, as the JAX engine's 1 B/dim wire does.

``topk_mode`` picks the kernel: ``"count"`` (count-then-insert, the
default) or ``"fixed"`` (k passes per corpus tile); same results.

Under a profiler each call is one ``expann.engine.query`` span holding the
host's cast (``expann.engine.cast``), each chunk's upload
(``expann.engine.upload``) and scan (``expann.search.traverse``), the
``fused_i8`` rerank (``expann.search.rerank``) and the download
(``expann.engine.download``), as in the graph engine.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from expann_tpu_torch.models.base import Engine, ParamList, _concat_pending
from expann_tpu_torch.ops.distance import pad_dim, pairwise_dist2, squared_norms
from expann_tpu_torch.ops.topk import MODES, flat_topk, flat_topk_prepare, quantize_corpus_i8, quantize_query_i8
from expann_tpu_torch.utils.profiling import annotate


def exact_topk(q: torch.Tensor, x: torch.Tensor, x_norms: torch.Tensor, k: int):
    """Exact k nearest rows of ``x`` per query, ordered by (d, id):
    returns ``(ids, d)``.  A stable sort keeps the lower id first on ties
    (``torch.topk`` does not)."""
    d2 = pairwise_dist2(q, x, x_norms=x_norms)
    d_s, idx = torch.sort(d2, dim=1, stable=True)
    # copies: a view would keep the whole (B, N) sort alive in the caller
    return idx[:, :k].clone(), d_s[:, :k].clone()


def rerank_exact(q: torch.Tensor, x: torch.Tensor, x_norms: torch.Tensor, cand_ids: torch.Tensor, k: int):
    """Exact f32 rerank of per-query candidate ids ``(B, m)`` against the
    f32 query ``q``: ``(ids, d)`` ``(B, k)``, ascending, equal distances in
    candidate order (brute_force.py:30-48).  Ids outside ``[0, n)`` (the
    scan's -1 slots) score +inf; a bf16 ``x`` is scored in f32."""
    n = x.shape[0]
    safe = torch.clamp(cand_ids, 0, n - 1).long()
    cn = torch.where((cand_ids >= 0) & (cand_ids < n), x_norms[safe], float("inf"))
    qn = torch.sum(q * q, dim=1, keepdim=True)
    d2 = qn + cn - 2.0 * torch.einsum("bd,bmd->bm", q, x[safe].float())
    d2, order = torch.sort(d2, dim=1, stable=True)
    return cand_ids.gather(1, order)[:, :k], d2[:, :k]


def rerank_dequant(qk, center, inv_scale, x, x_norms, cand_ids, k: int):
    """``rerank_exact`` against the dequantized int8 query ``qk * inv_scale
    + center`` (the i8 query wire, brute_force.py:51-60)."""
    return rerank_exact(qk.float() * inv_scale + center[None, :], x, x_norms, cand_ids, k)


class BruteForceEngine(Engine):
    """Nearest neighbours over a corpus held on ``device`` (the card by
    default; ``device="cpu"`` runs the plain versions)."""

    def __init__(
        self,
        batch_size: int = 1024,
        precision: str = "highest",
        mode: str = "exact",
        rerank_mult: int = 3,
        rerank_store: str = "f32",
        topk_mode: str = "count",
        query_wire: str = "bf16",
        *,
        device="cuda",
    ):
        for knob, value, allowed in (
            ("mode", mode, ("exact", "fused", "fused_i8")),
            ("rerank_store", rerank_store, ("f32", "bf16")),
            ("topk_mode", topk_mode, MODES),
            ("query_wire", query_wire, ("bf16", "i8")),
        ):
            if value not in allowed:
                raise ValueError(f"{knob}={value!r}: one of {allowed}")
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
        self.rerank_mult = rerank_mult
        self.rerank_store = rerank_store
        self.query_wire = query_wire
        self._i8_center = None  # host (D,) f32
        self._i8_scale = 1.0
        self._i8_center_dev = None
        self._i8_inv_scale = None

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
            elif self.mode == "fused_i8":
                self._x_fused, self._i8_center, self._i8_scale, _ = quantize_corpus_i8(x, self.device)
                self._i8_center_dev = torch.from_numpy(self._i8_center).to(self.device)
                self._i8_inv_scale = torch.tensor(1.0 / self._i8_scale, dtype=torch.float32, device=self.device)
                if self.rerank_store == "bf16":
                    # norms from the host f32 copy: uploading it only to
                    # square it would double the device bytes for a moment
                    self._x = torch.from_numpy(x).to(self.device, torch.bfloat16)
                    self._x_norms = torch.from_numpy((x * x).sum(axis=1)).to(self.device)
                else:
                    self._x = torch.from_numpy(x).to(self.device)
                    self._x_norms = squared_norms(self._x)
            else:
                self._x = torch.from_numpy(x).to(self.device)
                self._x_norms = squared_norms(self._x)

    def _width(self) -> int:
        return (self._x if self._x is not None else self._x_fused).shape[-1]

    def _query_fused_i8(self, q: np.ndarray, k: int, bs: int) -> List[torch.Tensor]:
        """The s8 scan for ``min(rerank_mult * k, 128)`` candidates, then the
        exact rerank (brute_force.py:187-266)."""
        scan_k = min(self.rerank_mult * k, 128)
        out = []
        for start in range(0, q.shape[0], bs):
            chunk = q[start : start + bs]
            with annotate("expann.engine.cast"):
                qk = torch.from_numpy(quantize_query_i8(chunk, self._i8_center, self._i8_scale))
            with annotate("expann.engine.upload"):
                qk = qk.to(self.device)
            with annotate("expann.search.traverse"):
                cand, _ = flat_topk(qk, self._x_fused, scan_k, mode=self.topk_mode)
            if self.query_wire == "i8":
                with annotate("expann.search.rerank"):
                    ids, _ = rerank_dequant(qk, self._i8_center_dev, self._i8_inv_scale, self._x, self._x_norms,
                                            cand, k)
            else:
                # the host casts the bf16 query while the card scans
                with annotate("expann.engine.cast"):
                    qd = torch.from_numpy(chunk).to(torch.bfloat16)
                with annotate("expann.engine.upload"):
                    qd = qd.to(self.device)
                with annotate("expann.search.rerank"):
                    ids, _ = rerank_exact(qd.float(), self._x, self._x_norms, cand, k)
            out.append(ids)
        return out

    def query_k_batch(self, queries: np.ndarray, k: int) -> np.ndarray:
        if self._x is None and self._x_fused is None:
            raise RuntimeError("build() must be called before queries")
        with annotate("expann.engine.query"):
            return self._query(queries, k)

    def _query(self, queries: np.ndarray, k: int) -> np.ndarray:
        with annotate("expann.engine.cast"):
            q = np.asarray(queries, dtype=np.float32)
            if q.ndim != 2:
                raise ValueError("queries must be 2D")
            width = self._width()
            q = pad_dim(q, width)
            if q.shape[-1] != width:
                raise ValueError("query dim exceeds corpus dim")
        out = []
        bs = max(self.batch_size, min(q.shape[0], 16384))
        if self.mode == "fused_i8":
            out = self._query_fused_i8(q, k, bs)
        elif self.mode == "fused":
            # queries travel as bf16: the kernel rounds them to the corpus
            # dtype anyway, and it halves the host-to-device bytes
            for start in range(0, q.shape[0], bs):
                with annotate("expann.engine.cast"):
                    chunk = torch.from_numpy(q[start : start + bs]).to(torch.bfloat16)
                with annotate("expann.engine.upload"):
                    chunk = chunk.to(self.device)
                with annotate("expann.search.traverse"):
                    ids, _ = flat_topk(chunk, self._x_fused, k, mode=self.topk_mode)
                out.append(ids)
        else:
            for start in range(0, q.shape[0], self.batch_size):
                with annotate("expann.engine.upload"):
                    chunk = torch.from_numpy(q[start : start + self.batch_size]).to(self.device)
                with annotate("expann.search.traverse"):
                    ids, _ = exact_topk(chunk, self._x, self._x_norms, k)
                out.append(ids)
        with annotate("expann.engine.download"):
            return torch.cat(out).cpu().numpy()
