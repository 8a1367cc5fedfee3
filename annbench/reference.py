"""The plain reference: exact k nearest neighbours under squared L2, in
float32 with TF32 off, in plain PyTorch.  It imports nothing of the
program and takes nothing the program made: the benchmark hands it the
corpus and the queries it drew itself.

``exact_topk`` scans in blocks of queries: a float32 matmul expansion picks
``k + EXTRA`` candidates a query, whose distances are then computed
directly as ``sum((q - x)^2)`` and ordered by (distance, id).  The extra
candidates absorb the expansion's rounding, so the k kept are the exact
ones.

``lowprec_topk`` is the control: the same search with every score computed
in a lower precision than the configuration states (``fp8``: both sides
rounded to float8 e4m3 and multiplied with float32 accumulation, as the
tensor cores do; ``int4``: centred codes in [-8, 7] on one scale), ordered
by those scores.  The benchmark's own runs never call it.
"""

from __future__ import annotations

import torch

EXTRA = 32
BLOCK_ELEMS = 1 << 30  # query block x corpus rows held at once (4 GiB of f32)


def _f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _blocks(q: torch.Tensor, n: int):
    step = max(1, BLOCK_ELEMS // max(n, 1))
    for s in range(0, q.shape[0], step):
        yield s, q[s : s + step]


def dist_of(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances ``(Q, k)`` of each query to the rows ``ids``
    ``(Q, k)`` names, computed directly in float32.  Ids outside
    ``[0, n)`` get +inf."""
    _f32()
    n = x.shape[0]
    valid = (ids >= 0) & (ids < n)
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    out = torch.empty(ids.shape, dtype=torch.float32, device=x.device)
    step = max(1, (1 << 26) // max(ids.shape[1] * x.shape[1], 1))
    for s in range(0, ids.shape[0], step):
        diff = q[s : s + step, None, :] - x[safe[s : s + step]]
        out[s : s + step] = (diff * diff).sum(-1)
    return torch.where(valid, out, torch.full_like(out, float("inf")))


def _order(cand: torch.Tensor, d: torch.Tensor, k: int):
    """The first k of each row of ``cand`` by (d, id)."""
    by_id = torch.argsort(cand, dim=1)
    cand, d = cand.gather(1, by_id), d.gather(1, by_id)
    by_d = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return cand.gather(1, by_d), d.gather(1, by_d)


def exact_topk(x: torch.Tensor, q: torch.Tensor, k: int):
    """``(ids int64 (Q, k), d float32 (Q, k))``: the exact k nearest rows of
    ``x`` to each query, ordered by (distance, id)."""
    _f32()
    n = x.shape[0]
    xn = (x * x).sum(1)
    ids_out, d_out = [], []
    for _, qb in _blocks(q, n):
        d2 = (qb * qb).sum(1, keepdim=True) + xn[None, :] - 2.0 * (qb @ x.T)
        cand = torch.topk(d2, min(k + EXTRA, n), dim=1, largest=False).indices
        del d2
        ids, d = _order(cand, dist_of(x, qb, cand), k)
        ids_out.append(ids)
        d_out.append(d)
    return torch.cat(ids_out), torch.cat(d_out)


def _lowprec(x: torch.Tensor, q: torch.Tensor, prec: str):
    if prec == "fp8":
        f8 = torch.float8_e4m3fn
        return x.to(f8).float(), q.to(f8).float()
    if prec == "int4":
        center = x.mean(0)
        scale = float((x - center).abs().max()) / 7.0 or 1.0

        def code(v):
            return torch.clamp(torch.round((v - center) / scale), -8, 7)

        return code(x), code(q)
    raise ValueError(f"unknown control precision {prec!r}")


def lowprec_topk(x: torch.Tensor, q: torch.Tensor, k: int, prec: str) -> torch.Tensor:
    """The control's ids ``(Q, k)``: exact k-NN with every score in ``prec``,
    ordered by those scores (ties by id)."""
    _f32()
    xl, ql = _lowprec(x, q, prec)
    xn = (xl * xl).sum(1)
    out = []
    for _, qb in _blocks(ql, xl.shape[0]):
        d2 = (qb * qb).sum(1, keepdim=True) + xn[None, :] - 2.0 * (qb @ xl.T)
        cand = torch.topk(d2, min(k + EXTRA, xl.shape[0]), dim=1, largest=False).indices
        out.append(_order(cand, d2.gather(1, cand), k)[0])
    return torch.cat(out)
