"""The comparison that decides ``correct``, and the recall arithmetic.

Every id list a run returned is judged against the plain reference
(``reference.py``) on the same corpus and queries, by three numbers:

* ``miss_at_10``: 1 - recall@k, the share of the reference's k nearest ids
  missing from the returned lists (k = 10 in every configuration here);
* ``order_gap``: the widest step by which a returned list runs backwards,
  ``(d[j] - d[j+1]) / d[j]`` over adjacent positions, with ``d`` the
  reference's float32 distances of the returned ids (0 when every list is
  in order).  An exact rerank leaves only rounding here; a lower precision,
  or an answer altered after the rerank, leaves more;
* ``bad_ids``: ids outside ``[0, n)`` or repeated within their list, and
  lists of the wrong shape (counted as k bad ids): an exact count, limit 0.

A list that several calls returned identically is judged once and counted
as often as it came back.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from annbench import reference

NAMES = ("miss_at_10", "order_gap", "bad_ids")


def recall(ids: torch.Tensor, gt: torch.Tensor) -> Tuple[int, int]:
    """``(hits, slots)``: how many of the reference's ids ``gt`` (Q, k) are
    in the returned lists ``ids`` (Q, k'), and Q * k."""
    hits = (ids[:, :, None] == gt[:, None, :]).any(1).sum()
    return int(hits), gt.numel()


def bad_count(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Per row, the ids outside ``[0, n)`` or repeated earlier in the row."""
    invalid = (ids < 0) | (ids >= n)
    srt = torch.sort(ids, dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0) & (srt[:, 1:] < n)
    return invalid.sum(1) + dup.sum(1)


def order_gap(d: torch.Tensor) -> float:
    """The widest relative backward step of rows of distances ``d`` (Q, k);
    rows with an infinite distance are left out (their ids are bad)."""
    if d.shape[1] < 2:
        return 0.0
    ok = torch.isfinite(d).all(1)
    d = d[ok]
    if d.numel() == 0:
        return 0.0
    head = d[:, :-1]
    step = torch.where(head > 0, (head - d[:, 1:]) / head, torch.zeros_like(head))
    return max(float(step.max()), 0.0)


def unique_lists(outs: Iterable[Tuple[int, np.ndarray]]) -> List[Tuple[int, np.ndarray, int]]:
    """``[(slot, ids, count)]``: the distinct arrays returned for each slot
    of the pool, with how often each came back."""
    seen: Dict[int, List[list]] = {}
    for slot, ids in outs:
        for entry in seen.setdefault(slot, []):
            if entry[0].shape == ids.shape and np.array_equal(entry[0], ids):
                entry[1] += 1
                break
        else:
            seen[slot].append([ids, 1])
    return [(slot, ids, c) for slot, lst in seen.items() for ids, c in lst]


def judge(outs, x: torch.Tensor, pool: torch.Tensor, gt: torch.Tensor, batch: int, k: int) -> dict:
    """The three numbers over every list of ``outs`` (``(slot, ids)`` pairs:
    the rows ``[slot * batch, slot * batch + len(ids))`` of ``pool``), and
    ``bad_rows``, the lists that hold a bad id (the run's failed queries)."""
    n = x.shape[0]
    hits = slots = bad = bad_rows = 0
    gap = 0.0
    for slot, ids_np, count in unique_lists(outs):
        lo = slot * batch
        rows = ids_np.shape[0] if ids_np.ndim == 2 else 0
        want = gt[lo : lo + batch]
        if ids_np.ndim != 2 or rows != want.shape[0] or ids_np.shape[1] != k:
            bad += count * want.shape[0] * k
            bad_rows += count * want.shape[0]
            slots += count * want.numel()
            continue
        ids = torch.from_numpy(np.ascontiguousarray(ids_np, dtype=np.int64)).to(x.device)
        h, s = recall(ids, want)
        hits += count * h
        slots += count * s
        per_row = bad_count(ids, n)
        bad += count * int(per_row.sum())
        bad_rows += count * int((per_row > 0).sum())
        gap = max(gap, order_gap(reference.dist_of(x, pool[lo : lo + rows], ids)))
    return {"miss_at_10": 1.0 - hits / max(slots, 1), "order_gap": gap, "bad_ids": bad, "bad_rows": bad_rows}


def passes(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (a missing number fails)."""
    return all(numbers.get(name, float("inf")) <= limits[name] for name in NAMES)


def lines(numbers: dict, limits: dict) -> List[str]:
    """One line a number: its name, its value and its limit."""
    return [f"check {name} {numbers[name]!r} limit {limits[name]!r}" for name in NAMES]
