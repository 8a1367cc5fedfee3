"""Fused bottom-layer beam search (counterpart of
expann_tpu/ops/pallas_fused.py ``fused_search``, merge ``"topt"``).

The whole traversal of one query runs in one kernel launch
(``csrc/fused_search.cu``: ``fused_search_kernel`` over bf16 blocks,
``fused_search_s8_kernel`` over s8 code blocks); ``fused_search_plain`` is
the same function in plain PyTorch, batched over queries, and runs on CPU
tensors.  ``fused_search_rows`` (``fused_search_rows_kernel``, K1-rows, and
``fused_search_rows_plain``) is the same traversal over the bf16 corpus
rows, each neighbour's row read by its id from the layout's id rows
(``ops/packed.build_rows``), for an index whose packed blocks do not fit
the card: over the same graph it returns the same beams as K1, and counts
the non-sentinel rows it scores instead of RS a node.

Semantics, per query: the beam holds EF (distance, id) entries, the first
``ef`` of them live.  Each iteration selects the ``expand`` best unexpanded
live entries by (d, lane) and marks them expanded; the query stops when
the best one is worse than the live worst or nothing finite is left
(src/antitopo_engine.h:588-590), or after ``max_iters`` iterations.  Each
selected node's packed block is scored as
``(|x|^2 + |q|^2) - 2 bf16(q).x`` (f32 sums, clamped at 0); on int8
blocks the query is in code space (integer-valued f32, ``build_packed_i8``'s
transform), ``q.x`` is taken on its int8 cast and every distance is an
exact integer, so kernel and plain version agree bit for bit; per node in
selection order its best ``TOPT = ceil(cand / expand)`` by (d, row) are
offered in ascending order, skipping ids already in the beam (checked
against the beam as it stands when that node's turn starts), each
replacing the live worst (d, lane) if strictly smaller.

Differences from the TPU kernel: distances and lanes are compared as
(d, lane) pairs, not as f32 keys whose low mantissa bits hold the lane
(the TPU results differ only on near-ties within a 2^-15 relative band);
the expanded flag is a separate array, not ``~id``; termination is per
query instead of per tile (a finished query in a TPU tile is inert, so
the results agree); any batch size and beam width are accepted, and the
iteration count is returned per query.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from expann_tpu_torch.ops import _kernels

FINTH = 1.0e38  # "finite": real distances are far below
INF = float("inf")
MAX_RS = 256  # rows per packed block the kernel supports


def topt_for(cand: int, expand: int, rs: int) -> int:
    """Candidates kept per expanded node per iteration."""
    e = max(1, expand)
    return max(1, min((cand + e - 1) // e, rs))


def ring_for(kind: int, B: int, D: int, RS: int, Rt: int, EF: int, expand: int) -> Tuple[int, int, int]:
    """The shared-memory ring of kernel ``kind`` (0 K1, 1 K1-s8, 2 K1-rows)
    for a launch of B queries on the current CUDA device: ``(slots, bytes a
    slot, resident queries an SM)``.  A batch that fits the card's resident slots
    with a deeper ring gets it (the iteration's blocks all in flight at B <=
    132 on an H100, two 16 KB slots up to ~660 bf16 queries); a larger one
    the default, one 8 KB slot, 16 queries an SM at D = 128."""
    out = [ctypes.c_int(0) for _ in range(3)]
    code = _kernels.library().expann_fused_search_ring(
        int(kind), B, D, RS, Rt, EF, max(1, expand), *(ctypes.byref(v) for v in out))
    _kernels.check(code, "fused_search ring")
    return out[0].value, out[1].value, out[2].value


def fused_search_plain(
    packed: torch.Tensor,
    packed_norms: torch.Tensor,
    packed_ids: torch.Tensor,
    q: torch.Tensor,
    beam_d0: torch.Tensor,
    beam_ids0: torch.Tensor,
    ef: int,
    expand: int,
    topt: int,
    max_iters: int,
    expanded: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused traversal, batched over queries.
    ``expanded``, an (N+1,) bool tensor, gets every node that some query
    expands set to True (the blocks the call reads); the results are the
    same with or without it."""
    RS = packed.shape[1]
    sentinel = packed.shape[0] - 1
    return _traverse_plain(
        lambda s: packed[s], lambda sel: RS * (sel != sentinel).sum(dim=1, dtype=torch.int32), packed.dtype, RS,
        sentinel, packed_norms, packed_ids, q, beam_d0, beam_ids0, ef, expand, topt, max_iters, expanded,
    )


def fused_search_rows_plain(
    rows: torch.Tensor,
    packed_norms: torch.Tensor,
    packed_ids: torch.Tensor,
    rs: int,
    q: torch.Tensor,
    beam_d0: torch.Tensor,
    beam_ids0: torch.Tensor,
    ef: int,
    expand: int,
    topt: int,
    max_iters: int,
    expanded: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1-rows: ``fused_search_plain`` with each
    selected node's first ``rs`` neighbours gathered from ``rows`` by their
    ids, and ``ncomp`` counting the non-sentinel ones."""
    sentinel = rows.shape[0] - 1
    ids = packed_ids[:, :rs]
    return _traverse_plain(
        lambda s: rows[ids[s].long()], lambda sel: (ids[sel.long()] != sentinel).sum(dim=(1, 2), dtype=torch.int32),
        rows.dtype, rs, sentinel, packed_norms, packed_ids, q, beam_d0, beam_ids0, ef, expand, topt, max_iters,
        expanded,
    )


def _traverse_plain(
    blocks: Callable,
    counts: Callable,
    dtype: torch.dtype,
    RS: int,
    sentinel: int,
    packed_norms: torch.Tensor,
    packed_ids: torch.Tensor,
    q: torch.Tensor,
    beam_d0: torch.Tensor,
    beam_ids0: torch.Tensor,
    ef: int,
    expand: int,
    topt: int,
    max_iters: int,
    expanded: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The traversal of both plain versions: ``blocks(sel)`` gives the
    ``(B, E, RS, D)`` neighbour rows of the selected nodes and
    ``counts(sel)`` the ``(B,)`` distance computations they cost."""
    B, EF = beam_d0.shape
    dev = q.device
    E = max(1, expand)
    q = q.float()
    qn = torch.sum(q * q, dim=1)
    qc = q.to(dtype).float()
    lane = torch.arange(EF, device=dev)
    live = lane < ef
    rows = torch.arange(B, device=dev)
    bd = torch.clamp_min(beam_d0.float(), 0.0)
    bi = beam_ids0.to(torch.int32).clone()
    bx = torch.zeros((B, EF), dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    ncomp = torch.zeros(B, dtype=torch.int32, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)

    def live_worst():
        dl = torch.where(live, bd, -INF)
        wd = dl.max(dim=1).values
        wl = torch.where(dl == wd[:, None], lane, -1).max(dim=1).values
        return wd, wl

    for _ in range(max_iters):
        act = ~done
        if not bool(act.any()):
            break
        iters += act.to(torch.int32)
        wd, _ = live_worst()
        masked = torch.where(bx | ~live, INF, bd)
        sel = torch.full((B, E), sentinel, dtype=torch.int32, device=dev)
        for e in range(E):
            ml = torch.argmin(masked, dim=1)  # first minimum: (d, lane) order
            md = masked[rows, ml]
            fin = md < FINTH
            if e == 0:
                done |= act & ((md > wd) | ~fin)
            ok = fin & ~done
            sel[:, e] = torch.where(ok, bi[rows, ml], sentinel)
            bx[rows[ok], ml[ok]] = True
            masked[rows, ml] = INF
        ncomp += counts(sel)
        if expanded is not None:
            expanded[sel[sel != sentinel].long()] = True
        if bool(done.all()):
            break

        s = sel.long()
        dots = torch.einsum("bd,berd->ber", qc, blocks(s).float())
        d = torch.clamp_min((packed_norms[s, :RS] + qn[:, None, None]) - 2.0 * dots, 0.0)
        ids = packed_ids[s, :RS]
        for e in range(E):
            order = torch.sort(d[:, e], dim=1, stable=True).indices[:, :topt]
            cd = d[:, e].gather(1, order)
            ci = ids[:, e].gather(1, order)
            dup = ((bi[:, None, :] == ci[:, :, None]) & (ci[:, :, None] != sentinel)).any(-1)
            for t in range(topt):
                wd, wl = live_worst()
                repl = ~dup[:, t] & ~done & (cd[:, t] < wd)
                r, w = rows[repl], wl[repl]
                bd[r, w] = cd[repl, t]
                bi[r, w] = ci[repl, t]
                bx[r, w] = False
    out_d = torch.where(live, bd, INF)
    out_i = torch.where(live, bi, sentinel)
    return out_i, out_d, ncomp, iters


def fused_search_cuda(
    packed: torch.Tensor,
    packed_norms: torch.Tensor,
    packed_ids: torch.Tensor,
    q: torch.Tensor,
    beam_d0: torch.Tensor,
    beam_ids0: torch.Tensor,
    ef: int,
    expand: int,
    topt: int,
    max_iters: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the fused traversal kernel (``csrc/fused_search.cu``): K1 on
    bf16 blocks, K1-s8 on int8 blocks, with the shared-memory ring the
    launcher chooses from B (``ring_for``)."""
    s8 = packed.dtype == torch.int8
    name = "fused_search_s8" if s8 else "fused_search"
    n1, RS, D = packed.shape
    return _launch(f"expann_{name}" if s8 else f"expann_{name}_bf16", name, packed, torch.int8 if s8 else torch.bfloat16,
                   16 if s8 else 8, n1, RS, D, packed_norms, packed_ids, q, beam_d0, beam_ids0, ef, expand, topt,
                   max_iters)


def _launch(
    fn: str,
    name: str,
    src: torch.Tensor,
    src_dtype: torch.dtype,
    d_align: int,
    n1: int,
    RS: int,
    D: int,
    packed_norms: torch.Tensor,
    packed_ids: torch.Tensor,
    q: torch.Tensor,
    beam_d0: torch.Tensor,
    beam_ids0: torch.Tensor,
    ef: int,
    expand: int,
    topt: int,
    max_iters: int,
    *extra: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check the operands of a traversal kernel, launch the library's
    ``fn`` over ``src`` (blocks or rows) and count it under ``name``."""
    device = src.device
    q = q.float().contiguous()
    for t, what, dtype in (
        (src, "packed" if src.dim() == 3 else "rows", src_dtype),
        (packed_norms, "packed_norms", torch.float32),
        (packed_ids, "packed_ids", torch.int32),
        (q, "q", torch.float32),
        (beam_d0, "beam_d0", torch.float32),
        (beam_ids0, "beam_ids0", torch.int32),
    ):
        _kernels.require_cuda(t, what, dtype, device)
    Rt = packed_norms.shape[1]
    B, EF = beam_d0.shape
    if packed_norms.shape != (n1, Rt) or packed_ids.shape != (n1, Rt) or Rt < RS or Rt % 4:
        raise ValueError("packed_norms / packed_ids must be (N+1, R_tile) with R_tile >= RS, a multiple of 4")
    if q.shape != (B, D) or beam_ids0.shape != (B, EF):
        raise ValueError(f"q {tuple(q.shape)} / beam {tuple(beam_ids0.shape)} do not match ({B}, {D}) / ({B}, {EF})")
    if D % d_align or RS % 16 or RS > MAX_RS or not 1 <= ef <= EF or not 1 <= topt <= RS:
        raise ValueError(f"unsupported shape: D={D} RS={RS} ef={ef} EF={EF} topt={topt}")
    obi = torch.empty((B, EF), dtype=torch.int32, device=device)
    obd = torch.empty((B, EF), dtype=torch.float32, device=device)
    ncomp = torch.empty((B,), dtype=torch.int32, device=device)
    iters = torch.empty((B,), dtype=torch.int32, device=device)
    if B == 0:
        return obi, obd, ncomp, iters
    with torch.cuda.device(device):  # the launcher sets its shared memory on the current device
        code = getattr(_kernels.library(), fn)(
            src.data_ptr(), packed_norms.data_ptr(), packed_ids.data_ptr(), q.data_ptr(),
            beam_d0.data_ptr(), beam_ids0.data_ptr(), obi.data_ptr(), obd.data_ptr(),
            ncomp.data_ptr(), iters.data_ptr(),
            B, D, RS, Rt, EF, int(ef), int(max_iters), max(1, expand), int(topt), n1 - 1, *extra,
            _kernels.stream_ptr(device),
        )
    _kernels.check(code, name)
    _kernels.launches[name] += 1
    return obi, obd, ncomp, iters


def fused_search(
    packed: torch.Tensor,  # (N+1, RS, D) bf16 or int8 (f32 accepted on CPU)
    packed_norms: torch.Tensor,  # (N+1, R_tile) f32, +inf at pad slots
    packed_ids: torch.Tensor,  # (N+1, R_tile) int32
    q: torch.Tensor,  # (B, D) f32; code space for int8 blocks
    beam_d0: torch.Tensor,  # (B, EF) f32, +inf padding
    beam_ids0: torch.Tensor,  # (B, EF) int32, sentinel padding
    ef: int,
    expand: int = 2,
    cand: int = 32,
    max_iters: int = 0,  # <= 0 means 8 * ef + 16
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the whole bottom-layer beam search.  Returns
    ``(beam_ids, beam_d, ncomp, iters)``: unsorted beams ``(B, EF)`` (lanes
    >= ef carry +inf / the sentinel), per-query distance-computation counts
    and per-query iteration counts.  Callers rerank the beam in exact f32
    (models/search.py does).  The kernel on CUDA tensors, the plain version
    on CPU tensors."""
    topt = topt_for(cand, expand, packed.shape[1])
    if max_iters <= 0:
        max_iters = 8 * int(ef) + 16
    if packed.is_cuda:
        return fused_search_cuda(
            packed, packed_norms, packed_ids, q, beam_d0, beam_ids0, ef, expand, topt, max_iters
        )
    if packed.device.type != "cpu":
        raise ValueError(f"fused_search runs on CUDA or CPU tensors, not {packed.device}")
    return fused_search_plain(
        packed, packed_norms, packed_ids, q, beam_d0, beam_ids0, ef, expand, topt, max_iters
    )


def fused_search_rows_cuda(
    rows: torch.Tensor,
    packed_norms: torch.Tensor,
    packed_ids: torch.Tensor,
    rs: int,
    q: torch.Tensor,
    beam_d0: torch.Tensor,
    beam_ids0: torch.Tensor,
    ef: int,
    expand: int,
    topt: int,
    max_iters: int,
    stall: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K1-rows (``csrc/fused_search.cu``) over the bf16 corpus
    ``rows``, with the ring the launcher chooses from B (``ring_for(2,
    ...)``).  ``stall`` (bytes, a multiple of 16) tests the copy
    timeout: the first wait for the id rows then never completes, and the
    kernel traps after 2 s."""
    n1, D = rows.shape
    return _launch("expann_fused_search_rows_bf16", "fused_search_rows", rows, torch.bfloat16, 8, n1, int(rs), D,
                   packed_norms, packed_ids, q, beam_d0, beam_ids0, ef, expand, topt, max_iters, int(stall))


def fused_search_rows(
    rows: torch.Tensor,  # (N+1, D) bf16 corpus, zero sentinel row N (f32 accepted on CPU)
    packed_norms: torch.Tensor,  # (N+1, R_tile) f32, +inf at pad slots
    packed_ids: torch.Tensor,  # (N+1, R_tile) int32
    rs: int,  # id slots scored a node: RS of the blocks the layout stands in for
    q: torch.Tensor,  # (B, D) f32
    beam_d0: torch.Tensor,  # (B, EF) f32, +inf padding
    beam_ids0: torch.Tensor,  # (B, EF) int32, sentinel padding
    ef: int,
    expand: int = 2,
    cand: int = 32,
    max_iters: int = 0,  # <= 0 means 8 * ef + 16
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``fused_search`` over the corpus rows and the layout's id rows
    (``ops/packed.build_rows``) instead of packed blocks: the same
    ``(beam_ids, beam_d, ncomp, iters)``, with ``ncomp`` the non-sentinel
    rows scored.  K1-rows on CUDA tensors, the plain version on CPU
    tensors."""
    topt = topt_for(cand, expand, rs)
    if max_iters <= 0:
        max_iters = 8 * int(ef) + 16
    if rows.is_cuda:
        return fused_search_rows_cuda(
            rows, packed_norms, packed_ids, rs, q, beam_d0, beam_ids0, ef, expand, topt, max_iters
        )
    if rows.device.type != "cpu":
        raise ValueError(f"fused_search_rows runs on CUDA or CPU tensors, not {rows.device}")
    return fused_search_rows_plain(
        rows, packed_norms, packed_ids, rs, q, beam_d0, beam_ids0, ef, expand, topt, max_iters
    )
