"""Entry seeds of the fused route: the S nearest entry members of each
query, by (distance, member position).

``entry_select`` takes the entry scan's raw product ``G = qk @ x[mem].T``
(B, n), the members' norms ``xn`` (n,) (the sentinel tail at +inf), the
queries' norms ``qn`` (B,) and the members' ids, forms
``d = (xn + qn) - 2 G`` in f32 and writes the S smallest by (d, position)
into the seed beams ``bd0[:, :S]`` / ``bi0[:, :S]`` (distances, member
ids): the order of a stable sort, in which equal distances keep member
order, as the JAX package's ``approx_max_k`` does off the TPU
(expann_tpu/models/search.py:574).  On a CUDA tensor it launches K5
(``csrc/entry_select.cu``), which reads G once and keeps the S in
registers, with the same f32 operations, so its seeds are bit-identical
to the plain version's; on a CPU tensor it runs ``entry_select_plain``,
the elementwise passes and the full stable sort.
"""

from __future__ import annotations

from typing import Tuple

import torch

from expann_tpu_torch.ops import _kernels

S_MAX = 32  # the most seeds K5 keeps (csrc/entry_select.cu, S_MAX)


def entry_select_plain(
    G: torch.Tensor, xn: torch.Tensor, qn: torch.Tensor, members: torch.Tensor, S: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(seed_d, seed_ids)`` ``(B, S)``, the whole
    distance matrix sorted stably per row."""
    md = (xn[None, :] + qn[:, None]) - 2.0 * G
    seed_d, idx = torch.sort(md, dim=1, stable=True)
    return seed_d[:, :S], members[idx[:, :S]]


def _check(G, xn, qn, members, S, bd0, bi0) -> None:
    """The contract both routes take: f32 operands of matching shapes on
    one device, a contiguous G, 1 <= S <= min(n, S_MAX), beams of at least
    S columns."""
    device = G.device
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"entry_select runs on CUDA or CPU tensors, not {device}")
    for t, name, dtype in ((G, "G", torch.float32), (xn, "xn", torch.float32), (qn, "qn", torch.float32),
                           (members, "members", torch.int32), (bd0, "bd0", torch.float32),
                           (bi0, "bi0", torch.int32)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not G.is_contiguous():
        raise ValueError("G must be contiguous")
    if G.dim() != 2:
        raise ValueError(f"G must be (B, n), not {tuple(G.shape)}")
    B, n = G.shape
    if xn.shape != (n,) or members.shape != (n,) or qn.shape != (B,):
        raise ValueError(f"xn / members must be ({n},) and qn ({B},): {tuple(xn.shape)}, {tuple(members.shape)}, "
                         f"{tuple(qn.shape)}")
    if not 1 <= S <= min(n, S_MAX):
        raise ValueError(f"S={S} outside 1..min(n={n}, {S_MAX})")
    if bd0.dim() != 2 or bd0.shape[0] != B or bd0.shape[1] < S or bi0.shape != bd0.shape:
        raise ValueError(f"bd0 / bi0 must be ({B}, >= {S}): {tuple(bd0.shape)}, {tuple(bi0.shape)}")


def entry_select_cuda(G, xn, qn, members, S: int, bd0: torch.Tensor, bi0: torch.Tensor) -> None:
    """Launch K5 on CUDA tensors, writing the seeds into ``bd0`` / ``bi0``
    (every operand contiguous and 16-byte aligned)."""
    _check(G, xn, qn, members, S, bd0, bi0)
    device = G.device
    for t, name, dtype in ((G, "G", torch.float32), (xn, "xn", torch.float32), (qn, "qn", torch.float32),
                           (members, "members", torch.int32), (bd0, "bd0", torch.float32),
                           (bi0, "bi0", torch.int32)):
        _kernels.require_cuda(t, name, dtype, device)
    B, n = G.shape
    with torch.cuda.device(device):
        code = _kernels.library().expann_entry_select(
            G.data_ptr(), xn.data_ptr(), qn.data_ptr(), members.data_ptr(), B, n, S, bd0.data_ptr(),
            bi0.data_ptr(), bd0.stride(0), _kernels.stream_ptr(device),
        )
    _kernels.check(code, "entry_select")
    _kernels.launches["entry_select"] += 1


def entry_select(G, xn, qn, members, S: int, bd0: torch.Tensor, bi0: torch.Tensor) -> None:
    """The S nearest members of each query into ``bd0[:, :S]`` (distances)
    and ``bi0[:, :S]`` (member ids): K5 on CUDA tensors, the plain version
    on CPU tensors."""
    if G.is_cuda:
        entry_select_cuda(G, xn, qn, members, S, bd0, bi0)
        return
    _check(G, xn, qn, members, S, bd0, bi0)
    bd0[:, :S], bi0[:, :S] = entry_select_plain(G, xn, qn, members, S)
