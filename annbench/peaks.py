"""Peaks of the card and the flat scan's least time.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).  A share of a roofline is
stated against them, with the card's power limit printed beside it.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12


def flat_bound_s(b: int, n: int, d: int, k: int) -> float:
    """Least seconds for one flat k-NN scan of ``b`` bf16 queries over an
    ``(n, d)`` bf16 corpus: the larger of its operations (2 b n d) at the
    bf16 tensor peak and its bytes at HBM's rate, each byte counted once:
    the corpus (2 n d), its f32 norms (4 n), the queries (2 b d) and the
    output ids and distances (4 + 4 bytes, b k of each)."""
    ops = 2.0 * b * n * d
    nbytes = 2.0 * n * d + 4.0 * n + 2.0 * b * d + 8.0 * b * k
    return max(ops / BF16_FLOPS, nbytes / HBM_BYTES_S)
