"""Scalar quantization of the corpus to uint8 codes (counterpart of
expann_tpu/ops/quantize.py; reference: src/quantizer.h).

  * ``quantize_simple``: the reference's live path, a cast to uint8 after a
    clip to [0, 255] (the cast truncates; ``quantizer_simple<uint8_t>``,
    src/quantizer.h:132-141).  Sane on SIFT-like data, whose components are
    small non-negative integers; Gaussian data loses its negatives.
  * ``quantize_ranged``: the min/max affine variant the reference defines
    but never instantiates (``quantizer_ranged_q8``, src/quantizer.h:186-238):
    ``round(x * scale + offset)`` (half to even) clipped to [0, 255].

Both quantize the padded ``(N + 1, D_pad)`` corpus, dummy row included,
and give that row a +inf norm, so sentinel neighbours mask themselves in
the compressed beam (models/search.py ``query_batch(compressed=True)``).
Scoring casts the codes to f32; every product and sum is an integer below
2^24, so f32 arithmetic is exact.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _with_norms(codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    cf = codes.float()
    norms = torch.sum(cf * cf, dim=-1)
    norms[-1] = float("inf")
    return codes, norms


def quantize_simple(vectors: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cast-quantize the padded corpus to uint8: ``(codes, code_norms)``."""
    return _with_norms(torch.clamp(vectors.float(), 0.0, 255.0).to(torch.uint8))


def ranged_scale_offset(x: np.ndarray) -> Tuple[float, float]:
    """Global min/max affine parameters (src/quantizer.h:214-219):
    ``scale = 256 / (max - min)``, ``offset = -scale * min``."""
    mx = float(np.max(x))
    mn = float(np.min(x))
    scale = 256.0 / max(mx - mn, 1e-30)
    return scale, -scale * mn


def quantize_ranged(vectors: torch.Tensor, scale: float, offset: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Affine-quantize the padded corpus to uint8: ``(codes, code_norms)``.
    ``scale`` and ``offset`` act as f32, as in the JAX package."""
    f = torch.round(vectors.float() * np.float32(scale) + np.float32(offset))
    return _with_norms(torch.clamp(f, 0.0, 255.0).to(torch.uint8))
