"""The check that nothing of JAX, nor the JAX package, was loaded.

Names are compared whole, by their top-level part (before the first dot):
``expann_tpu_torch`` is the program, ``expann_tpu`` the JAX package it was
ported from, and the one is not the other.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "expann_tpu"})


def forbidden(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: ``sys.modules``)."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
