"""The flat engine under test: ``BruteForceEngine`` in the configuration's
``flat`` mode, its corpus uploaded by ``build()``."""

from __future__ import annotations

import time

import numpy as np

from annbench.engines.graph import prepare  # noqa: F401  (the same kernel library)


def build(config: dict, spec: dict, x: np.ndarray, device):
    """``(engine, build seconds)``: host clock around ``build()``, ended by a
    synchronise."""
    import torch
    from expann_tpu_torch.models.brute_force import BruteForceEngine

    eng = BruteForceEngine(**config["flat"], device=device)
    eng.store_many_vectors(x)
    t0 = time.perf_counter()
    eng.build()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return eng, time.perf_counter() - t0


def counters(eng) -> dict:
    return {}


def stages(eng) -> dict:
    return {}
