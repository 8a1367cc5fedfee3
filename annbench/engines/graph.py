"""The graph engine under test: ``AntitopoEngine`` with the configuration's
``graph`` settings, built by its own ``build()`` and served by
``query_k_batch`` at the cell's ``ef``."""

from __future__ import annotations

import time

import numpy as np


def prepare(device) -> None:
    """Load the program's kernel library (nvcc builds it on a checkout's
    first run, into ``build/kernels/`` of the checkout)."""
    if device.type == "cuda":
        from expann_tpu_torch.ops import _kernels

        _kernels.library()


def build(config: dict, spec: dict, x: np.ndarray, device):
    """``(engine, build seconds)``: host clock around ``build()``, ended by a
    synchronise."""
    import torch
    from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine

    eng = AntitopoEngine(config=AntitopoConfig(**config["graph"], ef_search=int(spec["ef"])), device=device)
    eng.store_many_vectors(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    eng.build()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return eng, time.perf_counter() - t0


def counters(eng) -> dict:
    """The engine's work counters: distance computations at full and at
    quantized precision."""
    return {"distcomps": eng.num_distcomps, "distcomps_compressed": eng.num_distcomps_compressed}


def stages(eng) -> dict:
    """The builder's stage seconds (the distributed builder's; the one-shot
    builder records none)."""
    return dict(eng.build_stats.get("seconds", {}))
