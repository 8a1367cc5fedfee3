"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source of ``csrc/`` for Hopper
(``sm_90a``), one process per source, all started together, and links the
objects into one shared library with a plain C interface, under
``build/kernels/`` at the repository root, named by a hash of the sources,
the headers they include and the flags; later calls (and later processes)
reuse it.  The library is bound with ``ctypes``: device pointers from
``Tensor.data_ptr()``, PyTorch's current stream, and a ``cudaGetLastError()``
code returned by every launch.

``launches`` counts kernel launches per wrapper; each wrapper adds one
where it launches its kernel and nowhere else, except under a CUDA graph's
capture, where it launches nothing: a replay of the graph adds the
launches it makes (models/search.py ``_BeamGraph.replay``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flat_topk.cu", "fused_search.cu", "packed_score.cu", "probes.cu")
HEADERS = ("keys.cuh",)  # included by the sources: part of the library's hash
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "expann_flat_topk_bf16": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "expann_flat_topk_fixed_bf16": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "expann_flat_topk_s8": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "expann_flat_topk_fixed_s8": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "expann_fused_search_bf16": [_P] * 10 + [_I] * 10 + [_P],
    "expann_fused_search_s8": [_P] * 10 + [_I] * 10 + [_P],
    "expann_fused_search_rows_bf16": [_P] * 10 + [_I] * 11 + [_P],
    "expann_flat_topk_smem_bytes": [_I, _I],
    "expann_flat_topk_fixed_smem_bytes": [_I, _I],
    "expann_fused_search_smem_bytes": [_I] * 6,
    "expann_fused_search_ring": [_I] * 7 + [_P] * 3,
    "expann_packed_score_bf16": [_P] * 7 + [_I] * 7 + [_P],
    "expann_packed_score_smem_bytes": [_I, _I, _I],
    "expann_smem_optin": [],
    "expann_probe_fused": [_P] * 4 + [_I] * 2 + [_P],
    "expann_block_gather": [_P] * 4 + [_I] * 4 + [_P],
    "expann_block_gather_smem_bytes": [_I] * 3,
    "expann_step_overhead": [_P] * 4 + [_I] * 8 + [_P],
    "expann_step_overhead_smem_bytes": [_I],
    "expann_step_overhead_clusters": [_I] * 3,
    "expann_probe_lanes": [_P] * 2 + [_I] * 4 + [_P],
}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    so = BUILD_DIR / f"libexpann_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile each source in its own process, all at once, then link
        # under a temporary name and rename: concurrent builders never load a
        # half-written library
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
            procs = [
                subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / s)],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for s, obj in zip(SOURCES, objs)
            ]
            errs = [p.communicate()[1] for p in procs]
            failed = [f"{s} ({p.returncode}):\n{e}" for s, p, e in zip(SOURCES, procs, errs) if p.returncode != 0]
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
            lib_tmp = os.path.join(tmp, "lib.so")
            proc = subprocess.run([_nvcc(), "-shared", "-o", lib_tmp, *objs], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
            so.with_suffix(".log").write_text("".join(errs))
            os.replace(lib_tmp, so)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.expann_error_string.argtypes = [ctypes.c_int]
    lib.expann_error_string.restype = ctypes.c_char_p
    return lib


def build_report() -> str:
    """The ptxas report (registers, shared memory, spills per kernel) of
    the library ``library()`` loaded."""
    lib = library()
    return Path(lib._name).with_suffix(".log").read_text()


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().expann_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device) -> None:
    """Validate a kernel operand: device, dtype, contiguity, 16-byte alignment."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} must be 16-byte aligned")
