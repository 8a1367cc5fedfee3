"""ctypes bindings of the native IO runtime (counterpart of
expann_tpu/utils/io_native.py over the same source, native/expann_io.cpp).

The library is built at first use with ``g++`` from
``native/expann_io.cpp`` into ``build/native/`` of the checkout, named by a
hash of the source and the flags, and loaded from there.  It is built for
the host's base instruction set (no ``-march=native``), so a ``build/``
copied to another machine still loads there.  The tracked
``native/libexpann_io.so`` is never loaded or rebuilt: it was compiled with
``-march=native`` on another host.

Every entry point returns ``None`` (``native_blob_write``: False) when the
library cannot be built or loaded, so callers fall back to numpy; a file
the library rejects raises ``IOError``, as the JAX bindings do.  ``reads``
counts the files ``native_read_vecs`` parsed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "expann_io.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra")

reads = 0

_I64 = ctypes.c_int64
_SIGNATURES = {
    "expann_vecs_dims": ([ctypes.c_char_p, ctypes.POINTER(_I64), ctypes.POINTER(_I64)], _I64),
    "expann_vecs_read": ([ctypes.c_char_p, ctypes.c_void_p, _I64, _I64], _I64),
    "expann_blob_write": ([ctypes.c_char_p, ctypes.c_void_p, _I64], _I64),
    "expann_blob_size": ([ctypes.c_char_p], _I64),
    "expann_blob_read": ([ctypes.c_char_p, ctypes.c_void_p, _I64], _I64),
}


def _build(so: Path) -> None:
    """Compile the library into ``so``: under a temporary name, then
    renamed, so that concurrent builders never load a half-written file."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "lib.so")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", out, str(SOURCE)], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise OSError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(out, so)


@functools.lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    """Build (once per source hash) and load the library; None when either
    fails."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    try:
        digest.update(SOURCE.read_bytes())
        so = BUILD_DIR / f"libexpann_io_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            _build(so)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:  # built on another host (a copied build/): build it here
            _build(so)
            lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError):
        return None
    for name, (argtypes, restype) in _SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    return lib


def native_available() -> bool:
    return _load() is not None


def native_read_vecs(filename: str, dtype=np.float32) -> Optional[np.ndarray]:
    """An fvecs / ivecs file (records of int32 d, then d 4-byte items) as an
    ``(n, d)`` array of ``dtype``, parsed by the library; None if it is
    unavailable.  A file it cannot parse raises ``IOError``."""
    global reads
    lib = _load()
    if lib is None:
        return None
    path = os.fsencode(filename)
    n, d = _I64(), _I64()
    rc = lib.expann_vecs_dims(path, ctypes.byref(n), ctypes.byref(d))
    if rc != 0:
        raise IOError(f"native vecs parse failed ({rc}): {filename}")
    out = np.empty((n.value, d.value), np.float32 if dtype == np.float32 else np.int32)
    rc = lib.expann_vecs_read(path, out.ctypes.data_as(ctypes.c_void_p), n.value, d.value)
    if rc != 0:
        raise IOError(f"native vecs read failed ({rc}): {filename}")
    reads += 1
    return out if out.dtype == dtype else out.astype(dtype)


def native_blob_write(filename: str, arr: np.ndarray) -> bool:
    """Write the bytes of ``arr`` (C order) to ``filename``; False if the
    library is unavailable or the write failed."""
    lib = _load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(arr)
    return lib.expann_blob_write(os.fsencode(filename), arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes) == 0


def native_blob_read(filename: str, shape, dtype) -> Optional[np.ndarray]:
    """The array of ``shape`` and ``dtype`` whose bytes are the whole file;
    None if the library is unavailable.  A file of another size raises
    ``IOError``."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(shape, dtype)
    rc = lib.expann_blob_read(os.fsencode(filename), out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    if rc != 0:
        raise IOError(f"native blob read failed ({rc}): {filename}")
    return out
