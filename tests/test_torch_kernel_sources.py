"""The kernel library's name covers every file it is built from.

``ops/_kernels.library()`` reuses a built library when the hash of its
sources, headers and flags names one that exists; a source or a header
that the hash leaves out would let a stale library load after it changes.
No compiler is needed: the test reads ``csrc/``."""

import re

from expann_tpu_torch.ops import _kernels


def test_every_source_and_included_header_is_hashed():
    on_disk = {p.name for p in _kernels.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    assert set(_kernels.SOURCES) | set(_kernels.HEADERS) == on_disk
    included = set()
    for name in _kernels.SOURCES + _kernels.HEADERS:
        included |= set(re.findall(r'^#include "([^"]+)"', (_kernels.CSRC / name).read_text(), re.M))
    assert included == set(_kernels.HEADERS)
