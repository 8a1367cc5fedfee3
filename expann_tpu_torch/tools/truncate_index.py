"""Truncate a saved index's bottom-layer adjacency to a smaller R0
(counterpart of tools/truncate_index.py; host numpy only).

The packed serving layout holds one copy of each vector per adjacency slot
(RS = roundup(R0, 16) blocks of D values), so device memory caps the
servable R0 at a given N.  The prune emits forward rows roughly best-first,
so the first R0' slots of a wider-built graph approximate a graph built at
M0 = R0' with the wider build's candidate sets.  The file keeps every other
array, the header included (``utils/persist.py``, format_version 1; an
index written by either package)::

    python -m expann_tpu_torch.tools.truncate_index --in idx_M24.npz --r0 32 --out idx_M24_r32.npz
"""

from __future__ import annotations

import argparse

import numpy as np


def truncate_index(inp: str, out: str, r0: int) -> tuple:
    """Write ``inp`` to ``out`` with ``adj_bottom`` cut to its first ``r0``
    columns; returns the old and the new shape."""
    with np.load(inp) as z:
        arrays = {key: z[key] for key in z.files}
    adj = arrays["adj_bottom"]
    if not 0 < r0 < adj.shape[1]:
        raise ValueError(f"r0={r0} must be in 1..{adj.shape[1] - 1} (adj_bottom {adj.shape})")
    arrays["adj_bottom"] = np.ascontiguousarray(adj[:, :r0])
    np.savez(out, **arrays)
    return adj.shape, arrays["adj_bottom"].shape


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--r0", type=int, required=True)
    args = ap.parse_args(argv)
    old, new = truncate_index(args.inp, args.out, args.r0)
    print(f"wrote {args.out}: adj_bottom {old} -> {new}", flush=True)
    return old, new


if __name__ == "__main__":
    main()
