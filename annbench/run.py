"""Run one cell of the benchmark once and print its result line.

    python3 annbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m annbench.run ...``) from the root of a checkout.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last: each compared number with its limit); the last lines of
standard error are the same numbers, one a line.  Without as many CUDA
devices as the cell asks for, or with JAX or the JAX package loaded once
the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "annbench" / "cache"
THREADS = 4  # host threads of the one client process


def _process_setup() -> None:
    # run as a file, Python puts this directory first on the path: the
    # checkout's root goes there instead, so no file here shadows a module
    if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "annbench":
        sys.path[0] = str(ROOT)
    elif str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    # caches of the libraries the program loads: fixed directories of the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _process_setup()

    import torch

    from annbench import guard
    from annbench.harness import run_cell
    from annbench.manifest import cell

    chips = cell(args.workload, ROOT).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"annbench: the cell needs {chips} CUDA device(s), this machine has {have}", file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), root=ROOT,
                             device="cuda:0", t_start=T_START)
    found = guard.forbidden()
    if found:
        print(f"annbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
