"""The control's readings of a cell, from which the upper end of each
limit is set.

    python3 annbench/calibrate.py --workload <name> --seeds 11,12,13

For each seed it draws the cell's corpus and pool as a run does, puts the
control in the program's place (``reference.lowprec_topk``: exact k-NN
with every score in the cell's ``control`` precision, one step below what
the configuration states) over the whole pool, and judges its lists by the
comparison of a run (``check.judge``), at the cell's own sizes.  Prints one
JSON line a seed.  The benchmark's runs never call it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "annbench":
    sys.path[0] = str(ROOT)


def control_numbers(workload: str, seed: int, root: Path = ROOT, device="cuda") -> dict:
    import torch

    from annbench import check, data, reference
    from annbench.manifest import cell

    c = cell(workload, root)
    k, batch = int(c.config["k"]), int(c.traffic["batch"])
    device = torch.device(device)
    x, pool = data.make(c.config["data"], int(c.traffic["pool"]), seed, device)
    gt = reference.exact_topk(x, pool, k)[0]
    ids = reference.lowprec_topk(x, pool, k, c.spec["control"]).cpu().numpy()
    outs = [(s, ids[s * batch : (s + 1) * batch]) for s in range(max(1, pool.shape[0] // batch))]
    numbers = check.judge(outs, x, pool, gt, batch, k)
    return {"workload": workload, "seed": seed, "control": c.spec["control"], **numbers,
            "fails": not check.passes(numbers, c.spec["limits"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        out = control_numbers(args.workload, int(s), ROOT, args.device)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
