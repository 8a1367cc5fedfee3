"""Measure the canonical bench's CPU denominators on the card's own host
and write them to ``expann_tpu_torch/bench/cpu_baseline.json``::

    python -m expann_tpu_torch.tools.cpu_baseline [--build] [--build-timeout 3000]
        [--work build/cpu_baseline] [--out expann_tpu_torch/bench/cpu_baseline.json]

In order:
  1. builds the canonical graph (config_synthetic.json: n=56000, d=128,
     m=400, k=10; bench.py's graph config) on the card with this package,
     and saves it with ``utils/persist.save_index`` (format_version 1);
  2. builds ``native/baseline_search`` and ``native/baseline_build``
     (``make -C native baseline``: g++ -O3 -march=native);
  3. exports the graph and the canonical queries with
     ``tools/export_baseline.py``, run as a subprocess;
  4. runs ``baseline_search`` at ef 20-250, pinned to one core (``taskset
     -c 0``): the reference's serving loop, single core, as BASELINE.md
     measures it.  The host is shared, so one pass per ef is noisy: the
     tool makes 9 sweeps of one pass at every ef, each sweep in its own
     process and with the ef order rotated, so that a slow spell of the
     host falls on different efs, and takes each ef's median QPS.  A
     sweep whose median QPS rises with ef is flagged.  The QPS denominator
     is the lowest ef whose recall@10 is at least 0.95, bench.py's rule;
  5. with ``--build``, runs ``baseline_build`` (M=60, efc=500,
     prune_overflow=1), the reference's single-core insert loop, also
     pinned: its seconds are the build denominator.  If it does not finish
     within ``--build-timeout`` seconds, ``build_s`` stays null.

The JSON names the host's CPU model (lscpu), the card and its power limit
(nvidia-smi), and the commit (``git rev-parse HEAD``; null outside a git
checkout); it is written after the sweep and again after the build.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "expann_tpu_torch" / "bench" / "cpu_baseline.json"
CONFIG = {"n": 56000, "m": 400, "d": 128, "k": 10}
EFS = (20, 45, 90, 100, 110, 120, 150, 250)
SWEEPS = 9
RECALL_TARGET = 0.95
BUILD_ARGS = ("60", "500", "1")  # M, ef_construction, prune_overflow: bench.py's graph config
PIN = ["taskset", "-c", "0"]


def denominator(sweep: List[dict], target: float = RECALL_TARGET) -> Optional[dict]:
    """The sweep point at the lowest ef whose recall is at least ``target``."""
    ok = [p for p in sweep if p["recall"] >= target]
    return min(ok, key=lambda p: p["ef"]) if ok else None


def json_lines(text: str) -> List[dict]:
    """The JSON objects printed one a line by the native baselines."""
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def sweep_order(efs, s: int) -> List[int]:
    """The efs of sweep ``s``: ``efs`` rotated left by ``s``."""
    s %= len(efs)
    return list(efs[s:]) + list(efs[:s])


def median_sweep(runs: List[List[dict]]) -> List[dict]:
    """One point per ef, in ascending ef, from sweeps of one pass each: the
    median QPS over the sweeps, each sweep's QPS alongside.  Recall and
    distance computations do not depend on the pass, and must agree."""
    by_ef: dict = {}
    for run in runs:
        for p in run:
            by_ef.setdefault(p["ef"], []).append(p)
    out = []
    for ef in sorted(by_ef):
        ps = by_ef[ef]
        if len({(p["recall"], p["distcomps_per_query"]) for p in ps}) != 1:
            raise ValueError(f"sweeps disagree on recall or distance computations at ef={ef}: {ps}")
        qps = statistics.median(p["qps"] for p in ps)
        out.append({"ef": ef, "recall": ps[0]["recall"], "qps": qps, "us_per_query": round(1e6 / qps, 2),
                    "distcomps_per_query": ps[0]["distcomps_per_query"], "qps_sweeps": [p["qps"] for p in ps]})
    return out


def rising(sweep: List[dict]) -> List[int]:
    """The efs whose QPS is above that of the ef before them: more work
    ran faster, so the host's noise outweighs the difference there."""
    return [b["ef"] for a, b in zip(sweep, sweep[1:]) if b["qps"] > a["qps"]]


def host_cpu() -> str:
    """The host's CPU as lscpu describes it: model name (a virtual machine
    may report "unknown"), vendor, family / model / stepping, clock, and
    whether it has AVX-512 (``-march=native`` vectorises the distances)."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True, check=True, timeout=60).stdout
    f = {k.strip(): v.strip() for k, _, v in (line.partition(":") for line in out.splitlines())}
    get = lambda key: f.get(key, "?")  # noqa: E731
    mhz = f.get("CPU max MHz") or f.get("CPU MHz")
    clock = f"{mhz} MHz" if mhz else f"BogoMIPS {get('BogoMIPS')}"
    avx = "avx512f" if "avx512f" in f.get("Flags", "").split() else "no avx512f"
    return (f"{get('Model name')}; {get('Vendor ID')} family {get('CPU family')} model {get('Model')} "
            f"stepping {get('Stepping')}, {clock}, {avx}")


def _commit() -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def build_index(work: Path, device) -> tuple:
    """Build and save the canonical graph; returns ``(index, dataset, build_s)``."""
    import time

    from expann_tpu_torch.bench.canonical import graph_config
    from expann_tpu_torch.bench.harness import sync
    from expann_tpu_torch.data.loader import load_synthetic_uniform_sphere_points
    from expann_tpu_torch.models.antitopo import AntitopoEngine
    from expann_tpu_torch.utils.persist import save_index

    ds = load_synthetic_uniform_sphere_points(CONFIG["n"], CONFIG["m"], CONFIG["k"], CONFIG["d"],
                                              cache_dir=str(work), device=device)
    eng = AntitopoEngine(config=graph_config(), device=device)
    eng.store_many_vectors(ds.vecs)
    t0 = time.perf_counter()
    eng.build()
    sync(eng.device)
    build_s = time.perf_counter() - t0
    index = work / "index.npz"
    save_index(str(index), eng.graph, {"dim": eng.dim})
    return index, work / f"{ds.name}.dataset", build_s


def _write(out: Path, record: dict) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1) + "\n")
    print(f"wrote {out}", flush=True)


def main(argv=None, *, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--work", default=str(ROOT / "build" / "cpu_baseline"))
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--build", action="store_true", help="also time native/baseline_build")
    ap.add_argument("--build-timeout", type=float, default=3000.0)
    args = ap.parse_args(argv)
    work, out = Path(args.work), Path(args.out)
    work.mkdir(parents=True, exist_ok=True)

    from expann_tpu_torch.utils.profiling import card_name

    index, dataset, gpu_build_s = build_index(work, device)
    print(f"built and saved {index} in {gpu_build_s:.3f} s on the card", flush=True)
    subprocess.run(["make", "-C", str(ROOT / "native"), "baseline"], check=True, timeout=600)
    blob = work / "baseline_56k.bin"
    subprocess.run([sys.executable, str(ROOT / "tools" / "export_baseline.py"), "--index", str(index),
                    "--dataset", str(dataset), "--out", str(blob)], check=True, timeout=600)
    load = os.getloadavg()  # other work on the host slows the single-core loop
    runs = []
    for s in range(SWEEPS):
        efs = ",".join(str(ef) for ef in sweep_order(EFS, s))
        search = subprocess.run(PIN + [str(ROOT / "native" / "baseline_search"), str(blob), efs, "1"],
                                capture_output=True, text=True, check=True, timeout=1800)
        runs.append(json_lines(search.stdout))
    sweep = median_sweep(runs)
    up = rising(sweep)
    if up:
        print(f"warning: the median QPS rises with ef at ef={up}: the host's noise outweighs the work there",
              flush=True)
    record = {
        "config": CONFIG,
        "graph": "expann_tpu_torch.bench.canonical.graph_config() (bench.py:256-279), built on the card: "
                 + search.stderr.strip(),
        "method": f"native/baseline_search.cpp, the reference's serving loop (greedy descent + bottom-layer "
                  f"beam search), single core ({' '.join(PIN)}), over the {CONFIG['m']} canonical queries, "
                  f"k={CONFIG['k']}; g++ -O3 -march=native; {SWEEPS} sweeps of one pass at every ef, each in a "
                  f"process of its own with the ef order rotated, the median QPS of each ef",
        "host_cpu": host_cpu(),
        "host_cpus": os.cpu_count(),
        "host_loadavg_before_sweep": [round(v, 2) for v in load],
        "card": card_name(),
        "commit": _commit(),
        "sweep": sweep,
        "qps_rises_with_ef_at": up,
        "denominator": denominator(sweep),
        "build_s": None,
        "build": None,
        "build_note": "not run (python -m expann_tpu_torch.tools.cpu_baseline --build runs it)",
    }
    _write(out, record)
    if args.build:
        try:
            proc = subprocess.run(PIN + [str(ROOT / "native" / "baseline_build"), str(blob), *BUILD_ARGS],
                                  capture_output=True, text=True, check=True, timeout=args.build_timeout)
        except subprocess.TimeoutExpired:
            record["build_note"] = f"native/baseline_build did not finish within {args.build_timeout:.0f} s"
        else:
            record["build"] = json_lines(proc.stdout)[0]
            record["build_s"] = record["build"]["build_s"]
            record["build_note"] = (f"native/baseline_build.cpp {' '.join(BUILD_ARGS)} (M, efc, prune_overflow), "
                                    f"single core ({' '.join(PIN)}), the reference's insert-at-a-time build")
        _write(out, record)
    print(json.dumps({"denominator": record["denominator"], "build_s": record["build_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
