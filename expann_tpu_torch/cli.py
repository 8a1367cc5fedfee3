"""Benchmark CLI (counterpart of expann_tpu/cli.py).

Counterpart of the reference's main.cpp (reference: src/main.cpp:52-108):
``python -m expann_tpu_torch.cli --config config.json`` (or bare
``--dataset Synthetic --n .. --m .. --d .. --k ..``) loads a dataset, runs
the canonical parameter sweep on the card, and saves results under
``./data/<ds_name>/data/`` (and the built indexes under ``./index/``) of
the working directory.  Parameter precedence is CLI flag > config file >
interactive prompt.  The flags are the JAX CLI's; the device is a keyword
of ``main`` (the card by default; the tests pass ``device="cpu"``).
"""

from __future__ import annotations

import sys

from expann_tpu_torch.bench.runner import perform_benchmarks
from expann_tpu_torch.data.loader import load_sift1m, load_synthetic_uniform_sphere_points
from expann_tpu_torch.utils.config import get_parameter, load_config_file


def main(argv=None, *, device="cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    config = load_config_file(argv)

    dataset = get_parameter(argv, config, "dataset", "Enter dataset type (Synthetic/Sift1M): ")
    ds_name = get_parameter(
        argv, config, "ds_name", "Enter dataset name: ", interactive=False
    ) if ("ds_name" in config or "--ds_name" in argv) else ""
    # num_threads is accepted for config/flag parity with the reference but
    # the device is time-shared (bench/runner.py) — don't prompt for it
    num_threads = int(get_parameter(argv, config, "num_threads", "", int, interactive=False, default=1))

    if dataset == "Sift1M":
        k = int(get_parameter(argv, config, "k", "Enter Sift1M dataset parameter k: ", int))
        print(f"Using Sift1M dataset with k={k}")
        ds = load_sift1m(
            "datasets/sift/sift_base.fvecs",
            "datasets/sift/sift_query.fvecs",
            "datasets/sift/sift_groundtruth.ivecs",
            k,
        )
    elif dataset == "Synthetic":
        n = int(get_parameter(argv, config, "n", "Enter n: ", int))
        m = int(get_parameter(argv, config, "m", "Enter m: ", int))
        d = int(get_parameter(argv, config, "d", "Enter d: ", int))
        k = int(get_parameter(argv, config, "k", "Enter k: ", int))
        print(f"Using Synthetic dataset with n,m,d,k={n},{m},{d},{k}")
        ds = load_synthetic_uniform_sphere_points(n, m, k, d, device=device)
    else:
        print("Invalid dataset type!", file=sys.stderr)
        return 1

    bdm = perform_benchmarks(ds, num_threads, device=device)

    if not ds_name:
        ds_name = dataset
    bdm.save(f"./data/{ds_name}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
