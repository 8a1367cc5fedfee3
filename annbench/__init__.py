"""The benchmark of expann_tpu_torch: one cell a run, ``python3 annbench/run.py --help``."""
