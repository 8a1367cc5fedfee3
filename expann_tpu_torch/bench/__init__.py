"""The benchmark layer (counterpart of expann_tpu/bench/ and the repo-root
bench.py): the result record and its files (``bench_data``, ``manager``),
the recall / QPS harness (``harness``), the reference's 24-job sweep
(``runner``, driven by ``expann_tpu_torch.cli``), and the canonical
one-line benchmark (``canonical``, run as
``python -m expann_tpu_torch.bench.canonical``)."""

from expann_tpu_torch.bench.bench_data import BenchData
from expann_tpu_torch.bench.manager import BenchDataManager
from expann_tpu_torch.bench.harness import get_benchmark_data

__all__ = ["BenchData", "BenchDataManager", "get_benchmark_data"]
