"""Hopper counterparts of the repo's measurement tools (``tools/``), one
module per tool under the tool's own file name.  Each probe module holds
its kernel's plain PyTorch version, a ``*_cuda`` wrapper over
``csrc/probes.cu`` and a dispatcher by device, and a ``main()`` that runs
the tool's sweep on the card; the perf tools time the serving kernels::

    python -m expann_tpu_torch.tools.probe_fused          # P1
    python -m expann_tpu_torch.tools.perf_pallas_gather   # P2
    python -m expann_tpu_torch.tools.probe_step_overhead  # P3 and K1's slope
    python -m expann_tpu_torch.tools.probe_lanes          # P4
    python -m expann_tpu_torch.tools.perf_trace           # serving profile
    python -m expann_tpu_torch.tools.perf_flat_mode       # K2 / K3 (bf16, s8) A/B
    python -m expann_tpu_torch.tools.bench_1m             # the million-row build and serving
"""
