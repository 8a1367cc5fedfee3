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
    python -m expann_tpu_torch.tools.refine_1m            # refine a saved index
    python -m expann_tpu_torch.tools.bench_bigflat        # 20M flat rows (K2; fused_i8: K2-s8)
    python -m expann_tpu_torch.tools.make_sift_like       # the SIFT-like fvecs / ivecs files
    python -m expann_tpu_torch.tools.perf_latency         # device latency of small batches
    python -m expann_tpu_torch.tools.probe_wave_cost      # one wave of the million-row build, split
    python -m expann_tpu_torch.tools.profile_build        # the 56k build's steps
    python -m expann_tpu_torch.tools.perf_oppoint         # (expand, cand) x ef of the traversal
    python -m expann_tpu_torch.tools.perf_e2e_graph       # graph QPS against batch size
    python -m expann_tpu_torch.tools.perf_ab_serving      # serving modes in turns
    python -m expann_tpu_torch.tools.probe_flat_overhead  # a flat call's upload, compute, download
    python -m expann_tpu_torch.tools.truncate_index       # cut an index's bottom rows (host)
    python -m expann_tpu_torch.tools.persist_1m_artifacts # bench_1m's summary as records (host)
"""
