"""Parameter-sweep job runner (counterpart of expann_tpu/bench/runner.py).

Counterpart of the reference's bench_runner (reference:
src/bench_runner.h:124-180): builds the canonical job grid over engine
params and runs each job, collecting results into a BenchDataManager.  The
reference's thread pool over independent single-threaded engines
(:15-58, 77-87) has no counterpart: the card is time-shared, so jobs run
one after another (``num_threads`` is accepted for CLI parity).  Builds are
reused across jobs that share every build-affecting param, as the
reference's index-file scheme does (:149-158).

A reused job serves the built graph through a view of its own: a shallow
copy that shares the vectors, norms, adjacency and upper layers, and holds
its own uint8 codes and packed layout.  The engine derives those in place
(``_attach_codes``, ``set_packed_dtype``, ``_layout``), so an
engine serving the build's graph itself would leave, say, s8 blocks behind
for the next uncompressed job.  One view is kept per build and serving
layout, so each layout is built once per build.
"""

from __future__ import annotations

import copy
import traceback
from typing import Dict, List, Optional, Tuple

from expann_tpu_torch.bench.harness import get_benchmark_data, score, timed_queries
from expann_tpu_torch.bench.manager import BenchDataManager
from expann_tpu_torch.data.dataset import TestDataset
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.models.graph import GraphIndex


def canonical_job_grid(index_dir: str = "index") -> List[AntitopoConfig]:
    """The reference's sweep (src/bench_runner.h:133-163): M=60, M0=2M,
    ef_search_mult in 1..6, ef_construction = M * (500 / M),
    ortho_count=1, ortho_factor=0.5, ortho_bias=0.0,
    prune_overflow in {0, 1}, use_compression in {false, true}."""
    jobs = []
    for k in [60]:
        for num_for_1nn in [1, 2, 3, 4, 5, 6]:
            for edge_count_search_factor in [500 // k]:
                for use_compression in [False, True]:
                    for prune_overflow in [0, 1]:
                        filename = (
                            f"{index_dir}/sift_k{k}"
                            f"_efx{edge_count_search_factor}"
                            f"_orthocount1_orthofactor0.500000"
                            f"_orthobias0.000000"
                            f"_pruneoverflow{prune_overflow}"
                        )
                        jobs.append(
                            AntitopoConfig(
                                M=k,
                                M0=2 * k,
                                ef_search_mult=num_for_1nn,
                                ef_construction=k * edge_count_search_factor,
                                ortho_count=1,
                                ortho_factor=0.5,
                                ortho_bias=0.0,
                                prune_overflow=prune_overflow,
                                use_compression=use_compression,
                                index_filename=filename,
                                read_index=True,
                                write_index=True,
                            )
                        )
    return jobs


def _build_key(c: AntitopoConfig) -> Tuple:
    return (
        c.M,
        c.M0,
        c.ef_construction,
        c.ortho_count,
        c.ortho_factor,
        c.ortho_bias,
        c.prune_overflow,
        c.seed,
        c.prune_cand,
    )


def _serving_key(c: AntitopoConfig) -> Tuple:
    """What an engine derives from a built graph: uint8 codes and s8 blocks
    with ``use_compression``, else the packed layout of ``packed_dtype``."""
    return (True, c.quant_mode) if c.use_compression else (False, c.packed_dtype)


def _view(graph: GraphIndex) -> GraphIndex:
    """A shallow copy of ``graph`` that shares its built arrays and has no
    codes and no packed layout yet."""
    view = copy.copy(graph)
    view.layout = None
    view.codes = view.code_norms = view.quant_scale = view.quant_offset = None
    return view


def perform_benchmarks(
    ds: TestDataset,
    num_threads: int = 1,
    jobs: Optional[List[AntitopoConfig]] = None,
    verbose: bool = True,
    *,
    device="cuda",
) -> BenchDataManager:
    """Run ``jobs`` (the canonical grid by default) on ``ds`` with engines on
    ``device``; a job that fails adds an error string to the manager."""
    del num_threads  # device-bound; kept for CLI parity
    if jobs is None:
        jobs = canonical_job_grid()
    bdm = BenchDataManager(ds.name)

    built: Dict[Tuple, Tuple[AntitopoEngine, float]] = {}
    views: Dict[Tuple, GraphIndex] = {}
    total = len(jobs)
    for i, conf in enumerate(jobs):
        key = _build_key(conf)
        view_key = (key, _serving_key(conf))
        if verbose:
            print(
                f"Running job {i + 1}/{total}: ef_search_mult="
                f"{conf.ef_search_mult} use_compression={conf.use_compression} "
                f"prune_overflow={conf.prune_overflow}"
            )
        try:
            eng = AntitopoEngine(config=conf, device=device)
            if key in built:
                base, build_ns = built[key]
                if view_key not in views:
                    views[view_key] = _view(base.graph)
                eng.graph = views[view_key]
                eng.n = base.n
                eng.dim = base.dim
                if conf.use_compression and eng.graph.codes is None:
                    eng._attach_codes()
                ans, per_query_ns = timed_queries(eng, ds)
                bd = score(eng, ds, ans, per_query_ns, build_ns)
            else:
                bd = get_benchmark_data(eng, ds)
                built[key] = (eng, bd.time_to_build_ns)
                views[view_key] = eng.graph
            bdm.add(bd)
            if verbose:
                print(f"Completed job {i + 1}/{total}: {bd.to_string()}")
        except Exception as e:  # mirror the reference's error-string results
            bdm.add(f"job {i} failed: {e!r}")
            if verbose:
                traceback.print_exc()
    return bdm
