"""The Anti-Topo engine: public API (counterpart of
expann_tpu/models/antitopo.py).

Same surface as the reference's ``antitopo_engine<float>`` and its pybind11
bindings (src/antitopo_engine.h:103-260, src/pyrunner.cpp:55-91):
``store_vector`` / ``store_many_vectors`` / ``build`` / ``query_k`` /
``query_k_numpy`` / ``set_ef_search`` / ``name`` / ``param_list``.

Each chunk of a query call takes one of two routes, as in the JAX engine
(antitopo.py:467-497, :562-579; ``route_fused``): the fused traversal of
the serving layout (models/layout.py, chosen within ``PACKED_BUDGET_BYTES``)
for throughput batches, or the per-iteration beam search (models/search.py
``query_batch``) for small ones, over the layout's bf16 blocks or over row
gathers.
``use_packed`` and ``use_fused`` default to ``"auto"``: on when the
engine's device is CUDA, as the JAX engine's ``"auto"`` means on a TPU.  On
a CUDA device every kernel is the hand-written one; on the CPU its plain
version.

Quantized serving (``use_compression``): ``build`` attaches uint8 codes
(``quant_mode`` "simple" or "ranged", ops/quantize.py); with the packed
layout on, the layout switches to centered s8 blocks (``packed_dtype="i8"``,
half the bytes), scored in code space by the fused traversal and reranked
in exact f32; without it, and on the per-iteration route of an s8 layout,
queries take the uint8 gather beam (``query_batch(compressed=True)``).
``query_wire="i8"`` ships fused-route queries as int8 codes with a
per-query scale.  ``num_distcomps`` counts the full-precision distance
evaluations of queries and ``num_distcomps_compressed`` the quantized ones
(RECORD_STATS, src/antitopo_engine.h:125-129); both reset on ``build`` and
on ``set_ef_search``, as do ``num_rows_gathered`` (the corpus rows K1-rows
or K1-rows-s8 read) and ``num_queries`` (the queries answered).  Under a profiler each
call is one ``expann.engine.query`` span holding the host's cast
(``expann.engine.cast``), the serving layout's build on the first query
(``expann.engine.layout``), each chunk's upload (``expann.engine.upload``),
the search's spans (models/search.py) and the download
(``expann.engine.download``).

``build`` takes the one-shot builder up to 131072 rows (``BuildConfig.
auto_wave_threshold``) and the one-device distributed builder above it, or
with ``builder="dist"``, or the wave builder with ``builder="wave"``
(models/build.build_index; ``refine_frac > 0`` refines a wave or
distributed build).  A second ``build`` after more vectors are stored
extends the index by waves (models/wavebuild.extend_index_wave): store ->
build -> store -> build accumulates, as the reference's live inserts do
(src/antitopo_engine.h:310-330).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from expann_tpu_torch.models import layout as layouts
from expann_tpu_torch.models.base import Engine, ParamList, _concat_pending, format_param
from expann_tpu_torch.models.build import BuildConfig, build_index
from expann_tpu_torch.models.graph import GraphIndex
from expann_tpu_torch.models.search import fused_query_batch, query_batch
from expann_tpu_torch.models.wavebuild import extend_index_wave
from expann_tpu_torch.ops.distance import pad_dim
from expann_tpu_torch.ops.quantize import quantize_ranged, quantize_simple, ranged_scale_offset
from expann_tpu_torch.utils.persist import index_exists, load_index, save_index
from expann_tpu_torch.utils.profiling import annotate

# Device bytes the serving layout may take (models/layout.choose: blocks,
# else the rows of their precision, else none).  The JAX engine allows 10 GiB of a
# 16 GB TPU (EXPANN_PACKED_BUDGET_GB, antitopo.py:362-381); the same share
# of the H100's 80 GB is 50 GiB, which leaves ~26 GB for the corpus, the
# norm and id rows and the query workspace.  Canonical 56k: 0.92 GB (s8) /
# 1.84 GB (bf16); 1M rows at M0=120: 16.4 GB / 32.8 GB; 1M rows of 1024
# padded dims at M0=96: 100 GB / 201 GB of blocks, 1.02 GB / 2.05 GB of
# rows.
PACKED_BUDGET_BYTES = 50 * 2**30
PACKED_DTYPES = ("bf16", "i8")
QUERY_WIRES = ("bf16", "i8")
QUANT_MODES = ("simple", "ranged")


@dataclasses.dataclass
class AntitopoConfig:
    """Parameter set, mirroring antitopo_engine_config
    (reference: src/antitopo_engine.h:72-101) and the JAX package's knobs
    that the ported path reads."""

    M: int = 60
    M0: int = 0  # 0 -> 2 * M
    ef_search_mult: int = 1
    ef_search: Optional[int] = None
    ef_construction: int = 500
    ortho_count: int = 1
    ortho_factor: float = 0.5
    ortho_bias: float = 0.0
    prune_overflow: int = 0
    use_compression: bool = False
    use_largest_direction_filtering: bool = False  # no-op, as in reference
    index_filename: str = ""
    read_index: bool = False
    write_index: bool = False
    seed: int = 0
    # "default" and "highest" are both full fp32 in this package (TF32 off)
    precision: str = "highest"
    prune_cand: int = 0  # candidate-list cap fed to the prune; 0 -> auto
    query_block: int = 1024
    query_expand: int = 1  # beam entries expanded per traversal iteration
    builder: str = "auto"  # "oneshot" | "dist" | "wave" | "auto"
    # rows per wave: the wave builders (4096 from 4 x auto_wave_threshold
    # rows when 1024), the distributed builder (4096 at least)
    wave_size: int = 1024
    wave_expand: int = 4  # wave builders: beam entries expanded per iteration
    wave_overflow_rows: int = 128  # wave builders: fullest rows re-pruned per wave
    refine_frac: float = 0.0  # > 0: refine that share of a wave or distributed build
    # codes of use_compression: "simple" (the reference's uint8 cast) or
    # "ranged" (min/max affine q8, src/quantizer.h:186-238)
    quant_mode: str = "simple"
    # packed-neighbour layout for queries: "auto" (on when the engine's
    # device is CUDA), True or False
    use_packed: object = "auto"
    packed_topt: int = 8  # per-iteration route: best neighbours kept per expanded node
    # fused traversal: "auto" (on when the device is CUDA and packed is on;
    # chunks whose bucket is below fused_qt take the per-iteration route),
    # True (every chunk fused, needs packed), False (never)
    use_fused: object = "auto"
    fused_qt: int = 128
    fused_cand: int = 8  # candidates kept per iteration, split over query_expand
    # packed blocks: "bf16" or "i8" (centered s8 codes, build_packed_i8);
    # use_compression switches the layout to "i8" when packed is on
    packed_dtype: str = "bf16"
    # fused-route query wire: "bf16" (2 B/dim) or "i8" (1 B/dim absmax codes
    # plus a per-query f32 scale)
    query_wire: str = "bf16"
    # >0: seed the beam with the top-entry_seeds members of the largest
    # upper layer (<= 65536 members) by one dense scan; 0 keeps the
    # reference's greedy descent
    entry_seeds: int = 0

    def __post_init__(self):
        if self.M0 == 0:
            self.M0 = 2 * self.M


def route_fused(real: int, query_block: int, use_fused: bool, forced: bool, fused_qt: int) -> bool:
    """Whether a chunk of ``real`` queries takes the fused route
    (antitopo.py:471-481 of the JAX engine): its bucket is 8 doubled until
    it reaches ``real``, capped at ``query_block``; the chunk goes fused iff
    ``use_fused`` (resolved) and the bucket is at least ``fused_qt`` or the
    knob is literally True (``forced``).  The port pads no rows: the
    bucket only decides the route."""
    bucket = 8
    while bucket < real:
        bucket *= 2
    bucket = min(bucket, query_block)
    return use_fused and (bucket >= fused_qt or forced)


class AntitopoEngine(Engine):
    """Anti-Topo Engine+ on PyTorch, on ``device`` (the card by default;
    ``device="cpu"`` runs the plain versions)."""

    def __init__(
        self,
        M: int = 60,
        ef_construction: int = 500,
        ortho_count: int = 1,
        prune_overflow: int = 0,
        use_compression: bool = False,
        config: Optional[AntitopoConfig] = None,
        *,
        device="cuda",
    ):
        if config is None:
            config = AntitopoConfig(
                M=M,
                ef_construction=ef_construction,
                ortho_count=ortho_count,
                prune_overflow=prune_overflow,
                use_compression=use_compression,
            )
        for knob, allowed in (("packed_dtype", PACKED_DTYPES), ("query_wire", QUERY_WIRES),
                              ("quant_mode", QUANT_MODES)):
            if getattr(config, knob) not in allowed:
                raise ValueError(f"{knob}={getattr(config, knob)!r}: one of {allowed}")
        self.cfg = config
        self.device = torch.device(device)
        self._pending: List[np.ndarray] = []
        self.graph: Optional[GraphIndex] = None
        self.n = 0
        self.dim = 0
        self.num_distcomps = 0
        self.num_distcomps_compressed = 0
        self.num_rows_gathered = 0
        self.num_queries = 0
        self.build_stats: dict = {}

    # --- identity / params -------------------------------------------------
    def name(self) -> str:
        return "Anti-Topo Engine+"

    def param_list(self) -> ParamList:
        c = self.cfg
        return {
            "M": format_param(c.M),
            "M0": format_param(c.M0),
            "ef_search_mult": format_param(c.ef_search_mult),
            "ef_construction": format_param(c.ef_construction),
            "ortho_count": format_param(c.ortho_count),
            "ortho_factor": format_param(c.ortho_factor),
            "ortho_bias": format_param(c.ortho_bias),
            "prune_overflow": format_param(c.prune_overflow),
            "use_compression": format_param(c.use_compression),
            "use_largest_direction_filtering": format_param(c.use_largest_direction_filtering),
            "num_distcomps": format_param(self.num_distcomps),
            "num_distcomps_compressed": format_param(self.num_distcomps_compressed),
        }

    # --- ingest ------------------------------------------------------------
    def store_vector(self, v: np.ndarray) -> None:
        self._pending.append(np.asarray(v, dtype=np.float32).reshape(1, -1))

    def store_many_vectors(self, vs: np.ndarray, take_norms: bool = False) -> None:
        vs = np.asarray(vs, dtype=np.float32)
        if vs.ndim != 2:
            raise ValueError("Input should be a 2D array")
        if take_norms:
            norms = np.linalg.norm(vs, axis=1, keepdims=True)
            vs = vs / np.maximum(norms, 1e-30)
        self._pending.append(vs)

    # --- build -------------------------------------------------------------
    def build(self) -> None:
        c = self.cfg
        # the builders' stage seconds (and the wave builders' wave counts)
        self.build_stats = {}
        if c.index_filename and c.read_index:
            # read if the file exists, else build and write (reference
            # constructor, src/antitopo_engine.h:137-155)
            if index_exists(c.index_filename):
                c.write_index = False
            else:
                c.read_index = False
        if c.read_index and c.index_filename:
            self.graph, meta = load_index(c.index_filename, self.device)
            self._pending = []
            self.n = self.graph.n
            self.dim = int(meta.get("dim", self.graph.vectors.shape[1]))
        elif self.graph is not None and self._pending:
            # store -> build -> store -> build accumulates: the new vectors
            # go into the live graph by waves
            new_x = _concat_pending(self._pending)
            if new_x.shape[1] != self.dim:
                raise ValueError(f"dimension mismatch on extend: the index has {self.dim}, the new vectors "
                                 f"{new_x.shape[1]}")
            self._pending = []
            self.graph = extend_index_wave(self.graph, new_x, self._build_config(), wave_size=c.wave_size,
                                           stats=self.build_stats)
            self.n = self.graph.n
        else:
            if not self._pending:
                raise RuntimeError("no vectors stored")
            x = _concat_pending(self._pending)
            self._pending = []
            self.n, self.dim = x.shape
            self.graph = build_index(x, self._build_config(), self.device, stats=self.build_stats)
            if c.write_index and c.index_filename:
                save_index(c.index_filename, self.graph, {"dim": self.dim})
        if c.use_compression and self.graph.codes is None:
            self._attach_codes()
        # reset stats before queries (src/antitopo_engine.h:488-492)
        self._reset_counters()

    def _reset_counters(self) -> None:
        self.num_distcomps = 0
        self.num_distcomps_compressed = 0
        self.num_rows_gathered = 0
        self.num_queries = 0

    def _build_config(self) -> BuildConfig:
        c = self.cfg
        return BuildConfig(
            M=c.M,
            M0=c.M0,
            ef_construction=c.ef_construction,
            ortho_count=c.ortho_count,
            ortho_factor=c.ortho_factor,
            ortho_bias=c.ortho_bias,
            prune_overflow=c.prune_overflow,
            prune_cand=c.prune_cand,
            seed=c.seed,
            builder=c.builder,
            wave_size=c.wave_size,
            wave_expand=c.wave_expand,
            wave_overflow_rows=c.wave_overflow_rows,
            refine_frac=c.refine_frac,
        )

    def _attach_codes(self) -> None:
        """Quantize the corpus per ``quant_mode`` into uint8 codes
        (reference: the build-time quantize call, src/antitopo_engine.h:485-486)."""
        g = self.graph
        if self.cfg.quant_mode == "ranged":
            scale, offset = ranged_scale_offset(g.vectors[: self.n, : self.dim].cpu().numpy())
            g.codes, g.code_norms = quantize_ranged(g.vectors, scale, offset)
            g.quant_scale = torch.tensor(scale, dtype=torch.float32, device=self.device)
            g.quant_offset = torch.tensor(offset, dtype=torch.float32, device=self.device)
        else:
            g.codes, g.code_norms = quantize_simple(g.vectors)
            g.quant_scale = g.quant_offset = None

    # --- query -------------------------------------------------------------
    def set_ef_search(self, ef_search: int) -> None:
        self.cfg.ef_search = int(ef_search)
        self._reset_counters()

    def set_packed_dtype(self, dtype: str) -> None:
        """Switch the packed layout ("bf16" | "i8") of a built index: the
        serving layout is dropped and rebuilt on the next query."""
        if dtype not in PACKED_DTYPES:
            raise ValueError(f"packed_dtype={dtype!r}: one of {PACKED_DTYPES}")
        if dtype == self.cfg.packed_dtype:
            return
        self.cfg.packed_dtype = dtype
        if self.graph is not None:
            self.graph.layout = None

    def _ef(self, k: int) -> int:
        if self.cfg.ef_search is not None:
            return max(int(self.cfg.ef_search), k)
        return max(k * self.cfg.ef_search_mult, k)

    def _layout(self) -> Optional[layouts.Blocks | layouts.Rows]:  # CodeBlocks, CodeRows: subclasses
        """The serving layout queries use, built on first use
        (antitopo.py:338-433; s8 blocks with ``use_compression``), or None
        where the packed route is off or ``layouts.choose`` builds none
        within ``PACKED_BUDGET_BYTES``: queries then take the gather route."""
        c = self.cfg
        on = self.device.type == "cuda" if c.use_packed == "auto" else bool(c.use_packed)
        if not on:
            return None
        if c.use_compression:
            self.set_packed_dtype("i8")
        g = self.graph
        if g.layout is None:
            kind = layouts.choose(g.vectors.shape[0], g.adj_bottom.shape[1], g.vectors.shape[1], c.packed_dtype,
                                  PACKED_BUDGET_BYTES)
            if kind is None:
                return None
            with annotate("expann.engine.layout"):
                g.layout = kind.build(g)
        return g.layout

    def query_k_batch(self, queries: np.ndarray, k: int) -> np.ndarray:
        if self.graph is None:
            raise RuntimeError("build() must be called before queries")
        with annotate("expann.engine.query"):
            return self._query(queries, k)

    def _query(self, queries: np.ndarray, k: int) -> np.ndarray:
        c = self.cfg
        layout = self._layout()
        use_fused = layout is not None and (self.device.type == "cuda" if c.use_fused == "auto" else bool(c.use_fused))
        with annotate("expann.engine.cast"):
            q = np.asarray(queries, dtype=np.float32)
            if q.ndim != 2:
                raise ValueError("queries must be 2D")
        # queries narrower than the index (960 dims on a 1024-wide one) are
        # padded on the device, after the upload: the host copies no zeros
        width = self.graph.vectors.shape[1]
        ef = self._ef(k)
        bs = c.query_block
        # quantized serving: the fused route over s8 blocks when they exist,
        # otherwise the uint8 gather beam (antitopo.py:458-460, :493-495)
        compressed = bool(c.use_compression and self.graph.codes is not None)
        res, rows_read = [], []
        ncomp_total = 0
        for start in range(0, q.shape[0], bs):
            chunk = q[start : start + bs]
            fused = route_fused(chunk.shape[0], bs, use_fused, c.use_fused is True, c.fused_qt)
            if fused and (not compressed or layout.code_space):
                # queries travel as bf16 (2 B/dim) or as int8 absmax codes
                # (1 B/dim) plus a per-query scale, and are used as f32 on
                # the device for descent, traversal and rerank alike
                q_inv = None
                with annotate("expann.engine.cast"):
                    if c.query_wire == "i8":
                        a = np.maximum(np.abs(chunk).max(axis=1, keepdims=True), 1e-30)
                        q_op = torch.from_numpy(np.clip(np.round(chunk * (127.0 / a)), -127, 127).astype(np.int8))
                        q_inv = torch.from_numpy((a / 127.0).astype(np.float32))
                    else:
                        q_op = torch.from_numpy(chunk).to(torch.bfloat16)
                with annotate("expann.engine.upload"):
                    q_op = pad_dim(q_op.to(self.device), width)
                    if q_inv is None:
                        q_op = q_op.float()
                    else:
                        q_inv = q_inv.to(self.device)
                ids, _, ncomp = fused_query_batch(
                    self.graph,
                    q_op,
                    ef=ef,
                    k=k,
                    ef_cap=ef + ((-ef) % 128),
                    expand=c.query_expand,
                    cand=c.fused_cand,
                    seeds=c.entry_seeds,
                    q_inv_scale=q_inv,
                    rows_read=rows_read,
                )
            else:
                # the per-iteration route takes the f32 query as it is; it
                # scores the layout's blocks only where they are bf16 (the
                # block scorer has no code-space transform, antitopo.py:
                # 563-567; the rows layout has no blocks), else gathers
                with annotate("expann.engine.upload"):
                    q_dev = pad_dim(torch.from_numpy(chunk).to(self.device), width)
                ids, _, ncomp = query_batch(
                    self.graph,
                    q_dev,
                    k=k,
                    ef=ef,
                    expand=c.query_expand,
                    use_packed=layout is not None and layout.beam_blocks is not None,
                    packed_topt=c.packed_topt,
                    compressed=compressed,
                )
            res.append(ids)
            ncomp_total += ncomp.sum()
        with annotate("expann.engine.download"):
            out = torch.cat(res).cpu().numpy()
        # read after the download, which has waited for the device already
        if c.use_compression:
            # the traversal scores codes; the final beam is reranked in exact
            # f32, ef full-precision computations per query (antitopo.py:593-601)
            self.num_distcomps_compressed += int(ncomp_total)
            self.num_distcomps += q.shape[0] * ef
        else:
            self.num_distcomps += int(ncomp_total)
        self.num_rows_gathered += int(sum(r.sum() for r in rows_read))
        self.num_queries += q.shape[0]
        return out

    def query_k(self, v: np.ndarray, k: int) -> List[int]:
        ids = self.query_k_batch(np.asarray(v, np.float32)[None, :], k)[0]
        return [int(i) for i in ids if i < self.n][:k]

    # reference pybind alias (src/pyrunner.cpp:84-90)
    def query_k_numpy(self, v: np.ndarray, k: int) -> List[int]:
        return self.query_k(v, k)
