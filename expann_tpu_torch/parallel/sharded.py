"""The corpus-sharded index over a tuple of devices (counterpart of
expann_tpu/parallel/sharded.py).

The JAX module lays S sub-indexes out on a device mesh and runs each step
under ``shard_map``; one process drives it and gets one answer back.  The
port keeps that single-controller form: a mesh is a tuple of torch
devices, shard s lives on ``mesh[s]``, and one Python loop enqueues every
shard's work on its own device before anything is read back.  A device
may appear more than once, so S shards run on fewer cards (the CPU tests
use ``[cpu] * 8``, as the JAX tests use 8 virtual CPU devices; one card
serves ``[cuda:0] * 4``).  Per-shard lists move to ``mesh[0]`` with
``.to(mesh[0])`` and merge there.

  * ``build_sharded``: contiguous row blocks, global id ``s * n_shard +
    local``, one ``build_index`` per shard on its device; the last shard
    padded with +inf-norm rows no search reaches; the upper levels padded
    across shards (a shard without a level gets all-sentinel slots, so its
    descent there is a no-op).
  * queries fan out to every shard and merge by a stable sort on distance
    alone, so ties keep shard order, which is global-id order:
    ``sharded_query_batch`` (greedy descent and ``beam_search`` per shard:
    row gathers, one host sync an iteration, so its shards run one after
    another; the JAX docstring calls this path superseded),
    ``sharded_packed_query`` (the fused traversal K1 per shard) and
    ``sharded_flat_query`` (the flat top-k scan K2 per shard).  On the K1
    and K2 paths every shard's launches are enqueued before any read-back.
  * ``sharded_build_step``: per-shard exact top-C, a merge by (d, id), the
    anti-topo prune on ``mesh[0]``.
  * ``replicated_fused_query_dp`` / ``replicated_query_dp``: the graph on
    every distinct device of the mesh, the batch split into S slices.

Not ported: the JAX paddings of the batch to ``qt`` (sharded_packed_query)
and to ``S * qt`` (replicated_fused_query_dp), of the flat corpus with
1e4-valued rows to ``block`` and of the flat queries to 256: the port's
kernels take any batch and mask a ragged corpus tile themselves.  The
``precision`` switch is not ported (the port computes in f32 throughout).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from expann_tpu_torch.models.build import BuildConfig, build_index, sort_rows
from expann_tpu_torch.models.graph import GraphIndex, UpperLayer
from expann_tpu_torch.models.layout import Blocks
from expann_tpu_torch.models.prune import antitopo_prune, pairwise_co_dist
from expann_tpu_torch.models.search import entry_beam, fused_query_batch, query_batch, rerank
from expann_tpu_torch.ops.distance import LANE, pad_dim, pairwise_dist2, squared_norms
from expann_tpu_torch.ops.topk import flat_topk

INF = float("inf")
Mesh = Tuple[torch.device, ...]


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """The devices of a mesh, in shard order.  By default every visible
    CUDA device (or the first ``n_devices``; more than are visible raises).
    ``devices`` names them instead, and may repeat one: ``[cpu] * 8`` or
    ``[cuda:0] * 4`` give 8 or 4 shards on one device."""
    if devices is None:
        count = torch.cuda.device_count()
        n_devices = count if n_devices is None else n_devices
        if not 1 <= n_devices <= count:
            raise ValueError(f"{n_devices} devices asked for, {count} CUDA devices visible; "
                             f"pass devices= to run elsewhere")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    mesh = tuple(_indexed(torch.device(d)) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the current CUDA device, so that it compares equal to the
    device of the tensors made on it."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def as_mesh(mesh) -> Mesh:
    """A mesh from a mesh, a device sequence, or one device (S = 1)."""
    if mesh is None:
        return make_mesh()
    if isinstance(mesh, (str, torch.device)):
        mesh = [mesh]
    return make_mesh(devices=mesh)


class ShardedRows:
    """A table of ``S * n_shard + 1`` rows held as S parts: part s, on its
    own device, holds the rows ``s * n_shard + local`` (local < n_shard) and
    its own sentinel row ``n_shard``; the global sentinel ``S * n_shard``
    reads the last part's sentinel row (``_g2sl``, distbuild.py:56-62).

    It indexes like the one-device tensor it stands for, so the builder's
    one-device steps run on it unchanged: a tensor of global ids gathers
    onto the first part's device (each part serves the ids it owns), a
    slice ``[:S * n_shard]`` concatenates the parts' rows there, and
    assignment and ``index_add_`` write each id to its owner (ids at or
    beyond the global sentinel are dropped, as ``mode="drop"`` drops
    them)."""

    def __init__(self, parts: Sequence[torch.Tensor], n_shard: int):
        self.parts = tuple(parts)
        self.n_shard = n_shard
        self.shape = (len(self.parts) * n_shard + 1,) + tuple(self.parts[0].shape[1:])
        self.device = self.parts[0].device
        self.dtype = self.parts[0].dtype

    def _locate(self, gids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        S, ns = len(self.parts), self.n_shard
        shard = torch.clamp_max(torch.div(gids, ns, rounding_mode="floor"), S - 1)
        return shard, torch.where(gids >= S * ns, ns, gids - shard * ns)

    def __getitem__(self, key):
        if isinstance(key, slice):
            return torch.cat([p[: self.n_shard].to(self.device) for p in self.parts])[key]
        shard, local = self._locate(key)
        out = None
        for s, p in enumerate(self.parts):
            own = shard == s
            rows = p[torch.where(own, local, self.n_shard).to(p.device).long()].to(self.device)
            mask = own.reshape(own.shape + (1,) * (rows.dim() - own.dim()))
            out = rows if out is None else torch.where(mask, rows, out)
        return out

    def _owned(self, gids: torch.Tensor):
        """Per part: (part, mask of the ids it owns, their local rows)."""
        shard, local = self._locate(gids)
        keep = gids < len(self.parts) * self.n_shard
        for s, p in enumerate(self.parts):
            m = (shard == s) & keep
            yield p, m, local[m].to(p.device).long()

    def __setitem__(self, key, value: torch.Tensor) -> None:
        gids, cols = key if isinstance(key, tuple) else (key, None)
        for p, m, rows in self._owned(gids):
            if cols is None:
                p[rows] = value[m].to(p.device)
            else:
                p[rows, cols[m].to(p.device).long()] = value[m].to(p.device)

    def index_add_(self, dim: int, gids: torch.Tensor, value: torch.Tensor) -> "ShardedRows":
        if dim != 0:
            raise ValueError("ShardedRows adds along rows (dim 0) only")
        for p, m, rows in self._owned(gids):
            p.index_add_(0, rows, value[m].to(p.device))
        return self


def table(parts: Sequence[torch.Tensor], n_shard: int):
    """One part as itself, more as ``ShardedRows``."""
    return parts[0] if len(parts) == 1 else ShardedRows(parts, n_shard)


def table_parts(t) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """``(parts, n_shard)`` of a table: a one-device tensor of n + 1 rows is
    one part of n rows."""
    if isinstance(t, ShardedRows):
        return t.parts, t.n_shard
    return (t,), t.shape[0] - 1


def merge_lists(lists, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard ``(ids, d)`` lists, each ordered by (d, id), into the k
    best: the shard-major concatenation sorted stably on distance alone
    (``jax.lax.sort(..., num_keys=1)``), so ties keep shard order, which
    is global-id order.  Every list must be on one device."""
    if len(lists) == 1:
        ids, d = lists[0]
        return ids[:, :k], d[:, :k]
    ids = torch.cat([i for i, _ in lists], dim=1)
    d, order = torch.sort(torch.cat([d for _, d in lists], dim=1), dim=1, stable=True)
    return ids.gather(1, order[:, :k]), d[:, :k]


def _global(ids: torch.Tensor, d: torch.Tensor, s: int, n_shard: int, real: int, dev0: torch.device):
    """A shard's list in global ids on ``dev0``: local ids at or beyond the
    shard's ``real`` rows (sentinel, padding, empty slots -1) -> (-1, +inf)."""
    bad = (ids < 0) | (ids >= real)
    return (torch.where(bad, -1, ids + s * n_shard).to(dev0), torch.where(bad, INF, d).to(dev0))


def _query_tensor(queries, dim: int) -> torch.Tensor:
    return torch.from_numpy(pad_dim(np.asarray(queries, np.float32), dim))


# ---------------------------------------------------------------------------
# the sharded graph index
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedIndex:
    """S sub-indexes, shard s a ``GraphIndex`` on ``mesh[s]`` over its
    ``n_shard`` rows (local ids, sentinel ``n_shard``; global id ``s *
    n_shard + local``).  Every shard has the same widths and number of
    upper levels, so the JAX package's stacked ``(S, ...)`` arrays are the
    shards' tensors stacked (the properties below, on ``mesh[0]``)."""

    shards: Tuple[GraphIndex, ...]
    n_total: int
    mesh: Mesh

    @property
    def n_shard(self) -> int:
        return self.shards[0].n

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def _stack(self, get) -> torch.Tensor:
        return torch.stack([get(g).to(self.mesh[0]) for g in self.shards])

    @property
    def vectors(self) -> torch.Tensor:  # (S, n_shard + 1, D)
        return self._stack(lambda g: g.vectors)

    @property
    def norms(self) -> torch.Tensor:  # (S, n_shard + 1)
        return self._stack(lambda g: g.norms)

    @property
    def adj(self) -> torch.Tensor:  # (S, n_shard + 1, R)
        return self._stack(lambda g: g.adj_bottom)

    @property
    def start(self) -> torch.Tensor:  # (S,)
        return torch.tensor([g.starting_vertex for g in self.shards], dtype=torch.int32, device=self.mesh[0])

    @property
    def layer_slots(self) -> Tuple[torch.Tensor, ...]:  # each (S, n_shard + 1)
        return tuple(self._stack(lambda g, i=i: g.layers[i].slot) for i in range(len(self.shards[0].layers)))

    @property
    def layer_adjs(self) -> Tuple[torch.Tensor, ...]:  # each (S, nl_max + 1, Ru)
        return tuple(self._stack(lambda g, i=i: g.layers[i].adj) for i in range(len(self.shards[0].layers)))

    @property
    def packed(self) -> Optional[torch.Tensor]:  # (S, n_shard + 1, RS, D)
        return None if self.shards[0].layout is None else self._stack(lambda g: g.layout.packed)

    @property
    def packed_aux(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The JAX aux array's two rows, stacked: norms ``(S, n_shard + 1,
        R_tile)`` f32 and ids as plain int32 (the port has no f32 id
        carrier)."""
        if self.shards[0].layout is None:
            return None
        return self._stack(lambda g: g.layout.norms), self._stack(lambda g: g.layout.ids)


def build_sharded(x: np.ndarray, cfg: Optional[BuildConfig] = None, mesh=None) -> ShardedIndex:
    """Partition the corpus into contiguous row blocks and build one
    sub-index per shard on its device (sharded.py:94-191), one after
    another.  The last shard is padded with unreachable +inf-norm rows,
    its own sentinel ``local_n`` mapped to ``n_shard`` in the bottom and
    the upper adjacency; the upper levels are padded across shards."""
    cfg = cfg or BuildConfig()
    mesh = as_mesh(mesh)
    S = len(mesh)
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    ns = (n + S - 1) // S
    graphs, local_ns = [], []
    for s, dev in enumerate(mesh):
        part = x[s * ns : (s + 1) * ns]
        g = build_index(part, cfg, dev)
        local_n = part.shape[0]
        if local_n < ns:
            pad = ns - local_n
            D, R = g.vectors.shape[1], g.adj_bottom.shape[1]
            g.vectors = torch.cat([g.vectors[:local_n], torch.zeros((pad, D), device=dev), g.vectors[local_n:]])
            g.norms = torch.cat([g.norms[:local_n], torch.full((pad,), INF, device=dev), g.norms[local_n:]])
            a = torch.where(g.adj_bottom == local_n, ns, g.adj_bottom)
            g.adj_bottom = torch.cat([a[:local_n], torch.full((pad, R), ns, dtype=torch.int32, device=dev),
                                      a[local_n:]])
        graphs.append(g)
        local_ns.append(local_n)
    R = max(g.adj_bottom.shape[1] for g in graphs)
    for g in graphs:
        g.adj_bottom = torch.nn.functional.pad(g.adj_bottom, (0, R - g.adj_bottom.shape[1]), value=ns)

    # upper levels, padded to the most members and the widest degree of any
    # shard; a shard's own sentinel slot (n_l) and its padding rows map to
    # the common sentinel slot nl_max, its sentinel id local_n to n_shard
    n_levels = max(len(g.layers) for g in graphs)
    layers = [[] for _ in graphs]
    for lvl in range(n_levels):
        have = [g.layers[lvl] if lvl < len(g.layers) else None for g in graphs]
        nl_max = max(L.adj.shape[0] - 1 for L in have if L is not None)
        ru_max = max(L.adj.shape[1] for L in have if L is not None)
        for s, (L, dev) in enumerate(zip(have, mesh)):
            slots = torch.full((ns + 1,), nl_max, dtype=torch.int32, device=dev)
            adjs = torch.full((nl_max + 1, ru_max), ns, dtype=torch.int32, device=dev)
            if L is not None:
                n_l, ln = L.adj.shape[0] - 1, local_ns[s]
                slots[:ln] = torch.where(L.slot >= n_l, nl_max, L.slot)[:ln]
                adjs[:n_l, : L.adj.shape[1]] = torch.where(L.adj >= ln, ns, L.adj)[:n_l]
            layers[s].append(UpperLayer(slot=slots, adj=adjs))
    for g, ls in zip(graphs, layers):
        g.layers = tuple(ls)
    return ShardedIndex(shards=tuple(graphs), n_total=n, mesh=mesh)


def sharded_to_numpy(index: ShardedIndex) -> dict:
    """The JAX ``ShardedIndex``'s stacked arrays by their names, as host
    numpy (``layer_slots`` / ``layer_adjs`` one array a level), and
    ``n_total``.  The packed layout is derived, not carried
    (``pack_sharded``)."""
    return {
        "vectors": index.vectors.cpu().numpy(),
        "norms": index.norms.cpu().numpy(),
        "adj": index.adj.cpu().numpy(),
        "start": index.start.cpu().numpy(),
        "layer_slots": [t.cpu().numpy() for t in index.layer_slots],
        "layer_adjs": [t.cpu().numpy() for t in index.layer_adjs],
        "n_total": index.n_total,
    }


def sharded_from_numpy(arrays: dict, mesh) -> ShardedIndex:
    """A ShardedIndex on ``mesh`` from the arrays ``sharded_to_numpy``
    gives, or a JAX ``ShardedIndex``'s fields read into numpy under the
    same names: a JAX-built sharded index served by the port."""
    mesh = as_mesh(mesh)

    def part(name, s, dtype):
        return torch.from_numpy(np.array(arrays[name][s], dtype=dtype)).to(mesh[s])

    shards = []
    for s in range(len(mesh)):
        layers = tuple(
            UpperLayer(slot=torch.from_numpy(np.array(sl[s], np.int32)).to(mesh[s]),
                       adj=torch.from_numpy(np.array(al[s], np.int32)).to(mesh[s]))
            for sl, al in zip(arrays["layer_slots"], arrays["layer_adjs"])
        )
        shards.append(GraphIndex(vectors=part("vectors", s, np.float32), norms=part("norms", s, np.float32),
                                 adj_bottom=part("adj", s, np.int32), layers=layers,
                                 starting_vertex=int(arrays["start"][s])))
    return ShardedIndex(shards=tuple(shards), n_total=int(arrays["n_total"]), mesh=mesh)


def sharded_query_batch(index: ShardedIndex, queries: np.ndarray, k: int, ef: int, max_iters: int = 0) -> np.ndarray:
    """Replicated queries over the row-gather route (sharded.py:194-270):
    per shard greedy descent through its upper levels and ``beam_search``
    at ``ef = max(ef, k)`` (``max_iters = 8 max(ef, k) + 16`` by default),
    then the global top-k merge.  Returns ``(B, k)`` global ids, -1 where
    no id was found."""
    q = _query_tensor(queries, index.shards[0].vectors.shape[1])
    dev0, ns = index.mesh[0], index.n_shard
    lists = []
    for s, (g, dev) in enumerate(zip(index.shards, index.mesh)):
        ids, d, _ = query_batch(g, q.to(dev), k, ef, max_iters)
        lists.append(_global(ids, d, s, ns, ns, dev0))
    return merge_lists(lists, k)[0].cpu().numpy()


def pack_sharded(index: ShardedIndex, dtype: torch.dtype = torch.bfloat16) -> ShardedIndex:
    """A copy of ``index`` whose shards carry the packed-neighbour layout
    (``models/layout.Blocks``), each on its shard's device."""
    shards = tuple(dataclasses.replace(g, layout=Blocks.build(g, dtype)) for g in index.shards)
    return dataclasses.replace(index, shards=shards)


def sharded_packed_query(
    index: ShardedIndex,
    queries: np.ndarray,
    k: int,
    ef: int,
    expand: int = 1,
    cand: int = 8,
    qt: int = 8,
    max_iters: int = 0,
) -> np.ndarray:
    """Replicated queries over per-shard fused traversals
    (sharded.py:273-402): per shard greedy descent, a beam of width
    ``EF = roundup(max(ef, k), 128)`` seeded with the entry, the fused
    traversal (K1 on the card), an exact f32 rerank; then the global top-k
    merge.  Every shard's descent (its host syncs) runs first, then every
    shard's traversal and rerank are enqueued, then the merge is read back
    once.  ``qt`` is the JAX signature's; the port pads no batch."""
    if index.shards[0].layout is None:
        raise ValueError("call pack_sharded(index) first")
    ef = max(int(ef), k)
    EF = ef + (-ef) % 128
    if max_iters <= 0:
        max_iters = 8 * ef + 16
    q = _query_tensor(queries, index.shards[0].vectors.shape[1])
    dev0, ns = index.mesh[0], index.n_shard
    qs = [q.to(dev) for dev in index.mesh]
    seeds = [entry_beam(g, qd, EF, 0)[:2] for g, qd in zip(index.shards, qs)]
    lists = []
    for s, (g, qd, (bd0, bi0)) in enumerate(zip(index.shards, qs, seeds)):
        beam = g.layout.traverse(qd, bd0, bi0, ef, expand, cand, max_iters)[0]
        ids, d = rerank(g, qd, beam, k)
        lists.append(_global(ids, d, s, ns, ns, dev0))
    return merge_lists(lists, k)[0].cpu().numpy()


def sharded_candidates(v_parts, n_parts, wave: torch.Tensor, C: int, n_shard: int, mesh: Mesh):
    """The wave's exact top-C over the shards' corpora ``v_parts`` /
    ``n_parts`` (shard s on ``mesh[s]``): each shard's C best by (d, id)
    on its device, global ids (its sentinel row -1), the lists merged on
    ``mesh[0]`` by (d, id) (``num_keys=2``).  Returns ``(ids, d)`` (W, C)."""
    dev0 = mesh[0]
    lists = []
    for s, (v, nm, dev) in enumerate(zip(v_parts, n_parts, mesh)):
        w = wave.to(dev)
        d, idx = torch.sort(pairwise_dist2(w, v, x_norms=nm, q_norms=squared_norms(w)), dim=1, stable=True)
        idx = idx[:, :C]
        lists.append((torch.where(idx >= n_shard, -1, idx + s * n_shard).to(dev0), d[:, :C].to(dev0)))
    cat_d, cat_i = sort_rows(torch.cat([d for _, d in lists], 1), torch.cat([i for i, _ in lists], 1))
    return cat_i[:, :C], cat_d[:, :C]


def sharded_build_step(
    vectors,
    norms,
    wave,
    C: int,
    cap: int,
    ortho_factor: float,
    ortho_bias: float,
    prune_overflow: int,
    n_shard: int,
    mesh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One corpus-sharded candidate step and its prune (sharded.py:409-477).
    ``vectors`` / ``norms``: the shards' corpora ``(S, n_shard + 1, D)`` /
    ``(S, n_shard + 1)`` (a ShardedIndex's stacked views) or a sequence of
    per-shard tensors; shard s is used on ``mesh[s]``.  The wave's
    ``sharded_candidates``, the candidates' rows gathered from their shards
    and the anti-topo prune run on ``mesh[0]`` with sentinel ``S *
    n_shard``.  Returns the global ``(W, cap)`` ids and distances on
    ``mesh[0]``."""
    mesh = as_mesh(mesh)
    G = len(mesh) * n_shard
    wave = (wave if isinstance(wave, torch.Tensor) else torch.from_numpy(np.asarray(wave, np.float32))).float()
    v_parts = [vectors[s].to(dev) for s, dev in enumerate(mesh)]
    n_parts = [norms[s].to(dev) for s, dev in enumerate(mesh)]
    cand_ids, cand_d = sharded_candidates(v_parts, n_parts, wave, C, n_shard, mesh)
    real = cand_ids >= 0
    cvecs = ShardedRows(v_parts, n_shard)[torch.clamp_min(cand_ids, 0)]
    cnorms = torch.where(real & torch.isfinite(cand_d), squared_norms(cvecs), INF)
    co = pairwise_co_dist(cvecs, cnorms)
    return antitopo_prune(torch.where(real, cand_ids, G).to(torch.int32), torch.where(real, cand_d, INF), co, cap,
                          float(ortho_factor), float(ortho_bias), int(prune_overflow), G)


def _replicas(graph: GraphIndex, mesh: Mesh) -> dict:
    """The graph on every distinct device of the mesh, copied once to each
    device it is not on."""
    out = {}
    for dev in mesh:
        if dev in out:
            continue
        if graph.vectors.device == dev:
            out[dev] = graph
            continue
        moved = {f.name: getattr(graph, f.name).to(dev) for f in dataclasses.fields(graph)
                 if isinstance(getattr(graph, f.name), torch.Tensor)}
        layers = tuple(UpperLayer(slot=L.slot.to(dev), adj=L.adj.to(dev)) for L in graph.layers)
        layout = None if graph.layout is None else graph.layout.to(dev)
        out[dev] = dataclasses.replace(graph, layers=layers, layout=layout, **moved)
    return out


def _data_parallel(graph: GraphIndex, queries, mesh, serve) -> np.ndarray:
    """``serve(replica, q_slice)`` on S near-equal slices of the batch, slice
    s on ``mesh[s]``; the ids concatenated in batch order."""
    mesh = as_mesh(mesh)
    reps = _replicas(graph, mesh)
    q = _query_tensor(queries, graph.vectors.shape[1])
    outs = [serve(reps[dev], qs.to(dev)).to(mesh[0])
            for dev, qs in zip(mesh, torch.tensor_split(q, len(mesh))) if qs.shape[0]]
    return torch.cat(outs).cpu().numpy()


def replicated_fused_query_dp(
    graph: GraphIndex,
    queries: np.ndarray,
    k: int,
    ef,
    mesh=None,
    expand: int = 2,
    cand: int = 16,
    qt: int = 8,
    seeds: int = 0,
    ef_cap: int = 128,
) -> np.ndarray:
    """Data-parallel serving over the fused traversal (sharded.py:487-559):
    the graph (with its packed layout) on every device of the mesh, the
    batch split into S near-equal slices, ``fused_query_batch`` (K1 on the
    card) on each.  K1 ends each query on its own, so the ids equal one
    ``fused_query_batch`` call on the whole batch.  ``qt`` is the JAX
    signature's; the port pads no batch."""
    if graph.layout is None:
        raise ValueError("graph has no serving layout")
    return _data_parallel(graph, queries, mesh, lambda g, q: fused_query_batch(
        g, q, ef, k, ef_cap=ef_cap, expand=expand, cand=cand, seeds=seeds)[0])


def replicated_query_dp(graph: GraphIndex, queries: np.ndarray, k: int, ef: int, mesh=None) -> np.ndarray:
    """Data-parallel serving over the row-gather route ``query_batch``
    (sharded.py:562-591; superseded there by the fused variant)."""
    return _data_parallel(graph, queries, mesh, lambda g, q: query_batch(g, q, k, ef)[0])


# ---------------------------------------------------------------------------
# the sharded flat corpus
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedFlat:
    """Row-sharded bf16 corpus for the flat scan: shard s, on ``mesh[s]``,
    holds global rows ``s * n_shard`` onward, unpadded (the last shard may
    hold fewer)."""

    x: Tuple[torch.Tensor, ...]  # each (rows, D_pad) bf16
    n_shard: int
    n_total: int
    mesh: Mesh


def build_sharded_flat(x: np.ndarray, mesh=None) -> ShardedFlat:
    """One bf16 corpus per shard on its device (sharded.py:594-629), the
    features zero-padded to a multiple of 128, the rows not padded."""
    mesh = as_mesh(mesh)
    x = pad_dim(np.asarray(x, np.float32), LANE)
    n = x.shape[0]
    ns = (n + len(mesh) - 1) // len(mesh)
    parts = tuple(torch.from_numpy(x[s * ns : (s + 1) * ns]).to(dev, torch.bfloat16) for s, dev in enumerate(mesh))
    return ShardedFlat(x=parts, n_shard=ns, n_total=n, mesh=mesh)


def sharded_flat_query(index: ShardedFlat, queries: np.ndarray, k: int) -> np.ndarray:
    """Replicated queries, the flat top-k scan per shard (K2 on the card,
    every shard's launch enqueued before any read-back), the global top-k
    merge (sharded.py:632-696).  Slots beyond a shard's real rows are
    (-1, +inf)."""
    q = _query_tensor(queries, index.x[0].shape[1])
    dev0 = index.mesh[0]
    lists = []
    for s, (xs, dev) in enumerate(zip(index.x, index.mesh)):
        if xs.shape[0]:
            ids, d = flat_topk(q.to(dev), xs, k)
            lists.append(_global(ids, d, s, index.n_shard, xs.shape[0], dev0))
    return merge_lists(lists, k)[0].cpu().numpy()
