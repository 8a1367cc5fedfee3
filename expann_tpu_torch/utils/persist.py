"""Index persistence in the JAX package's npz format (``format_version`` 1,
expann_tpu/utils/persist.py): one ``.npz`` of named arrays plus a JSON
header.  An index built by either package loads in the other.  Search-time
params and the serving layout are not persisted (reference:
src/antitopo_engine.h:930-1074)."""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from expann_tpu_torch.models.graph import GraphIndex, UpperLayer
from expann_tpu_torch.models.layout import CodeBlocks

FORMAT_VERSION = 1
# derived arrays ``graph_from_numpy`` also takes (never persisted): uint8
# codes, the s8 packed layout and its query transform, each with its dtype
DERIVED = {
    "codes": np.uint8,
    "code_norms": np.float32,
    "quant_scale": np.float32,
    "quant_offset": np.float32,
    "packed": np.int8,
    "packed_norms": np.float32,
    "packed_ids": np.int32,
    "packed_codes": np.int8,
    "packed_code_norms": np.float32,
    "packed_center": np.float32,
    "packed_scale": np.float32,
}
CODE_BLOCKS = [name for name in DERIVED if name.startswith("packed")]  # in CodeBlocks' field order


def graph_to_numpy(graph: GraphIndex) -> Dict[str, np.ndarray]:
    """The persisted arrays of ``graph`` as host numpy arrays."""
    arrays = {
        "vectors": graph.vectors.cpu().numpy(),
        "norms": graph.norms.cpu().numpy(),
        "adj_bottom": graph.adj_bottom.cpu().numpy(),
        "starting_vertex": np.asarray(graph.starting_vertex, np.int32),
    }
    for i, layer in enumerate(graph.layers):
        arrays[f"layer{i}_slot"] = layer.slot.cpu().numpy()
        arrays[f"layer{i}_adj"] = layer.adj.cpu().numpy()
    return arrays


def graph_from_numpy(arrays: Dict[str, np.ndarray], device) -> GraphIndex:
    """Rebuild a GraphIndex on ``device`` from the persisted arrays (keys
    as written by ``save_index`` of either package), plus any ``DERIVED``
    arrays given, so that a graph can carry another package's codes and s8
    layout (``CodeBlocks``; ``packed_ids`` as plain int32 ids)."""

    def dev(name, dtype):
        return torch.from_numpy(np.array(arrays[name], dtype=dtype)).to(device)

    num_layers = sum(1 for key in arrays if key.endswith("_slot"))
    layers = tuple(
        UpperLayer(slot=dev(f"layer{i}_slot", np.int32), adj=dev(f"layer{i}_adj", np.int32))
        for i in range(num_layers)
    )
    derived = {name: dev(name, dtype) for name, dtype in DERIVED.items() if arrays.get(name) is not None}
    layout = CodeBlocks(*(derived.pop(name) for name in CODE_BLOCKS)) if "packed" in derived else None
    return GraphIndex(
        vectors=dev("vectors", np.float32),
        norms=dev("norms", np.float32),
        adj_bottom=dev("adj_bottom", np.int32),
        layers=layers,
        starting_vertex=int(arrays["starting_vertex"]),
        layout=layout,
        **derived,
    )


def save_index(filename: str, graph: GraphIndex, meta: Dict | None = None) -> None:
    directory = os.path.dirname(filename)
    if directory:
        os.makedirs(directory, exist_ok=True)
    arrays = graph_to_numpy(graph)
    header = {
        "format_version": FORMAT_VERSION,
        "num_layers": len(graph.layers),
        "meta": meta or {},
    }
    arrays["header"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8).copy()
    np.savez(filename, **arrays)
    # np.savez appends .npz; normalize to the requested name.
    if not filename.endswith(".npz") and os.path.exists(filename + ".npz"):
        os.replace(filename + ".npz", filename)


def load_index(filename: str, device) -> Tuple[GraphIndex, Dict]:
    with np.load(filename) as z:
        header = json.loads(bytes(z["header"]).decode())
        if header["format_version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported index format {header['format_version']}")
        arrays = {key: z[key] for key in z.files if key != "header"}
    return graph_from_numpy(arrays, device), header["meta"]


def index_exists(filename: str) -> bool:
    return os.path.exists(filename)
