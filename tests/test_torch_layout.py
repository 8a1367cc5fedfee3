"""The serving layout an engine holds (``models/layout.py``): the type
``choose`` names under the packed budget, built on the first query, and
dropped with its captured beams when the block dtype changes."""

import gc
import weakref

import numpy as np
import pytest
import torch

from expann_tpu_torch.models import antitopo
from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu_torch.models.layout import Blocks, CodeBlocks, CodeRows, Rows
from expann_tpu_torch.ops.packed import code_rows_bytes, rows_bytes

torch.set_num_threads(2)

K = 10
NONE = type(None)  # no layout: the gather route


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(4)
    return rng.standard_normal((1200, 32)).astype(np.float32), rng.standard_normal((20, 32)).astype(np.float32)


# (packed_dtype, budget, layout): the real budget admits both block types;
# a budget of the bf16 rows' bytes admits bf16 rows or s8 code rows; one
# below the code rows' bytes admits no s8 layout
CASES = [("bf16", "real", Blocks), ("i8", "real", CodeBlocks), ("bf16", "rows", Rows), ("i8", "below", NONE),
         ("i8", "rows", CodeRows)]


@pytest.mark.parametrize("dtype,budget,kind", CASES, ids=["blocks", "code_blocks", "rows", "none", "code_rows"])
def test_engine_holds_the_chosen_layout(small, monkeypatch, dtype, budget, kind):
    """After the first query the graph holds the layout the budget admits;
    ``set_packed_dtype`` clears it at once, and with it the captured beams
    it kept, and the next query builds the other dtype's layout."""
    x, q = small
    cfg = AntitopoConfig(M=8, ef_construction=40, prune_cand=40, query_expand=2, fused_cand=8, ef_search=40,
                         packed_dtype=dtype, use_packed=True, use_fused=True)
    eng = AntitopoEngine(config=cfg, device="cpu")
    eng.store_many_vectors(x)
    eng.build()
    g = eng.graph
    if budget == "rows":
        monkeypatch.setattr(antitopo, "PACKED_BUDGET_BYTES", rows_bytes(g.vectors.shape[0], g.vectors.shape[1]))
    elif budget == "below":
        monkeypatch.setattr(antitopo, "PACKED_BUDGET_BYTES", code_rows_bytes(g.vectors.shape[0], g.vectors.shape[1]) - 1)
    assert g.layout is None
    ids = eng.query_k_batch(q, K)
    assert type(g.layout) is kind
    assert ids.shape == (q.shape[0], K) and all(len(set(row.tolist())) == K for row in ids)
    rows = kind in (Rows, CodeRows)
    assert (g.packed is not None) == (kind in (Blocks, CodeBlocks)) and (g.packed_rows is not None) == rows
    assert (eng.num_rows_gathered > 0) == rows
    if kind is NONE:
        return
    built = weakref.ref(g.layout)
    beams = None
    if kind is Blocks:  # a stand-in for a captured beam, which lives in the layout's cache
        beams = type("Captured", (), {})()
        g.layout.beam_graphs["probe"] = beams
        beams = weakref.ref(beams)
    eng.set_packed_dtype("i8" if dtype == "bf16" else "bf16")
    assert g.layout is None
    gc.collect()
    assert built() is None and (beams is None or beams() is None)
    eng.query_k_batch(q[:4], K)
    assert type(g.layout) is {Blocks: CodeBlocks, CodeBlocks: Blocks, Rows: CodeRows, CodeRows: Rows}[kind]
