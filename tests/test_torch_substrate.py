"""The port's substrate against the JAX package on the same numpy inputs:
distance functions, the corpus layout, the shared index file, the packed
serving layout, and an import of the port that loads no JAX."""

import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from expann_tpu.models.build import BuildConfig as JBuildConfig
from expann_tpu.models.build import build_index as j_build_index
from expann_tpu.models.graph import make_corpus as j_make_corpus
from expann_tpu.ops import distance as jdist
from expann_tpu.ops.pallas_beam import build_packed as j_build_packed
from expann_tpu.ops.pallas_beam import decode_ids_f32
from expann_tpu.utils.persist import save_index as j_save_index
from expann_tpu_torch.models.graph import make_corpus
from expann_tpu_torch.ops import distance as tdist
from expann_tpu_torch.ops.packed import build_packed
from expann_tpu_torch.utils.persist import graph_to_numpy, load_index, save_index

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_graph():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((500, 32)).astype(np.float32)
    return j_build_index(x, JBuildConfig(M=12, ef_construction=60, seed=0))


def test_pad_helpers_match():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((13, 37)).astype(np.float32)
    np.testing.assert_array_equal(tdist.pad_dim(x), jdist.pad_dim(x))
    np.testing.assert_array_equal(tdist.pad_dim(torch.from_numpy(x)).numpy(), np.asarray(jdist.pad_dim(jnp.asarray(x))))
    np.testing.assert_array_equal(tdist.pad_rows(x, fill=-1), jdist.pad_rows(x, fill=-1))
    np.testing.assert_array_equal(
        tdist.pad_rows(torch.from_numpy(x), fill=-1).numpy(), np.asarray(jdist.pad_rows(jnp.asarray(x), fill=-1))
    )


def test_distances_match():
    """f32 throughout; the two libraries sum the products in another order,
    so values agree to rtol 1e-6 (a few ulps), not bitwise."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((16, 128)).astype(np.float32)
    x = rng.standard_normal((300, 128)).astype(np.float32)
    nb = rng.standard_normal((16, 40, 128)).astype(np.float32)
    nbn = (nb * nb).sum(-1)
    np.testing.assert_allclose(
        tdist.squared_norms(torch.from_numpy(x)).numpy(), np.asarray(jdist.squared_norms(jnp.asarray(x))), rtol=1e-6
    )
    np.testing.assert_allclose(
        tdist.pairwise_dist2(torch.from_numpy(q), torch.from_numpy(x)).numpy(),
        np.asarray(jdist.pairwise_dist2(jnp.asarray(q), jnp.asarray(x))),
        rtol=1e-6, atol=1e-4,
    )
    np.testing.assert_allclose(
        tdist.batched_neighbour_dist2(torch.from_numpy(q), torch.from_numpy(nb), torch.from_numpy(nbn)).numpy(),
        np.asarray(jdist.batched_neighbour_dist2(jnp.asarray(q), jnp.asarray(nb), jnp.asarray(nbn))),
        rtol=1e-6, atol=1e-4,
    )


def test_make_corpus_matches():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((50, 20)).astype(np.float32)
    v, nrm = make_corpus(x, "cpu")
    jv, jn = j_make_corpus(x)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # exact: both sum the same 20 nonzero squares of each row in f32
    np.testing.assert_allclose(nrm.numpy(), np.asarray(jn), rtol=1e-6)
    assert np.isinf(nrm[-1].item()) and np.isinf(np.asarray(jn)[-1])


def test_jax_index_file_loads_identically(jax_graph, tmp_path):
    path = str(tmp_path / "jax_index.npz")
    j_save_index(path, jax_graph, {"dim": 32})
    g, meta = load_index(path, "cpu")
    assert meta == {"dim": 32}
    np.testing.assert_array_equal(g.vectors.numpy(), np.asarray(jax_graph.vectors))
    np.testing.assert_array_equal(g.norms.numpy(), np.asarray(jax_graph.norms))
    np.testing.assert_array_equal(g.adj_bottom.numpy(), np.asarray(jax_graph.adj_bottom))
    assert g.starting_vertex == int(jax_graph.starting_vertex)
    assert len(g.layers) == len(jax_graph.layers) > 0
    for a, b in zip(g.layers, jax_graph.layers):
        np.testing.assert_array_equal(a.slot.numpy(), np.asarray(b.slot))
        np.testing.assert_array_equal(a.adj.numpy(), np.asarray(b.adj))
    # and the port writes the same arrays back
    path2 = str(tmp_path / "port_index.npz")
    save_index(path2, g, meta)
    g2, _ = load_index(path2, "cpu")
    for key, val in graph_to_numpy(g).items():
        np.testing.assert_array_equal(graph_to_numpy(g2)[key], val)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_build_packed_matches(jax_graph, dtype):
    """Ids and norms exact, blocks bitwise (both round f32 -> bf16 to
    nearest-even).  The JAX aux carries ids as biased f32 bit patterns."""
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}[dtype]
    g_v, g_n, g_a = (np.array(jax_graph.vectors), np.array(jax_graph.norms), np.array(jax_graph.adj_bottom))
    packed, pnorms, pids = build_packed(torch.from_numpy(g_v), torch.from_numpy(g_n), torch.from_numpy(g_a), dtype=tdt)
    jpacked, jaux = j_build_packed(jax_graph.vectors, jax_graph.norms, jax_graph.adj_bottom, dtype=jdt)
    jaux = np.asarray(jaux)
    np.testing.assert_array_equal(pids.numpy(), np.asarray(decode_ids_f32(jnp.asarray(jaux[:, 1]))))
    np.testing.assert_array_equal(pnorms.numpy(), jaux[:, 0])
    if dtype == "bf16":
        np.testing.assert_array_equal(
            packed.view(torch.int16).numpy(), np.asarray(jpacked).astype(ml_dtypes.bfloat16).view(np.int16)
        )
    else:
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))


def test_port_imports_no_jax():
    """Every module of the port imports without loading JAX or the JAX
    package."""
    code = (
        "import importlib, pkgutil, sys, expann_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(expann_tpu_torch.__path__, 'expann_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "assert len(names) >= 58, names\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'expann_tpu.')) or m == 'expann_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
