"""The port's native reader (utils/io_native.py, built from
native/expann_io.cpp into build/native/) against the JAX package's reader
and blob IO on the same files."""

import numpy as np
import pytest

from expann_tpu.data.loader import read_vecs as j_read_vecs
from expann_tpu.utils import io_native as j_io
from expann_tpu_torch.data.loader import read_vecs, read_vecs_numpy
from expann_tpu_torch.utils import io_native


def _write_vecs(path, mat):
    n, d = mat.shape
    rec = np.empty((n, d + 1), np.int32)
    rec[:, 0] = d
    rec[:, 1:] = mat.view(np.int32)
    rec.tofile(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("vecs")
    x = rng.standard_normal((257, 24)).astype(np.float32)
    ids = rng.integers(-5, 1 << 30, (31, 100)).astype(np.int32)
    _write_vecs(root / "x.fvecs", x)
    _write_vecs(root / "gt.ivecs", ids)
    return root, x, ids


def test_native_library_builds_outside_the_tracked_binary():
    assert io_native.native_available()
    lib = io_native._load()
    assert "build/native/" in lib._name and lib._name.endswith(".so")


@pytest.mark.parametrize("name,dtype", [("x.fvecs", np.float32), ("gt.ivecs", np.int32), ("gt.ivecs", np.int64)])
def test_native_reader_matches_jax_reader(files, name, dtype):
    """Byte for byte, and the loader's ``read_vecs`` took the native reader."""
    root, x, ids = files
    before = io_native.reads
    got = read_vecs(str(root / name), dtype)
    assert io_native.reads == before + 1
    want = j_read_vecs(str(root / name), dtype)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == read_vecs_numpy(str(root / name), dtype).tobytes()
    ref = x if name.endswith("fvecs") else ids.astype(dtype)
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize(
    "content,jax_raises",
    [(b"", True), (np.asarray([4, 1, 2, 3, 4, 4, 1], np.int32).tobytes(), True),
     (b"\x00\x00\x00\x00", False), (np.asarray([2, 1, 2, 3, 5, 6], np.int32).tobytes(), False)],
    ids=["empty", "ragged", "zero_dim", "wrong_record_dim"],
)
def test_bad_files_raise_ioerror_as_jax(tmp_path, content, jax_raises):
    """An empty or ragged file raises IOError in both packages.  The port
    does not fall back to numpy on a file its native reader rejects, so a
    zero dimension or a record whose own dimension differs raises too,
    where the JAX loader's numpy fallback returns an array."""
    path = tmp_path / "bad.fvecs"
    path.write_bytes(content)
    with pytest.raises(IOError):
        read_vecs(str(path))
    if jax_raises:
        with pytest.raises(IOError):
            j_read_vecs(str(path))
    else:
        j_read_vecs(str(path))


def test_missing_file_raises(tmp_path):
    with pytest.raises(IOError):
        read_vecs(str(tmp_path / "absent.fvecs"))


@pytest.mark.parametrize("dtype,shape", [(np.float32, (33, 7)), (np.int32, (5,)), (np.uint8, (3, 4, 5))])
def test_blob_round_trips_match_jax(tmp_path, dtype, shape):
    rng = np.random.default_rng(1)
    arr = (rng.standard_normal(shape) * 100).astype(dtype)
    ours, theirs = str(tmp_path / "ours.bin"), str(tmp_path / "theirs.bin")
    assert io_native.native_blob_write(ours, arr)
    assert j_io.native_blob_write(theirs, arr)
    assert open(ours, "rb").read() == open(theirs, "rb").read() == arr.tobytes()
    np.testing.assert_array_equal(io_native.native_blob_read(theirs, shape, dtype), arr)
    np.testing.assert_array_equal(j_io.native_blob_read(ours, shape, dtype), arr)
    with pytest.raises(IOError):
        io_native.native_blob_read(ours, (shape[0] + 1,) + shape[1:], dtype)
