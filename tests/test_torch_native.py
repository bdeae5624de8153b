"""The port's native host parser and codecs (`similaritysearchbyrdf_tpu_torch/native`),
built with g++ on first use into `build/native/<source hash>/`: its output
equals the Python parsers' and the golden bytes, the port's readers take it,
and a missing file falls back as in the JAX package."""

import os

import numpy as np
import pytest

from similaritysearchbyrdf_tpu_torch import vectors as V
from similaritysearchbyrdf_tpu_torch.native import loader
from similaritysearchbyrdf_tpu_torch.storage import serializers as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")


@pytest.fixture(scope="module")
def lib():
    """This machine has g++: the library must build, not fall back."""
    lib = loader.library()
    assert lib is not None, f"the native library did not build: {loader.last_build_log}"
    assert loader.built
    path = loader.library_path()
    assert path.exists() and path.parent.parent == loader.BUILD_ROOT
    assert loader.BUILD_ROOT.parts[-2:] == ("build", "native")
    assert not any(p.suffix == ".so" for p in (loader.SOURCES[0].parent).iterdir())
    return lib


def _dense_file(tmp_path, n=500, d=24):
    x = np.random.default_rng(0).normal(size=(n, d))
    p = tmp_path / "dense.txt"
    p.write_text("\n".join(f"[{i},[{','.join(repr(float(v)) for v in x[i])}]]"
                           for i in range(n)))
    return str(p)


@pytest.mark.parametrize("limit", [None, 1, 137])
def test_dense_native_matches_python(tmp_path, lib, limit):
    path = _dense_file(tmp_path)
    calls = loader.CALLS
    ids, values = loader.load_dense_file(path, limit)
    assert loader.CALLS == calls + 1
    py = V.load_dense_file(path, limit, use_native=False)
    np.testing.assert_array_equal(ids, py.ids)
    np.testing.assert_array_equal(values, py.values)


def test_dense_reader_takes_the_native_path(tmp_path, lib):
    path = _dense_file(tmp_path, n=50)
    calls = loader.CALLS
    batch = V.load_dense_file(path)
    assert loader.CALLS == calls + 1, "load_dense_file did not take the native path"
    py = V.load_dense_file(path, use_native=False)
    assert loader.CALLS == calls + 1
    np.testing.assert_array_equal(batch.ids, py.ids)
    np.testing.assert_array_equal(batch.values, py.values)


def test_sparse_native_matches_python(tmp_path, lib):
    lines = ["(0,8,[0,2,5],[1.0,2.0,3.0])", "(1,8,[1],[4.0])", "(2,8,[3,4],[5.5,6.5])"]
    p = tmp_path / "s.txt"
    p.write_text("\n".join(lines))
    ids, size, idx, val, lengths = loader.load_sparse_file(str(p))
    py = V.load_sparse_file(str(p))
    assert size == py.size == 8
    np.testing.assert_array_equal(ids, py.ids)
    np.testing.assert_array_equal(lengths, py.lengths)
    for i, n in enumerate(lengths):
        np.testing.assert_array_equal(idx[i, :n], py.indices[i, :n])
        np.testing.assert_array_equal(val[i, :n], py.values[i, :n])


def test_sparse_fixture_native_matches_python(lib):
    path = os.path.join(FIX, "sparsevectorfile")
    ids, size, idx, val, lengths = loader.load_sparse_file(path)
    py = V.load_sparse_file(path)
    assert size == py.size
    np.testing.assert_array_equal(ids, py.ids)
    np.testing.assert_array_equal(lengths, py.lengths)
    np.testing.assert_array_equal(val[:, :lengths.max()], py.values[:, :lengths.max()])


def test_batch_codecs_give_the_golden_bytes(lib):
    """Each golden record encoded as a batch of one by the native codecs,
    and the golden files decoded whole by them."""
    dense = [(3, [1.0, 2.0, 3.0]), (4, [4.0, 5.0, 6.0]),
             (2**31 - 1, [-0.3333333333333333, 1e300])]
    sparse = [(3, 3, [0, 1, 2], [1.0, 2.0, 3.0]), (5, 2, [0, 1], [1.0, 2.0]),
              (7, 1 << 20, [(1 << 20) - 1], [-2.5])]
    golden_d = open(os.path.join(FIX, "densevectors_golden.bin"), "rb").read()
    golden_s = open(os.path.join(FIX, "sparsevectors_golden.bin"), "rb").read()
    calls = loader.CALLS
    enc_d = b"".join(loader.encode_dense_batch(np.array([i], np.int32), np.array([v]))
                     for i, v in dense)
    enc_s = b"".join(loader.encode_sparse_batch(np.array([i], np.int32), size,
                                                np.array([ix], np.int32), np.array([v]),
                                                np.array([len(ix)], np.int32))
                     for i, size, ix, v in sparse)
    assert loader.CALLS == calls + 6
    assert enc_d == golden_d and enc_s == golden_s
    ids, values = loader.decode_dense_batch(golden_d[:2 * (8 + 3 * 8)])
    np.testing.assert_array_equal(ids, [3, 4])
    np.testing.assert_array_equal(values, [v for _, v in dense[:2]])
    ids, _, idx, val, lengths = loader.decode_sparse_batch(golden_s)
    np.testing.assert_array_equal(ids, [3, 5, 7])
    np.testing.assert_array_equal(lengths, [3, 2, 1])
    for row, (_, _, ix, v) in enumerate(sparse):
        np.testing.assert_array_equal(idx[row, :len(ix)], ix)
        np.testing.assert_array_equal(val[row, :len(v)], v)


def test_native_missing_file(lib):
    assert loader.load_dense_file("/nonexistent/x.txt") is None
    assert loader.load_sparse_file("/nonexistent/x.txt") is None
    with pytest.raises(FileNotFoundError):
        V.load_dense_file("/nonexistent/x.txt")


def test_no_compiler_falls_back_to_python(tmp_path, monkeypatch):
    """Without a compiler the library is not built, the build log says why,
    and the readers and codecs run their Python versions."""
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_build_failed", False)
    monkeypatch.setattr(loader, "built", False)
    monkeypatch.setattr(loader, "BUILD_ROOT", tmp_path / "build" / "native")
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert loader.library() is None and not loader.built
    assert "no C++ compiler" in loader.last_build_log
    path = _dense_file(tmp_path, n=20)
    calls = loader.CALLS
    batch = V.load_dense_file(path)
    assert loader.CALLS == calls and batch.values.shape == (20, 24)
    ids = np.arange(3, dtype=np.int32)
    vals = np.ones((3, 2))
    assert S.serialize_dense_batch(ids, vals) == b"".join(
        S.serialize_dense_vector(i, vals[i]) for i in range(3))
    assert loader.CALLS == calls
