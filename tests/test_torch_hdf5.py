"""The port's HDF5 reader and writer (``prosper_tpu_torch/io/hdf5.py``)
against h5py: each reads the other's files, values, dtypes, shapes and
attributes alike, through appends that grow the chunk B-tree over several
levels, rewinds, ``"a"`` mode and a writer that was never closed."""

import h5py
import numpy as np
import pytest

from prosper_tpu_torch.io import hdf5

DTYPES = ["f2", "f4", "f8", "i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8",
          "S5"]
SHAPES = [(), (5,), (3, 4), (2, 3, 4)]


def _values(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if dtype.startswith("S"):
        words = np.array([b"ab", b"cde", b"", b"fghij"], dtype)
        return words[rng.integers(0, 4, shape)]
    if dtype.startswith("f"):
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype,
                        endpoint=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_h5py_reads_what_is_written_here(tmp_path, dtype):
    p = tmp_path / "a.h5"
    with hdf5.File(p, "w") as f:
        f.attrs["step"] = 7
        f.attrs["name"] = "cuda"
        f.attrs["vec"] = np.arange(3.0)
        g = f.create_group("params")
        for shape in SHAPES:
            g.create_dataset(f"d{len(shape)}", data=_values(dtype, shape))
        f.create_group("a/b/c").create_dataset("x", data=np.int64(5))
    with h5py.File(p, "r") as f:
        assert f.attrs["step"] == 7 and f.attrs["name"] == b"cuda"
        np.testing.assert_array_equal(f.attrs["vec"], np.arange(3.0))
        for shape in SHAPES:
            got = f["params"][f"d{len(shape)}"]
            assert got.shape == shape and got.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(got[()], _values(dtype, shape))
        assert f["a/b/c/x"][()] == 5
        assert sorted(f) == ["a", "params"]


@pytest.mark.parametrize("layout", ["contiguous", "chunked", "gzip",
                                    "shuffle_gzip", "fletcher32",
                                    "extendable"])
def test_h5py_files_read_here(tmp_path, layout):
    p = tmp_path / "b.h5"
    kw = {"contiguous": {}, "chunked": {"chunks": (3, 2)},
          "gzip": {"chunks": (4, 3), "compression": "gzip"},
          "shuffle_gzip": {"chunks": (5, 5), "compression": "gzip",
                           "shuffle": True},
          "fletcher32": {"chunks": (2, 7), "fletcher32": True},
          "extendable": {"maxshape": (None, 7), "chunks": (1, 7)}}[layout]
    a = _values("f4", (11, 7), seed=3)
    with h5py.File(p, "w") as f:
        f.create_dataset("y", data=a, **kw)
        f["y"].attrs["label"] = "patches"          # a variable-length str
        f["y"].attrs["fixed"] = np.bytes_("abc")
        f["y"].attrs["scale"] = np.float32(0.5)
        f.create_dataset("s", data=np.float64(2.5))
    with hdf5.File(p) as f:
        y = f["y"]
        assert y.shape == a.shape and y.dtype == np.float32 and y.ndim == 2
        np.testing.assert_array_equal(np.asarray(y), a)
        np.testing.assert_array_equal(y[2:9], a[2:9])
        np.testing.assert_array_equal(y[-1], a[-1])
        np.testing.assert_array_equal(y[4, 1:3], a[4, 1:3])
        assert y.attrs == {"label": "patches", "fixed": "abc", "scale": 0.5}
        assert f["s"][()] == 2.5 and "s" in f and "t" not in f


def _append(ds, value):
    ds.resize(ds.shape[0] + 1, axis=0)
    ds[-1] = value


def test_appends_grow_the_chunk_tree(tmp_path):
    """Row-chunked appends past one B-tree leaf (64 chunks) and past one
    level of leaves (4096 chunks), read back by h5py and here, whole and by
    slices."""
    p = tmp_path / "c.h5"
    with hdf5.File(p, "w") as f:
        W = f.create_dataset("W", shape=(0, 3, 2), dtype=np.float32,
                             maxshape=(None, 3, 2), chunks=(1, 3, 2))
        for i in range(150):
            _append(W, np.full((3, 2), i, np.float32))
        s = f.create_dataset("F", shape=(0,), dtype=np.float64,
                             maxshape=(None,), chunks=(1,))
        for i in range(4200):
            _append(s, i / 4)
        with h5py.File(p) as g:
            np.testing.assert_array_equal(g["F"][()], np.arange(4200) / 4)
        with hdf5.File(p) as g:
            np.testing.assert_array_equal(g["F"][4090:4110],
                                          np.arange(4090, 4110) / 4)
        s.resize(30, axis=0)                    # back to one leaf, regrown
        for i in range(30, 200):
            _append(s, -i)
    F = np.concatenate([np.arange(30) / 4, -np.arange(30, 200)])
    with h5py.File(p) as f:
        assert f["W"].maxshape == (None, 3, 2) and f["W"].chunks == (1, 3, 2)
        np.testing.assert_array_equal(f["W"][:, 0, 0], np.arange(150))
        np.testing.assert_array_equal(f["F"][()], F)
    with hdf5.File(p) as f:
        np.testing.assert_array_equal(f["W"][70:90, 2, 1], np.arange(70, 90))
        np.testing.assert_array_equal(f["F"][20:80], F[20:80])
        assert f["F"].maxshape == (None,)


def test_append_mode_rewinds_and_extends(tmp_path):
    """A file h5py wrote, opened here in "a", rewound and appended to; then
    extended by h5py and read here: every row where it belongs, rows past a
    rewind read as zeros until written."""
    p = tmp_path / "d.h5"
    with h5py.File(p, "w") as f:
        f.attrs["step"] = 3
        d = f.create_dataset("F", shape=(0,), maxshape=(None,),
                             chunks=(1024,), dtype=np.float32)
        for i in range(10):
            _append(d, i)
        f.create_dataset("W", data=np.ones((2, 2)))
    with hdf5.File(p, "a") as f:
        F = f["F"]
        F.resize(4, axis=0)
        F.resize(6, axis=0)
        F[5] = 50.0
        _append(F, 60.0)
        f.create_dataset("extra", data=np.arange(3))
    with h5py.File(p, "a") as f:
        np.testing.assert_array_equal(f["F"][()], [0, 1, 2, 3, 0, 50, 60])
        assert f.attrs["step"] == 3 and f["W"].shape == (2, 2)
        _append(f["F"], 70.0)
    with hdf5.File(p) as f:
        np.testing.assert_array_equal(np.asarray(f["F"]),
                                      [0, 1, 2, 3, 0, 50, 60, 70])
        np.testing.assert_array_equal(f["extra"][()], np.arange(3))


def test_an_unclosed_writer_leaves_every_row_readable(tmp_path):
    p = tmp_path / "e.h5"
    f = hdf5.File(p, "w")
    d = f.create_dataset("F", shape=(0, 2), dtype=np.float32,
                         maxshape=(None, 2), chunks=(1, 2))
    for i in range(5):
        _append(d, [i, -i])
    with h5py.File(p) as g:                       # the writer is still open
        np.testing.assert_array_equal(g["F"][:, 0], np.arange(5))
    f.close()


def test_limits_and_errors(tmp_path):
    p = tmp_path / "f.h5"
    with hdf5.File(p, "w") as f:
        for i in range(64):
            f.create_dataset(f"x{i:02d}", data=np.int32(i))
        with pytest.raises(NotImplementedError, match="more than 64 links"):
            f.create_dataset("x64", data=np.int32(64))
        with pytest.raises(ValueError, match="exists"):
            f.create_group("x00")
        with pytest.raises(NotImplementedError):
            f.create_dataset("c", data=np.ones(2, np.complex64))
    with h5py.File(p) as f:
        assert len(f) == 64 and f["x63"][()] == 63
    with hdf5.File(p) as f:
        assert f.keys() == [f"x{i:02d}" for i in range(64)]
        with pytest.raises(KeyError):
            f["missing"]
    (tmp_path / "g.h5").write_bytes(b"not an HDF5 file" * 64)
    with pytest.raises(OSError, match="not an HDF5 file"):
        hdf5.File(tmp_path / "g.h5")
    with pytest.raises(ValueError, match="mode"):
        hdf5.File(p, "x")
