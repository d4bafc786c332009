"""AutoTable: append-oriented HDF5 writer.

Counterpart of ``prosper_tpu/io/autotable.py``, with its file layout.

Reference behavior: SURVEY.md §2 "AutoTable" — ``prosper/utils/autotable.py``
(mount unavailable): auto-creates one expandable array per key on first
append; each append adds one row; the per-iteration parameter history doubles
as the checkpoint/resume substrate (SURVEY.md §5.4).

The datasets are chunked with an unbounded first axis (the reference uses
PyTables, the JAX package h5py); the port writes them with its own
``io/hdf5.py``, and h5py reads them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from prosper_tpu_torch.io import hdf5


class AutoTable:
    """One expandable HDF5 dataset per key; ``append(name, value)`` adds a row."""

    def __init__(self, path: str, mode: str = "w"):
        self.path = path
        self._f = hdf5.File(path, mode)

    def append(self, name: str, value) -> None:
        value = np.asarray(value)
        if name not in self._f:
            self._f.create_dataset(
                name, shape=(0,) + value.shape, maxshape=(None,) + value.shape,
                chunks=(1,) + value.shape if value.shape else (1024,),
                dtype=value.dtype)
        ds = self._f[name]
        if ds.shape[1:] != value.shape:
            raise ValueError(
                f"shape mismatch appending to {name!r}: "
                f"table rows are {ds.shape[1:]}, got {value.shape}")
        ds.resize(ds.shape[0] + 1, axis=0)
        ds[-1] = value

    def append_all(self, record: dict) -> None:
        for k, v in record.items():
            self.append(k, v)

    def __getitem__(self, name: str) -> np.ndarray:
        return np.asarray(self._f[name])

    def keys(self):
        return list(self._f.keys())

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
