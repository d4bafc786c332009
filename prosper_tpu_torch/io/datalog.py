"""DataLog: the pub-sub metrics layer.

Counterpart of ``prosper_tpu/io/datalog.py``: handlers are attached per
channel name (``dlog.set_handler(('W', 'Q'), StoreToH5, path)``), the EM
loop calls ``append_all(record)`` every iteration, and only process 0
(``torch.distributed``'s rank 0, or the only process) touches files.

  TextPrinter   -> rank-0 stdout
  StoreToH5     -> AutoTable-backed HDF5, one row per append
  StoreToTxt    -> flat text file
  StoreToJSONL  -> one JSON object per ``append_all`` (scalars only)

A value may be a tensor on any device: ``DataLog`` copies each channel that
some handler takes to the host once (``.cpu().numpy()``), and a channel no
handler takes is never copied.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from prosper_tpu_torch.io.autotable import AutoTable
from prosper_tpu_torch.utils import process_index


def _is_proc0() -> bool:
    return process_index() == 0


def host(value) -> np.ndarray:
    """A channel's value as a host numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class DataHandler:
    """Handler interface (reference: datalog.DataHandler)."""

    def register(self, names: Sequence[str]) -> None:
        pass

    def append(self, name: str, value) -> None:
        raise NotImplementedError

    def append_all(self, record: Dict) -> None:
        for k, v in record.items():
            self.append(k, v)

    def close(self) -> None:
        pass


class TextPrinter(DataHandler):
    def append(self, name, value):
        if _is_proc0():
            v = host(value)
            if v.ndim == 0:
                print(f"  {name} = {v}")
            else:
                print(f"  {name} = array{v.shape}")


class StoreToTxt(DataHandler):
    def __init__(self, path: str):
        self._f = open(path, "a") if _is_proc0() else None

    def append(self, name, value):
        if self._f is not None:
            v = host(value)
            self._f.write(f"{name} = {v.tolist() if v.ndim else v}\n")
            self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()


class StoreToH5(DataHandler):
    def __init__(self, path: str, mode: str = "w"):
        self._table = AutoTable(path, mode) if _is_proc0() else None

    @property
    def table(self) -> Optional[AutoTable]:
        return self._table

    def append(self, name, value):
        if self._table is not None:
            self._table.append(name, host(value))

    def close(self):
        if self._table is not None:
            self._table.close()


class StoreToJSONL(DataHandler):
    def __init__(self, path: str, mode: str = "w"):
        self._f = open(path, mode) if _is_proc0() else None
        self._row: Dict = {}

    def append(self, name, value):
        if self._f is None:
            return
        v = host(value)
        if v.ndim == 0:
            self._row[name] = v.item()

    def append_all(self, record):
        super().append_all(record)
        if self._f is not None and self._row:
            self._f.write(json.dumps(self._row) + "\n")
            self._f.flush()
            self._row = {}

    def close(self):
        if self._f is not None:
            if self._row:
                self._f.write(json.dumps(self._row) + "\n")
                self._row = {}
            self._f.close()


class DataLog:
    """Channel -> handler dispatch (reference: datalog.DataLog)."""

    def __init__(self):
        self._handlers: List[Tuple[Optional[frozenset], DataHandler]] = []

    def set_handler(self, names: Union[str, Iterable[str], None],
                    handler_cls, *args, **kwargs) -> DataHandler:
        """Attach a handler for the given channel name(s); None = all."""
        handler = handler_cls(*args, **kwargs) if isinstance(handler_cls, type) \
            else handler_cls
        if names is None:
            key = None
        else:
            if isinstance(names, str):
                names = (names,)
            key = frozenset(names)
            handler.register(list(names))
        self._handlers.append((key, handler))
        return handler

    def ignored(self, name: str) -> bool:
        return not any(key is None or name in key for key, _ in self._handlers)

    def append(self, name: str, value) -> None:
        if self.ignored(name):
            return
        value = host(value)
        for key, handler in self._handlers:
            if key is None or name in key:
                handler.append(name, value)

    def append_all(self, record: Dict) -> None:
        record = {k: host(v) for k, v in record.items() if not self.ignored(k)}
        for key, handler in self._handlers:
            sub = {k: v for k, v in record.items() if key is None or k in key}
            if sub:
                handler.append_all(sub)

    def close(self) -> None:
        for _, handler in self._handlers:
            handler.close()
        self._handlers = []


#: global singleton, mirroring the reference's ``from datalog import dlog``
dlog = DataLog()
