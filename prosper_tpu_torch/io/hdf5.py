"""The HDF5 files of the package, read and written with numpy alone.

The package's checkpoints, data logs and data sets are HDF5 files with the
layout of the JAX package's (``io/checkpoint.py``, ``io/autotable.py``,
``data/patches.py``), and a machine that runs the port need not have
``h5py``.  This module reads and writes the part of the HDF5 file format
(https://docs.hdfgroup.org/hdf5/develop/_f_m_t3.html) those files use, with
the structures that h5py writes by default, so that h5py and this module
read each other's files:

* superblock version 0 (reads 1 too), 8-byte offsets and lengths;
* version 1 object headers, with continuation blocks;
* groups as symbol tables (a version 1 B-tree of symbol nodes and a local
  heap of names); groups this module writes hold up to 64 links;
* datasets of integers, IEEE floats and fixed-length byte strings: scalars
  and arrays, contiguous, or chunked with a
  version 1 B-tree of chunks (read: any chunking, with the deflate, shuffle
  and fletcher32 filters; written: one unlimited first axis, chunks of
  whole rows, the B-tree rebuilt as chunks are added);
* attributes of the same types, and (read only) variable-length strings.

Anything else raises ``NotImplementedError``.  ``File(path, "a")`` reads the
file and writes it anew with this module's structures, then appends.
Every call that changes a file leaves it consistent on disk (data, then
metadata, then the superblock's end-of-file address), so a reader sees
every row appended before a process was killed.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
#: a variable-length string (h5py writes a ``str`` attribute so): read only
VLEN_STR = np.dtype("O")
UNDEF = 0xFFFFFFFFFFFFFFFF
#: symbol nodes hold 2 * GROUP_LEAF_K links; group B-tree nodes and chunk
#: B-tree nodes hold 2 * K children
GROUP_LEAF_K, GROUP_INTERNAL_K, CHUNK_K = 32, 16, 32
HEADER_SPARE = 512          # bytes of each object header kept for attributes

# message types
NIL, DATASPACE, DATATYPE, FILL, LAYOUT, FILTERS, ATTRIBUTE, CONTINUATION, \
    SYMBOL_TABLE = 0, 1, 3, 5, 8, 11, 12, 16, 17


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"HDF5 feature not supported here: {what}")


# -- datatypes and dataspaces ---------------------------------------------------

_FLOAT_LAYOUT = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127),
                 8: (52, 11, 52, 1023)}


def _encode_dtype(dt: np.dtype) -> bytes:
    dt = np.dtype(dt)
    size = dt.itemsize
    if dt.kind in "iu":
        head = bytes([0x10, 0x08 if dt.kind == "i" else 0, 0, 0])
        props = struct.pack("<HH", 0, 8 * size)
    elif dt.kind == "f" and size in _FLOAT_LAYOUT:
        eloc, esize, msize, bias = _FLOAT_LAYOUT[size]
        head = bytes([0x11, 0x20, 8 * size - 1, 0])
        props = struct.pack("<HHBBBBI", 0, 8 * size, eloc, esize, 0, msize,
                            bias)
    elif dt.kind == "S":
        head, props = bytes([0x13, 0x01, 0, 0]), b""    # null-padded ASCII
    else:
        raise _unsupported(f"datatype {dt}")
    if dt.byteorder == ">":
        raise _unsupported("big-endian data to write")
    return head + struct.pack("<I", size) + props


def _decode_dtype(b: bytes) -> np.dtype:
    cls, bits0 = b[0] & 0x0F, b[1]
    size = struct.unpack_from("<I", b, 4)[0]
    order = ">" if bits0 & 0x01 else "<"
    if cls == 0:
        return np.dtype(f"{order}{'i' if bits0 & 0x08 else 'u'}{size}")
    if cls == 1:
        if bits0 & 0x40:
            raise _unsupported("VAX floats")
        return np.dtype(f"{order}f{size}")
    if cls == 3:
        return np.dtype(f"S{size}")
    if cls == 9 and b[1] & 0x0F == 1:
        return VLEN_STR
    raise _unsupported(f"datatype class {cls}")


def _encode_space(shape, maxshape=None) -> bytes:
    rank = len(shape)
    out = bytes([1, rank, 1 if maxshape is not None else 0, 0]) + bytes(4)
    out += b"".join(struct.pack("<Q", int(d)) for d in shape)
    if maxshape is not None:
        out += b"".join(struct.pack("<Q", UNDEF if m is None else int(m))
                        for m in maxshape)
    return out


def _decode_space(b: bytes):
    version, rank, flags = b[0], b[1], b[2]
    if version != 1:
        raise _unsupported(f"dataspace version {version}")
    p = 8
    dims = struct.unpack_from(f"<{rank}Q", b, p)
    maxdims = None
    if flags & 1:
        raw = struct.unpack_from(f"<{rank}Q", b, p + 8 * rank)
        maxdims = tuple(None if m == UNDEF else m for m in raw)
    return tuple(int(d) for d in dims), maxdims


def _attr_value(value) -> np.ndarray:
    if isinstance(value, str):
        value = value.encode("ascii")
    a = np.asarray(value)
    if a.dtype.kind == "U":
        a = np.char.encode(a, "ascii")
    if a.dtype.kind == "b":
        a = a.astype(np.uint8)
    return a.astype(a.dtype.newbyteorder("<"), order="C")


def _encode_attr(name: str, value) -> bytes:
    a = _attr_value(value)
    nm = name.encode("ascii") + b"\0"
    dt = _encode_dtype(a.dtype)
    sp = _encode_space(a.shape)
    return (bytes([1, 0]) + struct.pack("<HHH", len(nm), len(dt), len(sp))
            + _pad8(nm) + _pad8(dt) + _pad8(sp) + a.tobytes())


def _decode_attr(b: bytes, reader=None):
    if b[0] != 1:
        raise _unsupported(f"attribute message version {b[0]}")
    nlen, tlen, slen = struct.unpack_from("<HHH", b, 2)
    p = 8
    name = b[p:p + nlen]
    p += nlen + (-nlen % 8)
    dt = _decode_dtype(b[p:p + tlen])
    p += tlen + (-tlen % 8)
    shape, _ = _decode_space(b[p:p + slen])
    p += slen + (-slen % 8)
    n = int(np.prod(shape)) if shape else 1
    if dt is VLEN_STR:
        # (length, global heap collection, object index) per element
        value = np.array([reader.global_object(*struct.unpack_from(
            "<QI", b, p + 16 * i + 4))[:struct.unpack_from(
                "<I", b, p + 16 * i)[0]].decode("utf-8")
            for i in range(n)], object).reshape(shape)
        return name.rstrip(b"\0").decode("ascii"), (
            value[()] if value.ndim == 0 else value)
    value = np.frombuffer(b, dt, n, p).reshape(shape).copy()
    if dt.kind == "S" and value.ndim == 0:
        value = value.item().rstrip(b"\0").decode("ascii")
    elif value.ndim == 0:
        value = value[()]
    return name.rstrip(b"\0").decode("ascii"), value


# -- reading --------------------------------------------------------------------

class _Reader:
    """Parses a file: object headers, groups, datasets; reads data on
    demand."""

    def __init__(self, fh):
        self.fh = fh
        size = fh.seek(0, os.SEEK_END)
        base = 0
        while True:
            if self.read(base, 8) == SIGNATURE:
                break
            base = 512 if base == 0 else 2 * base
            if base >= size:
                raise OSError("not an HDF5 file (no superblock signature)")
        sb = self.read(base, 100)
        version = sb[8]
        if version not in (0, 1):
            raise _unsupported(f"superblock version {version}")
        if sb[13] != 8 or sb[14] != 8:
            raise _unsupported("offsets or lengths of other than 8 bytes")
        p = 24 if version == 0 else 28     # version 1: + the chunk B-tree K
        self.base = struct.unpack_from("<Q", sb, p)[0] + base
        self.root = struct.unpack_from("<Q", sb, p + 32 + 8)[0]

    def read(self, addr: int, n: int) -> bytes:
        self.fh.seek(addr)
        return self.fh.read(n)

    def messages(self, addr: int) -> List[Tuple[int, bytes]]:
        """(type, data) of every message of the object header at addr."""
        addr += self.base
        pre = self.read(addr, 16)
        if pre[0] != 1:
            raise _unsupported(f"object header version {pre[0]}")
        size = struct.unpack_from("<I", pre, 8)[0]
        blocks = [(addr + 16, size)]
        out = []
        while blocks:
            start, size = blocks.pop(0)
            raw = self.read(start, size)
            p = 0
            while p + 8 <= len(raw):
                mtype, msize, flags = struct.unpack_from("<HHB", raw, p)
                data = raw[p + 8:p + 8 + msize]
                p += 8 + msize
                if flags & 0x02:
                    raise _unsupported("shared header messages")
                if mtype == CONTINUATION:
                    at, ln = struct.unpack_from("<QQ", data)
                    blocks.append((at + self.base, ln))
                elif mtype != NIL:
                    out.append((mtype, data))
        return out

    def node(self, addr: int, name: str):
        msgs = self.messages(addr)
        types = {t for t, _ in msgs}
        if LAYOUT in types:
            return Dataset(self, msgs, name)
        if SYMBOL_TABLE in types:
            return Group(self, msgs, name)
        raise _unsupported(f"object at {addr} (neither group nor dataset)")

    def global_object(self, addr: int, index: int) -> bytes:
        """Object ``index`` of the global heap collection at ``addr``."""
        head = self.read(addr + self.base, 16)
        if head[:4] != b"GCOL":
            raise OSError("corrupt global heap collection")
        raw = self.read(addr + self.base, struct.unpack_from("<Q", head, 8)[0])
        p = 16
        while p + 16 <= len(raw):
            idx, _, size = struct.unpack_from("<HHxxxxQ", raw, p)
            if idx == 0:
                break
            if idx == index:
                return raw[p + 16:p + 16 + size]
            p += 16 + size + (-size % 8)
        raise OSError(f"global heap object {index} not found")

    def heap_names(self, heap_addr: int):
        h = self.read(heap_addr + self.base, 32)
        if h[:4] != b"HEAP":
            raise OSError("corrupt local heap")
        size, _, data_addr = struct.unpack_from("<QQQ", h, 8)
        return self.read(data_addr + self.base, size)

    def links(self, btree: int, heap: int) -> Dict[str, int]:
        names = self.heap_names(heap)
        out = {}

        def walk(addr):
            hdr = self.read(addr + self.base, 24)
            if hdr[:4] != b"TREE" or hdr[4] != 0:
                raise OSError("corrupt group B-tree")
            level, n = hdr[5], struct.unpack_from("<H", hdr, 6)[0]
            body = self.read(addr + self.base + 24, 16 * n + 8)
            for i in range(n):
                child = struct.unpack_from("<Q", body, 8 + 16 * i)[0]
                if level > 0:
                    walk(child)
                    continue
                snod = self.read(child + self.base, 8)
                if snod[:4] != b"SNOD":
                    raise OSError("corrupt symbol node")
                k = struct.unpack_from("<H", snod, 6)[0]
                ents = self.read(child + self.base + 8, 40 * k)
                for j in range(k):
                    off, obj = struct.unpack_from("<QQ", ents, 40 * j)
                    end = names.index(b"\0", off)
                    out[names[off:end].decode("ascii")] = obj
        walk(btree)
        return out

    def chunks(self, btree: int, ndims: int):
        """[(offsets, address, size, filter mask)] of a chunk B-tree."""
        key = 8 + 8 * ndims
        out = []

        def walk(addr):
            hdr = self.read(addr + self.base, 24)
            if hdr[:4] != b"TREE" or hdr[4] != 1:
                raise OSError("corrupt chunk B-tree")
            level, n = hdr[5], struct.unpack_from("<H", hdr, 6)[0]
            body = self.read(addr + self.base + 24, (key + 8) * n + key)
            for i in range(n):
                p = (key + 8) * i
                nbytes, mask = struct.unpack_from("<II", body, p)
                offs = struct.unpack_from(f"<{ndims}Q", body, p + 8)
                child = struct.unpack_from("<Q", body, p + key)[0]
                if level > 0:
                    walk(child)
                else:
                    out.append((offs, child, nbytes, mask))
        if btree != UNDEF:
            walk(btree)
        return out


class _GroupAPI:
    """What a group read from a file and a group open for writing share:
    ``[path]`` (names joined by '/'), ``in``, ``keys()``, ``items()``,
    ``values()``, iteration and ``len``, over the subclass's ``_names()``
    and ``_child(name)``."""

    def __getitem__(self, path: str):
        node = self
        for part in path.strip("/").split("/"):
            if not isinstance(node, _GroupAPI):
                raise KeyError(f"{path!r}: {node.name} is a dataset")
            node = node._child(part)
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def keys(self):
        return sorted(self._names())

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self._names())

    def items(self):
        return [(k, self._child(k)) for k in self.keys()]

    def values(self):
        return [self._child(k) for k in self.keys()]


class Group(_GroupAPI):
    """A group read from a file: the ``_GroupAPI`` and ``attrs``."""

    def __init__(self, reader, msgs, name):
        self.name = name
        self.attrs = dict(_decode_attr(d, reader) for t, d in msgs
                          if t == ATTRIBUTE)
        self._links: Dict[str, int] = {}
        for t, d in msgs:
            if t == SYMBOL_TABLE:
                self._links.update(reader.links(*struct.unpack_from("<QQ", d)))
        self._reader = reader
        self._cache: Dict[str, object] = {}

    def _names(self):
        return self._links

    def _child(self, name):
        if name not in self._cache:
            if name not in self._links:
                raise KeyError(f"{name!r} not found in {self.name or '/'}")
            self._cache[name] = self._reader.node(
                self._links[name], f"{self.name}/{name}")
        return self._cache[name]


def _decode_filters(d: bytes):
    version, n = d[0], d[1]
    p = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid, = struct.unpack_from("<H", d, p)
        p += 2
        nlen = 0
        if version == 1 or fid >= 256:
            nlen, = struct.unpack_from("<H", d, p)
            p += 2
        _, nvals = struct.unpack_from("<HH", d, p)
        p += 4
        p += nlen + (-nlen % 8 if version == 1 else 0)
        vals = struct.unpack_from(f"<{nvals}I", d, p)
        p += 4 * nvals + (4 * (nvals % 2) if version == 1 else 0)
        out.append((fid, vals))
    return out


def _unfilter(raw: bytes, filters, mask: int, itemsize: int) -> bytes:
    for i in reversed(range(len(filters))):
        if mask & (1 << i):
            continue
        fid, vals = filters[i]
        if fid == 1:
            raw = zlib.decompress(raw)
        elif fid == 2:
            size = vals[0] if vals else itemsize
            a = np.frombuffer(raw, np.uint8)
            n = len(a) // size
            raw = (a[:n * size].reshape(size, n).T.tobytes()
                   + a[n * size:].tobytes())
        elif fid == 3:
            raw = raw[:-4]
        else:
            raise _unsupported(f"filter {fid}")
    return raw


class _DatasetAPI:
    """What a dataset read from a file and one open for writing share:
    ``ndim``, ``len``, ``ds[...]``, ``ds[()]``, ``ds[i]``, ``ds[a:b]``
    (a slice of the first axis reads only its rows) and ``np.asarray(ds)``,
    over the subclass's ``shape`` and ``_rows(lo, hi)``."""

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, key):
        if not self.shape:
            if key in ((), Ellipsis):
                return self._rows(0, 1)
            raise IndexError("a scalar dataset takes ds[()]")
        n = self.shape[0]
        if key is Ellipsis or (isinstance(key, tuple) and not key):
            return self._rows(0, n)
        first, rest = (key[0], key[1:]) if isinstance(key, tuple) else (key,
                                                                          ())
        if isinstance(first, (int, np.integer)):
            i = int(first) + (n if first < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {first} out of range for {n} rows")
            return self._rows(i, i + 1)[0][rest]
        if isinstance(first, slice) and first.step in (None, 1):
            lo, hi, _ = first.indices(n)
            return self._rows(lo, max(lo, hi))[(slice(None),) + rest]
        return self._rows(0, n)[key]

    def __array__(self, dtype=None, copy=None):
        a = self._rows(0, self.shape[0] if self.shape else 1)
        return a if dtype is None else a.astype(dtype)


class Dataset(_DatasetAPI):
    """A dataset read from a file: the ``_DatasetAPI``, ``shape``,
    ``dtype``, ``maxshape`` and ``attrs``."""

    def __init__(self, reader, msgs, name):
        self.name = name
        self._reader = reader
        self.attrs = {}
        self._filters = []
        for t, d in msgs:
            if t == DATASPACE:
                self.shape, maxshape = _decode_space(d)
                self.maxshape = maxshape or self.shape
            elif t == DATATYPE:
                self.dtype = _decode_dtype(d)
            elif t == LAYOUT:
                self._layout = d
            elif t == FILTERS:
                self._filters = _decode_filters(d)
            elif t == ATTRIBUTE:
                self.attrs.update([_decode_attr(d, reader)])
        if self._layout[0] != 3:
            raise _unsupported(f"layout message version {self._layout[0]}")

    def _rows(self, lo: int, hi: int) -> np.ndarray:
        """Rows lo:hi of the first axis (the whole array for a scalar)."""
        dt, r = self.dtype, self._reader
        shape = self.shape
        row = int(np.prod(shape[1:])) if shape else 1
        cls = self._layout[1]
        if not shape:
            lo, hi = 0, 1
        n = (hi - lo) * row
        out_shape = ((hi - lo),) + tuple(shape[1:]) if shape else ()
        if cls == 1:                                   # contiguous
            addr, = struct.unpack_from("<Q", self._layout, 2)
            if addr == UNDEF or n == 0:
                return np.zeros(out_shape, dt)
            raw = r.read(addr + r.base + lo * row * dt.itemsize,
                         n * dt.itemsize)
            return np.frombuffer(raw, dt, n).reshape(out_shape).copy()
        if cls != 2:
            raise _unsupported(f"layout class {cls}")
        ndims = self._layout[2]
        btree, = struct.unpack_from("<Q", self._layout, 3)
        cdims = struct.unpack_from(f"<{ndims}I", self._layout, 11)[:-1]
        out = np.zeros(out_shape if shape else (1,), dt)
        if not shape:
            cdims, shape = (1,), (1,)
        for offs, addr, nbytes, mask in r.chunks(btree, ndims):
            o0 = offs[0]
            if o0 + cdims[0] <= lo or o0 >= hi:
                continue
            raw = r.read(addr + r.base, nbytes)
            if self._filters:
                raw = _unfilter(raw, self._filters, mask, dt.itemsize)
            block = np.frombuffer(raw, dt, int(np.prod(cdims))).reshape(cdims)
            src = [slice(max(lo, o0) - o0, min(hi, o0 + cdims[0]) - o0)]
            dst = [slice(max(lo, o0) - lo, min(hi, o0 + cdims[0]) - lo)]
            for d in range(1, len(shape)):
                ext = min(cdims[d], shape[d] - offs[d])
                src.append(slice(0, ext))
                dst.append(slice(offs[d], offs[d] + ext))
            out[tuple(dst)] = block[tuple(src)]
        return out.reshape(out_shape)


# -- writing --------------------------------------------------------------------

def _ohdr(messages: List[Tuple[int, bytes]], area: int) -> bytes:
    """A version 1 object header of ``area`` bytes of messages (the rest
    one NIL message)."""
    body = b"".join(struct.pack("<HHB3x", t, len(_pad8(d)), 0) + _pad8(d)
                    for t, d in messages)
    if len(body) > area or 0 < area - len(body) < 8:
        raise ValueError("object header overflow: too many attributes")
    count = len(messages)
    if area > len(body):
        body += struct.pack("<HHB3x", NIL, area - len(body) - 8, 0)
        body += bytes(area - len(body))
        count += 1
    return struct.pack("<BBHII4x", 1, 0, count, 1, area) + body


class _Writer:
    """Allocation at the end of the file and writes in place."""

    def __init__(self, fh):
        self.fh = fh
        self.eof = 96
        self.root = None

    def alloc(self, n: int) -> int:
        addr = self.eof
        self.eof += n
        return addr

    def write(self, addr: int, data: bytes) -> None:
        self.fh.seek(addr)
        self.fh.write(data)

    def superblock(self) -> None:
        sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + struct.pack("<HHI", GROUP_LEAF_K, GROUP_INTERNAL_K, 0)
              + struct.pack("<QQQQ", 0, UNDEF, self.eof, UNDEF)
              + struct.pack("<QQII", 0, self.root.ohdr, 0, 0) + bytes(16))
        self.write(0, sb)
        self.fh.flush()


class _WNode:
    """What a group and a dataset open for writing share: an object header
    of fixed size with attributes added in place."""

    def _init_header(self, w: _Writer, name: str, size: int):
        self._w, self.name = w, name
        self.attrs = _Attrs(self)
        self._area = size + HEADER_SPARE
        self.ohdr = w.alloc(16 + self._area)

    def _write_header(self) -> None:
        msgs = self._messages() + [(ATTRIBUTE, _encode_attr(k, v))
                                   for k, v in self.attrs.items()]
        self._w.write(self.ohdr, _ohdr(msgs, self._area))


class _Attrs(dict):
    """Attributes of a node open for writing: assignment writes them."""

    def __init__(self, node):
        super().__init__()
        self._node = node

    def __setitem__(self, key, value):
        _encode_attr(key, value)                   # fail before storing
        super().__setitem__(key, value)
        self._node._write_header()
        self._node._w.superblock()


class WGroup(_WNode, _GroupAPI):
    """A group of a file open for writing (up to 2 * GROUP_LEAF_K links)."""

    BTREE_SIZE = 24 + (2 * GROUP_INTERNAL_K + 1) * 8 + 2 * GROUP_INTERNAL_K * 8
    SNOD_SIZE = 8 + 2 * GROUP_LEAF_K * 40

    def __init__(self, w: _Writer, name: str):
        self._init_header(w, name, 24)
        self.heap = w.alloc(32)
        self.btree = w.alloc(self.BTREE_SIZE)
        self.snod = w.alloc(self.SNOD_SIZE)
        self._children: Dict[str, object] = {}
        self._write_header()
        self._write_links()

    def _messages(self):
        return [(SYMBOL_TABLE, struct.pack("<QQ", self.btree, self.heap))]

    def _write_links(self) -> None:
        names = sorted(self._children)
        heap, offs = bytearray(8), {}
        for n in names:
            offs[n] = len(heap)
            heap += _pad8(n.encode("ascii") + b"\0")
        data = self._w.alloc(len(heap))
        self._w.write(data, bytes(heap))
        # no free block: the offset 1 (HDF5's end of the free list)
        self._w.write(self.heap, b"HEAP" + bytes(4)
                      + struct.pack("<QQQ", len(heap), 1, data))
        ents = b""
        for n in names:
            c = self._children[n]
            if isinstance(c, WGroup):
                ents += struct.pack("<QQII", offs[n], c.ohdr, 1, 0)
                ents += struct.pack("<QQ", c.btree, c.heap)
            else:
                ents += struct.pack("<QQII", offs[n], c.ohdr, 0, 0) + bytes(16)
        self._w.write(self.snod, (b"SNOD" + bytes([1, 0])
                                  + struct.pack("<H", len(names)) + ents)
                      .ljust(self.SNOD_SIZE, b"\0"))
        node = b"TREE" + bytes([0, 0]) + struct.pack("<H", 1 if names else 0)
        node += struct.pack("<QQ", UNDEF, UNDEF)
        if names:
            node += struct.pack("<QQQ", 0, self.snod, offs[names[-1]])
        self._w.write(self.btree, node.ljust(self.BTREE_SIZE, b"\0"))

    def _add(self, name: str, node) -> None:
        if "/" in name:
            head, _, rest = name.partition("/")
            parent = self[head] if head in self._children else \
                self.create_group(head)
            return parent._add(rest, node)
        if name in self._children:
            raise ValueError(f"{name!r} exists in {self.name or '/'}")
        if len(self._children) == 2 * GROUP_LEAF_K:
            raise _unsupported(f"groups of more than {2 * GROUP_LEAF_K} links")
        self._children[name] = node
        self._write_links()
        self._w.superblock()

    def create_group(self, name: str) -> "WGroup":
        g = WGroup(self._w, f"{self.name}/{name}")
        self._add(name, g)
        return g

    def create_dataset(self, name: str, data=None, shape=None, dtype=None,
                       maxshape=None, chunks=None) -> "WDataset":
        """A dataset from ``data`` (written contiguously), or of ``shape``
        and ``dtype`` with ``maxshape[0] = None`` (an extendable first axis,
        chunks of ``chunks[0]`` rows; zeros until written).  ``chunks`` of
        a fixed-size dataset is accepted and not used."""
        ds = WDataset(self._w, f"{self.name}/{name}", data, shape, dtype,
                      maxshape, chunks)
        self._add(name, ds)
        return ds

    def _names(self):
        return self._children

    def _child(self, name):
        if name not in self._children:
            raise KeyError(f"{name!r} not found in {self.name or '/'}")
        return self._children[name]


class WDataset(_WNode, _DatasetAPI):
    """A dataset of a file open for writing: fixed (contiguous, written at
    creation) or with an extendable first axis (chunks of whole rows in a
    version 1 B-tree): ``resize(n)`` and ``ds[i] = row``."""

    def __init__(self, w, name, data, shape, dtype, maxshape, chunks):
        if data is not None:
            data = np.asarray(data, order="C")
            shape, dtype = data.shape, data.dtype
        self.dtype = np.dtype(dtype).newbyteorder("<") \
            if np.dtype(dtype).byteorder == ">" else np.dtype(dtype)
        self.shape = tuple(int(d) for d in shape)
        self.extendable = maxshape is not None and maxshape[0] is None
        if maxshape is not None and not self.extendable:
            raise _unsupported("a bounded maxshape")
        self._row = int(np.prod(self.shape[1:])) * self.dtype.itemsize
        if self.extendable:
            if not self.shape:
                raise ValueError("an extendable dataset needs an axis")
            self.maxshape = (None,) + self.shape[1:]
            self._rows_per_chunk = int(chunks[0]) if chunks else 1
            self._chunks: List[int] = []
            self._levels: List[list] = [[]]     # the B-tree's entries
            self._slots: List[List[int]] = [[]]     # its nodes' addresses
            self._root = UNDEF
        else:
            self.maxshape = self.shape
            nbytes = int(np.prod(self.shape)) * self.dtype.itemsize
            self._addr = w.alloc(nbytes) if nbytes else UNDEF
            if nbytes:
                raw = (np.zeros(self.shape, self.dtype) if data is None
                       else data.astype(self.dtype, copy=False)).tobytes()
                w.write(self._addr, raw)
        self._init_header(w, name, sum(8 + len(_pad8(d))
                                       for _, d in self._messages()))
        if self.extendable and self.shape[0]:
            n, self.shape = self.shape[0], (0,) + self.shape[1:]
            self.resize(n)
        self._write_header()

    def _messages(self):
        dt = _encode_dtype(self.dtype)
        fill = bytes([2, 3 if self.extendable else 2, 2, 1])
        fill += struct.pack("<I", self.dtype.itemsize) + bytes(
            self.dtype.itemsize)
        if self.extendable:
            ndims = len(self.shape) + 1
            layout = bytes([3, 2, ndims]) + struct.pack("<Q", self._root)
            layout += struct.pack(f"<{ndims}I", self._rows_per_chunk,
                                  *self.shape[1:], self.dtype.itemsize)
            space = _encode_space(self.shape, self.maxshape)
        else:
            size = int(np.prod(self.shape)) * self.dtype.itemsize
            layout = bytes([3, 1]) + struct.pack("<QQ", self._addr, size)
            space = _encode_space(self.shape)
        return [(DATASPACE, space), (DATATYPE, dt), (FILL, fill),
                (LAYOUT, layout)]

    # the chunk B-tree: leaves of up to 2K chunks, then levels of up to 2K
    # nodes.  Chunks come and go at the end only, so a change rewrites the
    # nodes from the one that holds the first changed chunk (and its left
    # neighbour, whose right key and sibling change) up to the root
    def _write_tree(self, first: int) -> None:
        R, rank = self._rows_per_chunk, len(self.shape)
        fan = 2 * CHUNK_K
        keysize = 8 + 8 * (rank + 1)
        size = 24 + (2 * CHUNK_K + 1) * keysize + 2 * CHUNK_K * 8

        def key(nbytes, row0):
            return struct.pack(f"<II{rank + 1}Q", nbytes, 0, row0,
                               *([0] * rank))
        # level 0: (key, chunk); level l + 1: (first key, node) of level l
        items = self._levels[0]
        del items[first:]
        items += [(key(R * self._row, c * R), self._chunks[c])
                  for c in range(first, len(self._chunks))]
        end = key(0, len(self._chunks) * R)
        level, lo = 0, first
        while True:
            n = -(-len(items) // fan)
            slots = self._slots[level]
            while len(slots) < n:
                slots.append(self._w.alloc(size))
            if len(self._levels) == level + 1:
                self._levels.append([])
                self._slots.append([])
            parents = self._levels[level + 1]
            lo = max(0, lo // fan - 1)
            del parents[lo:]
            for j in range(lo, n):
                g = items[j * fan:(j + 1) * fan]
                right = items[(j + 1) * fan][0] if j + 1 < n else end
                node = b"TREE" + bytes([1, level]) + struct.pack("<H", len(g))
                node += struct.pack("<QQ", slots[j - 1] if j else UNDEF,
                                    slots[j + 1] if j + 1 < n else UNDEF)
                node += b"".join(k + struct.pack("<Q", a) for k, a in g)
                self._w.write(slots[j], (node + right).ljust(size, b"\0"))
                parents.append((g[0][0], slots[j]))
            if n <= 1:
                self._root = slots[0] if n else UNDEF
                return
            items, level = parents, level + 1

    def resize(self, size: int, axis: int = 0) -> None:
        """Set the length of the extendable first axis; new rows are
        zeros."""
        if not self.extendable or axis != 0:
            raise _unsupported("resizing other than an extendable first axis")
        old, R = self.shape[0], self._rows_per_chunk
        need = -(-size // R)
        had = len(self._chunks)
        del self._chunks[need:]
        # a shrink leaves stale rows in its last chunk: rows past the old
        # end read as zeros
        for r in range(old, min(size, had * R)):
            self._write_row(r, bytes(self._row))
        while len(self._chunks) < need:
            addr = self._w.alloc(R * self._row)
            self._w.write(addr, bytes(R * self._row))
            self._chunks.append(addr)
        self.shape = (int(size),) + self.shape[1:]
        if len(self._chunks) != had or self._root == UNDEF:
            self._write_tree(min(had, len(self._chunks)))
        self._write_header()
        self._w.superblock()

    def _write_row(self, r: int, raw: bytes) -> None:
        R = self._rows_per_chunk
        self._w.write(self._chunks[r // R] + (r % R) * self._row, raw)

    def __setitem__(self, index, value) -> None:
        if not self.extendable or not isinstance(index, (int, np.integer)):
            raise _unsupported("writing other than a row of an extendable "
                               "dataset")
        n = self.shape[0]
        r = int(index) + (n if index < 0 else 0)
        if not 0 <= r < n:
            raise IndexError(f"row {index} out of range for {n} rows")
        row = np.asarray(value, self.dtype)
        if row.shape != self.shape[1:]:
            raise ValueError(f"a row of {self.name} has shape "
                             f"{self.shape[1:]}, got {row.shape}")
        self._write_row(r, row.tobytes())
        self._w.fh.flush()

    def _rows(self, lo: int, hi: int) -> np.ndarray:
        shape = ((hi - lo),) + self.shape[1:] if self.shape else ()
        n = (hi - lo) * (self._row // self.dtype.itemsize) if self.shape \
            else 1
        fh = self._w.fh
        if not self.extendable:
            if self._addr == UNDEF:
                return np.zeros(shape, self.dtype)
            fh.seek(self._addr + (lo * self._row if self.shape else 0))
            return np.frombuffer(fh.read(n * self.dtype.itemsize),
                                 self.dtype, n).reshape(shape).copy()
        R = self._rows_per_chunk
        rows = []
        for r in range(lo, hi):
            fh.seek(self._chunks[r // R] + (r % R) * self._row)
            rows.append(fh.read(self._row))
        return np.frombuffer(b"".join(rows), self.dtype, n).reshape(
            shape).copy()


class File:
    """An HDF5 file: mode "r" (read), "w" (create, truncating) or "a"
    (read it, write it anew with this module's structures, then append).
    The root group's API (``[path]``, ``keys()``, ``attrs``, and for "w"
    and "a" ``create_group`` / ``create_dataset``) is the file's."""

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "w", "a"):
            raise ValueError(f"mode must be 'r', 'w' or 'a', got {mode!r}")
        self.path = str(path)
        self.mode = mode
        if mode == "r":
            self._fh = open(self.path, "rb")
            try:
                r = _Reader(self._fh)
                self._root = r.node(r.root, "")
            except BaseException:
                self._fh.close()
                raise
            return
        old = None
        if mode == "a" and os.path.exists(self.path):
            with File(self.path, "r") as src:
                old = _snapshot(src)
        self._fh = open(self.path, "w+b")
        w = _Writer(self._fh)
        w.write(0, bytes(96))
        w.root = self._root = WGroup(w, "")
        w.superblock()
        if old is not None:
            _replay(self._root, old)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._root, name)

    def __getitem__(self, path):
        return self._root[path]

    def __contains__(self, path):
        return path in self._root

    def __iter__(self):
        return iter(self._root)

    def __len__(self):
        return len(self._root)

    def flush(self) -> None:
        if self.mode != "r":
            self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self.flush()
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _snapshot(group) -> Tuple[Dict, Dict]:
    """(attrs, {name: subgroup snapshot or (array, maxshape, attrs)}) of a
    group read from a file."""
    children = {}
    for name, node in group.items():
        if isinstance(node, _GroupAPI):
            children[name] = _snapshot(node)
        else:
            children[name] = (np.asarray(node), node.maxshape,
                              dict(node.attrs))
    return dict(group.attrs), children


def _replay(group: WGroup, snap) -> None:
    """Write a snapshot into a group of a file open for writing; an
    extendable dataset gets the chunks ``io/autotable.py`` gives it."""
    attrs, children = snap
    for k, v in attrs.items():
        group.attrs[k] = v
    for name, child in children.items():
        if not isinstance(child[0], np.ndarray):
            _replay(group.create_group(name), child)
            continue
        data, maxshape, dattrs = child
        if data.ndim and maxshape[0] is None:
            ds = group.create_dataset(
                name, shape=data.shape, dtype=data.dtype,
                maxshape=(None,) + data.shape[1:],
                chunks=(1024,) if data.ndim == 1 else (1,))
            for i, row in enumerate(data):
                ds[i] = row
        else:
            ds = group.create_dataset(name, data=data)
        for k, v in dattrs.items():
            ds.attrs[k] = v
