"""Host rows to the device through page-locked memory.

A copy from pageable host memory to the card goes through a bounce buffer
of the CUDA runtime and holds the host until it is done; a copy from
page-locked (pinned) memory is one DMA that runs on a stream of its own
while kernels run on another.  Two helpers:

* ``rows_to_device(y, device)``: a host array as a float32 tensor on the
  device, staged through a pinned buffer of PyTorch's caching host allocator
  (``model.inference`` on a numpy ``y``);
* ``SegmentUploader``: fixed-size row segments of a host (N, D) array put on
  the device one by one on a copy stream while the caller computes on its
  own stream (``engine/stream.py::StreamingEM``).  A C-contiguous, writeable
  float32 ``np.ndarray`` is page-locked in place once
  (``cudaHostRegister``) and segments copy straight from it; any other
  source (an ``np.memmap``, an h5py dataset, anything with ``.shape`` and
  row slicing) is read by the host into one of two pinned staging buffers,
  which overlaps the previous segment's copy and compute.

The uploader's events guard the three hazards between the host, the copy
stream and the compute stream: the compute stream waits for the copy of its
segment (read after write); the host refills a staging buffer only after
its last copy is done; the copy stream overwrites a device buffer only after
the compute that read it is done (write after read).
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: host ranges [start, end) this process has page-locked through
#: ``SegmentUploader`` (a registration is process-wide, so is this record):
#: a range that overlaps one of them is staged instead of registered twice
_REGISTERED: Dict[int, int] = {}


def rows_to_device(y, device) -> torch.Tensor:
    """``y`` (a tensor or a host array) as a float32 tensor on ``device``.
    A host array bound for a CUDA device is copied into a pinned buffer
    (PyTorch's caching host allocator keeps it for the next call and does
    not hand it out again before the copy is done) and uploaded from there
    without blocking the host; on the CPU the array is wrapped as it is."""
    device = torch.device(device)
    if isinstance(y, torch.Tensor):
        return y.to(device, torch.float32)
    y = np.asarray(y, np.float32)
    if device.type != "cuda":
        return torch.as_tensor(y, device=device)
    staged = torch.empty(y.shape, dtype=torch.float32, pin_memory=True)
    staged.numpy()[...] = y
    return staged.to(device, non_blocking=True)


def _registrable(y) -> bool:
    return (type(y) is np.ndarray and y.dtype == np.float32
            and y.flags.c_contiguous and y.flags.writeable and y.size > 0)


def _register(y: np.ndarray) -> Optional[int]:
    """Page-lock ``y`` in place; its address, or None where that is not
    done (an overlap with a range registered already, or a refusal)."""
    start = y.ctypes.data
    end = start + y.nbytes
    if any(s < end and start < e for s, e in _REGISTERED.items()):
        return None
    err = int(torch.cuda.cudart().cudaHostRegister(start, y.nbytes, 0))
    if err != 0:
        return None
    _REGISTERED[start] = end
    return start


def _unregister(start: int, array: np.ndarray) -> None:
    """Undo ``_register``; ``array`` is the registered array, held alive
    until then by the caller's finalizer."""
    _REGISTERED.pop(start, None)
    torch.cuda.cudart().cudaHostUnregister(start)


class SegmentUploader:
    """Segments of ``seg_size`` rows of a host (N, D) array on ``device``.

    ``put(k)`` starts the upload of segment k (the tail zero-padded to
    ``seg_size`` rows), ``get(k)`` makes the current stream wait for it and
    returns the (seg_size, D) device tensor, ``release(k)`` marks the end of
    the work that reads it.  Two device buffers take turns (segment k in
    buffer k % 2), or, with ``cache_all``, one buffer holds every segment
    and after the first pass no segment is uploaded again.  ``n_seg``
    (default: enough for N rows) may ask for more segments than the rows
    fill: those hold padding only (a short rank's, in lockstep with the
    others).  On the CPU the same calls copy synchronously.  ``stats``: seconds the host spent
    filling staging buffers and waiting for them, bytes and segments
    uploaded, the registration's seconds and whether the source was
    page-locked in place.  ``close()`` gives the buffers and the
    registration back.
    """

    def __init__(self, y, seg_size: int, device, cache_all: bool = False,
                 n_seg: Optional[int] = None):
        self.y = y
        self.N, self.D = int(y.shape[0]), int(y.shape[1])
        self.seg_size = int(seg_size)
        self.n_seg = (-(-self.N // self.seg_size) if n_seg is None
                      else int(n_seg))
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.cache_all = bool(cache_all)
        self.stats = {"fill_s": 0.0, "wait_s": 0.0, "bytes": 0,
                      "segments": 0, "register_s": 0.0, "registered": False}
        self._bufs: Optional[List[torch.Tensor]] = None
        self._resident = False
        self._host: Optional[torch.Tensor] = None     # the registered source
        self._unpin: Optional[weakref.finalize] = None
        self._pinned: Optional[List[torch.Tensor]] = None
        self._stream = None
        self._copied: List = []
        self._read: List = []

    def bounds(self, k: int) -> Tuple[int, int]:
        """Rows [lo, hi) of the data in segment k (empty past the data)."""
        lo = min(k * self.seg_size, self.N)
        return lo, min(k * self.seg_size + self.seg_size, self.N)

    def _setup(self) -> None:
        seg, D, dev = self.seg_size, self.D, self.device
        if self.cache_all:
            whole = torch.empty((self.n_seg * seg, D), dtype=torch.float32,
                                device=dev)
            self._bufs = [whole[k * seg:(k + 1) * seg]
                          for k in range(self.n_seg)]
        else:
            self._bufs = [torch.empty((seg, D), dtype=torch.float32,
                                      device=dev) for _ in range(2)]
        if not self.cuda:
            return
        self._stream = torch.cuda.Stream(dev)
        for b in self._bufs:
            # written on the copy stream: the allocator must not hand the
            # memory out again before that stream's work on it is done
            b.record_stream(self._stream)
        self._copied = [torch.cuda.Event() for _ in range(2)]
        self._read = [torch.cuda.Event() for _ in range(2)]
        t0 = time.perf_counter()
        start = _register(self.y) if _registrable(self.y) else None
        self.stats["register_s"] = time.perf_counter() - t0
        self.stats["registered"] = start is not None
        if start is not None:
            # unregistered by close(), or when this uploader is collected
            # (the finalizer holds the array alive until then)
            self._unpin = weakref.finalize(self, _unregister, start, self.y)
            self._host = torch.from_numpy(self.y)
        else:
            self._pinned = [torch.empty((seg, D), dtype=torch.float32,
                                        pin_memory=True) for _ in range(2)]

    def _buf(self, k: int) -> torch.Tensor:
        return self._bufs[k if self.cache_all else k % 2]

    def put(self, k: int) -> None:
        """Start the upload of segment k (nothing once the cache holds
        every segment)."""
        if self._bufs is None:
            self._setup()
        if self._resident:
            return
        lo, hi = self.bounds(k)
        dst = self._buf(k)
        self.stats["bytes"] += (hi - lo) * self.D * 4
        self.stats["segments"] += 1
        if not self.cuda:
            self._fill(dst.numpy(), lo, hi)
            dst[hi - lo:] = 0.0
            return
        j = k % 2
        if self._host is not None:
            src = self._host[lo:hi]
        else:
            # the staging buffer's last copy must be done before the host
            # writes it again
            t0 = time.perf_counter()
            self._copied[j].synchronize()
            t1 = time.perf_counter()
            staged = self._pinned[j]
            self._fill(staged.numpy(), lo, hi)
            self.stats["wait_s"] += t1 - t0
            self.stats["fill_s"] += time.perf_counter() - t1
            src = staged[:hi - lo]
        with torch.cuda.stream(self._stream):
            # the work that read this device buffer last must be done
            # before the copy stream overwrites it
            self._stream.wait_event(self._read[j])
            dst[:hi - lo].copy_(src, non_blocking=True)
            if hi - lo < self.seg_size:
                dst[hi - lo:].zero_()
            self._copied[j].record(self._stream)

    def _fill(self, out: np.ndarray, lo: int, hi: int) -> None:
        """The host reads rows [lo, hi) of the source into ``out``."""
        out[:hi - lo] = self.y[lo:hi]

    def get(self, k: int) -> torch.Tensor:
        """Segment k on the device, (seg_size, D); the current stream waits
        for its copy."""
        if self.cuda and not self._resident:
            torch.cuda.current_stream(self.device).wait_event(
                self._copied[k % 2])
        return self._buf(k)

    def release(self, k: int) -> None:
        """The work on segment k is enqueued; after the last segment of a
        pass the cache (``cache_all``) holds every segment."""
        if self.cuda and not self._resident:
            self._read[k % 2].record(torch.cuda.current_stream(self.device))
        if self.cache_all and k == self.n_seg - 1:
            self._resident = True

    def close(self) -> None:
        """Wait for the copies, unregister the source, drop the buffers."""
        if self._stream is not None:
            self._stream.synchronize()
        if self._unpin is not None:
            self._unpin()
        self._unpin = self._host = self._pinned = None
        self._bufs, self._resident, self._stream = None, False, None
