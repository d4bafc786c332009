"""Named tracepoints and ``torch.profiler`` integration.

Counterpart of ``prosper_tpu/io/tracing.py``: host-side named tracepoints
with timestamps per process, written to a trace file; ``traced_region``
also annotates the profiler's timeline (``torch.profiler.record_function``)
and, on a CUDA device, opens an NVTX range; ``profile_trace`` captures a
device trace around any region and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from prosper_tpu_torch.utils import process_index

_tracefile = None
_t0 = None


def set_tracefile(path: Optional[str]) -> None:
    """Enable (path) or disable (None) host-side tracepoint logging.

    The %d in the path, if present, is replaced by the process index (the
    reference writes one trace file per MPI rank)."""
    global _tracefile, _t0
    if _tracefile is not None:
        _tracefile.close()
        _tracefile = None
    if path is not None:
        if "%d" in path:
            path = path % process_index()
        _tracefile = open(path, "a")
        _t0 = time.perf_counter()


def tracepoint(name: str) -> None:
    """Record a named timestamped event (no-op unless set_tracefile called)."""
    if _tracefile is not None:
        dt = time.perf_counter() - _t0
        _tracefile.write(f"{dt:12.6f} p{process_index()} {name}\n")
        _tracefile.flush()


@contextlib.contextmanager
def traced_region(name: str):
    """Tracepoint pair and a profiler annotation around a region, and an
    NVTX range where a CUDA device is present."""
    nvtx = (torch.cuda.nvtx.range(name) if torch.cuda.is_available()
            else contextlib.nullcontext())
    tracepoint(f"{name} begin")
    with torch.profiler.record_function(name), nvtx:
        yield
    tracepoint(f"{name} end")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the region (CPU activity, and CUDA activity where a CUDA
    device is present) and write a Chrome trace ``trace.<process
    index>.json`` into ``logdir``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if torch.cuda.is_available()
                                           else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace.{process_index()}.json"))
