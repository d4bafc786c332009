"""Spans at the port's layer boundaries, and ``torch.profiler`` output.

Counterpart of ``prosper_tpu/io/tracing.py``.  One switch, ``enable``, off
by default.  Off, ``traced_region`` returns one shared no-op context: a
span then costs one flag check.  On, a region opens an NVTX range named
``prosper::<name>`` where a CUDA device is present and, while a
``torch.profiler`` session runs, ``torch.profiler.record_function`` of the
same name: the profiler's own host event, on the clock of its device
records, kept in its buffer until the session ends.  Regions nest on the
host thread.  Inside ``timed_regions`` each region also records a pair of
timing events on the current CUDA stream, which a CUDA graph captured
there records again at every replay: ``EM.run_scanned`` reads them into
``scan_stats["layer_ms"]``.  ``profile_trace`` captures a device trace
around any region and writes it as a Chrome trace.

The spans: ``em.build``, ``em.eager_step``, ``em.capture``, ``em.replay``,
``em.window_end`` (``engine/em.py``); ``estep``, ``ncut``, ``mstep`` (a
model's ``step_fn``: the linear family's, the max family's and GSC's), and
inside GSC's ``estep`` on the card ``gsc_rows`` (its E-step kernel,
``ops/gsc_cuda.py``) or, in the plain version, once per chunk of rows,
``slab_solve`` (the small Cholesky solves of every support) and
``slab_moments`` (<sz>, <sz sz^T> and their scatter to H)
(``core/gscstep.py``); ``inference`` (the linear
family's decode call) and inside it ``decode``, ``top_states``,
``recon_rows`` (``core/etstep.py``).
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Optional

import torch

from prosper_tpu_torch.utils import process_index

#: the prefix of every span's name in a profiler trace
PREFIX = "prosper::"

_on = False
_nvtx = False
#: where the regions record their timing events (``timed_regions``)
_pairs: Optional[List] = None
_OFF = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    """Turn the spans on or off (process-wide)."""
    global _on, _nvtx
    _on = bool(on)
    _nvtx = _on and torch.cuda.is_available()


def enabled() -> bool:
    return _on


class _Span:
    __slots__ = ("name", "_fn", "_pair", "_pairs")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # a record_function outside a profiler session records nothing, and
        # its dispatcher calls cost several microseconds
        self._fn = None
        if torch.autograd._profiler_enabled():
            self._fn = torch.profiler.record_function(PREFIX + self.name)
            self._fn.__enter__()
        if _nvtx:
            torch.cuda.nvtx.range_push(PREFIX + self.name)
        self._pairs = _pairs
        if self._pairs is not None:
            self._pair = (torch.cuda.Event(enable_timing=True, external=True),
                          torch.cuda.Event(enable_timing=True, external=True))
            self._pair[0].record()
        return self

    def __exit__(self, *exc):
        if self._pairs is not None:
            self._pair[1].record()
            self._pairs.append((self.name, *self._pair))
        if _nvtx:
            torch.cuda.nvtx.range_pop()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return False


def traced_region(name: str):
    """A span around a region: with the spans off a shared no-op context,
    on an NVTX range and, under the profiler, a profiler event named
    ``prosper::<name>``."""
    if not _on:
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def timed_regions():
    """Yields a list.  Within the block, with the spans on, each
    ``traced_region`` also records a pair of
    ``torch.cuda.Event(enable_timing=True, external=True)`` around itself
    on the current CUDA stream and appends ``(name, start, end)`` to the
    list; under stream capture the pair becomes two event-record nodes of
    the graph.  The list stays empty with the spans off."""
    global _pairs
    pairs: List = []
    if not _on:
        yield pairs
        return
    outer, _pairs = _pairs, pairs
    try:
        yield pairs
    finally:
        _pairs = outer


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
