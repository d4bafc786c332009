"""The measured window, its clock and, with ``--trace 1``, its profile.

The window's length comes from the host clock and ends in a device
synchronisation.  Traced, ``torch.profiler`` records the device (CUPTI)
and the host's torch operations over the window; ``Summary`` reduces the
trace: the seconds in which some operation ran on the device (the union of
the device intervals, all streams), device seconds by kernel name and by
the class that ``metrics/kernels.json`` gives each of the program's
kernels, the ten operations that took most of the device, and the longest
idle gaps by the host operation running in them.  The sums by name and the
idle share follow the repository's kernel-times tool (``profile``), with
busy time as a union, so that operations on two streams count once.
"""

from __future__ import annotations

import json
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

KERNELS = Path(__file__).resolve().parent / "metrics" / "kernels.json"


def kernel_classes() -> List[Tuple[re.Pattern, str]]:
    """``metrics/kernels.json``: a kernel's function name (or a prefix
    ending in ``*``) -> the class of work it does."""
    with open(KERNELS) as f:
        table = json.load(f)["kernels"]
    out = []
    for name, cls in table.items():
        if name.endswith("*"):
            pat = re.compile(r"^(?:void\s+)?" + re.escape(name[:-1]))
        else:
            pat = re.compile(r"(?:^|[\s:])" + re.escape(name) + r"(?:<|\(|$)")
        out.append((pat, cls))
    return out


def classify(name: str, classes) -> Optional[str]:
    for pat, cls in classes:
        if pat.search(name):
            return cls
    return None


def union_seconds(intervals: List[Tuple[float, float]]):
    """(total covered seconds, merged intervals) of (start, end) pairs."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


class Summary:
    """A traced window reduced to what the readers need."""

    def __init__(self, device_events, host_events, window_s: float):
        """``device_events``, ``host_events``: (name, start_s, end_s)."""
        classes = kernel_classes()
        self.window_s = window_s
        self.busy_s, merged = union_seconds([(s, e)
                                             for _, s, e in device_events])
        self.by_name: Dict[str, float] = {}
        self.by_class: Dict[str, float] = {}
        self.count_by_class: Dict[str, int] = {}
        for name, s, e in device_events:
            self.by_name[name] = self.by_name.get(name, 0.0) + (e - s)
            cls = classify(name, classes)
            if cls is not None:
                self.by_class[cls] = self.by_class.get(cls, 0.0) + (e - s)
                self.count_by_class[cls] = self.count_by_class.get(cls, 0) + 1
        self.device_ops = sorted(self.by_name.items(),
                                 key=lambda kv: -kv[1])[:10]
        self.idle_gaps = self._gaps(merged, host_events)

    @staticmethod
    def _gaps(merged, host_events, n_gaps: int = 200):
        """The longest idle gaps between device intervals, summed by the
        innermost host operation running at each gap's middle."""
        import numpy as np
        gaps = sorted(((b[0] - a[1], 0.5 * (a[1] + b[0]))
                       for a, b in zip(merged[:-1], merged[1:])),
                      reverse=True)[:n_gaps]
        starts = np.array([ev[1] for ev in host_events], dtype=np.float64)
        ends = np.array([ev[2] for ev in host_events], dtype=np.float64)
        by: Dict[str, float] = {}
        for length, mid in gaps:
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            key = "(no torch operation)"
            if inside.size:
                j = inside[np.argmin(ends[inside] - starts[inside])]
                key = host_events[j][0]
            by[key] = by.get(key, 0.0) + length
        return sorted(by.items(), key=lambda kv: -kv[1])[:10]

    def seconds(self, *classes: str) -> float:
        return sum(self.by_class.get(c, 0.0) for c in classes)

    def has(self, cls: str) -> bool:
        return self.count_by_class.get(cls, 0) > 0

    def as_dict(self) -> Dict:
        return {"busy_s": self.busy_s, "window_s": self.window_s,
                "by_class": self.by_class,
                "count_by_class": self.count_by_class,
                "device_ops": self.device_ops, "idle_gaps": self.idle_gaps}

    @classmethod
    def from_dict(cls, d: Dict) -> "Summary":
        self = cls.__new__(cls)
        self.__dict__.update(d)
        self.device_ops = [tuple(x) for x in d["device_ops"]]
        self.idle_gaps = [tuple(x) for x in d["idle_gaps"]]
        return self


class Window:
    """``with Window(trace, device) as w:`` times the block, which must end
    with the device synchronised; traced, it profiles it too.
    ``w.seconds`` is the window's length, ``w.summary()`` its trace."""

    def __init__(self, trace: bool, device):
        self.trace = trace
        self.device = device
        self.prof = None
        self.t0 = self.seconds = None

    def __enter__(self):
        import torch
        if self.trace and self.device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            # the tracer can miss the first kernels after it starts
            torch.ones(1, device=self.device).add_(1.0)
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def __exit__(self, *exc):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds = time.perf_counter() - self.t0
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def summary(self) -> Optional[Summary]:
        if self.prof is None:
            return None
        dev, host = raw_events(self.prof)
        if not dev:
            raise RuntimeError("the profiler recorded no device operation")
        return Summary(dev, host, self.seconds)


def raw_events(prof):
    """(device events, host events) of a finished ``torch.profiler``
    session as (name, start_s, end_s), read from its raw results: building
    the profiler's tree of events takes minutes for a window of many small
    calls."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        rec = (e.name(), s, s + e.duration_ns() * 1e-9)
        (dev if e.device_type() == cuda else host).append(rec)
    return dev, host
