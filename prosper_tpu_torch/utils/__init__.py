"""Misc utilities (counterpart of ``prosper_tpu/utils/__init__.py``)."""

from __future__ import annotations

import os
import sys
import time
import weakref
from typing import Dict, Optional

import torch


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def process_index() -> int:
    """This process's rank under ``torch.distributed`` when a process group
    is initialised, else 0 (the JAX package reads ``jax.process_index()``)."""
    return torch.distributed.get_rank() if _distributed() else 0


def process_count() -> int:
    """The world size under ``torch.distributed``, else 1."""
    return torch.distributed.get_world_size() if _distributed() else 1


def create_output_path(basename: Optional[str] = None,
                       root: str = "output") -> str:
    """Create a timestamped results directory (process 0 creates it).

    The path is authoritative on process 0 only: the other processes do not
    walk the collision suffixes, since every file writer of the package is
    rank-0-only (data log handlers, checkpoints)."""
    if basename is None:
        basename = os.path.splitext(os.path.basename(sys.argv[0]))[0] or "run"
    stamp = time.strftime("%Y-%m-%d+%H:%M")
    path = os.path.join(root, f"{basename}.{stamp}")
    if process_index() != 0:
        return path
    suffix = 0
    final = path
    while os.path.exists(final):
        suffix += 1
        final = f"{path}.{suffix:03d}"
    os.makedirs(final, exist_ok=True)
    return final


_PER_TENSOR: Dict[tuple, tuple] = {}


def cached_for(owner: torch.Tensor, name: str, build):
    """``build()``, made once for the tensor ``owner`` (by identity) and
    kept for as long as it lives: what is derived from a model's state
    tables alone (transposed or reduced copies, level plans) is not rebuilt
    on every call."""
    key = (id(owner), name)
    hit = _PER_TENSOR.get(key)
    if hit is not None and hit[0]() is owner:
        return hit[1]
    value = build()
    _PER_TENSOR[key] = (weakref.ref(
        owner, lambda _, key=key: _PER_TENSOR.pop(key, None)), value)
    return value
