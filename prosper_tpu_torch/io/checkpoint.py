"""Explicit checkpoint / resume.

Counterpart of ``prosper_tpu/io/checkpoint.py``, with its file layout: an
HDF5 file (read and written by ``io/hdf5.py``) with ``attrs["step"]``, a
group ``params`` (one dataset per parameter) and an optional group
``extra`` (``F_prev``, the revival chain's state and cadence).  Each package reads the other's params, step and extra.

The JAX package writes its PRNG key under ``rng``; the port writes its
``torch.Generator`` state (``get_state()``, a uint8 vector) under
``torch_rng``, with the generator's device type in the dataset's
``device_type`` attribute, and never writes ``rng``.  A CUDA generator's
state (seed and offset of its Philox counter) does not load into a CPU
generator, nor the other way round: ``restore_full`` returns the state only
where it fits the requested device (``EM.resume`` warns that the noise
chain restarts from the seed where it gets none).

``resume_from_h5`` reads row ``row`` of a per-iteration result table
written by ``StoreToH5`` (the reference's implicit resume).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from prosper_tpu_torch.io import hdf5
from prosper_tpu_torch.io.datalog import host
from prosper_tpu_torch.utils import process_index


def save(path: str, params: Dict, step: int,
         generator: Optional[torch.Generator] = None,
         extra: Optional[Dict] = None) -> None:
    """Write a checkpoint (process 0 only)."""
    if process_index() != 0:
        return
    with hdf5.File(path, "w") as f:
        f.attrs["step"] = int(step)
        g = f.create_group("params")
        for k, v in params.items():
            g.create_dataset(k, data=host(v))
        if generator is not None:
            ds = f.create_dataset("torch_rng",
                                  data=generator.get_state().numpy())
            ds.attrs["device_type"] = generator.device.type
        if extra:
            ge = f.create_group("extra")
            for k, v in extra.items():
                ge.create_dataset(k, data=host(v))


def restore(path: str, device="cuda"
            ) -> Tuple[Dict[str, torch.Tensor], int, Optional[torch.Tensor]]:
    """Load (params, step, generator state or None) from a checkpoint."""
    params, step, state, _ = restore_full(path, device)
    return params, step, state


def restore_full(path: str, device="cuda"
                 ) -> Tuple[Dict[str, torch.Tensor], int,
                            Optional[torch.Tensor], Dict[str, np.ndarray]]:
    """Load (params, step, generator state or None, extra).

    Params come back as float32 tensors on ``device``; ``extra`` as numpy.
    The state is None when the file holds none (a JAX checkpoint holds a
    PRNG key, not a torch state) and when it was written by a generator of
    another device type than ``device``'s."""
    device = torch.device(device)
    with hdf5.File(path, "r") as f:
        step = int(f.attrs["step"])
        params = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                  for k, v in f["params"].items()}
        state = None
        if "torch_rng" in f:
            ds = f["torch_rng"]
            if str(ds.attrs["device_type"]) == device.type:
                state = torch.from_numpy(np.asarray(ds, np.uint8))
        extra = {}
        if "extra" in f:
            extra = {k: np.asarray(v) for k, v in f["extra"].items()}
    return params, step, state, extra


def resume_from_h5(path: str, param_names=("W", "pi", "sigma"),
                   row: int = -1, device="cuda"
                   ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Reference-style resume: row ``row`` of a per-iteration result table
    written by StoreToH5, as (params on ``device``, step)."""
    with hdf5.File(path, "r") as f:
        params = {}
        n_rows = None
        for name in param_names:
            if name not in f:
                raise KeyError(f"{name!r} not found in {path}")
            ds = f[name]
            n_rows = ds.shape[0]
            params[name] = torch.as_tensor(np.asarray(ds[row], np.float32),
                                           device=device)
        step = row if row >= 0 else n_rows + row
    return params, step
