"""Parameters between the JAX package and the port.

The JAX package's parameters, taken to the host with ``np.asarray``, become
the port's float32 tensors on a device, and back.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_numpy(params: Dict, device="cuda") -> Dict[str, torch.Tensor]:
    """{name: array-like} -> {name: float32 tensor on ``device``}."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_numpy``: host float32 numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
