"""Hand-written float32 GEMM kernels of the ET E-steps (``csrc/sgemm.cu``).

* ``sgemm_nn``:         C (N, H) = A (N, D) @ B (D, H), the projection
  ``P = y @ W`` of both E-step kernels;
* ``sgemm_tn_splitn``:  C (M, K) = A.T @ B for A (N, M), B (N, K), the
  reduction over N cut into splits that are summed in order (no atomics):
  ``xs = y.T @ sw`` of the linear family and the singleton part of numer,
  ``qsw.T @ y``, of the max family.

They stand for the products inside the bodies of the TPU kernels
(``prosper_tpu/ops/linear_pallas.py::_kernel``,
``prosper_tpu/ops/max_pallas.py::_kernel``), which is why they are kernels
of this package and not library calls.  On a CPU tensor a wrapper runs the
plain version (``torch.matmul``); on a CUDA tensor it launches the kernel or
raises.  Both run in full float32 (``fmaf`` on the CUDA cores).
"""

from __future__ import annotations

from typing import Optional

import torch

from prosper_tpu_torch.ops.cuda_lib import (LAUNCHES, check, load_library,
                                            raise_on)

__all__ = ["sgemm_nn", "sgemm_nn_cuda", "sgemm_tn_splitn",
           "sgemm_tn_splitn_cuda", "SPLIT_ROWS"]

#: rows of N per split of ``sgemm_tn_splitn``; the number of splits, and so
#: the order of the sum, depends on N alone
SPLIT_ROWS = 1024
#: the kernels index their grids with 16 bits in two dimensions
N_MAX = 65535 * 128


def _check_pair(a: torch.Tensor, b: torch.Tensor, rows_match: bool):
    """Raise ValueError unless a and b are contiguous 2-D float32 tensors
    on one device whose shapes fit the product."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"need two matrices, got shapes {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    check(a, "a", a.shape, a.device)
    check(b, "b", b.shape, a.device)
    inner = (a.shape[0], b.shape[0]) if rows_match else (a.shape[1],
                                                         b.shape[0])
    if inner[0] != inner[1]:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} do "
                         "not fit the product")
    if min(*a.shape, *b.shape) < 1:
        raise ValueError("empty operand")


def sgemm_nn_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` by the ``sgemm_nn`` kernel."""
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {a.device}")
    _check_pair(a, b, rows_match=False)
    (N, D), H = a.shape, b.shape[1]
    if N > N_MAX:
        raise ValueError(f"kernel limit: at most {N_MAX} rows, got {N}")
    out = torch.empty((N, H), dtype=torch.float32, device=a.device)
    lib = load_library()
    err = lib.sgemm_nn(a.data_ptr(), b.data_ptr(), out.data_ptr(), N, D, H,
                       torch.cuda.current_stream(a.device).cuda_stream)
    raise_on(lib, err, "sgemm_nn")
    LAUNCHES["sgemm_nn"] += 1
    return out


def sgemm_tn_splitn_cuda(a: torch.Tensor, b: torch.Tensor,
                         out: Optional[torch.Tensor] = None,
                         accumulate: bool = False) -> torch.Tensor:
    """``a.T @ b`` by the ``sgemm_tn_splitn`` kernel: one partial per
    ``SPLIT_ROWS`` rows, the partials summed in order into ``out`` (added to
    what it holds when ``accumulate``)."""
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {a.device}")
    _check_pair(a, b, rows_match=True)
    (N, M), K = a.shape, b.shape[1]
    if N > N_MAX:
        raise ValueError(f"kernel limit: at most {N_MAX} rows, got {N}")
    if out is None:
        if accumulate:
            raise ValueError("accumulate needs out")
        out = torch.empty((M, K), dtype=torch.float32, device=a.device)
    else:
        check(out, "out", (M, K), a.device)
    n_split = -(-N // SPLIT_ROWS)
    ws = torch.empty(n_split * M * K, dtype=torch.float32, device=a.device)
    lib = load_library()
    err = lib.sgemm_tn_splitn(
        a.data_ptr(), b.data_ptr(), ws.data_ptr(), out.data_ptr(), N, M, K,
        SPLIT_ROWS, int(accumulate),
        torch.cuda.current_stream(a.device).cuda_stream)
    raise_on(lib, err, "sgemm_tn_splitn")
    LAUNCHES["sgemm_tn"] += 1
    return out


def sgemm_nn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``: the kernel on CUDA tensors, ``torch.matmul`` on CPU ones."""
    if a.device.type == "cpu":
        _check_pair(a, b, rows_match=False)
        return torch.matmul(a, b)
    return sgemm_nn_cuda(a, b)


def sgemm_tn_splitn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.T @ b``: the kernel on CUDA tensors, ``torch.matmul`` on CPU
    ones."""
    if a.device.type == "cpu":
        _check_pair(a, b, rows_match=True)
        return torch.matmul(a.T, b)
    return sgemm_tn_splitn_cuda(a, b)
