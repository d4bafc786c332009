"""Hand-written GEMM kernels of the ET E-steps (``csrc/sgemm.cuh``).

* ``sgemm_nn``:         C (N, H) = A (N, D) @ B (D, H), the projection
  ``P = y @ W`` of both E-step kernels;
* ``sgemm_tn_splitn``:  C (M, K) = A.T @ B for A (N, M), B (N, K), the
  reduction over N cut into splits that are summed in order (no atomics):
  ``xs = y.T @ sw`` of the linear family and the singleton part of numer,
  ``qsw.T @ y``, of the max family.

They stand for the products inside the bodies of the TPU kernels
(``prosper_tpu/ops/linear_pallas.py::_kernel``,
``prosper_tpu/ops/max_pallas.py::_kernel``), which is why they are kernels
of this package and not library calls.  They take CUDA tensors only: on a
CPU tensor the E-step routes run the plain versions (``torch.matmul``) in
their place.  Both run on the tensor cores in split TF32: each operand is cut
into two TF32 numbers (hi + lo, to 2^-22 relative), a product is the sum
of three TF32 products (lo x lo dropped), and the tensor cores' sums of
short runs of depth (a slab of 32, or 8 where the whole depth is one slab)
are added to a float32 running sum.  That keeps float32 accuracy (not the
rounding of an IEEE ``fmaf`` chain: the tests' float32 tolerances, rtol
1e-5 and atol 2e-7 per unit of depth), is exact on inputs quantised to
1/4, and gives the same bits on every call.

``hgemm_nn`` and ``hgemm_tn_splitn`` are the same two products of the
operands rounded to bf16 or fp16 (to nearest even), one tensor-core pass
summed in float32: the linear family's ``compute_dtype``.  They take and
give float32 tensors, as the split-TF32 kernels do (the kernels round y
and W on their way into shared memory, so no cast pass runs over y), and
count in ``LAUNCHES["hgemm_nn"]`` and ``["hgemm_tn"]``.  Their plain
version is ``core/etstep.py::matmul_as``, the float32 product of the
rounded operands, which they match within the same float32 tolerances.
``hgemm_tn_splitn`` has two kernels: ``csrc/hgemm_tn.cuh``'s, of bulk
tensor copies (TMA) into an mbarrier ring, rounding without transposition
and both MMA operands in shared memory, and ``csrc/sgemm.cuh``'s cp.async
kernel for the shapes a tensor map cannot describe; ``hgemm_tn_bulk`` is
the rule between them, and ``HGEMM_TN_PATHS`` counts the launches of
each.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from prosper_tpu_torch.ops.cuda_lib import (LAUNCHES, check, check_input,
                                            load_library, raise_on)

__all__ = ["HGEMM_TN_PATHS", "hgemm_nn_cuda", "hgemm_tn_bulk",
           "hgemm_tn_splitn_cuda", "sgemm_nn_cuda", "sgemm_tn_splitn_cuda",
           "split_rows"]

#: ``sgemm_tn_splitn`` cuts its sum over N into about this many splits, of
#: a multiple of 32 rows and at least ``MIN_SPLIT_ROWS`` each: at the
#: patches width 33 splits of a 2 x 2 tile grid are 132 blocks, one for each
#: SM of an H100.  The number of splits, and so the order of the sum,
#: depends on N alone.
SPLITS = 33
MIN_SPLIT_ROWS = 256
#: the kernels index their grids with 16 bits in two dimensions
N_MAX = 65535 * 128
#: the 16-bit operand types of ``hgemm_*``, by the suffix of their C entry
#: points (csrc/hgemm_bf16.cu, csrc/hgemm_f16.cu)
HALF_TYPES = {torch.bfloat16: "bf16", torch.float16: "f16"}
#: rows of depth in a slab of ``hgemm_tn_splitn``'s bulk-copy kernel
#: (``csrc/hgemm_tn.cuh``: ``htn::BK``); ``split_rows`` is a multiple of it
HTN_SLAB_ROWS = 32
#: launches of ``hgemm_tn_splitn`` by kernel: ``"bulk"`` (bulk tensor
#: copies, ``csrc/hgemm_tn.cuh``) and ``"cp_async"`` (``csrc/sgemm.cuh``'s
#: ``tn_kernel``, for the shapes a tensor map cannot describe); each call
#: also counts once in ``LAUNCHES["hgemm_tn"]``
HGEMM_TN_PATHS: Dict[str, int] = {"bulk": 0, "cp_async": 0}


def split_rows(N: int) -> int:
    """Rows of N in each split of ``sgemm_tn_splitn``'s sum."""
    return max(MIN_SPLIT_ROWS, -(-N // (32 * SPLITS)) * 32)


def hgemm_tn_bulk(M: int, K: int, a_ptr: int, b_ptr: int) -> bool:
    """Whether ``hgemm_tn_splitn`` of ``a`` (N, M) and ``b`` (N, K) at
    ``a_ptr`` and ``b_ptr`` takes its bulk-copy kernel: a tensor map needs
    a row stride of whole 16-byte pieces and a 16-byte aligned base, so M
    and K are multiples of 4 floats and both pointers 16-byte aligned.
    Else the cp.async kernel with 4-byte copies.  The kernel refuses a
    shape this rule does not give it."""
    return M % 4 == 0 and K % 4 == 0 and a_ptr % 16 == 0 and b_ptr % 16 == 0


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


def _half_code(dtype) -> str:
    if dtype not in HALF_TYPES:
        raise ValueError(f"the 16-bit GEMM kernels take torch.bfloat16 or "
                         f"torch.float16, got {dtype}")
    return HALF_TYPES[dtype]


def _nn_cuda(a, b, code: Optional[str]) -> torch.Tensor:
    """``a @ b`` by ``sgemm_nn`` (code None) or ``hgemm_nn`` (the suffix of
    its 16-bit type)."""
    check_input(a)
    _check_pair(a, b, rows_match=False)
    (N, D), H = a.shape, b.shape[1]
    if N > N_MAX:
        raise ValueError(f"kernel limit: at most {N_MAX} rows, got {N}")
    out = torch.empty((N, H), dtype=torch.float32, device=a.device)
    lib = load_library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    name = "sgemm_nn" if code is None else "hgemm_nn"
    # b's image: split TF32, or rounded to the 16-bit type
    img = torch.empty(getattr(lib, f"{name}_ws_floats")(D, H),
                      dtype=torch.float32, device=a.device)
    ptrs = (a.data_ptr(), b.data_ptr(), img.data_ptr(), out.data_ptr(), N, D,
            H)
    err = (lib.sgemm_nn(*ptrs, stream) if code is None
           else getattr(lib, f"hgemm_nn_{code}")(*ptrs, stream))
    raise_on(lib, err, name)
    LAUNCHES[name] += 1
    return out


def _tn_cuda(a, b, code: Optional[str], out: Optional[torch.Tensor],
             accumulate: bool) -> torch.Tensor:
    """``a.T @ b`` by ``sgemm_tn_splitn`` (code None) or ``hgemm_tn_splitn``
    (the suffix of its 16-bit type)."""
    check_input(a)
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
    rows = split_rows(N)
    n_split = -(-N // rows)
    ws = torch.empty(n_split * M * K, dtype=torch.float32, device=a.device)
    lib = load_library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    args = (a.data_ptr(), b.data_ptr(), ws.data_ptr(), out.data_ptr(), N, M,
            K, rows, int(accumulate))
    if code is None:
        raise_on(lib, lib.sgemm_tn_splitn(*args, stream), "sgemm_tn_splitn")
        LAUNCHES["sgemm_tn"] += 1
        return out
    bulk = hgemm_tn_bulk(M, K, a.data_ptr(), b.data_ptr())
    raise_on(lib, getattr(lib, f"hgemm_tn_splitn_{code}")(*args, int(bulk),
                                                          stream),
             "hgemm_tn_splitn")
    LAUNCHES["hgemm_tn"] += 1
    HGEMM_TN_PATHS["bulk" if bulk else "cp_async"] += 1
    return out


def sgemm_nn_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` by the ``sgemm_nn`` kernel."""
    return _nn_cuda(a, b, None)


def sgemm_tn_splitn_cuda(a: torch.Tensor, b: torch.Tensor,
                         out: Optional[torch.Tensor] = None,
                         accumulate: bool = False) -> torch.Tensor:
    """``a.T @ b`` by the ``sgemm_tn_splitn`` kernel: one partial per
    ``split_rows(N)`` rows, the partials summed in order into ``out`` (added to
    what it holds when ``accumulate``)."""
    return _tn_cuda(a, b, None, out, accumulate)


def hgemm_nn_cuda(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``a @ b`` of the operands rounded to ``dtype`` (``torch.bfloat16`` or
    ``torch.float16``), summed in float32, by the ``hgemm_nn`` kernel."""
    return _nn_cuda(a, b, _half_code(dtype))


def hgemm_tn_splitn_cuda(a: torch.Tensor, b: torch.Tensor, dtype,
                         out: Optional[torch.Tensor] = None,
                         accumulate: bool = False) -> torch.Tensor:
    """``a.T @ b`` of the operands rounded to ``dtype``, summed in float32,
    by the ``hgemm_tn_splitn`` kernel; ``out`` and ``accumulate`` as
    ``sgemm_tn_splitn_cuda``'s."""
    return _tn_cuda(a, b, _half_code(dtype), out, accumulate)
