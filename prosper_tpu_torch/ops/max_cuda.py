"""Hand-written CUDA kernel for the max-superposition (MCA / MMCA) E-step.

``max_et_estep`` replaces both TPU kernels of
``prosper_tpu/ops/max_pallas.py``, ``max_et_estep_pallas`` and
``max_et_estep_pallas_dtiled``: the hard-winner (rho <= 0) E-step, F per
datapoint and the weight-masked M-step sums.  It runs in three stages:
``P = y W`` by the ``sgemm_nn`` kernel (``ops/gemm_cuda.py``), the
per-datapoint kernel (``csrc/max_et_estep.cu``), which turns P's rows into
``w q_single`` in place, and the singleton part of numer,
``(w q_single)^T y``, by the ``sgemm_tn_splitn`` kernel; one call counts
once in ``LAUNCHES["max_estep"]``.  The library is built and loaded by
``ops/cuda_lib.py`` at first CUDA use.  On a CPU tensor the
wrapper runs the plain version (``core/maxstep.py``); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from prosper_tpu_torch.core import maxstep
from prosper_tpu_torch.core.etstep import LinearStateArrays
from prosper_tpu_torch.ops.cuda_lib import (LAUNCHES, SMEM_LIMIT, check,
                                            in_row_chunks, load_library,
                                            n_blocks, raise_on, scalars)
from prosper_tpu_torch.ops.gemm_cuda import (sgemm_nn_cuda,
                                             sgemm_tn_splitn_cuda)

__all__ = ["LAUNCHES", "max_et_estep", "max_et_estep_cuda"]

#: kernel limits: H' candidate slots (HPM) and multi states (32 * SPL), as
#: in the source
HP_MAX, S_MAX = 8, 128
TILE = 16                    # datapoints per tile, as TILE in the source
KEYS = ("abs", "resid", "y2", "n", "F", "F_true")


def _estep_rows(lib, y, weight, W, WT, gdiag, states, plan, lo, scal,
                sa: LinearStateArrays, Hp: int, magnitude: bool,
                collect_true: bool, smem: int):
    """The three stages on one chunk of rows: (F, sums (stride,))."""
    (N, D), H = y.shape, W.shape[1]
    S = sa.states.shape[0]
    dev = y.device
    nb = n_blocks(dev, smem, -(-N // TILE))
    stride = lib.max_et_estep_ws_stride(D, H)
    F = torch.empty(N, dtype=torch.float32, device=dev)
    ws = torch.empty(nb * stride, dtype=torch.float32, device=dev)
    sums = torch.empty(stride, dtype=torch.float32, device=dev)
    P = sgemm_nn_cuda(y, W)
    err = lib.max_et_estep(
        y.data_ptr(), weight.data_ptr(), P.data_ptr(), WT.data_ptr(),
        gdiag.data_ptr(), states.data_ptr(), sa.abs_states.data_ptr(),
        plan.data_ptr(), sa.values.data_ptr(), lo.data_ptr(),
        scal.data_ptr(), F.data_ptr(), ws.data_ptr(), sums.data_ptr(),
        N, D, H, Hp, S, int(magnitude), int(collect_true), nb,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "max_et_estep")
    # P holds w q_single: the singleton part of numer, after the blocks'
    sgemm_tn_splitn_cuda(P, y, out=sums[:H * D].view(H, D), accumulate=True)
    return F, sums


def max_et_estep_cuda(y, weight, W, sigma2, log_odds, sa: LinearStateArrays,
                      Hp: int, magnitude: bool, beta, prior_beta,
                      collect_true: bool = True
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The hard-winner E-step kernels on CUDA tensors; same contract as
    ``core.maxstep.max_et_estep`` with rho <= 0 (any N; rows are chunked
    only where the (N, H) workspace for P would exceed
    ``cuda_lib.P_LIMIT_BYTES``).
    Returns (F (N,), sums) with numer, denom (H, D), s (H) and the scalars
    abs, resid, y2, n, F, F_true."""
    if y.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {y.device}")
    N, D = y.shape
    H = W.shape[1]
    S = sa.states.shape[0]
    dev = y.device
    check(y, "y", (N, D), dev)
    check(weight, "weight", (N,), dev)
    check(W, "W", (D, H), dev)
    lo = torch.as_tensor(log_odds, dtype=torch.float32, device=dev)
    if lo.numel() != 1:
        raise ValueError(f"log_odds must be a scalar, got shape {lo.shape}")
    check(sa.states, "states", (S, Hp), dev)
    check(sa.abs_states, "abs_states", (S,), dev)
    check(sa.values, "values", (1,), dev)     # binary states: values [1.0]
    if N < 1:
        raise ValueError("need at least one datapoint")
    if not (Hp <= HP_MAX and S <= S_MAX):
        raise ValueError(f"kernel limits: Hp <= {HP_MAX}, S <= {S_MAX}; "
                         f"got {Hp=} {S=}")
    lib = load_library()
    smem = lib.max_et_smem_bytes(D, H, Hp, S)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a tile needs {smem} bytes of shared memory, more "
                         f"than the {SMEM_LIMIT} a block may use")
    plan = maxstep.dp_plan(sa.states).flat
    WT = W.T.contiguous()
    gdiag = (W * W).sum(dim=0)
    states = sa.states.T.contiguous()           # state-minor, as the lanes
    lo = lo.reshape(1).contiguous()
    scal = scalars(sigma2, beta, prior_beta, dev)
    F, sums = in_row_chunks(N, H, lambda i, j: _estep_rows(
        lib, y[i:j], weight[i:j], W, WT, gdiag, states, plan, lo, scal, sa,
        Hp, magnitude, collect_true, smem))
    LAUNCHES["max_estep"] += 1
    HD = H * D
    out = dict(numer=sums[:HD].view(H, D), denom=sums[HD:2 * HD].view(H, D),
               s=sums[2 * HD:2 * HD + H])
    for j, k in enumerate(KEYS):
        out[k] = sums[2 * HD + H + j]
    return F, out


def max_et_estep(y, weight, W, sigma2, log_odds, sa: LinearStateArrays,
                 Hp: int, magnitude: bool, beta, prior_beta,
                 chunk: int = 2048, collect_true: bool = True):
    """Hard-winner E-step: the kernel on a CUDA tensor, its plain version
    (``core.maxstep.max_et_estep``, chunked by ``chunk``) on a CPU one."""
    if y.device.type == "cpu":
        return maxstep.max_et_estep(y, weight, W, sigma2, log_odds, sa, Hp,
                                    magnitude, beta, prior_beta, chunk,
                                    collect_true=collect_true)
    return max_et_estep_cuda(y, weight, W, sigma2, log_odds, sa, Hp,
                             magnitude, beta, prior_beta, collect_true)
