"""Hand-written CUDA kernel for the max-superposition (MCA / MMCA) E-step.

``max_et_estep`` (``csrc/max_et_estep.cu``) replaces both TPU kernels of
``prosper_tpu/ops/max_pallas.py``, ``max_et_estep_pallas`` and
``max_et_estep_pallas_dtiled``: the hard-winner (rho <= 0) E-step, F per
datapoint and the weight-masked M-step sums.  The library is built and
loaded by ``ops/cuda_lib.py`` at first CUDA use.  On a CPU tensor the
wrapper runs the plain version (``core/maxstep.py``); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from prosper_tpu_torch.core import maxstep
from prosper_tpu_torch.core.etstep import LinearStateArrays
from prosper_tpu_torch.ops.cuda_lib import (LAUNCHES, SMEM_LIMIT, check,
                                            load_library, n_blocks, raise_on,
                                            scalars)

__all__ = ["LAUNCHES", "max_et_estep", "max_et_estep_cuda"]

#: kernel limits: H' candidate slots (HPM), multi states (32 * SPL) and
#: units (the projection's register blocking), as in the source
HP_MAX, S_MAX, H_MAX = 8, 128, 1024
TILE = 16                    # datapoints per tile, as TILE in the source
KEYS = ("abs", "resid", "y2", "n", "F", "F_true")


def max_et_estep_cuda(y, weight, W, sigma2, log_odds, sa: LinearStateArrays,
                      Hp: int, magnitude: bool, beta, prior_beta,
                      collect_true: bool = True
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The fused hard-winner E-step kernel on CUDA tensors; same contract
    as ``core.maxstep.max_et_estep`` with rho <= 0 (any N, no chunking).
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
    if not (Hp <= HP_MAX and S <= S_MAX and H <= H_MAX):
        raise ValueError(f"kernel limits: Hp <= {HP_MAX}, S <= {S_MAX}, "
                         f"H <= {H_MAX}; got {Hp=} {S=} {H=}")
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
    nb = n_blocks(dev, smem, -(-N // TILE))
    stride = lib.max_et_estep_ws_stride(D, H)
    F = torch.empty(N, dtype=torch.float32, device=dev)
    ws = torch.empty(nb * stride, dtype=torch.float32, device=dev)
    sums = torch.empty(stride, dtype=torch.float32, device=dev)
    err = lib.max_et_estep(
        y.data_ptr(), weight.data_ptr(), W.data_ptr(), WT.data_ptr(),
        gdiag.data_ptr(), states.data_ptr(), sa.abs_states.data_ptr(),
        plan.data_ptr(), sa.values.data_ptr(), lo.data_ptr(),
        scal.data_ptr(), F.data_ptr(), ws.data_ptr(), sums.data_ptr(),
        N, D, H, Hp, S, int(magnitude), int(collect_true), nb,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "max_et_estep")
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
