"""Hand-written CUDA kernels for the linear-family ET E-step and decode.

Two kernels share one front end (``csrc/linear_et_frontend.cuh``):

* ``linear_et_estep``  (``csrc/linear_et_estep.cu``) replaces
  ``prosper_tpu/ops/linear_pallas.py::linear_et_estep_pallas``: F per
  datapoint and the weight-masked sufficient statistics (training).
* ``linear_et_decode`` (``csrc/linear_et_decode.cu``) replaces
  ``linear_et_decode_pallas``: F, the posterior mean, the top-L states in
  canonical union indices and the candidates (serving).

The library is built and loaded by ``ops/cuda_lib.py`` at first CUDA use
(never at import).  Each wrapper checks its inputs, allocates outputs and
scratch with ``torch.empty``, launches on the current stream and adds one
to ``LAUNCHES``.  On a CPU tensor a wrapper runs the kernel's plain version
(``core/etstep.py``); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from prosper_tpu_torch.core import etstep
from prosper_tpu_torch.core.etstep import LinearStateArrays
from prosper_tpu_torch.ops.cuda_lib import (LAUNCHES, SMEM_LIMIT, check,
                                            load_library, n_blocks, raise_on,
                                            scalars)

__all__ = ["LAUNCHES", "load_library", "linear_et_estep",
           "linear_et_estep_cuda", "linear_et_decode", "linear_et_decode_cuda"]

HP_MAX, K_MAX, H_MAX = 32, 8, 1024
TILE = 16                    # datapoints per tile, as TILE in the sources


def _check_common(y, W, log_odds, sa: LinearStateArrays, Hp: int):
    """Validate the shared inputs, then build/load the kernels.
    Returns (lib, N, D, H, S, K, smem bytes)."""
    if y.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {y.device}")
    N, D = y.shape
    H = W.shape[1]
    S, K = sa.value_counts.shape
    dev = y.device
    check(y, "y", (N, D), dev)
    check(W, "W", (D, H), dev)
    check(log_odds, "log_odds", (K,), dev)
    check(sa.states, "states", (S, Hp), dev)
    check(sa.outer, "outer", (S, Hp * Hp), dev)
    check(sa.value_counts, "value_counts", (S, K), dev)
    check(sa.abs_states, "abs_states", (S,), dev)
    check(sa.values, "values", (K,), dev)
    if N < 1:
        raise ValueError("need at least one datapoint")
    if not (Hp <= HP_MAX and K <= K_MAX and H <= H_MAX):
        raise ValueError(f"kernel limits: Hp <= {HP_MAX}, K <= {K_MAX}, "
                         f"H <= {H_MAX}; got {Hp=} {K=} {H=}")
    lib = load_library()
    smem = lib.linear_et_smem_bytes(D, H, Hp, S, K)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a tile needs {smem} bytes of shared memory, more "
                         f"than the {SMEM_LIMIT} a block may use")
    return lib, N, D, H, S, K, smem


def _state_minor(sa: LinearStateArrays):
    """The state tables as the kernels read them: transposed, so that the
    lanes of a warp, which walk the states, read consecutive addresses."""
    return (sa.states.T.contiguous(), sa.outer.T.contiguous(),
            sa.value_counts.T.contiguous())


def linear_et_estep_cuda(y, weight, W, sigma2, log_odds,
                         sa: LinearStateArrays, Hp: int, signed_select: bool,
                         beta, prior_beta, collect_true: bool = True
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The fused E-step kernel on CUDA tensors; same contract as
    ``core.etstep.linear_et_estep`` (any N, no chunking)."""
    lib, N, D, H, S, K, smem = _check_common(y, W, log_odds, sa, Hp)
    dev = y.device
    check(weight, "weight", (N,), dev)
    gram = (W.T @ W).contiguous()
    scal = scalars(sigma2, beta, prior_beta, dev)
    states, outer, vcounts = _state_minor(sa)
    nb = n_blocks(dev, smem, -(-N // TILE))
    stride = lib.linear_et_estep_ws_stride(D, H, K)
    F = torch.empty(N, dtype=torch.float32, device=dev)
    ws = torch.empty(nb * stride, dtype=torch.float32, device=dev)
    sums = torch.empty(stride, dtype=torch.float32, device=dev)
    err = lib.linear_et_estep(
        y.data_ptr(), weight.data_ptr(), W.data_ptr(), gram.data_ptr(),
        states.data_ptr(), outer.data_ptr(), vcounts.data_ptr(),
        sa.abs_states.data_ptr(),
        sa.values.data_ptr(), log_odds.data_ptr(), scal.data_ptr(),
        F.data_ptr(), ws.data_ptr(), sums.data_ptr(),
        N, D, H, Hp, S, K, int(signed_select), int(collect_true), nb,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "linear_et_estep")
    LAUNCHES["estep"] += 1
    o = D * H + H * H
    out = dict(xs=sums[:D * H].view(D, H), ss=sums[D * H:o].view(H, H),
               s=sums[o:o + H], vc=sums[o + H:o + H + K])
    for j, k in enumerate(("abs", "y2", "n", "F", "F_true")):
        out[k] = sums[o + H + K + j]
    return F, out


def linear_et_decode_cuda(y, W, sigma2, log_odds, sa: LinearStateArrays,
                          Hp: int, signed_select: bool, top_L: int, beta,
                          prior_beta):
    """The fused decode kernel on CUDA tensors; same contract as
    ``core.etstep.linear_et_decode``."""
    lib, N, D, H, S, K, _ = _check_common(y, W, log_odds, sa, Hp)
    if top_L > 1 + H * K + S:
        raise ValueError(f"top_L={top_L} exceeds the {1 + H * K + S} "
                         "posterior columns")
    dev = y.device
    gram = (W.T @ W).contiguous()
    scal = scalars(sigma2, beta, prior_beta, dev)
    states, outer, vcounts = _state_minor(sa)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    F, s_mean, top_q = empty(N), empty(N, H), empty(N, top_L)
    top_u, cand = empty(N, top_L, dtype=torch.int32), empty(
        N, Hp, dtype=torch.int32)
    err = lib.linear_et_decode(
        y.data_ptr(), W.data_ptr(), gram.data_ptr(), states.data_ptr(),
        outer.data_ptr(), vcounts.data_ptr(), sa.values.data_ptr(),
        log_odds.data_ptr(), scal.data_ptr(), F.data_ptr(),
        s_mean.data_ptr(), top_q.data_ptr(), top_u.data_ptr(),
        cand.data_ptr(), N, D, H, Hp, S, K, top_L, int(signed_select),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "linear_et_decode")
    LAUNCHES["decode"] += 1
    return F, s_mean, top_q, top_u, cand


def linear_et_estep(y, weight, W, sigma2, log_odds, sa: LinearStateArrays,
                    Hp: int, signed_select: bool, beta, prior_beta,
                    chunk: int = 2048, collect_true: bool = True):
    """E-step: the kernel on a CUDA tensor, its plain version
    (``core.etstep.linear_et_estep``, chunked by ``chunk``) on a CPU one."""
    if y.device.type == "cpu":
        return etstep.linear_et_estep(y, weight, W, sigma2, log_odds, sa, Hp,
                                      signed_select, beta, prior_beta, chunk,
                                      collect_true)
    return linear_et_estep_cuda(y, weight, W, sigma2, log_odds, sa, Hp,
                                signed_select, beta, prior_beta, collect_true)


def linear_et_decode(y, W, sigma2, log_odds, sa: LinearStateArrays, Hp: int,
                     signed_select: bool, top_L: int, beta, prior_beta,
                     chunk: int = 4096):
    """Decode: the kernel on a CUDA tensor, its plain version
    (``core.etstep.linear_et_decode``, chunked by ``chunk``) on a CPU one."""
    if y.device.type == "cpu":
        return etstep.linear_et_decode(y, W, sigma2, log_odds, sa, Hp,
                                       signed_select, top_L, beta, prior_beta,
                                       chunk)
    return linear_et_decode_cuda(y, W, sigma2, log_odds, sa, Hp,
                                 signed_select, top_L, beta, prior_beta)
