"""Hand-written CUDA kernels for the linear-family ET E-step and decode.

Two per-datapoint kernels share one front end
(``csrc/linear_et_frontend.cuh``) and the projection ``P = y W`` by the
``sgemm_nn`` kernel (``ops/gemm_cuda.py``):

* ``linear_et_estep`` replaces
  ``prosper_tpu/ops/linear_pallas.py::linear_et_estep_pallas``: F per
  datapoint and the weight-masked sufficient statistics (training).  It
  runs in three stages: ``P = y W``, the per-datapoint kernel
  (``csrc/linear_et_estep.cu``), which turns P's rows into ``w <s>`` in
  place, and ``xs = y^T (w <s>)`` by the ``sgemm_tn_splitn`` kernel.  One
  call counts once in ``LAUNCHES["estep"]``.
* ``linear_et_decode`` replaces ``linear_et_decode_pallas``: F, the
  posterior mean, the top-L states in canonical union indices and the
  candidates (serving).  It runs in two stages: ``P = y W``, then the
  per-datapoint kernel (``csrc/linear_et_decode.cu``), which keeps a row's
  posterior in shared memory.  One call counts once in
  ``LAUNCHES["decode"]``.

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
from prosper_tpu_torch.ops.bigs_cuda import linear_et_estep_bigs_cuda
from prosper_tpu_torch.ops.cuda_lib import (LAUNCHES, SMEM_LIMIT, cached_for,
                                            check, in_row_chunks,
                                            load_library, n_blocks, raise_on,
                                            row_chunks, scalars)
from prosper_tpu_torch.ops.gemm_cuda import (sgemm_nn_cuda,
                                             sgemm_tn_splitn_cuda)
from prosper_tpu_torch.parallel.mesh import state_sharded

__all__ = ["LAUNCHES", "load_library", "linear_et_estep",
           "linear_et_estep_cuda", "linear_et_decode", "linear_et_decode_cuda"]

HP_MAX, K_MAX, H_MAX = 32, 8, 1024
ROWS_TILE = 8                # datapoints per tile of the per-datapoint kernels


def check_limits(Hp: int, K: int, H: int):
    """Raise ValueError for a model wider than the fused kernels hold."""
    if not (Hp <= HP_MAX and K <= K_MAX and H <= H_MAX):
        raise ValueError(
            f"kernel limits: Hp <= {HP_MAX}, K <= {K_MAX}, H <= {H_MAX}; "
            f"got {Hp=} {K=} {H=}.  The fused E-step and decode kernels do "
            'not hold such a model; backend="plain" trains and serves it on '
            "the card through the plain PyTorch version")


def _check_common(y, W, log_odds, sa: LinearStateArrays, Hp: int):
    """Validate the shared inputs, then build/load the kernels.
    Returns (lib, N, D, H, S, K)."""
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
    check_limits(Hp, K, H)
    return load_library(), N, D, H, S, K


def _check_smem(smem: int, S: int):
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the enumerated state space (S={S} multi states) is too large "
            f"for the fused kernel: a block needs {smem} bytes of shared "
            f"memory, more than the {SMEM_LIMIT} it may use; train such a "
            "model with s_block > 0 (the big-S E-step), or with "
            'backend="plain" (the plain PyTorch version on the card)')


def _state_minor(sa: LinearStateArrays):
    """The state tables as the kernels read them: transposed, so that the
    lanes of a warp, which walk the states, read consecutive addresses.
    Made once per state space."""
    return cached_for(sa.states, "state_minor", lambda: (
        sa.states.T.contiguous(), sa.outer.T.contiguous(),
        sa.value_counts.T.contiguous()))


def _estep_rows(lib, y, weight, W, gram, scal, log_odds, tables,
                sa: LinearStateArrays, Hp: int, signed_select: bool,
                collect_true: bool, smem: int):
    """The three stages on one chunk of rows: (F, sums (D*H + stride,))."""
    (N, D), H = y.shape, W.shape[1]
    S, K = sa.value_counts.shape
    dev = y.device
    states, outer, vcounts = tables
    nb = n_blocks(dev, smem, -(-N // ROWS_TILE))
    stride = lib.linear_et_estep_ws_stride(H, K)
    F = torch.empty(N, dtype=torch.float32, device=dev)
    ws = torch.empty(nb * stride, dtype=torch.float32, device=dev)
    sums = torch.empty(D * H + stride, dtype=torch.float32, device=dev)
    P = sgemm_nn_cuda(y, W)
    err = lib.linear_et_estep_rows(
        y.data_ptr(), weight.data_ptr(), P.data_ptr(), gram.data_ptr(),
        states.data_ptr(), outer.data_ptr(), vcounts.data_ptr(),
        sa.abs_states.data_ptr(), sa.values.data_ptr(), log_odds.data_ptr(),
        scal.data_ptr(), F.data_ptr(), ws.data_ptr(),
        sums[D * H:].data_ptr(), N, D, H, Hp, S, K, int(signed_select),
        int(collect_true), nb, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "linear_et_estep_rows")
    sgemm_tn_splitn_cuda(y, P, out=sums[:D * H].view(D, H))  # P holds w <s>
    return F, sums


def linear_et_estep_cuda(y, weight, W, sigma2, log_odds,
                         sa: LinearStateArrays, Hp: int, signed_select: bool,
                         beta, prior_beta, collect_true: bool = True
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The E-step kernels on CUDA tensors; same contract as
    ``core.etstep.linear_et_estep`` (any N; rows are chunked only where the
    (N, H) workspace for P would exceed ``cuda_lib.P_LIMIT_BYTES``)."""
    lib, N, D, H, S, K = _check_common(y, W, log_odds, sa, Hp)
    smem = lib.linear_et_rows_smem_bytes(H, Hp, S, K)
    _check_smem(smem, S)
    dev = y.device
    check(weight, "weight", (N,), dev)
    gram = (W.T @ W).contiguous()
    scal = scalars(sigma2, beta, prior_beta, dev)
    tables = _state_minor(sa)
    F, sums = in_row_chunks(N, H, lambda i, j: _estep_rows(
        lib, y[i:j], weight[i:j], W, gram, scal, log_odds, tables, sa, Hp,
        signed_select, collect_true, smem))
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
    """The decode kernels on CUDA tensors; same contract as
    ``core.etstep.linear_et_decode`` (any N; rows are chunked as the
    E-step's).  Two stages: ``P = y W`` by ``sgemm_nn``, then the
    per-datapoint kernel.  One call counts once in ``LAUNCHES["decode"]``."""
    lib, N, D, H, S, K = _check_common(y, W, log_odds, sa, Hp)
    smem = lib.linear_et_decode_smem_bytes(H, Hp, S, K)
    _check_smem(smem, S)
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
    for i, j in row_chunks(N, H):
        P = sgemm_nn_cuda(y[i:j], W)
        err = lib.linear_et_decode_rows(
            y[i:j].data_ptr(), P.data_ptr(), gram.data_ptr(),
            states.data_ptr(), outer.data_ptr(), vcounts.data_ptr(),
            sa.abs_states.data_ptr(), sa.values.data_ptr(),
            log_odds.data_ptr(), scal.data_ptr(), F[i:j].data_ptr(),
            s_mean[i:j].data_ptr(), top_q[i:j].data_ptr(),
            top_u[i:j].data_ptr(), cand[i:j].data_ptr(), j - i, D, H, Hp, S,
            K, top_L, int(signed_select),
            n_blocks(dev, smem, -(-(j - i) // ROWS_TILE)),
            torch.cuda.current_stream(dev).cuda_stream)
        raise_on(lib, err, "linear_et_decode_rows")
    LAUNCHES["decode"] += 1
    return F, s_mean, top_q, top_u, cand


def linear_et_estep(y, weight, W, sigma2, log_odds, sa: LinearStateArrays,
                    Hp: int, signed_select: bool, beta, prior_beta,
                    chunk: int = 2048, collect_true: bool = True,
                    s_block: int = 0, state_axis=None,
                    n_state_shards: int = 1):
    """E-step: kernels on a CUDA tensor, the E-step's three stages or, with
    ``s_block > 0``, the big-S one (``ops/bigs_cuda.py``); its plain version
    (``core.etstep.linear_et_estep``, chunked by ``chunk``) on a CPU one.
    Under a state axis (``state_axis``, ``n_state_shards > 1``) the big-S
    kernel on this state rank's slice, whatever ``s_block`` is (the fused
    rows kernel needs the whole union in one block), and on a CPU tensor
    its plain version over the same slice."""
    if state_sharded(state_axis, n_state_shards):
        return linear_et_estep_bigs_cuda(
            y, weight, W, sigma2, log_odds, sa, Hp, signed_select, beta,
            prior_beta, s_block, collect_true, state_axis=state_axis,
            n_state_shards=n_state_shards)
    if y.device.type == "cpu":
        return etstep.linear_et_estep(y, weight, W, sigma2, log_odds, sa, Hp,
                                      signed_select, beta, prior_beta, chunk,
                                      collect_true, s_block)
    if s_block > 0:
        return linear_et_estep_bigs_cuda(y, weight, W, sigma2, log_odds, sa,
                                         Hp, signed_select, beta, prior_beta,
                                         s_block, collect_true)
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
