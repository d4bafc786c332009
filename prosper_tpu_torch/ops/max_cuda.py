"""Hand-written CUDA kernels for the max-superposition (MCA / MMCA) E-step.

``max_et_estep`` replaces both TPU kernels of
``prosper_tpu/ops/max_pallas.py``, ``max_et_estep_pallas`` and
``max_et_estep_pallas_dtiled``: the hard-winner (rho <= 0) E-step, F per
datapoint and the weight-masked M-step sums.  It runs in four stages:
``P = y W`` by the ``sgemm_nn`` kernel (``ops/gemm_cuda.py``), the rows
kernel (``csrc/max_et_estep.cu``), which turns P's rows into
``w q_single`` in place and writes each row's candidates and routing
tables, the routing kernel (the multi states' part of numer and denom),
and the singleton part of numer, ``(w q_single)^T y``, by the
``sgemm_tn_splitn`` kernel; one call counts once in
``LAUNCHES["max_estep"]``.  The kernels are compiled once for each H'
within the limits, with the whole lattice over the H' slots, which the
state table must begin (``table_gamma``).  The library is built and loaded
by ``ops/cuda_lib.py`` at first CUDA use.  On a CPU tensor the wrapper runs
the plain version (``core/maxstep.py``); on a CUDA tensor it launches the
kernels or raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from prosper_tpu_torch.core import maxstep
from prosper_tpu_torch.core.etstep import LinearStateArrays
from prosper_tpu_torch.core.states import binary_state_space, n_multi_states
from prosper_tpu_torch.ops.cuda_lib import (LAUNCHES, SMEM_LIMIT, cached_for,
                                            check, in_row_chunks,
                                            load_library, occupancy, raise_on,
                                            scalars, sm_count)
from prosper_tpu_torch.ops.gemm_cuda import (sgemm_nn_cuda,
                                             sgemm_tn_splitn_cuda)

__all__ = ["LAUNCHES", "max_et_estep", "max_et_estep_cuda"]

#: kernel limits: H' candidate slots (HPM) and multi states (SMAX), as in
#: the source
HP_MAX, S_MAX = 8, 128
TILE = 16                    # datapoints per tile, as TILE in the source
ROUTE_COLS, ROUTE_ROWS = 32, 32   # a block of the routing kernel's columns
                                  # and its batch of rows (DR, RB)
KEYS = ("abs", "resid", "y2", "n", "F", "F_true")


def check_limits(Hp: int, S: int):
    """Raise ValueError for a state space larger than the kernel holds."""
    if not (Hp <= HP_MAX and S <= S_MAX):
        raise ValueError(
            f"kernel limits: Hp <= {HP_MAX}, S <= {S_MAX} multi states; got "
            f"{Hp=} {S=}.  The max E-step kernel does not hold such a model; "
            'backend="plain" trains it on the card through the plain '
            "PyTorch version")


def kernel_gamma(Hp: int, S: int) -> int:
    """The gamma of ``S`` multi states over ``Hp`` candidate slots: the
    states of 2..gamma active slots, the first S of the lattice over the
    slots, which the kernels hold.  Raises ValueError for a shape they do
    not hold."""
    check_limits(Hp, S)
    for gamma in range(2, Hp + 1):
        if n_multi_states(Hp, gamma) == S:
            return gamma
    raise ValueError(f"{S} multi states over {Hp} slots are no binary state "
                     "space of 2..gamma active slots, which the max E-step "
                     'kernel takes; backend="plain" takes any')


def table_gamma(states: torch.Tensor) -> int:
    """``kernel_gamma`` of a state table (S, Hp), checked to hold
    ``binary_state_space(Hp, gamma)``'s states in its order (the kernel
    has them compiled in); made once per table."""
    def build():
        S, Hp = states.shape
        gamma = kernel_gamma(Hp, S)
        if not np.array_equal(states.detach().cpu().numpy(),
                              binary_state_space(Hp, gamma).states):
            raise ValueError("the max E-step kernel takes the states of "
                             f"binary_state_space({Hp}, {gamma}) in their "
                             'order; another table needs backend="plain"')
        return gamma
    return cached_for(states, "max_kernel_gamma", build)


def smem_bytes(D: int, H: int, Hp: int, S: int) -> int:
    """Shared memory of a block of the rows kernel (the source's
    ``rows_smem_bytes``): the tile's rows, scores and posteriors, the
    candidates, and the table of states by slot and subset."""
    floats = (TILE * D + TILE * H + H + TILE * (1 + H + S) + 3 * H
              + 6 * TILE + len(KEYS))
    return 4 * (floats + TILE * Hp) + 2 * Hp * (1 << (Hp - 1))


def route_smem_bytes(Hp: int, hcols: int) -> int:
    """Shared memory of a block of the routing kernel (the source's
    ``route_smem_bytes``): numer and denom of ``hcols`` units at its
    ROUTE_COLS columns, and a batch of ROUTE_ROWS rows' masses per slot,
    values, candidates and the slots each of its 8 warps adds."""
    return (4 * (2 * hcols * ROUTE_COLS + ROUTE_ROWS * Hp * ROUTE_COLS
                 + ROUTE_ROWS * ROUTE_COLS + ROUTE_ROWS * Hp)
            + ROUTE_ROWS * 8)


def route_units(H: int, Hp: int) -> Tuple[int, int]:
    """(hcols, groups): the units h a block of the routing kernel sums, all
    H where two blocks an SM hold them, else in groups of equal size that
    one block an SM holds."""
    two = (SMEM_LIMIT + 1024) // 2 - 1024
    if route_smem_bytes(Hp, H) <= two:
        return H, 1
    cap = (SMEM_LIMIT - route_smem_bytes(Hp, 0)) // (8 * ROUTE_COLS)
    groups = -(-H // cap)
    return -(-H // groups), groups


def route_chunks(N: int, D: int, groups: int, slots: int) -> int:
    """Rows a chunk of the routing kernel: as many chunks as fill the
    ``slots`` blocks the card holds at once, each block one chunk's
    ROUTE_COLS columns and one group of units."""
    per_chunk = -(-D // ROUTE_COLS) * groups
    n = max(1, min(-(-N // ROUTE_ROWS), slots // per_chunk))
    return -(-N // n)


def blocks_per_sm(lib, D: int, H: int, Hp: int, S: int, hcols: int,
                  magnitude: bool) -> Tuple[int, int]:
    """Blocks of the rows kernel and of the routing kernel that one SM of
    the current device holds at once (registers and shared memory), asked
    of the runtime once."""
    return occupancy(
        lib, "max_et_estep", (D, H, Hp, S, hcols, bool(magnitude)),
        lambda out: lib.max_et_blocks_per_sm(D, H, Hp, S, hcols,
                                             int(magnitude), out), 2)


def _estep_rows(lib, y, weight, W, WT, gdiag, states, lo, scal,
                sa: LinearStateArrays, Hp: int, magnitude: bool,
                collect_true: bool, hcols: int, groups: int,
                bps: Tuple[int, int]):
    """The kernels on one chunk of rows: (F, sums)."""
    (N, D), H = y.shape, W.shape[1]
    S = sa.states.shape[0]
    dev = y.device
    sms = sm_count(dev)
    nb = min(-(-N // TILE), sms * bps[0])
    chunk_rows = route_chunks(N, D, groups, sms * bps[1])
    n_chunks = -(-N // chunk_rows)
    F = torch.empty(N, dtype=torch.float32, device=dev)
    wsA = torch.empty(nb * lib.max_et_ws_a_stride(H), dtype=torch.float32,
                      device=dev)
    wsB = torch.empty(n_chunks * lib.max_et_ws_b_stride(D, H),
                      dtype=torch.float32, device=dev)
    T = torch.empty(N * Hp * (1 << (Hp - 1)), dtype=torch.float32,
                    device=dev)
    cand = torch.empty(N * Hp, dtype=torch.int32, device=dev)
    sums = torch.empty(2 * H * D + 2 * H + len(KEYS), dtype=torch.float32,
                       device=dev)
    P = sgemm_nn_cuda(y, W)
    err = lib.max_et_estep(
        y.data_ptr(), weight.data_ptr(), P.data_ptr(), WT.data_ptr(),
        gdiag.data_ptr(), states.data_ptr(), sa.abs_states.data_ptr(),
        sa.values.data_ptr(), lo.data_ptr(), scal.data_ptr(), F.data_ptr(),
        wsA.data_ptr(), wsB.data_ptr(), T.data_ptr(), cand.data_ptr(),
        sums.data_ptr(), N, D, H, Hp, S, int(magnitude), int(collect_true),
        nb, chunk_rows, hcols, torch.cuda.current_stream(dev).cuda_stream)
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
    table_gamma(sa.states)
    smem = smem_bytes(D, H, Hp, S)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a tile needs {smem} bytes of shared memory, more "
                         f"than the {SMEM_LIMIT} a block may use; "
                         'backend="plain" trains such a model on the card '
                         "through the plain PyTorch version")
    hcols, groups = route_units(H, Hp)
    lib = load_library()
    bps = blocks_per_sm(lib, D, H, Hp, S, hcols, magnitude)
    WT = W.T.contiguous()
    gdiag = (W * W).sum(dim=0)
    states = sa.states.T.contiguous()           # state-minor, as the lanes
    lo = lo.reshape(1).contiguous()
    scal = scalars(sigma2, beta, prior_beta, dev)
    F, sums = in_row_chunks(N, H, lambda i, j: _estep_rows(
        lib, y[i:j], weight[i:j], W, WT, gdiag, states, lo, scal, sa, Hp,
        magnitude, collect_true, hcols, groups, bps))
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
