"""Hand-written CUDA kernel for the big-S (``s_block``) linear E-step.

``bigs_multi`` (``csrc/bigs_multi.cu``) replaces
``prosper_tpu/ops/bigs_pallas.py::bigs_multi_pallas``: the multi-state part
of the big-S E-step, an online logsumexp over the S enumerated states with
the running (max, mass, moments) per datapoint kept on chip.  The kernel
takes the reduced operands of ``core.etstep.bigs_operands_tri`` and
``bigs_tables_tri`` (the diagonal and one triangle of the symmetric Gram and
outer-product blocks; one dot product for the annealed and the un-annealed
logit) and the wrapper mirrors the second moments.  The torch code around
it (front end, the zero and singleton states, the combine and the
sufficient statistics) is ``core/etstep.py::_chunk_estats_bigs``.  The
library is built and loaded by ``ops/cuda_lib.py`` at first CUDA use.  On
a CPU tensor the wrapper runs the plain version (``core.etstep.bigs_multi``);
on a CUDA tensor it launches the kernel or raises.  The dispatcher between
the two is the E-step's, ``ops/linear_cuda.py::linear_et_estep``.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from prosper_tpu_torch.core import etstep
from prosper_tpu_torch.core.etstep import LinearStateArrays
from prosper_tpu_torch.ops.cuda_lib import (LAUNCHES, SMEM_LIMIT, cached_for,
                                            check, in_row_chunks,
                                            load_library, raise_on,
                                            schedule_pair)

__all__ = ["LAUNCHES", "bigs_multi_cuda", "linear_et_estep_bigs",
           "linear_et_estep_bigs_cuda"]

LEAD = 4                     # floats: every tile row is a 16-byte copy
NM_MAX = 152                 # moment columns the register tile holds


def check_limits(Hp: int, K: int):
    """Raise ValueError for more moment columns than the kernel holds."""
    nM = Hp + Hp * (Hp + 1) // 2 + K + 2
    if nM > NM_MAX:
        raise ValueError(
            f"kernel limit: {nM} moment columns (Hp + Hp (Hp + 1) / 2 + K "
            f"+ 2) are more than the {NM_MAX} the register tile holds "
            f"(Hp={Hp}, K={K}); backend=\"plain\" trains such a model on "
            "the card through the plain PyTorch version")


def tri_tables(lib, states_p, outer_p, vcounts_p, absst_p):
    """The state-table operands as the kernel reads them: A (nL, S4)
    state-minor with S4 a multiple of ``LEAD``, B (S, cols) with the
    kernel's column count.  Raises where the kernel does not hold the
    tables' width."""
    Hp, K = states_p.shape[1], vcounts_p.shape[1]
    check_limits(Hp, K)
    nL = Hp + Hp * (Hp + 1) // 2
    nM = nL + K + 2
    cols = lib.bigs_multi_cols(nM)
    if cols == 0:
        raise ValueError(f"the kernel holds no {nM} moment columns "
                         f"(Hp={Hp}, K={K})")
    if lib.bigs_multi_warps(nL, nM) == 0:
        raise ValueError(
            f"a block needs {lib.bigs_multi_smem_bytes(nL, nM)} bytes of "
            f"shared memory, more than the {SMEM_LIMIT} a block may use "
            f"(Hp={Hp}); backend=\"plain\" trains such a model on the card "
            "through the plain PyTorch version")
    return etstep.bigs_tables_tri(states_p, outer_p, vcounts_p, absst_p,
                                  LEAD, cols)


def bigs_multi_cuda(proj, Gf, states_p, outer_p, vcounts_p, prior, valid,
                    absst_p, inv2s2, beta, prior_beta, s_block: int,
                    collect_true: bool = True, tables=None
                    ) -> Tuple[torch.Tensor, ...]:
    """The big-S recurrence kernel on CUDA tensors; same contract as
    ``core.etstep.bigs_multi``.  One launch covers all C rows.  ``s_block``
    is not read: the kernel walks the states in tiles of its own (64) and
    masks those past the table itself, so the tables may be padded (``valid``
    marks the real states) or not.  ``tables`` are the ``tri_tables`` of
    these state tables where the caller keeps them; else they are built
    here."""
    if proj.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got "
                         f"{proj.device}")
    C, Hp = proj.shape
    S_pad, K = vcounts_p.shape
    dev = proj.device
    check(proj, "proj", (C, Hp), dev)
    check(Gf, "Gf", (C, Hp * Hp), dev)
    check(states_p, "states", (S_pad, Hp), dev)
    check(outer_p, "outer", (S_pad, Hp * Hp), dev)
    check(vcounts_p, "value_counts", (S_pad, K), dev)
    check(prior, "prior", (S_pad,), dev)
    check(valid, "valid", (S_pad,), dev)
    check(absst_p, "abs_states", (S_pad,), dev)
    if C < 1:
        raise ValueError("need at least one datapoint")
    lib = load_library()
    if tables is None:
        tables = tri_tables(lib, states_p, outer_p, vcounts_p, absst_p)
    AT, B = tables
    nL, lda = AT.shape
    check(B, "B", (S_pad, B.shape[1]), dev)
    X = etstep.bigs_operands_tri(proj, Gf, inv2s2, LEAD)
    PV = etstep.pad_last(torch.stack([prior, valid]), lda)
    scal = schedule_pair(beta, prior_beta, dev)
    acc = torch.empty((C, B.shape[1]), dtype=torch.float32, device=dev)
    stats = torch.empty((3, C), dtype=torch.float32, device=dev)
    err = lib.bigs_multi(
        X.data_ptr(), AT.data_ptr(), PV.data_ptr(), B.data_ptr(),
        scal.data_ptr(), acc.data_ptr(), stats.data_ptr(), C, S_pad, nL,
        X.shape[1], lda, nL + K + 2, int(collect_true),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "bigs_multi")
    LAUNCHES["bigs"] += 1
    return etstep.split_moments_tri(stats[0], stats[1], stats[2], acc, Hp, K)


def linear_et_estep_bigs(y, weight, W, sigma2, log_odds,
                         sa: LinearStateArrays, Hp: int, signed_select: bool,
                         beta, prior_beta, s_block: int,
                         collect_true: bool = True, multi=etstep.bigs_multi
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The big-S E-step around ``multi`` (the plain ``bigs_multi`` or its
    kernel), any N, on either device: the rows are cut where the larger of
    the (rows, H) and the two (rows, H', H) float32 workspaces of
    ``core.etstep._chunk_estats_bigs`` (``slot_sum_ss``) would exceed
    ``cuda_lib.P_LIMIT_BYTES``, F concatenated and the sums added in chunk
    order; where all rows fit it is one call, as without the cut."""
    N, H = y.shape[0], W.shape[1]
    gram = W.T @ W
    gram_diag = torch.diagonal(gram)
    return in_row_chunks(
        N, max(H, Hp * H), lambda i, j: etstep._chunk_estats_bigs(
            y[i:j], weight[i:j], W, gram, gram_diag, sigma2, log_odds, sa,
            Hp, signed_select, beta, prior_beta, s_block, collect_true,
            multi=multi))


def linear_et_estep_bigs_cuda(y, weight, W, sigma2, log_odds,
                              sa: LinearStateArrays, Hp: int,
                              signed_select: bool, beta, prior_beta,
                              s_block: int, collect_true: bool = True
                              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The big-S E-step on CUDA tensors: the torch front end and sums of
    ``core.etstep._chunk_estats_bigs`` around one kernel launch per chunk
    of rows (``linear_et_estep_bigs``; one chunk unless N is very large).
    ``s_block`` tiles only the plain version: the kernel masks states past
    S itself, so the tables go to it unpadded (a padding unit of 1), and
    their reduced form is built once per state space."""
    if y.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {y.device}")
    tables = cached_for(sa.states, "bigs_tri", lambda: tri_tables(
        load_library(), sa.states, sa.outer, sa.value_counts, sa.abs_states))
    return linear_et_estep_bigs(
        y, weight, W, sigma2, log_odds, sa, Hp, signed_select, beta,
        prior_beta, 1, collect_true,
        multi=functools.partial(bigs_multi_cuda, tables=tables))
