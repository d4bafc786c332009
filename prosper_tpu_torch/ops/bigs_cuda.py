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
library is built and loaded by ``ops/cuda_lib.py`` at first CUDA use.
``bigs_multi_cuda`` takes CUDA tensors only.  The route between the kernel
and its plain version (``core.etstep.bigs_multi``) is the E-step's,
``ops/linear_cuda.py::linear_et_estep``, and under a state axis
``_slice_multi``'s.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from prosper_tpu_torch.core import etstep
from prosper_tpu_torch.core.etstep import LinearStateArrays
from prosper_tpu_torch.ops.cuda_lib import (LAUNCHES, SMEM_LIMIT, check,
                                            check_input, in_row_chunks,
                                            load_library, needs_plain,
                                            raise_on, schedule_pair)
from prosper_tpu_torch.ops.gemm_cuda import (hgemm_nn_cuda,
                                             hgemm_tn_splitn_cuda)
from prosper_tpu_torch.parallel.mesh import state_rank, state_sharded
from prosper_tpu_torch.utils import cached_for

__all__ = ["LAUNCHES", "bigs_multi_cuda", "empty_moments",
           "linear_et_estep_bigs", "linear_et_estep_bigs_cuda"]

LEAD = 4                     # floats: every tile row is a 16-byte copy
NM_MAX = 152                 # moment columns the register tile holds


def check_limits(Hp: int, K: int):
    """Raise ValueError for more moment columns than the kernel holds."""
    nM = Hp + Hp * (Hp + 1) // 2 + K + 2
    if nM > NM_MAX:
        raise needs_plain(
            f"kernel limit: {nM} moment columns (Hp + Hp (Hp + 1) / 2 + K "
            f"+ 2) are more than the {NM_MAX} the register tile holds "
            f"(Hp={Hp}, K={K})")


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
        raise needs_plain(
            f"a block needs {lib.bigs_multi_smem_bytes(nL, nM)} bytes of "
            f"shared memory, more than the {SMEM_LIMIT} a block may use "
            f"(Hp={Hp})")
    return etstep.bigs_tables_tri(states_p, outer_p, vcounts_p, absst_p,
                                  LEAD, cols)


def empty_moments(C: int, Hp: int, K: int, device):
    """``bigs_multi``'s output for a table with no real state: m = m_t =
    NEG, l = l_t = 0, zero moments."""
    neg = torch.full((C,), etstep.NEG, dtype=torch.float32, device=device)
    z = torch.zeros((C,), dtype=torch.float32, device=device)
    return (neg, z, neg.clone(), z.clone(), z.clone(),
            torch.zeros((C, Hp), dtype=torch.float32, device=device),
            torch.zeros((C, Hp * Hp), dtype=torch.float32, device=device),
            torch.zeros((C, K), dtype=torch.float32, device=device))


def bigs_multi_cuda(proj, Gf, states_p, outer_p, vcounts_p, prior, valid,
                    absst_p, inv2s2, beta, prior_beta, s_block: int,
                    collect_true: bool = True, tables=None,
                    n_states: Optional[int] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """The big-S recurrence kernel on CUDA tensors; same contract as
    ``core.etstep.bigs_multi``.  One launch covers all C rows.  ``s_block``
    is not read: the kernel walks the states in tiles of its own (64) and
    masks those past its S itself, so the tables may be padded (``valid``
    marks the real states) or not.  ``n_states`` (default: all rows of
    the tables) is that S: the rows past it may hold padding only.  With
    ``n_states = 0`` (a state shard whose slice holds padding only) there
    is no launch and the output is ``empty_moments``, as the plain
    version's.  ``tables`` are the ``tri_tables`` of these state tables
    where the caller keeps them; else they are built here."""
    check_input(proj)
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
    n_states = S_pad if n_states is None else int(n_states)
    if not 0 <= n_states <= S_pad:
        raise ValueError(f"n_states={n_states} is outside the table's "
                         f"{S_pad} rows")
    if n_states == 0:
        return empty_moments(C, Hp, K, dev)
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
        scal.data_ptr(), acc.data_ptr(), stats.data_ptr(), C, n_states, nL,
        X.shape[1], lda, nL + K + 2, int(collect_true),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "bigs_multi")
    LAUNCHES["bigs"] += 1
    return etstep.split_moments_tri(stats[0], stats[1], stats[2], acc, Hp, K)


def linear_et_estep_bigs(y, weight, W, sigma2, log_odds,
                         sa: LinearStateArrays, Hp: int, signed_select: bool,
                         beta, prior_beta, s_block: int,
                         collect_true: bool = True, multi=etstep.bigs_multi,
                         state_axis=None, n_state_shards: int = 1,
                         compute_dtype=None, kernels: bool = False
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The big-S E-step around ``multi`` (the plain ``bigs_multi``, or its
    kernel with ``kernels``), any N: the rows are cut where the larger of
    the (rows, H) and the two (rows, H', H) float32 workspaces of
    ``core.etstep._chunk_estats_bigs`` (``slot_sum_ss``) would exceed
    ``cuda_lib.P_LIMIT_BYTES``, F concatenated and the sums added in chunk
    order; where all rows fit it is one call, as without the cut.  Under
    a state axis each chunk runs on this state rank's slice.  With a
    16-bit ``compute_dtype`` P = yW and xs = y^T sw of a chunk come from
    the 16-bit GEMM kernels with ``kernels`` (``matmul_as`` without);
    without it they are float32 torch products.  The Gram matrix stays
    float32 either way, as in the JAX package."""
    N, H = y.shape[0], W.shape[1]
    gram = W.T @ W
    gram_diag = torch.diagonal(gram)
    half = kernels and compute_dtype is not None

    def chunk(i, j):
        y_c = y[i:j]
        F, sums = etstep._chunk_estats_bigs(
            y_c, weight[i:j], W, gram, gram_diag, sigma2, log_odds, sa, Hp,
            signed_select, beta, prior_beta, s_block, collect_true,
            multi=multi, state_axis=state_axis,
            n_state_shards=n_state_shards,
            P=hgemm_nn_cuda(y_c, W, compute_dtype) if half else None,
            compute_dtype=compute_dtype)
        if half:                          # the sums hold sw in place of xs
            xs = hgemm_tn_splitn_cuda(y_c, sums.pop("sw"), compute_dtype)
            sums = dict(xs=xs, **sums)
        return F, sums

    return in_row_chunks(N, max(H, Hp * H), chunk)


def _slice_multi(sa: LinearStateArrays, state_axis, n_state_shards: int):
    """(the recurrence on this state rank's slice, whether it is the
    kernel): the slice of ``ceil(S / n)`` states (a padding unit of 1; the
    tables ``core.etstep.bigs_front`` cuts) whose ``n_states`` leading rows
    are real; on a CUDA tensor the kernel with the slice's reduced tables,
    built once per (state space, n, state rank), on a CPU tensor the plain
    ``bigs_multi`` over the same slice in one tile."""
    srank = state_rank(state_axis)
    lo, hi, _ = etstep.state_slice(sa.states.shape[0], n_state_shards,
                                   srank)
    if not sa.states.is_cuda:
        def plain(*args):
            *ops, inv2s2, beta, prior_beta, _, collect_true = args
            return etstep.bigs_multi(*ops, inv2s2, beta, prior_beta,
                                     max(1, ops[2].shape[0]), collect_true)
        return plain, False
    tables = cached_for(sa.states, ("bigs_tri", n_state_shards, srank),
                        lambda: tri_tables(load_library(), *(
                            etstep.slice_state_shard(
                                srank, n_state_shards,
                                [sa.states, sa.outer, sa.value_counts,
                                 sa.abs_states])[0])))
    return functools.partial(bigs_multi_cuda, tables=tables,
                             n_states=hi - lo), True


def linear_et_estep_bigs_cuda(y, weight, W, sigma2, log_odds,
                              sa: LinearStateArrays, Hp: int,
                              signed_select: bool, beta, prior_beta,
                              s_block: int, collect_true: bool = True,
                              state_axis=None, n_state_shards: int = 1,
                              compute_dtype=None
                              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The big-S E-step through the kernel: the torch front end and sums of
    ``core.etstep._chunk_estats_bigs`` around one kernel launch per chunk
    of rows (``linear_et_estep_bigs``; one chunk unless N is very large).
    ``s_block`` tiles only the plain version: the kernel masks states past
    S itself, so the tables go to it unpadded (a padding unit of 1), and
    their reduced form is built once per state space.

    Under a state axis (``state_axis``, ``n_state_shards > 1``) the kernel
    runs on this state rank's slice of ``ceil(S / n)`` states, whatever
    ``s_block`` is, with the reduced tables of the slice built once per
    (state space, n, state rank); a slice of padding alone launches
    nothing.  On a CPU tensor that path runs the plain ``bigs_multi`` over
    the same slice (the kernel's plain version); without a state axis the
    kernel takes CUDA tensors only.  ``compute_dtype`` as
    ``linear_et_estep_bigs``'s: the kernel itself stays float32."""
    if state_sharded(state_axis, n_state_shards):
        multi, kernels = _slice_multi(sa, state_axis, n_state_shards)
        return linear_et_estep_bigs(
            y, weight, W, sigma2, log_odds, sa, Hp, signed_select, beta,
            prior_beta, 1, collect_true, multi=multi, state_axis=state_axis,
            n_state_shards=n_state_shards, compute_dtype=compute_dtype,
            kernels=kernels)
    check_input(y)
    tables = cached_for(sa.states, "bigs_tri", lambda: tri_tables(
        load_library(), sa.states, sa.outer, sa.value_counts, sa.abs_states))
    return linear_et_estep_bigs(
        y, weight, W, sigma2, log_odds, sa, Hp, signed_select, beta,
        prior_beta, 1, collect_true,
        multi=functools.partial(bigs_multi_cuda, tables=tables),
        compute_dtype=compute_dtype, kernels=True)
