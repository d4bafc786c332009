"""Hand-written CUDA kernel for the big-S (``s_block``) linear E-step.

``bigs_multi`` (``csrc/bigs_multi.cu``) replaces
``prosper_tpu/ops/bigs_pallas.py::bigs_multi_pallas``: the multi-state part
of the big-S E-step, an online logsumexp over the S enumerated states with
the running (max, mass, moments) per datapoint kept on chip.  The torch
code around it (front end, the zero and singleton states, the combine and
the sufficient statistics) is ``core/etstep.py::_chunk_estats_bigs``.  The
library is built and loaded by ``ops/cuda_lib.py`` at first CUDA use.  On
a CPU tensor the wrapper runs the plain version (``core.etstep.bigs_multi``);
on a CUDA tensor it launches the kernel or raises.  The dispatcher between
the two is the E-step's, ``ops/linear_cuda.py::linear_et_estep``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from prosper_tpu_torch.core import etstep
from prosper_tpu_torch.core.etstep import LinearStateArrays
from prosper_tpu_torch.ops.cuda_lib import (LAUNCHES, SMEM_LIMIT, check,
                                            load_library, raise_on)

__all__ = ["LAUNCHES", "bigs_multi_cuda", "linear_et_estep_bigs_cuda"]

NB_MAX = 256                 # moment columns the kernel's register tile holds


def bigs_multi_cuda(proj, Gf, states_p, outer_p, vcounts_p, prior, valid,
                    absst_p, inv2s2, beta, prior_beta, s_block: int,
                    collect_true: bool = True) -> Tuple[torch.Tensor, ...]:
    """The big-S recurrence kernel on CUDA tensors; same contract as
    ``core.etstep.bigs_multi``.  One launch covers all C rows.  ``s_block``
    is not read: the kernel walks the states in tiles of its own (64) and
    masks those past the table itself, so the tables may be padded (``valid``
    marks the real states) or not."""
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
    Xa, Xt, A, B = etstep.bigs_operands(
        proj, Gf, states_p, outer_p, vcounts_p, prior, valid, absst_p,
        inv2s2, beta, prior_beta, collect_true)
    nA, nB = A.shape[1], B.shape[1]
    if nB > NB_MAX:
        raise ValueError(f"kernel limit: {nB} moment columns (Hp + Hp^2 + "
                         f"K + 2) > {NB_MAX}")
    lib = load_library()
    smem = lib.bigs_multi_smem_bytes(nA, nB, int(collect_true))
    if smem > SMEM_LIMIT:
        raise ValueError(f"a block needs {smem} bytes of shared memory, more "
                         f"than the {SMEM_LIMIT} a block may use (Hp={Hp})")
    AT = A.T.contiguous()            # state-minor: a tile row is contiguous
    acc = torch.empty((C, nB), dtype=torch.float32, device=dev)
    stats = torch.empty((3, C), dtype=torch.float32, device=dev)
    err = lib.bigs_multi(
        Xa.data_ptr(), (Xt if collect_true else Xa).data_ptr(),
        AT.data_ptr(), B.data_ptr(), acc.data_ptr(), stats.data_ptr(),
        C, S_pad, nA, nB, int(collect_true),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "bigs_multi")
    LAUNCHES["bigs"] += 1
    return etstep.split_moments(stats[0], stats[1], stats[2], acc, Hp, K)


def linear_et_estep_bigs_cuda(y, weight, W, sigma2, log_odds,
                              sa: LinearStateArrays, Hp: int,
                              signed_select: bool, beta, prior_beta,
                              s_block: int, collect_true: bool = True
                              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The big-S E-step on CUDA tensors: the torch front end and sums of
    ``core.etstep._chunk_estats_bigs`` around one kernel launch over all
    rows (any N, no chunking).  ``s_block`` tiles only the plain version:
    the kernel masks states past S itself, so the tables go to it unpadded
    (a padding unit of 1)."""
    if y.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {y.device}")
    gram = W.T @ W
    return etstep._chunk_estats_bigs(
        y, weight, W, gram, torch.diagonal(gram), sigma2, log_odds, sa, Hp,
        signed_select, beta, prior_beta, 1, collect_true,
        multi=bigs_multi_cuda)
