"""Hand-written CUDA kernel for the GSC (spike-and-slab) ET E-step.

``gsc_et_estep`` is GSC's E-step.  On a CUDA tensor it runs three stages,
``P = y W`` by the ``sgemm_nn`` kernel (``ops/gemm_cuda.py``), the
per-datapoint kernel (``csrc/gsc_et_estep.cu``: selection, the singletons,
each support's slab system solved in registers, both softmax channels, F
and the moments; it turns P's rows into ``w <sz>`` in place), and
``xs = y^T (w <sz>)`` by the ``sgemm_tn_splitn`` kernel; one call counts
once in ``LAUNCHES["gsc_estep"]``, and its two GEMMs beside it.  On a CPU
tensor it runs the plain version, ``core/gscstep.py::gsc_et_estep``.  On
a CUDA tensor a model past the kernel's limits (``within_limits``) and a
state axis raise a ValueError: nothing falls back, and the model's
``backend="plain"`` runs such a model on the card through the plain
version.

The JAX package has no TPU kernel for GSC (its E-step is plain XLA); this
one was added because the plain version's ~420 small operations a chunk
of rows kept the card idle between them.  The library is built and loaded
by ``ops/cuda_lib.py`` at first CUDA use.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from prosper_tpu_torch.core import gscstep
from prosper_tpu_torch.core.etstep import LinearStateArrays
from prosper_tpu_torch.io.tracing import traced_region
from prosper_tpu_torch.ops.cuda_lib import (LAUNCHES, cached_for, check,
                                            in_row_chunks, load_library,
                                            occupancy, raise_on,
                                            schedule_pair, sm_count)
from prosper_tpu_torch.ops.gemm_cuda import (sgemm_nn_cuda,
                                             sgemm_tn_splitn_cuda)
from prosper_tpu_torch.parallel.mesh import state_sharded

__all__ = ["LAUNCHES", "gsc_et_estep", "gsc_et_estep_cuda",
           "kernel_occupancy", "support_tables", "within_limits"]

#: kernel limits: H' candidate slots, the largest support (gamma) and H,
#: as in the source (HPM, GMAX); at H = 1024, H' = 8 and gamma = 4 a block
#: takes 208 KB of the 227 KB of shared memory it may use
HP_MAX, GAMMA_MAX, H_MAX = 8, 4, 1024
ROWS_TILE = 8                # datapoints per tile, a warp each
KEYS = ("abs", "y2", "n", "F", "F_true")


def _tri(i: int, j: int) -> int:
    """Position of the pair (i, j), i >= j, in a packed lower triangle."""
    return i * (i + 1) // 2 + j


def support_tables(act: np.ndarray) -> Tuple[np.ndarray, int]:
    """The kernel's support table, built on the host from the (S, Hp)
    activity of the supports: (int32 table, gamma).  The table is

    * a code for each support s: its size m in bits 0-3 and its i-th slot
      (ascending) in bits 4 + 4 i;
    * the starts (Hp (Hp + 3) / 2 + 1) and entries of one list for each
      item of the candidate frame: <sz> of slot a (items 0..Hp), then
      <sz sz^T> of the slot pair a >= b (item Hp + a (a + 1) / 2 + b).  An
      entry is the offset r * S + s, in a row's moment buffer, of the
      support s's term: row i (kappa_i) for a slot, row gamma + i (i + 1) /
      2 + j (Sigma_ij) for a pair, with slots (a, b) at the support's
      positions (i, j).  A list runs over the supports in order, which
      fixes the order of each sum."""
    act = np.asarray(act).astype(bool)
    S, Hp = act.shape
    gamma = int(act.sum(axis=1).max()) if S else 0
    codes = np.zeros(S, np.int64)
    items = [[] for _ in range(Hp + Hp * (Hp + 1) // 2)]
    for s in range(S):
        idx = [int(a) for a in np.flatnonzero(act[s])]
        codes[s] = len(idx) + sum(a << (4 + 4 * i) for i, a in enumerate(idx))
        for i, a in enumerate(idx):
            items[a].append(i * S + s)
            for j in range(i + 1):
                items[Hp + _tri(a, idx[j])].append((gamma + _tri(i, j)) * S
                                                   + s)
    starts = np.cumsum([0] + [len(e) for e in items])
    entries = np.array([e for lst in items for e in lst], np.int64)
    return (np.concatenate([codes, starts, entries]).astype(np.int32),
            gamma)


def _support_table(sa: LinearStateArrays):
    """(the support table on the device of ``sa``, or None beyond the
    kernel's limits, and gamma), built once per state table: a step then
    builds nothing on the host, so it can be captured in a CUDA graph."""
    def build():
        act = (sa.states > 0.5).cpu().numpy()
        sizes = act.sum(axis=1)
        if act.shape[0] == 0 or sizes.min() < 2 or sizes.max() > GAMMA_MAX:
            return None, int(sizes.max()) if act.shape[0] else 0
        table, gamma = support_tables(act)
        return torch.as_tensor(table, device=sa.states.device), gamma
    return cached_for(sa.states, "gsc_support_table", build)


def within_limits(W: torch.Tensor, sa: LinearStateArrays, Hp: int) -> bool:
    """Whether the kernel holds the model: H' <= 8, H <= 1024 and
    supports of 2 to 4 units (read from the state table once)."""
    return (2 <= Hp <= HP_MAX and W.shape[1] <= H_MAX
            and _support_table(sa)[0] is not None)


def kernel_occupancy(H: int, sa: LinearStateArrays, Hp: int
                     ) -> Tuple[int, int]:
    """(bytes of shared memory a block, blocks that one SM of the current
    device holds at once) of the kernel for a model within its limits,
    the blocks asked of the runtime once."""
    table, gamma = _support_table(sa)
    S, nt = sa.states.shape[0], table.numel()
    lib = load_library()
    bps, = occupancy(lib, "gsc_et_estep_rows", (H, Hp, S, gamma, nt),
                     lambda out: lib.gsc_et_blocks_per_sm(H, Hp, S, gamma,
                                                          nt, out))
    return lib.gsc_et_smem_bytes(H, Hp, S, gamma, nt), bps


def _estep_rows(lib, y, weight, W, gram, scal, table, S: int, gamma: int,
                Hp: int, collect_true: bool, bps: int):
    """The three stages on one chunk of rows: (F, sums (D*H + stride,))."""
    (N, D), H = y.shape, W.shape[1]
    dev = y.device
    nb = min(-(-N // ROWS_TILE), sm_count(dev) * bps)
    stride = lib.gsc_et_ws_stride(H)
    F = torch.empty(N, dtype=torch.float32, device=dev)
    ws = torch.empty(nb * stride, dtype=torch.float32, device=dev)
    sums = torch.empty(D * H + stride, dtype=torch.float32, device=dev)
    P = sgemm_nn_cuda(y, W)
    with traced_region("gsc_rows"):
        err = lib.gsc_et_estep_rows(
            y.data_ptr(), weight.data_ptr(), P.data_ptr(), gram.data_ptr(),
            table.data_ptr(), scal.data_ptr(), F.data_ptr(), ws.data_ptr(),
            sums[D * H:].data_ptr(), N, D, H, Hp, S, gamma, table.numel(),
            int(collect_true), nb, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "gsc_et_estep_rows")
    xs = sums[:D * H].view(D, H)                      # P holds w <sz>
    sgemm_tn_splitn_cuda(y, P, out=xs)
    return F, sums


def gsc_et_estep_cuda(y, weight, W, sigma2, pi, mu, psi,
                      sa: LinearStateArrays, Hp: int, beta, prior_beta,
                      collect_true: bool = True
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The E-step kernels on CUDA tensors; the contract of
    ``core.gscstep.gsc_et_estep`` (any N; rows are chunked only where the
    (N, H) workspace for P would exceed ``cuda_lib.P_LIMIT_BYTES``).  The
    Gram matrix W^T W is a plain product, as the linear family's kernels
    take it."""
    if y.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {y.device}")
    N, D = y.shape
    H = W.shape[1]
    S = sa.states.shape[0]
    dev = y.device
    check(y, "y", (N, D), dev)
    check(weight, "weight", (N,), dev)
    check(W, "W", (D, H), dev)
    check(sa.states, "states", (S, Hp), dev)
    if N < 1:
        raise ValueError("need at least one datapoint")
    if not within_limits(W, sa, Hp):
        raise ValueError(
            f"kernel limits: 2 <= Hp <= {HP_MAX}, supports of 2 to "
            f"{GAMMA_MAX} units, H <= {H_MAX}; got {Hp=} {H=} and supports "
            f"of up to {_support_table(sa)[1]} units.  The kernel does "
            'not hold such a model; backend="plain" trains it on the card '
            "through the plain PyTorch version")
    table, gamma = _support_table(sa)
    lib = load_library()
    _, bps = kernel_occupancy(H, sa, Hp)
    gram = (W.T @ W).contiguous()
    scal = torch.cat([torch.stack([
        torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())
        for v in (sigma2, pi, mu, psi)]), schedule_pair(beta, prior_beta, dev)])
    F, sums = in_row_chunks(N, H, lambda i, j: _estep_rows(
        lib, y[i:j], weight[i:j], W, gram, scal, table, S, gamma, Hp,
        collect_true, bps))
    LAUNCHES["gsc_estep"] += 1
    o = D * H + H * H
    out = dict(xs=sums[:D * H].view(D, H), ss=sums[D * H:o].view(H, H),
               s=sums[o:o + H])
    for j, k in enumerate(KEYS):
        out[k] = sums[o + H + j]
    return F, out


def gsc_et_estep(y: torch.Tensor, weight: torch.Tensor, W: torch.Tensor,
                 sigma2, pi, mu, psi, sa: LinearStateArrays, Hp: int,
                 beta, prior_beta, chunk: int = 1024,
                 collect_true: bool = True, state_axis=None,
                 n_state_shards: int = 1
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """GSC's E-step, (F (N,), sums) with ``core.gscstep.gsc_et_estep``'s
    keys: on a CPU tensor the plain version chunked by ``chunk`` (under a
    state axis too), on a CUDA tensor the kernels (``chunk`` unused: the
    kernel takes any N).  On a CUDA tensor a state axis and a model past
    the kernel's limits raise a ValueError naming ``backend="plain"``."""
    if y.device.type != "cuda":
        return gscstep.gsc_et_estep(y, weight, W, sigma2, pi, mu, psi, sa,
                                    Hp, beta, prior_beta, chunk,
                                    collect_true, state_axis, n_state_shards)
    if state_sharded(state_axis, n_state_shards):
        raise ValueError(
            "under a state axis GSC runs the plain level-aligned E-step on "
            "each rank's share of the supports: the CUDA kernel needs every "
            'support; build the model with backend="plain" to train it on '
            "the card")
    return gsc_et_estep_cuda(y, weight, W, sigma2, pi, mu, psi, sa, Hp, beta,
                             prior_beta, collect_true)
