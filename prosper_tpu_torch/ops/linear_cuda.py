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
  call counts once in ``LAUNCHES["estep"]``.  With a model's 16-bit
  ``compute_dtype`` the two GEMM stages are ``hgemm_nn`` and
  ``hgemm_tn_splitn`` (the operands rounded to bf16 or fp16, summed in
  float32); the rows kernel is the same and reads float32 P, y, W and
  Gram matrix.
* ``linear_et_decode`` replaces ``linear_et_decode_pallas``: F, the
  posterior mean, the top-L states in canonical union indices and the
  candidates (serving).  It runs in two stages: ``P = y W``, then the
  per-datapoint kernel (``csrc/linear_et_decode.cu``), which keeps a row's
  posterior in shared memory.  One call counts once in
  ``LAUNCHES["decode"]``.

The library is built and loaded by ``ops/cuda_lib.py`` at first CUDA use
(never at import).  Each wrapper (``*_cuda``) checks its inputs, allocates
outputs and scratch with ``torch.empty``, launches on the current stream and
adds one to ``LAUNCHES``.  The family's two routes, ``linear_et_estep`` and
``linear_et_decode``, are the one place that picks a kernel or the plain
version (``core/etstep.py``) and that refuses: the plain version on a CPU
tensor, a kernel on a CUDA tensor, or a ValueError naming
``backend="plain"`` where no kernel holds the model.
"""

from __future__ import annotations

import heapq
from typing import Dict, Tuple

import numpy as np
import torch

from prosper_tpu_torch.core import etstep
from prosper_tpu_torch.core.etstep import LinearStateArrays
from prosper_tpu_torch.ops.bigs_cuda import linear_et_estep_bigs_cuda
from prosper_tpu_torch.ops.cuda_lib import (LAUNCHES, check, check_input,
                                            check_smem, in_row_chunks,
                                            load_library, n_blocks,
                                            needs_plain, occupancy, raise_on,
                                            row_chunks, scalars, sm_count)
from prosper_tpu_torch.ops.gemm_cuda import (hgemm_nn_cuda,
                                             hgemm_tn_splitn_cuda,
                                             sgemm_nn_cuda,
                                             sgemm_tn_splitn_cuda)
from prosper_tpu_torch.parallel.mesh import state_sharded
from prosper_tpu_torch.utils import cached_for

__all__ = ["LAUNCHES", "load_library", "linear_et_estep",
           "linear_et_estep_cuda", "linear_et_decode", "linear_et_decode_cuda",
           "rows_tables"]

HP_MAX, K_MAX, H_MAX = 32, 8, 1024
ROWS_TILE = 8                # datapoints per tile of the per-datapoint kernels
LANES = 32                   # lanes of a warp, which own a row's work


def check_limits(Hp: int, K: int, H: int):
    """Raise ValueError for a model wider than the fused kernels hold."""
    if not (Hp <= HP_MAX and K <= K_MAX and H <= H_MAX):
        raise needs_plain(
            f"kernel limits: Hp <= {HP_MAX}, K <= {K_MAX}, H <= {H_MAX}; "
            f"got {Hp=} {K=} {H=}.  The fused E-step and decode kernels do "
            "not hold such a model")


def _check_common(y, W, log_odds, sa: LinearStateArrays, Hp: int):
    """Validate the shared inputs, then build/load the kernels.
    Returns (lib, N, D, H, S, K)."""
    check_input(y)
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
    check_limits(Hp, K, H)
    return load_library(), N, D, H, S, K


def _check_smem(smem: int, S: int):
    check_smem(smem, f"the fused kernel does not hold S={S} multi states "
               "(s_block > 0 trains them through the big-S E-step)")


#: a piece's fixed cost in the moments' schedule, in states walked
PIECE_COST = 3


def _pieces(counts, target: int):
    """A moment row's words cut into consecutive ranges of at most
    ``target`` states (a word more only where it alone exceeds it):
    [(w0, w1, states)]."""
    out, w0, n = [], 0, 0
    for wd, c in enumerate(counts):
        if n and n + c > target:
            out.append((w0, wd, n))
            w0, n = wd, 0
        n += c
    out.append((w0, len(counts), n))
    return out


def _lane_schedule(cost):
    """Pieces shared out over the 32 lanes, largest first, each to the
    lane with the least work so far (ties to the lowest lane): (pieces
    lane by lane, start of each lane's pieces (33,), the largest lane's
    work)."""
    lanes = [[] for _ in range(LANES)]
    heap = [(0, lane) for lane in range(LANES)]
    for i in sorted(range(len(cost)), key=lambda i: (-cost[i], i)):
        load, lane = heapq.heappop(heap)
        lanes[lane].append(i)
        heapq.heappush(heap, (load + cost[i], lane))
    return (np.array([i for items in lanes for i in items], np.int64),
            np.cumsum([0] + [len(items) for items in lanes]),
            max(load for load, _ in heap))


def _moment_schedule(counts: np.ndarray, skip, max_pieces: int):
    """The moment rows (``counts`` (R, SW): states of each row in each
    word; rows in ``skip`` left out) cut into pieces and shared out over
    the lanes, the cut whose largest lane has the least work among a few
    piece sizes: (piece rows, first and end words, each row's first piece
    (R + 1,), pieces lane by lane, start of each lane's pieces (33,))."""
    R = counts.shape[0]
    rows = [r for r in range(R) if r not in skip]
    total = int(counts[rows].sum()) if rows else 0
    longest = int(counts.sum(axis=1).max()) if R else 0
    even = max(1, -(-total // LANES))
    best = None
    for target in sorted({max(1, int(even * f)) for f in
                          (0.5, 0.625, 0.75, 0.875, 1.0, 1.25, 1.5, 2.0)}
                         | {max(1, longest)}):
        pieces = [(r, w0, w1, n) for r in rows
                  for w0, w1, n in _pieces(counts[r], target)]
        if len(pieces) > max_pieces:
            continue
        order, lstart, work = _lane_schedule(
            [n + PIECE_COST for *_, n in pieces])
        if best is None or (work, len(pieces)) < best[0]:
            best = ((work, len(pieces)), pieces, order, lstart)
    _, pieces, order, lstart = best
    rstart = np.searchsorted([r for r, *_ in pieces], np.arange(R + 1))
    return (np.array([r for r, *_ in pieces], np.int64),
            np.array([w0 for _, w0, *_ in pieces], np.int64),
            np.array([w1 for _, _, w1, _ in pieces], np.int64),
            rstart, order, lstart)


def _bits(mask: np.ndarray) -> np.ndarray:
    """(n, m) booleans as n rows of ceil(m / 32) words, bit j % 32 of word
    j // 32 set where mask[:, j]."""
    n, m = mask.shape
    words = -(-m // 32)
    padded = np.zeros((n, words * 32), bool)
    padded[:, :m] = mask
    weights = np.left_shift(np.uint64(1), np.arange(32, dtype=np.uint64))
    return (padded.reshape(n, words, 32) * weights).sum(axis=2).astype(
        np.uint64)


def rows_tables(states, outer, values) -> Tuple[np.ndarray, int, int]:
    """The rows kernel's state tables as bit masks, built on the host from a
    state space's dense tables (S, Hp), (S, Hp^2) and its K non-zero
    values: (int32 table, KW, SW).  The table is, in order,

    * ``smask`` (S): the non-zero slots of each state, bit a for slot a;
    * ``sval`` (S * KW, KW = ceil(Hp / 8), none where K = 1): the index of
      each slot's value, 4 bits a slot, slot a in bits 4 (a % 8) of word
      a // 8;
    * ``rbits`` (R * SW, SW = ceil(S / 32)): for each row of the moments,
      slot a's (row a) then the slot pair a >= b's (row
      Hp + a (a + 1) / 2 + b), the states that hold it, state s in bit
      s % 32 of word s // 32;
    * ``rstart`` (R + 1) and ``lstart`` (33): each row's first piece, each
      lane's first entry of ``lorder``;
    * ``prow``, ``pw0``, ``pw1``, ``lorder`` (P each): the pieces of the
      rows, row by row (a piece: the words [pw0, pw1) of row prow), and
      the pieces lane by lane, largest first to the least-loaded lane.
      Where K = 1 a slot's own pair (a, a) has no piece: its moment is
      the slot's times the value.  P is at most Hp + Hp^2.

    The kernel walks a state's slots, and its slot pairs (a, b) in the
    order of a * Hp + b, and a piece's states in ascending order; a row
    adds its pieces' sums in order.  A pair's value is the product of its
    two values: ``outer`` must be the states' outer product (as every
    state space's is)."""
    states = np.asarray(states, np.float32)
    outer = np.asarray(outer, np.float32)
    values = np.asarray(values, np.float32).reshape(-1)
    S, Hp = states.shape
    K = values.size
    act = states != 0
    vidx = np.zeros((S, Hp), np.int64)
    found = np.zeros((S, Hp), bool)
    for k, v in enumerate(values):
        hit = states == v
        vidx[hit & ~found] = k
        found |= hit
    if np.any(act & ~found):
        raise ValueError("a state holds a value that is not in values")
    pair = act[:, :, None] & act[:, None, :]                  # (S, Hp, Hp)
    prod = values[vidx][:, :, None] * values[vidx][:, None, :]   # float32
    if not np.array_equal(np.where(pair, prod, np.float32(0)).reshape(
            S, Hp * Hp), outer):
        raise ValueError("outer is not the states' outer product")

    smask = _bits(act)[:, 0]
    KW = 0 if K == 1 else -(-Hp // 8)
    sval = np.zeros((S, KW), np.uint64)
    for a in range(Hp if K > 1 else 0):
        sval[:, a // 8] |= vidx[:, a].astype(np.uint64) << np.uint64(
            4 * (a % 8))
    low = [(a, b) for a in range(Hp) for b in range(a + 1)]
    rows = np.concatenate([act.T, np.array(
        [pair[:, a, b] for a, b in low], bool).reshape(len(low), S)])
    rbits = _bits(rows)
    counts = np.array([[bin(int(w)).count("1") for w in row]
                       for row in rbits], np.int64).reshape(rbits.shape)
    own = {Hp + a * (a + 1) // 2 + a for a in range(Hp)} if K == 1 else ()
    prow, pw0, pw1, rstart, lorder, lstart = _moment_schedule(
        counts, own, Hp + Hp * Hp)
    table = np.concatenate([smask, sval.reshape(-1), rbits.reshape(-1)]
                           + [a.astype(np.uint64) for a in (
                               rstart, lstart, prow, pw0, pw1, lorder)])
    return (table.astype(np.uint32).view(np.int32), KW,
            int(rbits.shape[1]))


def _rows_table(sa: LinearStateArrays):
    """The rows kernel's state tables on the device of ``sa``, built once
    per state space: a step then builds nothing on the host, so it can be
    captured in a CUDA graph."""
    def build():
        table = rows_tables(sa.states.cpu().numpy(), sa.outer.cpu().numpy(),
                            sa.values.cpu().numpy())[0]
        return torch.as_tensor(table, device=sa.states.device)
    return cached_for(sa.states, "rows_table", build)


def _state_minor(sa: LinearStateArrays):
    """The state tables as the kernels read them: transposed, so that the
    lanes of a warp, which walk the states, read consecutive addresses.
    Made once per state space."""
    return cached_for(sa.states, "state_minor", lambda: (
        sa.states.T.contiguous(), sa.outer.T.contiguous(),
        sa.value_counts.T.contiguous()))


def _estep_rows(lib, y, weight, W, gram, scal, log_odds, table,
                vcounts, sa: LinearStateArrays, Hp: int, signed_select: bool,
                collect_true: bool, bps: int, compute_dtype=None):
    """The three stages on one chunk of rows: (F, sums (D*H + stride,)).
    The GEMMs are the split-TF32 kernels, or with a 16-bit
    ``compute_dtype`` the 16-bit ones."""
    (N, D), H = y.shape, W.shape[1]
    S, K = sa.value_counts.shape
    dev = y.device
    nb = min(-(-N // ROWS_TILE), sm_count(dev) * bps)
    stride = lib.linear_et_estep_ws_stride(H, K)
    F = torch.empty(N, dtype=torch.float32, device=dev)
    ws = torch.empty(nb * stride, dtype=torch.float32, device=dev)
    sums = torch.empty(D * H + stride, dtype=torch.float32, device=dev)
    P = (sgemm_nn_cuda(y, W) if compute_dtype is None
         else hgemm_nn_cuda(y, W, compute_dtype))
    err = lib.linear_et_estep_rows(
        y.data_ptr(), weight.data_ptr(), P.data_ptr(), gram.data_ptr(),
        table.data_ptr(), vcounts.data_ptr(), sa.abs_states.data_ptr(),
        sa.values.data_ptr(), log_odds.data_ptr(), scal.data_ptr(),
        F.data_ptr(), ws.data_ptr(), sums[D * H:].data_ptr(), N, D, H, Hp, S,
        K, table.numel(), int(signed_select), int(collect_true), nb,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "linear_et_estep_rows")
    xs = sums[:D * H].view(D, H)                      # P holds w <s>
    if compute_dtype is None:
        sgemm_tn_splitn_cuda(y, P, out=xs)
    else:
        hgemm_tn_splitn_cuda(y, P, compute_dtype, out=xs)
    return F, sums


def rows_occupancy(lib, H: int, Hp: int, sa: LinearStateArrays
                   ) -> Tuple[int, int]:
    """(bytes of shared memory a block of the rows kernel takes, blocks
    that one SM of the current device holds at once), the blocks asked of
    the runtime once per shape.  Raises ``needs_plain`` where a block needs
    more shared memory than a block may use."""
    S, K = sa.value_counts.shape
    nt = _rows_table(sa).numel()
    smem = lib.linear_et_rows_smem_bytes(H, Hp, S, K, nt)
    _check_smem(smem, S)
    bps, = occupancy(lib, "linear_et_estep_rows", (H, Hp, S, K, nt),
                     lambda out: lib.linear_et_rows_blocks_per_sm(
                         H, Hp, S, K, nt, out))
    return smem, bps


def linear_et_estep_cuda(y, weight, W, sigma2, log_odds,
                         sa: LinearStateArrays, Hp: int, signed_select: bool,
                         beta, prior_beta, collect_true: bool = True,
                         compute_dtype=None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The E-step kernels on CUDA tensors; same contract as
    ``core.etstep.linear_et_estep`` (any N; rows are chunked only where the
    (N, H) workspace for P would exceed ``cuda_lib.P_LIMIT_BYTES``).  The
    Gram matrix stays float32 at every ``compute_dtype``."""
    lib, N, D, H, S, K = _check_common(y, W, log_odds, sa, Hp)
    _, bps = rows_occupancy(lib, H, Hp, sa)
    dev = y.device
    check(weight, "weight", (N,), dev)
    gram = (W.T @ W).contiguous()
    scal = scalars(sigma2, beta, prior_beta, dev)
    table, vcounts = _rows_table(sa), _state_minor(sa)[2]
    F, sums = in_row_chunks(N, H, lambda i, j: _estep_rows(
        lib, y[i:j], weight[i:j], W, gram, scal, log_odds, table, vcounts,
        sa, Hp, signed_select, collect_true, bps, compute_dtype))
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
                    n_state_shards: int = 1, compute_dtype=None,
                    collect_phi: bool = False, slot_onehot=None):
    """The family's E-step route, ``core.etstep.linear_et_estep``'s
    contract.  A learned Phi (``collect_phi``, with ``slot_onehot``) takes
    the plain version on a CPU tensor, under a state axis too, and raises
    on a CUDA tensor: no kernel collects its value-set sums.  Else, under a
    state axis (``state_axis``, ``n_state_shards > 1``), the big-S kernel
    on this state rank's slice whatever ``s_block`` is (the fused rows
    kernel needs the whole union in one block), or on a CPU tensor its
    plain version over the same slice; without one, the plain version on a
    CPU tensor (chunked by ``chunk``), and on a CUDA tensor the fused
    E-step's three stages or, with ``s_block > 0``, the big-S kernel
    (``ops/bigs_cuda.py``).  A 16-bit ``compute_dtype`` takes the two D x H
    products of these paths to the 16-bit GEMM kernels on a CUDA tensor
    (``matmul_as`` on a CPU one)."""
    if collect_phi:
        if y.is_cuda:
            raise needs_plain("no CUDA kernel collects the value-set sums "
                              "(phi_c, phi_M) of a learned Phi")
        return etstep.linear_et_estep(
            y, weight, W, sigma2, log_odds, sa, Hp, signed_select, beta,
            prior_beta, chunk, collect_true, collect_phi=True,
            slot_onehot=slot_onehot, state_axis=state_axis,
            n_state_shards=n_state_shards, compute_dtype=compute_dtype)
    sharded = state_sharded(state_axis, n_state_shards)
    if not (y.is_cuda or sharded):
        return etstep.linear_et_estep(y, weight, W, sigma2, log_odds, sa, Hp,
                                      signed_select, beta, prior_beta, chunk,
                                      collect_true, s_block,
                                      compute_dtype=compute_dtype)
    if sharded or s_block > 0:
        return linear_et_estep_bigs_cuda(
            y, weight, W, sigma2, log_odds, sa, Hp, signed_select, beta,
            prior_beta, s_block, collect_true, state_axis=state_axis,
            n_state_shards=n_state_shards, compute_dtype=compute_dtype)
    return linear_et_estep_cuda(y, weight, W, sigma2, log_odds, sa, Hp,
                                signed_select, beta, prior_beta, collect_true,
                                compute_dtype)


def linear_et_decode(y, W, sigma2, log_odds, sa: LinearStateArrays, Hp: int,
                     signed_select: bool, top_L: int, beta, prior_beta,
                     chunk: int = 4096, s_block: int = 0,
                     learned_phi: bool = False):
    """The family's decode route, ``core.etstep.linear_et_decode``'s
    contract: the kernel on a CUDA tensor, the plain version (chunked by
    ``chunk``) on a CPU one.  A big-S model (``s_block > 0``) decodes
    through the plain version on either device, as the JAX package keeps
    such models off its fused decode; a learned Phi too, and on a CUDA
    tensor it raises."""
    if learned_phi and y.is_cuda:
        raise needs_plain("the decode kernel takes no learned Phi")
    if s_block > 0 or learned_phi or not y.is_cuda:
        return etstep.linear_et_decode(y, W, sigma2, log_odds, sa, Hp,
                                       signed_select, top_L, beta, prior_beta,
                                       chunk)
    return linear_et_decode_cuda(y, W, sigma2, log_odds, sa, Hp,
                                 signed_select, top_L, beta, prior_beta)
