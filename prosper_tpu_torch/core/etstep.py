"""The Expectation-Truncation E-step for linear-superposition models, in
plain PyTorch.

Counterpart of ``prosper_tpu/core/etstep.py`` for BSC, TSC and DSC (every
model with ``ybar = W @ s`` and isotropic Gaussian noise).  Per datapoint
the truncated union is ``{0} ∪ {H x K singletons} ∪ {S multi states over
the H' candidates}``, and

  ||y - W s||^2 = ||y||^2 - 2 s.(Wc^T y) + s.(Wc^T Wc).s

so the E-step needs ``P = y @ W``, the candidates' projections
``proj = P[n, cand]`` and Gram entries ``gram[cand, cand]``; nothing of size
(N, S, D) exists.  Gathers and scatters use indices (``gather``,
``scatter_add_``, ``index_add_``).  At a large S (``s_block > 0``) the S
multi states go through ``bigs_multi`` in tiles with an online logsumexp,
so no (N, S) tensor exists either.  These functions are the plain versions
that the CUDA kernels in ``ops/linear_cuda.py`` and ``ops/bigs_cuda.py``
are held to, and the path that runs on the CPU; ``bigs_operands_tri`` and
``bigs_tables_tri`` build the reduced operands that the big-S kernel reads.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from prosper_tpu_torch.core.select import top_hprime_candidates, top_l_argmax
from prosper_tpu_torch.io.tracing import traced_region
from prosper_tpu_torch.parallel.mesh import (maybe_pmax, maybe_psum,
                                             state_rank, state_sharded)

NEG = -3e38   # masked logit


class LinearStateArrays(NamedTuple):
    """Device-resident static enumeration (from core.states.StateSpace)."""
    states: torch.Tensor        # (S, Hp)
    outer: torch.Tensor         # (S, Hp*Hp)
    abs_states: torch.Tensor    # (S,)
    value_counts: torch.Tensor  # (S, K)
    values: torch.Tensor        # (K,)


def state_arrays_from(space, device) -> LinearStateArrays:
    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)
    return LinearStateArrays(states=t(space.states), outer=t(space.outer),
                             abs_states=t(space.abs_states),
                             value_counts=t(space.value_counts),
                             values=t(space.values))


def traced_state_arrays(slot_onehot: torch.Tensor,
                        value_counts: torch.Tensor,
                        abs_states: torch.Tensor,
                        phi: torch.Tensor) -> LinearStateArrays:
    """State arrays as functions of a learned value vector ``phi`` (K,).

    ``slot_onehot`` is the static (S, Hp, K) assignment indicator
    (``core.states.slot_value_onehot``); states, outer and values follow
    the parameter, so DSC value-set learning re-enumerates nothing."""
    phi = phi.to(torch.float32)
    states = torch.einsum("sak,k->sa", slot_onehot, phi)
    S, Hp = states.shape
    outer = (states[:, :, None] * states[:, None, :]).reshape(S, Hp * Hp)
    return LinearStateArrays(states=states, outer=outer,
                             abs_states=abs_states,
                             value_counts=value_counts, values=phi)


def state_slice(S: int, n: int, srank: int, unit: int = 1
                ) -> Tuple[int, int, int]:
    """Shard ``srank`` of ``n`` over S states: the S axis padded so that
    each of the n contiguous slices holds S_loc states, a multiple of
    ``unit``.  Returns (lo, hi, S_loc): the slice's real states are
    ``lo:hi`` (none where lo == hi), the rest of its S_loc is padding."""
    per_rank = -(-S // n)
    S_loc = -(-per_rank // unit) * unit
    lo = min(srank * S_loc, S)
    return lo, min(lo + S_loc, S), S_loc


def slice_state_shard(srank: int, n: int, arrays, unit: int = 1):
    """This rank's slice of state-indexed arrays under state sharding (the
    JAX package's ``slice_state_shard``): the S axis padded with zeros to
    n slices of S_loc states (a multiple of ``unit``), the contiguous slice
    of state rank ``srank``.  Returns (sliced list, svalid (S_loc,): 1 for
    a real state and 0 for padding, own_zs): ``own_zs`` is 1.0 on state
    rank 0 alone, which owns the zero and singleton states and the
    per-datapoint scalars (the sums are added over the state axis, so
    those must count once)."""
    S = arrays[0].shape[0]
    lo, hi, S_loc = state_slice(S, n, srank, unit)

    def sl(a):
        pad = (0, 0) * (a.dim() - 1) + (0, S_loc - (hi - lo))
        return torch.nn.functional.pad(a[lo:hi], pad)
    svalid = (torch.arange(S_loc, device=arrays[0].device)
              < hi - lo).float()
    return [sl(a) for a in arrays], svalid, float(srank == 0)


def pmax_pair(a, b, state_axis):
    """(a, b) (b may be None), each maximised over the state group in one
    all-reduce (a alone: in place)."""
    if b is None:
        return maybe_pmax(a, state_axis), None
    ab = maybe_pmax(torch.stack([a, b]), state_axis)
    return ab[0], ab[1]


def psum_pair(a, b, state_axis):
    """(a, b) (b may be None), each summed over the state group in one
    all-reduce (a alone: in place)."""
    if b is None:
        return maybe_psum(a, state_axis), None
    ab = maybe_psum(torch.stack([a, b]), state_axis)
    return ab[0], ab[1]


def mask_union(logits, lead: int, own: float, svalid):
    """A state shard's union logits ``[zero | singletons (lead - 1) |
    slice]``: the zero and singleton columns NEG off state rank 0, the
    slice's padding NEG (None stays None)."""
    if logits is None:
        return None
    head = logits[:, :lead] if own else torch.full_like(logits[:, :lead],
                                                        NEG)
    tail = torch.where(svalid[None, :] > 0, logits[:, lead:],
                       torch.full_like(logits[:, lead:], NEG))
    return torch.cat([head, tail], dim=1)


def union_softmax(logits, logits_t, state_axis=None):
    """The union softmax of a chunk's logits (C, columns) and the
    un-annealed channel's log-normaliser (``logits_t`` may be None).
    Returns (q, logZ (C,), logZ_t (C,) or None).  With a state group (a
    shard's masked logits, ``mask_union``) the row maxima are combined by
    one MAX all-reduce and the rescaled masses by one SUM, both channels in
    each, so every state rank gets the same logZ."""
    if state_axis is None:
        m = logits.max(dim=1, keepdim=True).values
        p = torch.exp(logits - m)
        Z = p.sum(dim=1, keepdim=True)
        return (p / Z, (m + torch.log(Z))[:, 0],
                None if logits_t is None else torch.logsumexp(logits_t, dim=1))
    M, M_t = pmax_pair(logits.max(dim=1).values,
                       None if logits_t is None
                       else logits_t.max(dim=1).values, state_axis)
    p = torch.exp(logits - M[:, None])
    Z_t = (None if logits_t is None
           else torch.exp(logits_t - M_t[:, None]).sum(dim=1))
    Z, Z_t = psum_pair(p.sum(dim=1), Z_t, state_axis)
    return (p / Z[:, None], M + torch.log(Z),
            None if logits_t is None else M_t + torch.log(Z_t))


def own_scalars(sums: Dict[str, torch.Tensor], own: float):
    """The per-datapoint scalars of a state shard's sums counted on state
    rank 0 alone (times 1.0 there, 0.0 elsewhere: exact)."""
    for k in ("y2", "n", "F", "F_true"):
        sums[k] = sums[k] * own
    return sums


def matmul_as(a, b, compute_dtype=None):
    """``a @ b``; with a 16-bit ``compute_dtype`` (``torch.bfloat16`` or
    ``torch.float16``) the float32 product of ``a`` and ``b`` rounded to it
    (to nearest, ties to even): the products of the rounded operands are
    exact in float32 and summed in float32.  This is the JAX package's
    ``jnp.dot(a.astype(dt), b.astype(dt), preferred_element_type=f32)`` and
    the plain version of the 16-bit GEMM kernels (``ops/gemm_cuda.py``);
    the linear family's ``compute_dtype`` rounds nothing else."""
    if compute_dtype is None:
        return a @ b
    return a.to(compute_dtype).float() @ b.to(compute_dtype).float()


def _candidates(y, W, gram, gram_diag, Hp: int, signed_select: bool, P=None,
                compute_dtype=None):
    """P = y @ W (unless given; ``matmul_as`` at ``compute_dtype``), the
    top-Hp candidates, their projections and Gram entries: (P (C, H),
    cand (C, Hp), proj (C, Hp), Gf (C, Hp^2))."""
    C = y.shape[0]
    if P is None:
        P = matmul_as(y, W, compute_dtype)
    w_norm = torch.sqrt(torch.clamp(gram_diag, min=1e-30))
    cand = top_hprime_candidates(P, w_norm, Hp, signed_select)
    proj = torch.gather(P, 1, cand)
    Gf = gram[cand[:, :, None], cand[:, None, :]].reshape(C, Hp * Hp)
    return P, cand, proj, Gf


def _lik_single(P, gram_diag, values, inv2s2):
    """(C, H, K) log-likelihood terms of the singleton states."""
    return (2.0 * P[:, :, None] * values[None, None, :]
            - gram_diag[None, :, None] * (values ** 2)[None, None, :]) * inv2s2


def _union_logits(y, W, gram, gram_diag, sigma2, log_odds,
                  sa: LinearStateArrays, Hp: int, signed_select: bool,
                  beta, prior_beta, P=None, compute_dtype=None):
    """Shared front end: candidates and the annealed union logits
    ``[zero | H*K singletons | S multi]`` plus the un-annealed pieces.

    Returns (P, cand, proj, Gf, logits (C, 1+H*K+S), lik_single (C,H,K),
    lik_multi (C,S), prior_multi (S,))."""
    C = y.shape[0]
    H = W.shape[1]
    K = sa.values.shape[0]
    inv2s2 = 0.5 / sigma2
    P, cand, proj, Gf = _candidates(y, W, gram, gram_diag, Hp, signed_select,
                                    P, compute_dtype)
    lik_multi = (2.0 * (proj @ sa.states.T) - Gf @ sa.outer.T) * inv2s2
    prior_multi = sa.value_counts @ log_odds                         # (S,)
    logits_multi = beta * lik_multi + prior_beta * prior_multi[None, :]
    lik_single = _lik_single(P, gram_diag, sa.values, inv2s2)
    logits_single = (beta * lik_single
                     + prior_beta * log_odds[None, None, :]).reshape(C, H * K)
    logits = torch.cat([torch.zeros((C, 1), dtype=P.dtype, device=P.device),
                        logits_single, logits_multi], dim=1)
    return P, cand, proj, Gf, logits, lik_single, lik_multi, prior_multi


def _free_energy_const(y2, D: int, H: int, sigma2, log_odds, beta,
                       prior_beta):
    """The per-datapoint constant of F: -beta ||y||^2/2s2 - beta log_norm
    + prior_beta H log p0."""
    sigma2 = torch.as_tensor(sigma2, dtype=torch.float32, device=y2.device)
    inv2s2 = 0.5 / sigma2
    log_p0 = -torch.log1p(torch.exp(log_odds).sum())
    log_norm = 0.5 * D * torch.log(2.0 * math.pi * sigma2)
    return -beta * (y2 * inv2s2) - beta * log_norm + prior_beta * H * log_p0


def _weighted_sums(y, y2, wv, s_full, sum_ss, abs_n, vc_n, F, F_true,
                   staged: bool = False, compute_dtype=None):
    """A chunk's sufficient statistics, each row weighted by ``wv``;
    ``sum_ss`` comes weighted already.  ``staged`` leaves the last product
    to the caller: the sums then hold ``sw = w <s>`` (C, H) in place of
    ``xs = y.T @ sw`` (``matmul_as`` at ``compute_dtype``)."""
    sw = s_full * wv[:, None]
    sums = dict(
        ss=sum_ss, s=sw.sum(dim=0),
        abs=(abs_n * wv).sum(), vc=(vc_n * wv[:, None]).sum(dim=0),
        y2=(y2 * wv).sum(), n=wv.sum(), F=(F * wv).sum(),
        F_true=(F_true * wv).sum())
    if staged:
        return dict(sw=sw, **sums)
    return dict(xs=matmul_as(y.T, sw, compute_dtype), **sums)


def _chunk_estats(y, w, W, gram, gram_diag, sigma2, log_odds,
                  sa: LinearStateArrays, Hp: int, signed_select: bool,
                  beta, prior_beta, collect_true: bool = True, P=None,
                  collect_phi: bool = False, slot_onehot=None,
                  state_axis=None, n_state_shards: int = 1,
                  compute_dtype=None):
    """E-statistics for one chunk: y (C, D), w (C,) accumulation weights.
    Returns (F (C,), sums).  F is the per-datapoint truncated
    log-pseudo-likelihood with every constant term.  Given ``P = y @ W``
    it is the middle stage alone (``linear_et_estep_rows``).
    ``collect_phi`` adds the value-set sums ``phi_c`` (K,) and ``phi_M``
    (K, K) from ``slot_onehot`` (S, Hp, K).  ``compute_dtype`` (16-bit)
    rounds the operands of the two D x H products alone (``matmul_as``):
    y for ||y||^2, W for the Gram matrix and the rows' other inputs stay
    float32, as in the JAX package.

    State sharding (``state_axis``, the state group, and
    ``n_state_shards > 1``): the rank evaluates its contiguous slice of
    the S multi states (``slice_state_shard``), the zero and singleton
    states on state rank 0 alone, and the softmax is combined over the
    group (``union_softmax``: one MAX and one SUM all-reduce for both
    channels).  F is then the same on every state rank; the sums are this
    rank's part, which the caller adds over the state group too."""
    C, D = y.shape
    H = W.shape[1]
    K = sa.values.shape[0]
    staged = P is not None
    sharded = state_sharded(state_axis, n_state_shards)
    if sharded:
        to_slice = [sa.states, sa.outer, sa.value_counts, sa.abs_states]
        if collect_phi:
            to_slice.append(slot_onehot)
        sliced, svalid, own = slice_state_shard(
            state_rank(state_axis), n_state_shards, to_slice)
        sa = sa._replace(states=sliced[0], outer=sliced[1],
                         value_counts=sliced[2], abs_states=sliced[3])
        if collect_phi:
            slot_onehot = sliced[4]
    (P, cand, proj, Gf, logits, lik_single, lik_multi,
     prior_multi) = _union_logits(y, W, gram, gram_diag, sigma2, log_odds,
                                  sa, Hp, signed_select, beta, prior_beta, P,
                                  compute_dtype)
    # the un-annealed channel (beta = prior_beta = 1); skipped when the
    # caller knows the schedule is saturated, where it equals F
    logits_t = None if not collect_true else torch.cat(
        [torch.zeros((C, 1), dtype=y.dtype, device=y.device),
         (lik_single + log_odds[None, None, :]).reshape(C, H * K),
         lik_multi + prior_multi[None, :]], dim=1)
    if sharded:
        logits, logits_t = (mask_union(t, 1 + H * K, own, svalid)
                            for t in (logits, logits_t))
    q, logZ, logZ_t = union_softmax(logits, logits_t,
                                    state_axis if sharded else None)
    y2 = (y * y).sum(dim=1)
    F = logZ + _free_energy_const(y2, D, H, sigma2, log_odds, beta,
                                  prior_beta)
    F_true = F if not collect_true else (
        logZ_t + _free_energy_const(y2, D, H, sigma2, log_odds, 1.0, 1.0))

    v = sa.values
    q_single = q[:, 1:1 + H * K].reshape(C, H, K)
    q_multi = q[:, 1 + H * K:]
    s_single = q_single @ v                                          # (C, H)
    ss_diag_single = q_single @ (v ** 2)                             # (C, H)
    s_cand = q_multi @ sa.states                                     # (C, Hp)
    ss_cand = q_multi @ sa.outer                                     # (C, Hp^2)

    wv = w.to(torch.float32)
    s_full = s_single.scatter_add(1, cand, s_cand)                   # (C, H)
    ss_idx = (cand[:, :, None] * H + cand[:, None, :]).reshape(-1)
    ss_val = (ss_cand.reshape(C, Hp, Hp) * wv[:, None, None]).reshape(-1)
    sum_ss = torch.zeros(H * H, dtype=torch.float32, device=y.device)
    sum_ss = sum_ss.index_add_(0, ss_idx, ss_val).reshape(H, H)
    sum_ss = sum_ss + torch.diag((ss_diag_single * wv[:, None]).sum(dim=0))

    abs_n = q_single.sum(dim=(1, 2)) + q_multi @ sa.abs_states
    vc_n = q_single.sum(dim=1) + q_multi @ sa.value_counts           # (C, K)
    sums = _weighted_sums(y, y2, wv, s_full, sum_ss, abs_n, vc_n, F, F_true,
                          staged, compute_dtype)
    if collect_phi:
        # With s = sum_k phi_k b_k (b_k the indicator of value k per unit)
        # the expected complete-data log-likelihood is quadratic in phi; its
        # stationary point solves M phi = c with
        #   c_k  = sum_n w E[b_k]^T W^T y_n
        #   M_kj = sum_n w E[b_k^T (W^T W) b_j].
        # The multi states use the candidate-space posterior; a singleton
        # has one active unit and adds to the diagonal only.
        S = slot_onehot.shape[0]
        Qsel = (q_multi @ slot_onehot.reshape(S, Hp * K)).reshape(C, Hp, K)
        phi_c_multi = torch.einsum("nak,na,n->k", Qsel, proj, wv)
        QGf = (q_multi * wv[:, None]).T @ Gf                     # (S, Hp^2)
        phi_M_multi = torch.einsum("sab,sak,sbj->kj", QGf.reshape(S, Hp, Hp),
                                   slot_onehot, slot_onehot)
        phi_c_single = torch.einsum("nhk,nh,n->k", q_single, P, wv)
        phi_M_single = torch.einsum("nhk,h,n->k", q_single, gram_diag, wv)
        sums["phi_c"] = phi_c_multi + phi_c_single
        sums["phi_M"] = phi_M_multi + torch.diag(phi_M_single)
    return F, own_scalars(sums, own) if sharded else sums


def linear_et_estep_rows(y, weight, P, W, sigma2, log_odds,
                         sa: LinearStateArrays, Hp: int, signed_select: bool,
                         beta, prior_beta, collect_true: bool = True):
    """The per-datapoint stage of the E-step alone, plain version of the
    rows kernel (``csrc/linear_et_estep.cu``): from ``P = y @ W`` it returns
    (F (N,), sw = w <s> (N, H), sums without xs).  The E-step is
    ``P = y @ W``, this, then ``xs = y.T @ sw``."""
    gram = W.T @ W
    F, sums = _chunk_estats(y, weight, W, gram, torch.diagonal(gram), sigma2,
                            log_odds, sa, Hp, signed_select, beta, prior_beta,
                            collect_true, P=P)
    return F, sums.pop("sw"), sums


# ---- big S: the multi states in s_block tiles, online logsumexp -------------

def bigs_operands(proj, Gf, states_p, outer_p, vcounts_p, prior, valid,
                  absst_p, inv2s2, beta, prior_beta, collect_true=True):
    """The two GEMM operands of the big-S recurrence, in the merged form of
    the JAX scan (``prosper_tpu/core/etstep.py:508-524``):

      logits  = Xa @ A.T   A  = [st | ot | prior | mask]   (S_pad, nA)
                           Xa = [2 b i proj | -b i Gf | prior_beta | 1]
      moments = p @ B      B  = [st | ot | vcounts | abs | 1]  (S_pad, nB)

    with b = beta and i = 1/(2 sigma^2); the un-annealed channel uses
    Xt = [2 i proj | -i Gf | 1 | 1].  A padded state is masked through its
    own column (0 valid, NEG padded) against a constant 1, never through the
    prior, so ``prior_beta = 0`` cannot unmask it.
    Returns (Xa (C, nA), Xt (C, nA) or None, A, B)."""
    ones = torch.ones((proj.shape[0], 1), dtype=torch.float32,
                      device=proj.device)
    mask = torch.where(valid > 0, torch.zeros_like(valid),
                       torch.full_like(valid, NEG))
    A = torch.cat([states_p, outer_p, prior[:, None], mask[:, None]], dim=1)
    B = torch.cat([states_p, outer_p, vcounts_p, absst_p[:, None],
                   torch.ones_like(absst_p)[:, None]], dim=1)
    X = torch.cat([(2.0 * inv2s2) * proj, (-inv2s2) * Gf], dim=1)
    Xa = torch.cat([beta * X, prior_beta * ones, ones], dim=1)
    Xt = torch.cat([X, ones, ones], dim=1) if collect_true else None
    return Xa, Xt, A, B


def split_moments(m, m_t, l_t, acc, Hp: int, K: int):
    """(m, l, m_t, l_t, a_abs, a_s, a_ss, a_vc) from the running maxima and
    the (C, nB) moment accumulator, whose columns follow ``B``."""
    nB = acc.shape[1]
    return (m, acc[:, nB - 1], m_t, l_t, acc[:, nB - 2], acc[:, :Hp],
            acc[:, Hp:Hp + Hp * Hp], acc[:, Hp + Hp * Hp:Hp + Hp * Hp + K])


def pad_last(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with zero columns appended up to ``width``."""
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


@functools.lru_cache(maxsize=None)
def tri_columns(Hp: int, device):
    """Flat indices into a row-major (Hp, Hp) matrix for its reduced form
    ``[diagonal | upper triangle, a < b in row order]``: (diag (Hp,),
    ab (P,), ba (P,), mirror (Hp*Hp,)) with P = Hp (Hp - 1) / 2, where
    ``mirror`` takes the Hp + P reduced columns back to the full matrix
    (entries (a, b) and (b, a) read the same column).  Built once per
    (Hp, device)."""
    a, b = torch.triu_indices(Hp, Hp, offset=1, device=device)
    diag = torch.arange(Hp, device=device) * (Hp + 1)
    mirror = torch.empty((Hp, Hp), dtype=torch.long, device=device)
    mirror[a, b] = mirror[b, a] = Hp + torch.arange(a.shape[0], device=device)
    mirror.view(-1)[diag] = torch.arange(Hp, device=device)
    return diag, a * Hp + b, b * Hp + a, mirror.reshape(-1)


def bigs_operands_tri(proj, Gf, inv2s2, lead: int = 1):
    """The per-datapoint operand of the big-S recurrence in its reduced
    form (the ``bigs_multi`` kernel's, ``ops/bigs_cuda.py``): the Gram
    matrix enters s.G.s only through its diagonal and the sums
    g_ab + g_ba, so

      X = i [2 proj | -g_aa | -(g_ab + g_ba), a < b]    (C, nL)

    with i = 1/(2 sigma^2) and nL = Hp + Hp (Hp + 1) / 2; beta, the prior
    and the mask stay out of it (``X @ A`` serves both channels).  The row
    length is padded with zeros to a multiple of ``lead``."""
    Hp = proj.shape[1]
    diag, ab, ba, _ = tri_columns(Hp, proj.device)
    X = torch.cat([(2.0 * inv2s2) * proj, (-inv2s2) * Gf[:, diag],
                   (-inv2s2) * (Gf[:, ab] + Gf[:, ba])], dim=1)
    return pad_last(X, -(-X.shape[1] // lead) * lead)


def bigs_tables_tri(states_p, outer_p, vcounts_p, absst_p, lead: int = 1,
                    cols: int = 0):
    """The state-table operands of the reduced form, which depend on the
    state space alone:

      A = [s_a | s_a^2 | s_a s_b, a < b]^T                (nL, S) state-minor
      B = [s_a | s_a^2 | s_a s_b, a < b | vcounts | |s| | 1]   (S, nM)

    with nM = nL + K + 2.  A's rows are padded with zeros to a multiple of
    ``lead`` states and B's to ``cols`` columns (0: none)."""
    Hp = states_p.shape[1]
    diag, ab, _, _ = tri_columns(Hp, states_p.device)
    tri = torch.cat([states_p, outer_p[:, diag], outer_p[:, ab]], dim=1)
    B = torch.cat([tri, vcounts_p, absst_p[:, None],
                   torch.ones_like(absst_p)[:, None]], dim=1)
    S = tri.shape[0]
    return (pad_last(tri.T, -(-S // lead) * lead).contiguous(),
            pad_last(B, max(cols, B.shape[1])).contiguous())


def split_moments_tri(m, m_t, l_t, acc, Hp: int, K: int):
    """``split_moments`` for a moment accumulator whose columns follow the
    reduced ``B`` of ``bigs_tables_tri`` (columns past nM are padding):
    <s_a s_b> is mirrored from its triangle, so a_ss (C, Hp^2) is exactly
    symmetric."""
    nL = Hp + Hp * (Hp + 1) // 2
    mirror = tri_columns(Hp, acc.device)[3]
    return (m, acc[:, nL + K + 1], m_t, l_t, acc[:, nL + K], acc[:, :Hp],
            acc[:, Hp:nL][:, mirror], acc[:, nL:nL + K])


def bigs_multi(proj, Gf, states_p, outer_p, vcounts_p, prior, valid,
               absst_p, inv2s2, beta, prior_beta, s_block: int,
               collect_true: bool = True):
    """The multi-state part of the big-S E-step, plain version of the
    ``bigs_multi`` kernel (``ops/bigs_cuda.py``): per ``s_block`` tile of
    the padded state tables one logits GEMM, the running max with its
    rescale, and one moment GEMM; nothing of size (C, S_pad) exists.

    proj (C, Hp), Gf (C, Hp^2); the state tables padded to S_pad rows, a
    multiple of ``s_block``, with ``valid`` (S_pad,) marking the real ones.
    Returns (m, l, m_t, l_t, a_abs, a_s, a_ss, a_vc), datapoint first; with
    ``collect_true`` off, m_t = NEG and l_t = 0.  A table with no real
    state (a state shard's slice of padding only, or S_pad = 0) gives
    m = m_t = NEG, l = l_t = 0 and zero moments: each tile's weights are
    multiplied by ``valid``, since a padded logit is NEG and a tile of
    padding alone would otherwise weigh each of its states exp(0) = 1."""
    C, Hp = proj.shape
    S_pad, K = vcounts_p.shape
    if S_pad % s_block:
        raise ValueError(f"{S_pad} padded states are not a multiple of "
                         f"s_block={s_block}")
    Xa, Xt, A, B = bigs_operands(proj, Gf, states_p, outer_p, vcounts_p,
                                 prior, valid, absst_p, inv2s2, beta,
                                 prior_beta, collect_true)
    m = torch.full((C,), NEG, dtype=torch.float32, device=proj.device)
    m_t = m.clone()
    l_t = torch.zeros_like(m)
    acc = torch.zeros((C, B.shape[1]), dtype=torch.float32,
                      device=proj.device)
    for j in range(0, S_pad, s_block):
        A_b, B_b = A[j:j + s_block], B[j:j + s_block]
        v_b = valid[None, j:j + s_block]
        logits = Xa @ A_b.T
        m_new = torch.maximum(m, logits.max(dim=1).values)
        p = torch.exp(logits - m_new[:, None]) * v_b
        acc = acc * torch.exp(m - m_new)[:, None] + p @ B_b
        m = m_new
        if collect_true:
            logits_t = Xt @ A_b.T
            m_tn = torch.maximum(m_t, logits_t.max(dim=1).values)
            l_t = (l_t * torch.exp(m_t - m_tn)
                   + (torch.exp(logits_t - m_tn[:, None]) * v_b).sum(dim=1))
            m_t = m_tn
    return split_moments(m, m_t, l_t, acc, Hp, K)


def slot_sum_ss(ssw, cand, H: int):
    """sum_ss[h, k] = sum_n sum_ab [cand_na = h] ssw[n, a*Hp+b] [cand_nb = k]
    without atomics, so that it is the same in every run on every device:
    ``scatter_`` writes each row's Hp distinct candidates once, and the sum
    over rows and slots is one (H, C*Hp) x (C*Hp, H) GEMM (the per-slot
    product form of the JAX package's ``slot_scatter_mat``).  It costs
    C*Hp*H^2 multiply-adds: little at the H of big-S models, more than the
    atomic ``index_add_`` of ``_chunk_estats`` at H in the hundreds."""
    C, Hp = cand.shape
    z = torch.zeros((C, Hp, H), dtype=torch.float32, device=cand.device)
    hot = z.scatter(2, cand[:, :, None], 1.0)
    vals = z.scatter(2, cand[:, None, :].expand(C, Hp, Hp),
                     ssw.reshape(C, Hp, Hp))
    return hot.reshape(C * Hp, H).T @ vals.reshape(C * Hp, H)


def bigs_front(y, W, gram, gram_diag, log_odds, sa: LinearStateArrays,
               Hp: int, signed_select: bool, s_block: int, shard=None,
               P=None, compute_dtype=None):
    """The big-S front end: ``P = y @ W`` (unless given; ``matmul_as`` at
    ``compute_dtype``), the candidates, and the operands
    of ``bigs_multi`` before its scalars: proj (C, Hp), Gf (C, Hp^2) and the
    state tables padded to a multiple of ``s_block``, with the prior and
    the validity of each padded state.  ``shard = (srank, n)``: the tables
    of state rank srank's slice instead, the S axis padded so that each of
    the n slices is a whole number of ``s_block`` tiles
    (``slice_state_shard``).
    Returns (P, cand, (proj, Gf, states_p, outer_p, vcounts_p, prior,
    valid, absst_p))."""
    S = sa.states.shape[0]
    P, cand, proj, Gf = _candidates(y, W, gram, gram_diag, Hp, signed_select,
                                    P, compute_dtype)
    tables = [sa.states, sa.outer, sa.value_counts, sa.abs_states]
    if shard is not None:
        (states_p, outer_p, vcounts_p, absst_p), valid, _ = \
            slice_state_shard(shard[0], shard[1], tables, s_block)
    else:
        pad = -S % s_block

        def padded(t):
            return torch.nn.functional.pad(
                t, (0, 0, 0, pad) if t.dim() == 2 else (0, pad))
        states_p, outer_p, vcounts_p, absst_p = (padded(t) for t in tables)
        valid = (torch.arange(S + pad, device=y.device) < S).float()
    return P, cand, (proj, Gf, states_p, outer_p, vcounts_p,
                     vcounts_p @ log_odds, valid, absst_p)


def _chunk_estats_bigs(y, w, W, gram, gram_diag, sigma2, log_odds,
                       sa: LinearStateArrays, Hp: int, signed_select: bool,
                       beta, prior_beta, s_block: int,
                       collect_true: bool = True, multi=bigs_multi,
                       state_axis=None, n_state_shards: int = 1, P=None,
                       compute_dtype=None):
    """Big-S E-statistics for one chunk: the zero and singleton states in
    closed form, the S multi states through ``multi`` (``bigs_multi`` or its
    kernel), the two partial softmaxes combined.  Same (F, sums) as
    ``_chunk_estats``; no (C, S) tensor exists.  Given ``P = y @ W`` the
    sums hold ``sw`` in place of ``xs``, as ``_chunk_estats``'s; otherwise
    both products run at ``compute_dtype`` (``matmul_as``).

    State sharding (as ``_chunk_estats``): ``multi`` runs over this state
    rank's slice of the tables (``bigs_front``), state rank 0 alone holds
    the zero and singleton states (elsewhere their part is m = NEG, l = 0),
    and the two partial softmaxes are combined over the group as well: one
    MAX all-reduce of the row maxima, one SUM of the rescaled masses (both
    channels in each)."""
    C, D = y.shape
    H = W.shape[1]
    K = sa.values.shape[0]
    inv2s2 = 0.5 / sigma2
    sharded = state_sharded(state_axis, n_state_shards)
    shard = (state_rank(state_axis), n_state_shards) if sharded else None
    own = 1.0 if shard is None else float(shard[0] == 0)
    staged = P is not None
    P, cand, tables = bigs_front(y, W, gram, gram_diag, log_odds, sa, Hp,
                                 signed_select, s_block, shard, P,
                                 compute_dtype)

    # zero + singleton part (1 + H*K columns) in closed form
    v = sa.values
    lik_single = _lik_single(P, gram_diag, v, inv2s2)

    def part_a(logits_single):
        if not own:
            return (torch.full((C,), NEG, device=y.device),
                    torch.zeros((C,), device=y.device))
        m_a = torch.clamp(logits_single.max(dim=1).values, min=0.0)
        return m_a, (torch.exp(-m_a) + torch.exp(
            logits_single - m_a[:, None]).sum(dim=1))

    logits_single = (beta * lik_single
                     + prior_beta * log_odds[None, None, :]).reshape(C, H * K)
    if not own:
        logits_single = torch.full_like(logits_single, NEG)
    m_a, l_a = part_a(logits_single)
    if collect_true:
        m_at, l_at = part_a((lik_single
                             + log_odds[None, None, :]).reshape(C, H * K))

    # the multi states, over the tables padded to a multiple of s_block
    m_b, l_b, m_bt, l_bt, a_abs, a_s, a_ss, a_vc = multi(
        *tables, inv2s2, beta, prior_beta, s_block, collect_true)

    # combine the two partial softmaxes (and those of the state ranks)
    M = torch.maximum(m_a, m_b)
    M_t = torch.maximum(m_at, m_bt) if collect_true else None
    if sharded:
        M, M_t = pmax_pair(M, M_t, state_axis)
    Z = l_a * torch.exp(m_a - M) + l_b * torch.exp(m_b - M)
    Z_t = (l_at * torch.exp(m_at - M_t) + l_bt * torch.exp(m_bt - M_t)
           if collect_true else None)
    if sharded:
        Z, Z_t = psum_pair(Z, Z_t, state_axis)
    y2 = (y * y).sum(dim=1)
    F = M + torch.log(Z) + _free_energy_const(y2, D, H, sigma2, log_odds,
                                              beta, prior_beta)
    if collect_true:
        F_true = M_t + torch.log(Z_t) + _free_energy_const(
            y2, D, H, sigma2, log_odds, 1.0, 1.0)
    else:
        F_true = F

    # sufficient statistics, the algebra of _chunk_estats
    q_single = (torch.exp(logits_single - M[:, None])
                / Z[:, None]).reshape(C, H, K)
    scale_b = (torch.exp(m_b - M) / Z)[:, None]
    wv = w.to(torch.float32)
    s_full = (q_single @ v).scatter_add(1, cand, a_s * scale_b)     # (C, H)
    sum_ss = slot_sum_ss(a_ss * scale_b * wv[:, None], cand, H)
    sum_ss = sum_ss + torch.diag(
        ((q_single @ (v ** 2)) * wv[:, None]).sum(dim=0))
    abs_n = q_single.sum(dim=(1, 2)) + a_abs * scale_b[:, 0]
    vc_n = q_single.sum(dim=1) + a_vc * scale_b
    sums = _weighted_sums(y, y2, wv, s_full, sum_ss, abs_n, vc_n, F, F_true,
                          staged, compute_dtype)
    return F, own_scalars(sums, own) if sharded else sums


def linear_et_estep(y: torch.Tensor, weight: torch.Tensor, W: torch.Tensor,
                    sigma2, log_odds: torch.Tensor, sa: LinearStateArrays,
                    Hp: int, signed_select: bool, beta, prior_beta,
                    chunk: int = 2048, collect_true: bool = True,
                    s_block: int = 0, collect_phi: bool = False,
                    slot_onehot=None, state_axis=None,
                    n_state_shards: int = 1, compute_dtype=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full E-step with chunked accumulation.  Returns (F (N,), sums).
    ``s_block > 0`` takes the big-S path (``_chunk_estats_bigs``, the plain
    ``bigs_multi``).  ``collect_phi`` (with ``slot_onehot``, and without
    ``s_block``) adds the value-set sums ``phi_c`` and ``phi_M``.  With
    ``state_axis`` and ``n_state_shards > 1`` each chunk runs on this state
    rank's slice of the states and the caller adds the sums over the state
    group too.  ``compute_dtype`` (``torch.bfloat16`` or ``torch.float16``;
    None: float32) is the model's: the two D x H products of every chunk
    run on operands rounded to it (``matmul_as``).

    N must be a multiple of ``chunk`` unless N <= chunk (pad with
    ``weight == 0`` rows; ``EM`` does)."""
    N = y.shape[0]
    if collect_phi and (s_block > 0 or slot_onehot is None):
        raise ValueError("collect_phi needs slot_onehot and s_block = 0 "
                         "(the big-S path collects no value-set sums)")
    gram = W.T @ W
    gram_diag = torch.diagonal(gram)

    def body(y_i, w_i):
        if s_block > 0:
            return _chunk_estats_bigs(y_i, w_i, W, gram, gram_diag, sigma2,
                                      log_odds, sa, Hp, signed_select, beta,
                                      prior_beta, s_block, collect_true,
                                      state_axis=state_axis,
                                      n_state_shards=n_state_shards,
                                      compute_dtype=compute_dtype)
        return _chunk_estats(y_i, w_i, W, gram, gram_diag, sigma2, log_odds,
                             sa, Hp, signed_select, beta, prior_beta,
                             collect_true, collect_phi=collect_phi,
                             slot_onehot=slot_onehot, state_axis=state_axis,
                             n_state_shards=n_state_shards,
                             compute_dtype=compute_dtype)

    if N <= chunk:
        return body(y, weight)
    if N % chunk != 0:
        raise ValueError(f"shard size {N} not a multiple of chunk {chunk}; "
                         "pad the shard or pick another chunk")
    Fs, total = [], None
    for i in range(0, N, chunk):
        F_i, sums_i = body(y[i:i + chunk], weight[i:i + chunk])
        Fs.append(F_i)
        total = sums_i if total is None else {
            k: total[k] + sums_i[k] for k in total}
    return torch.cat(Fs), total


def _decode_chunk(y, W, gram, gram_diag, sigma2, log_odds,
                  sa: LinearStateArrays, Hp: int, signed_select: bool,
                  top_L: int, beta, prior_beta):
    C, D = y.shape
    H = W.shape[1]
    K = sa.values.shape[0]
    P, cand, _, _, logits, _, _, _ = _union_logits(
        y, W, gram, gram_diag, sigma2, log_odds, sa, Hp, signed_select,
        beta, prior_beta)
    m = logits.max(dim=1, keepdim=True).values
    p = torch.exp(logits - m)
    Z = p.sum(dim=1, keepdim=True)
    q = p / Z
    F = (m + torch.log(Z))[:, 0] + _free_energy_const(
        (y * y).sum(dim=1), D, H, sigma2, log_odds, beta, prior_beta)
    q_single = q[:, 1:1 + H * K].reshape(C, H, K)
    s_cand = q[:, 1 + H * K:] @ sa.states
    s_mean = (q_single @ sa.values).scatter_add(1, cand, s_cand)
    top_q, top_u = top_l_argmax(q, top_L)
    return F, s_mean, top_q, top_u.to(torch.int32), cand.to(torch.int32)


def linear_et_decode(y: torch.Tensor, W: torch.Tensor, sigma2,
                     log_odds: torch.Tensor, sa: LinearStateArrays, Hp: int,
                     signed_select: bool, top_L: int, beta, prior_beta,
                     chunk: int = 4096):
    """Per-datapoint posterior decode in canonical union indices (0 = zero
    state, 1 + h*K + k = singleton, 1 + H*K + s = multi state).

    Returns (F (N,), s_mean (N, H), top_q (N, L), top_u (N, L) int32,
    cand (N, Hp) int32) — the plain version of the decode kernel."""
    H = W.shape[1]
    S, K = sa.value_counts.shape
    if top_L > 1 + H * K + S:
        raise ValueError(f"top_L={top_L} exceeds the {1 + H * K + S} "
                         "posterior columns")
    gram = W.T @ W
    gram_diag = torch.diagonal(gram)
    parts = [_decode_chunk(y[i:i + chunk], W, gram, gram_diag, sigma2,
                           log_odds, sa, Hp, signed_select, top_L, beta,
                           prior_beta)
             for i in range(0, y.shape[0], chunk)]
    return tuple(torch.cat(t, dim=0) for t in zip(*parts))


def top_states_from_topk(top_q: torch.Tensor, top_u: torch.Tensor, H: int,
                         K: int, values: torch.Tensor,
                         multi_states: torch.Tensor, cand: torch.Tensor,
                         dense: bool) -> Dict[str, torch.Tensor]:
    """Decode canonical top-L (prob, index) pairs into the inference fields.

    ``dense=True``: ``top_states (N, L, H)``.  ``dense=False``: the compact
    ``top_single_unit`` (unit of a singleton, -1 else), ``top_single_value``
    and ``top_cand_states (N, L, Hp)`` (multi-state values over the
    candidates); ``densify_top_states`` rebuilds the dense tensor."""
    N, L = top_q.shape
    S, Hp = multi_states.shape
    u = top_u.long() - 1                                 # -1 -> zero state
    is_single = (u >= 0) & (u < H * K)
    sh = torch.where(is_single, u // K, torch.zeros_like(u))
    sv = torch.where(is_single, values[torch.clamp(u % K, 0, K - 1)],
                     torch.zeros((), dtype=values.dtype, device=values.device))
    is_multi = u >= H * K
    s_idx = torch.clamp(u - H * K, 0, S - 1)
    mcv = multi_states[s_idx] * is_multi[..., None]      # (N, L, Hp)
    if dense:
        out = torch.zeros((N, L, H), dtype=torch.float32, device=top_q.device)
        out.scatter_(2, sh[..., None], sv[..., None])
        out.scatter_add_(2, cand.long()[:, None, :].expand(N, L, Hp), mcv)
        return {"top_probs": top_q, "top_states": out}
    return {"top_probs": top_q,
            "top_single_unit": torch.where(is_single, sh, -1).to(torch.int32),
            "top_single_value": sv,
            "top_cand_states": mcv}


def densify_top_states(out: Dict[str, torch.Tensor], H: int) -> torch.Tensor:
    """Dense ``top_states (N, L, H)`` from a compact decode, bit-identical
    to the dense path."""
    unit = out["top_single_unit"].long()
    N, L = unit.shape
    Hp = out["cand"].shape[1]
    dense = torch.zeros((N, L, H), dtype=torch.float32, device=unit.device)
    dense.scatter_(2, torch.clamp(unit, min=0)[..., None],
                   out["top_single_value"][..., None])
    dense.scatter_add_(2, out["cand"].long()[:, None, :].expand(N, L, Hp),
                       out["top_cand_states"])
    return dense


#: rows of each product of ``recon_rows`` on a CUDA tensor
RECON_BLOCK = 4096


def recon_rows(s_mean: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``s_mean @ W.T``.  On a CUDA tensor in blocks of ``RECON_BLOCK`` rows,
    the last one padded with zero rows: the GEMM library picks its kernel by
    the product's shape, and a fixed shape gives each row the same bits in
    any batch, so decodes of the rows of several ranks, concatenated, equal
    one decode of them all."""
    N = s_mean.shape[0]
    if s_mean.device.type != "cuda" or N == 0:
        return s_mean @ W.T
    pad = -N % RECON_BLOCK
    s = torch.nn.functional.pad(s_mean, (0, 0, 0, pad)) if pad else s_mean
    return torch.cat([s[i:i + RECON_BLOCK] @ W.T
                      for i in range(0, N + pad, RECON_BLOCK)])[:N]


def posterior_outputs(W, F, s_mean, top_q, top_u, cand,
                      sa: LinearStateArrays, dense_states: bool):
    """The inference dict from a top-L decode: top states (dense or
    compact, plus ``cand``), ``s_mean``, ``recon = s_mean @ W.T``
    (``recon_rows``) and F."""
    with traced_region("top_states"):
        out = top_states_from_topk(top_q, top_u, W.shape[1],
                                   sa.values.shape[0], sa.values, sa.states,
                                   cand, dense_states)
    if not dense_states:
        out["cand"] = cand
    with traced_region("recon_rows"):
        recon = recon_rows(s_mean, W)
    out.update({"s_mean": s_mean, "recon": recon, "F": F})
    return out


def linear_et_posterior(y: torch.Tensor, W: torch.Tensor, sigma2,
                        log_odds: torch.Tensor, sa: LinearStateArrays,
                        Hp: int, signed_select: bool, top_L: int = 10,
                        beta=1.0, prior_beta=1.0, chunk: int = 4096,
                        dense_states: bool = True,
                        decode=linear_et_decode) -> Dict[str, torch.Tensor]:
    """Chunked posterior decode for held-out data: per datapoint the top-L
    truncated states by posterior probability, their probabilities, the
    posterior mean, the reconstruction and F.  ``decode`` takes
    ``linear_et_decode``'s arguments and gives its outputs: the plain
    version (the default), or a route that may run the decode kernel."""
    with traced_region("decode"):
        F, s_mean, top_q, top_u, cand = decode(
            y, W, sigma2, log_odds, sa, Hp, signed_select, top_L, beta,
            prior_beta, chunk)
    return posterior_outputs(W, F, s_mean, top_q, top_u, cand, sa,
                             dense_states)


@functools.lru_cache(maxsize=None)
def _log_binomials(H: int, gamma: int, device):
    """(ks, log C(H, k)) for k = 0..gamma as float32 tensors on ``device``,
    made once: a step then copies nothing from the host for them."""
    ks = torch.arange(gamma + 1, dtype=torch.float32, device=device)
    log_comb = torch.tensor(
        [math.lgamma(H + 1) - math.lgamma(k + 1) - math.lgamma(H - k + 1)
         for k in range(gamma + 1)], dtype=torch.float32, device=device)
    return ks, log_comb


def truncated_prior_logmass(log_pi_active: torch.Tensor, H: int, gamma: int):
    """log A_gamma and log B_gamma for the ET corrections, in log space:

    A = sum_{k<=gamma} C(H,k) pi^k (1-pi)^(H-k),  B = the same with a factor
    k (so B/A = E_trunc|s|), with pi the probability that a unit is active.
    """
    ks, log_comb = _log_binomials(H, gamma, log_pi_active.device)
    log_1m = torch.log(-torch.expm1(torch.clamp(log_pi_active, max=-1e-8)))
    terms = log_comb + ks * log_pi_active + (H - ks) * log_1m
    logA = torch.logsumexp(terms, dim=0)
    termsB = torch.where(ks >= 1, terms + torch.log(torch.clamp(ks, min=1.0)),
                         torch.full_like(terms, float("-inf")))
    logB = torch.logsumexp(termsB, dim=0)
    return logA, logB
