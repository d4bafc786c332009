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
``scatter_add_``, ``index_add_``).  These functions are the plain versions
that the CUDA kernels in ``ops/linear_cuda.py`` are held to, and the path
that runs on the CPU.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from prosper_tpu_torch.core.select import top_hprime_candidates, top_l_argmax

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


def _union_logits(y, W, gram, gram_diag, sigma2, log_odds,
                  sa: LinearStateArrays, Hp: int, signed_select: bool,
                  beta, prior_beta):
    """Shared front end: candidates and the annealed union logits
    ``[zero | H*K singletons | S multi]`` plus the un-annealed pieces.

    Returns (P, cand, proj, Gf, logits (C, 1+H*K+S), lik_single (C,H,K),
    lik_multi (C,S), prior_multi (S,))."""
    C = y.shape[0]
    H = W.shape[1]
    K = sa.values.shape[0]
    inv2s2 = 0.5 / sigma2
    P = y @ W                                                        # (C, H)
    w_norm = torch.sqrt(torch.clamp(gram_diag, min=1e-30))
    cand = top_hprime_candidates(P, w_norm, Hp, signed_select)      # (C, Hp)
    proj = torch.gather(P, 1, cand)                                  # (C, Hp)
    Gf = gram[cand[:, :, None], cand[:, None, :]].reshape(C, Hp * Hp)

    lik_multi = (2.0 * (proj @ sa.states.T) - Gf @ sa.outer.T) * inv2s2
    prior_multi = sa.value_counts @ log_odds                         # (S,)
    logits_multi = beta * lik_multi + prior_beta * prior_multi[None, :]
    v = sa.values
    lik_single = (2.0 * P[:, :, None] * v[None, None, :]
                  - gram_diag[None, :, None] * (v ** 2)[None, None, :]) * inv2s2
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


def _chunk_estats(y, w, W, gram, gram_diag, sigma2, log_odds,
                  sa: LinearStateArrays, Hp: int, signed_select: bool,
                  beta, prior_beta, collect_true: bool = True):
    """E-statistics for one chunk: y (C, D), w (C,) accumulation weights.
    Returns (F (C,), sums).  F is the per-datapoint truncated
    log-pseudo-likelihood with every constant term."""
    C, D = y.shape
    H = W.shape[1]
    K = sa.values.shape[0]
    (P, cand, proj, Gf, logits, lik_single, lik_multi,
     prior_multi) = _union_logits(y, W, gram, gram_diag, sigma2, log_odds,
                                  sa, Hp, signed_select, beta, prior_beta)
    m = logits.max(dim=1, keepdim=True).values
    p = torch.exp(logits - m)
    Z = p.sum(dim=1, keepdim=True)
    q = p / Z
    logZ = (m + torch.log(Z))[:, 0]

    y2 = (y * y).sum(dim=1)
    F = logZ + _free_energy_const(y2, D, H, sigma2, log_odds, beta,
                                  prior_beta)
    if collect_true:
        # the un-annealed channel (beta = prior_beta = 1); skipped when the
        # caller knows the schedule is saturated, where it equals F
        logits_t = torch.cat(
            [torch.zeros((C, 1), dtype=y.dtype, device=y.device),
             (lik_single + log_odds[None, None, :]).reshape(C, H * K),
             lik_multi + prior_multi[None, :]], dim=1)
        F_true = (torch.logsumexp(logits_t, dim=1)
                  + _free_energy_const(y2, D, H, sigma2, log_odds, 1.0, 1.0))
    else:
        F_true = F

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
    sw = s_full * wv[:, None]
    sum_ss = sum_ss + torch.diag((ss_diag_single * wv[:, None]).sum(dim=0))

    abs_n = q_single.sum(dim=(1, 2)) + q_multi @ sa.abs_states
    vc_n = q_single.sum(dim=1) + q_multi @ sa.value_counts           # (C, K)
    sums = dict(
        xs=y.T @ sw, ss=sum_ss, s=sw.sum(dim=0),
        abs=(abs_n * wv).sum(), vc=(vc_n * wv[:, None]).sum(dim=0),
        y2=(y2 * wv).sum(), n=wv.sum(), F=(F * wv).sum(),
        F_true=(F_true * wv).sum())
    return F, sums


def linear_et_estep(y: torch.Tensor, weight: torch.Tensor, W: torch.Tensor,
                    sigma2, log_odds: torch.Tensor, sa: LinearStateArrays,
                    Hp: int, signed_select: bool, beta, prior_beta,
                    chunk: int = 2048, collect_true: bool = True
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full E-step with chunked accumulation.  Returns (F (N,), sums).

    N must be a multiple of ``chunk`` unless N <= chunk (pad with
    ``weight == 0`` rows; ``EM`` does)."""
    N = y.shape[0]
    gram = W.T @ W
    gram_diag = torch.diagonal(gram)

    def body(y_i, w_i):
        return _chunk_estats(y_i, w_i, W, gram, gram_diag, sigma2, log_odds,
                             sa, Hp, signed_select, beta, prior_beta,
                             collect_true)

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


def posterior_outputs(W, F, s_mean, top_q, top_u, cand,
                      sa: LinearStateArrays, dense_states: bool):
    """The inference dict from a top-L decode: top states (dense or
    compact, plus ``cand``), ``s_mean``, ``recon = s_mean @ W.T`` and F."""
    out = top_states_from_topk(top_q, top_u, W.shape[1],
                               sa.values.shape[0], sa.values, sa.states,
                               cand, dense_states)
    if not dense_states:
        out["cand"] = cand
    out.update({"s_mean": s_mean, "recon": s_mean @ W.T, "F": F})
    return out


def linear_et_posterior(y: torch.Tensor, W: torch.Tensor, sigma2,
                        log_odds: torch.Tensor, sa: LinearStateArrays,
                        Hp: int, signed_select: bool, top_L: int = 10,
                        beta=1.0, prior_beta=1.0, chunk: int = 4096,
                        dense_states: bool = True) -> Dict[str, torch.Tensor]:
    """Chunked posterior decode for held-out data (plain version): per
    datapoint the top-L truncated states by posterior probability, their
    probabilities, the posterior mean, the reconstruction and F."""
    F, s_mean, top_q, top_u, cand = linear_et_decode(
        y, W, sigma2, log_odds, sa, Hp, signed_select, top_L, beta,
        prior_beta, chunk)
    return posterior_outputs(W, F, s_mean, top_q, top_u, cand, sa,
                             dense_states)


def linear_et_posterior_kernel(y: torch.Tensor, W: torch.Tensor, sigma2,
                               log_odds: torch.Tensor, sa: LinearStateArrays,
                               Hp: int, signed_select: bool, top_L: int = 10,
                               beta=1.0, prior_beta=1.0,
                               dense_states: bool = True
                               ) -> Dict[str, torch.Tensor]:
    """Posterior decode through the fused decode kernel on a CUDA tensor
    (``ops/linear_cuda.py``; its plain version on a CPU tensor).  Same
    output contract as ``linear_et_posterior``."""
    from prosper_tpu_torch.ops.linear_cuda import linear_et_decode as fused
    F, s_mean, top_q, top_u, cand = fused(
        y, W, sigma2, log_odds, sa, Hp, signed_select, top_L, beta,
        prior_beta)
    return posterior_outputs(W, F, s_mean, top_q, top_u, cand, sa,
                             dense_states)


def truncated_prior_logmass(log_pi_active: torch.Tensor, H: int, gamma: int):
    """log A_gamma and log B_gamma for the ET corrections, in log space:

    A = sum_{k<=gamma} C(H,k) pi^k (1-pi)^(H-k),  B = the same with a factor
    k (so B/A = E_trunc|s|), with pi the probability that a unit is active.
    """
    dev = log_pi_active.device
    ks = torch.arange(gamma + 1, dtype=torch.float32, device=dev)
    log_comb = torch.tensor(
        [math.lgamma(H + 1) - math.lgamma(k + 1) - math.lgamma(H - k + 1)
         for k in range(gamma + 1)], dtype=torch.float32, device=dev)
    log_1m = torch.log(-torch.expm1(torch.clamp(log_pi_active, max=-1e-8)))
    terms = log_comb + ks * log_pi_active + (H - ks) * log_1m
    logA = torch.logsumexp(terms, dim=0)
    termsB = torch.where(ks >= 1, terms + torch.log(torch.clamp(ks, min=1.0)),
                         torch.full_like(terms, float("-inf")))
    logB = torch.logsumexp(termsB, dim=0)
    return logA, logB
