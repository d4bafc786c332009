"""The ET E-step for max-superposition models (MCA, MMCA), in plain PyTorch.

Counterpart of ``prosper_tpu/core/maxstep.py``:

  MCA :  ybar_d = max_{h active} W_dh
  MMCA:  ybar_d = W_dh*,  h* = argmax_{h active} |W_dh|

with isotropic Gaussian noise and a Bernoulli(pi) prior.  The M-step
statistics give each observed dimension to its winning cause: the hard
winner (rho <= 0), or the annealed softened max
A propto exp(rho (K_h - K_max) / |K_max|) when rho > 0.

Unlike the linear family, max admits no Gram shortcut, so the winner
lattice ybar (chunk, S, D) is built per chunk by the subset-lattice DP:
each multi state is its parent (one slot fewer) plus one added slot, which
wins a dimension only when its key is strictly greater (ties keep the
earlier slot).  The zero state and the H singletons are closed form.
Gathers and scatters use indices (``index_add_``).  These functions are
the plain version that the CUDA kernel in ``ops/max_cuda.py`` is held to,
the path that runs on the CPU, and the softened-max path on any device.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from prosper_tpu_torch.core.etstep import (LinearStateArrays,
                                           _free_energy_const,
                                           top_states_from_topk)
from prosper_tpu_torch.core.select import top_hprime_candidates, top_l_argmax


def _subset_dp_plan(states_np):
    """Static DP plan over the subset lattice of the enumerated states.

    States are binary supports over the Hp candidate slots, enumerated by
    size (``core/states.py::binary_state_space``).  Each size-m state
    extends a unique size-(m-1) parent (drop its largest active slot).
    Returns [(parent_pos, add_slot)] per level m >= 2, where parent_pos
    indexes the previous level (level 1 = the Hp slots themselves); raises
    unless concatenating the levels reproduces the state order.
    """
    act = states_np > 0.5
    sizes = act.sum(axis=1).astype(int)
    order = []
    levels = []
    pos_of = {}                 # active-tuple -> position within its level
    for m in range(2, sizes.max() + 1):
        rows = np.flatnonzero(sizes == m)
        parent_pos, add_slot = [], []
        for j, r in enumerate(rows):
            sup = tuple(np.flatnonzero(act[r]))
            pos_of[sup] = j
            parent = sup[:-1]
            parent_pos.append(parent[0] if m == 2 else pos_of[parent])
            add_slot.append(sup[-1])
        levels.append((np.asarray(parent_pos, np.int32),
                       np.asarray(add_slot, np.int32)))
        order.extend(rows.tolist())
    if order != list(range(states_np.shape[0])):
        raise ValueError("state enumeration is not size-ordered; the DP "
                         "plan needs the binary_state_space ordering")
    return levels


class DPPlan(NamedTuple):
    """The DP plan of one state table, on its device."""
    levels: List[Tuple[torch.Tensor, torch.Tensor]]   # (parent_pos, add)
    flat: torch.Tensor   # (2S,) int32: parents | added slots, as the kernel
                         # reads them (parent < Hp: a slot; else Hp + state)


#: id(states) -> (weak reference to states, its plan)
_PLANS: Dict[int, Tuple[weakref.ref, DPPlan]] = {}


def dp_plan(states: torch.Tensor) -> DPPlan:
    """The DP plan of ``states`` (S, Hp), built once per table."""
    ref, plan = _PLANS.get(id(states), (None, None))
    if ref is None or ref() is not states:
        plan = None
    if plan is None:
        Hp = states.shape[1]
        levels = _subset_dp_plan(states.detach().cpu().numpy())
        par, add, off = [], [], 0
        for m, (pp, aa) in enumerate(levels):
            par.extend(pp if m == 0 else Hp + off + pp)
            add.extend(aa)
            if m > 0:
                off += len(levels[m - 1][0])
        dev = states.device
        plan = DPPlan(
            levels=[(torch.as_tensor(pp, dtype=torch.long, device=dev),
                     torch.as_tensor(aa, dtype=torch.long, device=dev))
                    for pp, aa in levels],
            flat=torch.as_tensor(np.asarray(par + add, np.int32),
                                 device=dev))
        key = id(states)
        _PLANS[key] = (weakref.ref(states,
                                   lambda _r, k=key: _PLANS.pop(k, None)),
                       plan)
    return plan


def _dp_winner_tile(Wc, plan: DPPlan, magnitude: bool, collect=("ybar",)):
    """Winner tile over all multi states by the subset-lattice DP.

    Wc (C, Hp, D): the candidates' dictionary columns.  Returns (out,
    masks): ``out`` maps each name in ``collect`` ("ybar" / "key") to its
    (C, S, D) tile; ``masks`` holds each level's 'added slot wins' mask."""
    key1 = Wc.abs() if magnitude else Wc
    ybar_prev, key_prev = Wc, key1
    outs = {name: [] for name in collect}
    masks = []
    for pp, aa in plan.levels:
        pv, kv = ybar_prev[:, pp], key_prev[:, pp]
        va, ka = Wc[:, aa], key1[:, aa]
        better = ka > kv
        ybar_prev = torch.where(better, va, pv)
        key_prev = torch.where(better, ka, kv)
        if "ybar" in outs:
            outs["ybar"].append(ybar_prev)
        if "key" in outs:
            outs["key"].append(key_prev)
        masks.append(better)
    return {k: torch.cat(v, dim=1) for k, v in outs.items()}, masks


def _dp_hard_resp(qa, plan: DPPlan, masks, Hp: int):
    """Hard-winner responsibilities A[n, h, d] = sum_s qa[n, s] [winner of
    (s, d) is slot h] by a reverse flow over the lattice: each state's mass
    goes to its added slot where that slot won and flows to its parent
    otherwise."""
    C, _, D = masks[0].shape
    A = torch.zeros((C, Hp, D), dtype=qa.dtype, device=qa.device)
    off = [0]
    for pp, _ in plan.levels:
        off.append(off[-1] + len(pp))
    inflow = None
    for lev in range(len(plan.levels) - 1, -1, -1):
        pp, aa = plan.levels[lev]
        w = qa[:, off[lev]:off[lev + 1], None].expand(masks[lev].shape)
        if inflow is not None:
            w = w + inflow
        win = w * masks[lev]
        A.index_add_(1, aa, win)
        down = w - win
        if lev > 0:
            inflow = torch.zeros((C, len(plan.levels[lev - 1][0]), D),
                                 dtype=qa.dtype, device=qa.device)
            inflow.index_add_(1, pp, down)
        else:
            A.index_add_(1, pp, down)        # level-2 parents are slots
    return A


def _soft_resp(qa, Wc, states, plan: DPPlan, magnitude: bool, rho):
    """Softened-max responsibilities A[n, h, d] = sum_s qa[n, s] *
    exp(rho (K_h - K_max) / |K_max|) / Z over the active slots."""
    Hp = Wc.shape[1]
    kv_full = _dp_winner_tile(Wc, plan, magnitude, ("key",))[0]["key"]
    kv_scale = torch.clamp(kv_full.abs(), min=1e-6)

    def powers(h):
        kh = Wc[:, h:h + 1, :]
        if magnitude:
            kh = kh.abs()
        gap = torch.clamp(kh - kv_full, max=0.0) / kv_scale
        return states[None, :, h, None] * torch.exp(rho * gap)  # (C, S, D)

    denom = torch.full_like(kv_full, 1e-20)
    for h in range(Hp):
        denom = denom + powers(h)
    return torch.stack([torch.einsum("ns,nsd->nd", qa, powers(h) / denom)
                        for h in range(Hp)], dim=1)


def _union_terms(y, W, gram_diag, sigma2, log_odds, sa: LinearStateArrays,
                 Hp: int, magnitude: bool, beta, prior_beta, plan: DPPlan,
                 P=None):
    """Candidates, winner tile and the annealed union logits
    [zero | H singletons | S multi] of one chunk (from P = y @ W, if
    given)."""
    C = y.shape[0]
    inv2s2 = 0.5 / sigma2
    if P is None:
        P = y @ W                                                    # (C, H)
    w_norm = torch.sqrt(torch.clamp(gram_diag, min=1e-30))
    cand = top_hprime_candidates(P, w_norm, Hp, magnitude)          # (C, Hp)
    Wc = W.T[cand]                                                   # (C,Hp,D)
    tile, masks = _dp_winner_tile(Wc, plan, magnitude)
    ybar = tile["ybar"]                                              # (C,S,D)
    y_dot = torch.einsum("nd,nsd->ns", y, ybar)
    ybar2 = (ybar * ybar).sum(dim=2)
    lik_multi = (2.0 * y_dot - ybar2) * inv2s2
    prior_multi = sa.abs_states * log_odds
    lik_single = (2.0 * P - gram_diag[None, :]) * inv2s2
    logits = torch.cat(
        [torch.zeros((C, 1), dtype=P.dtype, device=P.device),
         beta * lik_single + prior_beta * log_odds,
         beta * lik_multi + prior_beta * prior_multi[None, :]], dim=1)
    return dict(P=P, cand=cand, Wc=Wc, ybar=ybar, masks=masks, y_dot=y_dot,
                ybar2=ybar2, lik_multi=lik_multi, prior_multi=prior_multi,
                lik_single=lik_single, logits=logits)


def _chunk_max_estats(y, w, W, gram_diag, sigma2, log_odds,
                      sa: LinearStateArrays, Hp: int, magnitude: bool,
                      beta, prior_beta, plan: DPPlan, rho=None,
                      collect_true: bool = True, P=None):
    """E-statistics for one chunk: y (C, D), w (C,) weights.
    Returns (F (C,), sums).  ``rho`` (a host number or a 0-d tensor) is the
    softened max's exponent; None takes the hard winner.  Given
    ``P = y @ W`` it is the middle stage alone (``max_et_estep_rows``): the
    sums then hold ``qsw = w q_single`` (C, H), and numer lacks its
    singleton part ``qsw.T @ y``."""
    C, D = y.shape
    H = W.shape[1]
    staged = P is not None
    u = _union_terms(y, W, gram_diag, sigma2, log_odds, sa, Hp, magnitude,
                     beta, prior_beta, plan, P)
    logits = u["logits"]
    m = logits.max(dim=1, keepdim=True).values
    p = torch.exp(logits - m)
    Z = p.sum(dim=1, keepdim=True)
    q = p / Z
    y2 = (y * y).sum(dim=1)
    F = (m + torch.log(Z))[:, 0] + _free_energy_const(
        y2, D, H, sigma2, log_odds, beta, prior_beta)
    if collect_true:
        logits_t = torch.cat(
            [torch.zeros((C, 1), dtype=y.dtype, device=y.device),
             u["lik_single"] + log_odds,
             u["lik_multi"] + u["prior_multi"][None, :]], dim=1)
        F_true = torch.logsumexp(logits_t, dim=1) + _free_energy_const(
            y2, D, H, sigma2, log_odds, 1.0, 1.0)
    else:
        F_true = F

    q_zero, q_single, q_multi = q[:, 0], q[:, 1:1 + H], q[:, 1 + H:]
    wv = w.to(torch.float32)
    cand = u["cand"]
    s_full = q_single.scatter_add(1, cand, q_multi @ sa.states)
    abs_n = q_single.sum(dim=1) + q_multi @ sa.abs_states

    qa = q_multi * wv[:, None]                                       # (C, S)
    if rho is not None:
        accA = _soft_resp(qa, u["Wc"], sa.states, plan, magnitude, rho)
    else:
        accA = _dp_hard_resp(qa, plan, u["masks"], Hp)               # (C,Hp,D)
    idx = cand.reshape(-1)
    denom = torch.zeros((H, D), dtype=y.dtype, device=y.device)
    denom.index_add_(0, idx, accA.reshape(C * Hp, D))
    numer = torch.zeros((H, D), dtype=y.dtype, device=y.device)
    numer.index_add_(0, idx, (accA * y[:, None, :]).reshape(C * Hp, D))
    qsw = q_single * wv[:, None]
    denom = denom + qsw.sum(dim=0)[:, None]
    if not staged:
        numer = numer + qsw.T @ y

    resid_multi = (q_multi * (y2[:, None] - 2 * u["y_dot"]
                              + u["ybar2"])).sum(dim=1)
    resid_single = (q_single * (y2[:, None] - 2.0 * u["P"]
                                + gram_diag[None, :])).sum(dim=1)
    resid = q_zero * y2 + resid_single + resid_multi
    sums = dict(numer=numer, denom=denom, s=(s_full * wv[:, None]).sum(dim=0),
                abs=(abs_n * wv).sum(), resid=(resid * wv).sum(),
                y2=(y2 * wv).sum(), n=wv.sum(), F=(F * wv).sum(),
                F_true=(F_true * wv).sum())
    if staged:
        sums["qsw"] = qsw
    return F, sums


def max_et_estep_rows(y, weight, P, W, sigma2, log_odds,
                      sa: LinearStateArrays, Hp: int, magnitude: bool, beta,
                      prior_beta, collect_true: bool = True):
    """The per-datapoint stage of the hard-winner E-step alone, plain
    version of the kernel in ``csrc/max_et_estep.cu``: from ``P = y @ W`` it
    returns (F (N,), qsw = w q_single (N, H), sums whose numer lacks
    ``qsw.T @ y``).  The E-step is ``P = y @ W``, this, then
    ``numer += qsw.T @ y``."""
    F, sums = _chunk_max_estats(y, weight, W, (W * W).sum(dim=0), sigma2,
                                log_odds, sa, Hp, magnitude, beta, prior_beta,
                                dp_plan(sa.states), None, collect_true, P=P)
    return F, sums.pop("qsw"), sums


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to prosper_tpu_torch yet "
        "(ROADMAP.md, open item: distributed)")


def max_et_estep(y: torch.Tensor, weight: torch.Tensor, W: torch.Tensor,
                 sigma2, log_odds, sa: LinearStateArrays, Hp: int,
                 magnitude: bool, beta, prior_beta, chunk: int = 2048,
                 rho=None, collect_true: bool = True,
                 dp_winner: bool = True, state_axis=None,
                 n_state_shards: int = 1
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Max-superposition E-step, chunked by ``chunk`` (it bounds the
    (chunk, S, D) winner tile).  Returns (F (N,), sums).  N must be a
    multiple of ``chunk`` unless N <= chunk (``EM`` pads).  ``rho`` is the
    softened max's exponent, on the host or the device; None (the
    schedule's rho <= 0) takes the hard winner."""
    if state_axis is not None or n_state_shards != 1 or not dp_winner:
        raise _not_ported("state sharding of the max family (state_axis, "
                          "n_state_shards, dp_winner=False)")
    N = y.shape[0]
    gram_diag = (W * W).sum(dim=0)
    plan = dp_plan(sa.states)

    def body(y_i, w_i):
        return _chunk_max_estats(y_i, w_i, W, gram_diag, sigma2, log_odds,
                                 sa, Hp, magnitude, beta, prior_beta, plan,
                                 rho, collect_true)

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


def _posterior_chunk(y, W, gram_diag, sigma2, log_odds, sa, Hp, magnitude,
                     top_L, beta, prior_beta, plan, dense_states):
    D = y.shape[1]
    H = W.shape[1]
    u = _union_terms(y, W, gram_diag, sigma2, log_odds, sa, Hp, magnitude,
                     beta, prior_beta, plan)
    logits = u["logits"]
    m = logits.max(dim=1, keepdim=True).values
    p = torch.exp(logits - m)
    Z = p.sum(dim=1, keepdim=True)
    q = p / Z
    F = (m + torch.log(Z))[:, 0] + _free_energy_const(
        (y * y).sum(dim=1), D, H, sigma2, log_odds, beta, prior_beta)
    q_single, q_multi = q[:, 1:1 + H], q[:, 1 + H:]
    cand = u["cand"]
    s_mean = q_single.scatter_add(1, cand, q_multi @ sa.states)
    recon = q_single @ W.T + torch.einsum("ns,nsd->nd", q_multi, u["ybar"])
    top_q, top_u = top_l_argmax(q, top_L)
    out = top_states_from_topk(top_q, top_u, H, 1, sa.values, sa.states,
                               cand, dense_states)
    if not dense_states:
        out["cand"] = cand.to(torch.int32)
    out.update({"s_mean": s_mean, "recon": recon, "F": F})
    return out


def max_et_posterior(y: torch.Tensor, W: torch.Tensor, sigma2, log_odds,
                     sa: LinearStateArrays, Hp: int, magnitude: bool,
                     top_L: int = 10, beta=1.0, prior_beta=1.0,
                     chunk: int = 2048,
                     dense_states: bool = True) -> Dict[str, torch.Tensor]:
    """Posterior decode for max models, chunked by ``chunk`` rows: per
    datapoint the top-L truncated states (canonical union index 0 = zero
    state, 1 + h = singleton, 1 + H + s = multi state), their
    probabilities, ``s_mean``, the posterior-mean reconstruction ``recon``
    and F; ``top_states (N, L, H)`` when ``dense_states``, else the compact
    fields and ``cand``."""
    H = W.shape[1]
    S = sa.states.shape[0]
    if top_L > 1 + H + S:
        raise ValueError(f"top_L={top_L} exceeds the {1 + H + S} posterior "
                         "columns")
    gram_diag = (W * W).sum(dim=0)
    plan = dp_plan(sa.states)
    parts = [_posterior_chunk(y[i:i + chunk], W, gram_diag, sigma2, log_odds,
                              sa, Hp, magnitude, top_L, beta, prior_beta,
                              plan, dense_states)
             for i in range(0, y.shape[0], chunk)]
    return {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}
