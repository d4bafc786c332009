"""The ET E-step for spike-and-slab / Gaussian sparse coding (GSC), in
plain PyTorch: the version the CPU, a state axis and models past the
kernel's limits run, and the one ``ops/gsc_cuda.py``'s kernel is held to.

Counterpart of ``prosper_tpu/core/gscstep.py``.  Latents s_h = b_h z_h with
b ~ Bernoulli(pi) and z ~ N(mu, psi); the binary supports are enumerated
(ET truncation) and the slab is integrated out in closed form per support:

  log p(y|s) = -D/2 log(2 pi sigma^2) - ||y||^2/(2 sigma^2) - k/2 log psi
               - 1/2 log det M_s - k mu^2/(2 psi) + 1/2 b_s^T M_s^-1 b_s

  M_s = I/psi + W_s^T W_s / sigma^2          (k x k posterior precision)
  b_s = W_s^T y / sigma^2 + (mu/psi) 1       (natural parameter)
  q(z|y,s) = N(kappa_s = M_s^-1 b_s,  Sigma_s = M_s^-1)

Two forms of the small solvers:

* the entry-wise form (``chol_bl``, ``logdet_bl``, ``solve_bl``,
  ``inverse_bl``): each matrix entry is one tensor over (rows, states), and
  the supports of one size m solve an m x m system (``_gsc_level_plan``).
  The E-step runs this form.
* the padded tensor form (``chol_small`` and the rest): every support as an
  (Hp, Hp) matrix with identity rows and columns on its inactive slots,
  which leaves the determinant, kappa on the support and the inverse on the
  support as they are.  The decode runs this form.

Gram entries and natural parameters are index gathers from the candidates'
``proj`` and ``Gf`` (``core/etstep.py::_candidates``); no (N, S, D) tensor
exists.  The sums over the states into the Hp candidate frame are products
with constant 0/1 tables, the scatter of <sz> to H is a ``scatter_add``
over each row's distinct candidates and <sz sz^T> goes through the
atomic-free ``slot_sum_ss``: no sufficient statistic is accumulated by
atomic float adds, so a step gives the same bits in every run on a device.

The sufficient statistics share the linear family's schema (xs, ss, s, abs,
y2, n, F, F_true); the slab M-step reads sum(s) and trace(ss) as
sum_h <s_h z_h> and sum_h <s_h z_h^2>.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from prosper_tpu_torch.core.etstep import (LinearStateArrays, _candidates,
                                           mask_union, own_scalars,
                                           slot_sum_ss, top_states_from_topk,
                                           union_softmax)
from prosper_tpu_torch.core.select import top_l_argmax
from prosper_tpu_torch.io.tracing import traced_region
from prosper_tpu_torch.ops.cuda_lib import cached_for
from prosper_tpu_torch.parallel.mesh import state_rank, state_sharded


# ---- the padded tensor form: (..., n, n) matrices ---------------------------

def chol_small(M: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky factor of SPD matrices M (..., n, n),
    unrolled over the small matrix size; the pivot is clamped at 1e-30."""
    n = M.shape[-1]
    below = torch.arange(n, device=M.device)
    cols: List[torch.Tensor] = []
    for j in range(n):
        col = M[..., :, j]
        if j > 0:
            L = torch.stack(cols, dim=-1)                        # (..., n, j)
            col = col - torch.einsum("...ik,...k->...i", L, L[..., j, :])
        d = torch.sqrt(torch.clamp(col[..., j], min=1e-30))
        col = col / d[..., None]
        cols.append(torch.where(below >= j, col, torch.zeros_like(col)))
    return torch.stack(cols, dim=-1)


def cho_logdet_small(L: torch.Tensor) -> torch.Tensor:
    """log det(M) from its Cholesky factor."""
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(dim=-1)


def cho_solve_vec_small(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b with M = L L^T; b (..., n)."""
    n = L.shape[-1]
    y: List[torch.Tensor] = []
    for i in range(n):
        s = b[..., i]
        if i > 0:
            s = s - torch.einsum("...k,...k->...", L[..., i, :i],
                                 torch.stack(y, dim=-1))
        y.append(s / L[..., i, i])
    x: List[torch.Tensor] = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        if i < n - 1:
            s = s - torch.einsum("...k,...k->...", L[..., i + 1:, i],
                                 torch.stack(x[i + 1:], dim=-1))
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def cho_inverse_small(L: torch.Tensor) -> torch.Tensor:
    """The full inverse of M = L L^T, by triangular solves against I."""
    n = L.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device).expand(L.shape)
    Y: List[torch.Tensor] = []                           # rows of L^-1
    for i in range(n):
        s = eye[..., i, :]
        if i > 0:
            s = s - torch.einsum("...k,...km->...m", L[..., i, :i],
                                 torch.stack(Y, dim=-2))
        Y.append(s / L[..., i, i][..., None])
    X: List[torch.Tensor] = [None] * n
    for i in range(n - 1, -1, -1):
        s = Y[i]
        if i < n - 1:
            s = s - torch.einsum("...k,...km->...m", L[..., i + 1:, i],
                                 torch.stack(X[i + 1:], dim=-2))
        X[i] = s / L[..., i, i][..., None]
    return torch.stack(X, dim=-2)


# ---- the entry-wise form: M[i][j] (i >= j) are tensors of one shape ---------

def chol_bl(M):
    """Cholesky factor of entry-wise matrices: L[i][j] for i >= j."""
    n = len(M)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-30))
        L[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, n):
            t = M[i][j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv
    return L


def logdet_bl(L):
    out = torch.log(L[0][0])
    for j in range(1, len(L)):
        out = out + torch.log(L[j][j])
    return 2.0 * out


def solve_bl(L, b):
    """Solve (L L^T) x = b; b is a list of tensors or Python numbers.
    Python-constant zeros are skipped, so the unit-vector solves of
    ``inverse_bl`` issue no dead operations."""
    def is0(v):
        return isinstance(v, float) and v == 0.0

    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            if not is0(y[k]):
                s = s - L[i][k] * y[k]
        y[i] = 0.0 if is0(s) else s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            if not is0(x[k]):
                s = s - L[k][i] * x[k]
        x[i] = 0.0 if is0(s) else s / L[i][i]
    return x


def inverse_bl(L):
    """Sig[i][j] (full, symmetric) of (L L^T)^-1, entry-wise."""
    n = len(L)
    Sig = [[None] * n for _ in range(n)]
    for j in range(n):
        col = solve_bl(L, [1.0 if i == j else 0.0 for i in range(n)])
        for i in range(j, n):
            Sig[i][j] = col[i]
            Sig[j][i] = col[i]
    return Sig


# ---- the supports grouped by size -------------------------------------------

def _gsc_level_plan(act_np: np.ndarray):
    """Group the enumerated supports by size m (host numpy).  The states
    are size-ordered, so each level is a contiguous [off, off + S_m) slice
    of the state axis.  Returns [(off, idx_m)] with idx_m the (S_m, m)
    active slots of each state."""
    sizes = act_np.astype(bool).sum(axis=1)
    plan = []
    off = 0
    for m in range(int(sizes.min()), int(sizes.max()) + 1):
        rows = np.flatnonzero(sizes == m)
        if rows.size == 0:
            continue
        assert rows[0] == off and rows[-1] == off + rows.size - 1, (
            "state enumeration is not size-ordered")
        idx = np.stack([np.flatnonzero(act_np[r]) for r in rows])
        plan.append((off, idx.astype(np.int32)))
        off += rows.size
    return plan


class GSCLevel:
    """One support size m of the state space, on a device: the state slice
    ``off:off + S_m``, the flat columns of its Gram entries (i >= j) in
    ``Gf`` and of its slots in ``proj``, and the 0/1 tables that sum a
    (rows, S_m) quantity per slot (``E``: (m, S_m, Hp)) or per slot pair
    (``EE``: (m (m + 1) / 2, S_m, Hp^2), both orders of i != j)."""

    def __init__(self, off: int, idx: np.ndarray, Hp: int, device):
        S_m, m = idx.shape
        self.off, self.S, self.m = off, S_m, m
        self.pairs = [(i, j) for i in range(m) for j in range(i + 1)]
        gram_cols = np.stack([idx[:, i] * Hp + idx[:, j]
                              for i, j in self.pairs])
        eye = np.eye(Hp, dtype=np.float32)
        EE = np.stack([(eye[idx[:, i]][:, :, None] * eye[idx[:, j]][:, None, :]
                        + (eye[idx[:, j]][:, :, None]
                           * eye[idx[:, i]][:, None, :] if i != j else 0.0)
                        ).reshape(S_m, Hp * Hp) for i, j in self.pairs])

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)
        self.gram_cols = t(gram_cols.reshape(-1), torch.long)
        self.slot_cols = t(idx.T.reshape(-1), torch.long)
        self.E = t(np.stack([eye[idx[:, i]] for i in range(m)]))
        self.EE = t(EE)


def _gsc_shard_level_arrays(act_np: np.ndarray, n_shards: int):
    """The level-aligned layout of the supports over ``n_shards`` state
    shards (host numpy, the JAX package's ``_gsc_shard_level_arrays``):
    each size-m level's supports are dealt round-robin over the shards
    (shard r takes the level's supports r, r + n, ...) and padded per
    (level, shard) to L_m = ceil(S_m / n) with supports on slots 0..m-1 (a
    real SPD system, masked out of the logits), so that every shard holds
    the same level structure and shard r the same supports as the JAX
    package's shard r.  Returns (states (n, S_loc, Hp), svalid (n, S_loc),
    abs_states (n, S_loc))."""
    act = act_np.astype(bool)
    Hp = act.shape[1]
    sizes = act.sum(axis=1)
    states_sh, svalid_sh, absst_sh = [], [], []
    for m in range(int(sizes.min()), int(sizes.max()) + 1):
        rows = np.flatnonzero(sizes == m)
        if rows.size == 0:
            continue
        L_m = -(-rows.size // n_shards)
        valid = np.zeros((n_shards, L_m), np.float32)
        st = np.zeros((n_shards, L_m, Hp), np.float32)
        for r in range(n_shards):
            sub = rows[r::n_shards]
            valid[r, :sub.size] = 1.0
            st[r, :sub.size] = act[sub]
            st[r, sub.size:, :m] = 1.0
        states_sh.append(st)
        svalid_sh.append(valid)
        absst_sh.append(np.full((n_shards, L_m), float(m), np.float32))
    return (np.concatenate(states_sh, axis=1),
            np.concatenate(svalid_sh, axis=1),
            np.concatenate(absst_sh, axis=1))


def gsc_shard_arrays(sa: LinearStateArrays, n: int, srank: int):
    """State rank ``srank``'s share of the supports under ``n`` state
    shards (``_gsc_shard_level_arrays``), on the device of ``sa``: (its
    state arrays, svalid (S_loc,)), built once per (state space, n,
    srank); ``gsc_levels`` of those arrays solves its levels."""
    def build():
        st, sv, ab = _gsc_shard_level_arrays(
            (sa.states > 0.5).cpu().numpy(), n)

        def t(a):
            return torch.as_tensor(a[srank], device=sa.states.device)
        return sa._replace(states=t(st), abs_states=t(ab)), t(sv)
    return cached_for(sa.states, ("gsc_shard", n, srank), build)


def gsc_levels(sa: LinearStateArrays) -> List[GSCLevel]:
    """The levels of ``sa``'s state space on its device, built once per
    state table: a step then builds no tensor from the host (a CUDA graph
    could not capture that)."""
    def build():
        act = (sa.states > 0.5).cpu().numpy()
        Hp = act.shape[1]
        return [GSCLevel(off, idx, Hp, sa.states.device)
                for off, idx in _gsc_level_plan(act)]
    return cached_for(sa.states, "gsc_levels", build)


# ---- the E-step --------------------------------------------------------------

def _singletons(P, gram_diag, inv_s2, inv_psi, mu, psi):
    """The k = 1 supports over all H in closed form: (M1 (H,), kappa1 (C,H),
    lik_single (C, H))."""
    M1 = inv_psi + gram_diag * inv_s2
    b1 = P * inv_s2 + mu * inv_psi
    kappa1 = b1 / M1[None, :]
    lik_single = (-0.5 * torch.log(psi) - 0.5 * torch.log(M1)[None, :]
                  - (mu * mu) * (0.5 * inv_psi) + 0.5 * b1 * kappa1)
    return M1, kappa1, lik_single


def _free_energy_const(y2, D: int, H: int, sigma2, pi, beta, prior_beta):
    """-beta ||y||^2/2s2 - beta log_norm + prior_beta H log(1 - pi)."""
    log_norm = 0.5 * D * torch.log(2.0 * math.pi * sigma2)
    return (-beta * (0.5 * y2 * (1.0 / sigma2)) - beta * log_norm
            + prior_beta * H * torch.log1p(-pi))


def _scalars(device, *values):
    """The model's scalars as float32 tensors on ``device`` (0-d tensors
    there already are returned as they are)."""
    return [torch.as_tensor(v, dtype=torch.float32, device=device)
            for v in values]


def _chunk_gsc_estats(y, w, W, gram, gram_diag, sigma2, pi, mu, psi,
                      sa: LinearStateArrays, Hp: int, beta, prior_beta,
                      collect_true: bool = True, state_axis=None,
                      n_state_shards: int = 1):
    """E-statistics for one chunk: y (C, D), w (C,) accumulation weights.
    Returns (F (C,), sums).  State sharding (``state_axis``,
    ``n_state_shards > 1``), as the linear family's ``_chunk_estats``:
    this rank's level-aligned share of the supports (``gsc_shard_arrays``,
    each level solved at its size), the zero and singleton states on state
    rank 0, the softmax combined over the group."""
    C, D = y.shape
    H = W.shape[1]
    inv_s2 = 1.0 / sigma2
    inv_psi = 1.0 / psi
    log_odds = torch.log(pi) - torch.log1p(-pi)
    sharded = state_sharded(state_axis, n_state_shards)
    if sharded:
        srank = state_rank(state_axis)
        sa, svalid = gsc_shard_arrays(sa, n_state_shards, srank)
        own = float(srank == 0)

    P, cand, proj, Gf = _candidates(y, W, gram, gram_diag, Hp, True)
    bsrc = proj * inv_s2 + mu * inv_psi                            # (C, Hp)

    # each support size m solves m x m systems, one tensor per entry over
    # (rows, states of that size)
    levels = gsc_levels(sa)
    logdet_parts, bMb_parts, solved = [], [], []
    with traced_region("slab_solve"):
        for lv in levels:
            G = Gf[:, lv.gram_cols].view(C, len(lv.pairs), lv.S) * inv_s2
            bb = bsrc[:, lv.slot_cols].view(C, lv.m, lv.S)
            Mbl = [[None] * lv.m for _ in range(lv.m)]
            for p, (i, j) in enumerate(lv.pairs):
                Mbl[i][j] = G[:, p] + inv_psi if i == j else G[:, p]
            b = [bb[:, i] for i in range(lv.m)]
            L = chol_bl(Mbl)
            logdet_parts.append(logdet_bl(L))
            kap = solve_bl(L, b)
            bMb_parts.append(sum(b[i] * kap[i] for i in range(lv.m)))
            solved.append((kap, inverse_bl(L)))
        logdet = torch.cat(logdet_parts, dim=1)                    # (C, S)
        bMb = torch.cat(bMb_parts, dim=1)

    k_s = sa.abs_states
    lik_multi = (-0.5 * k_s[None, :] * torch.log(psi) - 0.5 * logdet
                 - k_s[None, :] * (mu * mu) * (0.5 * inv_psi) + 0.5 * bMb)
    prior_multi = k_s * log_odds                                   # (S,)
    M1, kappa1, lik_single = _singletons(P, gram_diag, inv_s2, inv_psi, mu,
                                         psi)
    zero = torch.zeros((C, 1), dtype=torch.float32, device=y.device)
    logits = torch.cat([zero, beta * lik_single + prior_beta * log_odds,
                        beta * lik_multi + prior_beta * prior_multi[None, :]],
                       dim=1)
    # the un-annealed channel; a saturated step skips it (F_true == F)
    logits_t = None if not collect_true else torch.cat(
        [zero, lik_single + log_odds, lik_multi + prior_multi[None, :]],
        dim=1)
    if sharded:
        logits, logits_t = (mask_union(t, 1 + H, own, svalid)
                            for t in (logits, logits_t))
    q, logZ, logZ_t = union_softmax(logits, logits_t,
                                    state_axis if sharded else None)
    y2 = (y * y).sum(dim=1)
    F = logZ + _free_energy_const(y2, D, H, sigma2, pi, beta, prior_beta)
    F_true = F if not collect_true else (
        logZ_t + _free_energy_const(y2, D, H, sigma2, pi, 1.0, 1.0))

    q_single = q[:, 1:1 + H]                                       # (C, H)
    q_multi = q[:, 1 + H:]                                         # (C, S)

    # <sz> and <sz sz^T> in the Hp candidate frame: per level one product
    # of the (rows, states) values with the constant per-slot tables
    wv = w.to(torch.float32)
    with traced_region("slab_moments"):
        sz_cand = torch.zeros((C, Hp), dtype=torch.float32, device=y.device)
        szsz = torch.zeros((C, Hp * Hp), dtype=torch.float32,
                           device=y.device)
        for lv, (kap, Sig) in zip(levels, solved):
            q_m = q_multi[:, lv.off:lv.off + lv.S]                 # (C, S_m)
            qk = torch.stack([q_m * kap[i] for i in range(lv.m)], dim=1)
            sz_cand = sz_cand + qk.reshape(C, -1) @ lv.E.reshape(-1, Hp)
            vals = torch.stack([q_m * (Sig[i][j] + kap[i] * kap[j])
                                for i, j in lv.pairs], dim=1)
            szsz = szsz + vals.reshape(C, -1) @ lv.EE.reshape(-1, Hp * Hp)

        sz_full = (q_single * kappa1).scatter_add(1, cand, sz_cand)  # (C, H)
        sw = sz_full * wv[:, None]
        Sig1 = 1.0 / M1
        ss_diag = (q_single * (Sig1[None, :] + kappa1 ** 2)
                   * wv[:, None]).sum(0)
        sum_ss = (slot_sum_ss(szsz * wv[:, None], cand, H)
                  + torch.diag(ss_diag))
    abs_n = q_single.sum(dim=1) + q_multi @ k_s
    sums = dict(xs=y.T @ sw, ss=sum_ss, s=sw.sum(dim=0),
                abs=(abs_n * wv).sum(), y2=(y2 * wv).sum(), n=wv.sum(),
                F=(F * wv).sum(), F_true=(F_true * wv).sum())
    return F, own_scalars(sums, own) if sharded else sums


def gsc_et_estep(y: torch.Tensor, weight: torch.Tensor, W: torch.Tensor,
                 sigma2, pi, mu, psi, sa: LinearStateArrays, Hp: int,
                 beta, prior_beta, chunk: int = 1024,
                 collect_true: bool = True, state_axis=None,
                 n_state_shards: int = 1
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The GSC E-step with chunked accumulation: (F (N,), sums).  N must
    be a multiple of ``chunk`` unless N <= chunk (``EM`` pads with weight-0
    rows).  The JAX package's ``batch_last=False`` (the padded form in the
    E-step) is left out: the decode runs that form.  Under a state axis
    each chunk runs on this rank's share of the supports, and the caller
    adds the sums over the state group too."""
    N = y.shape[0]
    sigma2, pi, mu, psi = _scalars(y.device, sigma2, pi, mu, psi)
    gram = W.T @ W
    gram_diag = torch.diagonal(gram)

    def body(y_i, w_i):
        return _chunk_gsc_estats(y_i, w_i, W, gram, gram_diag, sigma2, pi,
                                 mu, psi, sa, Hp, beta, prior_beta,
                                 collect_true, state_axis, n_state_shards)

    if N <= chunk:
        return body(y, weight)
    if N % chunk != 0:
        raise ValueError(f"shard size {N} not a multiple of chunk {chunk}")
    Fs, total = [], None
    for i in range(0, N, chunk):
        F_i, sums_i = body(y[i:i + chunk], weight[i:i + chunk])
        Fs.append(F_i)
        total = sums_i if total is None else {
            k: total[k] + sums_i[k] for k in total}
    return torch.cat(Fs), total


# ---- the decode ---------------------------------------------------------------

def _gsc_posterior_chunk(y, W, gram, gram_diag, sigma2, pi, mu, psi,
                         sa: LinearStateArrays, Hp: int, top_L: int, beta,
                         prior_beta, dense_states: bool):
    """Posterior decode of one chunk through the padded tensor form."""
    C, D = y.shape
    H = W.shape[1]
    inv_s2 = 1.0 / sigma2
    inv_psi = 1.0 / psi
    log_odds = torch.log(pi) - torch.log1p(-pi)
    P, cand, proj, Gf = _candidates(y, W, gram, gram_diag, Hp, True)
    G = Gf.view(C, Hp, Hp)

    act = (sa.states > 0.5).float()                                # (S, Hp)
    k_s = sa.abs_states
    act_ab = act[:, :, None] * act[:, None, :]
    diag_term = act * inv_psi + (1.0 - act)
    M = (act_ab[None] * (G[:, None] * inv_s2)
         + torch.diag_embed(diag_term)[None])                      # (C,S,Hp,Hp)
    b = act[None] * (proj[:, None, :] * inv_s2 + mu * inv_psi)     # (C,S,Hp)
    chol = chol_small(M)
    kappa = cho_solve_vec_small(chol, b)
    bMb = (b * kappa).sum(dim=-1)
    lik_multi = (-0.5 * k_s[None, :] * torch.log(psi)
                 - 0.5 * cho_logdet_small(chol)
                 - k_s[None, :] * (mu * mu) * (0.5 * inv_psi) + 0.5 * bMb)
    _, kappa1, lik_single = _singletons(P, gram_diag, inv_s2, inv_psi, mu,
                                        psi)
    logits = torch.cat(
        [torch.zeros((C, 1), dtype=torch.float32, device=y.device),
         beta * lik_single + prior_beta * log_odds,
         beta * lik_multi + prior_beta * (k_s * log_odds)[None, :]], dim=1)
    m = logits.max(dim=1, keepdim=True).values
    p = torch.exp(logits - m)
    Z = p.sum(dim=1, keepdim=True)
    q = p / Z
    F = (m + torch.log(Z))[:, 0] + _free_energy_const(
        (y * y).sum(dim=1), D, H, sigma2, pi, beta, prior_beta)

    q_single = q[:, 1:1 + H]
    q_multi = q[:, 1 + H:]
    # p(b_h = 1 | y) and the slab means <s_h z_h>
    b_mean = q_single.scatter_add(1, cand, q_multi @ act)
    sz_cand = torch.einsum("ns,nsh->nh", q_multi, kappa)
    s_mean = (q_single * kappa1).scatter_add(1, cand, sz_cand)
    top_q, top_u = top_l_argmax(q, top_L)
    out = top_states_from_topk(top_q, top_u, H, 1,
                               torch.ones(1, device=y.device), act, cand,
                               dense_states)
    if not dense_states:
        out["cand"] = cand.to(torch.int32)
    out.update({"b_mean": b_mean, "s_mean": s_mean, "recon": s_mean @ W.T,
                "F": F})
    return out


def gsc_posterior(y: torch.Tensor, W: torch.Tensor, sigma2, pi, mu, psi,
                  sa: LinearStateArrays, Hp: int, top_L: int = 10,
                  beta=1.0, prior_beta=1.0, chunk: int = 1024,
                  dense_states: bool = True) -> Dict[str, torch.Tensor]:
    """Posterior decode for GSC in chunks of rows: the top-L supports and
    their probabilities (dense ``top_states``, or the compact fields and
    ``cand``), the support posterior ``b_mean`` = p(b_h = 1 | y), the slab
    means ``s_mean`` = <s_h z_h>, ``recon`` = s_mean W^T, and F."""
    H = W.shape[1]
    S = sa.states.shape[0]
    if top_L > 1 + H + S:
        raise ValueError(f"top_L={top_L} exceeds the {1 + H + S} "
                         "posterior columns")
    sigma2, pi, mu, psi = _scalars(y.device, sigma2, pi, mu, psi)
    gram = W.T @ W
    gram_diag = torch.diagonal(gram)
    parts = [_gsc_posterior_chunk(y[i:i + chunk], W, gram, gram_diag, sigma2,
                                  pi, mu, psi, sa, Hp, top_L, beta,
                                  prior_beta, dense_states)
             for i in range(0, y.shape[0], chunk)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
