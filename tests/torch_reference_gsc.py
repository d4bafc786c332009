"""The plain reference of GSC (spike-and-slab sparse coding): its
Expectation-Truncation EM steps in plain PyTorch, float64 by default.

Written from the model's equations (Sheikh, Shelton and Luecke, "A
Truncated EM Approach for Spike-and-Slab Sparse Coding", JMLR 15, 2014),
not from the program, and importing nothing of it.  The latents are
s_h = b_h z_h with b ~ Bernoulli(pi) and z ~ N(mu, psi); y = W s + sigma
noise.  For a binary support of m units the slab integrates out in closed
form:

  M_s = I / psi + W_s^T W_s / sigma^2               (m x m precision)
  b_s = W_s^T y / sigma^2 + mu / psi                (natural parameter)
  log p(y, s) = const - m/2 log psi - 1/2 log det M_s - m mu^2 / 2 psi
                + 1/2 b_s^T M_s^-1 b_s + m log(pi / (1 - pi))
  q(z | y, s) = N(kappa_s = M_s^-1 b_s, Sigma_s = M_s^-1)

Each (row, support) matrix is factored by ``torch.linalg.cholesky``.  With
q = softmax(beta * log-likelihood + prior_beta * log-prior) over the
truncated union, F per row is

  F = logZ - beta ||y||^2 / 2 sigma^2 - beta D/2 log(2 pi sigma^2)
      + prior_beta H log(1 - pi)

and the M-step is

  W     <- (sum y <sz>^T)(sum <sz sz^T> + ridge)^-1,  <sz sz^T> holding
           Sigma_s + kappa_s kappa_s^T
  pi    <- pi A_gamma / B_gamma * mean <|s|>          (the ET correction)
  sigma^2 <- sum <||y - W sz||^2> / (N D) with the new W
  mu    <- sum <s_h z_h> / sum <|s|>
  psi   <- sum <s_h z_h^2> / sum <|s|> - 2 mu sum <s_h z_h> / sum <|s|>
           + mu^2, at the new mu

Departures from the paper, which are the port's and are followed here: the
truncation is ET's, not the paper's preselection by the posterior: per row
the zero state, the H singletons over all H and every support of 2..gamma
units among the H' candidates, the units with the largest |y.W_h| / |W_h|
(the port's signed selection; ties go to the lower index there and are
left to ``torch.topk`` here, where in float64 they do not occur); the
ET data cut (``Ncut``) keeps the rows of largest F of the previous
iteration (``reference.cut_weights``); the W ridge of 1e-6 (trace / H + 1).

``prec`` is a ``reference.Prec``: "float64" (the reference), "tf32" (the
control: float32 with TF32-rounded operands in the products) or "float32"
(a witness of how far rounding alone moves the iterations).  Rows are taken
in blocks, so the reference fits beside the program's state at N = 10^6.
TF32 is switched off for matmul and cuDNN on import, so that a float32
product here is one.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional

import torch

from benchmark.reference import (Prec, cut_weights, multi_states,
                                 step_schedule, truncated_logmass)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK = 65536


def levels(Hp: int, gamma: int, device) -> List[torch.Tensor]:
    """The supports of 2..gamma candidate slots by size m: one (S_m, m)
    tensor of slot indices a size."""
    st = multi_states(Hp, gamma, device, torch.float64) > 0.5
    sizes = st.sum(dim=1)
    return [torch.nonzero(st[sizes == m])[:, 1].reshape(-1, m)
            for m in range(2, gamma + 1)]


def gsc_estep(blocks: Iterable, W, pi, sigma, mu, psi, beta, prior_beta,
              Hp: int, gamma: int, prec: Prec, slab_cov: bool = True
              ) -> Dict:
    """E-step sums over ``blocks`` of (rows, weight): a row of weight 0
    (cut) adds nothing to the sums; every row's F is kept (``F_rows``).
    ``slab_cov=False`` leaves Sigma_s out of <sz sz^T> (kappa kappa^T
    alone): a fault the calibration plants."""
    D, H = W.shape
    dev = W.device
    W = prec.cast(W)
    pi, mu, psi = prec.cast(pi), prec.cast(mu), prec.cast(psi)
    s2 = prec.cast(sigma) ** 2
    G = prec.mm(W.T, W)
    g = torch.diagonal(G)
    lo = torch.log(pi) - torch.log1p(-pi)
    lv = levels(Hp, gamma, dev)
    nact = torch.cat([torch.full((idx.shape[0],), float(idx.shape[1]),
                                 dtype=prec.dtype, device=dev) for idx in lv])
    cov = 1.0 if slab_cov else 0.0
    out = {k: torch.zeros((), dtype=prec.dtype, device=dev)
           for k in ("n", "y2", "F", "F_true", "abs")}
    out["xs"] = torch.zeros((D, H), dtype=prec.dtype, device=dev)
    out["s"] = torch.zeros(H, dtype=prec.dtype, device=dev)
    ss = torch.zeros(H * H, dtype=prec.dtype, device=dev)
    out["F_rows"] = []
    # the singletons over all H, in closed form (m = 1)
    M1 = 1.0 / psi + g / s2
    for y, w in blocks:
        y, w = prec.cast(y), prec.cast(w)
        B = y.shape[0]
        P = prec.mm(y, W)                                          # (B, H)
        cand = torch.topk(P.abs() / torch.sqrt(g)[None, :], Hp,
                          dim=1).indices                           # (B, Hp)
        b1 = P / s2 + mu / psi
        kap1 = b1 / M1
        lik1 = (-0.5 * torch.log(psi) - 0.5 * torch.log(M1) - mu * mu
                / (2.0 * psi) + 0.5 * b1 * kap1)
        liks, parts = [], []
        for idx in lv:
            S_m, m = idx.shape
            u = cand[:, idx]                                       # (B,S_m,m)
            M = (G[u[..., :, None], u[..., None, :]] / s2
                 + torch.eye(m, dtype=prec.dtype, device=dev) / psi)
            b = P.gather(1, u.reshape(B, -1)).reshape(B, S_m, m) / s2 \
                + mu / psi
            L = torch.linalg.cholesky(M)
            kap = torch.cholesky_solve(b[..., None], L)[..., 0]
            logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2,
                                                    dim2=-1)).sum(dim=-1)
            liks.append(-0.5 * m * torch.log(psi) - 0.5 * logdet
                        - m * mu * mu / (2.0 * psi)
                        + 0.5 * (b * kap).sum(dim=-1))
            parts.append((u, kap, torch.cholesky_inverse(L), m))
        lik_m = torch.cat(liks, dim=1)                             # (B, S)
        zero = torch.zeros((B, 1), dtype=prec.dtype, device=dev)
        logits = torch.cat([zero, beta * lik1 + prior_beta * lo,
                            beta * lik_m + prior_beta * nact * lo], dim=1)
        logZ = torch.logsumexp(logits, dim=1)
        q = torch.exp(logits - logZ[:, None])
        logZ_t = torch.logsumexp(torch.cat(
            [zero, lik1 + lo, lik_m + nact * lo], dim=1), dim=1)
        y2 = (y * y).sum(dim=1)
        F = logZ + _f_const(y2, D, H, s2, pi, beta, prior_beta)
        F_t = logZ_t + _f_const(y2, D, H, s2, pi, 1.0, 1.0)
        out["F_rows"].append(F)
        q = q * w[:, None]
        q1 = q[:, 1:1 + H]
        sz = q1 * kap1                                             # (B, H)
        ss_diag = (q1 * (cov / M1 + kap1 * kap1)).sum(dim=0)
        absn = q1.sum()
        off = 1 + H
        for u, kap, Sig, m in parts:
            S_m = u.shape[1]
            qm = q[:, off:off + S_m]
            off += S_m
            sz.scatter_add_(1, u.reshape(B, -1),
                            (qm[..., None] * kap).reshape(B, -1))
            mom = qm[..., None, None] * (cov * Sig + kap[..., :, None]
                                         * kap[..., None, :])
            ss.index_add_(0, (u[..., :, None] * H
                              + u[..., None, :]).reshape(-1),
                          mom.reshape(-1))
            absn = absn + m * qm.sum()
        ss += torch.diag(ss_diag).reshape(-1)
        out["xs"] += prec.mm(y.T, sz)
        out["s"] += sz.sum(dim=0)
        out["abs"] += absn
        out["n"] += w.sum()
        out["y2"] += (w * y2).sum()
        out["F"] += (w * F).sum()
        out["F_true"] += (w * F_t).sum()
    out["ss"] = ss.reshape(H, H)
    return out


def _f_const(y2, D, H, s2, pi, beta, prior_beta):
    return (-beta * y2 / (2.0 * s2) - beta * 0.5 * D * torch.log(
        2.0 * math.pi * s2) + prior_beta * H * torch.log1p(-pi))


def gsc_mstep(sums, W, pi, H: int, gamma: int, prec: Prec) -> Dict:
    """The five updates from the E-step's sums; ``W`` and ``pi`` are the
    values the E-step ran with."""
    D = W.shape[0]
    ss, xs = sums["ss"], sums["xs"]
    n = torch.clamp(sums["n"], min=1.0)
    ridge = 1e-6 * (torch.trace(ss) / H + 1.0)
    Wn = torch.linalg.solve(ss + ridge * torch.eye(H, dtype=ss.dtype,
                                                   device=ss.device),
                            xs.T).T
    logA, logB = truncated_logmass(prec.cast(pi), H, gamma)
    pin = torch.clamp(prec.cast(pi) * torch.exp(logA - logB) * sums["abs"]
                      / n, 1e-6, 1.0 - 1e-6)
    resid = (sums["y2"] - 2.0 * (Wn * xs).sum()
             + (prec.mm(Wn.T, Wn) * ss).sum())
    sigma = torch.sqrt(torch.clamp(resid / (n * D), min=1e-10))
    total = torch.clamp(sums["abs"], min=1e-6)
    mu = sums["s"].sum() / total
    psi = torch.clamp(torch.trace(ss) / total - 2.0 * mu * sums["s"].sum()
                      / total + mu * mu, min=1e-6)
    return {"W": Wn, "pi": pin, "sigma": sigma, "mu": mu, "psi": psi}


PARAMS = ("W", "pi", "sigma", "mu", "psi")


def em_steps(cfg: Dict, shards: List[torch.Tensor], init: Dict,
             schedule: Dict, steps: int, n_steps: int,
             noise: Callable[[int], torch.Tensor], prec: Prec,
             rows_used: Optional[Callable] = None, cut: bool = True,
             slab_cov: bool = True) -> List[Dict]:
    """The first ``n_steps`` EM iterations from ``init`` (W, pi, sigma, mu,
    psi) over the rows of every shard (the W noise of iteration t is
    ``noise(t)``, float32 (D, H), scaled by the schedule).  Returns per
    iteration the free energies per datapoint and the five new parameters.
    Where the schedule's ``Ncut_factor`` is above 0 the iteration cuts the
    rows by the previous iteration's F (``cut_weights``).  Faults the
    calibration plants: ``rows_used`` (shard -> rows) keeps part of each
    shard, ``cut=False`` keeps every row under the cut, ``slab_cov=False``
    leaves Sigma_s out of <sz sz^T>."""
    H, Hp, gamma = cfg["H"], cfg["Hprime"], cfg["gamma"]
    p = {k: prec.cast(init[k]) for k in PARAMS}
    out, F_rows = [], None
    for t in range(n_steps):
        sc = step_schedule(schedule, steps, t)
        if sc["Ncut_factor"] > 0 and F_rows is None:
            raise ValueError("the data cut needs a previous iteration's F")
        weights = (cut_weights(F_rows, p["pi"], H, gamma, sc["Ncut_factor"])
                   if sc["Ncut_factor"] > 0 and cut else None)
        Wt = (p["W"] + sc["W_noise"] * prec.cast(noise(t)) if sc["W_noise"]
              else p["W"])

        def blocks():
            j = 0
            for y in shards:
                y = rows_used(y) if rows_used is not None else y
                for i in range(0, y.shape[0], BLOCK):
                    rows = y[i:i + BLOCK]
                    yield rows, (weights[j] if weights is not None else
                                 torch.ones(rows.shape[0], dtype=prec.dtype,
                                            device=rows.device))
                    j += 1
        sums = gsc_estep(blocks(), Wt, p["pi"], p["sigma"], p["mu"],
                         p["psi"], sc["beta"], 1.0, Hp, gamma, prec,
                         slab_cov)
        F_rows = sums.pop("F_rows")
        p = gsc_mstep(sums, Wt, p["pi"], H, gamma, prec)
        n = torch.clamp(sums["n"], min=1.0)
        out.append({"F_mean": float(sums["F"] / n),
                    "Q_mean": float(sums["F_true"] / n), **p})
    return out
