"""The plain reference: Expectation-Truncation EM steps of BSC (linear
superposition) and MCA (max superposition), and the BSC posterior decode,
in plain PyTorch.

Written from the models' equations, not from the program, and importing
nothing of it.  Per datapoint the truncated posterior covers the zero
state, the H singletons and every state of 2..gamma active units among the
H' candidates, the units with the largest y.W_h / |W_h|.  With
q = softmax(beta * log-likelihood + prior_beta * log-prior) over that union:

  F      = logZ - beta ||y||^2 / 2s2 - beta D/2 log(2 pi s2)
           + prior_beta H log(1 - pi)
  BSC    W <- (sum y <s>^T)(sum <s s^T> + ridge)^-1,
         sigma^2 <- sum <||y - W s||^2> / (N D) with the new W
  MCA    W_dh <- sum <A_ndh> y_nd / sum <A_ndh>, A = [h wins pixel d],
         sigma^2 <- sum <||y - ybar_s||^2> / (N D) with the old W
  both   pi <- pi A_gamma / B_gamma * mean <|s|>   (the ET correction)

``prec`` is "float64" (the reference), "tf32" (the control: float32
arithmetic whose products take operands rounded to TF32's 10-bit mantissa,
as the tensor cores' TF32 mode does; the emulation gives the same numbers
on any device) or "float32" (IEEE float32 throughout: a witness of how far
rounding alone moves a trajectory).  Rows are taken in blocks, so the reference fits beside the
program's state at N = 10^6 rows.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, Iterable, List, Optional

import torch

BLOCK = {"linear": 65536, "max": 4096}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest on TF32's 10-bit mantissa."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x1000) & -0x2000
    return b.view(torch.float32)


class Prec:
    """The arithmetic of one side: its dtype and its products."""

    def __init__(self, name: str):
        if name not in ("float64", "tf32", "float32"):
            raise ValueError(f"precision {name!r}: float64, tf32 or float32")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return torch.matmul(tf32(a), tf32(b))
        return torch.matmul(a, b)

    def bmv(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(B, S, D) . (B, D) -> (B, S)"""
        return self.mm(a, b[:, :, None])[:, :, 0]


def multi_states(Hp: int, gamma: int, device, dtype) -> torch.Tensor:
    """(S, Hp) binary states with 2..gamma active candidate slots."""
    rows = []
    for k in range(2, gamma + 1):
        for sup in itertools.combinations(range(Hp), k):
            r = [0.0] * Hp
            for i in sup:
                r[i] = 1.0
            rows.append(r)
    return torch.tensor(rows, dtype=dtype, device=device)


def schedule_value(points: List, steps: int, position: int) -> float:
    """A piecewise-linear schedule: breakpoints (fraction of the run in
    [0, 1], or an iteration > 1, value), held flat outside them."""
    pts = sorted(((p * (steps - 1) if 0.0 <= p <= 1.0 else p, v)
                  for p, v in points), key=lambda pv: pv[0])
    x = float(position)
    if x <= pts[0][0]:
        return float(pts[0][1])
    for (x0, v0), (x1, v1) in zip(pts[:-1], pts[1:]):
        if x0 <= x <= x1:
            return float(v1 if x1 == x0 else v0 + (x - x0) / (x1 - x0)
                         * (v1 - v0))
    return float(pts[-1][1])


def f32(v: float) -> float:
    """A schedule value as the device holds it (float32)."""
    return float(torch.tensor(v, dtype=torch.float32))


def step_schedule(schedule: Dict, steps: int, position: int) -> Dict:
    T = schedule_value(schedule["T"], steps, position) if "T" in schedule \
        else 1.0
    return {"beta": f32(1.0 / max(T, 1e-6)),
            "W_noise": f32(schedule_value(schedule.get("W_noise", [[0, 0]]),
                                          steps, position)),
            "Ncut_factor": schedule_value(
                schedule.get("Ncut_factor", [[0, 0]]), steps, position)}


def truncated_logmass(pi: torch.Tensor, H: int, gamma: int):
    """(log A, log B): A = sum_{k <= gamma} C(H, k) pi^k (1 - pi)^(H - k),
    B the same with a factor k."""
    ks = torch.arange(gamma + 1, dtype=pi.dtype, device=pi.device)
    lc = torch.tensor([math.lgamma(H + 1) - math.lgamma(k + 1)
                       - math.lgamma(H - k + 1) for k in range(gamma + 1)],
                      dtype=pi.dtype, device=pi.device)
    terms = lc + ks * torch.log(pi) + (H - ks) * torch.log1p(-pi)
    logB = torch.logsumexp(terms[1:] + torch.log(ks[1:]), dim=0)
    return torch.logsumexp(terms, dim=0), logB


def _front(y, W, wnorm, Hp, prec):
    P = prec.mm(y, W)                                              # (B, H)
    cand = torch.topk(P / wnorm[None, :], Hp, dim=1).indices       # (B, Hp)
    return P, cand


def _f_const(y2, D, H, s2, pi, beta, prior_beta):
    return (-beta * y2 / (2.0 * s2) - beta * 0.5 * D * torch.log(
        2.0 * math.pi * s2) + prior_beta * H * torch.log1p(-pi))


def _softmax_parts(logits):
    logZ = torch.logsumexp(logits, dim=1)
    return torch.exp(logits - logZ[:, None]), logZ


def linear_estep(blocks: Iterable, W, pi, sigma, beta, prior_beta, Hp,
                 gamma, prec: Prec) -> Dict:
    """BSC E-step sums over ``blocks`` of (rows, weight): a row of weight
    0 (cut) adds nothing to the sums; every row's F is kept (``F_rows``)."""
    D, H = W.shape
    dev = W.device
    W = prec.cast(W)
    pi, s2 = prec.cast(pi), prec.cast(sigma) ** 2
    st = multi_states(Hp, gamma, dev, prec.dtype)                  # (S, Hp)
    outer = (st[:, :, None] * st[:, None, :]).reshape(len(st), Hp * Hp)
    nact = st.sum(dim=1)
    G = prec.mm(W.T, W)
    g = torch.diagonal(G)
    lo = torch.log(pi) - torch.log1p(-pi)
    out = {k: torch.zeros((), dtype=prec.dtype, device=dev)
           for k in ("n", "y2", "F", "F_true", "abs")}
    out["xs"] = torch.zeros((D, H), dtype=prec.dtype, device=dev)
    ss = torch.zeros(H * H, dtype=prec.dtype, device=dev)
    ss_diag = torch.zeros(H, dtype=prec.dtype, device=dev)
    out["F_rows"] = []
    for y, w in blocks:
        y, w = prec.cast(y), prec.cast(w)
        B = y.shape[0]
        P, cand = _front(y, W, torch.sqrt(g), Hp, prec)
        proj = P.gather(1, cand)
        Gc = G[cand[:, :, None], cand[:, None, :]].reshape(B, Hp * Hp)
        lik_m = (2.0 * prec.mm(proj, st.T) - prec.mm(Gc, outer.T)) / (2 * s2)
        lik_s = (2.0 * P - g[None, :]) / (2 * s2)
        zero = torch.zeros((B, 1), dtype=prec.dtype, device=dev)
        q, logZ = _softmax_parts(torch.cat(
            [zero, beta * lik_s + prior_beta * lo,
             beta * lik_m + prior_beta * nact * lo], dim=1))
        y2 = (y * y).sum(dim=1)
        F = logZ + _f_const(y2, D, H, s2, pi, beta, prior_beta)
        logZ_t = torch.logsumexp(torch.cat(
            [zero, lik_s + lo, lik_m + nact * lo], dim=1), dim=1)
        F_t = logZ_t + _f_const(y2, D, H, s2, pi, 1.0, 1.0)
        out["F_rows"].append(F)
        q = q * w[:, None]
        qs, qm = q[:, 1:1 + H], q[:, 1 + H:]
        s_mean = qs.scatter_add(1, cand, prec.mm(qm, st))
        ss_diag += qs.sum(dim=0)
        idx = (cand[:, :, None] * H + cand[:, None, :]).reshape(-1)
        ss.index_add_(0, idx, prec.mm(qm, outer).reshape(-1))
        out["xs"] += prec.mm(y.T, s_mean)
        out["abs"] += qs.sum() + (qm * nact).sum()
        _add_rows(out, w, y2, F, F_t)
    out["ss"] = ss.reshape(H, H) + torch.diag(ss_diag)
    return out


def max_estep(blocks: Iterable, W, pi, sigma, beta, prior_beta, Hp, gamma,
              prec: Prec) -> Dict:
    """MCA E-step sums over ``blocks`` of (rows, weight), as
    ``linear_estep``: the winner of pixel d in a state is its active unit
    of largest W_dh (on a tie the earlier candidate)."""
    D, H = W.shape
    dev = W.device
    W = prec.cast(W)
    WT = W.T.contiguous()
    pi, s2 = prec.cast(pi), prec.cast(sigma) ** 2
    st = multi_states(Hp, gamma, dev, prec.dtype)
    S = len(st)
    nact = st.sum(dim=1)
    g = (W * W).sum(dim=0)
    lo = torch.log(pi) - torch.log1p(-pi)
    out = {k: torch.zeros((), dtype=prec.dtype, device=dev)
           for k in ("n", "y2", "F", "F_true", "abs", "resid")}
    numer = torch.zeros((H, D), dtype=prec.dtype, device=dev)
    denom = torch.zeros((H, D), dtype=prec.dtype, device=dev)
    act = st > 0.5
    out["F_rows"] = []
    for y, w in blocks:
        y, w = prec.cast(y), prec.cast(w)
        B = y.shape[0]
        P, cand = _front(y, W, torch.sqrt(g), Hp, prec)
        Wc = WT[cand]                                              # (B,Hp,D)
        ybar = torch.full((B, S, D), -math.inf, dtype=prec.dtype, device=dev)
        win = torch.zeros((B, S, D), dtype=torch.long, device=dev)
        for h in range(Hp):
            v = Wc[:, h:h + 1, :].expand(B, S, D)
            better = act[None, :, h, None] & (v > ybar)
            ybar = torch.where(better, v, ybar)
            win = torch.where(better, torch.full_like(win, h), win)
        y_dot = prec.bmv(ybar, y)                                   # (B, S)
        ybar2 = (ybar * ybar).sum(dim=2)
        lik_m = (2.0 * y_dot - ybar2) / (2 * s2)
        lik_s = (2.0 * P - g[None, :]) / (2 * s2)
        zero = torch.zeros((B, 1), dtype=prec.dtype, device=dev)
        q, logZ = _softmax_parts(torch.cat(
            [zero, beta * lik_s + prior_beta * lo,
             beta * lik_m + prior_beta * nact * lo], dim=1))
        y2 = (y * y).sum(dim=1)
        F = logZ + _f_const(y2, D, H, s2, pi, beta, prior_beta)
        logZ_t = torch.logsumexp(torch.cat(
            [zero, lik_s + lo, lik_m + nact * lo], dim=1), dim=1)
        F_t = logZ_t + _f_const(y2, D, H, s2, pi, 1.0, 1.0)
        out["F_rows"].append(F)
        q = q * w[:, None]
        q0, qs, qm = q[:, 0], q[:, 1:1 + H], q[:, 1 + H:]
        A = torch.zeros((B, Hp, D), dtype=prec.dtype, device=dev)
        A.scatter_add_(1, win, qm[:, :, None].expand(B, S, D))
        flat = cand.reshape(-1)
        denom.index_add_(0, flat, A.reshape(B * Hp, D))
        numer.index_add_(0, flat, (A * y[:, None, :]).reshape(B * Hp, D))
        denom += qs.sum(dim=0)[:, None]
        numer += prec.mm(qs.T, y)
        out["resid"] += (q0 * y2).sum() + (qs * (y2[:, None] - 2.0 * P
                                                 + g[None, :])).sum() \
            + (qm * (y2[:, None] - 2.0 * y_dot + ybar2)).sum()
        out["abs"] += qs.sum() + (qm * nact).sum()
        _add_rows(out, w, y2, F, F_t)
    out["numer"], out["denom"] = numer, denom
    return out


def _add_rows(out, w, y2, F, F_t) -> None:
    """The kept rows' count, |y|^2 and free energies into the sums."""
    out["n"] += w.sum()
    out["y2"] += (w * y2).sum()
    out["F"] += (w * F).sum()
    out["F_true"] += (w * F_t).sum()


def cut_weights(F_rows: List[torch.Tensor], pi, H: int, gamma: int,
                factor: float) -> List[torch.Tensor]:
    """The ET data cut: 0/1 weights keeping the ceil((1 - (1 - A) factor)
    N) rows of the largest F of the previous iteration (A: the prior mass
    of the states of at most gamma units), per block of ``F_rows``."""
    F = torch.cat(F_rows)
    A = torch.exp(truncated_logmass(pi, H, gamma)[0])
    keep = int(math.ceil(float((1.0 - (1.0 - A) * factor) * F.numel())))
    thresh = torch.topk(F, keep).values[-1]
    return [(f >= thresh).to(f.dtype) for f in F_rows]


def linear_mstep(sums, W, pi, sigma, H, gamma, prec: Prec):
    D = W.shape[0]
    ss = sums["ss"]
    ridge = 1e-6 * (torch.trace(ss) / H + 1.0)
    A = ss + ridge * torch.eye(H, dtype=ss.dtype, device=ss.device)
    Wn = torch.linalg.solve(A, sums["xs"].T).T
    n = sums["n"]
    resid = (sums["y2"] - 2.0 * (Wn * sums["xs"]).sum()
             + (prec.mm(Wn.T, Wn) * ss).sum())
    return Wn, _pi_update(sums, pi, H, gamma), torch.sqrt(
        torch.clamp(resid / (n * D), min=1e-10))


def max_mstep(sums, W, pi, sigma, H, gamma, prec: Prec):
    D = W.shape[0]
    denom = sums["denom"]
    Wn = torch.where(denom > 1e-6, sums["numer"] / torch.clamp(denom,
                                                                min=1e-6),
                     prec.cast(W).T).T
    return Wn, _pi_update(sums, pi, H, gamma), torch.sqrt(
        torch.clamp(sums["resid"] / (sums["n"] * D), min=1e-10))


def _pi_update(sums, pi, H, gamma):
    logA, logB = truncated_logmass(pi, H, gamma)
    return torch.clamp(pi * torch.exp(logA - logB) * sums["abs"] / sums["n"],
                       1e-6, 1.0 - 1e-6)


MODELS = {"linear": (linear_estep, linear_mstep),
          "max": (max_estep, max_mstep)}


def em_steps(cfg: Dict, shards: List[torch.Tensor], init: Dict,
             schedule: Dict, steps: int, n_steps: int,
             noise: Callable[[int], torch.Tensor], prec: Prec,
             rows_used: Optional[Callable] = None) -> List[Dict]:
    """The first ``n_steps`` EM iterations from ``init`` over the rows of
    every shard (the W noise of iteration t is ``noise(t)``, float32
    (D, H), scaled by the schedule).  Returns per iteration the free
    energies per datapoint and the new W, pi and sigma.  Where the
    schedule's ``Ncut_factor`` is above 0 the iteration cuts the rows by
    the previous iteration's F (``cut_weights``).  ``rows_used`` (shard ->
    rows) keeps part of each shard: a fault planted in the reference."""
    estep, mstep = MODELS[cfg["superposition"]]
    H, Hp, gamma = cfg["H"], cfg["Hprime"], cfg["gamma"]
    block = BLOCK[cfg["superposition"]]
    W, pi, sigma = (prec.cast(init[k]) for k in ("W", "pi", "sigma"))
    out, F_rows = [], None
    for t in range(n_steps):
        sc = step_schedule(schedule, steps, t)
        if sc["Ncut_factor"] > 0 and F_rows is None:
            raise ValueError("the data cut needs a previous iteration's F")
        weights = (cut_weights(F_rows, pi, H, gamma, sc["Ncut_factor"])
                   if sc["Ncut_factor"] > 0 else None)
        Wt = W + sc["W_noise"] * prec.cast(noise(t)) if sc["W_noise"] else W

        def blocks():
            j = 0
            for y in shards:
                y = rows_used(y) if rows_used is not None else y
                for i in range(0, y.shape[0], block):
                    rows = y[i:i + block]
                    yield rows, (weights[j] if weights is not None else
                                 torch.ones(rows.shape[0], dtype=prec.dtype,
                                            device=rows.device))
                    j += 1
        sums = estep(blocks(), Wt, pi, sigma, sc["beta"], 1.0, Hp, gamma,
                     prec)
        F_rows = sums.pop("F_rows")
        W, pi, sigma = mstep(sums, Wt, pi, sigma, H, gamma, prec)
        out.append({"F_mean": float(sums["F"] / sums["n"]),
                    "Q_mean": float(sums["F_true"] / sums["n"]),
                    "W": W, "pi": pi, "sigma": sigma})
    return out


class LinearDecoder:
    """BSC posterior decode (beta = 1) in ``prec``: per block of rows F,
    the posterior mean, the top-L probabilities and their states as
    (B, L, H) binary vectors."""

    def __init__(self, W, pi, sigma, Hp, gamma, L: int, prec: Prec):
        self.prec, self.Hp, self.L = prec, Hp, L
        self.W = prec.cast(W)
        self.D, self.H = W.shape
        self.pi, self.s2 = prec.cast(pi), prec.cast(sigma) ** 2
        self.st = multi_states(Hp, gamma, W.device, prec.dtype)
        self.outer = (self.st[:, :, None] * self.st[:, None, :]).reshape(
            len(self.st), Hp * Hp)
        self.nact = self.st.sum(dim=1)
        self.G = prec.mm(self.W.T, self.W)
        self.g = torch.diagonal(self.G)
        self.lo = torch.log(self.pi) - torch.log1p(-self.pi)

    def __call__(self, y: torch.Tensor) -> Dict:
        prec, H, Hp, L, s2, lo = (self.prec, self.H, self.Hp, self.L,
                                  self.s2, self.lo)
        y = prec.cast(y)
        B = y.shape[0]
        P, cand = _front(y, self.W, torch.sqrt(self.g), Hp, prec)
        proj = P.gather(1, cand)
        Gc = self.G[cand[:, :, None], cand[:, None, :]].reshape(B, Hp * Hp)
        lik_m = (2.0 * prec.mm(proj, self.st.T)
                 - prec.mm(Gc, self.outer.T)) / (2 * s2)
        lik_s = (2.0 * P - self.g[None, :]) / (2 * s2)
        zero = torch.zeros((B, 1), dtype=prec.dtype, device=y.device)
        q, logZ = _softmax_parts(torch.cat(
            [zero, lik_s + lo, lik_m + self.nact * lo], dim=1))
        y2 = (y * y).sum(dim=1)
        qs, qm = q[:, 1:1 + H], q[:, 1 + H:]
        tq, tu = torch.topk(q, L, dim=1)
        dense = torch.zeros((B, L, H), dtype=prec.dtype, device=y.device)
        single = (tu >= 1) & (tu <= H)
        dense.scatter_(2, torch.clamp(tu - 1, 0, H - 1)[..., None],
                       single[..., None].to(prec.dtype))
        sm = (self.st[torch.clamp(tu - 1 - H, 0, len(self.st) - 1)]
              * (tu > H)[..., None])
        dense.scatter_add_(2, cand[:, None, :].expand(B, L, Hp), sm)
        return {"F": logZ + _f_const(y2, self.D, H, s2, self.pi, 1.0, 1.0),
                "s_mean": qs.scatter_add(1, cand, prec.mm(qm, self.st)),
                "top_probs": tq, "top_states": dense, "P": P, "logZ": logZ}

    def prob_of(self, ref: Dict, states: torch.Tensor) -> torch.Tensor:
        """(B, L) probabilities, under this side's posterior of the rows of
        ``ref`` (an output of ``__call__``), of (B, L, H) binary states."""
        s = self.prec.cast(states)
        lik = (2.0 * (s * ref["P"][:, None, :]).sum(dim=2)
               - (self.prec.mm(s, self.G) * s).sum(dim=2)) / (2 * self.s2)
        return torch.exp(lik + s.sum(dim=2) * self.lo - ref["logZ"][:, None])
