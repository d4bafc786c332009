"""Operations and bytes of a GSC EM iteration (spike-and-slab sparse
coding), on the yardstick of ``counts.py``: the algorithm's work whatever
implements it, a multiply-add two operations, each input byte read once
and each output byte written once.

Per row, the E-step's work is

* P = y W and xs = y^T <sz>: D H multiply-adds each;
* the H singletons in closed form: the natural parameter, the mean and the
  log-likelihood (3 multiply-adds a unit) and the moments <sz>, <sz^2>
  (2);
* per support of m units among the H' candidates: the Cholesky factor of
  its m x m precision (m^3 / 3 multiply-adds), the solve for the mean
  (2 m^2), the inverse for the covariance (m^3), the log-determinant and
  b^T kappa (2 m), and the moments q kappa and q (Sigma + kappa kappa^T)
  (m + m (m + 1));
* the softmax over the 1 + H + S columns (one multiply-add a column);
* <sz> and <sz sz^T> from the candidate frame into H and H x H
  (H' + H'^2 adds).

It reads y, the weights and W and writes F, xs, <sz sz^T> and <sz>.  The
M-step is the linear family's (``counts.linear_mstep``: the LU solve for W,
sigma's W^T W and the E-step's Gram matrix) and the slab's mean and
variance (a sum and a trace, 2 H).
"""

from __future__ import annotations

from math import comb
from typing import Dict

from benchmark.metrics import counts


def support_madds(m: int) -> float:
    """Multiply-adds of one row's support of m units."""
    return m ** 3 / 3.0 + 2 * m * m + m ** 3 + 2 * m + m + m * (m + 1)


def gsc_estep(N, D, H, Hp, gamma) -> Dict[str, float]:
    """The GSC E-step over N rows."""
    supports = sum(comb(Hp, m) * support_madds(m)
                   for m in range(2, gamma + 1))
    S = counts.n_states(Hp, gamma)
    per_row = 2 * D * H + 5 * H + supports + (1 + H + S) + Hp + Hp * Hp
    return {"flops": 2.0 * N * per_row,
            "bytes": 4.0 * (N * D + 2 * N + 2 * D * H + H * H + H)}


def gsc_mstep(D, H) -> Dict[str, float]:
    m = counts.linear_mstep(D, H)
    return {"flops": m["flops"] + 2.0 * H, "bytes": m["bytes"]}


def train_iteration(cfg: Dict, N: int) -> Dict[str, float]:
    """One GSC EM iteration over N rows: E-step and M-step."""
    D, H = cfg["D"], cfg["H"]
    e = gsc_estep(N, D, H, cfg["Hprime"], cfg["gamma"])
    m = gsc_mstep(D, H)
    return {k: e[k] + m[k] for k in e}
