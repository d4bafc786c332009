"""Operations and bytes of the algorithms the cells run, and the card's
peaks: the yardstick of the roofline shares and of ``mfu``.

A count is the algorithm's work, whatever implements it: each input byte
read once, each output byte written once, no recomputed operation.  A
multiply-add counts as two operations, a compare-select as one.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit).  Operations are divided by the dense peak of the fastest unit that
can give the configuration's precision:

* float32: 495 TFLOP/s, the TF32 tensor-core peak.  No float32-accurate
  product on this card runs above it: split into bf16 parts it needs at
  least three passes (under 330 TFLOP/s), and the float32 units give 67.
  A share of it cannot pass 100 % when a later change moves float32 work
  onto the tensor cores, as a share of the 67 TFLOP/s of the float32 units
  would.
* bfloat16 and float16 (a 16-bit ``compute_dtype``): 989 TFLOP/s.
* bytes: 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from math import comb
from typing import Dict

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12, "float16": 989e12}
PEAK_BYTES = 3.35e12


def n_states(Hp: int, gamma: int) -> int:
    """Binary states of 2..gamma active units among H' candidates."""
    return sum(comb(Hp, k) for k in range(2, gamma + 1))


def least_seconds(work: Dict[str, float], dtype: str) -> float:
    """The least time the card could take for ``work`` {flops, bytes}."""
    return max(work["flops"] / PEAK_FLOPS[dtype], work["bytes"] / PEAK_BYTES)


def linear_estep(N, D, H, Hp, S) -> Dict[str, float]:
    """BSC/TSC/DSC E-step over N rows: P = y W and xs = y^T <s> (2 N D H
    each); per row and multi state the logit (proj . s and Gram . s s^T:
    H' + H'^2 multiply-adds) and the moments (<s>, <s s^T>: again
    H' + H'^2), and the value count and |s| (2).  Reads y, the
    weights and W; writes F, xs and <s s^T>."""
    nx = Hp + Hp * Hp
    return {"flops": 4.0 * N * D * H + 2.0 * N * S * (2 * nx + 2),
            "bytes": 4.0 * (N * D + 2 * N + 2 * D * H + H * H)}


def max_estep(N, D, H, S) -> Dict[str, float]:
    """MCA/MMCA E-step over N rows: the two D x H products, and two passes
    over the (S, D) winner lattice per row (a compare-select and two
    multiply-adds for ybar and its likelihood; a compare-select and an add
    for the responsibilities).  Reads y, the weights and W; writes F, the
    numerator and the denominator of W (H x D each)."""
    return {"flops": 4.0 * N * D * H + 8.0 * N * S * D,
            "bytes": 4.0 * (N * D + 2 * N + D * H + 2 * H * D)}


def linear_mstep(D, H) -> Dict[str, float]:
    """W <- xs (ss + ridge)^-1 (LU, 2/3 H^3, and the solve, 2 H^2 D) and
    sigma's W^T W (2 D H^2); the E-step's Gram matrix W^T W (2 D H^2)."""
    return {"flops": 2.0 / 3.0 * H ** 3 + 2.0 * H * H * D + 4.0 * D * H * H,
            "bytes": 4.0 * (3 * D * H + 2 * H * H)}


def max_mstep(D, H) -> Dict[str, float]:
    """W <- numer / denom, one division per entry."""
    return {"flops": 1.0 * D * H, "bytes": 4.0 * 4 * D * H}


def linear_decode(N, D, H, Hp, S, L) -> Dict[str, float]:
    """BSC decode of N rows: P = y W (2 N D H), per row and multi state the
    logit (H' + H'^2 multiply-adds) and the posterior mean (H'); reads y
    and W, writes F, the mean (H), the top-L probabilities and states (2 L)
    and the candidates (H')."""
    return {"flops": 2.0 * N * D * H + 2.0 * N * S * (Hp + Hp * Hp + Hp),
            "bytes": 4.0 * (N * D + D * H + N * (1 + H + 2 * L + Hp))}


def linear_inference(N, D, H, Hp, S, L) -> Dict[str, float]:
    """A whole ``inference`` call: the decode, the Gram matrix (2 D H^2)
    and the reconstruction <s> W^T (2 N D H, written: N D)."""
    dec = linear_decode(N, D, H, Hp, S, L)
    return {"flops": dec["flops"] + 2.0 * D * H * H + 2.0 * N * D * H,
            "bytes": dec["bytes"] + 4.0 * N * D}


def train_iteration(cfg: Dict, N: int) -> Dict[str, float]:
    """One EM iteration of a configuration over N rows: E-step and M-step."""
    D, H, Hp, g = cfg["D"], cfg["H"], cfg["Hprime"], cfg["gamma"]
    S = n_states(Hp, g)
    if cfg["superposition"] == "linear":
        e, m = linear_estep(N, D, H, Hp, S), linear_mstep(D, H)
    elif cfg["superposition"] == "max":
        e, m = max_estep(N, D, H, S), max_mstep(D, H)
    else:
        raise ValueError(f"superposition {cfg['superposition']!r}: no count "
                         "of its iteration (linear or max)")
    return {k: e[k] + m[k] for k in e}
