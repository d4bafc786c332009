"""Synthetic dictionaries and recovery scoring (host-side numpy).

Counterpart of ``prosper_tpu/data/bars.py``, plus ``planted_dictionary``
from ``examples/patches_scale_run.py``: the bars test (D = R^2 pixels, 2R
horizontal and vertical bars) and its scaled stand-in, a random sparse
dictionary on 16x16 patches.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def generate_bars_dict(H: int, neg_bars: bool = False,
                       intensity: float = 10.0) -> np.ndarray:
    """(D, H) dictionary of single-pixel-wide bars on an R x R grid, R = H//2.

    Columns 0..R-1 are horizontal bars, R..2R-1 vertical.  With
    ``neg_bars=True`` alternate bars are negative.
    """
    if H % 2 != 0:
        raise ValueError("H must be even (H = 2R bars)")
    R = H // 2
    W = np.zeros((R, R, H))
    for i in range(R):
        W[i, :, i] = intensity
        W[:, i, R + i] = intensity
    W = W.reshape(R * R, H)
    if neg_bars:
        W[:, 1::2] *= -1.0
    return W


def planted_dictionary(D: int, H: int, active_pixels: int = 8,
                       intensity: float = 10.0, seed: int = 0) -> np.ndarray:
    """Random sparse dictionary: each column lights a few random pixels
    (low coherence, so recoverable — the scaled stand-in for bars)."""
    rng = np.random.default_rng(seed)
    W = np.zeros((D, H), np.float32)
    for h in range(H):
        idx = rng.choice(D, size=active_pixels, replace=False)
        W[idx, h] = intensity
    return W


def cosine_match(W_learned: np.ndarray, W_true: np.ndarray,
                 signed: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Optimally assign learned columns to ground-truth columns (Hungarian
    on the cosine matrix).  Returns, per true column, the matched learned
    column and the cosine (|cosine| with ``signed=True``)."""
    Wl = np.asarray(W_learned, np.float64)
    Wt = np.asarray(W_true, np.float64)
    nl = np.linalg.norm(Wl, axis=0, keepdims=True) + 1e-12
    nt = np.linalg.norm(Wt, axis=0, keepdims=True) + 1e-12
    C = (Wt / nt).T @ (Wl / nl)
    score = np.abs(C) if signed else C
    rows, cols = linear_sum_assignment(-score)
    order = np.argsort(rows)
    rows, cols = rows[order], cols[order]
    return cols, score[rows, cols]


def count_recovered_bars(W_learned, W_true, threshold: float = 0.8,
                         signed: bool = False) -> int:
    """Number of ground-truth columns matched with cosine above threshold."""
    _, cosines = cosine_match(W_learned, W_true, signed=signed)
    return int(np.sum(cosines > threshold))


def bars_gt_params(model, intensity: float = 10.0, pi: float = None,
                   sigma: float = 1.0, neg_bars: bool = False) -> Dict:
    """Ground-truth numpy parameters for a bars test on ``model``; with
    H > 2R the bars occupy the first 2R columns and the rest are zero."""
    R = int(round(np.sqrt(model.D)))
    if R * R != model.D:
        raise ValueError(f"bars test needs square D, got D={model.D}")
    H_true = 2 * R
    if model.H < H_true:
        raise ValueError(f"model H={model.H} < number of bars {H_true}")
    W = np.zeros((model.D, model.H))
    W[:, :H_true] = generate_bars_dict(H_true, neg_bars=neg_bars,
                                       intensity=intensity)
    if pi is None:
        pi = 2.0 / model.H
    params = {"W": W.astype(np.float32), "pi": np.float32(pi),
              "sigma": np.float32(sigma)}
    if hasattr(model, "phi"):
        K = len(model.phi)
        params["pi"] = np.full((K,), pi / K, np.float32)
    return params
