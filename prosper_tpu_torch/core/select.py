"""Candidate pre-selection and data sub-selection (static shapes, masks).

Counterpart of ``prosper_tpu/core/select.py``:
  * top-H' candidate units per datapoint by the score P / ||W_h||,
  * ``partial`` as an exact-count random mask,
  * the ET ``Ncut`` cut as a free-energy threshold found by the same
    3-round, 128-bin histogram bisection as the JAX package, so the cut
    keeps the same rows.

Fractions and factors may be host numbers or 0-d tensors on the data's
device.  Given tensors, no function here makes a scalar on the host or
copies one to the device, so a step that calls them can be captured into a
CUDA graph.  With a process group (``parallel/mesh.py``) the threshold
reduces its extent and histograms over the ranks, and the exact-count mask
draws every rank's uniforms so that the generator moves alike on all of
them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from prosper_tpu_torch.parallel.mesh import maybe_pmax, maybe_psum


def top_hprime_candidates(P: torch.Tensor, w_norm: torch.Tensor, Hp: int,
                          signed: bool) -> torch.Tensor:
    """Per-datapoint top-H' candidate units, (N, Hp) int64.

    P : (N, H) projection y @ W; w_norm : (H,) column norms of W.
    ``signed`` scores by |correlation| (TSC/DSC).  Hp iterated argmaxes:
    descending score, ties to the lowest index (``torch.argmax`` returns
    the first maximal index, as ``jnp.argmax`` does).
    """
    score = P / torch.clamp(w_norm, min=1e-12)[None, :]
    if signed:
        score = score.abs()
    cands = []
    for _ in range(Hp):
        i = torch.argmax(score, dim=1, keepdim=True)
        cands.append(i)
        score = score.scatter(1, i, float("-inf"))
    return torch.cat(cands, dim=1)


def top_l_argmax(q: torch.Tensor, L: int):
    """Top-L of non-negative rows by L iterated argmaxes (descending value,
    lowest index first; a taken entry is knocked out to -1).
    Returns (top_q (N, L), top_u (N, L) int64)."""
    M = q.shape[1]
    if L > M:
        raise ValueError(f"top_L={L} exceeds the {M} posterior columns")
    vals, idxs = [], []
    s = q
    for _ in range(L):
        v, i = torch.max(s, dim=1, keepdim=True)
        vals.append(v)
        idxs.append(i)
        s = s.scatter(1, i, -1.0)
    return torch.cat(vals, dim=1), torch.cat(idxs, dim=1)


def exact_count_mask(generator: torch.Generator, N: int, frac,
                     valid: Optional[torch.Tensor] = None,
                     device=None, group=None) -> torch.Tensor:
    """Random {0,1} float mask with exactly ceil(frac * n_valid) ones;
    padding rows (valid == 0) never count and are never selected.

    With a process group of P ranks, each holding N rows, every rank draws
    P * N uniforms and takes the N of its rank: the masks differ per rank
    (the JAX package folds the rank into its key), the count is per rank,
    and the generator advances by the same amount on every rank whatever
    its number of valid rows, so the parameter noise drawn after it stays
    replicated."""
    device = valid.device if valid is not None else device
    P, r = ((1, 0) if group is None
            else (dist.get_world_size(group), dist.get_rank(group)))
    u = torch.rand(P * N, generator=generator, device=device)[r * N:
                                                              (r + 1) * N]
    if valid is not None:
        u = torch.where(valid > 0, u, torch.full_like(u, -1.0))
        n_valid = valid.sum()
    else:
        n_valid = torch.full((), float(N), device=device)
    k = torch.clamp(torch.ceil(frac * n_valid).long(), 1, N)
    sorted_u = torch.sort(u, descending=True).values
    # gathered by a tensor index: indexing with a 0-d tensor would read it
    # on the host
    thresh = sorted_u.gather(0, torch.clamp(k - 1, 0, N - 1).reshape(1))
    return ((u >= thresh) & (u >= 0)).float()


def _f64(x) -> torch.Tensor:
    """``x`` (a tensor where it lies, or a host number rounded to float32
    first) in float64."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.float32)
    return x.double()


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32, as XLA's fused multiply-add does
    it (the product of two float32 values is exact in float64)."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def global_quantile_threshold(values: torch.Tensor, valid: torch.Tensor,
                              keep_count: torch.Tensor, rounds: int = 3,
                              bins: int = 128, group=None) -> torch.Tensor:
    """Threshold t such that ~``keep_count`` of the valid ``values`` are
    >= t, by histogram bisection in float32 (accuracy range / bins**rounds).
    The arithmetic follows the JAX package step by step, including where
    XLA fuses a multiply-add, so both pick the same threshold.

    With a process group the values are this rank's and ``keep_count`` is
    global: the extent is reduced once (MIN of lo as the MAX of -lo, beside
    the MAX of hi) and each round's histogram is summed, so every rank
    derives the same threshold from device tensors alone (1 + ``rounds``
    all-reduces)."""
    big = torch.full((), 3e38, dtype=torch.float32, device=values.device)
    v = torch.where(valid > 0, values, -big)
    lo = torch.where(valid > 0, values, big).min()
    hi = v.max()
    if group is not None:
        ext = maybe_pmax(torch.stack([-lo, hi]), group)
        lo, hi = -ext[0], ext[1]
    hi = hi + torch.clamp(1e-6 * hi.abs(), min=1e-6)
    bidx = torch.arange(bins, device=values.device)
    w = valid.float()
    for _ in range(rounds):
        width = torch.clamp((hi - lo) / bins, min=1e-30)
        idx = torch.clamp(torch.floor((v - lo) / width), 0, bins - 1).long()
        hist = maybe_psum(torch.zeros(bins, dtype=torch.float32,
                                      device=values.device)
                          .index_add_(0, idx, w), group)
        tail = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])
        b_star = torch.where(tail >= keep_count, bidx,
                             torch.zeros_like(bidx)).max()
        lo = _fma(b_star, width, lo)
        hi = lo + width
    return lo


def ncut_keep_count(N_total, Ncut_factor, log_A_gamma) -> torch.Tensor:
    """Number of datapoints kept by the ET data cut: the kept fraction
    ramps from 1 down to A_gamma(pi) as ``Ncut_factor`` goes 0 -> 1."""
    A = torch.exp(log_A_gamma)
    frac = _fma(-(1.0 - A), Ncut_factor, 1.0)
    return torch.ceil(frac * N_total)
