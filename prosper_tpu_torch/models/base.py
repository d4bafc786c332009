"""Shared model machinery: static model configs and the ET data-selection
masks.

Counterpart of ``prosper_tpu/models/base.py``.  A model is a static config
object; parameters are a dict of tensors on one device, and every function
follows the device of the tensors it is given.  Randomness (parameter noise,
the ``partial`` mask) comes from an explicit ``torch.Generator`` on that
device.  The Ncut ranking uses the previous iteration's per-datapoint free
energies by default (one E-step pass); ``ncut_current`` ranks by the
current iteration's, at the price of a second pass while the cut is active.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from prosper_tpu_torch.core.etstep import truncated_prior_logmass
from prosper_tpu_torch.core.select import (exact_count_mask,
                                           global_quantile_threshold,
                                           ncut_keep_count)


def to_numpy(x) -> np.ndarray:
    """Host copy of a tensor or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ETModel:
    """Base class: static config and the shared EM-step pieces."""

    #: parameter names this model owns (subclasses extend)
    param_names: Tuple[str, ...] = ("W", "pi", "sigma")
    #: the chunked E-step needs data sizes that divide ``chunk`` (EM pads)
    requires_chunk_multiple: bool = True

    def __init__(self, D: int, H: int, Hprime: int, gamma: int,
                 to_learn: Optional[Sequence[str]] = None,
                 chunk: int = 2048):
        if not (0 < Hprime <= H):
            raise ValueError(f"need 0 < Hprime <= H, got {Hprime=} {H=}")
        if not (2 <= gamma <= Hprime):
            raise ValueError(
                f"need 2 <= gamma <= Hprime, got {gamma=} {Hprime=} — the "
                "zero and singleton states are handled analytically, so "
                "gamma < 2 would leave no enumerated states")
        self.D = int(D)
        self.H = int(H)
        self.Hprime = int(Hprime)
        self.gamma = int(gamma)
        self.to_learn = (tuple(to_learn) if to_learn is not None
                         else self.param_names)
        self.chunk = int(chunk)

    # -- subclass contract ----------------------------------------------------

    def generate_from_hidden(self, params: Dict, s: np.ndarray) -> np.ndarray:
        """Noise-free mean ybar given latent states (host-side numpy)."""
        raise NotImplementedError

    def sample_latents(self, params: Dict, N: int,
                       rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    # -- shared API -----------------------------------------------------------

    def generate_data(self, params: Dict, N: int, seed: int = 0) -> Dict:
        """Sample N datapoints from the generative model (host-side, f64).
        Returns numpy {'y': (N, D) f32, 's': latents, 'valid': ones}; the
        same numbers as the JAX package for the same seed."""
        rng = np.random.default_rng(seed)
        s = self.sample_latents(params, N, rng)
        ybar = self.generate_from_hidden(params, s)
        sigma = float(to_numpy(params["sigma"]))
        y = ybar + sigma * rng.standard_normal(ybar.shape)
        return {"y": y.astype(np.float32), "s": s,
                "valid": np.ones((N,), np.float32)}

    def standard_init(self, data: Dict, seed: int = 0,
                      device=None) -> Dict[str, torch.Tensor]:
        """Data-driven init: W from the data mean plus noise, sigma from the
        data std, pi = 1/H.  Drawn with numpy from ``seed``, so it is
        bit-identical to the JAX package's.  The tensors go to ``device``,
        by default the device of ``data['y']`` when it is a tensor, else
        CUDA."""
        y_in = data["y"]
        if device is None:
            device = y_in.device if isinstance(y_in, torch.Tensor) else "cuda"
        rng = np.random.default_rng(seed)
        y = to_numpy(y_in).astype(np.float64)
        mean = y.mean(axis=0)
        std = y.std()
        W = (mean[:, None]
             + (std / np.sqrt(self.H)) * rng.standard_normal((self.D, self.H)))

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        return {"W": t(W), "pi": t(np.float32(1.0 / self.H)),
                "sigma": t(np.float32(max(std, 1e-3)))}

    def noisify(self, params: Dict, sched: Dict,
                generator: torch.Generator) -> Dict:
        """Add the scheduled jitter to W, pi and sigma (noise is drawn only
        for channels whose std is non-zero)."""
        p = dict(params)

        def noise(x, std):
            if std == 0.0:
                return x
            return x + std * torch.randn(x.shape, generator=generator,
                                         device=x.device, dtype=x.dtype)
        p["W"] = noise(params["W"], sched["W_noise"])
        p["pi"] = torch.clamp(noise(params["pi"], sched["pi_noise"]),
                              1e-6, 1.0 - 1e-6)
        p["sigma"] = torch.clamp(noise(params["sigma"], sched["sigma_noise"]),
                                 min=1e-5)
        return p

    # -- the serving path ------------------------------------------------------

    #: ``inference(dense_states=None)`` returns the compact layout once the
    #: dense (N, top_L, H) tensor would exceed this many bytes
    DENSE_STATES_AUTO_BYTES: int = 128 * 1024 * 1024

    def resolve_dense_states(self, N: int, top_L: int, dense_states) -> bool:
        """None = dense for small batches, compact for large ones."""
        if dense_states is None:
            return (N * top_L * self.H * 4) <= self.DENSE_STATES_AUTO_BYTES
        return bool(dense_states)

    # -- shared ET data-selection masks ---------------------------------------

    def partial_mask(self, data, sched, generator) -> torch.Tensor:
        """Exact-count random subsampling mask (``partial`` channel)."""
        valid = data["valid"]
        if sched["partial"] >= 1.0:
            return valid
        return exact_count_mask(generator, valid.shape[0], sched["partial"],
                                valid=valid)

    def ncut_weight(self, pmask, F_rank, sched, logA) -> torch.Tensor:
        """The ET data cut on top of ``pmask``, ranking by ``F_rank``.  The
        keep count applies the ET fraction to the rows under consideration
        (sum of ``pmask``), not to all valid rows: with ``partial`` < 1 the
        two differ, and a keep count above the subset would make the cut a
        no-op."""
        keep = ncut_keep_count(pmask.sum(), sched["Ncut_factor"], logA)
        thresh = global_quantile_threshold(F_rank, pmask, keep)
        return pmask * (F_rank >= thresh).float()

    def run_estep_with_ncut(self, estep, log_pi_active, data, sched,
                            generator):
        """E-step orchestration for both Ncut semantics.  ``estep(weight)
        -> (F, sums)``.  Returns (F, sums, logA, logB, N_total)."""
        if not getattr(self, "ncut_current", False):
            weight, logA, logB, N_total = self.et_weight_mask(
                log_pi_active, data, sched, generator)
            F, sums = estep(weight)
            return F, sums, logA, logB, N_total

        pmask = self.partial_mask(data, sched, generator)
        logA, logB = truncated_prior_logmass(log_pi_active, self.H,
                                             self.gamma)
        N_total = data["valid"].sum()
        F, sums = estep(pmask)
        if sched["Ncut_factor"] > 0:
            sums = estep(self.ncut_weight(pmask, F, sched, logA))[1]
        return F, sums, logA, logB, N_total

    def et_weight_mask(self, log_pi_active, data, sched, generator):
        """Combined partial-subsampling + Ncut mask.
        Returns (weight (N,), logA, logB, N_total)."""
        pmask = self.partial_mask(data, sched, generator)
        logA, logB = truncated_prior_logmass(log_pi_active, self.H,
                                             self.gamma)
        N_total = data["valid"].sum()
        if sched["Ncut_factor"] > 0:
            weight = self.ncut_weight(pmask, data["F_prev"], sched, logA)
        else:
            weight = pmask
        return weight, logA, logB, N_total


def sched_floats(anneal) -> Dict[str, float]:
    """Annealing snapshot -> plain host floats, the step's scalars (the
    JAX package's ``sched_from_anneal`` turns these into traced scalars;
    eager PyTorch takes them as they are)."""
    s = anneal.as_scalars() if hasattr(anneal, "as_scalars") else dict(anneal)
    beta = float(s.get("beta", 1.0))
    anneal_prior = bool(s.get("anneal_prior", 0.0))
    return {
        "beta": beta,
        "prior_beta": beta if anneal_prior else 1.0,
        "Ncut_factor": float(s.get("Ncut_factor", 0.0)),
        "partial": float(s.get("partial", 1.0)),
        "W_noise": float(s.get("W_noise", 0.0)),
        "pi_noise": float(s.get("pi_noise", 0.0)),
        "sigma_noise": float(s.get("sigma_noise", 0.0)),
        "mu_noise": float(s.get("mu_noise", 0.0)),
        # softened-max exponent for MCA/MMCA responsibilities; <= 0 = hard max
        "rho": float(s.get("rho", 0.0)),
    }


def make_blank_data(y, valid=None, device=None) -> Dict[str, torch.Tensor]:
    """Wrap observations into the step's data dict (y, valid, F_prev) on
    ``device`` (default: y's device when it is a tensor, else CUDA)."""
    if device is None:
        device = y.device if isinstance(y, torch.Tensor) else "cuda"
    y = torch.as_tensor(to_numpy(y) if not isinstance(y, torch.Tensor) else y,
                        dtype=torch.float32, device=device)
    N = y.shape[0]
    if valid is None:
        valid = torch.ones(N, dtype=torch.float32, device=device)
    valid = torch.as_tensor(valid, dtype=torch.float32, device=device)
    return {"y": y, "valid": valid,
            "F_prev": torch.zeros(N, dtype=torch.float32, device=device)}
