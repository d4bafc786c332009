"""Mixture models: Mixture of Gaussians (MoG) and Mixture of Poissons (MoP).

Counterpart of ``prosper_tpu/models/mixtures.py``.  Classic EM mixtures on
the framework's EM loop and annealing: the step has the ET models'
(params, data, sched, generator) -> (params, F, scalars) contract, so
``EM.run`` and ``EM.run_scanned`` drive them unchanged.  The E-step is one
(N, K) softmax after an (N, D) x (D, K) product; the sufficient statistics
are two GEMMs.  Plain PyTorch on whatever device the tensors lie on.
With a process group (``MeshRuntime.shard_step``) each rank holds its own
rows, draws its own ``partial`` mask, and the sums and the valid count are
summed over the ranks in one all-reduce before the M-step.  A mixture has
no enumerated states: on a ``("data", "state")`` mesh its step takes the
data group alone and runs state-replicated, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from prosper_tpu_torch.core.select import exact_count_mask
from prosper_tpu_torch.models.base import device_sched, pattern_of, to_numpy
from prosper_tpu_torch.models.linear import reduce_sums
from prosper_tpu_torch.utils.staging import rows_to_device


class MixtureModel:
    """Shared EM machinery for K-component mixtures."""

    #: single-pass (N, K) E-step: no chunk-divisibility requirement
    requires_chunk_multiple = False

    param_names = ("pi",)

    def __init__(self, D: int, K: int, to_learn=None, chunk: int = 65536):
        self.D = int(D)
        self.K = int(K)
        self.to_learn = (tuple(to_learn) if to_learn is not None
                         else self.param_names)
        self.chunk = int(chunk)

    # -- subclass contract: component log-likelihoods and M-step --------------

    def component_loglik(self, params, y):
        """(N, K) log p(y | component k)."""
        raise NotImplementedError

    def m_step_components(self, params, sums, n_used):
        raise NotImplementedError

    def sample_component(self, params, comp, rng):
        raise NotImplementedError

    # -- shared step ----------------------------------------------------------

    def step_fn(self, params, data, sched, generator, group=None):
        """One EM iteration: the ``partial`` mask, responsibilities, the
        M-step.  Returns (new_params, F (N,), scalars).  A saturated step
        (beta == prior_beta == 1) skips the second logsumexp: F_true == F.
        ``group``: the process group the JAX package names ``axis_name``."""
        y = data["y"]
        valid = data["valid"]
        sched = device_sched(sched, y.device)
        pattern = pattern_of(sched)
        weight = (exact_count_mask(generator, y.shape[0], sched["partial"],
                                   valid=valid, group=group)
                  if pattern.partial else valid)

        log_pi = torch.log(torch.clamp(params["pi"], min=1e-12))
        ll = self.component_loglik(params, y)                       # (N, K)
        logits = sched["beta"] * ll + sched["prior_beta"] * log_pi[None, :]
        m = logits.max(dim=1, keepdim=True).values
        p = torch.exp(logits - m)
        Z = p.sum(dim=1, keepdim=True)
        r = p / Z * weight[:, None]                                 # (N, K)
        F = (m + torch.log(Z))[:, 0]
        F_true = (F if pattern.saturated
                  else torch.logsumexp(ll + log_pi[None, :], dim=1))

        sums = {
            "r": r.sum(dim=0),                                      # (K,)
            "ry": r.T @ y,                                          # (K, D)
            "ry2": r.T @ (y * y),
            "n": weight.sum(),
            "F": (F * weight).sum(),
            "F_true": (F_true * weight).sum(),
        }
        sums, N_total = reduce_sums(sums, valid.sum(), group)
        new = dict(params)
        n_used = torch.clamp(sums["n"], min=1.0)
        if "pi" in self.to_learn:
            pi = torch.clamp(sums["r"], min=1e-12)
            new["pi"] = pi / pi.sum()
        new.update(self.m_step_components(params, sums, n_used))
        scalars = {
            "F_total": sums["F"], "F_mean": sums["F"] / n_used,
            "Q": sums["F_true"], "Q_mean": sums["F_true"] / n_used,
            "n_used": sums["n"], "N_total": N_total,
        }
        return new, F, scalars

    # -- shared API (generation / init / inference) ---------------------------

    def generate_data(self, params, N: int, seed: int = 0) -> Dict:
        """N draws (host numpy): {'y': (N, D) float32, 's': the component of
        each row, 'valid': ones}; the JAX package's numbers for a seed."""
        rng = np.random.default_rng(seed)
        pi = to_numpy(params["pi"]).astype(np.float64)
        comp = rng.choice(self.K, size=N, p=pi / pi.sum())
        y = self.sample_component(params, comp, rng)
        return {"y": y.astype(np.float32), "s": comp,
                "valid": np.ones((N,), np.float32)}

    def standard_init(self, data: Dict, seed: int = 0,
                      device=None) -> Dict[str, torch.Tensor]:
        """K distinct rows of the data as seeds, pi = 1/K; drawn with numpy
        from ``seed``, so the same as the JAX package's.  The tensors go to
        ``device``, by default the device of ``data['y']`` when it is a
        tensor, else CUDA."""
        y_in = data["y"]
        if device is None:
            device = y_in.device if isinstance(y_in, torch.Tensor) else "cuda"
        rng = np.random.default_rng(seed)
        y = to_numpy(y_in).astype(np.float64)
        idx = rng.choice(y.shape[0], size=self.K, replace=False)
        params = {"pi": np.full((self.K,), 1.0 / self.K, np.float32)}
        params.update(self._init_components(y, y[idx], rng))
        return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                for k, v in params.items()}

    def inference(self, params, data):
        """Responsibilities ``resp`` (N, K), hard assignments ``assign``
        (N,) and F (N,), on the device of the parameters."""
        dev = params["pi"].device
        y = rows_to_device(data["y"], dev)
        ll = self.component_loglik(params, y)
        logp = ll + torch.log(torch.clamp(params["pi"], min=1e-12))[None, :]
        return {"resp": torch.softmax(logp, dim=1),
                "assign": torch.argmax(logp, dim=1),
                "F": torch.logsumexp(logp, dim=1)}


class MoG(MixtureModel):
    """Isotropic-per-component Gaussian mixture."""

    param_names = ("pi", "mu", "sigma")

    def component_loglik(self, params, y):
        mu = params["mu"]                                           # (K, D)
        sigma2 = params["sigma"][None, :] ** 2                      # (1, K)
        y2 = (y * y).sum(dim=1, keepdim=True)                       # (N, 1)
        cross = y @ mu.T                                            # (N, K)
        mu2 = (mu * mu).sum(dim=1)[None, :]
        dist2 = y2 - 2.0 * cross + mu2
        return (-0.5 * dist2 / sigma2
                - 0.5 * self.D * torch.log(2.0 * math.pi * sigma2))

    def m_step_components(self, params, sums, n_used):
        out = {}
        rk = torch.clamp(sums["r"], min=1e-8)[:, None]              # (K, 1)
        if "mu" in self.to_learn:
            out["mu"] = sums["ry"] / rk
        if "sigma" in self.to_learn:
            # residuals around the means in use (a frozen mu is not
            # replaced by the responsibility-weighted mean)
            mu = out.get("mu", params["mu"])
            ey2 = sums["ry2"].sum(dim=1)
            cross = (mu * sums["ry"]).sum(dim=1)
            mu2 = (mu * mu).sum(dim=1) * rk[:, 0]
            var = torch.clamp((ey2 - 2 * cross + mu2) / (rk[:, 0] * self.D),
                              min=1e-10)
            out["sigma"] = torch.sqrt(var)
        return out

    def _init_components(self, y, seeds, rng):
        return {"mu": seeds,
                "sigma": np.full((self.K,), float(y.std()) + 1e-3)}

    def sample_component(self, params, comp, rng):
        mu = to_numpy(params["mu"]).astype(np.float64)
        sigma = to_numpy(params["sigma"]).astype(np.float64)
        return mu[comp] + sigma[comp, None] * rng.standard_normal(
            (comp.shape[0], self.D))


class MoP(MixtureModel):
    """Mixture of independent Poissons (count data)."""

    param_names = ("pi", "lam")

    def component_loglik(self, params, y):
        lam = torch.clamp(params["lam"], min=1e-8)                  # (K, D)
        # sum_d [ y log lam - lam - log Gamma(y + 1) ]
        return (y @ torch.log(lam).T - lam.sum(dim=1)[None, :]
                - torch.lgamma(y + 1.0).sum(dim=1, keepdim=True))

    def m_step_components(self, params, sums, n_used):
        if "lam" not in self.to_learn:
            return {}
        rk = torch.clamp(sums["r"], min=1e-8)[:, None]
        return {"lam": torch.clamp(sums["ry"] / rk, min=1e-8)}

    def _init_components(self, y, seeds, rng):
        return {"lam": np.maximum(seeds, 0.1)}

    def sample_component(self, params, comp, rng):
        lam = to_numpy(params["lam"]).astype(np.float64)
        return rng.poisson(lam[comp]).astype(np.float64)
