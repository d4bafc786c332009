"""Linear-superposition ET models: BSC, TSC, DSC.

Counterpart of ``prosper_tpu/models/linear.py``.  All three share
``ybar = W @ s`` with isotropic Gaussian noise and a factorised discrete
prior; they differ in the per-unit value set and the prior:

  BSC:  s_h in {0, 1},       p(s_h=1) = pi                    (scalar pi)
  TSC:  s_h in {-1, 0, +1},  p(s_h=±1) = pi/2                 (scalar pi)
  DSC:  s_h in {0} ∪ Phi,    p(s_h=phi_k) = pi_k              (vector pi)

The E-step runs a CUDA kernel on a CUDA tensor (the fused E-step, or with
``s_block > 0`` the big-S one) and its plain version on a CPU tensor
(``ops/linear_cuda.py``); the M-step is closed form:

  W     <- (sum_n y <s>^T) (sum_n <s s^T>)^-1
  pi    <- pi * (A_gamma/B_gamma) * mean<|s|>        (ET truncation correction)
  sigma <- sqrt( sum<||y - W s||^2> / (N_use * D) )
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from prosper_tpu_torch.core import states as states_mod
from prosper_tpu_torch.core.etstep import (LinearStateArrays,
                                           linear_et_posterior,
                                           linear_et_posterior_kernel,
                                           state_arrays_from,
                                           truncated_prior_logmass)
from prosper_tpu_torch.models.base import ETModel, sched_floats, to_numpy
from prosper_tpu_torch.ops.linear_cuda import linear_et_estep


def not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to prosper_tpu_torch yet "
        f"(ROADMAP.md, open item: {item})")


def _no_state_sharding(state_axis, n_state_shards):
    if state_axis is not None or n_state_shards != 1:
        raise not_ported("state sharding (state_axis, n_state_shards)",
                         "distributed")


class LinearETModel(ETModel):
    """Shared EM step for the linear family."""

    #: candidate scoring uses |corr| when latents may be negative
    signed_select: bool = False

    def __init__(self, D, H, Hprime, gamma, values, to_learn=None,
                 chunk=2048, min_active: int = 2, ncut_current: bool = False,
                 s_block: int = 0, compute_dtype=None):
        super().__init__(D, H, Hprime, gamma, to_learn, chunk)
        #: big-S mode: the S multi states in s_block tiles with an online
        #: logsumexp (core/etstep.py::_chunk_estats_bigs), for state spaces
        #: too large for the fused kernel; 0 = off
        self.s_block = int(s_block)
        if compute_dtype is not None:
            raise not_ported("compute_dtype",
                             "DSC learned Phi, compute_dtype and partial "
                             "parity")
        #: rank the Ncut data cut by the current iteration's F (reference
        #: semantics) with a second E-step pass while the cut is active;
        #: the default ranks by the previous iteration's F
        self.ncut_current = bool(ncut_current)
        self.space = states_mod.discrete_state_space(
            Hprime, gamma, values, min_active=min_active)
        self._sa: Dict[torch.device, LinearStateArrays] = {}

    def state_arrays(self, device) -> LinearStateArrays:
        """The enumerated state tables on ``device`` (built once each)."""
        device = torch.device(device)
        if device not in self._sa:
            self._sa[device] = state_arrays_from(self.space, device)
        return self._sa[device]

    # -- prior hooks (subclass contract) --------------------------------------

    def log_odds(self, params) -> torch.Tensor:
        """(K,) log p(value_k) - log p(0)."""
        raise NotImplementedError

    def log_pi_active(self, params) -> torch.Tensor:
        """log P(unit active), for the ET A/B corrections."""
        raise NotImplementedError

    def update_prior(self, params, sums, n_used, logA, logB) -> Dict:
        raise NotImplementedError

    # -- the EM step ----------------------------------------------------------

    def estep_sums(self, params, y, weight, sched, saturated: bool = False,
                   state_axis=None, n_state_shards: int = 1):
        """E-step over one block of data: (F (N,), sums).  ``params`` are
        already noisified; the caller owns the weight mask.  On a CUDA
        tensor this always launches a kernel: the fused E-step, or the big-S
        one when ``s_block > 0``."""
        _no_state_sharding(state_axis, n_state_shards)
        W = params["W"]
        return linear_et_estep(
            y, weight, W, params["sigma"] ** 2, self.log_odds(params),
            self.state_arrays(W.device), self.Hprime, self.signed_select,
            sched["beta"], sched["prior_beta"], chunk=self.chunk,
            collect_true=not saturated, s_block=self.s_block)

    def finalize_mstep(self, params, sums, N_total):
        """Closed-form M-step and the per-iteration scalars (0-d tensors).
        ``params`` is the noisified dict the E-step ran with."""
        logA, logB = truncated_prior_logmass(self.log_pi_active(params),
                                             self.H, self.gamma)
        new_params = self.m_step(params, sums, logA, logB)
        n_used = torch.clamp(sums["n"], min=1.0)
        scalars = {
            "F_total": sums["F"],
            "F_mean": sums["F"] / n_used,
            "Q": sums["F_true"],                 # un-annealed free energy
            "Q_mean": sums["F_true"] / n_used,
            "n_used": sums["n"],
            "N_total": N_total,
        }
        return new_params, scalars

    def step_fn(self, params, data, sched, generator,
                saturated: bool = False, state_axis=None,
                n_state_shards: int = 1):
        """One EM iteration: noisify -> masks -> E-step -> M-step.
        ``saturated`` asserts beta == prior_beta == 1, which lets the
        E-step skip the un-annealed channel (F_true == F there); the
        parameters come out bit-identical either way.
        Returns (new_params, F (N,), scalars)."""
        _no_state_sharding(state_axis, n_state_shards)
        y = data["y"]
        params = self.noisify(params, sched, generator)

        def estep(weight):
            return self.estep_sums(params, y, weight, sched, saturated)

        F, sums, logA, logB, N_total = self.run_estep_with_ncut(
            estep, self.log_pi_active(params), data, sched, generator)
        new_params, scalars = self.finalize_mstep(params, sums, N_total)
        return new_params, F, scalars

    def m_step(self, params, sums, logA, logB):
        H = self.H
        n_used = torch.clamp(sums["n"], min=1.0)
        new = dict(params)
        if "W" in self.to_learn:
            ss = sums["ss"]
            ridge = 1e-6 * (torch.trace(ss) / H + 1.0)
            A = ss + ridge * torch.eye(H, dtype=ss.dtype, device=ss.device)
            new["W"] = torch.linalg.solve(A, sums["xs"].T).T.contiguous()
        if "pi" in self.to_learn:
            new.update(self.update_prior(params, sums, n_used, logA, logB))
        if "sigma" in self.to_learn:
            W = new["W"]
            resid = (sums["y2"] - 2.0 * torch.sum(W * sums["xs"])
                     + torch.sum((W.T @ W) * sums["ss"]))
            sigma2 = torch.clamp(resid / (n_used * self.D), min=1e-10)
            new["sigma"] = torch.sqrt(sigma2)
        return new

    def generate_from_hidden(self, params, s):
        return s @ to_numpy(params["W"]).astype(np.float64).T

    # -- posterior decode (the serving path) ----------------------------------

    def inference(self, params, data, top_L: int = 10, anneal=None,
                  dense_states=None, runtime=None):
        """Posterior decode on held-out data: top states, probabilities,
        posterior mean, reconstruction and F, on the device of
        ``params['W']``; on a CUDA device through the fused decode kernel,
        except for a big-S model (``s_block > 0``), which decodes through
        the plain ``linear_et_posterior`` on any device, as the JAX package
        keeps big-S models off its fused decode.
        ``dense_states``: True returns ``top_states (N, L, H)``, False the
        compact fields (``core.etstep.densify_top_states`` rebuilds the
        dense tensor), None picks by output size."""
        if runtime is not None:
            raise not_ported("runtime (sharded serving)",
                             "GSC, mixtures, recovery protocol, streaming, "
                             "distributed, CLI/IO")
        sched = sched_floats(anneal) if anneal is not None else None
        beta = sched["beta"] if sched else 1.0
        prior_beta = sched["prior_beta"] if sched else 1.0
        W = params["W"]
        y = data["y"]
        y = (y.to(W.device, torch.float32) if isinstance(y, torch.Tensor)
             else torch.as_tensor(np.asarray(y, np.float32), device=W.device))
        dense_states = self.resolve_dense_states(y.shape[0], top_L,
                                                 dense_states)
        decode = (linear_et_posterior if self.s_block > 0
                  else linear_et_posterior_kernel)
        return decode(
            y.contiguous(), W, params["sigma"] ** 2, self.log_odds(params),
            self.state_arrays(W.device), self.Hprime, self.signed_select,
            top_L, beta, prior_beta, dense_states=dense_states)


class BSC(LinearETModel):
    """Binary Sparse Coding with Expectation Truncation."""

    signed_select = False

    def __init__(self, D, H, Hprime, gamma, to_learn=None, chunk=2048,
                 ncut_current: bool = False, s_block: int = 0,
                 compute_dtype=None):
        super().__init__(D, H, Hprime, gamma, values=[1.0],
                         to_learn=to_learn, chunk=chunk,
                         ncut_current=ncut_current, s_block=s_block,
                         compute_dtype=compute_dtype)

    def log_odds(self, params):
        pi = params["pi"]
        return (torch.log(pi) - torch.log1p(-pi)).reshape(1)

    def log_pi_active(self, params):
        return torch.log(params["pi"])

    def update_prior(self, params, sums, n_used, logA, logB):
        mean_abs = sums["abs"] / n_used
        pi = params["pi"] * torch.exp(logA - logB) * mean_abs
        return {"pi": torch.clamp(pi, 1e-6, 1.0 - 1e-6)}

    def sample_latents(self, params, N, rng):
        pi = float(to_numpy(params["pi"]))
        return (rng.random((N, self.H)) < pi).astype(np.float64)


class TSC(LinearETModel):
    """Ternary Sparse Coding: latents in {-1, 0, +1}, symmetric prior pi/2."""

    signed_select = True

    def __init__(self, D, H, Hprime, gamma, to_learn=None, chunk=2048,
                 ncut_current: bool = False, s_block: int = 0,
                 compute_dtype=None):
        super().__init__(D, H, Hprime, gamma, values=[-1.0, 1.0],
                         to_learn=to_learn, chunk=chunk,
                         ncut_current=ncut_current, s_block=s_block,
                         compute_dtype=compute_dtype)

    def log_odds(self, params):
        pi = params["pi"]
        lo = torch.log(pi / 2.0) - torch.log1p(-pi)
        return torch.stack([lo, lo])

    def log_pi_active(self, params):
        return torch.log(params["pi"])

    def update_prior(self, params, sums, n_used, logA, logB):
        mean_abs = sums["abs"] / n_used
        pi = params["pi"] * torch.exp(logA - logB) * mean_abs
        return {"pi": torch.clamp(pi, 1e-6, 1.0 - 1e-6)}

    def sample_latents(self, params, N, rng):
        pi = float(to_numpy(params["pi"]))
        u = rng.random((N, self.H))
        s = np.zeros((N, self.H))
        s[u < pi / 2] = -1.0
        s[(u >= pi / 2) & (u < pi)] = 1.0
        return s


class DSC(LinearETModel):
    """Discrete Sparse Coding: latents from {0} ∪ Phi with a learned pi
    vector (``params['pi']`` is (K,); p(0) = 1 - sum(pi)).  Phi is a fixed
    config here; learning it is not ported yet."""

    signed_select = True

    def __init__(self, D, H, Hprime, gamma, phi=(-1.0, 1.0, 2.0),
                 to_learn=None, chunk=2048, ncut_current: bool = False,
                 s_block: int = 0, compute_dtype=None):
        if to_learn is not None and "phi" in to_learn:
            raise not_ported("learning Phi (to_learn with 'phi')",
                             "DSC learned Phi, compute_dtype and partial "
                             "parity")
        super().__init__(D, H, Hprime, gamma, values=list(phi),
                         to_learn=to_learn, chunk=chunk,
                         ncut_current=ncut_current, s_block=s_block,
                         compute_dtype=compute_dtype)
        self.phi = np.asarray(phi, np.float64)

    def standard_init(self, data, seed: int = 0, device=None):
        params = super().standard_init(data, seed, device)
        K = len(self.phi)
        params["pi"] = torch.full((K,), 1.0 / (self.H * K),
                                  dtype=torch.float32,
                                  device=params["W"].device)
        return params

    def log_odds(self, params):
        pi = params["pi"]
        p0 = torch.clamp(1.0 - torch.sum(pi), min=1e-6)
        return torch.log(pi) - torch.log(p0)

    def log_pi_active(self, params):
        return torch.log(torch.clamp(torch.sum(params["pi"]), 1e-8,
                                     1.0 - 1e-8))

    def update_prior(self, params, sums, n_used, logA, logB):
        mean_abs = sums["abs"] / n_used
        pi_act = torch.clamp(torch.sum(params["pi"]), 1e-8, 1.0 - 1e-8)
        pi_act_new = torch.clamp(pi_act * torch.exp(logA - logB) * mean_abs,
                                 1e-6, 1.0 - 1e-6)
        vc = torch.clamp(sums["vc"], min=1e-12)
        return {"pi": pi_act_new * vc / torch.sum(vc)}

    def sample_latents(self, params, N, rng):
        pi = to_numpy(params["pi"]).astype(np.float64)
        p0 = max(1.0 - pi.sum(), 0.0)
        probs = np.concatenate([[p0], pi])
        probs = probs / probs.sum()
        vals = np.concatenate([[0.0], self.phi])
        idx = rng.choice(len(vals), size=(N, self.H), p=probs)
        return vals[idx]
