"""Maximal-causes models: MCA (max) and MMCA (max-magnitude).

Counterpart of ``prosper_tpu/models/mca.py``.  Binary latents with a
Bernoulli(pi) prior; the superposition is the pointwise max (MCA) or the
value of largest magnitude (MMCA); Gaussian observation noise.  The M-step
gives each observed dimension to its winning cause (``core/maxstep.py``):

    W_dh   <- sum_n <A_ndh y_nd> / sum_n <A_ndh>
    pi     <- ET-corrected mean activity      (as BSC)
    sigma  <- sqrt( sum <||y - ybar_s||^2> / (N_use * D) )

With ``backend="cuda"`` (the default; the JAX package's "pallas" is taken
for it) the E-step goes through the family's route,
``ops/max_cuda.py::max_et_estep``, which picks the fused CUDA kernel (the
hard winner on a CUDA tensor) or the plain version (the softened max, rho >
0, and a CPU tensor), or refuses (a state axis on a CUDA tensor: the kernel
needs the whole subset lattice).  ``backend="plain"`` (or "xla") runs the
plain version on whatever device the tensors lie on, which is also how a
state space larger than the kernel holds (H' > 8 or more than 128 multi
states) and a state axis train on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from prosper_tpu_torch.core import maxstep
from prosper_tpu_torch.core.etstep import truncated_prior_logmass
from prosper_tpu_torch.core.states import binary_state_space
from prosper_tpu_torch.io.tracing import traced_region
from prosper_tpu_torch.models.base import (ETModel, device_sched, pattern_of,
                                           resolve_backend, sched_floats,
                                           to_numpy)
from prosper_tpu_torch.models.linear import reduce_sums
from prosper_tpu_torch.ops import max_cuda
from prosper_tpu_torch.parallel.mesh import check_runtime
from prosper_tpu_torch.utils.staging import rows_to_device


class MCA(ETModel):
    """Maximal Causes Analysis: ybar_d = max over active h of W_dh."""

    #: |W|-ranked winner (MMCA) vs plain value max (MCA)
    magnitude: bool = False

    def __init__(self, D, H, Hprime, gamma, to_learn=None, chunk=2048,
                 ncut_current: bool = False, backend: str = "cuda"):
        super().__init__(D, H, Hprime, gamma, to_learn, chunk)
        #: "cuda": the hand-written kernel on a CUDA tensor (hard winner);
        #: "plain": the plain PyTorch version on any device.  A switch the
        #: caller sets, not a fallback.
        self.backend = resolve_backend(backend)
        self.space = binary_state_space(Hprime, gamma)
        #: rank the Ncut data cut by the current iteration's F with a
        #: second E-step pass while the cut is active (as the linear family)
        self.ncut_current = bool(ncut_current)

    # -- prior helpers --------------------------------------------------------

    def _log_odds(self, params) -> torch.Tensor:
        pi = params["pi"]
        return torch.log(pi) - torch.log1p(-pi)

    def log_pi_active(self, params) -> torch.Tensor:
        return torch.log(params["pi"])

    # -- the EM step ----------------------------------------------------------

    def estep_sums(self, params, y, weight, sched, state_axis=None,
                   n_state_shards: int = 1):
        """E-step over one block of data: (F (N,), sums).  rho > 0 runs the
        softened max, rho <= 0 the hard winner; with ``backend="cuda"`` the
        route ``ops/max_cuda.py::max_et_estep`` picks the kernel or the
        plain version, or refuses, and ``backend="plain"`` runs the plain
        version.  A saturated step skips the un-annealed channel (F_true ==
        F there).  Under a state axis the plain loop form on this rank's
        slice."""
        W = params["W"]
        pattern = pattern_of(sched)
        estep = (max_cuda.max_et_estep if self.backend == "cuda"
                 else maxstep.max_et_estep)
        return estep(y, weight, W, params["sigma"] ** 2,
                     self._log_odds(params), self.state_arrays(W.device),
                     self.Hprime, self.magnitude, sched["beta"],
                     sched["prior_beta"], chunk=self.chunk,
                     rho=sched["rho"] if pattern.soft else None,
                     collect_true=not pattern.saturated,
                     state_axis=state_axis, n_state_shards=n_state_shards)

    def finalize_mstep(self, params, sums, N_total, group=None,
                       state_axis=None, n_state_shards: int = 1):
        """Winner-responsibility M-step and the per-iteration scalars.
        ``params`` is the noisified dict the E-step ran with; with a
        process group the sums and ``N_total`` are this rank's and are
        summed over the ranks first (``models/linear.py::reduce_sums``)."""
        sums, N_total = reduce_sums(sums, N_total, group, state_axis,
                                    n_state_shards)
        logA, logB = truncated_prior_logmass(self.log_pi_active(params),
                                             self.H, self.gamma)
        new = dict(params)
        n_used = torch.clamp(sums["n"], min=1.0)
        if "W" in self.to_learn:
            denom = sums["denom"]                                     # (H, D)
            new["W"] = torch.where(
                denom > 1e-6, sums["numer"] / torch.clamp(denom, min=1e-6),
                params["W"].T).T.contiguous()
        if "pi" in self.to_learn:
            mean_abs = sums["abs"] / n_used
            pi = params["pi"] * torch.exp(logA - logB) * mean_abs
            new["pi"] = torch.clamp(pi, 1e-6, 1.0 - 1e-6)
        if "sigma" in self.to_learn:
            sigma2 = torch.clamp(sums["resid"] / (n_used * self.D), min=1e-10)
            new["sigma"] = torch.sqrt(sigma2)
        scalars = {
            "F_total": sums["F"], "F_mean": sums["F"] / n_used,
            "Q": sums["F_true"], "Q_mean": sums["F_true"] / n_used,
            "n_used": sums["n"], "N_total": N_total,
        }
        return new, scalars

    def step_fn(self, params, data, sched, generator, state_axis=None,
                n_state_shards: int = 1, group=None):
        """One EM iteration: noisify -> masks -> E-step -> M-step.
        Returns (new_params, F (N,), scalars); with a process group on this
        rank's rows and, under a state axis, its slice of the states
        (``LinearETModel.step_fn``)."""
        y = data["y"]
        sched = device_sched(sched, y.device)
        params = self.noisify(params, sched, generator)

        def estep(weight):
            with traced_region("estep"):
                return self.estep_sums(params, y, weight, sched, state_axis,
                                       n_state_shards)

        F, sums, _, _, N_total = self.run_estep_with_ncut(
            estep, self.log_pi_active(params), data, sched, generator, group)
        with traced_region("mstep"):
            new, scalars = self.finalize_mstep(params, sums, N_total, group,
                                               state_axis, n_state_shards)
        return new, F, scalars

    # -- generation -----------------------------------------------------------

    def sample_latents(self, params, N, rng):
        pi = float(to_numpy(params["pi"]))
        return (rng.random((N, self.H)) < pi).astype(np.float64)

    def generate_from_hidden(self, params, s, rng=None, block: int = 4096):
        """The winner over each row's active units only (rows hold few), in
        blocks of rows: the same numbers as the JAX package's (N, D, H)
        formulation, which does not fit in memory at patches width.  Ties
        go to the lowest unit."""
        WT = to_numpy(params["W"]).astype(np.float64).T                # (H, D)
        act = s > 0.5
        k = max(int(act.sum(axis=1).max()), 1)
        units = np.argsort(~act, axis=1, kind="stable")[:, :k]  # active first
        live = np.take_along_axis(act, units, axis=1)                 # (N, k)
        ybar = np.zeros((s.shape[0], WT.shape[1]))
        for i in range(0, s.shape[0], block):
            vals = WT[units[i:i + block]]                              # (b,k,D)
            key = np.abs(vals) if self.magnitude else vals
            key = np.where(live[i:i + block, :, None], key, -np.inf)
            win = key.argmax(axis=1)[:, None, :]
            ybar[i:i + block] = np.take_along_axis(vals, win, axis=1)[:, 0]
        ybar[~act.any(axis=1)] = 0.0
        return ybar

    # -- posterior decode (the serving path) ----------------------------------

    def inference(self, params, data, top_L: int = 10, anneal=None,
                  dense_states=None, runtime=None):
        """Posterior decode on held-out data (plain PyTorch: the JAX
        package has no decode kernel for this family), on the device of
        ``params['W']``.  Same output contract as the linear family's
        ``inference``, with the canonical union index 0 = zero state,
        1 + h = singleton, 1 + H + s = multi state.  ``runtime``: this
        rank's rows on this rank's device (``MeshRuntime.shard_decode``)."""
        if runtime is not None:
            return check_runtime(runtime).shard_decode(
                lambda y, p: self.inference(p, {"y": y}, top_L, anneal,
                                            dense_states))(data["y"], params)
        sched = sched_floats(anneal) if anneal is not None else None
        beta = sched["beta"] if sched else 1.0
        prior_beta = sched["prior_beta"] if sched else 1.0
        W = params["W"]
        y = data["y"]
        y = rows_to_device(y, W.device)
        dense_states = self.resolve_dense_states(y.shape[0], top_L,
                                                 dense_states)
        return maxstep.max_et_posterior(
            y.contiguous(), W, params["sigma"] ** 2, self._log_odds(params),
            self.state_arrays(W.device), self.Hprime, self.magnitude, top_L,
            beta, prior_beta, chunk=self.chunk, dense_states=dense_states)


class MMCA(MCA):
    """Max-magnitude causes: the winning cause has the largest |W_dh|
    (the signed variant of MCA for zero-mean data)."""

    magnitude = True
