"""GSC: spike-and-slab / Gaussian Sparse Coding.

Counterpart of ``prosper_tpu/models/gsc.py``.  s_h = b_h z_h with
b ~ Bernoulli(pi) and z ~ N(mu, psi); the E-step enumerates the binary
supports with the slab integrated out per support.  With
``backend="cuda"`` (the default) it goes through the family's route,
``ops/gsc_cuda.py::gsc_et_estep``: the kernel on a CUDA tensor (the JAX
package has no Pallas kernel for this family; the port's was written for
the card), the plain PyTorch version (``core/gscstep.py``) on a CPU
tensor, and a refusal for a model past the kernel's limits or a state axis
on a CUDA tensor.  ``backend="plain"`` runs the plain version on whatever
device the tensors lie on, which is how such a model trains on the card.
The M-step updates W, pi and sigma and the slab's mean and variance:

  W      <- (sum_n y <sz>^T)(sum_n <sz sz^T>)^-1      (least squares)
  pi     <- ET-corrected mean support size            (as BSC)
  sigma  <- residual formula with the new W
  mu     <- sum <s_h z_h> / sum <|s|>
  psi    <- sum <s_h z_h^2> / sum <|s|>  - 2 mu sum<s_h z_h>/sum<|s|> + mu^2
"""

from __future__ import annotations

import numpy as np
import torch

from prosper_tpu_torch.core.etstep import truncated_prior_logmass
from prosper_tpu_torch.core import gscstep
from prosper_tpu_torch.core.gscstep import gsc_posterior
from prosper_tpu_torch.core.states import binary_state_space
from prosper_tpu_torch.io.tracing import traced_region
from prosper_tpu_torch.models.base import (ETModel, device_sched, pattern_of,
                                           resolve_backend, sched_floats,
                                           to_numpy)
from prosper_tpu_torch.models.linear import reduce_sums, solve
from prosper_tpu_torch.ops.gsc_cuda import gsc_et_estep
from prosper_tpu_torch.parallel.mesh import check_runtime
from prosper_tpu_torch.utils.staging import rows_to_device


class GSC(ETModel):

    param_names = ("W", "pi", "sigma", "mu", "psi")

    def __init__(self, D, H, Hprime, gamma, to_learn=None, chunk=4096,
                 ncut_current: bool = False, backend: str = "cuda"):
        super().__init__(D, H, Hprime, gamma, to_learn, chunk)
        #: "cuda": the hand-written kernel on a CUDA tensor; "plain": the
        #: plain PyTorch version on any device.  A switch the caller sets,
        #: not a fallback.
        self.backend = resolve_backend(backend)
        self.space = binary_state_space(Hprime, gamma)
        #: rank the Ncut data cut by the current iteration's F with a
        #: second E-step pass while the cut is active (as the linear family)
        self.ncut_current = bool(ncut_current)

    def _extra_init(self, y, rng):
        return {"mu": np.float32(0.0), "psi": np.float32(1.0)}

    def log_pi_active(self, params):
        return torch.log(params["pi"])

    # -- the EM step ----------------------------------------------------------

    def estep_sums(self, params, y, weight, sched, state_axis=None,
                   n_state_shards: int = 1):
        """E-step over one block of data: (F (N,), sums).  ``params`` are
        already noisified; the caller owns the weight mask.  A saturated
        step skips the un-annealed channel (F_true == F there).  With
        ``backend="cuda"`` the route ``ops/gsc_cuda.py::gsc_et_estep`` picks
        the kernel or the plain version, or refuses; with
        ``backend="plain"`` the plain version.  Under a state axis
        (``state_axis``, ``n_state_shards > 1``) the plain version on this
        rank's level-aligned share of the supports (``core/gscstep.py``)."""
        W = params["W"]
        estep = (gscstep.gsc_et_estep if self.backend == "plain"
                 else gsc_et_estep)
        return estep(
            y, weight, W, params["sigma"] ** 2, params["pi"], params["mu"],
            params["psi"], self.state_arrays(W.device), self.Hprime,
            sched["beta"], sched["prior_beta"], self.chunk,
            collect_true=not pattern_of(sched).saturated,
            state_axis=state_axis, n_state_shards=n_state_shards)

    def step_fn(self, params, data, sched, generator, state_axis=None,
                n_state_shards: int = 1, group=None):
        """One EM iteration: noisify -> masks -> E-step -> M-step.
        Returns (new_params, F (N,), scalars); with a process group on this
        rank's rows and, under a state axis, its share of the supports
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

    def finalize_mstep(self, params, sums, N_total, group=None,
                       state_axis=None, n_state_shards: int = 1):
        """The slab M-step (W, pi, sigma, mu, psi) and the per-iteration
        scalars.  ``params`` is the noisified dict the E-step ran with; with
        a process group the sums and ``N_total`` are this rank's and are
        summed over the ranks first (``models/linear.py::reduce_sums``)."""
        sums, N_total = reduce_sums(sums, N_total, group, state_axis,
                                    n_state_shards)
        logA, logB = truncated_prior_logmass(self.log_pi_active(params),
                                             self.H, self.gamma)
        new = dict(params)
        n_used = torch.clamp(sums["n"], min=1.0)
        H = self.H
        if "W" in self.to_learn:
            ss = sums["ss"]
            ridge = 1e-6 * (torch.trace(ss) / H + 1.0)
            A = ss + ridge * torch.eye(H, dtype=ss.dtype, device=ss.device)
            new["W"] = solve(A, sums["xs"].T).T.contiguous()
        if "pi" in self.to_learn:
            mean_abs = sums["abs"] / n_used
            new["pi"] = torch.clamp(
                params["pi"] * torch.exp(logA - logB) * mean_abs,
                1e-6, 1.0 - 1e-6)
        if "sigma" in self.to_learn:
            W = new["W"]
            resid = (sums["y2"] - 2.0 * torch.sum(W * sums["xs"])
                     + torch.sum((W.T @ W) * sums["ss"]))
            new["sigma"] = torch.sqrt(torch.clamp(resid / (n_used * self.D),
                                                  min=1e-10))
        total_abs = torch.clamp(sums["abs"], min=1e-6)
        sum_z = torch.sum(sums["s"])
        sum_z2 = torch.trace(sums["ss"])
        if "mu" in self.to_learn:
            new["mu"] = sum_z / total_abs
        if "psi" in self.to_learn:
            mu_new = new["mu"]
            psi = (sum_z2 / total_abs - 2.0 * mu_new * sum_z / total_abs
                   + mu_new ** 2)
            new["psi"] = torch.clamp(psi, min=1e-6)
        scalars = {
            "F_total": sums["F"], "F_mean": sums["F"] / n_used,
            "Q": sums["F_true"], "Q_mean": sums["F_true"] / n_used,
            "n_used": sums["n"], "N_total": N_total,
        }
        return new, scalars

    # -- posterior decode (the serving path) ----------------------------------

    def inference(self, params, data, top_L: int = 10, anneal=None,
                  runtime=None, dense_states=None):
        """Posterior decode on held-out data, on the device of
        ``params['W']``: the top-L supports and their probabilities, the
        support posterior ``b_mean``, the slab means ``s_mean``, ``recon``
        and F.  ``dense_states``: True returns ``top_states (N, L, H)``,
        False the compact fields and ``cand``
        (``core.etstep.densify_top_states`` rebuilds the dense tensor),
        None picks by output size.  ``runtime``: this rank's rows on this
        rank's device (``MeshRuntime.shard_decode``)."""
        if runtime is not None:
            return check_runtime(runtime).shard_decode(
                lambda y, p: self.inference(p, {"y": y}, top_L, anneal,
                                            dense_states=dense_states))(
                data["y"], params)
        sched = sched_floats(anneal) if anneal is not None else None
        beta = sched["beta"] if sched else 1.0
        prior_beta = sched["prior_beta"] if sched else 1.0
        W = params["W"]
        y = data["y"]
        y = rows_to_device(y, W.device)
        dense_states = self.resolve_dense_states(y.shape[0], top_L,
                                                 dense_states)
        return gsc_posterior(
            y.contiguous(), W, params["sigma"] ** 2, params["pi"],
            params["mu"], params["psi"], self.state_arrays(W.device),
            self.Hprime, top_L, beta, prior_beta, chunk=self.chunk,
            dense_states=dense_states)

    # -- generation -----------------------------------------------------------

    def sample_latents(self, params, N, rng):
        pi = float(to_numpy(params["pi"]))
        mu = float(to_numpy(params.get("mu", 0.0)))
        psi = float(to_numpy(params.get("psi", 1.0)))
        b = (rng.random((N, self.H)) < pi)
        z = mu + np.sqrt(psi) * rng.standard_normal((N, self.H))
        return b * z

    def generate_from_hidden(self, params, s, rng=None):
        return s @ to_numpy(params["W"]).astype(np.float64).T
