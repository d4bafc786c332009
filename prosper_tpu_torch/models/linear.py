"""Linear-superposition ET models: BSC, TSC, DSC.

Counterpart of ``prosper_tpu/models/linear.py``.  All three share
``ybar = W @ s`` with isotropic Gaussian noise and a factorised discrete
prior; they differ in the per-unit value set and the prior:

  BSC:  s_h in {0, 1},       p(s_h=1) = pi                    (scalar pi)
  TSC:  s_h in {-1, 0, +1},  p(s_h=±1) = pi/2                 (scalar pi)
  DSC:  s_h in {0} ∪ Phi,    p(s_h=phi_k) = pi_k              (vector pi)

With ``backend="cuda"`` (the default; the JAX package's name "pallas" is
taken for it) the E-step runs a CUDA kernel on a CUDA tensor (the fused
E-step, or with ``s_block > 0`` the big-S one) and its plain version on a
CPU tensor (``ops/linear_cuda.py``); with ``backend="plain"`` (or "xla") it
runs the plain version on whatever device the tensors lie on, which is
also how a model wider than a kernel's limits trains on the card, and DSC
with a learned value set, whose sums no kernel collects.  The M-step is
closed form:

  W     <- (sum_n y <s>^T) (sum_n <s s^T>)^-1
  pi    <- pi * (A_gamma/B_gamma) * mean<|s|>        (ET truncation correction)
  sigma <- sqrt( sum<||y - W s||^2> / (N_use * D) )
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from prosper_tpu_torch.core import etstep
from prosper_tpu_torch.core import states as states_mod
from prosper_tpu_torch.core.etstep import (LinearStateArrays,
                                           linear_et_posterior,
                                           linear_et_posterior_kernel,
                                           traced_state_arrays,
                                           truncated_prior_logmass)
from prosper_tpu_torch.models.base import (ETModel, device_sched,
                                           pattern_of, resolve_backend,
                                           sched_floats, to_numpy)
from prosper_tpu_torch.ops.linear_cuda import linear_et_estep
from prosper_tpu_torch.parallel.mesh import (check_runtime, psum_dict,
                                             state_rank, state_sharded)
from prosper_tpu_torch.utils.staging import rows_to_device


def not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to prosper_tpu_torch yet "
        f"(ROADMAP.md, open item: {item})")


def solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^-1 B by LU without the solver's host-side check of its status
    (``torch.linalg.solve`` reads it on the host, which a CUDA graph
    capture cannot do); the matrices the M-steps hand it are symmetric
    positive definite by their ridge."""
    return torch.linalg.solve_ex(A, B, check_errors=False).result


def reduce_sums(sums: Dict, N_total, group, state_axis=None,
                n_state_shards: int = 1):
    """(sums, N_total) summed over the ranks of ``group`` (the data group)
    in one all-reduce (``parallel/mesh.py::psum_dict``); as they are
    without a group.  Under a state axis the sums are this state rank's
    part and are summed over the state group as well (a second all-reduce;
    the two together are the sum over the whole mesh), with ``N_total``
    counted on state rank 0 alone: each data shard's rows count once, as
    the JAX package keeps ``N_total`` out of its state psum."""
    sharded = state_sharded(state_axis, n_state_shards)
    if group is None and not sharded:
        return sums, N_total
    if sharded:
        N_total = N_total * float(state_rank(state_axis) == 0)
    out = psum_dict(dict(sums, N_total=N_total), group)
    if sharded:
        out = psum_dict(out, state_axis)
    return {k: out[k] for k in sums}, out["N_total"]


class LinearETModel(ETModel):
    """Shared EM step for the linear family."""

    #: candidate scoring uses |corr| when latents may be negative
    signed_select: bool = False

    def __init__(self, D, H, Hprime, gamma, values, to_learn=None,
                 chunk=2048, min_active: int = 2, ncut_current: bool = False,
                 s_block: int = 0, compute_dtype=None, backend: str = "cuda"):
        super().__init__(D, H, Hprime, gamma, to_learn, chunk)
        #: "cuda": the hand-written kernels on a CUDA tensor; "plain": the
        #: plain PyTorch version on any device.  A switch the caller sets,
        #: not a fallback: with "cuda" a kernel that does not hold the
        #: model, or fails to build or launch, raises.
        self.backend = resolve_backend(backend)
        #: big-S mode: the S multi states in s_block tiles with an online
        #: logsumexp (core/etstep.py::_chunk_estats_bigs), for state spaces
        #: too large for the fused kernel; 0 = off
        self.s_block = int(s_block)
        if compute_dtype is not None:
            raise not_ported("compute_dtype",
                             "compute_dtype and the tensor cores")
        #: rank the Ncut data cut by the current iteration's F (reference
        #: semantics) with a second E-step pass while the cut is active;
        #: the default ranks by the previous iteration's F
        self.ncut_current = bool(ncut_current)
        self.space = states_mod.discrete_state_space(
            Hprime, gamma, values, min_active=min_active)
        #: DSC sets this when the value set Phi is learned; the state arrays
        #: then follow ``params["phi"]`` step by step (``_sa_for``)
        self.learn_phi: bool = False
        self._onehot: Dict[torch.device, torch.Tensor] = {}

    def slot_onehot(self, device) -> torch.Tensor:
        """(S, Hp, K) slot-carries-value indicator on ``device`` (built
        once each)."""
        device = torch.device(device)
        if device not in self._onehot:
            self._onehot[device] = torch.as_tensor(
                states_mod.slot_value_onehot(self.space), device=device)
        return self._onehot[device]

    def _sa_for(self, params) -> LinearStateArrays:
        """State arrays for this step: the static tables, or functions of
        ``params["phi"]`` when Phi is a learned parameter."""
        device = params["W"].device
        sa = self.state_arrays(device)
        if self.learn_phi and "phi" in params:
            return traced_state_arrays(self.slot_onehot(device),
                                       sa.value_counts, sa.abs_states,
                                       params["phi"])
        return sa

    def _check_phi_backend(self, device) -> None:
        """Learned Phi needs the value-set sums and state tables that
        follow ``params["phi"]``; only the plain version has them."""
        if (self.learn_phi and self.backend == "cuda"
                and device.type == "cuda"):
            raise ValueError(
                "no CUDA kernel collects the value-set sums (phi_c, phi_M) "
                "of a learned Phi; build the model with backend=\"plain\" "
                "to train and decode it on the card")

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

    def estep_sums(self, params, y, weight, sched, state_axis=None,
                   n_state_shards: int = 1):
        """E-step over one block of data: (F (N,), sums).  ``params`` are
        already noisified; the caller owns the weight mask.  With
        ``backend="cuda"`` a CUDA tensor always launches a kernel, the fused
        E-step or the big-S one when ``s_block > 0``, or raises (learned
        Phi); ``backend="plain"`` runs the plain version on the tensors'
        device.  Learned Phi tiles no states: ``s_block`` is not read.  A
        saturated step skips the un-annealed channel (F_true == F there).

        Under a state axis (``state_axis``: the state group,
        ``n_state_shards > 1``) the rank's slice of the states:
        ``backend="cuda"`` on a CUDA tensor runs the big-S kernel on it
        whatever ``s_block`` is (the fused rows kernel needs the whole
        union, as the JAX package turns its own kernel off there);
        ``backend="plain"`` and learned Phi run the plain version sliced
        (``_chunk_estats`` for ``s_block = 0``, ``_chunk_estats_bigs``
        above).  The sums are then this state rank's part."""
        W = params["W"]
        shard = dict(state_axis=state_axis, n_state_shards=n_state_shards)
        saturated = pattern_of(sched).saturated
        args = (y, weight, W, params["sigma"] ** 2, self.log_odds(params),
                self._sa_for(params), self.Hprime, self.signed_select,
                sched["beta"], sched["prior_beta"])
        if self.learn_phi:
            self._check_phi_backend(W.device)
            return etstep.linear_et_estep(
                *args, chunk=self.chunk, collect_true=not saturated,
                collect_phi=True, slot_onehot=self.slot_onehot(W.device),
                **shard)
        estep = (linear_et_estep if self.backend == "cuda"
                 else etstep.linear_et_estep)
        return estep(*args, chunk=self.chunk, collect_true=not saturated,
                     s_block=self.s_block, **shard)

    def finalize_mstep(self, params, sums, N_total, group=None,
                       state_axis=None, n_state_shards: int = 1):
        """Closed-form M-step and the per-iteration scalars (0-d tensors).
        ``params`` is the noisified dict the E-step ran with.  With a
        process group the sums and ``N_total`` are this rank's and are
        summed over the ranks first (``reduce_sums``; over the state group
        too under a state axis)."""
        sums, N_total = reduce_sums(sums, N_total, group, state_axis,
                                    n_state_shards)
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

    def step_fn(self, params, data, sched, generator, state_axis=None,
                n_state_shards: int = 1, group=None):
        """One EM iteration: noisify -> masks -> E-step -> M-step.
        Returns (new_params, F (N,), scalars).  With a process group
        (``MeshRuntime.shard_step``) ``data`` holds this rank's rows and
        the parameters, scalars and generator stay replicated.  Under a
        state axis (``state_axis``, ``n_state_shards``; ``group`` is then
        the data group) the E-step runs on this rank's slice of the states
        and F is the same on every state rank of a row."""
        y = data["y"]
        sched = device_sched(sched, y.device)
        params = self.noisify(params, sched, generator)

        def estep(weight):
            return self.estep_sums(params, y, weight, sched, state_axis,
                                   n_state_shards)

        F, sums, logA, logB, N_total = self.run_estep_with_ncut(
            estep, self.log_pi_active(params), data, sched, generator, group)
        new_params, scalars = self.finalize_mstep(
            params, sums, N_total, group, state_axis, n_state_shards)
        return new_params, F, scalars

    def m_step(self, params, sums, logA, logB):
        H = self.H
        n_used = torch.clamp(sums["n"], min=1.0)
        new = dict(params)
        if "W" in self.to_learn:
            ss = sums["ss"]
            ridge = 1e-6 * (torch.trace(ss) / H + 1.0)
            A = ss + ridge * torch.eye(H, dtype=ss.dtype, device=ss.device)
            new["W"] = solve(A, sums["xs"].T).T.contiguous()
        if "pi" in self.to_learn:
            new.update(self.update_prior(params, sums, n_used, logA, logB))
        if "sigma" in self.to_learn:
            W = new["W"]
            resid = (sums["y2"] - 2.0 * torch.sum(W * sums["xs"])
                     + torch.sum((W.T @ W) * sums["ss"]))
            sigma2 = torch.clamp(resid / (n_used * self.D), min=1e-10)
            new["sigma"] = torch.sqrt(sigma2)
        return new

    def generate_from_hidden(self, params, s, rng=None):
        return s @ to_numpy(params["W"]).astype(np.float64).T

    # -- posterior decode (the serving path) ----------------------------------

    def inference(self, params, data, top_L: int = 10, anneal=None,
                  dense_states=None, runtime=None):
        """Posterior decode on held-out data: top states, probabilities,
        posterior mean, reconstruction and F, on the device of
        ``params['W']``; on a CUDA device through the fused decode kernel,
        except for a big-S model (``s_block > 0``) and ``backend="plain"``,
        which decode through the plain ``linear_et_posterior`` on any
        device, as the JAX package keeps such models off its fused decode.
        Learned Phi decodes through the plain version alone (on the card
        with ``backend="plain"``).
        ``dense_states``: True returns ``top_states (N, L, H)``, False the
        compact fields (``core.etstep.densify_top_states`` rebuilds the
        dense tensor), None picks by output size.
        ``runtime`` (a ``MeshRuntime``): ``data`` holds this rank's rows,
        decoded on this rank's device (``MeshRuntime.shard_decode``); the
        outputs are this rank's rows."""
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
        self._check_phi_backend(W.device)
        decode = (linear_et_posterior
                  if (self.s_block > 0 or self.backend == "plain"
                      or self.learn_phi)
                  else linear_et_posterior_kernel)
        return decode(
            y.contiguous(), W, params["sigma"] ** 2, self.log_odds(params),
            self._sa_for(params), self.Hprime, self.signed_select,
            top_L, beta, prior_beta, dense_states=dense_states)


class BSC(LinearETModel):
    """Binary Sparse Coding with Expectation Truncation."""

    signed_select = False

    def __init__(self, D, H, Hprime, gamma, to_learn=None, chunk=2048,
                 ncut_current: bool = False, s_block: int = 0,
                 compute_dtype=None, backend: str = "cuda"):
        super().__init__(D, H, Hprime, gamma, values=[1.0],
                         to_learn=to_learn, chunk=chunk,
                         ncut_current=ncut_current, s_block=s_block,
                         compute_dtype=compute_dtype, backend=backend)

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
                 compute_dtype=None, backend: str = "cuda"):
        super().__init__(D, H, Hprime, gamma, values=[-1.0, 1.0],
                         to_learn=to_learn, chunk=chunk,
                         ncut_current=ncut_current, s_block=s_block,
                         compute_dtype=compute_dtype, backend=backend)

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
    vector (``params['pi']`` is (K,); p(0) = 1 - sum(pi)).

    The value set Phi is static config by default; ``to_learn=(..., "phi")``
    makes it a learned (K,) parameter with a closed-form M-step: the
    expected complete-data log-likelihood is quadratic in phi, so
    phi <- M^-1 c with the E-step's ``phi_c`` / ``phi_M`` sums.  When W is
    learned too, the (W -> aW, phi -> phi/a) scale degeneracy is gauge-fixed
    after each update: the initially largest |phi_k| keeps its magnitude and
    W absorbs the inverse."""

    signed_select = True

    def __init__(self, D, H, Hprime, gamma, phi=(-1.0, 1.0, 2.0),
                 to_learn=None, chunk=2048, ncut_current: bool = False,
                 s_block: int = 0, compute_dtype=None,
                 backend: str = "cuda"):
        super().__init__(D, H, Hprime, gamma, values=list(phi),
                         to_learn=to_learn, chunk=chunk,
                         ncut_current=ncut_current, s_block=s_block,
                         compute_dtype=compute_dtype, backend=backend)
        self.phi = np.asarray(phi, np.float64)
        if "phi" in self.to_learn:
            self.learn_phi = True
            self.param_names = ("W", "pi", "sigma", "phi")
            states_mod.slot_value_onehot(self.space)   # distinct values
            self._phi_anchor = int(np.argmax(np.abs(self.phi)))
            self._phi_anchor_val = float(self.phi[self._phi_anchor])

    def standard_init(self, data, seed: int = 0, device=None):
        params = super().standard_init(data, seed, device)
        K = len(self.phi)
        dev = params["W"].device
        params["pi"] = torch.full((K,), 1.0 / (self.H * K),
                                  dtype=torch.float32, device=dev)
        if self.learn_phi:
            params["phi"] = torch.as_tensor(self.phi.astype(np.float32),
                                            device=dev)
        return params

    def m_step(self, params, sums, logA, logB):
        new = super().m_step(params, sums, logA, logB)
        if self.learn_phi:
            K = len(self.phi)
            M = sums["phi_M"]
            ridge = 1e-6 * (torch.trace(M) / K + 1.0)
            phi = solve(M + ridge * torch.eye(K, dtype=M.dtype,
                                              device=M.device),
                        sums["phi_c"][:, None])[:, 0]
            if "W" in self.to_learn:
                # gauge fix: |phi[anchor]| keeps its initial magnitude and W
                # absorbs the scale (W s is invariant under it)
                anchor = phi[self._phi_anchor]
                alpha = torch.where(anchor.abs() > 1e-6,
                                    self._phi_anchor_val / anchor,
                                    torch.ones_like(anchor))
                phi = phi * alpha
                new["W"] = new["W"] / alpha
            new["phi"] = phi
        return new

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
        phi = (to_numpy(params["phi"]).astype(np.float64)
               if "phi" in params else self.phi)
        vals = np.concatenate([[0.0], phi])
        idx = rng.choice(len(vals), size=(N, self.H), p=probs)
        return vals[idx]
