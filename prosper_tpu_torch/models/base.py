"""Shared model machinery: static model configs and the ET data-selection
masks.

Counterpart of ``prosper_tpu/models/base.py``.  A model is a static config
object; parameters are a dict of tensors on one device, and every function
follows the device of the tensors it is given.  Randomness (parameter noise,
the ``partial`` mask) comes from an explicit ``torch.Generator`` on that
device.  The Ncut ranking uses the previous iteration's per-datapoint free
energies by default (one E-step pass); ``ncut_current`` ranks by the
current iteration's, at the price of a second pass while the cut is active.

A step's schedule is a dict of values (``sched_floats``: host numbers, or
the same as 0-d tensors on the device) and the branches those values pick:
whether a noise channel draws at all, whether ``partial`` subsamples,
whether the data cut is on, whether the max is softened, whether the step
is saturated.  ``step_pattern`` derives the branches from the host numbers
once, and ``device_sched`` puts the values on the device with the pattern
beside them under ``sched["pattern"]``: a step fed such a dict reads no
schedule value on the host, so it can be captured into a CUDA graph and
replayed with other values (``engine/em.py::EM.run_scanned``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from prosper_tpu_torch.core.etstep import (LinearStateArrays,
                                           state_arrays_from,
                                           truncated_prior_logmass)
from prosper_tpu_torch.core.select import (exact_count_mask,
                                           global_quantile_threshold,
                                           ncut_keep_count)
from prosper_tpu_torch.parallel.mesh import maybe_psum


def to_numpy(x) -> np.ndarray:
    """Host copy of a tensor or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


#: the names a model's ``backend`` takes -> what they select.  "pallas" and
#: "xla" are the JAX package's names for the same two choices.
BACKENDS = {"cuda": "cuda", "pallas": "cuda", "plain": "plain",
            "xla": "plain"}


def resolve_backend(backend: str) -> str:
    """``"cuda"`` (the hand-written kernels on a CUDA tensor) or
    ``"plain"`` (the plain PyTorch version on whatever device the tensors
    lie on) for any accepted name; ValueError for any other."""
    if backend not in BACKENDS:
        raise ValueError("backend must be 'cuda' or 'plain' (or the JAX "
                         f"package's 'pallas' or 'xla'), got {backend!r}")
    return BACKENDS[backend]


class StepPattern(NamedTuple):
    """The branches one EM step takes, as the host schedule decides them."""
    saturated: bool        # beta == prior_beta == 1: no un-annealed channel
    W_noise: bool          # each noise channel draws only where its std != 0
    pi_noise: bool
    sigma_noise: bool
    mu_noise: bool
    partial: bool          # partial < 1: the exact-count random subsample
    ncut: bool             # Ncut_factor > 0: the ET data cut
    soft: bool             # rho > 0: the softened max (MCA / MMCA)


#: the schedule's channels, in the order of a device schedule's columns
SCHED_KEYS = ("beta", "prior_beta", "Ncut_factor", "partial", "W_noise",
              "pi_noise", "sigma_noise", "mu_noise", "rho")


def step_pattern(sched: Dict) -> StepPattern:
    """The pattern of a schedule snapshot (``sched_floats``): a pure
    function of its values."""
    f = {k: float(sched[k]) for k in SCHED_KEYS}
    return StepPattern(
        saturated=f["beta"] == 1.0 and f["prior_beta"] == 1.0,
        W_noise=f["W_noise"] != 0.0,
        pi_noise=f["pi_noise"] != 0.0, sigma_noise=f["sigma_noise"] != 0.0,
        mu_noise=f["mu_noise"] != 0.0, partial=f["partial"] < 1.0,
        ncut=f["Ncut_factor"] > 0, soft=f["rho"] > 0)


def pattern_of(sched: Dict) -> StepPattern:
    """The pattern a schedule dict carries, else the one its values give."""
    pattern = sched.get("pattern")
    return step_pattern(sched) if pattern is None else pattern


def sched_row(sched: Dict) -> list:
    """A snapshot's values in the order of ``SCHED_KEYS``."""
    return [float(sched[k]) for k in SCHED_KEYS]


def sched_from_row(row: torch.Tensor, pattern: StepPattern) -> Dict:
    """The step's schedule from one row (n_channels,) of a device
    schedule: 0-d views of it, and the pattern."""
    return dict(zip(SCHED_KEYS, row.unbind(0)), pattern=pattern)


def device_sched(sched: Dict, device) -> Dict:
    """``sched`` ready for a step on ``device``: the values as 0-d float32
    tensors there (one copy for all of them) and the pattern.  A dict that
    carries its pattern already is returned as it is."""
    if "pattern" in sched:
        return sched
    row = torch.tensor(sched_row(sched), dtype=torch.float32).to(device)
    return sched_from_row(row, step_pattern(sched))


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
        self._sa: Dict[torch.device, LinearStateArrays] = {}

    def state_arrays(self, device) -> LinearStateArrays:
        """The enumerated state tables of ``self.space`` (the subclass's
        ``core.states.StateSpace``) on ``device``, built once each."""
        device = torch.device(device)
        if device not in self._sa:
            self._sa[device] = state_arrays_from(self.space, device)
        return self._sa[device]

    # -- subclass contract ----------------------------------------------------

    def generate_from_hidden(self, params: Dict, s: np.ndarray,
                             rng: Optional[np.random.Generator] = None
                             ) -> np.ndarray:
        """Noise-free mean ybar given latent states (host-side numpy).
        ``rng`` is accepted for callers written for the JAX package and
        not read: no model of the port draws here."""
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
        ybar = self.generate_from_hidden(params, s, rng)
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
        params = {"W": t(W), "pi": t(np.float32(1.0 / self.H)),
                  "sigma": t(np.float32(max(std, 1e-3)))}
        # the subclass's own parameters, drawn after W from the same stream
        params.update({k: t(v) for k, v in self._extra_init(y, rng).items()})
        return params

    def _extra_init(self, y: np.ndarray, rng: np.random.Generator) -> Dict:
        """Initial values (numpy) of the parameters a subclass adds to W,
        pi and sigma, from the float64 data and the init's random stream."""
        return {}

    def noisify(self, params: Dict, sched: Dict,
                generator: torch.Generator) -> Dict:
        """Add the scheduled jitter to W, pi and sigma, and to mu where the
        model has one (noise is drawn only for channels whose std is
        non-zero, in this order)."""
        pattern = pattern_of(sched)
        p = dict(params)

        def noise(x, channel):
            if not getattr(pattern, channel):
                return x
            return x + sched[channel] * torch.randn(
                x.shape, generator=generator, device=x.device, dtype=x.dtype)
        p["W"] = noise(params["W"], "W_noise")
        p["pi"] = torch.clamp(noise(params["pi"], "pi_noise"),
                              1e-6, 1.0 - 1e-6)
        p["sigma"] = torch.clamp(noise(params["sigma"], "sigma_noise"),
                                 min=1e-5)
        if "mu" in params:
            p["mu"] = noise(params["mu"], "mu_noise")
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
    #
    # With a process group (``parallel/mesh.py``; the data group of a
    # ("data", "state") mesh) the rows are this rank's: the partial mask
    # draws per data shard, the Ncut cut ranks the rows of every data shard
    # (``n_sel`` and the threshold's histograms are summed), and
    # ``N_total`` is this rank's count, summed with the sufficient
    # statistics in ``finalize_mstep`` (one all-reduce for both).  The
    # state ranks of a row hold the same rows, the same generator and the
    # same F bit for bit (the softmax is combined over them), so they draw
    # the same mask and cut the same rows.

    def partial_mask(self, data, sched, generator, group=None) -> torch.Tensor:
        """Exact-count random subsampling mask (``partial`` channel)."""
        valid = data["valid"]
        if not pattern_of(sched).partial:
            return valid
        return exact_count_mask(generator, valid.shape[0], sched["partial"],
                                valid=valid, group=group)

    def ncut_weight(self, pmask, F_rank, sched, logA,
                    group=None) -> torch.Tensor:
        """The ET data cut on top of ``pmask``, ranking by ``F_rank``.  The
        keep count applies the ET fraction to the rows under consideration
        (sum of ``pmask``, over every rank), not to all valid rows: with
        ``partial`` < 1 the two differ, and a keep count above the subset
        would make the cut a no-op."""
        n_sel = maybe_psum(pmask.sum(), group)
        keep = ncut_keep_count(n_sel, sched["Ncut_factor"], logA)
        thresh = global_quantile_threshold(F_rank, pmask, keep, group=group)
        return pmask * (F_rank >= thresh).float()

    def run_estep_with_ncut(self, estep, log_pi_active, data, sched,
                            generator, group=None):
        """E-step orchestration for both Ncut semantics.  ``estep(weight)
        -> (F, sums)``.  Returns (F, sums, logA, logB, N_total), with this
        rank's ``N_total`` under a group."""
        if not getattr(self, "ncut_current", False):
            weight, logA, logB, N_total = self.et_weight_mask(
                log_pi_active, data, sched, generator, group)
            F, sums = estep(weight)
            return F, sums, logA, logB, N_total

        pmask = self.partial_mask(data, sched, generator, group)
        logA, logB = truncated_prior_logmass(log_pi_active, self.H,
                                             self.gamma)
        N_total = data["valid"].sum()
        F, sums = estep(pmask)
        if pattern_of(sched).ncut:
            sums = estep(self.ncut_weight(pmask, F, sched, logA, group))[1]
        return F, sums, logA, logB, N_total

    def et_weight_mask(self, log_pi_active, data, sched, generator,
                       group=None):
        """Combined partial-subsampling + Ncut mask.
        Returns (weight (N,), logA, logB, N_total), with this rank's
        ``N_total`` under a group."""
        pmask = self.partial_mask(data, sched, generator, group)
        logA, logB = truncated_prior_logmass(log_pi_active, self.H,
                                             self.gamma)
        N_total = data["valid"].sum()
        if pattern_of(sched).ncut:
            weight = self.ncut_weight(pmask, data["F_prev"], sched, logA,
                                      group)
        else:
            weight = pmask
        return weight, logA, logB, N_total

    # -- one iteration ----------------------------------------------------------

    def step(self, params, data, anneal, generator: torch.Generator):
        """One EM iteration on the device of ``data``: ``data`` holds y,
        valid and F_prev (``make_blank_data``); returns (params, data with
        F_prev = this iteration's F, scalars), the JAX package's
        ``step(params, data, anneal, rng)`` contract.  The annealer is read,
        not advanced."""
        sched = device_sched(sched_floats(anneal), data["y"].device)
        params, F, scalars = self.step_fn(params, data, sched, generator)
        return params, dict(data, F_prev=F), scalars


def sched_floats(anneal) -> Dict[str, float]:
    """Annealing snapshot -> plain host floats, the step's scalars (the
    JAX package's ``sched_from_anneal`` turns these into traced scalars;
    a step of the port turns them into 0-d tensors, ``device_sched``)."""
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
