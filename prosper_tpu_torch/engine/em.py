"""The EM training driver.

Counterpart of ``prosper_tpu/engine/em.py::EM``: the outer loop stays in
Python (annealing and logging are host concerns); each iteration is the
model's ``step_fn`` (noisify -> masks -> E-step -> M-step) on one device.
Schedule values enter as host floats; per-iteration scalars come back to
the host once per step.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from prosper_tpu_torch.io.weights import params_from_numpy
from prosper_tpu_torch.models.base import (make_blank_data, sched_floats,
                                           to_numpy)

#: EM options of the JAX package that are not ported yet -> ROADMAP item
_NOT_PORTED = {
    "runtime": "distributed",
    "dlog": "CLI/IO",
    "log_params_every": "CLI/IO",
    "checkpoint_path": "CLI/IO",
    "checkpoint_every": "CLI/IO",
    "revive_duplicates": "recovery protocol",
    "split_norm_frac": "recovery protocol",
    "split_coact": "recovery protocol",
    "reseed_worst_frac": "recovery protocol",
}


class EM:
    """EM training loop on one device.

    Parameters
    ----------
    model : an ET model of the port (BSC, TSC, DSC, MCA, MMCA)
    anneal : LinearAnnealing
    data : dict with 'y' (N, D) (and optional 'valid', 'F_prev'), numpy or
        tensors; moved to ``device`` and padded with weight-0 rows to a
        multiple of the model's chunk when N exceeds it.
    params : initial parameters (numpy or tensors); defaults to
        ``model.standard_init`` on the padded data.
    device : where the data, parameters and random numbers live.
    seed : seeds the ``torch.Generator`` for parameter noise and ``partial``.
    """

    def __init__(self, model, anneal, data: Dict,
                 params: Optional[Dict] = None, device="cuda",
                 seed: int = 42, **unported):
        for name in unported:
            if name not in _NOT_PORTED:
                raise TypeError(f"EM got an unexpected argument {name!r}")
            raise NotImplementedError(
                f"EM({name}=...) is not ported to prosper_tpu_torch yet "
                f"(ROADMAP.md, open item: {_NOT_PORTED[name]})")
        self.model = model
        self.anneal = anneal
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        # weight-0 padding so that the chunked E-step's sizes divide the
        # chunk (the JAX package's rule); a no-op when N already fits
        N = data["y"].shape[0]
        c = (model.chunk if (getattr(model, "requires_chunk_multiple", False)
                             and N > model.chunk) else 1)
        N_pad = -(-N // c) * c
        blank = make_blank_data(data["y"], data.get("valid"),
                                device=self.device)
        if "F_prev" in data:
            blank["F_prev"] = torch.as_tensor(
                to_numpy(data["F_prev"]), dtype=torch.float32,
                device=self.device)
        pad = N_pad - N
        self.data = {k: torch.nn.functional.pad(
            v, (0, 0, 0, pad) if v.dim() == 2 else (0, pad))
            for k, v in blank.items()}
        if params is None:
            params = model.standard_init(self.data)
        self.params = params_from_numpy(
            {k: to_numpy(v) for k, v in params.items()}, self.device)
        self.history: list = []

    def _sat_now(self) -> bool:
        """beta == prior_beta == 1 on the host schedule."""
        f = sched_floats(self.anneal)
        return f["beta"] == 1.0 and f["prior_beta"] == 1.0

    def run(self, verbose: bool = False) -> Dict[str, torch.Tensor]:
        """Run until the annealing schedule is exhausted; returns params."""
        while not self.anneal.finished:
            self.step_once(verbose=verbose)
        return self.params

    def step_once(self, verbose: bool = False) -> Dict[str, float]:
        t0 = time.perf_counter()
        sched = sched_floats(self.anneal)
        params, F, scalars = self.model.step_fn(
            self.params, self.data, sched, self.generator,
            saturated=self._sat_now())
        self.params = params
        self.data = dict(self.data, F_prev=F)

        names = list(scalars)
        vals = torch.stack([torch.as_tensor(scalars[k], dtype=torch.float32,
                                            device=self.device)
                            for k in names]).tolist()
        out = dict(zip(names, vals))
        out["iteration"] = self.anneal.position
        out["T"] = float(self.anneal["T"])
        out["dt"] = time.perf_counter() - t0
        self.history.append(out)
        if verbose:
            print(f"[em] iter {self.anneal.position:4d} "
                  f"F/N={out['F_mean']:+.4f} n_used={out['n_used']:.0f} "
                  f"T={out['T']:.2f} dt={out['dt'] * 1e3:.1f}ms", flush=True)
        self.anneal.next()
        return out
