"""The EM training driver.

Counterpart of ``prosper_tpu/engine/em.py::EM``.  Each iteration is the
model's ``step_fn`` (noisify -> masks -> E-step -> M-step) on one device.

``run`` keeps the outer loop in Python: one step per iteration, its schedule
copied to the device and its scalars copied back, so ``history`` holds each
iteration's own time.

``run_scanned`` is the counterpart of the JAX package's scan over the step:
the schedules of k iterations go to the device in one transfer, a step reads
row ``i`` of them and writes its scalars to row ``i`` of a device buffer,
with ``i`` a device counter the step increments, and the scalars come back
once per call.  On a CUDA device the step is captured into one
``torch.cuda.CUDAGraph`` per ``StepPattern`` (the branches the host schedule
picks) and replayed, so no replay needs the host; on the CPU the same step
runs in a plain loop.  Both use the same generator and the same arithmetic
as ``run``, so parameters, free energies, scalars and the generator's state
equal ``run``'s bit for bit, and any mix of the two follows one trajectory.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from prosper_tpu_torch.io.weights import params_from_numpy
from prosper_tpu_torch.models.base import (SCHED_KEYS, StepPattern,
                                           device_sched, make_blank_data,
                                           sched_floats, sched_from_row,
                                           sched_row, step_pattern, to_numpy)
from prosper_tpu_torch.ops.cuda_lib import LAUNCHES

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


def schedule_window(anneal, k: int) -> List[Dict[str, float]]:
    """The next k schedule snapshots (``sched_floats``), read from the host
    annealer without moving it."""
    start = anneal.position
    try:
        out = []
        for j in range(k):
            anneal.position = start + j
            out.append(sched_floats(anneal))
    finally:
        anneal.position = start
    return out


def uniform_runs(scheds: List[Dict[str, float]]
                 ) -> List[Tuple[int, int, StepPattern]]:
    """Cut a window of schedules into runs (lo, hi, pattern) of iterations
    that take the same branches (``step_pattern``): saturation, each noise
    channel, ``partial``, the data cut, the softened max.  Each run is one
    specialisation of the step."""
    patterns = [step_pattern(s) for s in scheds]
    runs, start = [], 0
    for j in range(1, len(patterns) + 1):
        if j == len(patterns) or patterns[j] != patterns[start]:
            runs.append((start, j, patterns[start]))
            start = j
    return runs


class _Scan:
    """What ``run_scanned`` keeps between calls: the carry in buffers of
    fixed address (params, F_prev; y and valid are the EM's own), the device
    schedule and scalars with room for every iteration of the annealer, the
    device counter, and one captured graph per pattern."""

    def __init__(self, params, data, steps: int, device):
        self.y, self.valid = data["y"], data["valid"]
        self.params = {k: v.clone() for k, v in params.items()}
        self.F_prev = data["F_prev"].clone()
        self.sched = torch.zeros((steps, len(SCHED_KEYS)),
                                 dtype=torch.float32, device=device)
        self.i = torch.zeros(1, dtype=torch.long, device=device)
        self.names: Optional[List[str]] = None
        self.scalars: Optional[torch.Tensor] = None
        #: pattern -> (graph, the kernels one replay holds by launch name)
        self.graphs: Dict[StepPattern, tuple] = {}
        self.pool = None

    def fits(self, params, data) -> bool:
        return (self.y is data["y"] and self.valid is data["valid"]
                and set(self.params) == set(params)
                and all(self.params[k].shape == v.shape
                        for k, v in params.items()))


class EM:
    """EM training loop on one device.

    Parameters
    ----------
    model : a model of the port: an ET model (BSC, TSC, DSC, MCA, MMCA,
        GSC) or a mixture (``models.mixtures.MoG``, ``MoP``)
    anneal : LinearAnnealing
    data : dict with 'y' (N, D) (and optional 'valid', 'F_prev'), numpy or
        tensors; moved to ``device`` and padded with weight-0 rows to a
        multiple of the model's chunk when N exceeds it.
    params : initial parameters (numpy or tensors); defaults to
        ``model.standard_init`` on the rows with ``valid > 0`` (the padding
        takes no part in it).
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
            y = self.data["y"]
            params = model.standard_init(
                {"y": y[self.data["valid"] > 0]}, device=self.device)
        self.params = params_from_numpy(
            {k: to_numpy(v) for k, v in params.items()}, self.device)
        self.history: list = []
        #: what ``run_scanned`` did so far on a CUDA device: graphs captured
        #: and the host seconds their captures took, replays, steps run
        #: eagerly, and the kernels the replays held by launch name (replays
        #: times what each capture recorded: ``LAUNCHES`` counts launch
        #: sites, and a replay passes none)
        self.scan_stats = {"graphs": 0, "capture_s": 0.0, "replays": 0,
                           "eager_steps": 0, "replayed_launches": {}}
        self._scan: Optional[_Scan] = None

    def run(self, verbose: bool = False) -> Dict[str, torch.Tensor]:
        """Run until the annealing schedule is exhausted; returns params."""
        while not self.anneal.finished:
            self.step_once(verbose=verbose)
        return self.params

    def step_once(self, verbose: bool = False) -> Dict[str, float]:
        t0 = time.perf_counter()
        sched = device_sched(sched_floats(self.anneal), self.device)
        params, F, scalars = self.model.step_fn(
            self.params, self.data, sched, self.generator)
        self.params = params
        self.data = dict(self.data, F_prev=F)

        out = dict(zip(scalars, self._stack(scalars).tolist()))
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

    def _stack(self, scalars: Dict) -> torch.Tensor:
        """A step's scalars as one float32 vector on the device."""
        return torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                            device=self.device)
                            for v in scalars.values()])

    # -- run_scanned -----------------------------------------------------------

    def run_scanned(self, n_steps: Optional[int] = None,
                    collect_params: bool = False) -> Dict[str, torch.Tensor]:
        """Run k = min(n_steps, remaining) iterations with no host work
        between them; returns params.  ``history`` gains one record per
        iteration with the keys of ``step_once``'s and ``dt = total / k``;
        the annealer advances k steps.  Same trajectory as ``run``."""
        if collect_params:
            raise NotImplementedError(
                "run_scanned(collect_params=True) is not ported to "
                "prosper_tpu_torch yet: its consumer is the data log "
                "(ROADMAP.md, open item: CLI/IO)")
        remaining = self.anneal.steps - self.anneal.position
        k = remaining if n_steps is None else min(n_steps, remaining)
        if k <= 0:
            return self.params

        scheds = schedule_window(self.anneal, k)
        t0 = time.perf_counter()
        scan = self._scan
        if scan is None or not scan.fits(self.params, self.data):
            scan = self._scan = _Scan(self.params, self.data,
                                      self.anneal.steps, self.device)
        else:
            for name, v in self.params.items():
                scan.params[name].copy_(v)
            scan.F_prev.copy_(self.data["F_prev"])
        # the k schedules: one transfer
        scan.sched[:k].copy_(torch.tensor([sched_row(s) for s in scheds],
                                          dtype=torch.float32))
        scan.i.zero_()
        for lo, hi, pattern in uniform_runs(scheds):
            self._run_uniform(scan, pattern, hi - lo)
        rows = scan.scalars[:k].tolist()          # the scalars: one transfer
        total_dt = time.perf_counter() - t0

        self.params = {name: v.clone() for name, v in scan.params.items()}
        self.data = dict(self.data, F_prev=scan.F_prev.clone())
        for row in rows:
            rec = dict(zip(scan.names, row))
            rec["iteration"] = self.anneal.position
            rec["T"] = float(self.anneal["T"])
            rec["dt"] = total_dt / k
            self.history.append(rec)
            self.anneal.next()
        return self.params

    def _scan_step(self, scan: _Scan, pattern: StepPattern) -> None:
        """One iteration on the carry: the schedule from row ``i`` of the
        device schedule, the new parameters and F into the carry's buffers,
        the scalars into row ``i`` of the device scalars, ``i`` advanced.
        Nothing here reads a device value on the host."""
        sched = sched_from_row(scan.sched.index_select(0, scan.i)[0], pattern)
        data = {"y": scan.y, "valid": scan.valid, "F_prev": scan.F_prev}
        params, F, scalars = self.model.step_fn(scan.params, data, sched,
                                                self.generator)
        for name, v in params.items():
            scan.params[name].copy_(v)
        scan.F_prev.copy_(F)
        if scan.scalars is None:
            scan.names = list(scalars)
            scan.scalars = torch.zeros((scan.sched.shape[0], len(scalars)),
                                       dtype=torch.float32,
                                       device=self.device)
        scan.scalars.index_copy_(0, scan.i, self._stack(scalars)[None])
        scan.i.add_(1)

    def _run_uniform(self, scan: _Scan, pattern: StepPattern, n: int) -> None:
        """n iterations of one pattern.  On a CUDA device the first
        iteration of a pattern not met before runs eagerly (it is the
        iteration itself and the warm-up of the capture: the kernels are
        built, every cached table exists), the step is then captured, and
        the rest are replays.  On the CPU every iteration is the step."""
        if self.device.type != "cuda":
            for _ in range(n):
                self._scan_step(scan, pattern)
            return
        done = 0
        if pattern not in scan.graphs:
            self._scan_step(scan, pattern)
            self.scan_stats["eager_steps"] += 1
            done = 1
            if n == 1:
                return
            t0 = time.perf_counter()
            scan.graphs[pattern] = self._capture(scan, pattern)
            self.scan_stats["capture_s"] += time.perf_counter() - t0
        graph, launches = scan.graphs[pattern]
        replayed = self.scan_stats["replayed_launches"]
        for _ in range(n - done):
            graph.replay()
            self.scan_stats["replays"] += 1
            for name, count in launches.items():
                replayed[name] = replayed.get(name, 0) + count

    def _capture(self, scan: _Scan, pattern: StepPattern) -> tuple:
        """The step of ``pattern`` as a CUDA graph over the carry's buffers:
        (graph, the kernels one replay holds, by the name of their launch
        count).  The wrappers pass their launch sites once while the step
        is captured, which ``LAUNCHES`` counts as it counts an eager step; a
        replay passes none, so ``LAUNCHES`` does not see it.  A step that
        cannot be captured raises: ``run`` steps it eagerly."""
        if scan.pool is None:
            scan.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = dict(LAUNCHES)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=scan.pool)
                try:
                    self._scan_step(scan, pattern)
                finally:
                    graph.capture_end()
        except RuntimeError as e:
            raise RuntimeError(
                f"run_scanned: the step with {pattern} could not be "
                "captured into a CUDA graph; EM.run steps it eagerly") from e
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.scan_stats["graphs"] += 1
        return graph, {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                       if LAUNCHES[k] != before[k]}
