"""The EM training driver.

Counterpart of ``prosper_tpu/engine/em.py::EM``.  Each iteration is the
model's ``step_fn`` (noisify -> masks -> E-step -> M-step) on one device,
or, with a ``MeshRuntime`` (``parallel/mesh.py``), on each rank's device
over that rank's rows: the parameters are replicated, the step reduces its
sufficient statistics over the ranks, and every rank computes the same
M-step (the reference under ``mpirun -n P``).

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

The host work between iterations is the JAX package's: the data log, the
periodic checkpoints and the recovery protocol (``revive_duplicates`` and
its options: duplicate and dead columns re-seeded, blends split by
``coactivation_split``), in numpy on the host.  Periodic actions fire on
boundary crossings, revival before the checkpoint, and ``run_scanned`` cuts
its iterations into windows that end where the next of them is due.  A checkpoint
holds the parameters, ``F_prev``, the generator's state and the revival
chain's, so a resumed run (``EM.resume``) follows the uninterrupted one.
Under a runtime the host work is the JAX package's multi-process one: rank 0
revives on its own rows and broadcasts W, a checkpoint holds the global
``F_prev`` (every rank's rows in stride order) and only rank 0 writes files.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from prosper_tpu_torch.data.diagnosis import dictionary_stats
from prosper_tpu_torch.io import checkpoint
from prosper_tpu_torch.io.weights import params_from_numpy
from prosper_tpu_torch.models.base import (SCHED_KEYS, StepPattern,
                                           device_sched, make_blank_data,
                                           sched_floats, sched_from_row,
                                           sched_row, step_pattern, to_numpy)
from prosper_tpu_torch.ops.cuda_lib import LAUNCHES
from prosper_tpu_torch.parallel.mesh import (COLLECTIVES, check_runtime,
                                             local_device)


def coactivation_split(w_b: np.ndarray, Y: np.ndarray,
                       support_frac: float = 0.25,
                       corr_frac: float = 0.35,
                       contrast_threshold: float = 0.3):
    """Split a suspected blend column into its two constituent atoms.

    At the patches scale the stable failures are *blends*: one learned
    column w_b ~= a1 + a2 with near-disjoint supports.  Among datapoints
    that correlate with w_b, most contain only ONE of the two atoms
    (P(both) ~ pi^2), so a1's pixels co-vary together and anti-correlate
    with a2's pixels: the top eigenvector of the support-restricted,
    centered covariance is ~indicator(a1) - indicator(a2), and its sign
    partitions the support.  Returns (w1, w2) or None when no clean
    two-group structure exists (the caller falls back to re-seeding).
    Host numpy, the JAX package's arithmetic.
    """
    thr = support_frac * float(np.max(np.abs(w_b)))
    sup = np.flatnonzero(np.abs(w_b) > thr)
    if sup.size < 4:
        return None
    # rows that contain (at least) one of the two atoms: a single-atom row
    # correlates at ~0.5*||w_b||^2, pure-noise rows at ~N(0, sigma*||w_b||)
    # -- select by threshold, not a fixed top fraction (at realistic
    # sparsity a fixed fraction is mostly noise rows)
    c = Y @ w_b
    rows = np.flatnonzero(c > corr_frac * float(w_b @ w_b))
    if rows.size < 32:
        return None
    if rows.size > 4096:
        rows = rows[np.argsort(-c[rows])[:4096]]
    Ys = Y[rows][:, sup]
    Ys = Ys - Ys.mean(axis=0)
    C = Ys.T @ Ys
    evals, evecs = np.linalg.eigh(C)
    v = evecs[:, -1]
    m1 = v >= 0.0
    if m1.sum() < 2 or (~m1).sum() < 2:
        return None
    # a true blend's groups co-vary within and anti-correlate across; a
    # single atom shows a flat correlation structure.  Demand real
    # within-vs-cross contrast before splitting (0.3 online; the offline
    # sweep, data/diagnosis.py::split_blend_sweep, passes 0.22)
    d = np.sqrt(np.maximum(np.diag(C), 1e-12))
    R = C / np.outer(d, d)
    off = ~np.eye(sup.size, dtype=bool)
    cross = float(R[np.ix_(m1, ~m1)].mean())
    within_mask = (np.outer(m1, m1) | np.outer(~m1, ~m1)) & off
    within = float(R[within_mask].mean())
    if within - cross < contrast_threshold:
        return None
    w1 = np.zeros_like(w_b)
    w2 = np.zeros_like(w_b)
    w1[sup[m1]] = w_b[sup[m1]]
    w2[sup[~m1]] = w_b[sup[~m1]]
    # reject splits that did not separate energy meaningfully
    n1, n2 = np.linalg.norm(w1), np.linalg.norm(w2)
    if min(n1, n2) < 0.25 * max(n1, n2):
        return None
    return w1, w2


def run_restarts(build_em, n_restarts: int, scanned: bool = True):
    """Run ``n_restarts`` independent EM trainings, keep the best final F.

    ``build_em(i)`` must return a fresh ``EM`` (annealing schedules are
    stateful, so they cannot be shared across restarts).  Returns
    ``(best_params, {"F_means": [...], "best": index})``.  For dictionary
    recovery the JAX package measured this as superseded by the recovery
    protocol (``BASELINE.md``, "run_restarts vs the recovery protocol"); it
    is kept for model selection where basin diversity is the point.
    """
    if n_restarts < 1:
        raise ValueError(f"n_restarts must be >= 1, got {n_restarts}")
    best_params, f_means, best_i = None, [], 0
    for i in range(n_restarts):
        em = build_em(i)
        params = em.run_scanned() if scanned else em.run()
        f = float(em.history[-1]["F_mean"])
        f_means.append(f)
        if best_params is None or f > f_means[best_i]:
            best_params, best_i = params, i
    return best_params, {"F_means": f_means, "best": best_i}


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
    schedule and scalars with room for every iteration of the annealer (and,
    once ``collect_params`` asks for them, each iteration's parameters), the
    device counter, and one captured graph per pattern and collection."""

    def __init__(self, params, data, steps: int, device):
        self.y, self.valid = data["y"], data["valid"]
        self.params = {k: v.clone() for k, v in params.items()}
        self.F_prev = data["F_prev"].clone()
        self.sched = torch.zeros((steps, len(SCHED_KEYS)),
                                 dtype=torch.float32, device=device)
        self.i = torch.zeros(1, dtype=torch.long, device=device)
        self.names: Optional[List[str]] = None
        self.scalars: Optional[torch.Tensor] = None
        self.phist: Optional[Dict[str, torch.Tensor]] = None
        #: (pattern, collect_params) -> (graph, the kernels one replay holds
        #: by launch name, the all-reduces one replay holds)
        self.graphs: Dict[Tuple[StepPattern, bool], tuple] = {}
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
        multiple of the model's chunk when N exceeds it.  Under a runtime
        these are this rank's rows (its ``stride_data`` slice), and every
        rank pads to the same length, that of the longest shard.
    params : initial parameters (numpy or tensors); defaults to
        ``model.standard_init`` on the rows with ``valid > 0`` (the padding
        takes no part in it; under a runtime every rank's rows).
    device : where the data, parameters and random numbers live (default
        CUDA; under a runtime the runtime's device).
    runtime : a ``parallel.mesh.MeshRuntime``: data-parallel training over
        its ranks.
    seed : seeds the ``torch.Generator`` for parameter noise and ``partial``;
        ``seed + 1`` seeds the revival's numpy chain.
    dlog : optional ``io.datalog.DataLog``; each iteration appends its
        scalars and parameters to it.
    log_params_every : parameters of two or more dimensions (W) go to the
        dlog only at iterations that are multiples of it (0: never); scalars
        and vectors every iteration.  1 is the reference's behaviour.
    checkpoint_path, checkpoint_every : write a checkpoint (``save_checkpoint``)
        each time the annealer has advanced ``checkpoint_every`` iterations
        past the last one.
    revive_duplicates : None or (every, cos_threshold[, stop_frac[,
        dead_norm_frac]]): every ``every`` iterations, until ``stop_frac``
        (default 0.75) of the schedule, the weaker column of each pair above
        ``cos_threshold`` mutual cosine, and each column below
        ``dead_norm_frac`` (default 0: off) times the median norm, is
        re-initialised (``_maybe_revive_duplicates``).
    split_norm_frac : with revival, a freed column first splits a suspected
        blend: a column whose norm exceeds this times the median norm (or,
        with ``split_coact``, whose support exceeds this times the median
        support); 0 disables.
    split_coact : split blends by ``coactivation_split`` on the data instead
        of a symmetric +/- perturbation (alone it sets ``split_norm_frac``
        to 1.5).
    reseed_worst_frac : re-seed freed columns from the datapoints in the
        worst-explained fraction of ``F_prev`` instead of uniformly; 0 off.
    """

    def __init__(self, model, anneal, data: Dict,
                 params: Optional[Dict] = None, device=None,
                 seed: int = 42, dlog=None, log_params_every: int = 1,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0,
                 revive_duplicates: Optional[tuple] = None,
                 split_norm_frac: float = 0.0, split_coact: bool = False,
                 reseed_worst_frac: float = 0.0, runtime=None):
        self.runtime = runtime
        if runtime is not None:
            check_runtime(runtime)
            if device is not None and local_device(device) != runtime.device:
                raise ValueError(f"EM(device={device!r}) differs from the "
                                 f"runtime's device {runtime.device}")
            device = runtime.device
        self.model = model
        self.anneal = anneal
        self.device = torch.device("cuda" if device is None else device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.dlog = dlog
        self.log_params_every = log_params_every
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        if revive_duplicates is not None:
            if not 2 <= len(revive_duplicates) <= 4:
                raise ValueError(
                    "revive_duplicates must be (every, cos_threshold"
                    "[, stop_frac[, dead_norm_frac]]), got "
                    f"{revive_duplicates!r}")
            defaults = (None, None, 0.75, 0.0)
            revive_duplicates = (int(revive_duplicates[0]),
                                 *(float(v) for v in revive_duplicates[1:]),
                                 *defaults[len(revive_duplicates):])
        self.revive_duplicates = revive_duplicates
        self.split_norm_frac = float(split_norm_frac)
        self.split_coact = bool(split_coact)
        if self.split_coact and self.split_norm_frac <= 0.0:
            # the pool gate runs first, so split_coact alone would do
            # nothing: take the calibrated support factor (blends sit at
            # ~1.6-1.9x the median support)
            self.split_norm_frac = 1.5
        self.reseed_worst_frac = float(reseed_worst_frac)
        #: how often each revival action fired this run
        self.revival_stats = {"revived": 0, "coact_split": 0,
                              "coact_rejected": 0, "sym_split": 0,
                              "reseeded": 0}
        self._revive_rng = np.random.default_rng(seed + 1)
        self._revive_valid_rows = None
        self._coact_sample = None
        # periodic actions fire on boundary crossings (position advanced
        # past last_fired + every), not on multiples, so that a resumed run
        # keeps the cadence of the uninterrupted one
        self._last_ckpt = anneal.position
        self._last_revive = anneal.position

        # weight-0 padding so that the chunked E-step's sizes divide the
        # chunk (the JAX package's rule); a no-op when N already fits.  Under
        # a runtime every rank pads to the longest shard's length, so that
        # the ranks' steps take the same shapes and draws
        N = data["y"].shape[0]
        self._n_local = N
        if runtime is not None:
            # the rows of each data shard; the ranks of a state group hold
            # the same rows
            self._n_locals = runtime.n_locals(N)
            self._row_offset = int(
                self._n_locals[:runtime.data_index].sum())
        else:
            self._n_locals, self._row_offset = np.asarray([N]), 0
        self.N_global = int(self._n_locals.sum())
        n_max = int(self._n_locals.max())
        c = (model.chunk if (getattr(model, "requires_chunk_multiple", False)
                             and n_max > model.chunk) else 1)
        N_pad = -(-n_max // c) * c
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
            params = model.standard_init({"y": self._init_rows()},
                                         device=self.device)
        self.params = params_from_numpy(
            {k: to_numpy(v) for k, v in params.items()}, self.device)
        if runtime is not None:
            self.params = runtime.replicate(self.params)
        #: the model's step, with the runtime's group bound where there is one
        self._step = (runtime.shard_step(model.step_fn) if runtime is not None
                      else model.step_fn)
        self.history: list = []
        #: what ``run_scanned`` did so far on a CUDA device: graphs captured
        #: and the host seconds their captures took, replays, steps run
        #: eagerly, the kernels the replays held by launch name (replays
        #: times what each capture recorded: ``LAUNCHES`` counts launch
        #: sites, and a replay passes none), and the all-reduces they held
        #: (``parallel.mesh.COLLECTIVES``, under a runtime)
        self.scan_stats = {"graphs": 0, "capture_s": 0.0, "replays": 0,
                           "eager_steps": 0, "replayed_launches": {},
                           "replayed_all_reduces": 0}
        self._scan: Optional[_Scan] = None

    def run(self, verbose: bool = False) -> Dict[str, torch.Tensor]:
        """Run until the annealing schedule is exhausted; returns params."""
        while not self.anneal.finished:
            self.step_once(verbose=verbose)
        return self.params

    def step_once(self, verbose: bool = False) -> Dict[str, float]:
        t0 = time.perf_counter()
        sched = device_sched(sched_floats(self.anneal), self.device)
        params, F, scalars = self._step(self.params, self.data, sched,
                                        self.generator)
        self.params = params
        self.data = dict(self.data, F_prev=F)

        out = dict(zip(scalars, self._stack(scalars).tolist()))
        out["iteration"] = self.anneal.position
        out["T"] = float(self.anneal["T"])
        out["dt"] = time.perf_counter() - t0
        self.history.append(out)
        if self.dlog is not None:
            rec = dict(out)
            big = self._logs_params(self.anneal.position)
            for k, v in self.params.items():
                if v.dim() <= 1 or big:   # W etc. rate-limited
                    rec[k] = v
            self.dlog.append_all(rec)
        if verbose:
            print(f"[em] iter {self.anneal.position:4d} "
                  f"F/N={out['F_mean']:+.4f} n_used={out['n_used']:.0f} "
                  f"T={out['T']:.2f} dt={out['dt'] * 1e3:.1f}ms", flush=True)
        self.anneal.next()
        # revival before the checkpoint: the checkpoint then holds the
        # revived W and the revival chain's state after it
        self._maybe_revive_duplicates()
        self._maybe_checkpoint()
        return out

    def _logs_params(self, position: int) -> bool:
        """Whether the iteration at ``position`` logs its big parameters."""
        return bool(self.log_params_every
                    and position % self.log_params_every == 0)

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
        iteration with the keys of ``step_once``'s and ``dt`` = the window's
        total / its length; the annealer advances k steps.  Same trajectory
        as ``run``.

        Checkpoints and revival cut the k iterations into windows that end
        where the next of them is due (``_next_due``), each window ending
        with revival, then the checkpoint: both fire at the iterations
        where ``run`` fires them, from any starting position (a resumed
        run's too).  ``collect_params=True`` also keeps each iteration's
        parameters in a device buffer (the step writes row ``i``) and hands
        them to the dlog with ``log_params_every``'s thinning, as ``run``
        logs them.

        Under a runtime the step's all-reduces are captured with it: an
        NCCL group's collectives replay inside the graph (never without
        them).  A gloo group cannot be captured, so ``run_scanned`` on a
        CUDA device under gloo raises; on the CPU it is the plain loop."""
        if (self.runtime is not None and self.device.type == "cuda"
                and self.runtime.backend != "nccl"):
            raise ValueError(
                f"run_scanned captures the step into a CUDA graph, and a "
                f"{self.runtime.backend} process group cannot be captured: "
                "use an nccl group, or EM.run")
        remaining = self.anneal.steps - self.anneal.position
        k = remaining if n_steps is None else min(n_steps, remaining)
        while k > 0:
            due = self._next_due()
            n = k if due is None else min(k, max(1, due - self.anneal.position))
            self._scan_window(n, collect_params)
            k -= n
        return self.params

    def _next_due(self) -> Optional[int]:
        """The position at which the next checkpoint or revival fires, or
        None when neither will."""
        due = []
        if self.checkpoint_path and self.checkpoint_every:
            due.append(self._last_ckpt + self.checkpoint_every)
        if self.revive_duplicates is not None:
            every, _, stop_frac, _ = self.revive_duplicates
            at = self._last_revive + every
            if at < stop_frac * self.anneal.steps:
                due.append(at)
        return min(due) if due else None

    def _scan_window(self, k: int, collect_params: bool) -> None:
        """k iterations with no host work between them (the body of
        ``run_scanned``), then revival and the checkpoint where due."""
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
        if collect_params and scan.phist is None:
            scan.phist = {name: torch.zeros((self.anneal.steps,) + v.shape,
                                            dtype=v.dtype, device=self.device)
                          for name, v in scan.params.items()}
        # the k schedules: one transfer
        scan.sched[:k].copy_(torch.tensor([sched_row(s) for s in scheds],
                                          dtype=torch.float32))
        scan.i.zero_()
        for lo, hi, pattern in uniform_runs(scheds):
            self._run_uniform(scan, pattern, hi - lo, collect_params)
        rows = scan.scalars[:k].tolist()          # the scalars: one transfer
        total_dt = time.perf_counter() - t0

        self.params = {name: v.clone() for name, v in scan.params.items()}
        self.data = dict(self.data, F_prev=scan.F_prev.clone())
        logged = (self._collected(scan, k)
                  if collect_params and self.dlog is not None else {})
        for j, row in enumerate(rows):
            rec = dict(zip(scan.names, row))
            rec["iteration"] = self.anneal.position
            rec["T"] = float(self.anneal["T"])
            rec["dt"] = total_dt / k
            self.history.append(rec)
            if self.dlog is not None:
                self.dlog.append_all(dict(rec, **{
                    name: rows_[j] for name, rows_ in logged.items()
                    if j in rows_}))
            self.anneal.next()
        self._maybe_revive_duplicates()
        self._maybe_checkpoint()

    def _collected(self, scan: _Scan, k: int) -> Dict[str, Dict[int, np.ndarray]]:
        """The parameters the dlog takes from the last k iterations: name ->
        {j: value of iteration j}; vectors and scalars of every iteration,
        bigger ones of the iterations ``_logs_params`` picks, each parameter
        read from the device in one transfer."""
        start = self.anneal.position
        big = [j for j in range(k) if self._logs_params(start + j)]
        out = {}
        for name, buf in scan.phist.items():
            js = list(range(k)) if buf.dim() <= 2 else big
            if js:
                vals = buf[torch.tensor(js, device=buf.device)].cpu().numpy()
                out[name] = dict(zip(js, vals))
        return out

    def _scan_step(self, scan: _Scan, pattern: StepPattern,
                   collect_params: bool) -> None:
        """One iteration on the carry: the schedule from row ``i`` of the
        device schedule, the new parameters and F into the carry's buffers,
        the scalars (and with ``collect_params`` the parameters) into row
        ``i`` of their device buffers, ``i`` advanced.  Nothing here reads a
        device value on the host."""
        sched = sched_from_row(scan.sched.index_select(0, scan.i)[0], pattern)
        data = {"y": scan.y, "valid": scan.valid, "F_prev": scan.F_prev}
        params, F, scalars = self._step(scan.params, data, sched,
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
        if collect_params:
            for name, v in scan.params.items():
                scan.phist[name].index_copy_(0, scan.i, v[None])
        scan.i.add_(1)

    def _run_uniform(self, scan: _Scan, pattern: StepPattern, n: int,
                     collect_params: bool) -> None:
        """n iterations of one pattern.  On a CUDA device the first
        iteration of a pattern not met before runs eagerly (it is the
        iteration itself and the warm-up of the capture: the kernels are
        built, every cached table exists), the step is then captured, and
        the rest are replays.  On the CPU every iteration is the step."""
        if self.device.type != "cuda":
            for _ in range(n):
                self._scan_step(scan, pattern, collect_params)
            return
        key = (pattern, collect_params)
        done = 0
        if key not in scan.graphs:
            self._scan_step(scan, pattern, collect_params)
            self.scan_stats["eager_steps"] += 1
            done = 1
            if n == 1:
                return
            t0 = time.perf_counter()
            scan.graphs[key] = self._capture(scan, pattern, collect_params)
            self.scan_stats["capture_s"] += time.perf_counter() - t0
        graph, launches, reduces = scan.graphs[key]
        replayed = self.scan_stats["replayed_launches"]
        for _ in range(n - done):
            graph.replay()
            self.scan_stats["replays"] += 1
            self.scan_stats["replayed_all_reduces"] += reduces
            for name, count in launches.items():
                replayed[name] = replayed.get(name, 0) + count

    def _capture(self, scan: _Scan, pattern: StepPattern,
                 collect_params: bool) -> tuple:
        """The step of ``pattern`` as a CUDA graph over the carry's buffers:
        (graph, the kernels one replay holds, by the name of their launch
        count, the all-reduces it holds).  The wrappers pass their launch
        sites once while the step is captured, which ``LAUNCHES`` counts as
        it counts an eager step; a replay passes none, so ``LAUNCHES`` does
        not see it.  A step that cannot be captured raises: ``run`` steps it
        eagerly."""
        if scan.pool is None:
            scan.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = dict(LAUNCHES)
        reduces = COLLECTIVES["all_reduce"]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=scan.pool)
                try:
                    self._scan_step(scan, pattern, collect_params)
                finally:
                    graph.capture_end()
        except RuntimeError as e:
            raise RuntimeError(
                f"run_scanned: the step with {pattern} could not be "
                "captured into a CUDA graph; EM.run steps it eagerly") from e
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.scan_stats["graphs"] += 1
        return graph, {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                       if LAUNCHES[k] != before[k]}, (COLLECTIVES["all_reduce"]
                                                      - reduces)

    # -- checkpoints -------------------------------------------------------------

    def _maybe_checkpoint(self) -> None:
        if (self.checkpoint_path and self.checkpoint_every
                and self.anneal.position - self._last_ckpt
                >= self.checkpoint_every):
            self._last_ckpt = self.anneal.position
            self.save_checkpoint()

    def save_checkpoint(self, path: Optional[str] = None) -> None:
        """Write the state a resumed run needs to ``path`` (default
        ``checkpoint_path``): the parameters, the annealer's position,
        the generator's state (after ``run_scanned``'s replays: the state
        the next step draws from), ``F_prev`` (the Ncut ranking reads it)
        and, with revival, the revival chain's state and its last firing.
        Under a runtime every rank calls it (the global ``F_prev``, every
        rank's rows in stride order without the padding, is gathered) and
        rank 0 writes."""
        extra = {"F_prev": self._global_F_prev()}
        if self.revive_duplicates is not None:
            extra["revive_rng"] = self.revival_rng_state()
            extra["revive_last"] = np.int64(self._last_revive)
        checkpoint.save(path or self.checkpoint_path, self.params,
                        step=self.anneal.position, generator=self.generator,
                        extra=extra)

    def resume(self, path: str) -> int:
        """Continue from the checkpoint at ``path`` (one ``save_checkpoint``
        wrote, or the JAX package's): parameters, annealer position,
        ``F_prev``, the generator's and the revival chain's state.  Without
        a generator state for this device (a JAX checkpoint, or one written
        on another device type) the noise chain goes on from the seed, with
        a warning.  Under a runtime each rank takes its rows of the global
        ``F_prev``.  Returns the step."""
        params, step, state, extra = checkpoint.restore_full(path,
                                                             self.device)
        self.anneal.reset(min(step, self.anneal.steps))
        self._last_ckpt = self._last_revive = self.anneal.position
        self.params = {k: v.contiguous() for k, v in params.items()}
        if "F_prev" in extra:
            F_prev = extra["F_prev"]
            if self.runtime is not None:
                if F_prev.shape != (self.N_global,):
                    raise ValueError(
                        f"{path}: F_prev has shape {F_prev.shape}, the "
                        f"data of every rank {(self.N_global,)}")
                mine = np.zeros(self.data["F_prev"].shape, np.float32)
                mine[:self._n_local] = F_prev[
                    self._row_offset:self._row_offset + self._n_local]
                F_prev = mine
            elif F_prev.shape != tuple(self.data["F_prev"].shape):
                raise ValueError(
                    f"{path}: F_prev has shape {F_prev.shape}, the padded "
                    f"data {tuple(self.data['F_prev'].shape)}")
            self.data = dict(self.data, F_prev=torch.as_tensor(
                F_prev, dtype=torch.float32, device=self.device))
        if state is not None:
            self.generator.set_state(state)
        else:
            warnings.warn(
                f"{path} holds no {self.device.type} generator state: the "
                "parameter noise and partial masks restart from the seed's "
                "chain", RuntimeWarning, stacklevel=2)
        if "revive_rng" in extra:
            self.restore_revival_rng(extra["revive_rng"])
        if "revive_last" in extra:
            self._last_revive = int(extra["revive_last"])
        return self.anneal.position

    def _init_rows(self):
        """The rows the default init reads: those with ``valid > 0``; under
        a runtime every rank's, in stride order, gathered on rank 0 (the
        other ranks' inits are replaced by rank 0's), so that the init is
        the one-process init of the whole data set."""
        y, valid = self.data["y"], self.data["valid"]
        if self.runtime is None:
            return y[valid > 0]
        ys = self.runtime.gather_host(y.cpu().numpy())
        vs = self.runtime.gather_host(valid.cpu().numpy())
        if ys is None:
            return y[valid > 0]
        return np.concatenate([a[v > 0] for a, v in zip(ys, vs)])

    def _global_F_prev(self):
        """``F_prev`` as a checkpoint holds it: this device's (padded)
        tensor without a runtime; under one, every rank's rows in stride
        order, gathered on the host (a collective: every rank calls it)."""
        if self.runtime is None:
            return self.data["F_prev"]
        return self.runtime.stride_order(self.data["F_prev"], self._n_locals)

    # -- the recovery protocol ---------------------------------------------------

    def _valid_rows(self) -> np.ndarray:
        """Indices of the rows with ``valid > 0``, read to the host once."""
        if self._revive_valid_rows is None:
            self._revive_valid_rows = np.flatnonzero(
                self.data["valid"].cpu().numpy() > 0)
        return self._revive_valid_rows

    def _maybe_revive_duplicates(self) -> None:
        """Re-initialise duplicate and dead columns of W (host numpy, the
        JAX package's arithmetic and random chain): given the same W, data,
        F_prev and chain state it writes the same W bit for bit.  Under a
        runtime every rank reaches this point at the same iteration (the
        gates read the host schedule): rank 0 revives on its own rows, the
        others skip the work, and ``_bcast_revived_W`` installs rank 0's W
        on every rank."""
        cfg = self.revive_duplicates
        if cfg is None or "W" not in self.params:
            return
        every, threshold, stop_frac, dead_norm_frac = cfg
        pos = self.anneal.position
        if (pos - self._last_revive < every
                or pos >= stop_frac * self.anneal.steps):
            return
        self._last_revive = pos
        W = self.params["W"].cpu().numpy().copy()
        if self.runtime is not None and self.runtime.rank != 0:
            self._bcast_revived_W(W, 0)
            return
        norms = np.linalg.norm(W, axis=0) + 1e-9
        C = (W / norms).T @ (W / norms)
        np.fill_diagonal(C, 0.0)
        used: set = set()
        revived = 0
        rows = self._valid_rows()
        if self.reseed_worst_frac > 0.0:
            F = self.data["F_prev"].cpu().numpy()[rows]
            k = max(1, int(self.reseed_worst_frac * rows.size))
            rows = rows[np.argsort(F)[:k]]

        split_norm_frac = self.split_norm_frac
        median_norm = float(np.median(norms))
        if split_norm_frac <= 0.0:
            split_pool = []
        elif self.split_coact:
            # blends sit below the median norm (the M-step rescales them)
            # but their support is ~2x an atom's: the pool ranks by support
            # (the diagnosis module's statistic); a norm floor keeps
            # near-dead noise columns out
            st = dictionary_stats(W)
            sup_sizes = st["support"]
            med_sup = max(float(st["median_support"]), 1.0)
            norm_floor = 0.3 * st["median_norm"]
            split_pool = [int(h) for h in np.argsort(-sup_sizes)
                          if sup_sizes[h] >= split_norm_frac * med_sup
                          and norms[h] >= norm_floor]
        else:
            # symmetric split: a fused pair of atoms carries ~sqrt(2)x the
            # energy of one
            split_pool = [int(h) for h in np.argsort(norms)[::-1]
                          if norms[h] > split_norm_frac * median_norm]

        def reinit(col: int) -> None:
            # prefer splitting a suspected blend: read the partition off the
            # data (co-activation) or seed the freed column and the blend
            # with symmetric +/- perturbations
            while split_pool:
                b = split_pool.pop(0)
                if b in used or b == col:
                    continue
                if self.split_coact:
                    parts = coactivation_split(
                        W[:, b].astype(np.float64), self._coact_rows())
                    if parts is None:
                        self.revival_stats["coact_rejected"] += 1
                        continue          # not a clean blend: next candidate
                    W[:, b] = parts[0].astype(np.float32)
                    W[:, col] = parts[1].astype(np.float32)
                    self.revival_stats["coact_split"] += 1
                else:
                    eps = 0.3 * norms[b] / np.sqrt(W.shape[0])
                    noise = (eps * self._revive_rng.standard_normal(
                        W.shape[0])).astype(np.float32)
                    W[:, col] = W[:, b] + noise
                    W[:, b] = W[:, b] - noise
                    self.revival_stats["sym_split"] += 1
                used.add(b)
                return
            idx = int(rows[self._revive_rng.integers(0, rows.size)])
            sample = self.data["y"][idx].cpu().numpy()
            noise = self._revive_rng.standard_normal(W.shape[0])
            W[:, col] = 0.5 * sample + 0.5 * noise.astype(np.float32)
            self.revival_stats["reseeded"] += 1

        for h in range(W.shape[1]):
            j = int(np.argmax(C[h]))
            if C[h, j] > threshold and h not in used and j not in used:
                weaker = j if norms[j] <= norms[h] else h
                reinit(weaker)
                used.update((h, j))
                revived += 1
        if dead_norm_frac > 0.0:
            floor = dead_norm_frac * median_norm
            for h in range(W.shape[1]):
                if h not in used and norms[h] < floor:
                    reinit(h)
                    used.add(h)
                    revived += 1
        self.revival_stats["revived"] += revived
        if self.runtime is not None:
            self._bcast_revived_W(W, revived)
        elif revived:
            self.params = dict(self.params, W=torch.as_tensor(
                W, device=self.device))

    def _bcast_revived_W(self, W: np.ndarray, revived: int) -> None:
        """Rank 0's W and whether it revived anything, broadcast on the
        host; every rank installs the same W (a collective: every rank
        calls it)."""
        W = self.runtime.broadcast_host(np.ascontiguousarray(W, np.float32))
        flag = self.runtime.broadcast_host(np.asarray([revived], np.int64))
        if int(flag[0]):
            self.params = dict(self.params, W=torch.as_tensor(
                W, device=self.device))

    def revival_rng_state(self) -> np.ndarray:
        """Revival PCG64 state as a (6,) uint64 array (checkpointable)."""
        st = self._revive_rng.bit_generator.state
        s, inc = st["state"]["state"], st["state"]["inc"]
        m = (1 << 64) - 1
        return np.array([s & m, s >> 64, inc & m, inc >> 64,
                         int(st["has_uint32"]), st["uinteger"]], np.uint64)

    def restore_revival_rng(self, arr) -> None:
        """Inverse of revival_rng_state (applied by ``resume``)."""
        a = [int(v) for v in np.asarray(arr, np.uint64)]
        self._revive_rng.bit_generator.state = {
            "bit_generator": "PCG64",
            "state": {"state": a[0] | (a[1] << 64),
                      "inc": a[2] | (a[3] << 64)},
            "has_uint32": a[4], "uinteger": a[5]}

    def _coact_rows(self) -> np.ndarray:
        """Host subsample of up to 65536 valid datapoints (float64) for
        blend splitting, strided over the whole data set (under a runtime
        rank 0's rows); read from the device once per run."""
        if self._coact_sample is None:
            rows = self._valid_rows()
            take = rows[:: max(1, -(-rows.size // 65536))][:65536]
            self._coact_sample = self.data["y"][torch.as_tensor(
                take, device=self.device)].cpu().numpy().astype(np.float64)
        return self._coact_sample
