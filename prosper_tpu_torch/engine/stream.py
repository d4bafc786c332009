"""Host-to-device streaming EM: training on more rows than the card holds.

Counterpart of ``prosper_tpu/engine/stream.py``.  The data
set stays on the host (any sliceable (N, D) array: an ``np.ndarray``, an
``np.memmap``, an h5py dataset) and the card holds two segments of
``seg_size`` rows at a time: segment k + 1 uploads on a copy stream while
segment k's E-step runs (``utils/staging.py::SegmentUploader``).  Where the
whole padded data set fits ``cache_bytes`` of device memory, every segment
stays on the card after the first pass and later iterations upload nothing.

Each iteration mirrors the models' own ``step_fn``: ``noisify`` once, then
per segment the ``partial`` mask (only where the schedule subsamples), the
Ncut cut and the family's ``estep_sums``, the segments' sums added on the
device, and one ``finalize_mstep`` over all N rows.  The free energies that
rank the Ncut cut (``F_prev``, N floats) stay on the device, and the cut's
threshold is computed before the pass by the device's own
``core/select.py::global_quantile_threshold`` over all rows, so with
``partial`` off the masks and the generator's draws are those of the
in-memory ``EM``; the parameters differ from its by the order of the float32
sums alone (where the in-memory E-step cuts its rows into chunks of the
segments' size, as the CUDA wrappers do with ``cuda_lib.P_LIMIT_BYTES`` and
the plain versions with ``model.chunk``, the two agree bit for bit).  With
``partial`` < 1 the JAX package's two documented
deviations hold: an exact-count mask per segment (kept counts
sum_seg ceil(frac * n_seg)), and the Ncut threshold ranks all valid rows
before the partial mask intersects it.

With a ``MeshRuntime`` each rank streams its own host shard (its
``stride_data`` rows): the segment geometry comes from the longest shard, so
every rank runs the same number of segments in lockstep (a short rank's
last ones may hold padding only), the threshold reduces over the ranks, and
the pass's sums are reduced once, in ``finalize_mstep``, as the in-memory
step reduces them (the JAX package reduces per segment), so a streamed run
equals the in-memory run under the same runtime with the same row cut.  A
checkpoint holds the global ``F_prev`` in stride order; rank 0 writes it.
Under a ``("data", "state")`` mesh the shards are those of the data axis
(the ranks of a state group stream the same rows) and each segment's
E-step runs on the rank's slice of the states, its all-reduces over the
state group in the same lockstep (the JAX package passes the state
keywords to ``estep_sums`` the same way).

``host_quantile_threshold`` is the host twin of the device threshold, kept
as the JAX package keeps it.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from prosper_tpu_torch.core.etstep import truncated_prior_logmass
from prosper_tpu_torch.core.select import (exact_count_mask,
                                           global_quantile_threshold,
                                           ncut_keep_count)
from prosper_tpu_torch.io import checkpoint
from prosper_tpu_torch.io.weights import params_from_numpy
from prosper_tpu_torch.models.base import device_sched, sched_floats, to_numpy
from prosper_tpu_torch.parallel.mesh import (check_runtime, local_device,
                                             maybe_psum)
from prosper_tpu_torch.utils.staging import SegmentUploader


def host_quantile_threshold(values: np.ndarray, valid: np.ndarray,
                            keep_count: float, rounds: int = 3,
                            bins: int = 128, allreduce=None) -> float:
    """Host twin of ``core/select.py::global_quantile_threshold``: the same
    float32 histogram bisection, step for step, with the bin edge
    ``lo = b_star * width + lo`` rounded once (as a fused multiply-add), so
    both pick the same threshold and induce the same mask.

    ``allreduce``: optional ``(x, op) -> x`` with op in {"sum", "min",
    "max"}, the reduction over the ranks (``MeshRuntime.allreduce_host``):
    ``values`` are this rank's rows, and the extent and the bin counts are
    combined over all of them."""
    red = allreduce if allreduce is not None else (lambda x, _op: x)
    f32 = np.float32
    values = np.asarray(values, f32)
    ok = np.asarray(valid) > 0
    big = f32(3e38)
    v = np.where(ok, values, -big)
    lo = f32(red(np.where(ok, values, big).min(), "min"))
    hi = f32(red(v.max(), "max"))
    hi = f32(hi + max(f32(1e-6) * abs(hi), f32(1e-6)))
    keep = f32(keep_count)
    bidx = np.arange(bins)
    for _ in range(rounds):
        width = max(f32((hi - lo) / f32(bins)), f32(1e-30))
        with np.errstate(over="ignore"):      # the invalid rows' -3e38
            idx = np.clip(np.floor((v - lo) / width), 0,
                          bins - 1).astype(np.int64)
        hist = red(np.bincount(idx[ok], minlength=bins).astype(f32), "sum")
        tail = np.cumsum(hist[::-1], dtype=f32)[::-1]
        b_star = int(np.where(tail >= keep, bidx, 0).max())
        lo = f32(np.float64(b_star) * np.float64(width) + np.float64(lo))
        hi = f32(lo + width)
    return float(lo)


class StreamingEM:
    """EM over a host-resident data set, streamed segment by segment.

    Parameters
    ----------
    model : an ET model with ``estep_sums`` / ``finalize_mstep`` (BSC, TSC,
        DSC, MCA, MMCA, GSC).  The mixtures fit in device memory by
        construction (``EM``); ``ncut_current`` needs a second pass.
    anneal : LinearAnnealing.
    y : host (N, D) sliceable array (``np.ndarray``, ``np.memmap``, h5py
        dataset); read as float32.
    seg_size : rows per device segment, rounded up to a multiple of
        ``model.chunk``; the rolling tier holds 2 * seg_size * D * 4 bytes
        of data on the card.
    params : initial parameters; default ``model.standard_init`` on the
        first segment's rows (pass them for an exact comparison with
        ``EM``).
    cache_bytes : when the padded data set fits this many bytes, every
        segment stays on the card after the first pass (None or 0: off).
    checkpoint_path, checkpoint_every : as ``EM``'s; a checkpoint holds the
        parameters, the step, the generator's state and ``F_prev``.
    runtime : a ``parallel.mesh.MeshRuntime``: ``y`` is this rank's shard,
        and the ranks train one model in lockstep (module docstring).
    device : where the segments, parameters and random numbers live
        (``"cuda"``; the CPU only when asked; under a runtime its device).
    """

    def __init__(self, model, anneal, y, seg_size: int = 1 << 20,
                 params: Optional[Dict] = None, seed: int = 42,
                 dlog=None, log_params_every: int = 1,
                 cache_bytes: Optional[int] = 8 << 30,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0, runtime=None, device=None):
        if not (hasattr(model, "estep_sums")
                and hasattr(model, "finalize_mstep")):
            raise TypeError(
                f"{type(model).__name__} does not expose the streaming "
                "protocol (estep_sums + finalize_mstep); the ET families "
                "(BSC/TSC/DSC, MCA/MMCA, GSC) do -- mixtures fit in device "
                "memory by construction, use EM")
        if getattr(model, "ncut_current", False):
            raise ValueError(
                "ncut_current (the same-iteration Ncut ranking) needs a "
                "second E-step pass per iteration and is not supported by "
                "StreamingEM; use the default lagged ranking or "
                "the in-memory EM")
        self.runtime = runtime
        self.group = None
        if runtime is not None:
            check_runtime(runtime)
            if device is not None and local_device(device) != runtime.device:
                raise ValueError(f"StreamingEM(device={device!r}) differs "
                                 f"from the runtime's device "
                                 f"{runtime.device}")
            device, self.group = runtime.device, runtime.data_group
        self.model = model
        self.anneal = anneal
        self.dlog = dlog
        self.log_params_every = log_params_every
        self.device = torch.device("cuda" if device is None else device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.y = y
        #: rows of this rank; every rank's counts in rank order, the global
        #: count and this rank's offset in the global (stride) row order
        self.N = int(y.shape[0])
        self._n_locals = (runtime.n_locals(self.N) if runtime is not None
                          else np.asarray([self.N], np.int64))
        self.N_global = int(self._n_locals.sum())
        self._row_offset = (int(self._n_locals[:runtime.data_index].sum())
                            if runtime is not None else 0)
        #: the state axis's keywords for the E-step and the M-step (none
        #: without a state axis of more than one shard)
        self._state_kw = ({} if runtime is None
                          else runtime.state_kwargs(model.estep_sums))
        c = max(int(model.chunk), 1)
        N_for_seg = int(self._n_locals.max())
        seg = min(int(seg_size), max(N_for_seg, 1))
        self.seg_size = -(-seg // c) * c
        self.n_seg = -(-N_for_seg // self.seg_size)
        rows = self.n_seg * self.seg_size
        total = rows * int(y.shape[1]) * 4
        self._cache_all = bool(cache_bytes) and total <= int(cache_bytes)
        self.uploader = SegmentUploader(y, self.seg_size, self.device,
                                        cache_all=self._cache_all,
                                        n_seg=self.n_seg)
        self.valid = (torch.arange(rows, device=self.device)
                      < self.N).float()
        #: this rank's valid rows (``finalize_mstep`` sums them over the
        #: ranks) and all ranks' (the Ncut keep count)
        self.N_total = self.valid.sum()
        self._N_all = maybe_psum(self.valid.sum(), self.group)
        #: the lagged per-row free energies that rank the Ncut cut, on the
        #: device (rows past N are padding)
        self.F_prev = torch.zeros(rows, dtype=torch.float32,
                                  device=self.device)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self._last_ckpt = anneal.position
        if params is None:
            probe = np.asarray(y[:min(self.seg_size, self.N)], np.float32)
            params = model.standard_init({"y": probe}, seed=seed,
                                         device=self.device)
        self.params = params_from_numpy(
            {k: to_numpy(v) for k, v in params.items()}, self.device)
        if runtime is not None:
            # every rank probed its own rows: rank 0's parameters for all
            self.params = runtime.replicate(self.params)
        self.history: list = []

    def _next_needs_F(self) -> bool:
        """Whether the next iteration's Ncut cut reads this one's F."""
        pos = self.anneal.position
        try:
            self.anneal.position = min(pos + 1, self.anneal.steps - 1)
            return sched_floats(self.anneal)["Ncut_factor"] > 0.0
        finally:
            self.anneal.position = pos

    def step_once(self, verbose: bool = False) -> Dict[str, float]:
        t0 = time.perf_counter()
        model, up, seg = self.model, self.uploader, self.seg_size
        sched = device_sched(sched_floats(self.anneal), self.device)
        pattern = sched["pattern"]
        params = model.noisify(self.params, sched, self.generator)
        if pattern.ncut:
            # the threshold over all rows from the lagged F, before the pass
            logA, _ = truncated_prior_logmass(model.log_pi_active(params),
                                              model.H, model.gamma)
            keep = ncut_keep_count(self._N_all, sched["Ncut_factor"], logA)
            thresh = global_quantile_threshold(self.F_prev, self.valid, keep,
                                               group=self.group)
        keep_F = self._next_needs_F()

        acc = None
        up.put(0)
        for k in range(self.n_seg):
            rows = slice(k * seg, (k + 1) * seg)
            y_seg = up.get(k)
            valid = self.valid[rows]
            w = (exact_count_mask(self.generator, seg, sched["partial"],
                                  valid=valid, group=self.group)
                 if pattern.partial else valid)
            if pattern.ncut:
                w = w * (self.F_prev[rows] >= thresh).float()
            F, sums = model.estep_sums(params, y_seg, w, sched,
                                       **self._state_kw)
            up.release(k)
            if keep_F:
                self.F_prev[rows] = F
            acc = sums if acc is None else {n: acc[n] + v
                                            for n, v in sums.items()}
            if k + 1 < self.n_seg:
                up.put(k + 1)
        self.params, scalars = model.finalize_mstep(
            params, acc, self.N_total, self.group, **self._state_kw)

        vals = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                            device=self.device)
                            for v in scalars.values()]).tolist()
        out = dict(zip(scalars, vals))
        out["iteration"] = self.anneal.position
        out["T"] = float(self.anneal["T"])
        out["dt"] = time.perf_counter() - t0
        self.history.append(out)
        if self.dlog is not None:
            rec = dict(out)
            big = bool(self.log_params_every and self.anneal.position
                       % self.log_params_every == 0)
            for k, v in self.params.items():
                if v.dim() <= 1 or big:
                    rec[k] = v
            self.dlog.append_all(rec)
        if verbose:
            print(f"[stream-em] iter {self.anneal.position:4d} "
                  f"F/N={out['F_mean']:+.4f} n_used={out['n_used']:.0f} "
                  f"segs={self.n_seg} dt={out['dt'] * 1e3:.0f}ms", flush=True)
        self.anneal.next()
        self._maybe_checkpoint()
        return out

    def run(self, verbose: bool = False) -> Dict[str, torch.Tensor]:
        """Run until the schedule is exhausted, then ``close()``; returns
        the parameters."""
        try:
            while not self.anneal.finished:
                self.step_once(verbose=verbose)
        finally:
            self.close()
        return self.params

    def close(self) -> None:
        """Give back the device segments and the host registration (the
        next step sets them up again)."""
        self.uploader.close()

    # -- checkpoints -----------------------------------------------------------

    def _maybe_checkpoint(self) -> None:
        if (self.checkpoint_path and self.checkpoint_every
                and self.anneal.position - self._last_ckpt
                >= self.checkpoint_every):
            self._last_ckpt = self.anneal.position
            self.save_checkpoint()

    def save_checkpoint(self, path: Optional[str] = None) -> None:
        """Write the parameters, the step, the generator's state and
        ``F_prev`` (N floats; under a runtime every rank's, in stride order)
        to ``path`` (default ``checkpoint_path``), in the layout of
        ``EM.save_checkpoint``.  Under a runtime every rank calls it and
        rank 0 writes."""
        checkpoint.save(path or self.checkpoint_path, self.params,
                        step=self.anneal.position, generator=self.generator,
                        extra={"F_prev": self._global_F_prev()})

    def _global_F_prev(self):
        """Every rank's ``F_prev`` rows in stride order (a collective under
        a runtime), or this rank's."""
        if self.runtime is None:
            return self.F_prev[:self.N]
        return self.runtime.stride_order(self.F_prev, self._n_locals)

    def resume(self, path: str) -> int:
        """Continue from the checkpoint at ``path`` on the trajectory it
        left: parameters, step, the generator's state and ``F_prev``.
        Raises ValueError, changing nothing, where the checkpoint holds no
        generator state for this device type (the noise and the partial
        masks could not follow the same chain) or an ``F_prev`` of another
        length than N (under a runtime: than every rank's N together; each
        rank takes its own rows).  Returns the step."""
        params, step, state, extra = checkpoint.restore_full(path,
                                                             self.device)
        if state is None:
            raise ValueError(
                f"{path} holds no {self.device.type} generator state: a "
                "streamed run resumes from a checkpoint of this package "
                f"written on a {self.device.type} device")
        F_prev = extra.get("F_prev")
        if F_prev is not None and F_prev.shape != (self.N_global,):
            raise ValueError(f"{path}: F_prev has shape {F_prev.shape}, the "
                             f"data set {(self.N_global,)}")
        if F_prev is not None:
            F_prev = F_prev[self._row_offset:self._row_offset + self.N]
        self.params = {k: v.contiguous() for k, v in params.items()}
        self.generator.set_state(state)
        if F_prev is not None:
            self.F_prev[:self.N] = torch.as_tensor(
                np.asarray(F_prev, np.float32), device=self.device)
        step = min(int(step), self.anneal.steps)
        self.anneal.reset(step)
        self._last_ckpt = step
        return step
