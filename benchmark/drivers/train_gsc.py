"""GSC training traffic (kind ``train_gsc``): ``drivers/train.py``'s runs
for the spike-and-slab model.

The same schedule, windows and checks as ``train``: fresh 120-iteration
``EM`` runs back to back through ``EM.run_scanned``, run 0's first
iterations and a ``checked_cut`` segment held to a plain reference.  What
differs is the model's: the rows come from the GSC generative model
(``slab_rows``: binary supports times Gaussian slabs of mean ``mu`` and
variance ``psi`` on the planted dictionary), a run starts from
``data.init_params`` with mu = 0 and psi = 1 (what ``GSC`` starts from),
the reference is ``reference_gsc.py`` and the check covers all five
parameters.  One chip.

The port's spans are switched with ``--trace`` (``io.tracing.enable``):
with them on, each window ``EM``'s ``scan_stats["layer_ms"]`` (device ms a
region: ``estep``, ``ncut``, ``mstep``, and inside the E-step
``slab_solve`` and ``slab_moments``) and ``["timed_iterations"]`` are
summed over the window into the counters ``layer_ms`` and
``timed_iterations``, which the per-layer metrics read.  Off, the spans
cost a flag check and nothing is timed.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List

import torch

from benchmark import data, reference, reference_gsc, trace
from benchmark.drivers import train
from benchmark.harness import PHASES, Ctx, build_model, open_device, phase, rel
from benchmark.trace import Summary, Window

#: rows a call of the generator makes at once
BLOCK = 65536


def slab_rows(W: torch.Tensor, N: int, pi: float, sigma: float, mu: float,
              psi: float, g: torch.Generator) -> torch.Tensor:
    """(N, D) float32 rows of the GSC generative model on W's device:
    s_h = b_h z_h with P(b_h = 1) = pi and z_h ~ N(mu, psi), the mean W s
    (in float64, rounded once), plus sigma times standard normal noise."""
    D, H = W.shape
    y = torch.empty((N, D), dtype=torch.float32, device=W.device)
    for i in range(0, N, BLOCK):
        b = min(BLOCK, N - i)
        on = torch.rand((b, H), generator=g, device=W.device) < pi
        z = mu + math.sqrt(psi) * torch.randn((b, H), generator=g,
                                              device=W.device)
        s = torch.where(on, z, torch.zeros_like(z))
        ybar = torch.matmul(s.double(), W.double().T).float()
        y[i:i + b] = ybar + sigma * torch.randn((b, D), generator=g,
                                                device=W.device)
    return y


def training_data(cfg: Dict, seed: int, n_rows: int, device):
    """The cell's rows and the planted dictionary they come from."""
    p = cfg["planted"]
    W = data.planted_dictionary(cfg["D"], cfg["H"], p["active_pixels"],
                                p["intensity"],
                                data.generator(device, seed, "dict"), device)
    y = slab_rows(W, n_rows, p["pi_times_H"] / cfg["H"], p["sigma"], p["mu"],
                  p["psi"], data.generator(device, seed, "rows", 0))
    return W, y


def init_params(mean, std, H: int, g) -> Dict[str, torch.Tensor]:
    """``data.init_params`` and the slab's start, mu = 0 and psi = 1."""
    p = data.init_params(mean, std, H, g)
    dev = p["W"].device
    p["mu"] = torch.tensor(0.0, dtype=torch.float32, device=dev)
    p["psi"] = torch.tensor(1.0, dtype=torch.float32, device=dev)
    return p


def port_of(em) -> Dict:
    """What the check compares of an ``EM``: its free energies per
    iteration and its five parameters."""
    return {"F_mean": [h["F_mean"] for h in em.history],
            "Q_mean": [h["Q_mean"] for h in em.history],
            **{p: em.params[p].clone() for p in reference_gsc.PARAMS}}


def setup(ctx: Ctx) -> Dict:
    """Rows, models and run 0 driven through its checked iterations, the
    spans switched as ``--trace`` asks: what the window starts from."""
    from prosper_tpu_torch import EM
    from prosper_tpu_torch.io import tracing
    phase("import program", ctx.started)
    tracing.enable(ctx.trace)
    dev = torch.device(ctx.device)
    open_device(ctx, dev)
    cfg, tr = ctx.cfg, ctx.traffic
    model = build_model(cfg)
    _, y = training_data(cfg, ctx.seed, tr["rows"], dev)
    mean, std = data.moments(y)

    def init(run):
        return init_params(mean, std, cfg["H"],
                           data.generator(dev, ctx.seed, "init", run))

    def new_em(run, steps: int, schedule=None):
        return EM(model, train.anneal(schedule or tr["schedule"], steps),
                  {"y": y}, params=init(run),
                  seed=data.derive(ctx.seed, "em", run), device=dev)

    train.sync(dev)
    phase("rows", ctx.started)
    warm = new_em(-1, tr["warmup_iterations"])
    warm.run_scanned()
    del warm
    train.sync(dev)
    phase("warm-up", ctx.started)
    em = new_em(0, tr["iterations"])
    em.run_scanned(tr["checked_iterations"])
    train.sync(dev)
    phase("checked steps", ctx.started)
    return {"dev": dev, "y": y, "init": init, "new_em": new_em, "em": em,
            "port": port_of(em)}


def _tally(counters: Dict, em, sign: float = 1.0) -> None:
    """Add (or with ``sign`` -1 take away) an ``EM``'s capture seconds,
    layer ms and timed iterations to the window's counters."""
    st = em.scan_stats
    counters["capture_s"] += sign * st["capture_s"]
    counters["timed_iterations"] += int(sign) * st["timed_iterations"]
    for name, ms in st["layer_ms"].items():
        counters["layer_ms"][name] = (counters["layer_ms"].get(name, 0.0)
                                      + sign * ms)


def run_rank(ctx: Ctx, rank: int = 0, world: int = 1, runtime=None) -> Dict:
    if world != 1 or runtime is not None:
        raise ValueError("the train_gsc driver runs on one chip")
    tr = ctx.traffic
    st = setup(ctx)
    dev, em, new_em = st["dev"], st["em"], st["new_em"]
    counters = {"iterations": 0, "rows": tr["rows"], "runs": 1,
                "capture_s": 0.0, "layer_ms": {}, "timed_iterations": 0}
    # the checked iterations ran before the window
    _tally(counters, em, -1.0)
    with Window(ctx.trace, dev) as w:
        setup_s = time.time() - ctx.started
        while True:
            if em.anneal.finished:
                _tally(counters, em)
                em = st["em"] = None
                em = new_em(counters["runs"], tr["iterations"])
                counters["runs"] += 1
            n = min(tr["window_iterations"],
                    em.anneal.steps - em.anneal.position)
            em.run_scanned(n)
            counters["iterations"] += n
            if w.elapsed() >= ctx.seconds:
                break
    _tally(counters, em)
    out = {"setup_s": setup_s, "phases": dict(PHASES), "window_s": w.seconds,
           "attempted": counters["iterations"], "failed": 0,
           "counters": counters,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0)}
    t0 = time.perf_counter()
    summary = summarize(w)
    out["trace"] = summary.as_dict() if summary is not None else None
    if summary is not None:
        print(f"[time] the trace took {time.perf_counter() - t0:.3f} s to "
              "reduce", file=sys.stderr, flush=True)
    em = st["em"] = None
    cut = run_cut(ctx, st)
    # the window's models are freed before the reference runs
    gc.collect()
    t0 = time.perf_counter()
    out["values"] = compare(st["port"], follow(ctx, st["y"], st["init"](0),
                                               dev))
    if cut is not None:
        out["values"].update(compare(cut, follow(
            ctx, st["y"], st["init"]("cut"), dev, segment="cut"), ".cut"))
    out["reference_s"] = time.perf_counter() - t0
    return out


def summarize(w: Window):
    """``w.summary()`` for a window of millions of small kernels: each
    kernel name is classified once (``trace.Summary`` matches every
    event's name against each class, minutes at this cell's ~10^5 kernels
    a second), and the spans' device-side ranges (``prosper::``, which
    the profiler copies onto the device's timeline when the spans are on)
    are left out of the busy time, which counts kernels and copies
    alone."""
    from prosper_tpu_torch.io.tracing import PREFIX
    if w.prof is None:
        return None
    dev, host = trace.raw_events(w.prof)
    dev = [e for e in dev if not e[0].startswith(PREFIX)]
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    s = Summary.__new__(Summary)
    s.window_s = w.seconds
    s.busy_s, merged = trace.union_seconds([(a, b) for _, a, b in dev])
    s.by_name, count = {}, {}
    for name, a, b in dev:
        s.by_name[name] = s.by_name.get(name, 0.0) + (b - a)
        count[name] = count.get(name, 0) + 1
    classes = trace.kernel_classes()
    s.by_class, s.count_by_class = {}, {}
    for name, seconds in s.by_name.items():
        cls = trace.classify(name, classes)
        if cls is not None:
            s.by_class[cls] = s.by_class.get(cls, 0.0) + seconds
            s.count_by_class[cls] = s.count_by_class.get(cls, 0) + count[name]
    s.device_ops = sorted(s.by_name.items(), key=lambda kv: -kv[1])[:10]
    s.idle_gaps = s._gaps(merged, host)
    return s


def run_cut(ctx: Ctx, st: Dict):
    """The program's side of the mix's ``checked_cut`` segment (None where
    the mix has none): a fresh ``EM`` through ``run_scanned``."""
    seg = ctx.traffic.get("checked_cut")
    if seg is None:
        return None
    em = st["new_em"]("cut", seg["iterations"], seg["schedule"])
    em.run_scanned()
    train.sync(st["dev"])
    return port_of(em)


def follow(ctx: Ctx, y, init: Dict, dev, prec: str = "float64",
           segment: str = "run 0", **faults) -> List[Dict]:
    """The reference's iterations over the rows: run 0's first
    ``checked_iterations``, or (``segment="cut"``) the whole
    ``checked_cut`` segment.  ``faults`` go to ``reference_gsc.em_steps``
    (``rows_used``, ``cut``, ``slab_cov``)."""
    cfg, tr = ctx.cfg, ctx.traffic
    if segment == "cut":
        seg = tr["checked_cut"]
        schedule, steps, n, run = (seg["schedule"], seg["iterations"],
                                   seg["iterations"], "cut")
    else:
        schedule, steps, n, run = (tr["schedule"], tr["iterations"],
                                   tr["checked_iterations"], 0)
    g = torch.Generator(device=dev)
    g.manual_seed(data.derive(ctx.seed, "em", run))

    def noise(t):
        return torch.randn((cfg["D"], cfg["H"]), generator=g, device=dev,
                           dtype=torch.float32)
    return reference_gsc.em_steps(cfg, [y], init, schedule, steps, n, noise,
                                  reference.Prec(prec), **faults)


def compare(port: Dict, ref: List[Dict], suffix: str = ""
            ) -> Dict[str, float]:
    """``F_rel``: the largest relative gap of the free energy per datapoint
    (annealed and un-annealed) over the iterations compared;
    ``param_rel``: the largest relative gap |x - x_ref| / |x_ref| of W, pi,
    sigma, mu and psi after the last.  ``suffix`` ends both names."""
    F = max(max(abs(p - r["F_mean"]) / abs(r["F_mean"]),
                abs(q - r["Q_mean"]) / abs(r["Q_mean"]))
            for p, q, r in zip(port["F_mean"], port["Q_mean"], ref))
    last = ref[-1]
    return {"F_rel" + suffix: F,
            "param_rel" + suffix: max(rel(port[p], last[p])
                                      for p in reference_gsc.PARAMS)}


finish = train.finish
