"""Training traffic: EM training runs back to back through ``EM.run_scanned``.

Each run is a fresh ``EM`` from fresh initial parameters (the run's index
seeds them, as ``run_restarts`` builds its runs), under the mix's schedule
of ``iterations`` iterations, called in windows of ``window_iterations``.
Set-up makes the rows on the device, warms every pattern of the schedule up
in an ``EM`` of ``warmup_iterations`` iterations, and drives run 0 through
its first ``checked_iterations`` iterations by the same call; the window
continues run 0 and starts the next runs until ``--seconds`` have passed,
ending when the last call begun before then has synchronised.  On several
chips every rank holds ``rows`` rows of its own (one process a card, NCCL),
and rank 0 decides for all when the window ends.

``correct``: the plain reference (``reference.py``, float64) follows run 0's
checked iterations from the same initial parameters over every rank's rows,
drawing the W noise itself from run 0's seed, as the program's generator
draws it; the free energies of each iteration and W, pi and sigma after the
last are compared.  Where the mix names a ``checked_cut`` segment, a fresh
``EM`` runs it through ``run_scanned`` on the same rows once the window has
closed (two iterations of a pattern: an eager step, then a replay), and the
reference follows it too, its data cut with it: the patterns of the run's
second half, at T = 1 with no noise, without and with the cut.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

from benchmark import data, reference
from benchmark.harness import (PHASES, Ctx, build_model, open_device, phase,
                               rel)
from benchmark.trace import Window


def anneal(schedule: Dict, steps: int):
    from prosper_tpu_torch import LinearAnnealing
    a = LinearAnnealing(steps)
    for name, points in schedule.items():
        a[name] = [tuple(p) for p in points]
    return a


def port_of(em) -> Dict:
    """What the check compares of an ``EM``: its free energies per
    iteration and its parameters."""
    return {"F_mean": [h["F_mean"] for h in em.history],
            "Q_mean": [h["Q_mean"] for h in em.history],
            **{p: em.params[p].clone() for p in ("W", "pi", "sigma")}}


def setup(ctx: Ctx, rank: int = 0, runtime=None) -> Dict:
    """Rows, models and run 0 driven through its checked iterations: what
    the window starts from."""
    import torch

    from prosper_tpu_torch import EM
    phase("import program", ctx.started)
    dev = runtime.device if runtime is not None else torch.device(ctx.device)
    open_device(ctx, dev)
    cfg, tr = ctx.cfg, ctx.traffic
    model = build_model(cfg)
    N, H = tr["rows"], cfg["H"]
    _, y = data.training_data(cfg, ctx.seed, N, rank, dev)
    # every rank trains from rank 0's parameters (EM broadcasts them)
    mean, std = data.moments(y)

    def init(run):
        return data.init_params(mean, std, H,
                                data.generator(dev, ctx.seed, "init", run))

    def new_em(run, steps: int, schedule=None):
        return EM(model, anneal(schedule or tr["schedule"], steps),
                  {"y": y}, params=init(run),
                  seed=data.derive(ctx.seed, "em", run), device=dev,
                  runtime=runtime)

    sync(dev)
    phase("rows", ctx.started)
    warm = new_em(-1, tr["warmup_iterations"])
    warm.run_scanned()
    del warm
    sync(dev)
    phase("warm-up", ctx.started)
    em = new_em(0, tr["iterations"])
    em.run_scanned(tr["checked_iterations"])
    sync(dev)
    phase("checked steps", ctx.started)
    return {"dev": dev, "y": y, "init": init, "new_em": new_em, "em": em,
            "port": port_of(em)}


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cut(ctx: Ctx, st: Dict):
    """The program's side of the mix's ``checked_cut`` segment (None where
    the mix has none): a fresh ``EM`` through ``run_scanned``."""
    seg = ctx.traffic.get("checked_cut")
    if seg is None:
        return None
    em = st["new_em"]("cut", seg["iterations"], seg["schedule"])
    em.run_scanned()
    sync(st["dev"])
    return port_of(em)


def shards(ctx: Ctx, st: Dict, world: int) -> List:
    """Every rank's rows, remade on this rank's device from the seed."""
    return [st["y"]] + [data.training_data(ctx.cfg, ctx.seed,
                                           ctx.traffic["rows"], r,
                                           st["dev"])[1]
                        for r in range(1, world)]


def run_rank(ctx: Ctx, rank: int = 0, world: int = 1, runtime=None) -> Dict:
    import torch
    import torch.distributed as dist
    tr = ctx.traffic
    st = setup(ctx, rank, runtime)
    dev, em, new_em = st["dev"], st["em"], st["new_em"]
    capture = -em.scan_stats["capture_s"]
    runs, iters = 1, 0
    if runtime is not None:
        dist.barrier()

    def stop(local: bool) -> bool:
        if runtime is None:
            return local
        flag = torch.tensor([float(local)], device=dev)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    with Window(ctx.trace, dev) as w:
        setup_s = time.time() - ctx.started
        while True:
            if em.anneal.finished:
                capture += em.scan_stats["capture_s"]
                em = st["em"] = None
                em = new_em(runs, tr["iterations"])
                runs += 1
            n = min(tr["window_iterations"],
                    em.anneal.steps - em.anneal.position)
            em.run_scanned(n)
            iters += n
            if stop(w.elapsed() >= ctx.seconds):
                break
    capture += em.scan_stats["capture_s"]
    out = {"setup_s": setup_s, "phases": dict(PHASES), "window_s": w.seconds,
           "attempted": iters, "failed": 0,
           "counters": {"iterations": iters, "rows": tr["rows"],
                        "runs": runs, "capture_s": capture},
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0)}
    summary = w.summary()
    out["trace"] = summary.as_dict() if summary is not None else None
    em = st["em"] = None
    cut = run_cut(ctx, st)
    if runtime is not None:
        dist.barrier()
        dist.destroy_process_group()
    # the window's models are freed before the reference runs
    gc.collect()
    if rank == 0:
        t0 = time.perf_counter()
        ys = shards(ctx, st, world)
        out["values"] = compare(st["port"], follow(ctx, ys,
                                                   st["init"](0), dev))
        if cut is not None:
            out["values"].update(compare(cut, follow(
                ctx, ys, st["init"]("cut"), dev, segment="cut"), ".cut"))
        out["reference_s"] = time.perf_counter() - t0
    return out


def follow(ctx: Ctx, shards: List, init: Dict, dev,
           prec: str = "float64", rows_used=None,
           segment: str = "run 0") -> List[Dict]:
    """The reference's iterations over ``shards``: run 0's first
    ``checked_iterations``, or (``segment="cut"``) the whole
    ``checked_cut`` segment."""
    import torch
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
    return reference.em_steps(cfg, shards, init, schedule, steps, n, noise,
                              reference.Prec(prec), rows_used)


def compare(port: Dict, ref: List[Dict], suffix: str = ""
            ) -> Dict[str, float]:
    """``F_rel``: the largest relative gap of the free energy per datapoint
    (annealed and un-annealed) over the iterations compared;
    ``param_rel``: the largest relative gap |x - x_ref| / |x_ref| of W, pi
    and sigma after the last.  ``suffix`` ends both names."""
    F = max(max(abs(p - r["F_mean"]) / abs(r["F_mean"]),
                abs(q - r["Q_mean"]) / abs(r["Q_mean"]))
            for p, q, r in zip(port["F_mean"], port["Q_mean"], ref))
    last = ref[-1]
    return {"F_rel" + suffix: F,
            "param_rel" + suffix: max(rel(port[p], last[p])
                                      for p in ("W", "pi", "sigma"))}


def finish(ctx: Ctx, ranks: List[Dict]):
    """The run's result from every rank's: rates from rank 0's window, the
    device's busy time averaged over the ranks, the fullest card's peak."""
    r0 = ranks[0]
    rows = r0["counters"]["rows"] * len(ranks)
    e2e = {"setup_s": r0["setup_s"],
           "train_rows_per_s": rows * r0["counters"]["iterations"]
           / r0["window_s"]}
    return r0, e2e, _busy(ranks)


def _busy(ranks: List[Dict]):
    traces = [r["trace"] for r in ranks if r.get("trace")]
    if not traces:
        return None
    return sum(t["busy_s"] for t in traces) / len(traces)

