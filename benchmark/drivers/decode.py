"""Decode traffic: requests of image patches decoded through the program's
``model.inference`` with the planted parameters, offered as an open loop.

A request is every overlapping ``patch`` x ``patch`` patch (``stride``) of
one image, its size one of ``images``; the rows are a slice, at an offset
drawn from the seed, of a pool of ``pool_rows`` rows made on the device in
set-up from the planted model.  Requests are due at a fixed interval,
one every 1 / ``rate_per_s`` seconds; every seed gets the same sizes in
another order.  One client serves them in order
of arrival: a request's latency runs from its due time to its outputs
synchronised on the device, so a stall counts for every request that waits
behind it.  No request starts after ``--seconds``; the window ends when the
last one started has completed.  Set-up decodes one request of each size.

``correct``: after the window, ``checked_requests`` requests drawn from the
seed among the first that complete (one of them of the largest size) are
decoded again by the plain reference in float64, row by row; the numbers
compared are the largest gaps of F, of the posterior mean, of the top-L
probabilities rank by rank, and of each reported state's probability under
the reference's posterior.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from benchmark import data, reference
from benchmark.harness import PHASES, Ctx, build_model, open_device, p95, phase
from benchmark.trace import Window


def plan(traffic: Dict, seed: int, seconds: float) -> List[Dict]:
    """The requests of a run: rows, pool offset and due time (s)."""
    sizes = [(h - traffic["patch"]) // traffic["stride"] + 1
             for h, _ in traffic["images"]]
    sizes = [n * ((w - traffic["patch"]) // traffic["stride"] + 1)
             for n, (_, w) in zip(sizes, traffic["images"])]
    rate = float(traffic["rate_per_s"])
    n = int(math.ceil(rate * seconds * 1.25)) + 2 * len(sizes)
    n += -n % len(sizes)
    g = torch.Generator().manual_seed(data.derive(seed, "requests"))
    order = torch.randperm(n, generator=g).tolist()
    rows = [sizes[i % len(sizes)] for i in order]
    pool = traffic["pool_rows"]
    offs = torch.randint(0, pool - max(sizes) + 1, (n,), generator=g).tolist()
    return [{"rows": r, "offset": o, "due": i / rate}
            for i, (r, o) in enumerate(zip(rows, offs))]


def checked(traffic: Dict, reqs: List[Dict], seed: int,
            seconds: float) -> List[int]:
    """Indices of the requests the check compares: drawn from the seed
    among the first ``check_among`` (and those due in the window's first
    half), one of them of the largest size."""
    among = max(1, min(traffic["check_among"],
                       sum(r["due"] < 0.5 * seconds for r in reqs)))
    g = torch.Generator().manual_seed(data.derive(seed, "checked"))
    order = torch.randperm(among, generator=g).tolist()
    big = max(r["rows"] for r in reqs[:among])
    first_big = next(i for i in order if reqs[i]["rows"] == big)
    rest = [i for i in order if i != first_big]
    return sorted([first_big] + rest[:traffic["checked_requests"] - 1])


def setup(ctx: Ctx) -> Dict:
    """The planted parameters, the pool of rows, the requests, the ones
    checked and the decode call; every request size decoded once."""
    dev = torch.device(ctx.device)
    cfg, tr = ctx.cfg, ctx.traffic
    model = build_model(cfg)
    phase("import program", ctx.started)
    open_device(ctx, dev)
    p = cfg["planted"]
    W = data.planted_dictionary(cfg["D"], cfg["H"], p["active_pixels"],
                                p["intensity"],
                                data.generator(dev, ctx.seed, "dict"), dev)
    pi, sigma = p["pi_times_H"] / cfg["H"], p["sigma"]
    params = {"W": W, "pi": torch.tensor(pi, device=dev),
              "sigma": torch.tensor(float(sigma), device=dev)}
    pool = data.rows(W, tr["pool_rows"], pi, sigma, cfg["superposition"],
                     data.generator(dev, ctx.seed, "pool"))
    reqs = plan(tr, ctx.seed, ctx.seconds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phase("rows", ctx.started)

    def decode(req):
        y = pool[req["offset"]:req["offset"] + req["rows"]]
        return model.inference(params, {"y": y}, top_L=tr["top_L"],
                               dense_states=tr["dense_states"])

    for n in sorted({r["rows"] for r in reqs}):
        decode({"rows": n, "offset": 0})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phase("warm-up", ctx.started)
    return {"dev": dev, "params": params, "pool": pool, "reqs": reqs,
            "keep": set(checked(tr, reqs, ctx.seed, ctx.seconds)),
            "decode": decode}


def run_rank(ctx: Ctx, rank: int = 0, world: int = 1, runtime=None) -> Dict:
    st = setup(ctx)
    dev, reqs, keep, decode = st["dev"], st["reqs"], st["keep"], st["decode"]
    kept, latency, service, done_rows = {}, [], [], []
    failed = 0
    with Window(ctx.trace, dev) as w:
        setup_s = time.time() - ctx.started
        for i, req in enumerate(reqs):
            now = w.elapsed()
            if max(now, req["due"]) >= ctx.seconds:
                break
            if req["due"] > now:
                time.sleep(req["due"] - now)
            start = w.elapsed()
            try:
                out = decode(req)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            except RuntimeError:
                failed += 1
                continue
            end = w.elapsed()
            latency.append(end - req["due"])
            service.append(end - start)
            done_rows.append(req["rows"])
            if i in keep:
                kept[i] = out
    out = {"setup_s": setup_s, "phases": dict(PHASES), "window_s": w.seconds,
           "attempted": len(latency) + failed, "failed": failed,
           "counters": {"requests": len(latency), "request_rows": done_rows,
                        "service_s": service},
           "latency_s": latency,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0)}
    summary = w.summary()
    out["trace"] = summary.as_dict() if summary is not None else None
    missing = keep - set(kept)
    if missing:
        raise RuntimeError(f"the checked requests {sorted(missing)} did not "
                           "complete in the window")
    t0 = time.perf_counter()
    out["values"] = compare(ctx, st, kept)
    out["reference_s"] = time.perf_counter() - t0
    return out


def dense_states(out: Dict, H: int) -> torch.Tensor:
    """(N, L, H) binary states of the program's compact decode."""
    unit = out["top_single_unit"].long()
    N, L = unit.shape
    Hp = out["cand"].shape[1]
    dense = torch.zeros((N, L, H), dtype=torch.float64, device=unit.device)
    dense.scatter_(2, torch.clamp(unit, min=0)[..., None],
                   (unit >= 0)[..., None].double()
                   * out["top_single_value"].double()[..., None])
    dense.scatter_add_(2, out["cand"].long()[:, None, :].expand(N, L, Hp),
                       out["top_cand_states"].double())
    return dense


def gaps(ref: reference.LinearDecoder, y, side, block: int = 8192
         ) -> Dict[str, float]:
    """The largest gaps of one side's decode of ``y`` to the float64
    reference's; ``side(i, j)`` gives that side's F, s_mean, top_probs and
    top_states (j - i, L, H) of rows i..j."""
    out = {"F_gap": 0.0, "mean_gap": 0.0, "rank_gap": 0.0, "prob_gap": 0.0}

    def gap(a, b):
        return float((a.double() - b).abs().max())
    for i in range(0, y.shape[0], block):
        r = ref(y[i:i + block])
        o = side(i, i + r["F"].shape[0])
        out["F_gap"] = max(out["F_gap"], gap(o["F"], r["F"]))
        out["mean_gap"] = max(out["mean_gap"], gap(o["s_mean"], r["s_mean"]))
        out["rank_gap"] = max(out["rank_gap"],
                              gap(o["top_probs"], r["top_probs"]))
        out["prob_gap"] = max(out["prob_gap"], gap(
            o["top_probs"], ref.prob_of(r, o["top_states"])))
    return out


def program_side(out: Dict, H: int):
    """``gaps``'s view of the program's outputs of one request."""
    def side(i, j):
        part = {k: v[i:j] for k, v in out.items()}
        part["top_states"] = (part["top_states"] if "top_states" in part
                              else dense_states(part, H))
        return part
    return side


def reference_for(ctx: Ctx, st: Dict, prec: str) -> reference.LinearDecoder:
    p = st["params"]
    return reference.LinearDecoder(p["W"], p["pi"], p["sigma"],
                                   ctx.cfg["Hprime"], ctx.cfg["gamma"],
                                   ctx.traffic["top_L"],
                                   reference.Prec(prec))


def rows_of(st: Dict, i: int):
    req = st["reqs"][i]
    return st["pool"][req["offset"]:req["offset"] + req["rows"]]


def compare(ctx: Ctx, st: Dict, kept: Dict) -> Dict[str, float]:
    ref = reference_for(ctx, st, "float64")
    worst: Dict[str, float] = {}
    for i, out in kept.items():
        g = gaps(ref, rows_of(st, i), program_side(out, ctx.cfg["H"]))
        for k, v in g.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def finish(ctx: Ctx, ranks: List[Dict]):
    r0 = ranks[0]
    rows = sum(r0["counters"]["request_rows"])
    e2e = {"setup_s": r0["setup_s"],
           "decode_rows_per_s": rows / r0["window_s"],
           "decode_p95_ms": 1e3 * p95(r0["latency_s"])}
    busy = r0["trace"]["busy_s"] if r0.get("trace") else None
    return r0, e2e, busy
