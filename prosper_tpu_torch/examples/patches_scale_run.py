"""Patches-scale dictionary recovery through the port: the recovery protocol.

The port's counterpart of ``examples/patches_scale_run.py``: BSC at the
repo's headline width (16x16 patches, D = 256, H = 300, H' = 8, gamma = 4,
154 multi states) on N = 10^6 rows drawn from a planted sparse dictionary
(300 atoms of 8 pixels), trained with the recovery protocol:

1. 120 iterations (T 2 -> 1 and W noise 0.5 -> 0 over the first half, the
   data cut from 0.75 on) with revival every 10 iterations (duplicates above
   cosine 0.85, dead columns below 0.1 x the median norm), worst-F
   re-seeding (the worst 2 % of F_prev) and co-activation blend splits;
2. 40 iterations of a gamma = 5 warm-start refinement (T = 1);
3. up to two offline blend-split sweeps (``data/diagnosis.py::
   split_blend_sweep`` on 65536 rows), each followed by a 15-iteration
   polish.

Every stage trains through ``EM.run_scanned`` (``--run`` for ``EM.run``).
Per seed it prints the atoms recovered (cosine > 0.8 under the optimal
assignment) after each stage and of 300 at the end, the revival counts, ms
per iteration of the first stage, wall seconds, the missed atoms' classes
(``diagnose_recovery``) and the card's ``nvidia-smi`` name and power limit;
last, one JSON line with the table.

    python -m prosper_tpu_torch.examples.patches_scale_run --seeds 0-9
    python -m prosper_tpu_torch.examples.patches_scale_run --seeds 0 \\
        --N 20000 --iters 20 --device cpu        # a small rehearsal
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np


def card_name(device) -> str:
    """The card's ``nvidia-smi`` name and power limit, or the device."""
    import torch
    if torch.device(device).type != "cuda":
        return f"{torch.device(device).type} (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def run_protocol(seed: int = 0, N: int = 1_000_000, D: int = 256,
                 H: int = 300, Hp: int = 8, gamma: int = 4, iters: int = 120,
                 device="cuda", backend: str = "cuda", scanned: bool = True,
                 revive=(10, 0.85, 0.75, 0.1), reseed_worst_frac=0.02,
                 refine_gamma: int = 5, refine_iters: int = 40,
                 split_norm_frac: float = 1.5, split_coact: bool = True,
                 final_split_sweeps: int = 2, polish_iters: int = 15,
                 chunk: int = 8192, keep_data: bool = False,
                 log=print) -> Dict:
    """One seed of the protocol.  Returns {"seed", "recovered" (final),
    "stages" [(stage, recovered)], "revival_stats" (summed over the
    stages), "ms_per_iter" (first stage, the median from iteration 2 on),
    "wall_s"
    (training, data generation excluded), "gen_s", "scan_stats" (of each
    stage), "missed_classes", "em" (the last stage's EM)}, and with
    ``keep_data`` the host rows, "y" (N, D) float32."""
    import torch

    from prosper_tpu_torch.data.bars import cosine_match, planted_dictionary
    from prosper_tpu_torch.data.diagnosis import (diagnose_recovery,
                                                  split_blend_sweep)
    from prosper_tpu_torch.engine.anneal import LinearAnnealing
    from prosper_tpu_torch.engine.em import EM
    from prosper_tpu_torch.models import BSC

    def recovered(params) -> int:
        _, cos = cosine_match(params["W"].cpu().numpy(), gt["W"])
        return int((cos > 0.8).sum())

    t0 = time.perf_counter()
    model = BSC(D, H, Hp, gamma, chunk=chunk, backend=backend)
    gt = {"W": planted_dictionary(D, H, seed=seed),
          "pi": np.float32(2.0 / H), "sigma": np.float32(1.0)}
    data = model.generate_data(gt, N, seed=seed + 1)
    init = model.standard_init(data, seed=seed + 3, device=device)
    y = {"y": torch.as_tensor(data["y"], device=device)}
    stride = max(1, N // 65536)
    Ysample = np.asarray(data["y"][::stride][:65536], np.float64)
    y_host = data["y"] if keep_data else None
    del data
    gen_s = time.perf_counter() - t0
    log(f"[patches] seed {seed}: generated {N} rows in {gen_s:.1f} s")

    def train(em):
        params = em.run_scanned() if scanned else em.run()
        stats["scan_stats"].append(dict(em.scan_stats))
        for k, v in em.revival_stats.items():
            stats["revival_stats"][k] += v
        return params

    def protocol_em(model_, anneal, params, em_seed):
        return EM(model_, anneal, y, params=params, seed=em_seed,
                  device=device, revive_duplicates=revive,
                  reseed_worst_frac=reseed_worst_frac,
                  split_norm_frac=split_norm_frac, split_coact=split_coact)

    stats = {"scan_stats": [], "revival_stats": {
        "revived": 0, "coact_split": 0, "coact_rejected": 0, "sym_split": 0,
        "reseeded": 0}}
    stages: List = []
    t0 = time.perf_counter()
    anneal = LinearAnnealing(iters)
    anneal["T"] = [(0.0, 2.0), (0.5, 1.0)]
    anneal["W_noise"] = [(0.0, 0.5), (0.5, 0.0)]
    anneal["Ncut_factor"] = [(0.75, 0.0), (0.95, 1.0)]
    em = protocol_em(model, anneal, init, seed + 2)
    params = train(em)
    # the median: the first window's iterations share its kernel build (in
    # a fresh process) and first captures
    ms_per_iter = float(np.median([h["dt"] for h in em.history[2:]])) * 1e3
    stages.append(("anneal", recovered(params)))
    log(f"[patches] seed {seed}: {iters} iterations, {ms_per_iter:.3f} ms "
        f"an iteration, recovered {stages[-1][1]}/{H}; sigma "
        f"{float(params['sigma']):.4f} pi {float(params['pi']):.5f}; "
        f"revival {em.revival_stats}; scan {em.scan_stats['graphs']} graphs "
        f"{em.scan_stats['replays']} replays")

    if refine_gamma > gamma:
        # a deeper enumeration separates columns that converged to a blend
        # of two atoms; parameters carry over between state spaces
        del em
        anneal2 = LinearAnnealing(refine_iters)
        anneal2["T"] = 1.0
        em = protocol_em(BSC(D, H, Hp, refine_gamma, chunk=chunk,
                             backend=backend), anneal2, params, seed + 4)
        params = train(em)
        stages.append((f"gamma={refine_gamma}", recovered(params)))
        log(f"[patches] seed {seed}: gamma={refine_gamma} refinement "
            f"({refine_iters} iterations): recovered {stages[-1][1]}/{H}; "
            f"revival {em.revival_stats}")

    # the residual misses are blend columns the online splitter never
    # reaches (it fires only when revival frees a column): split them
    # offline into (blend column, donor column), polish, repeat
    pmodel = BSC(D, H, Hp, max(refine_gamma, gamma), chunk=chunk,
                 backend=backend)
    for it in range(final_split_sweeps):
        out = split_blend_sweep(params["W"].cpu().numpy(), Ysample)
        if not out["splits"]:
            log(f"[patches] seed {seed}: split sweep {it}: no blends left")
            break
        params = dict(params, W=torch.as_tensor(out["W"], device=device))
        anneal3 = LinearAnnealing(polish_iters)
        anneal3["T"] = 1.0
        del em
        em = protocol_em(pmodel, anneal3, params, seed + 5 + it)
        params = train(em)
        stages.append((f"sweep {it}", recovered(params)))
        log(f"[patches] seed {seed}: split sweep {it}: {len(out['splits'])} "
            f"splits + {polish_iters}-iteration polish -> recovered "
            f"{stages[-1][1]}/{H}")
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    rep = diagnose_recovery(params["W"].cpu().numpy(), gt["W"])
    classes: Dict[str, int] = {}
    for c in rep["missed_classes"].values():
        classes[c] = classes.get(c, 0) + 1
    return {"seed": seed, "recovered": stages[-1][1], "of": H,
            "stages": stages, "revival_stats": stats["revival_stats"],
            "ms_per_iter": ms_per_iter, "wall_s": wall_s, "gen_s": gen_s,
            "scan_stats": stats["scan_stats"], "missed_classes": classes,
            "duplicates": len(rep["duplicates"]), "dead": len(rep["dead"]),
            "em": em, **({"y": y_host} if keep_data else {})}


def seed_list(spec: str) -> List[int]:
    """'0-9' -> [0, ..., 9]; '0,3,5' -> [0, 3, 5]."""
    out: List[int] = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m prosper_tpu_torch.examples.patches_scale_run")
    p.add_argument("--seeds", default="0", help="e.g. 0-9 or 0,2,5")
    p.add_argument("--N", type=int, default=1_000_000)
    p.add_argument("--iters", type=int, default=120)
    p.add_argument("--device", default="cuda")
    p.add_argument("--run", action="store_true",
                   help="train through EM.run instead of EM.run_scanned")
    args = p.parse_args(argv)
    card = card_name(args.device)
    results = []
    for seed in seed_list(args.seeds):
        r = run_protocol(seed, N=args.N, iters=args.iters,
                         device=args.device, scanned=not args.run)
        r.pop("em")
        results.append(r)
        print(f"[patches] seed {seed}: recovered {r['recovered']}/{r['of']} "
              f"(stages {r['stages']}); revival {r['revival_stats']}; "
              f"{r['ms_per_iter']:.3f} ms an iteration, {r['wall_s']:.1f} s "
              f"wall (+{r['gen_s']:.1f} s data); missed "
              f"{r['missed_classes'] or 'none'}  [{card}]", flush=True)
    rec = [r["recovered"] for r in results]
    print(json.dumps({"patches_scale_run": {
        "seeds": [r["seed"] for r in results], "recovered": rec,
        "median": float(np.median(rec)), "min": int(min(rec)),
        "ms_per_iter": [r["ms_per_iter"] for r in results],
        "wall_s": [r["wall_s"] for r in results],
        "missed_classes": [r["missed_classes"] for r in results],
        "revival_stats": [r["revival_stats"] for r in results],
        "N": args.N, "iters": args.iters, "card": card}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
