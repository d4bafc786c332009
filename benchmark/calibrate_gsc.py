"""Readings that the limits of ``correct`` of a GSC training cell (kind
``train_gsc``) are set from (not run by the benchmark's own runs).

    python3 benchmark/calibrate_gsc.py --workload gsc_patches_train \\
        --seeds 101-106 [--controls 3] [--out FILE]

As ``calibrate.py`` does for the other training cells: per seed one JSON
line with the numbers compared for the program against the plain reference
(``reference_gsc.py``), and on the first ``--controls`` seeds the same
numbers for the control (the reference with TF32 products), for the
reference in IEEE float32 (``float32``, a witness of rounding) and for the
faults, planted in the reference put in the program's place:
``unchanged`` (the initial parameters after the iterations compared),
``half_batch`` (the E-step over half of the rows), ``no_slab_cov``
(Sigma_s left out of <sz sz^T>: kappa kappa^T alone) and, in the
``checked_cut`` segment, ``keep_every_row`` (a data cut that keeps every
row).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import reference_gsc, spec  # noqa: E402
from benchmark.calibrate import seeds_of  # noqa: E402
from benchmark.harness import Ctx, process_started  # noqa: E402


def as_side(steps):
    """A reference trajectory in the program's place."""
    return {"F_mean": [s["F_mean"] for s in steps],
            "Q_mean": [s["Q_mean"] for s in steps],
            **{p: steps[-1][p] for p in reference_gsc.PARAMS}}


def train_row(ctx: Ctx, control: bool):
    from benchmark.drivers import train_gsc as drv
    st = drv.setup(ctx)
    st["em"] = None
    ports = {"run 0": st["port"], "cut": drv.run_cut(ctx, st)}
    gc.collect()
    row = {}
    for seg, run, suffix in (("run 0", 0, ""), ("cut", "cut", ".cut")):
        init0 = st["init"](run)

        def follow(**k):
            return drv.follow(ctx, st["y"], init0, st["dev"], segment=seg,
                              **k)

        def add(name, values):
            row.setdefault(name, {}).update(values)
        ref = follow()
        add("program", drv.compare(ports[seg], ref, suffix))
        if not control:
            continue
        add("control", drv.compare(as_side(follow(prec="tf32")), ref,
                                   suffix))
        add("float32", drv.compare(as_side(follow(prec="float32")), ref,
                                   suffix))
        add("half_batch", drv.compare(as_side(follow(
            rows_used=lambda y: y[:y.shape[0] // 2])), ref, suffix))
        # a step that keeps its state: its parameters alone are compared
        add("unchanged", {"param_rel" + suffix: drv.compare(
            dict(as_side(ref), **init0), ref, suffix)["param_rel" + suffix]})
        add("no_slab_cov", drv.compare(as_side(follow(slab_cov=False)), ref,
                                       suffix))
        if seg == "cut":
            add("keep_every_row", drv.compare(as_side(follow(cut=False)),
                                              ref, suffix))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 101-106")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    s = spec.load()
    cell = spec.cell(s, args.workload)
    base = Ctx(cell=cell, cfg=spec.config(s, cell), traffic=spec.traffic(cell),
               seed=0, seconds=0.0, trace=False, device=args.device,
               started=process_started())
    if base.traffic["kind"] != "train_gsc":
        raise SystemExit(f"{args.workload} is no train_gsc cell: "
                         "benchmark/calibrate.py reads it")
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(seeds_of(args.seeds)):
        row = dict(seed=seed, **train_row(dataclasses.replace(base, seed=seed),
                                          i < args.controls))
        # the seed's models and their graphs' pools, before the next seed
        gc.collect()
        import torch
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        line = json.dumps({"workload": args.workload, **row})
        print(line, flush=True)
        if sink:
            print(line, file=sink, flush=True)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
