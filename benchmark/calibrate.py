"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 101-112 \\
        [--controls 3] [--out FILE]

For each seed it sets the cell up as a run does, without the window, and
prints one JSON line: the numbers compared for the program against the
plain reference (the lower readings), and on the first ``--controls`` seeds
the same numbers for the control (the reference computed with TF32
products, the step below the configuration's float32) and for the faults a
cell can have, planted in the reference put in the program's place, and
for training the reference in IEEE float32 (``float32``, a witness of how
far rounding alone moves the iterations compared):

* training, for run 0's checked iterations and for the ``checked_cut``
  segment: ``unchanged`` (a step that returns its state: the initial
  parameters after the iterations compared), ``half_batch`` (the E-step over
  half of the rows, the means taken over the rest) and, on several chips,
  ``no_exchange`` (rank 0's rows alone, the sums never reduced);
* decoding: ``altered`` (one posterior mean of one row moved by 1).

A multi-chip cell's program readings come from its runs; here its control
and faults are read on one chip, with every rank's rows remade from the
seed.
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

from benchmark import spec  # noqa: E402
from benchmark.harness import Ctx, process_started  # noqa: E402


def seeds_of(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def as_side(steps):
    """A reference trajectory in the program's place."""
    last = steps[-1]
    return {"F_mean": [s["F_mean"] for s in steps],
            "Q_mean": [s["Q_mean"] for s in steps],
            "W": last["W"], "pi": last["pi"], "sigma": last["sigma"]}


def train_row(ctx: Ctx, control: bool):
    import torch

    from benchmark.drivers import train
    from benchmark import data
    world = ctx.chips
    if world == 1:
        st = train.setup(ctx)
        st["em"] = None
        ports = {"run 0": st["port"], "cut": train.run_cut(ctx, st)}
        dev, init = st["dev"], st["init"]
    else:
        dev = torch.device(ctx.device)
        y = data.training_data(ctx.cfg, ctx.seed, ctx.traffic["rows"], 0,
                               dev)[1]
        mean, std = data.moments(y)

        def init(run):
            return data.init_params(mean, std, ctx.cfg["H"],
                                    data.generator(dev, ctx.seed, "init",
                                                   run))
        st = {"dev": dev, "y": y}
    shards = train.shards(ctx, st, world)
    row = {}
    segments = [("run 0", 0, "")]
    if "checked_cut" in ctx.traffic:
        segments.append(("cut", "cut", ".cut"))
    for seg, run, suffix in segments:
        init0 = init(run)

        def follow(**k):
            return train.follow(ctx, k.pop("shards", shards), init0, dev,
                                segment=seg, **k)

        def add(name, values):
            row.setdefault(name, {}).update(values)
        ref = follow()
        if world == 1:
            add("program", train.compare(ports[seg], ref, suffix))
        if not control:
            continue
        add("control", train.compare(as_side(follow(prec="tf32")), ref,
                                     suffix))
        add("float32", train.compare(as_side(follow(prec="float32")), ref,
                                     suffix))
        add("half_batch", train.compare(as_side(follow(
            rows_used=lambda y: y[:y.shape[0] // 2])), ref, suffix))
        # the free energies of a step that keeps its state are not
        # modelled: its parameters alone are compared
        add("unchanged", {"param_rel" + suffix: train.compare(
            dict(as_side(ref), **init0), ref, suffix)["param_rel" + suffix]})
        if world > 1:
            add("no_exchange", train.compare(
                as_side(follow(shards=shards[:1])), ref, suffix))
    return row


def decode_row(ctx: Ctx, control: bool):
    from benchmark.drivers import decode
    st = decode.setup(ctx)
    ref = decode.reference_for(ctx, st, "float64")
    H = ctx.cfg["H"]
    row = {}

    def worst(side_of):
        out = {}
        for i in sorted(st["keep"]):
            for k, v in decode.gaps(ref, decode.rows_of(st, i),
                                    side_of(i)).items():
                out[k] = max(out.get(k, 0.0), v)
        return out
    outs = {i: st["decode"](st["reqs"][i]) for i in st["keep"]}
    row["program"] = worst(lambda i: decode.program_side(outs[i], H))
    if control:
        ctl = decode.reference_for(ctx, st, "tf32")

        def control_side(i):
            y = decode.rows_of(st, i)
            return lambda a, b: ctl(y[a:b])
        row["control"] = worst(control_side)

        def altered(i):
            out = dict(outs[i], s_mean=outs[i]["s_mean"].clone())
            out["s_mean"][0, 0] += 1.0
            return decode.program_side(out, H)
        row["altered"] = worst(altered)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 101-112")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=20.0,
                    help="the window the request plan is drawn for")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    s = spec.load()
    cell = spec.cell(s, args.workload)
    base = Ctx(cell=cell, cfg=spec.config(s, cell), traffic=spec.traffic(cell),
               seed=0, seconds=args.seconds, trace=False, device=args.device,
               started=process_started())
    row_of = train_row if base.traffic["kind"] == "train" else decode_row
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(seeds_of(args.seeds)):
        row = dict(seed=seed, **row_of(dataclasses.replace(base, seed=seed),
                                       i < args.controls))
        # the seed's models and their graphs' pools, before the next seed
        gc.collect()
        import torch
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
