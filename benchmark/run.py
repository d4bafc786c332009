"""Run one cell of ``BENCHMARK.json`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Sets the cell up, measures ``--seconds`` seconds, checks the outputs
against the plain reference and prints one JSON line last: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit
(also the last lines of standard error).  Exits non-zero and prints no
result where the cell asks for more CUDA devices than there are, where the
outputs cannot be checked, or where JAX or the JAX package is loaded.

A cell on several chips starts one process a card (``--rank``), each on
``cuda:<rank>`` in one NCCL group on a localhost port; this process only
gathers their results.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, spec  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a multi-chip cell, started by the parent run
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--started", type=float, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def context(args, device="cuda", root=spec.ROOT) -> harness.Ctx:
    s = spec.load(root)
    cell = spec.cell(s, args.workload)
    return harness.Ctx(cell=cell, cfg=spec.config(s, cell, root),
                       traffic=spec.traffic(cell, root), seed=args.seed,
                       seconds=args.seconds, trace=bool(args.trace),
                       device=device,
                       started=(args.started if args.started is not None
                                else harness.process_started()),
                       limits=spec.limits(cell, root))


def worker(args) -> None:
    """One rank of a multi-chip cell: its result goes to ``--out``."""
    from prosper_tpu_torch import MeshRuntime
    from prosper_tpu_torch.ops.cuda_lib import load_library
    from prosper_tpu_torch.parallel.mesh import init_multihost
    import torch.distributed as dist
    ctx = context(args, device=args.device)
    init_multihost(f"localhost:{args.port}", ctx.chips, args.rank,
                   device=ctx.device)
    if ctx.device.startswith("cuda"):
        # rank 0 builds the kernels where the checkout has none yet
        if args.rank == 0:
            load_library()
        dist.barrier()
        load_library()
    rt = MeshRuntime(device=ctx.device)
    res = spec.driver(ctx.traffic["kind"]).run_rank(ctx, args.rank,
                                                    ctx.chips, rt)
    res["forbidden"] = harness.forbidden_modules()
    res["kind"] = device_name(ctx)
    with open(args.out, "w") as f:
        json.dump(res, f)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


#: the script each rank runs
WORKER = Path(__file__).resolve()


def spawn(ctx: harness.Ctx, args):
    """Start one process a chip and return their results, rank 0 first."""
    env = dict(os.environ)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("OMP_NUM_THREADS", "2")
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs, outs = [], []
        for r in range(ctx.chips):
            outs.append(os.path.join(tmp, f"rank{r}.json"))
            cmd = [sys.executable, str(WORKER), "--device", ctx.device,
                   "--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", str(args.trace),
                   "--rank", str(r), "--port", str(port), "--out", outs[-1],
                   "--started", repr(ctx.started)]
            procs.append(subprocess.Popen(cmd, env=dict(env,
                                                        LOCAL_RANK=str(r))))
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=ctx.seconds + 900))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                for q in procs:
                    q.wait()
                raise
        if any(codes):
            raise RuntimeError(f"ranks exited with {codes}")
        results = []
        for o in outs:
            with open(o) as f:
                results.append(json.load(f))
    return results


def device_name(ctx) -> str:
    """The name of the card this process runs on (a multi-chip cell's
    parent, which uses no card, takes its ranks')."""
    import torch
    if not ctx.device.startswith("cuda"):
        return "cpu"
    return torch.cuda.get_device_name(torch.cuda.current_device())


def device_info(ctx, ranks, busy):
    cuda = ctx.device.startswith("cuda")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": ranks[0]["kind"],
           "count": ctx.chips,
           "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks)}
    if ctx.trace:
        dev["busy_s"] = busy
        dev["window_s"] = ranks[0]["window_s"]
    return dev


def per_layer(ctx, s, r0, root=spec.ROOT):
    from benchmark.trace import Summary
    reading = Reading(ctx, Summary.from_dict(r0["trace"]), r0["counters"])
    out = {}
    for m in spec.per_layer(s, ctx.cell):
        v = spec.reader(m["name"], root).read(reading)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


class Reading:
    """What a per-layer reader reads: the configuration, the mix, the
    number of chips, rank 0's trace and the driver's counters."""

    def __init__(self, ctx, trace, counters):
        self.cfg, self.traffic, self.chips = ctx.cfg, ctx.traffic, ctx.chips
        self.trace, self.counters = trace, counters


def run_cell(ctx: harness.Ctx, args=None, root=spec.ROOT):
    """Drive one run of the cell (on ``ctx.device``; a multi-chip cell
    through its ranks) and return (result, checks), or raise."""
    s = spec.load(root)
    driver = spec.driver(ctx.traffic["kind"], root)
    if ctx.chips == 1:
        ranks = [dict(driver.run_rank(ctx), kind=device_name(ctx))]
    else:
        ranks = spawn(ctx, args)
    r0, e2e, busy = driver.finish(ctx, ranks)
    found = sorted(set(harness.forbidden_modules()).union(
        *(r.get("forbidden", []) for r in ranks)))
    if found:
        raise RuntimeError(f"a process of the run loaded {found}")
    chk = harness.checks(r0["values"], ctx.limits)
    if ctx.trace:
        metrics = per_layer(ctx, s, r0, root)
    else:
        units = {m["name"]: m["unit"] for m in spec.end_to_end(s, ctx.cell)}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items()
                   if k in units}
    result = {"correct": harness.passed(chk),
              "attempted": ranks[0]["attempted"],
              "failed": ranks[0]["failed"],
              "metrics": metrics,
              "device": device_info(ctx, ranks, busy),
              "card": harness.card(),
              "setup_phases": r0["phases"],
              "reference_s": r0["reference_s"]}
    if ctx.trace:
        t = r0["trace"]
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    return result, chk


#: the bytecode of every module a run imports, the libraries' too, where
#: the checkout keeps it: only a checkout's first run compiles it.  Where
#: no bytecode is written (PYTHONDONTWRITEBYTECODE), every run compiled
#: torch's sources again: 7-9.5 s of a run's 12-17 s of set-up, and most
#: of its spread.
PYCACHE = ROOT / "benchmark" / ".pycache"


def main(argv=None) -> int:
    args = parse(argv)
    if args.rank is not None:
        worker(args)
        return 0
    ctx = context(args)
    harness.phase("interpreter", ctx.started)
    import torch
    harness.phase("import torch", ctx.started)
    if not torch.cuda.is_available() or torch.cuda.device_count() < ctx.chips:
        print(f"{ctx.cell['name']} needs {ctx.chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    harness.phase("device count", ctx.started)
    result, chk = run_cell(ctx, args)
    print(f"[time] the reference took {result.pop('reference_s'):.3f} s",
          file=sys.stderr)
    harness.emit(result, chk)
    return 0


if __name__ == "__main__":
    sys.pycache_prefix = str(PYCACHE)
    sys.dont_write_bytecode = False
    sys.exit(main())
