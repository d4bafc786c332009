"""What every driver shares: the run's context, the clock of set-up, the
program's model, the checks that decide ``correct`` and the line printed.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List

#: top-level module names that no process of a run may hold: JAX and the
#: JAX package beside the port (compared whole: the port's own name,
#: prosper_tpu_torch, begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "prosper_tpu")


@dataclass
class Ctx:
    """One run of one cell."""
    cell: Dict
    cfg: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    #: the epoch second at which the process (the parent of a multi-rank
    #: run) started; set-up runs from it to the first timed unit of work
    started: float = 0.0
    #: names -> limits of the numbers that decide ``correct``
    limits: Dict[str, float] = field(default_factory=dict)

    @property
    def chips(self) -> int:
        return int(self.cell["chips"])


def process_started() -> float:
    """The epoch second at which this process started (Linux: from
    /proc, to the clock tick; elsewhere: now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


#: the seconds from the start of the process to the end of each phase of
#: set-up (``phase``), in order
PHASES: Dict[str, float] = {}


def phase(name: str, started: float) -> None:
    """Mark the end of a phase of set-up, on standard error too."""
    PHASES[name] = time.time() - started
    print(f"[setup] {name} {PHASES[name]:.3f} s", file=sys.stderr,
          flush=True)


def open_device(ctx: "Ctx", dev) -> None:
    """Create the device's context and load the program's kernels, each
    timed as a phase of set-up."""
    import torch
    if dev.type != "cuda":
        return
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    phase("context", ctx.started)
    from prosper_tpu_torch.ops.cuda_lib import load_library
    load_library()
    phase("kernel library", ctx.started)


def build_model(cfg: Dict):
    """The program's model of a configuration file."""
    from prosper_tpu_torch import models
    cls = getattr(models, cfg["model"])
    return cls(cfg["D"], cfg["H"], cfg["Hprime"], cfg["gamma"],
               chunk=cfg["chunk"])


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0] if out else "not read"


def checks(values: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """Each number compared beside its limit; a number over its limit, or
    one that is not a number, fails."""
    out = {}
    for name, v in values.items():
        if name not in limits:
            raise KeyError(f"no limit for {name!r} in the cell's limits file")
        out[name] = {"value": v, "limit": limits[name]}
    return out


def passed(chk: Dict) -> bool:
    return all(c["value"] == c["value"] and c["value"] <= c["limit"]
               for c in chk.values())


def p95(values: List[float]) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive method)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[18]


def rel(a, b) -> float:
    """|a - b| / |b| of two tensors or numbers, in float64."""
    import torch
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-300))


def emit(result: Dict, chk: Dict) -> None:
    """The last lines of standard error (each number compared and its
    limit) and the result as the last line of standard output, with the
    checks under the key that comes last."""
    for name, c in chk.items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(dict(result, checks=chk)), flush=True)
