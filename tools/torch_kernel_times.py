#!/usr/bin/env python3
"""Times, profiles and ablations of prosper_tpu_torch's CUDA kernels on one
NVIDIA GPU, at the shapes of chip_smoke.py's paths (N = 131072 rows; BSC
D=256, H=300, H'=8, gamma=4; MCA D=256, H=300, H'=6, gamma=3; big-S TSC
D=64, H=32, H'=10, gamma=5, s_block=1024; decode of 8192 rows).

    python3 tools/torch_kernel_times.py times [--repo DIR]
        CUDA-event times of the E-step, decode, max E-step and big-S E-step
        wrappers of the package found in DIR (default: this checkout); one
        JSON line.
    python3 tools/torch_kernel_times.py compare --parent DIR
        `times` of an unpacked parent commit in DIR and of this checkout, in
        turns (parent, change, change, parent), one process each.
    python3 tools/torch_kernel_times.py profile
        torch.profiler over EM iterations of BSC and MCA: device time by
        kernel, the device's busy time and its idle share of the window.
    python3 tools/torch_kernel_times.py ablate
        Builds edited copies of the sources with one part of the linear
        rows kernel or of the max kernel switched off (the results are then
        wrong; only the time is read) and prints what each part saves; then
        the GEMM kernels with a register cap for 4 and 5 blocks an SM.

Every line of output ends with the card's name and power limit.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N, N_DECODE = 131072, 8192

#: (name, file, text to replace, replacement): parts switched off by `ablate`
ABLATIONS = [
    ("rows: candidate selection (also the max kernel's)",
     "linear_et_frontend.cuh",
     "const int bi = row_argmax(sc, H, lane, &b);",
     "const int bi = a; b = 0.f;"),
    ("rows: multi-state logits", "linear_et_estep.cu", "int sb = 0;",
     "int sb = S;"),
    ("rows: multi-state moments", "linear_et_estep.cu", "int jb = 0;",
     "int jb = J;"),
    ("rows: ss scatter", "linear_et_estep.cu",
     "if (w != 0.f) {\n        const int* cr", "if (w > 3e38f) {\n"
     "        const int* cr"),
    ("max: phase 0 (strip DP, y.ybar, ||ybar||^2)", "max_et_estep.cu",
     "for (int d0 = 0; d0 < D; d0 += 32) {",
     "for (int d0 = 0; d0 < 0; d0 += 32) {"),
    ("max: phase 1 (routing)", "max_et_estep.cu",
     "for (int dd = tid; dd < D; dd += THREADS) {",
     "for (int dd = tid; dd < 0; dd += THREADS) {"),
]
#: variants of the GEMM kernels (right results, other register caps)
VARIANTS = [
    (f"nothing, but the GEMMs capped for {n} blocks an SM", "sgemm.cu",
     "__launch_bounds__(THREADS)\n", f"__launch_bounds__(THREADS, {n})\n")
    for n in (4, 5)]


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def setups(torch, np, which=("bsc", "mca", "tsc")):
    """Models, data on the card and initial parameters of the three paths,
    as chip_smoke.py makes them."""
    from prosper_tpu_torch.data.bars import planted_dictionary
    from prosper_tpu_torch.models import BSC, MCA, TSC
    dev = torch.device("cuda")
    out = {}
    for name, model, pi in (
            ("bsc", lambda: BSC(256, 300, 8, 4, chunk=8192), 2.0 / 300),
            ("mca", lambda: MCA(256, 300, 6, 3), 2.0 / 300),
            ("tsc", lambda: TSC(64, 32, 10, 5, chunk=8192, s_block=1024),
             0.1)):
        if name not in which:
            continue
        m = model()
        gt = {"W": planted_dictionary(m.D, m.H, seed=0), "pi": np.float32(pi),
              "sigma": np.float32(1.0)}
        data = m.generate_data(gt, N, seed=1)
        out[name] = (m, torch.tensor(data["y"], device=dev),
                     m.standard_init(data, seed=3, device=dev))
    return out


def kernel_calls(torch, np):
    """{name: a call of one wrapper at its main-path shape}."""
    from prosper_tpu_torch.ops import linear_cuda, max_cuda
    dev = torch.device("cuda")
    su = setups(torch, np)
    w = torch.ones(N, device=dev)
    calls = {}
    m, y, p = su["bsc"]
    sa, lo, s2 = m.state_arrays(dev), m.log_odds(p), p["sigma"] ** 2
    calls["linear_et_estep"] = lambda: linear_cuda.linear_et_estep_cuda(
        y, w, p["W"], s2, lo, sa, 8, False, 1.0, 1.0)
    if hasattr(linear_cuda, "sgemm_nn_cuda"):      # the GEMMs, where present
        sw = torch.randn(N, 300, device=dev)
        calls["sgemm_nn"] = lambda: linear_cuda.sgemm_nn_cuda(y, p["W"])
        calls["sgemm_tn_splitn"] = (
            lambda: linear_cuda.sgemm_tn_splitn_cuda(y, sw))
    yd = y[:N_DECODE].contiguous()
    calls["linear_et_decode"] = lambda: linear_cuda.linear_et_decode_cuda(
        yd, p["W"], s2, lo, sa, 8, False, 10, 1.0, 1.0)
    mm, ym, pm = su["mca"]
    sam, lom = mm.state_arrays(dev), mm._log_odds(pm)
    calls["max_et_estep"] = lambda: max_cuda.max_et_estep_cuda(
        ym, w, pm["W"], pm["sigma"] ** 2, lom, sam, 6, False, 1.0, 1.0)
    mt, yt, pt = su["tsc"]
    sat, lot = mt.state_arrays(dev), mt.log_odds(pt)
    for tag, true_ch in (("annealed", True), ("saturated", False)):
        calls[f"bigs_estep_{tag}"] = (
            lambda c=true_ch: linear_cuda.linear_et_estep(
                yt, w, pt["W"], pt["sigma"] ** 2, lot, sat, 10, True, 1.0,
                1.0, collect_true=c, s_block=1024))
    return calls


def cmd_times(args):
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    calls = kernel_calls(torch, np)
    out = {k: cuda_ms(torch, fn) for k, fn in calls.items()}
    print(json.dumps({"repo": str(args.repo), "ms": out, "card": smi()}),
          flush=True)


def cmd_compare(args):
    rows = []
    for repo in (args.parent, ROOT, ROOT, args.parent):
        r = subprocess.run([sys.executable, __file__, "times", "--repo",
                            str(repo)], capture_output=True, text=True)
        if r.returncode != 0:
            sys.exit(f"times failed in {repo}:\n{r.stdout}\n{r.stderr}")
        rows.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    for k in rows[0]["ms"]:
        par = (rows[0]["ms"][k] + rows[3]["ms"][k]) / 2
        new = (rows[1]["ms"][k] + rows[2]["ms"][k]) / 2
        print(f"{k}: parent {rows[0]['ms'][k]:.3f} / {rows[3]['ms'][k]:.3f} "
              f"ms, change {rows[1]['ms'][k]:.3f} / {rows[2]['ms'][k]:.3f} ms"
              f", parent / change = {par / new:.3f}  [{rows[0]['card']}]")


def cmd_profile(args):
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from prosper_tpu_torch import EM, LinearAnnealing
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi()
    for name, (model, y, init) in setups(torch, np, ("bsc", "mca")).items():
        for tag, T, ncut in (("annealed, Ncut on", 1.5, 0.5),
                             ("saturated", 1.0, 1.0)):
            a = LinearAnnealing(8)
            a["T"], a["Ncut_factor"] = T, ncut
            em = EM(model, a, {"y": y}, params=init, seed=4,
                    device=torch.device("cuda"))
            for _ in range(3):
                em.step_once()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    em.step_once()
                torch.cuda.synchronize()
            ev = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            if not ev:
                sys.exit("the profiler recorded no device events")
            busy = sum(e.device_time for e in ev) / 4e3
            span = (max(e.time_range.end for e in ev)
                    - min(e.time_range.start for e in ev)) / 4e3
            by = {}
            for e in ev:
                by[e.name] = by.get(e.name, 0.0) + e.device_time / 4e3
            print(f"[profile] {name} {tag}: device busy {busy:.3f} ms per "
                  f"iteration in a window of {span:.3f} ms: idle share "
                  f"{100 * (1 - busy / span):.1f} %  [{card}]")
            for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]:
                print(f"[profile]   {v:8.3f} ms  {k[:100]}")


def cmd_ablate(args):
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from prosper_tpu_torch.ops import cuda_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi()
    src = cuda_lib.CSRC
    base = None
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, fname, old, new) in enumerate(
                [("nothing", None, "", "")] + ABLATIONS + VARIANTS):
            d = Path(tmp) / f"v{i}"
            shutil.copytree(src, d)
            if fname:
                text = (d / fname).read_text()
                if text.count(old) < 1:
                    sys.exit(f"{fname}: {old!r} not found")
                (d / fname).write_text(text.replace(old, new))
            cuda_lib.CSRC, cuda_lib._lib = d, None
            calls = kernel_calls(torch, np) if i == 0 else calls
            ms = {k: cuda_ms(torch, calls[k])
                  for k in ("linear_et_estep", "max_et_estep", "sgemm_nn",
                            "sgemm_tn_splitn")}
            base = base or ms
            print(f"[ablate] without {name}: linear E-step "
                  f"{ms['linear_et_estep']:.3f} ms (saves "
                  f"{base['linear_et_estep'] - ms['linear_et_estep']:.3f}), "
                  f"max E-step {ms['max_et_estep']:.3f} ms (saves "
                  f"{base['max_et_estep'] - ms['max_et_estep']:.3f}), "
                  f"sgemm_nn {ms['sgemm_nn']:.3f} ms, sgemm_tn_splitn "
                  f"{ms['sgemm_tn_splitn']:.3f} ms  [{card}]", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("times")
    t.add_argument("--repo", default=str(ROOT))
    t.set_defaults(fn=cmd_times)
    c = sub.add_parser("compare")
    c.add_argument("--parent", required=True)
    c.set_defaults(fn=cmd_compare)
    sub.add_parser("profile").set_defaults(fn=cmd_profile)
    sub.add_parser("ablate").set_defaults(fn=cmd_ablate)
    args = ap.parse_args()
    os.chdir(ROOT)
    args.fn(args)


if __name__ == "__main__":
    main()
