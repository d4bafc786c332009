#!/usr/bin/env python3
"""Smoke run of prosper_tpu_torch (the PyTorch + CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from prosper_tpu_torch/csrc with nvcc, holds
each kernel against its plain PyTorch version on the card (the two GEMM
kernels against float64 ``torch.matmul``, at the main path's shapes and at
ragged ones), and drives the port's three paths:

* the linear family: the bars through ``EM.run`` on CUDA, then BSC at the
  width of the repo's headline configuration (16x16 patches: D=256, H=300,
  H'=8, gamma=4, 154 multi states) -- an annealed EM run on 131072
  planted-dictionary rows and a decode of 8192 held-out rows (two stages a
  decode: the ``sgemm_nn`` kernel, then the per-datapoint kernel);
* the max family: MCA bars through ``EM.run`` on CUDA, one softened-max
  step (rho > 0, the plain version on the card) against the CPU, then MCA
  and MMCA at the patches width of bench.py (D=256, H=300, H'=6, gamma=3,
  35 multi states) on 131072 rows, each with a decode of 8192 rows;
* the big-S linear E-step (``s_block > 0``): TSC at the width of bench.py's
  tsc_bigs (D=64, H=32, H'=10, gamma=5, 12564 multi states, s_block=1024),
  an annealed EM run on 131072 planted-dictionary rows through the big-S
  kernel and a plain decode of 8192 held-out rows.

Each of the three training paths then runs once more through
``EM.run_scanned`` (the step captured into CUDA graphs and replayed) from
the same seed: parameters, free energies, scalars and the generator's next
draw bit-identical to ``EM.run``'s, every pattern captured, and a profiler
trace of a replay-only pass showing each kernel on the card as often as a
traced ``EM.run``; a fresh ``EM`` and a replay-only pass are timed apart.
One DSC step with a learned value set (``backend="plain"``) and a big-S
E-step cut into two chunks of rows are held against the CPU and against
one chunk.

GSC and the mixtures have no kernel (plain PyTorch on the card; no launch
count may move while they run):

* GSC bars (the tuned configuration of examples/barstest/param_bars_gsc.py)
  through ``EM.run`` on CUDA, 8/8 bars; GSC at the patches width of
  bench.py:652 (D=256, H=300, H'=6, gamma=3, 35 multi states) on 131072
  planted-dictionary rows with a slab, through ``run`` and ``run_scanned``,
  one E-step against the CPU, a decode of 8192 rows;
* MoG and MoP at bench.py:714-727 (D=256, K=300) on 131072 rows through
  ``run`` and ``run_scanned``, an inference of 8192 rows, one step against
  the CPU.

Each path's launch counts are set to 0 just before it and checked just
after.  Every phase raises on failure.  Prints one JSON line of the
iteration times through ``run`` and ``run_scanned``, one of per-kernel
results (time, plain version's time, the card's bound for the same work from
the shapes, and a library call's time where one computes the same function)
and ends with {"ok": true, "device": {"platform": "gpu", ...}}.
Exits non-zero without a result when no CUDA device is present.
"""

import json
import subprocess
import sys
import time

BARS_SEED = 0          # a seed whose noisy bars run recovers all 10 bars
MCA_BARS_SEED = 0      # a seed whose MCA bars run on CUDA recovers all 8
GSC_BARS_SEED = 17     # a seed whose GSC bars run on CUDA recovers all 8
# published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores, TF32 on the tensor cores (dense), and device memory
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12


T0 = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def stamp(what):
    """Log the seconds since the start, after ``what``."""
    log(f"[time] {what} done at {time.perf_counter() - T0:.1f} s")


def cuda_ms(torch, fn, reps):
    """Mean device time of ``fn()`` in ms over ``reps`` launches."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(torch, plain, kernel, reps):
    """(kernel ms, plain ms), timed in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain, reps)
    k1 = cuda_ms(torch, kernel, reps)
    k2 = cuda_ms(torch, kernel, reps)
    p2 = cuda_ms(torch, plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound_split_tf32(flops, nbytes):
    """``bound`` for a float32 product of ``flops`` done as split TF32 on
    the tensor cores: three TF32 products at the TF32 peak."""
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def bound(flops, nbytes):
    """The least time the card could take: {"bound_ms", "bound_by"} from
    the operations over the float32 peak and the bytes over the memory
    rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def reset_launches(cuda_lib):
    for k in cuda_lib.LAUNCHES:
        cuda_lib.LAUNCHES[k] = 0


def expect_launches(cuda_lib, tag, **want):
    """The launch counts since the last reset are exactly ``want`` (every
    kernel not named: 0).  Returns them."""
    got = dict(cuda_lib.LAUNCHES)
    if got != {k: want.get(k, 0) for k in got}:
        raise AssertionError(f"{tag} launches {got}, expected {want} and "
                             "nothing else")
    return got


def next_draw(torch, generator):
    """What ``generator`` would draw next, without moving it."""
    twin = torch.Generator(device=generator.device)
    twin.set_state(generator.get_state())
    return torch.randn(64, generator=twin, device=generator.device)


def same_run(torch, tag, ref, em, first=0):
    """``em`` went where ``ref`` went, bit for bit: parameters, F_prev,
    every scalar of every iteration (``em``'s history starts at iteration
    ``first``: a resumed run), the generator's next draw."""
    for k in ref.params:
        if not torch.equal(ref.params[k], em.params[k]):
            raise AssertionError(f"{tag}: {k} differs from the reference's")
    if not torch.equal(ref.data["F_prev"], em.data["F_prev"]):
        raise AssertionError(f"{tag}: F_prev differs from the reference's")
    if len(ref.history) - first != len(em.history):
        raise AssertionError(f"{tag}: history length")
    for hr, he in zip(ref.history[first:], em.history):
        for k in hr:
            if k != "dt" and hr[k] != he[k]:
                raise AssertionError(
                    f"{tag}: {k} of iteration {hr['iteration']} is "
                    f"{he[k]!r}, the reference's {hr[k]!r}")
    if not torch.equal(next_draw(torch, ref.generator),
                       next_draw(torch, em.generator)):
        raise AssertionError(f"{tag}: the generator's next draw differs "
                             "from the reference's")


#: the device function behind each launch count (prosper_tpu_torch/csrc)
KERNEL_FUNCS = {"estep": "rows_kernel", "decode": "decode_kernel",
                "max_estep": "max_estep_kernel", "bigs": "bigs_kernel",
                "sgemm_nn": "nn_kernel", "sgemm_tn": "tn_kernel"}


def traced_kernels(torch, run):
    """How often each of the port's kernels ran on the card during
    ``run()``, by launch-count name: counted from a profiler trace of the
    device, so a graph replay, which passes no launch site, shows too."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        raise AssertionError("the profiler recorded no device events")
    return {k: sum(fn in n for n in names) for k, fn in KERNEL_FUNCS.items()}


def scanned_path(torch, np, cuda_lib, tag, ref, make_em, init, seed, smi,
                 **want):
    """This slice's path: ``make_em()`` (an EM built as ``ref`` was, on the
    same model object) through ``run_scanned`` against ``ref``, which went
    through ``run`` with the launch counts ``want``.  Four passes: a first
    EM (one eager step and one capture per pattern, then replays), a fresh
    EM (the same again with nothing left to build), that EM rewound
    (replays only), and rewound once more under the profiler, whose count of
    each kernel on the card must equal that of a traced ``run``.  Returns
    the path's entry of the ``scanned`` line and the launch counts of the
    first pass (its eager steps and captures: a replay passes no launch
    site)."""
    iters = len(ref.history)
    run_ms = float(np.median([h["dt"] for h in ref.history[1:]])) * 1e3
    reset_launches(cuda_lib)
    em = make_em()
    em.run_scanned()
    torch.cuda.synchronize()
    stats = dict(em.scan_stats)
    if stats["graphs"] < 2 or stats["eager_steps"] + stats["replays"] != iters:
        raise AssertionError(f"{tag} run_scanned did not capture its "
                             f"patterns: {stats}")
    # the launch sites were passed by the eager steps and the captures; the
    # replays hold what the captures recorded
    per_step = {k: v // iters for k, v in want.items()}
    sited = stats["eager_steps"] + stats["graphs"]
    launches = expect_launches(cuda_lib, f"{tag} run_scanned",
                               **{k: n * sited for k, n in per_step.items()})
    replayed = stats["replayed_launches"]
    if replayed != {k: n * stats["replays"] for k, n in per_step.items()}:
        raise AssertionError(f"{tag} run_scanned: its {stats['replays']} "
                             f"replays hold {replayed}, a step of run "
                             f"launches {per_step}")
    same_run(torch, f"{tag} run_scanned", ref, em)
    first_ms = em.history[-1]["dt"] * 1e3
    capture_ms = stats["capture_s"] * 1e3 / stats["graphs"]

    fresh = make_em()
    fresh.run_scanned()
    same_run(torch, f"{tag} run_scanned", ref, fresh)
    fresh_ms = fresh.history[-1]["dt"] * 1e3

    def replay_all():
        """Rewind: the same iterations again, every graph in hand."""
        fresh.anneal.reset(0)
        fresh.params = {k: v.clone() for k, v in init.items()}
        fresh.data = dict(fresh.data,
                          F_prev=torch.zeros_like(fresh.data["F_prev"]))
        fresh.generator.manual_seed(seed)
        fresh.history.clear()
        before = fresh.scan_stats["replays"]
        fresh.run_scanned()
        same_run(torch, f"{tag} run_scanned", ref, fresh)
        if fresh.scan_stats["replays"] - before != iters:
            raise AssertionError(f"{tag} the rewound run_scanned did not "
                                 f"replay every iteration: "
                                 f"{fresh.scan_stats}")
    replay_all()
    replay_ms = fresh.history[-1]["dt"] * 1e3
    traced = traced_kernels(torch, replay_all)
    traced_run = traced_kernels(torch, make_em().run)
    if traced != traced_run or any(traced[k] < v for k, v in want.items()):
        raise AssertionError(f"{tag} kernels on the card in {iters} replays "
                             f"{traced}, in {iters} eager steps {traced_run}, "
                             f"run's launch counts {want}")
    log(f"{tag} run_scanned bit-identical to run over {iters} iterations "
        f"(parameters, F_prev, scalars, the generator's next draw); "
        f"{stats['graphs']} graphs, {stats['replays']} replays, "
        f"{stats['eager_steps']} eager first steps; launch sites passed "
        f"{launches}, held by the replays {replayed}; kernels traced on the "
        f"card in {iters} replays {traced}, as in {iters} eager steps; host "
        f"ms per iteration: run {run_ms:.3f}, run_scanned {replay_ms:.3f} "
        f"replaying, {first_ms:.3f} with its captures in a first EM "
        f"({capture_ms:.1f} ms a capture), {fresh_ms:.3f} in a fresh EM  "
        f"[{smi}]")
    return {"iterations": iters, "run_ms": run_ms,
            "run_scanned_ms": replay_ms,
            "run_scanned_first_em_ms": first_ms,
            "run_scanned_fresh_em_ms": fresh_ms, "capture_ms": capture_ms,
            "graphs": stats["graphs"],
            "replays": stats["replays"],
            "eager_first_steps": stats["eager_steps"],
            "replayed_launches": replayed,
            "replay_kernels_traced": traced}, launches


def gemm_phase(torch, np, dev, smi, err):
    """The two GEMM kernels against float64 ``torch.matmul``: exactly on
    inputs quantised to 1/4 (every product and partial sum is then exact in
    float32), within rounding on Gaussian ones, repeated calls
    bit-identical; then their times at the main path's shape beside
    ``torch.matmul`` in float32 (the library call, which the port never
    makes), at the main path's rows and a decode's, with the bound of the
    split-TF32 work the kernels do and that of a float32 product on the CUDA
    cores; the MMAs in their SASS.  Returns each kernel's entries for the
    JSON line."""
    from prosper_tpu_torch.ops import gemm_cuda

    gen = torch.Generator(device=dev).manual_seed(7)
    share = {"sgemm_nn": 0.0, "sgemm_tn": 0.0}
    shapes = [(131072, 256, 300)] + [(N, D, H) for N in (1000, 16385)
                                     for D in (25, 256) for H in (10, 300)]
    for N, D, H in shapes:
        for quantised in (True, False):
            def draw(*shape):
                a = torch.randn(shape, generator=gen, device=dev)
                return torch.round(a * 4) / 4 if quantised else a
            y, W, sw = draw(N, D), draw(D, H), draw(N, H)
            y[3] = 0.0                                  # a row of zeros
            base = draw(D, H)
            for name, out, again, ref, depth in (
                    ("sgemm_nn", gemm_cuda.sgemm_nn_cuda(y, W),
                     gemm_cuda.sgemm_nn_cuda(y, W), y.double() @ W.double(),
                     D),
                    ("sgemm_tn", gemm_cuda.sgemm_tn_splitn_cuda(y, sw),
                     gemm_cuda.sgemm_tn_splitn_cuda(y, sw),
                     y.double().T @ sw.double(), N),
                    ("sgemm_tn", gemm_cuda.sgemm_tn_splitn_cuda(
                        y, sw, out=base.clone(), accumulate=True),
                     gemm_cuda.sgemm_tn_splitn_cuda(
                         y, sw, out=base.clone(), accumulate=True),
                     base.double() + y.double().T @ sw.double(), N)):
                torch.cuda.synchronize()
                if not torch.equal(out, again):
                    raise AssertionError(f"{name} {N}x{D}x{H}: two calls "
                                         "differ")
                e = (out.double() - ref).abs().max().item()
                # a float32 fmaf chain of `depth` unit-variance products:
                # error within 2e-7 per term, relative 1e-5
                tol = 0.0 if quantised else 2e-7 * depth
                if quantised and e != 0.0:
                    raise AssertionError(f"{name} {N}x{D}x{H}: not exact on "
                                         f"quantised inputs (max abs {e})")
                torch.testing.assert_close(out.double(), ref, rtol=1e-5,
                                           atol=tol, msg=f"{name} {N}x{D}x{H}")
                err[name] = max(err[name], e)
                if not quantised:       # the largest share of the tolerance
                    used = ((out.double() - ref).abs()
                            / (tol + 1e-5 * ref.abs())).max().item()
                    share[name] = max(share[name], used)
                    log(f"[gemm] {name} {N}x{D}x{H} on Gaussian inputs: max "
                        f"abs error {e:.3e}, {100 * used:.1f} % of the "
                        "tolerance")
    log(f"[gemm] sgemm_nn and sgemm_tn_splitn agree with float64 matmul at "
        f"{len(shapes)} shapes (exactly on quantised inputs; repeated calls "
        "bit-identical)")

    sass = gemm_sass()
    out = {}
    for N in (131072, 8192):          # the main path's rows; a decode's
        D, H = 256, 300
        y, W, sw = draw(N, D), draw(D, H), draw(N, H)
        nn = interleaved_ms(torch, lambda: torch.matmul(y, W),
                            lambda: gemm_cuda.sgemm_nn_cuda(y, W), reps=10)
        tn = interleaved_ms(torch, lambda: torch.matmul(y.T, sw),
                            lambda: gemm_cuda.sgemm_tn_splitn_cuda(y, sw),
                            reps=10)
        flops = 2.0 * N * D * H
        nbytes = 4.0 * (N * D + D * H + N * H)
        tc, f32 = bound_split_tf32(flops, nbytes), bound(flops, nbytes)
        log(f"[gemm] N={N}, D={D}, H={H}: sgemm_nn {nn[0]:.3f} ms "
            f"({flops / nn[0] / 1e9:.1f} TFLOP/s of the float32 product) vs "
            f"torch.matmul {nn[1]:.3f} ms; sgemm_tn_splitn {tn[0]:.3f} ms "
            f"({flops / tn[0] / 1e9:.1f} TFLOP/s) vs torch.matmul "
            f"{tn[1]:.3f} ms; bound of the split-TF32 work "
            f"{tc['bound_ms']:.3f} ms by {tc['bound_by']} (sgemm_nn "
            f"{100 * tc['bound_ms'] / nn[0]:.1f} %, sgemm_tn_splitn "
            f"{100 * tc['bound_ms'] / tn[0]:.1f} % of it), of a float32 "
            f"product on the CUDA cores {f32['bound_ms']:.3f} ms  [{smi}]")
        for name, t in (("sgemm_nn", nn), ("sgemm_tn", tn)):
            if N == 131072:
                out[name] = {"ms": t[0], "plain_ms": t[1], "library_ms": t[1],
                             **tc, "bound_f32_cuda_cores_ms": f32["bound_ms"],
                             "tolerance_share": share[name],
                             "sass": sass[name]}
            else:
                out[name].update({f"ms_{N}_rows": t[0],
                                  f"library_ms_{N}_rows": t[1],
                                  f"bound_ms_{N}_rows": tc["bound_ms"]})
    return out


def gemm_sass():
    """Instructions of the built GEMM kernels by kind, from the library's
    SASS (``cuobjdump -sass`` of the CUDA toolkit, or the copy in Triton's
    package): the tensor-core MMAs must be there.  Where no cuobjdump is
    found, says so and returns None for each."""
    import os
    import shutil
    from prosper_tpu_torch.ops import cuda_lib
    tools = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "cuobjdump"), shutil.which("cuobjdump")]
    try:
        import triton
        tools.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    tool = next((t for t in tools if t and os.path.exists(t)), None)
    if tool is None:
        log("[gemm] SASS: no cuobjdump found, not read")
        return {"sgemm_nn": None, "sgemm_tn": None}
    text = subprocess.run([tool, "-sass", cuda_lib.load_library()._name],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = {}
        elif fn is not None:
            for op in ("HGMMA", "HMMA", "FFMA"):
                if f" {op}." in line or f" {op} " in line:
                    counts[fn][op] = counts[fn].get(op, 0) + 1
    out = {}
    for name, func in (("sgemm_nn", KERNEL_FUNCS["sgemm_nn"]),
                       ("sgemm_tn", KERNEL_FUNCS["sgemm_tn"])):
        found = {fn: c for fn, c in counts.items() if func in fn}
        log(f"[gemm] SASS of {func}: {found}")
        if not found or any(c.get("HGMMA", 0) < 1 for c in found.values()):
            raise AssertionError(f"{func}: no HGMMA in its SASS: the "
                                 "tensor cores are not used")
        out[name] = {fn: c.get("HGMMA", 0) for fn, c in found.items()}
    return out


def check_path(torch, np, tag, em, serve, H):
    """A path's EM run and decodes: Q_mean finite and rising, F finite;
    decode outputs finite, top_probs descending, the compact decode
    densifying to the dense one."""
    from prosper_tpu_torch.core.etstep import densify_top_states
    Q = [h["Q_mean"] for h in em.history]
    log(f"{tag} Q_mean by iteration: " + " ".join(f"{q:.3f}" for q in Q))
    log(f"{tag} n_used by iteration: "
        + " ".join(f"{h['n_used']:.0f}" for h in em.history))
    if not (np.isfinite(Q).all() and Q[-1] > Q[0]):
        raise AssertionError(f"{tag} Q_mean is not finite or did not rise")
    if not torch.isfinite(em.data["F_prev"]).all():
        raise AssertionError(f"{tag} non-finite F")
    compact, dense = serve[False], serve[True]
    for out in (compact, dense):
        for k in ("F", "s_mean", "recon", "top_probs"):
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"{tag} non-finite {k} in the decode")
        if (out["top_probs"][:, 1:] > out["top_probs"][:, :-1]).any():
            raise AssertionError(f"{tag} top_probs not in descending order")
    if not torch.equal(densify_top_states(compact, H), dense["top_states"]):
        raise AssertionError(f"{tag} compact decode does not densify to the "
                             "dense")
    if dense["top_states"].shape != (8192, 10, H):
        raise AssertionError(f"{tag} dense top_states has the wrong shape")


def max_family(torch, np, dev, smi, err, patches_anneal):
    """Phases 7-10: the max kernel against its plain version, MCA bars on
    the card, one softened-max step, and the MCA / MMCA path at patches
    width.  Returns the max kernel's launches and times for the JSON line."""
    from prosper_tpu_torch import EM, LinearAnnealing
    from prosper_tpu_torch.core import etstep, maxstep
    from prosper_tpu_torch.core.states import binary_state_space
    from prosper_tpu_torch.data.bars import (bars_gt_params,
                                             count_recovered_bars,
                                             planted_dictionary)
    from prosper_tpu_torch.io.weights import params_from_numpy
    from prosper_tpu_torch.models import MCA, MMCA
    from prosper_tpu_torch.models.base import make_blank_data, sched_floats
    from prosper_tpu_torch.ops import cuda_lib, max_cuda

    def quarters(a):
        return np.round(np.asarray(a, np.float64) * 4) / 4

    # ---- 7. the max kernel against its plain version --------------------------
    # inputs quantised to multiples of 1/4: P, y.ybar and ||ybar||^2 are then
    # exact in float32, so candidates and winners (ties included) must agree
    rng = np.random.default_rng(5)
    for name, N, D, H in (("bars", 1000, 16, 8), ("mca_small", 4096, 64, 100),
                          ("patches", 16384, 256, 300)):
        Hp, gamma = 6, 3
        sa = etstep.state_arrays_from(binary_state_space(Hp, gamma), dev)
        for magnitude in (False, True):
            W_np = quarters(rng.standard_normal((D, H)) * 2)
            if not magnitude:
                W_np = np.abs(W_np)
            y = torch.tensor(quarters(rng.standard_normal((N, D)) * 2),
                             dtype=torch.float32, device=dev)
            W = torch.tensor(W_np, dtype=torch.float32, device=dev)
            w = torch.tensor(rng.random(N) > 0.2, dtype=torch.float32,
                             device=dev)
            w[:40] = 0.0
            lo = torch.tensor(float(np.log(2.0 / H) - np.log1p(-2.0 / H)),
                              device=dev)
            sigma2 = torch.tensor(2.0, device=dev)
            for beta in (0.6, 1.0):
                args = (y, w, W, sigma2, lo, sa, Hp, magnitude, beta, 1.0)
                F0, ref = maxstep.max_et_estep(*args, chunk=2048)
                F1, on = max_cuda.max_et_estep_cuda(*args, collect_true=True)
                _, off = max_cuda.max_et_estep_cuda(*args, collect_true=False)
                torch.cuda.synchronize()
                torch.testing.assert_close(F1, F0, rtol=1e-4, atol=1e-4)
                err["max_estep"] = max(err["max_estep"],
                                       (F1 - F0).abs().max().item())
                for k in ref:
                    torch.testing.assert_close(on[k], ref[k], rtol=1e-3,
                                               atol=1e-3, msg=f"{name} {k}")
                    err["max_estep"] = max(err["max_estep"],
                                           (on[k] - ref[k]).abs().max().item())
                    if beta == 1.0 and k != "F_true" and not torch.equal(
                            on[k], off[k]):
                        raise AssertionError(f"{name}: {k} differs with "
                                             "collect_true off at beta=1")
        log(f"[max kernel] {name} (N={N}, D={D}, H={H}): MCA and MMCA agree "
            "with the plain version (beta 0.6 and 1, collect_true on/off "
            "bit-identical)")

    # ---- 8. MCA bars on the card ----------------------------------------------
    def bars_anneal():
        a = LinearAnnealing(60)
        a["T"] = [(0.0, 2.0), (0.7, 1.0)]
        a["W_noise"] = [(0.0, 1.0), (0.7, 0.0)]
        a["Ncut_factor"] = [(0.5, 0.0), (0.8, 1.0)]
        return a

    model = MCA(16, 8, 6, 3, chunk=1000)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    data = model.generate_data(gt, 1000, seed=21)
    reset_launches(cuda_lib)
    params = EM(model, bars_anneal(), {"y": data["y"]}, seed=MCA_BARS_SEED,
                device=dev).run()
    n_rec = count_recovered_bars(params["W"].cpu().numpy(), gt["W"], 0.8)
    sig = float(params["sigma"])
    log(f"[mca bars] {n_rec}/8 bars, sigma {sig:.4f}, launches "
        f"{dict(cuda_lib.LAUNCHES)}")
    if n_rec != 8 or abs(sig - 1.0) >= 0.3:
        raise AssertionError("MCA bars not recovered on the card")
    expect_launches(cuda_lib, "[mca bars]", max_estep=60, sgemm_nn=60,
                    sgemm_tn=60)

    # ---- 9. one softened-max step on CUDA against the CPU ---------------------
    yq = quarters(data["y"]).astype(np.float32)
    p0 = {"W": quarters(gt["W"] * 0.8 + 1.0), "pi": np.float32(0.2),
          "sigma": np.float32(1.5)}
    a = LinearAnnealing(10)
    a["T"] = 1.5
    a["rho"] = 4.0
    sched = sched_floats(a)
    out = {}
    for d in (dev, torch.device("cpu")):
        before = cuda_lib.LAUNCHES["max_estep"]
        out[d.type] = model.step_fn(params_from_numpy(p0, d),
                                    make_blank_data(yq, device=d), sched,
                                    torch.Generator(device=d))
        if cuda_lib.LAUNCHES["max_estep"] != before:
            raise AssertionError("a softened-max step launched the kernel")
    for k, v in out["cpu"][0].items():
        torch.testing.assert_close(out[dev.type][0][k].cpu(), v, rtol=1e-4,
                                   atol=1e-6, msg=f"softened-max step {k}")
    torch.testing.assert_close(out[dev.type][1].cpu(), out["cpu"][1],
                               rtol=1e-4, atol=1e-4)
    log("[mca rho=4] one softened-max step on CUDA (plain version, no kernel "
        "launch) matches the CPU")

    # ---- 10. MCA and MMCA at patches width -----------------------------------
    D, H, Hp, gamma, N = 256, 300, 6, 3, 131072
    W_gt = planted_dictionary(D, H, seed=0)
    result = {}
    for cls, iters in ((MCA, 6), (MMCA, 4)):
        model = cls(D, H, Hp, gamma)
        W_c = W_gt.copy()
        if cls is MMCA:
            W_c[:, 1::2] *= -1.0
        gt = {"W": W_c, "pi": np.float32(2.0 / H), "sigma": np.float32(1.0)}
        data = model.generate_data(gt, N, seed=1)
        held_out = model.generate_data(gt, 8192, seed=2)
        init = model.standard_init(data, seed=3, device=dev)
        y_dev = torch.tensor(data["y"], device=dev)
        torch.cuda.synchronize()
        reset_launches(cuda_lib)
        em = EM(model, patches_anneal(iters), {"y": y_dev}, params=init,
                seed=4, device=dev)
        params = em.run()
        serve = {dense: model.inference(params, held_out, top_L=10,
                                        dense_states=dense)
                 for dense in (False, True)}
        torch.cuda.synchronize()
        tag = f"[{cls.__name__.lower()} patches]"
        launches = expect_launches(cuda_lib, tag, max_estep=iters,
                                   sgemm_nn=iters, sgemm_tn=iters)
        log(f"{tag} launches on the path: {launches}")
        check_path(torch, np, tag, em, serve, H)
        result[cls.__name__] = (em, model, params, init, y_dev, iters,
                                launches)

    # timing at N = 131072 (MCA): the kernel against the plain version, and
    # the EM iteration both ways
    em, model, params, init, y_dev, iters, launches = result["MCA"]
    em_ms = float(np.median([h["dt"] for h in em.history[1:]])) * 1e3
    sa = model.state_arrays(dev)
    scanned, scanned_launches = scanned_path(
        torch, np, cuda_lib, "[mca patches]", em,
        lambda: EM(model, patches_anneal(iters), {"y": y_dev}, params=init,
                   seed=4, device=dev),
        init, 4, smi, max_estep=iters, sgemm_nn=iters, sgemm_tn=iters)

    reset_launches(cuda_lib)
    em_p = EM(MCA(D, H, Hp, gamma, backend="plain"), patches_anneal(iters),
              {"y": y_dev}, params=init, seed=4, device=dev)
    em_p.run()
    expect_launches(cuda_lib, "[mca patches] backend=plain")
    em_plain_ms = float(np.median([h["dt"] for h in em_p.history[1:]])) * 1e3
    log(f"[mca patches] EM iteration (N={N}): kernel path {em_ms:.3f} ms, "
        f"plain version {em_plain_ms:.3f} ms  [{smi}]")
    W, sig2, lo = params["W"], params["sigma"] ** 2, model._log_odds(params)
    y_all, weight = em.data["y"], em.data["valid"]
    est = interleaved_ms(
        torch,
        lambda: maxstep.max_et_estep(y_all, weight, W, sig2, lo, sa, Hp,
                                     False, 1.0, 1.0, chunk=model.chunk),
        lambda: max_cuda.max_et_estep_cuda(y_all, weight, W, sig2, lo, sa, Hp,
                                           False, 1.0, 1.0),
        reps=3)
    log(f"[mca patches] max E-step kernel {est[0]:.3f} ms vs plain "
        f"{est[1]:.3f} ms (N={N}) = {N / est[0] * 1e3:.0f} vs "
        f"{N / est[1] * 1e3:.0f} datapoints/s  [{smi}]")
    S = sa.states.shape[0]
    # the two D x H products, and two passes over the (S, D) lattice per
    # row: a compare-select and two FMAs, then a compare-select and an add
    return {"launches": launches, "scanned": scanned,
            "scanned_launches": scanned_launches, "ms": est[0],
            "plain_ms": est[1],
            **bound(4.0 * N * D * H + 8.0 * N * S * D,
                    4.0 * (N * D + 2 * N + D * H + 2 * H * D))}


def bigs_path(torch, np, dev, smi, err, patches_anneal):
    """Phases 11-12: the big-S kernel against its plain version, and the
    big-S TSC path at the width of bench.py's tsc_bigs.  Returns the
    kernel's launches and times for the JSON line."""
    from prosper_tpu_torch import EM
    from prosper_tpu_torch.core import etstep
    from prosper_tpu_torch.core.states import discrete_state_space
    from prosper_tpu_torch.data.bars import planted_dictionary
    from prosper_tpu_torch.models import TSC
    from prosper_tpu_torch.ops import bigs_cuda, cuda_lib, linear_cuda

    def multi_args(y, W, lo, sa, Hp, signed, sigma2, s_block, beta,
                   prior_beta):
        """The operands the big-S E-step hands the recurrence, the tables
        padded to a multiple of ``s_block`` (1: unpadded, as on CUDA)."""
        gram = W.T @ W
        _, _, tables = etstep.bigs_front(y, W, gram, torch.diagonal(gram),
                                         lo, sa, Hp, signed, s_block)
        return (*tables, 0.5 / sigma2, beta, prior_beta, s_block)

    # ---- 11. the big-S kernel against its plain version --------------------
    # inputs quantised to multiples of 1/4, so candidates agree exactly; the
    # logits and moments are sums in another order than cuBLAS's (and over
    # the reduced operands: beta (x.a), not (beta x).a), hence F (and the
    # running max) within rtol 1e-4, every sum within rtol 1e-3
    rng = np.random.default_rng(11)
    shapes = [  # (name, N, D, H, Hp, gamma, values, signed, s_block)
        ("bsc", 1000, 16, 12, 6, 4, (1.0,), False, 48),
        ("tsc", 1000, 16, 12, 6, 4, (-1.0, 1.0), True, 48),
        ("dsc", 999, 16, 12, 6, 4, (-1.0, 1.0, 2.0), True, 48),
        ("tsc_bigs", 16384, 64, 32, 10, 5, (-1.0, 1.0), True, 1024),
        ("bsc_odd_S", 1000, 16, 13, 6, 3, (1.0,), False, 16),    # S = 35
        ("tsc_hp3", 777, 16, 12, 3, 2, (-1.0, 1.0), True, 8),    # nL = 9
    ]
    for name, N, D, H, Hp, gamma, values, signed, s_block in shapes:
        sa = etstep.state_arrays_from(discrete_state_space(Hp, gamma, values),
                                      dev)
        S = sa.states.shape[0]
        W_np = np.round(rng.standard_normal((D, H)) * 4) / 4
        W_np[:, 2] = 0.0                                    # a dead unit
        W = torch.tensor(W_np, dtype=torch.float32, device=dev)
        y = torch.tensor(np.round(rng.standard_normal((N, D)) * 6) / 4,
                         dtype=torch.float32, device=dev)
        w = torch.tensor(rng.random(N) > 0.2, dtype=torch.float32, device=dev)
        w[:40] = 0.0                                        # zero-weight rows
        K = len(values)
        lo = torch.full((K,), float(np.log(2.0 / (H * K))
                                    - np.log1p(-2.0 / H)), device=dev)
        sigma2 = torch.tensor(2.0, device=dev)
        for beta in (0.6, 1.0):
            for prior_beta in (1.0, 0.8, 0.0):
                margs = multi_args(y, W, lo, sa, Hp, signed, sigma2, s_block,
                                   beta, prior_beta)
                ref = etstep.bigs_multi(*margs, collect_true=True)
                on = bigs_cuda.bigs_multi_cuda(*margs, collect_true=True)
                off = bigs_cuda.bigs_multi_cuda(*margs, collect_true=False)
                again = bigs_cuda.bigs_multi_cuda(*margs, collect_true=True)
                torch.cuda.synchronize()
                for i, field in enumerate(("m", "l", "m_t", "l_t", "a_abs",
                                           "a_s", "a_ss", "a_vc")):
                    tol = 1e-4 if field in ("m", "m_t") else 1e-3
                    torch.testing.assert_close(
                        on[i], ref[i], rtol=tol, atol=tol,
                        msg=f"{name} beta={beta} prior_beta={prior_beta} "
                            f"{field}")
                    err["bigs"] = max(err["bigs"],
                                      (on[i] - ref[i]).abs().max().item())
                    if not torch.equal(on[i], again[i]):
                        raise AssertionError(f"{name}: {field} differs "
                                             "between two calls")
                    if field not in ("m_t", "l_t") and not torch.equal(
                            on[i], off[i]):
                        raise AssertionError(f"{name}: {field} differs with "
                                             "collect_true off")
                args = (y, w, W, sigma2, lo, sa, Hp, signed, beta, prior_beta)
                F0, sums0 = etstep.linear_et_estep(*args, chunk=N,
                                                   s_block=s_block)
                F1, sums1 = linear_cuda.linear_et_estep(*args,
                                                        s_block=s_block)
                _, sums_off = linear_cuda.linear_et_estep(
                    *args, s_block=s_block, collect_true=False)
                _, sums_again = linear_cuda.linear_et_estep(*args,
                                                            s_block=s_block)
                torch.cuda.synchronize()
                torch.testing.assert_close(F1, F0, rtol=1e-4, atol=1e-4)
                for k in sums0:
                    torch.testing.assert_close(
                        sums1[k], sums0[k], rtol=1e-3, atol=1e-3,
                        msg=f"{name} beta={beta} prior_beta={prior_beta} {k}")
                    if not torch.equal(sums1[k], sums_again[k]):
                        raise AssertionError(f"{name}: sum {k} differs "
                                             "between two calls")
                    if beta == 1.0 and prior_beta == 1.0 and k != "F_true" \
                            and not torch.equal(sums1[k], sums_off[k]):
                        raise AssertionError(f"{name}: sum {k} differs with "
                                             "collect_true off at beta=1")
        log(f"[bigs kernel] {name} (N={N}, D={D}, H={H}, H'={Hp}, "
            f"gamma={gamma}, S={S}, s_block={s_block}): the recurrence and "
            "the E-step agree with the plain versions (beta 0.6 and 1, "
            "prior_beta 1, 0.8 and 0; repeated calls and collect_true off "
            "bit-identical)")

    # ---- 12. big-S TSC at the width of bench.py's tsc_bigs -----------------
    D, H, Hp, gamma, N, iters, s_block = 64, 32, 10, 5, 131072, 6, 1024
    model = TSC(D, H, Hp, gamma, chunk=8192, s_block=s_block)
    gt = {"W": planted_dictionary(D, H, seed=0), "pi": np.float32(0.1),
          "sigma": np.float32(1.0)}
    data = model.generate_data(gt, N, seed=1)
    held_out = model.generate_data(gt, 8192, seed=2)
    init = model.standard_init(data, seed=3, device=dev)
    y_dev = torch.tensor(data["y"], device=dev)
    torch.cuda.synchronize()
    reset_launches(cuda_lib)
    em = EM(model, patches_anneal(iters), {"y": y_dev}, params=init, seed=4,
            device=dev)
    params = em.run()
    serve = {dense: model.inference(params, held_out, top_L=10,
                                    dense_states=dense)
             for dense in (False, True)}
    torch.cuda.synchronize()
    tag = "[tsc bigs]"
    launches = expect_launches(cuda_lib, tag, bigs=iters)
    S = model.space.states.shape[0]
    log(f"{tag} S={S} multi states; launches on "
        f"the path: {launches}")
    check_path(torch, np, tag, em, serve, H)

    # timing at N = 131072: the EM iteration through the kernel and through
    # the plain version, and the kernel against bigs_multi
    em_ms = float(np.median([h["dt"] for h in em.history[1:]])) * 1e3
    sa = model.state_arrays(dev)
    scanned, scanned_launches = scanned_path(
        torch, np, cuda_lib, tag, em,
        lambda: EM(model, patches_anneal(iters), {"y": y_dev}, params=init,
                   seed=4, device=dev),
        init, 4, smi, bigs=iters)

    reset_launches(cuda_lib)
    em_p = EM(TSC(D, H, Hp, gamma, chunk=8192, s_block=s_block,
                  backend="plain"), patches_anneal(iters), {"y": y_dev},
              params=init, seed=4, device=dev)
    em_p.run()
    expect_launches(cuda_lib, f"{tag} backend=plain")
    em_plain_ms = float(np.median([h["dt"] for h in em_p.history[1:]])) * 1e3
    log(f"{tag} EM iteration (N={N}): kernel path {em_ms:.3f} ms, plain "
        f"version {em_plain_ms:.3f} ms  [{smi}]")
    for name, run in (("kernel path", em), ("plain version", em_p)):
        log(f"{tag} {name}, ms by iteration (T): " + " ".join(
            f"{h['dt'] * 1e3:.3f} ({h['T']:.3f})" for h in run.history))
    # the kernel on the operands of the main path (the unpadded tables the
    # E-step hands it), the plain version on the same ones padded to s_block
    # (the padded states are masked, so the results agree); tolerances and
    # bit-identities as in phase 11
    ops = (em.data["y"], params["W"], model.log_odds(params), sa, Hp, True,
           params["sigma"] ** 2)
    kargs = multi_args(*ops, 1, 1.0, 1.0)
    pargs = multi_args(*ops, s_block, 1.0, 1.0)
    on, off = (bigs_cuda.bigs_multi_cuda(*kargs, collect_true=c)
               for c in (True, False))
    ref = etstep.bigs_multi(*pargs, collect_true=True)
    torch.cuda.synchronize()
    for i, field in enumerate(("m", "l", "m_t", "l_t", "a_abs", "a_s", "a_ss",
                               "a_vc")):
        tol = 1e-4 if field in ("m", "m_t") else 1e-3
        torch.testing.assert_close(on[i], ref[i], rtol=tol, atol=tol,
                                   msg=f"{tag} N={N} {field}")
        err["bigs"] = max(err["bigs"], (on[i] - ref[i]).abs().max().item())
        if field not in ("m_t", "l_t") and not torch.equal(on[i], off[i]):
            raise AssertionError(f"{tag} N={N}: {field} differs with "
                                 "collect_true off")
    del on, off, ref
    log(f"{tag} the kernel on the main path's operands (N={N}, S={S}, "
        "unpadded) agrees with the plain version; collect_true off "
        "bit-identical")
    est = interleaved_ms(
        torch, lambda: etstep.bigs_multi(*pargs, collect_true=True),
        lambda: bigs_cuda.bigs_multi_cuda(*kargs, collect_true=True), reps=3)
    sat = interleaved_ms(
        torch, lambda: etstep.bigs_multi(*pargs, collect_true=False),
        lambda: bigs_cuda.bigs_multi_cuda(*kargs, collect_true=False), reps=3)
    log(f"{tag} big-S kernel {est[0]:.3f} ms vs plain {est[1]:.3f} ms with "
        f"the un-annealed channel, {sat[0]:.3f} vs {sat[1]:.3f} ms without "
        f"(N={N}) = {N / est[0] * 1e3:.0f} vs {N / est[1] * 1e3:.0f} "
        f"datapoints/s  [{smi}]")
    # what the function needs per (row, state): nL multiply-adds of logits
    # (one dot product serves both channels; the Gram and outer blocks are
    # symmetric) and nM of moments; its inputs (proj, Gf, the state tables)
    # read once, its eight outputs written once
    K = kargs[4].shape[1]
    nX = Hp + Hp * Hp
    nL = Hp + Hp * (Hp + 1) // 2
    nM = nL + K + 2
    merged = bound(2.0 * (2 * (nX + 2) + nX + K + 2) * N * S, 0.0)
    log(f"{tag} bound by the function's {nL} + {nM} multiply-adds per "
        f"(row, state): {2e3 * (nL + nM) * N * S / PEAK_F32_FLOPS:.3f} ms; by "
        f"the merged-GEMM formulation's count (the earlier yardstick): "
        f"{merged['bound_ms']:.3f} ms annealed")
    # ---- 13. the big-S E-step cut into two chunks of rows ------------------
    # a workspace limit that halves the rows, against all rows in one chunk:
    # F row by row is the same arithmetic; the sums are two partial sums
    # added, within rtol 1e-5 of each sum's largest entry
    w_all = em.data["valid"]
    eargs = (em.data["y"], w_all, params["W"], params["sigma"] ** 2,
             model.log_odds(params), sa, Hp, True, 0.8, 1.0)
    reset_launches(cuda_lib)
    F_one, s_one = linear_cuda.linear_et_estep(*eargs, s_block=s_block)
    limit = cuda_lib.P_LIMIT_BYTES
    cuda_lib.P_LIMIT_BYTES = 4 * Hp * H * (N // 2)
    try:
        chunks = cuda_lib.row_chunks(N, Hp * H)
        F_two, s_two = linear_cuda.linear_et_estep(*eargs, s_block=s_block)
    finally:
        cuda_lib.P_LIMIT_BYTES = limit
    torch.cuda.synchronize()
    expect_launches(cuda_lib, f"{tag} row chunks", bigs=3)
    if len(chunks) != 2 or not torch.equal(F_one, F_two):
        raise AssertionError(f"{tag} two row chunks: {chunks}, or F differs")
    for k in s_one:
        torch.testing.assert_close(
            s_two[k], s_one[k], rtol=1e-5,
            atol=1e-5 * s_one[k].abs().max().item(),
            msg=f"{tag} two row chunks: {k}")
    log(f"{tag} the E-step in two chunks of rows {chunks} agrees with one "
        "chunk (F bit-identical, sums within rtol 1e-5)")
    return {"launches": launches, "scanned": scanned,
            "scanned_launches": scanned_launches, "ms": est[0],
            "plain_ms": est[1],
            **bound(2.0 * (nL + nM) * N * S,
                    4.0 * (N * nX + S * (nX + K + 3) + N * (nX + K + 5)))}


def learned_phi_step(torch, np, dev, cuda_lib):
    """Phase 14: one EM step of DSC with a learned value set, built with
    ``backend="plain"`` (the plain version on the card: it collects the
    value-set sums, which no kernel does; the default backend must refuse
    the step there), against the same step on the CPU; rtol 1e-4, the sums
    being taken in another order."""
    from prosper_tpu_torch import LinearAnnealing
    from prosper_tpu_torch.data.bars import planted_dictionary
    from prosper_tpu_torch.io.weights import params_from_numpy
    from prosper_tpu_torch.models import DSC
    from prosper_tpu_torch.models.base import make_blank_data, sched_floats

    D, H, Hp, gamma, N = 64, 32, 6, 3, 8192
    kw = dict(phi=(-1.0, 1.0, 2.0), chunk=2048,
              to_learn=("W", "pi", "sigma", "phi"))
    model = DSC(D, H, Hp, gamma, backend="plain", **kw)
    gt = {"W": planted_dictionary(D, H, seed=0),
          "pi": np.float32([0.03, 0.03, 0.03]), "sigma": np.float32(1.0),
          "phi": np.float32([-1.0, 1.0, 2.0])}
    y = model.generate_data(gt, N, seed=5)["y"]
    p0 = {k: v.numpy() for k, v in
          model.standard_init({"y": y}, seed=3, device="cpu").items()}
    p0["phi"] = np.float32([-0.6, 1.4, 1.7])
    a = LinearAnnealing(10)
    a["T"] = 1.5
    a["Ncut_factor"] = 0.5
    reset_launches(cuda_lib)

    def step(m, d):
        return m.step_fn(params_from_numpy(p0, d),
                         make_blank_data(y, device=d), sched_floats(a),
                         torch.Generator(device=d))
    try:
        step(DSC(D, H, Hp, gamma, **kw), dev)
    except ValueError as e:
        if 'backend="plain"' not in str(e):
            raise
    else:
        raise AssertionError("learned Phi with the default backend took a "
                             "step on the card: no kernel collects its sums")
    out = {d.type: step(model, d) for d in (dev, torch.device("cpu"))}
    torch.cuda.synchronize()
    expect_launches(cuda_lib, "[dsc learned phi]")
    for k, v in out["cpu"][0].items():
        torch.testing.assert_close(out[dev.type][0][k].cpu(), v, rtol=1e-4,
                                   atol=1e-5, msg=f"learned-phi step {k}")
    torch.testing.assert_close(out[dev.type][1].cpu(), out["cpu"][1],
                               rtol=1e-4, atol=1e-4)
    phi = out[dev.type][0]["phi"].cpu().numpy()
    # the gauge: the anchor (the configured set's largest value) keeps 2.0
    if not (np.isfinite(phi).all() and abs(phi[2] - 2.0) < 1e-5):
        raise AssertionError(f"learned-phi step: phi = {phi}")
    log(f"[dsc learned phi] one step on CUDA (backend=\"plain\", no kernel "
        f"launch; the default backend refuses it) matches the CPU; phi -0.6, 1.4, 1.7 -> "
        + ", ".join(f"{v:.4f}" for v in phi))


def quantised(np, a, step):
    """``a`` rounded to multiples of ``step`` (a power of two), float32."""
    return (np.round(np.asarray(a, np.float64) / step) * step).astype(
        np.float32)


def against_cpu(torch, tag, got, ref, rtol):
    """A result on the card against the same call on the CPU: tensors (or
    dicts of them) within ``rtol``, with an absolute floor of ``rtol`` of
    each tensor's largest entry (an entry that cancels to near zero carries
    the rounding of its large terms).  Returns the largest difference."""
    if isinstance(ref, dict):
        return max(against_cpu(torch, f"{tag} {k}", got[k], v, rtol)
                   for k, v in ref.items())
    got = got.cpu()
    floor = max(ref.abs().max().item(), 1.0) * rtol
    torch.testing.assert_close(got, ref, rtol=rtol, atol=floor, msg=tag)
    return (got - ref).abs().max().item()


def gsc_path(torch, np, dev, smi, patches_anneal, N=131072):
    """Phases 15-16: GSC bars on the card, and GSC at the patches width of
    bench.py:652 (D=256, H=300, H'=6, gamma=3, 35 multi states) through
    ``run`` and ``run_scanned``, one E-step against the CPU and a decode.
    GSC is plain PyTorch: no kernel of the port may launch.  Returns the
    ``scanned`` entry and the decode's rows/s."""
    from prosper_tpu_torch import EM, LinearAnnealing
    from prosper_tpu_torch.data.bars import (bars_gt_params,
                                             count_recovered_bars,
                                             planted_dictionary)
    from prosper_tpu_torch.io.weights import params_from_numpy
    from prosper_tpu_torch.models import GSC
    from prosper_tpu_torch.models.base import sched_floats
    from prosper_tpu_torch.ops import cuda_lib

    # ---- 15. GSC bars on the card ---------------------------------------------
    # the tuned configuration of examples/barstest/param_bars_gsc.py
    R = 4
    model = GSC(R * R, 2 * R, 5, 3, chunk=1500)
    gt = bars_gt_params(model, intensity=5.0, sigma=1.0)
    gt["mu"], gt["psi"] = np.float32(1.0), np.float32(0.09)
    data = model.generate_data(gt, 1500, seed=31)
    anneal = LinearAnnealing(70)
    anneal["T"] = [(0.0, 2.0), (0.7, 1.0)]
    anneal["W_noise"] = [(0.0, 0.5), (0.7, 0.0)]
    reset_launches(cuda_lib)
    params = EM(model, anneal, {"y": data["y"]}, seed=GSC_BARS_SEED,
                device=dev).run()
    n_rec = count_recovered_bars(params["W"].cpu().numpy(), gt["W"], 0.8,
                                 signed=True)
    sig, mu, psi = (float(params[k]) for k in ("sigma", "mu", "psi"))
    log(f"[gsc bars] {n_rec}/8 bars at signed cosine > 0.8, sigma {sig:.4f}, "
        f"mu {mu:.4f}, psi {psi:.4f}")
    if n_rec != 8 or abs(sig - 1.0) >= 0.4:
        raise AssertionError("GSC bars not recovered on the card")
    expect_launches(cuda_lib, "[gsc bars]")
    stamp("phase 15")

    # ---- 16. GSC at patches width ---------------------------------------------
    D, H, Hp, gamma, iters = 256, 300, 6, 3, 6
    model = GSC(D, H, Hp, gamma, chunk=8192)
    gt = {"W": planted_dictionary(D, H, seed=0), "pi": np.float32(2.0 / H),
          "sigma": np.float32(1.0), "mu": np.float32(1.0),
          "psi": np.float32(0.25)}
    data = model.generate_data(gt, N, seed=1)
    held_out = model.generate_data(gt, 8192, seed=2)
    init = model.standard_init(data, seed=3, device=dev)
    y_dev = torch.tensor(data["y"], device=dev)
    torch.cuda.synchronize()
    tag = "[gsc patches]"
    reset_launches(cuda_lib)
    em = EM(model, patches_anneal(iters), {"y": y_dev}, params=init, seed=4,
            device=dev)
    params = em.run()
    serve = {dense: model.inference(params, held_out, top_L=10,
                                    dense_states=dense)
             for dense in (False, True)}
    torch.cuda.synchronize()
    expect_launches(cuda_lib, tag)
    check_path(torch, np, tag, em, serve, H)
    log(f"{tag} mu {float(params['mu']):.4f}, psi {float(params['psi']):.4f}"
        f", sigma {float(params['sigma']):.4f} after {iters} iterations "
        "(planted: 1, 0.25, 1)")
    scanned, _ = scanned_path(
        torch, np, cuda_lib, tag, em,
        lambda: EM(model, patches_anneal(iters), {"y": y_dev}, params=init,
                   seed=4, device=dev),
        init, 4, smi)
    stamp(f"{tag} run and run_scanned")

    # one annealed E-step on 4096 rows against the CPU; y in quarters and W
    # in 1/64ths, so P = y W and the Gram matrix are exact in float32 and
    # the candidates agree; the rest within rtol 1e-4 (the small Cholesky
    # solves and the sums round differently on the two devices)
    p_q = {k: v.cpu().numpy() for k, v in params.items()}
    p_q["W"] = quantised(np, p_q["W"], 1 / 64)
    y_q = quantised(np, data["y"][:4096], 0.25)
    w_q = (np.arange(4096) % 5 > 0).astype(np.float32)
    a = LinearAnnealing(4)
    a["T"] = 1.5
    out = {}
    for d in (dev, torch.device("cpu")):
        p = params_from_numpy(p_q, d)
        out[d.type] = model.estep_sums(p, torch.tensor(y_q, device=d),
                                       torch.tensor(w_q, device=d),
                                       sched_floats(a))
    err = max(against_cpu(torch, f"{tag} E-step F", out[dev.type][0],
                          out["cpu"][0], 1e-4),
              against_cpu(torch, f"{tag} E-step", out[dev.type][1],
                          out["cpu"][1], 1e-4))
    log(f"{tag} one annealed E-step on 4096 rows on the card agrees with the "
        f"CPU within rtol 1e-4 (largest difference {err:.3e})")

    # the decode: 8192 rows from the card, compact and dense
    y_ho = torch.tensor(held_out["y"], device=dev)
    dec = {dense: cuda_ms(torch, lambda d=dense: model.inference(
        params, {"y": y_ho}, top_L=10, dense_states=d), 3)
        for dense in (False, True)}
    expect_launches(cuda_lib, tag)
    log(f"{tag} decode of 8192 rows: compact {dec[False]:.3f} ms = "
        f"{8192 / dec[False] * 1e3:.0f} rows/s, dense {dec[True]:.3f} ms = "
        f"{8192 / dec[True] * 1e3:.0f} rows/s  [{smi}]")
    return scanned, {"compact_ms": dec[False], "dense_ms": dec[True],
                     "rows_per_s": 8192 / dec[False] * 1e3}


def mixture_path(torch, np, dev, smi, patches_anneal, N=131072):
    """Phase 17: MoG and MoP at the clustering width of bench.py:714-727
    (D=256, K=300; MoP's data is abs(floor(3y))): 131072 rows through
    ``run`` and ``run_scanned``, an inference of 8192 rows, one step against
    the CPU.  Plain PyTorch: no kernel of the port may launch.  Returns the
    ``scanned`` entries."""
    from prosper_tpu_torch import EM, LinearAnnealing
    from prosper_tpu_torch.io.weights import params_from_numpy
    from prosper_tpu_torch.models.base import make_blank_data, sched_floats
    from prosper_tpu_torch.models.mixtures import MoG, MoP
    from prosper_tpu_torch.ops import cuda_lib

    D, K, iters = 256, 300, 6
    scanned = {}
    for name, cls in (("mog", MoG), ("mop", MoP)):
        tag = f"[{name}]"
        model = cls(D, K)
        y = np.random.default_rng(5).standard_normal((N, D)).astype(
            np.float32)
        if cls is MoP:
            y = np.abs(np.floor(3.0 * y))                       # counts
        init = model.standard_init({"y": y}, seed=6, device=dev)
        y_dev = torch.tensor(y, device=dev)
        torch.cuda.synchronize()
        reset_launches(cuda_lib)
        em = EM(model, patches_anneal(iters), {"y": y_dev}, params=init,
                seed=4, device=dev)
        params = em.run()
        out = model.inference(params, {"y": y_dev[:8192]})
        torch.cuda.synchronize()
        expect_launches(cuda_lib, tag)
        Q = [h["Q_mean"] for h in em.history]
        log(f"{tag} Q_mean by iteration: " + " ".join(f"{q:.3f}" for q in Q))
        if not (np.isfinite(Q).all() and Q[-1] > Q[0]):
            raise AssertionError(f"{tag} Q_mean is not finite or did not rise")
        if not (all(torch.isfinite(v).all() for v in params.values())
                and torch.isfinite(out["F"]).all()
                and torch.allclose(out["resp"].sum(1),
                                   torch.ones(8192, device=dev), atol=1e-5)
                and out["assign"].shape == (8192,)
                and int(out["assign"].max()) < K):
            raise AssertionError(f"{tag} non-finite parameters or a bad "
                                 "inference")
        scanned[name], _ = scanned_path(
            torch, np, cuda_lib, tag, em,
            lambda: EM(model, patches_anneal(iters), {"y": y_dev},
                       params=init, seed=4, device=dev),
            init, 4, smi)
        # one annealed step on 4096 rows against the CPU: F within rtol
        # 1e-5, the new parameters within rtol 1e-4 of each one's largest
        # entry (the responsibilities are near one-hot at D=256, so a
        # component that holds a small fraction of a row gets its mean from
        # ratios of tiny sums, which round differently on the two devices)
        a = LinearAnnealing(4)
        a["T"] = 1.5
        p0 = {k: v.cpu().numpy() for k, v in init.items()}
        step = {d.type: model.step_fn(params_from_numpy(p0, d),
                                      make_blank_data(y[:4096], device=d),
                                      sched_floats(a),
                                      torch.Generator(device=d))
                for d in (dev, torch.device("cpu"))}
        err = max(against_cpu(torch, f"{tag} step", step[dev.type][0],
                              step["cpu"][0], 1e-4),
                  against_cpu(torch, f"{tag} step F", step[dev.type][1],
                              step["cpu"][1], 1e-5))
        log(f"{tag} one annealed step on 4096 rows on the card agrees with "
            f"the CPU (F within rtol 1e-5, the parameters within 1e-4; "
            f"largest difference {err:.3e}); "
            f"{N} rows, {iters} iterations, inference of 8192 rows, no kernel "
            "launch")
    return scanned


def read_logs(np, out_dir):
    """result.h5 (every channel but dt) and metrics.jsonl (each row but dt)
    of an output directory."""
    import os

    from prosper_tpu_torch.io import hdf5
    with hdf5.File(os.path.join(out_dir, "result.h5")) as f:
        h5 = {k: np.asarray(f[k]) for k in f if k != "dt"}
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [{k: v for k, v in json.loads(line).items() if k != "dt"}
                for line in f]
    return h5, rows


def same_logs(np, tag, a, b, rows):
    """Two output directories hold the same logs, of ``rows`` iterations."""
    (ha, ja), (hb, jb) = read_logs(np, a), read_logs(np, b)
    if set(ha) != set(hb) or len(ja) != rows or ja != jb:
        raise AssertionError(f"{tag}: the logs of {a} and {b} differ "
                             f"({len(ja)} and {len(jb)} rows)")
    for k in ha:
        if not np.array_equal(ha[k], hb[k]):
            raise AssertionError(f"{tag}: {k} differs between the logs")
        if ha[k].shape[0] != rows:
            raise AssertionError(f"{tag}: {k} holds {ha[k].shape[0]} rows")


def expect_step_launches(cuda_lib, tag, em, scanned, iters):
    """An E-step counts once per iteration: through ``run`` each iteration
    passes the launch sites of the E-step and its two GEMMs; through
    ``run_scanned`` the eager first steps and the captures pass them and
    the replays hold the rest."""
    if not scanned:
        return expect_launches(cuda_lib, tag, estep=iters, sgemm_nn=iters,
                               sgemm_tn=iters)
    st = em.scan_stats
    sited = st["eager_steps"] + st["graphs"]
    got = expect_launches(cuda_lib, tag, estep=sited, sgemm_nn=sited,
                          sgemm_tn=sited)
    want = {k: st["replays"] for k in ("estep", "sgemm_nn", "sgemm_tn")}
    if (st["eager_steps"] + st["replays"] != iters
            or st["replayed_launches"] != want):
        raise AssertionError(f"{tag}: {st} for {iters} iterations")
    return got


def io_path(torch, np, dev, smi, model, y_dev, init, patches_anneal):
    """Phase 18: BSC patches (the main path's model, rows and init) with a
    data log (result.h5 and metrics.jsonl) and checkpoints every 3
    iterations, through ``run`` and through ``run_scanned`` (with
    ``collect_params``): a run killed after 4 iterations and resumed from
    its step-3 checkpoint into a fresh EM with another seed ends
    bit-identical to the uninterrupted run (parameters, F_prev, scalars,
    the generator's next draw), its logs rewound by ``_truncate_logs`` and
    continued hold the uninterrupted run's 6 rows, and the two loops'
    logs are equal.  Then host ms per iteration through ``run`` without the
    log and with it at ``log_params_every`` 1 and 10, and the cost of a
    checkpoint.  Returns the numbers."""
    import os
    import tempfile

    from prosper_tpu_torch import EM
    from prosper_tpu_torch.cli import _truncate_logs
    from prosper_tpu_torch.io.datalog import DataLog, StoreToH5, StoreToJSONL
    from prosper_tpu_torch.ops import cuda_lib

    iters = 6
    out = {}

    def open_log(out_dir, mode="w"):
        """The command line's data log: result.h5 and metrics.jsonl."""
        os.makedirs(out_dir, exist_ok=True)
        dlog = DataLog()
        dlog.set_handler(None, StoreToH5, os.path.join(out_dir, "result.h5"),
                         mode)
        dlog.set_handler(None, StoreToJSONL,
                         os.path.join(out_dir, "metrics.jsonl"), mode)
        return dlog

    def logged(out_dir, **kw):
        return EM(model, patches_anneal(iters), {"y": y_dev}, params=init,
                  seed=4, device=dev, dlog=open_log(out_dir), **kw)

    with tempfile.TemporaryDirectory() as tmp:
        for loop in ("run", "run_scanned"):
            tag = f"[io {loop}]"
            scanned = loop == "run_scanned"

            def go(em, n=None):
                if scanned:
                    em.run_scanned(n, collect_params=True)
                elif n is None:
                    em.run()
                else:
                    for _ in range(n):
                        em.step_once()
                torch.cuda.synchronize()
                em.dlog.close()

            ref_dir, cut_dir = (os.path.join(tmp, loop, d)
                                for d in ("ref", "cut"))
            ckpt = os.path.join(cut_dir, "checkpoint.h5")
            reset_launches(cuda_lib)
            ref = logged(ref_dir)
            go(ref)
            launches = expect_step_launches(cuda_lib, tag, ref, scanned,
                                            iters)
            cut = logged(cut_dir, checkpoint_path=ckpt, checkpoint_every=3)
            go(cut, 4)                     # killed after 4: checkpoint at 3
            res = EM(model, patches_anneal(iters), {"y": y_dev}, params=init,
                     seed=99, device=dev, checkpoint_path=ckpt,
                     checkpoint_every=3)
            if res.resume(ckpt) != 3:
                raise AssertionError(f"{tag}: the checkpoint is not at 3")
            _truncate_logs(cut_dir, 3, 1)
            res.dlog = open_log(cut_dir, "a")
            go(res)
            same_run(torch, f"{tag} resumed at 3", ref, res, first=3)
            same_logs(np, tag, ref_dir, cut_dir, iters)
            log(f"{tag} killed after 4 iterations, resumed from the step-3 "
                f"checkpoint into a fresh EM (seed 99): bit-identical to the "
                f"uninterrupted run (parameters, F_prev, scalars, the "
                f"generator's next draw); the logs rewound and continued "
                f"hold its {iters} rows; launch sites {launches}")
        same_logs(np, "[io] run_scanned(collect_params=True) against run",
                  os.path.join(tmp, "run", "ref"),
                  os.path.join(tmp, "run_scanned", "ref"), iters)

        # host ms per iteration without the log and with it: the wall time
        # of run (history's dt ends before the log is written)
        times = {"none": [], 1: [], 10: []}
        for every in ("none", 1, 10, "none"):
            if every == "none":
                em = EM(model, patches_anneal(iters), {"y": y_dev},
                        params=init, seed=4, device=dev)
            else:
                em = logged(os.path.join(tmp, f"every{every}"),
                            log_params_every=every)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            em.run()
            torch.cuda.synchronize()
            times[every].append((time.perf_counter() - t0) / iters * 1e3)
            if em.dlog is not None:
                em.dlog.close()
        out["run_ms_no_dlog"] = float(np.mean(times["none"]))
        out["run_ms_dlog_every_1"] = times[1][0]
        out["run_ms_dlog_every_10"] = times[10][0]
        t0 = time.perf_counter()
        for i in range(3):
            ref.save_checkpoint(os.path.join(tmp, f"c{i}.h5"))
        out["checkpoint_ms_131072"] = (time.perf_counter() - t0) / 3 * 1e3
    log(f"[io] wall ms per iteration of run (N={y_dev.shape[0]}): "
        f"{out['run_ms_no_dlog']:.3f} without a data log, "
        f"{out['run_ms_dlog_every_1']:.3f} with one at log_params_every=1 "
        f"(W read and written every iteration), "
        f"{out['run_ms_dlog_every_10']:.3f} at 10; a checkpoint "
        f"{out['checkpoint_ms_131072']:.1f} ms  [{smi}]")
    return out


def cli_path(torch, np, dev, smi, N=131072):
    """Phase 19: the command line in this process on a JSON config at the
    patches width (BSC D=256, H=300, H'=8, gamma=4 on N=131072 planted-
    dictionary rows, 6 iterations, checkpoints every 3): ``generate``;
    ``train --scan``; ``train`` killed after 4 iterations and ``train
    --resume``, which ends bit-identical to the ``--scan`` run; ``infer``
    (one decode); ``diagnose --json``; one ``python -m
    prosper_tpu_torch.cli train`` in a subprocess (bit-identical again); a
    ``traced_region`` around one step in a profiler trace beside
    ``rows_kernel``.  Returns the numbers."""
    import contextlib
    import io
    import os
    import tempfile

    from prosper_tpu_torch import EM, cli
    from prosper_tpu_torch.data.bars import planted_dictionary
    from prosper_tpu_torch.io import hdf5
    from prosper_tpu_torch.io.tracing import profile_trace, traced_region
    from prosper_tpu_torch.ops import cuda_lib

    iters = 6
    on = ["--device", str(dev)]
    cfg = {"model": {"type": "bsc", "D": 256, "H": 300, "Hprime": 8,
                     "gamma": 4, "chunk": 8192},
           "anneal": {"steps": iters, "T": [[0.0, 2.0], [0.6, 1.0]],
                      "W_noise": [[0.0, 0.5], [0.6, 0.0]],
                      "Ncut_factor": [[0.4, 0.0], [1.0, 1.0]]},
           "gt_params": {"W": planted_dictionary(256, 300, seed=0).tolist(),
                         "pi": 2.0 / 300, "sigma": 1.0},
           "seed": 4, "checkpoint_every": 3}
    out = {}

    def final(run_dir):
        with hdf5.File(os.path.join(run_dir, "checkpoint.h5")) as f:
            return ({k: np.asarray(v) for k, v in f["params"].items()},
                    np.asarray(f["torch_rng"]), int(f.attrs["step"]))

    def same_end(tag, a, b):
        pa, ra, sa = final(a)
        pb, rb, sb = final(b)
        if (sa, sb) != (iters, iters) or not np.array_equal(ra, rb) or any(
                not np.array_equal(pa[k], pb[k]) for k in pa):
            raise AssertionError(f"{tag}: the final checkpoints of {a} and "
                                 f"{b} differ")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cfg.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        data = os.path.join(tmp, "d.h5")
        run = {k: os.path.join(tmp, k) for k in ("scan", "resumed", "proc")}
        t0 = time.perf_counter()
        cli.main(["generate", path, "-N", str(N), "--seed", "1", "-o", data])
        reset_launches(cuda_lib)
        t1 = time.perf_counter()
        cli.main(["train", path, "--data", data, "-o", run["scan"], "-q",
                  "--scan"] + on)
        torch.cuda.synchronize()
        out["train_scan_s"] = time.perf_counter() - t1
        launches = dict(cuda_lib.LAUNCHES)
        if not (launches["estep"] >= 1 and launches["sgemm_nn"]
                == launches["sgemm_tn"] == launches["estep"]):
            raise AssertionError(f"[cli] train --scan launches {launches}")

        calls = []
        real_step = EM.step_once

        def killed_after_4(self, *a, **k):
            if len(calls) == 4:
                raise KeyboardInterrupt("killed")
            calls.append(1)
            return real_step(self, *a, **k)
        EM.step_once = killed_after_4
        try:
            cli.main(["train", path, "--data", data, "-o", run["resumed"],
                      "-q"] + on)
            raise AssertionError("[cli] the killed run was not killed")
        except KeyboardInterrupt:
            pass
        finally:
            EM.step_once = real_step
        reset_launches(cuda_lib)
        cli.main(["train", path, "--data", data, "-o", run["resumed"], "-q",
                  "--resume"] + on)
        torch.cuda.synchronize()
        resumed = expect_launches(cuda_lib, "[cli] train --resume", estep=3,
                                  sgemm_nn=3, sgemm_tn=3)
        same_end("[cli] train --resume against train --scan", run["scan"],
                 run["resumed"])
        same_logs(np, "[cli] train --resume against train --scan",
                  run["scan"], run["resumed"], iters)

        reset_launches(cuda_lib)
        inf = os.path.join(tmp, "inference.h5")
        cli.main(["infer", path, "-c",
                  os.path.join(run["scan"], "checkpoint.h5"), "--data", data,
                  "-o", inf] + on)
        torch.cuda.synchronize()
        inferred = expect_launches(cuda_lib, "[cli] infer", decode=1,
                                   sgemm_nn=1)
        with hdf5.File(inf) as f:
            if not (f["F"].shape == (N,) and np.isfinite(f["F"][...]).all()
                    and f["s_mean"].shape == (N, 300)):
                raise AssertionError("[cli] infer wrote bad outputs")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["diagnose", "-c",
                      os.path.join(run["scan"], "checkpoint.h5"), "--gt",
                      path, "--json"])
        report = json.loads(buf.getvalue())
        out["diagnose"] = {k: report[k] for k in ("recovered", "total")}

        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "prosper_tpu_torch.cli", "train", path,
             "--data", data, "-o", run["proc"], "-q"] + on,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        out["subprocess_train_s"] = time.perf_counter() - t1
        if proc.returncode != 0:
            raise AssertionError(f"[cli] python -m prosper_tpu_torch.cli "
                                 f"train failed:\n{proc.stderr[-2000:]}")
        same_end("[cli] python -m prosper_tpu_torch.cli train", run["scan"],
                 run["proc"])

        c = cli.load_config(path)
        with hdf5.File(data) as f:
            y = np.asarray(f["patches"])
        em = EM(c["model"], c["anneal"], {"y": y}, seed=4, device=dev)
        em.step_once()
        with profile_trace(os.path.join(tmp, "prof")) as prof:
            with traced_region("em step"):
                em.step_once()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        cuda_names = [e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        if "em step" not in names or not any("rows_kernel" in n
                                             for n in cuda_names):
            raise AssertionError("[cli] the traced region or rows_kernel is "
                                 "missing from the profiler trace")
        if not os.path.exists(os.path.join(tmp, "prof", "trace.0.json")):
            raise AssertionError("[cli] profile_trace wrote no trace")
        out["seconds"] = time.perf_counter() - t0
    log(f"[cli] generate, train --scan (launch sites {launches}), train "
        f"killed after 4 iterations + train --resume (launches {resumed}; "
        f"bit-identical to --scan), infer (launches {inferred}), diagnose "
        f"--json ({out['diagnose']}), python -m prosper_tpu_torch.cli train "
        f"in a subprocess ({out['subprocess_train_s']:.1f} s, bit-identical "
        f"to --scan), a traced_region beside rows_kernel in the profiler "
        f"trace; train --scan took {out['train_scan_s']:.1f} s  [{smi}]")
    return out


def recovery_path(torch, np, dev, smi):
    """Phase 20: seed 0 of prosper_tpu_torch/examples/patches_scale_run.py
    at its defaults (BSC D=256, H=300, H'=8, gamma=4 on N = 10^6 planted-
    dictionary rows: 120 iterations with revival, worst-F re-seeding and
    co-activation splits, 40 of the gamma=5 refinement, the blend-split
    sweeps and their polish, all through ``run_scanned``).  Fails below
    295/300.  Times each revival that fired and a checkpoint at this size.
    Returns the numbers."""
    import os
    import tempfile

    from prosper_tpu_torch.engine.em import EM
    from prosper_tpu_torch.examples.patches_scale_run import run_protocol
    from prosper_tpu_torch.ops import cuda_lib

    fired = []
    real = EM._maybe_revive_duplicates

    def timed(self):
        last = self._last_revive
        t0 = time.perf_counter()
        real(self)
        if self._last_revive != last:
            fired.append((time.perf_counter() - t0) * 1e3)
    reset_launches(cuda_lib)
    EM._maybe_revive_duplicates = timed
    try:
        r = run_protocol(0, device=dev, log=log)
    finally:
        EM._maybe_revive_duplicates = real
    if not fired:
        raise AssertionError("[recovery] no revival fired")
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    # at N = 10^6 an E-step cuts its rows into chunks whose (rows, H)
    # workspace fits, each chunk one sgemm_nn and one sgemm_tn
    chunks = len(cuda_lib.row_chunks(r["em"].data["y"].shape[0], 300))
    if not (launches["estep"] >= 1 and launches["decode"] == 0
            and launches["sgemm_nn"] == launches["sgemm_tn"]
            == chunks * launches["estep"]):
        raise AssertionError(f"[recovery] launches {launches} for E-steps "
                             f"of {chunks} row chunks")
    em = r.pop("em")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for i in range(3):
            em.save_checkpoint(os.path.join(tmp, f"c{i}.h5"))
        ckpt_ms = (time.perf_counter() - t0) / 3 * 1e3
    del em
    graphs = [s["graphs"] for s in r["scan_stats"]]
    replays = [s["replays"] for s in r["scan_stats"]]
    eager = [s["eager_steps"] for s in r["scan_stats"]]
    log(f"[recovery] seed 0, N=10^6: recovered {r['recovered']}/{r['of']} "
        f"(stages {r['stages']}); revival {r['revival_stats']}; "
        f"{r['ms_per_iter']:.3f} ms an iteration (first stage, "
        f"run_scanned), {r['wall_s']:.1f} s wall (+{r['gen_s']:.1f} s data); "
        f"scan_stats per stage: graphs {graphs}, replays {replays}, eager "
        f"steps {eager}; {len(fired)} revivals, "
        f"{np.mean(fired):.1f} ms each (max {max(fired):.1f}); a checkpoint "
        f"{ckpt_ms:.1f} ms; launch sites {launches}; missed "
        f"{r['missed_classes'] or 'none'}  [{smi}]")
    if r["recovered"] < 295:
        raise AssertionError(f"[recovery] {r['recovered']}/300 < 295")
    return {"recovered": r["recovered"], "of": r["of"],
            "stages": r["stages"], "revival_stats": r["revival_stats"],
            "ms_per_iter": r["ms_per_iter"], "wall_s": r["wall_s"],
            "data_s": r["gen_s"], "graphs": graphs, "replays": replays,
            "eager_steps": eager, "revival_ms": fired,
            "checkpoint_ms_1e6": ckpt_ms, "missed": r["missed_classes"],
            "launches": launches}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from prosper_tpu_torch import EM, LinearAnnealing
    from prosper_tpu_torch.core import etstep
    from prosper_tpu_torch.core.states import discrete_state_space
    from prosper_tpu_torch.data.bars import (bars_gt_params,
                                             count_recovered_bars,
                                             planted_dictionary)
    from prosper_tpu_torch.models import BSC
    from prosper_tpu_torch.ops import cuda_lib, linear_cuda

    dev = torch.device("cuda")
    # ---- 1. environment ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch.backends.cuda.matmul.allow_tf32 = False "
        "(float32 matmuls in full float32)")

    # ---- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_lib.load_library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    func = None
    for line in cuda_lib.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            log("[build]", func, line.strip())
    lib = cuda_lib.load_library()
    for name, smem in (
            ("linear E-step rows kernel (H=300, H'=8, S=154, K=1)",
             lib.linear_et_rows_smem_bytes(300, 8, 154, 1)),
            ("linear decode kernel (H=300, H'=8, S=154, K=1)",
             lib.linear_et_decode_smem_bytes(300, 8, 154, 1)),
            ("max E-step kernel (D=256, H=300, H'=6, S=35)",
             lib.max_et_smem_bytes(256, 300, 6, 35)),
            (f"big-S kernel (H'=10, K=2: 65 logit and 69 moment columns, "
             f"{lib.bigs_multi_warps(65, 69)} warps a block)",
             lib.bigs_multi_smem_bytes(65, 69)),
            ("sgemm_nn kernel", lib.sgemm_smem_bytes(0)),
            ("sgemm_tn_splitn kernel", lib.sgemm_smem_bytes(1))):
        log(f"[build] {name}: {smem} bytes of shared memory a block, "
            f"{cuda_lib.blocks_per_sm(smem)} blocks an SM")

    # ---- 3./4. kernels against their plain versions ---------------------------
    # inputs quantised to multiples of 1/4: P = y W and the Gram matrix are
    # then exact in float32 in any summation order, so candidates and top-L
    # identities must agree exactly
    shapes = [  # (name, N, D, H, Hp, gamma, values, signed)
        ("bsc_bars", 1000, 25, 10, 6, 3, (1.0,), False),
        ("tsc_bars", 1000, 25, 10, 6, 3, (-1.0, 1.0), True),
        ("dsc_bars", 1000, 25, 16, 6, 3, (-1.0, 1.0, 2.0), True),
        ("bsc_patches", 16384, 256, 300, 8, 4, (1.0,), False),
    ]
    err = {"estep": 0.0, "decode": 0.0, "max_estep": 0.0, "bigs": 0.0,
           "sgemm_nn": 0.0, "sgemm_tn": 0.0}
    gm = gemm_phase(torch, np, dev, smi, err)
    rng = np.random.default_rng(0)
    for name, N, D, H, Hp, gamma, values, signed in shapes:
        if D == 256:
            W_np = planted_dictionary(D, H, seed=1) / 8.0
            s = rng.random((N, H)) < 2.0 / H
            y_np = s @ W_np.T + rng.standard_normal((N, D))
        else:
            W_np = rng.standard_normal((D, H)) * 2
            y_np = rng.standard_normal((N, D)) * 3
        y = torch.tensor(np.round(y_np * 4) / 4, dtype=torch.float32,
                         device=dev)
        W = torch.tensor(np.round(W_np * 4) / 4, dtype=torch.float32,
                         device=dev)
        w = torch.tensor(rng.random(N) > 0.2, dtype=torch.float32, device=dev)
        w[:40] = 0.0
        K = len(values)
        lo = torch.full((K,), float(np.log(2.0 / (H * K)) - np.log1p(-2.0 / H)),
                        device=dev)
        sa = etstep.state_arrays_from(discrete_state_space(Hp, gamma, values),
                                      dev)
        sigma2 = torch.tensor(2.0, device=dev)
        for beta in (0.6, 1.0):
            args = (y, w, W, sigma2, lo, sa, Hp, signed, beta, 1.0)
            F0, ref = etstep.linear_et_estep(*args, chunk=N)
            F1, on = linear_cuda.linear_et_estep_cuda(*args, collect_true=True)
            _, off = linear_cuda.linear_et_estep_cuda(*args,
                                                      collect_true=False)
            torch.cuda.synchronize()
            torch.testing.assert_close(F1, F0, rtol=1e-4, atol=1e-4)
            err["estep"] = max(err["estep"], (F1 - F0).abs().max().item())
            for k in ref:
                torch.testing.assert_close(on[k], ref[k], rtol=1e-3,
                                           atol=1e-3, msg=f"{name} {k}")
                err["estep"] = max(err["estep"],
                                   (on[k] - ref[k]).abs().max().item())
                if beta == 1.0 and k != "F_true" and not torch.equal(
                        on[k], off[k]):
                    raise AssertionError(f"{name}: {k} differs with "
                                         "collect_true off at beta=1")
            dargs = (y, W, sigma2, lo, sa, Hp, signed, 10, beta, 0.8)
            ref_d = etstep.linear_et_decode(*dargs)
            out_d = linear_cuda.linear_et_decode_cuda(*dargs)
            again_d = linear_cuda.linear_et_decode_cuda(*dargs)
            torch.cuda.synchronize()
            for a, b in zip(out_d, again_d):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name}: two decode calls differ")
            for i, field in enumerate(("F", "s_mean", "top_q")):
                torch.testing.assert_close(out_d[i], ref_d[i], rtol=1e-4,
                                           atol=1e-5, msg=f"{name} {field}")
                err["decode"] = max(err["decode"], (out_d[i] - ref_d[i])
                                    .abs().max().item())
            for i, field in ((3, "top_u"), (4, "cand")):
                if not torch.equal(out_d[i], ref_d[i]):
                    bad = (out_d[i] != ref_d[i]).any(dim=1).sum().item()
                    raise AssertionError(f"{name}: {field} differs in {bad} "
                                         "rows")
        log(f"[kernels] {name}: E-step and decode agree with the plain "
            "versions (beta 0.6 and 1; collect_true on/off and repeated "
            "decodes bit-identical)")

    # ---- 5. bars on the card -------------------------------------------------
    model = BSC(25, 10, 6, 3)
    gt = bars_gt_params(model, intensity=10.0, sigma=2.0)
    data = model.generate_data(gt, 1000, seed=11)
    anneal = LinearAnnealing(60)
    anneal["T"] = [(0.0, 2.0), (0.7, 1.0)]
    anneal["Ncut_factor"] = [(0.0, 0.0), (0.5, 0.0), (0.9, 1.0)]
    anneal["W_noise"] = [(0.0, 1.0), (0.7, 0.0)]
    reset_launches(cuda_lib)
    em = EM(model, anneal, {"y": data["y"]}, seed=BARS_SEED, device=dev)
    params = em.run()
    n_rec = count_recovered_bars(params["W"].cpu().numpy(), gt["W"], 0.85)
    sig, pi = float(params["sigma"]), float(params["pi"])
    log(f"[bars] {n_rec}/10 bars, sigma {sig:.4f}, pi {pi:.4f}, "
        f"E-step launches {linear_cuda.LAUNCHES['estep']}")
    if n_rec != 10 or abs(sig - 2.0) >= 0.3 or abs(pi - 0.2) >= 0.08:
        raise AssertionError("bars not recovered on the card")
    expect_launches(cuda_lib, "[bars]", estep=60, sgemm_nn=60, sgemm_tn=60)

    # ---- 6. main path at patches width ----------------------------------------
    D, H, Hp, gamma, N, iters = 256, 300, 8, 4, 131072, 6
    model = BSC(D, H, Hp, gamma, chunk=8192)
    gt = {"W": planted_dictionary(D, H, seed=0), "pi": np.float32(2.0 / H),
          "sigma": np.float32(1.0)}
    t0 = time.perf_counter()
    data = model.generate_data(gt, N, seed=1)
    held_out = model.generate_data(gt, 8192, seed=2)
    init = model.standard_init(data, seed=3, device=dev)
    log(f"[patches] generated {N} + 8192 rows in "
        f"{time.perf_counter() - t0:.1f} s")

    def patches_anneal(iters=iters):
        a = LinearAnnealing(iters)
        a["T"] = [(0.0, 2.0), (0.6, 1.0)]
        a["W_noise"] = [(0.0, 0.5), (0.6, 0.0)]
        a["Ncut_factor"] = [(0.4, 0.0), (1.0, 1.0)]
        return a

    y_dev = torch.tensor(data["y"], device=dev)
    torch.cuda.synchronize()
    reset_launches(cuda_lib)
    em = EM(model, patches_anneal(), {"y": y_dev}, params=init, seed=4,
            device=dev)
    params = em.run()
    serve = {dense: model.inference(params, held_out, top_L=10,
                                    dense_states=dense)
             for dense in (False, True)}
    torch.cuda.synchronize()
    launches = expect_launches(cuda_lib, "[patches]", estep=iters, decode=2,
                               sgemm_nn=iters + 2, sgemm_tn=iters)
    log(f"[patches] launches on the main path: {launches}")
    check_path(torch, np, "[patches]", em, serve, H)

    # timing: kernel path against the plain version on the card
    em_ms = float(np.median([h["dt"] for h in em.history[1:]])) * 1e3
    sa = model.state_arrays(dev)

    # this slice's path: the same run through run_scanned (CUDA graphs)
    scanned = {}
    scanned["bsc_patches"], scanned_launches = scanned_path(
        torch, np, cuda_lib, "[patches]", em,
        lambda: EM(model, patches_anneal(), {"y": y_dev}, params=init,
                   seed=4, device=dev),
        init, 4, smi, estep=iters, sgemm_nn=iters, sgemm_tn=iters)

    reset_launches(cuda_lib)
    em_p = EM(BSC(D, H, Hp, gamma, chunk=8192, backend="plain"),
              patches_anneal(), {"y": y_dev}, params=init, seed=4, device=dev)
    em_p.run()
    expect_launches(cuda_lib, "[patches] backend=plain")
    em_plain_ms = float(np.median([h["dt"] for h in em_p.history[1:]])) * 1e3
    log(f"[patches] EM iteration (N={N}): kernel path {em_ms:.3f} ms, "
        f"plain version {em_plain_ms:.3f} ms  [{smi}]")

    W, sig2, lo_ = params["W"], params["sigma"] ** 2, model.log_odds(params)
    y_all = em.data["y"]
    weight = em.data["valid"]
    est = interleaved_ms(
        torch,
        lambda: etstep.linear_et_estep(y_all, weight, W, sig2, lo_, sa, Hp,
                                       False, 1.0, 1.0, chunk=8192),
        lambda: linear_cuda.linear_et_estep_cuda(y_all, weight, W, sig2, lo_,
                                                 sa, Hp, False, 1.0, 1.0),
        reps=3)
    y_ho = torch.tensor(held_out["y"], device=dev)
    dec = interleaved_ms(
        torch,
        lambda: etstep.linear_et_decode(y_ho, W, sig2, lo_, sa, Hp, False,
                                        10, 1.0, 1.0),
        lambda: linear_cuda.linear_et_decode_cuda(y_ho, W, sig2, lo_, sa, Hp,
                                                  False, 10, 1.0, 1.0),
        reps=5)
    log(f"[patches] E-step kernel {est[0]:.3f} ms vs plain {est[1]:.3f} ms "
        f"(N={N}); decode kernel {dec[0]:.3f} ms vs plain {dec[1]:.3f} ms "
        f"(N=8192) = {8192 / dec[0] * 1e3:.0f} vs {8192 / dec[1] * 1e3:.0f} "
        f"rows/s  [{smi}]")

    stamp("phases 1-6")
    # ---- 7.-10. the max family -----------------------------------------------
    mx = max_family(torch, np, dev, smi, err, patches_anneal)

    stamp("phases 7-10")
    # ---- 11.-13. the big-S linear E-step ------------------------------------
    bg = bigs_path(torch, np, dev, smi, err, patches_anneal)

    stamp("phases 11-13")
    # ---- 14. one DSC step with a learned value set, against the CPU ----------
    learned_phi_step(torch, np, dev, cuda_lib)
    stamp("phase 14")

    # ---- 15.-17. GSC and the mixtures (plain PyTorch, no kernel) --------------
    scanned["gsc_patches"], gsc_decode = gsc_path(torch, np, dev, smi,
                                                  patches_anneal)
    stamp("phases 15-16")
    scanned.update(mixture_path(torch, np, dev, smi, patches_anneal))
    stamp("phase 17")

    # ---- 18.-20. logs and resume, the command line, the recovery protocol ---
    seconds = {}
    t0 = time.perf_counter()
    recovery = io_path(torch, np, dev, smi, model, y_dev, init,
                       patches_anneal)
    seconds["18"] = time.perf_counter() - t0
    stamp("phase 18")
    t0 = time.perf_counter()
    recovery["cli"] = cli_path(torch, np, dev, smi)
    seconds["19"] = time.perf_counter() - t0
    stamp("phase 19")
    t0 = time.perf_counter()
    recovery.update(recovery_path(torch, np, dev, smi))
    seconds["20"] = time.perf_counter() - t0
    stamp("phase 20")

    # the bounds, from this run's shapes: the two D x H products, the
    # logits over [proj | Gram] and the moments over the state tables per
    # (row, state); each input read once, each output written once
    S, K = sa.value_counts.shape
    NX = Hp + Hp * Hp
    est_bound = bound(4.0 * N * D * H + 2.0 * N * S * (2 * NX + K + 1),
                      4.0 * (N * D + 2 * N + 2 * D * H + H * H))
    Nd, L = y_ho.shape[0], 10
    dec_bound = bound(2.0 * Nd * D * H + 2.0 * Nd * S * (NX + Hp),
                      4.0 * (Nd * D + D * H + Nd * (1 + H + 2 * L + Hp)))
    mxl, bgl = mx.pop("launches"), bg.pop("launches")
    scanned["mca_patches"], scanned["tsc_bigs"] = (mx.pop("scanned"),
                                                   bg.pop("scanned"))
    mxs, bgs = mx.pop("scanned_launches"), bg.pop("scanned_launches")

    def gemm_launches(name):
        return launches[name] + mxl[name]

    def scanned_gemm_launches(name):
        return scanned_launches[name] + mxs[name]

    kernels = [
        {"name": "linear_et_estep", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/linear_et_estep.cu",
         "replaces": "prosper_tpu/ops/linear_pallas.py:244",
         "launches": launches["estep"],
         "scanned_launches": scanned_launches["estep"],
         "max_abs_err": err["estep"], "ms": est[0], "plain_ms": est[1], **est_bound, "library_ms": None},
        {"name": "linear_et_decode", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/linear_et_decode.cu",
         "replaces": "prosper_tpu/ops/linear_pallas.py:435",
         "launches": launches["decode"], "scanned_launches": 0,
         "max_abs_err": err["decode"],
         "ms": dec[0], "plain_ms": dec[1], **dec_bound, "library_ms": None},
        {"name": "max_et_estep", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/max_et_estep.cu",
         "replaces": "prosper_tpu/ops/max_pallas.py:559; "
                     "prosper_tpu/ops/max_pallas.py:433",
         "launches": mxl["max_estep"], "scanned_launches": mxs["max_estep"],
         "max_abs_err": err["max_estep"],
         **mx, "library_ms": None},
        {"name": "bigs_multi", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/bigs_multi.cu",
         "replaces": "prosper_tpu/ops/bigs_pallas.py:155",
         "launches": bgl["bigs"], "scanned_launches": bgs["bigs"],
         "max_abs_err": err["bigs"], **bg,
         "library_ms": None},
        # the two products inside the bodies of the TPU kernels; one launch
        # per E-step of the linear and of the MCA patches path, and
        # sgemm_nn once more per decode
        {"name": "sgemm_nn", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/sgemm.cu",
         "replaces": "prosper_tpu/ops/linear_pallas.py:63; "
                     "prosper_tpu/ops/max_pallas.py:65",
         "launches": gemm_launches("sgemm_nn"),
         "scanned_launches": scanned_gemm_launches("sgemm_nn"),
         "max_abs_err": err["sgemm_nn"], **gm["sgemm_nn"]},
        {"name": "sgemm_tn_splitn", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/sgemm.cu",
         "replaces": "prosper_tpu/ops/linear_pallas.py:179; "
                     "prosper_tpu/ops/max_pallas.py:169",
         "launches": gemm_launches("sgemm_tn"),
         "scanned_launches": scanned_gemm_launches("sgemm_tn"),
         "max_abs_err": err["sgemm_tn"], **gm["sgemm_tn"]},
    ]
    for k in kernels:
        log(f"[kernels] {k['name']}: {k['ms']:.3f} ms, bound "
            f"{k['bound_ms']:.3f} ms by {k['bound_by']} "
            f"({100 * k['bound_ms'] / k['ms']:.1f} % of it), "
            f"{k['launches']} launches through run, "
            f"{k['scanned_launches']} through run_scanned's eager steps and "
            f"captures  [{smi}]")
        if k["name"] != "linear_et_decode" and k["scanned_launches"] < 1:
            raise AssertionError(f"{k['name']} was launched no time through "
                                 "run_scanned")
    log(json.dumps({"scanned": dict(scanned, card=smi),
                    "gsc_decode": dict(gsc_decode, card=smi)}))
    log(json.dumps({"recovery": dict(recovery, phase_s=seconds, card=smi)}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
