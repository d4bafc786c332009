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

GSC's E-step runs its kernel (``ops/gsc_cuda.py``: one ``gsc_estep``
launch and its two GEMMs a step); its decode and the mixtures are plain
PyTorch (no launch count may move while they run):

* GSC bars (the tuned configuration of examples/barstest/param_bars_gsc.py)
  through ``EM.run`` on CUDA, 8/8 bars; GSC at the patches width of
  bench.py:652 (D=256, H=300, H'=6, gamma=3, 35 multi states) on 131072
  planted-dictionary rows with a slab, through ``run`` and ``run_scanned``,
  one E-step against the CPU, the E-step kernel against the plain version
  on the card (bit-identical twice, within rtol 1e-4 of the plain version,
  both timed beside the least time of its operations and bytes), a
  decode of 8192 rows;
* MoG and MoP at bench.py:714-727 (D=256, K=300) on 131072 rows through
  ``run`` and ``run_scanned``, an inference of 8192 rows, one step against
  the CPU.

Phase 21 drives ``StreamingEM``: BSC at the patches width on phase 20's
N = 10^6 host rows in 8 segments of 131072 rows, the rolling tier from the
ndarray (page-locked in place) and from an np.memmap (pinned staging
buffers), the cached tier and the in-memory ``EM.run``, bit-identical
among the streamed runs and within the tolerance of the in-memory one with
the same kept counts, a resumed run, MCA, big-S TSC and GSC on 262144 rows
in 2 segments, and a profiled rolling iteration that shows how much of the
uploads lies under the compute (the ``stream`` line).

Then queue 3's open check: the first E-step of that run in both row cuts
of the in-memory E-step against float64 sums of the same step, and the W
drift of the two cuts after 6 M-steps.  Phase 22 drives the data-parallel
runtime (``prosper_tpu_torch/parallel/mesh.py``): (a) a one-rank NCCL
group, under which phase 6's run through ``run`` and ``run_scanned`` (the
all-reduces captured in the graphs), its decode, a ``StreamingEM`` and MCA,
big-S TSC and GSC runs are bit-identical to the runs without a runtime; (b) two
gloo ranks on the one card (this script started twice, ``--rank22``), whose
run equals phase 6's run with its rows cut as the ranks hold them, bit for
bit, and whose decodes, concatenated, equal phase 6's.  ``python3
chip_smoke.py --phase 22`` runs the build, phase 6's run, the open check and
phase 22 alone.  Phase 23 drives state sharding: (c) the big-S kernel on
each state rank's slice of phase 12's states and on a slice of padding
alone, against the plain version; then the script started twice again
(``--rank23``), two gloo ranks on the card as the (1, 2) ``("data",
"state")`` mesh: (a) phase 12's big-S TSC run and (b) phase 6's BSC run,
each rank on half of the states through the big-S kernel alone, against
the one-process run of the same kernel path; (d) MCA with
``backend="cuda"`` under the state axis raises.  ``python3 chip_smoke.py
--phase 23`` runs the build, phases 6 and 12 and phase 23 alone.  Phase 24
drives ``compute_dtype``: (a) the 16-bit GEMM kernels (bf16, fp16) against
the float64 product of the rounded operands at the GEMM phase's shapes,
both of ``hgemm_tn_splitn``'s kernels (tensor copies; cp.async for the
shapes those cannot take) giving the same bits, a one-hot permutation
check of its layouts, its design in the SASS, their times beside the plain
version, ``torch.mm`` with ``out_dtype`` and the bound of one 16-bit
pass; (b) phase 6's BSC run at
``compute_dtype=torch.bfloat16`` through ``run`` and ``run_scanned``
(bit-identical, 6 launches of each 16-bit GEMM and no split-TF32 GEMM but
the decodes'), its first E-step against float64 sums over the rounded
operands and its end beside phase 6's float32 run; (c) one bf16 E-step of
phase 12's big-S TSC and of phase 23's BSC on two state ranks against
their plain versions.  ``python3 chip_smoke.py --phase 24`` runs the
build, phases 6 and 12 and phase 24 alone.  ``python3 chip_smoke.py
--phase max`` runs the build and phases 7-10 (the max family) alone, and
``--phase gsc`` the build and phases 15-16 (GSC).

Each path's launch counts are set to 0 just before it and checked just
after.  Every phase raises on failure.  Prints one JSON line of the
iteration times through ``run`` and ``run_scanned``, one of state sharding
(``state``), one of per-kernel
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
# tensor cores, TF32 and bf16 / fp16 on the tensor cores (dense), and
# device memory
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_16BIT_FLOPS = 989e12
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
    """Every launch count to 0, hgemm_tn_splitn's counts by kernel too."""
    from prosper_tpu_torch.ops import gemm_cuda
    for counts in (cuda_lib.LAUNCHES, gemm_cuda.HGEMM_TN_PATHS):
        for k in counts:
            counts[k] = 0


def expect_launches(cuda_lib, tag, **want):
    """The launch counts since the last reset are exactly ``want`` (every
    kernel not named: 0), and every launch of hgemm_tn_splitn took its
    bulk-copy kernel (the paths give it 16-byte aligned rows of a multiple
    of 4 floats).  Returns them."""
    from prosper_tpu_torch.ops import gemm_cuda
    got = dict(cuda_lib.LAUNCHES)
    if got != {k: want.get(k, 0) for k in got}:
        raise AssertionError(f"{tag} launches {got}, expected {want} and "
                             "nothing else")
    paths = dict(gemm_cuda.HGEMM_TN_PATHS)
    if paths != {"bulk": got["hgemm_tn"], "cp_async": 0}:
        raise AssertionError(f"{tag} hgemm_tn_splitn's launches by kernel "
                             f"{paths}: its bulk-copy kernel expected at "
                             f"each of its {got['hgemm_tn']}")
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


#: the device functions behind each launch count (prosper_tpu_torch/csrc);
#: the GEMM kernels are templates on their operand type: float for
#: ``sgemm_*``, a 16-bit type for ``hgemm_*``; ``hgemm_tn`` launches one of
#: two (``gemm_cuda.HGEMM_TN_PATHS``), of which ``htn_bulk_kernel`` is the
#: paths' (``traced_kernels`` counts it apart, as ``hgemm_tn_bulk``)
KERNEL_FUNCS = {"estep": ("rows_kernel",), "decode": ("decode_kernel",),
                "max_estep": ("max_estep_kernel",), "bigs": ("bigs_kernel",),
                "gsc_estep": ("gsc_estep_kernel",),
                "sgemm_nn": ("nn_kernel",), "sgemm_tn": ("tn_kernel",),
                "hgemm_nn": ("nn_kernel",),
                "hgemm_tn": ("tn_kernel", "htn_bulk_kernel")}
HALF_NAMES = ("bfloat16", "__half")


def kernel_of(name, key):
    """Whether the device function ``name`` (mangled, as in the SASS, or
    demangled, as in a trace) is a kernel of launch count ``key``."""
    if not any(f in name for f in KERNEL_FUNCS[key]):
        return False
    half = any(h in name for h in HALF_NAMES)
    return half if key.startswith("hgemm") else (
        not half if key.startswith("sgemm") else True)


def traced_kernels(torch, run):
    """How often each of the port's kernels ran on the card during
    ``run()``, by launch-count name, and ``hgemm_tn_bulk``: how often
    hgemm_tn_splitn's bulk-copy kernel ran.  Counted from a profiler trace
    of the device, so a graph replay, which passes no launch site, shows
    too."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the tracer may miss the first kernels launched after it starts
        # (one run lost the first step's two: sgemm_nn and max_estep), so a
        # kernel of no interest goes first and is waited for
        torch.ones(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        raise AssertionError("the profiler recorded no device events")
    return dict({k: sum(kernel_of(n, k) for n in names)
                 for k in KERNEL_FUNCS},
                hgemm_tn_bulk=sum("htn_bulk_kernel" in n for n in names))


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


def gemm_check(torch, what, out, again, ref, quantised, depth):
    """One GEMM kernel's result ``out`` (and a second call's, ``again``)
    against the float64 ``ref``: the same bits twice, exact on quantised
    inputs, else within rtol 1e-5 and atol 2e-7 per unit of depth (a
    float32 fmaf chain of ``depth`` unit-variance products).  Returns the
    largest error and, on Gaussian inputs, the largest share of the
    tolerance it takes (None on quantised ones)."""
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{what}: two calls differ")
    e = (out.double() - ref).abs().max().item()
    tol = 0.0 if quantised else 2e-7 * depth
    if quantised and e != 0.0:
        raise AssertionError(f"{what}: not exact on quantised inputs (max "
                             f"abs {e})")
    torch.testing.assert_close(out.double(), ref, rtol=1e-5, atol=tol,
                               msg=what)
    return e, None if quantised else (
        (out.double() - ref).abs() / (tol + 1e-5 * ref.abs())).max().item()


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
                e, used = gemm_check(torch, f"{name} {N}x{D}x{H}", out,
                                     again, ref, quantised, depth)
                err[name] = max(err[name], e)
                if not quantised:       # the largest share of the tolerance
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


def gemm_sass(keys=("sgemm_nn", "sgemm_tn"), ops=False):
    """Instructions of the built GEMM kernels of launch counts ``keys`` by
    kind, from the library's SASS (``cuobjdump -sass`` of the CUDA toolkit,
    or the copy in Triton's package): the tensor-core MMAs must be there.
    Returns {key: {function: HGMMA count}}, or with ``ops`` {key: {function:
    {opcode: count}}}, where ``HGMMA_SMEM_A`` counts the HGMMAs whose A
    operand is a shared-memory descriptor (``gdesc``) rather than
    registers.  Where no cuobjdump is found, says so and returns None for
    each."""
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
        return {k: None for k in keys}
    text = subprocess.run([tool, "-sass", cuda_lib.load_library()._name],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = {}
        elif fn is not None:
            for op in ("HGMMA", "HMMA", "FFMA", "UTMALDG"):
                if f" {op}." in line or f" {op} " in line:
                    counts[fn][op] = counts[fn].get(op, 0) + 1
            if " HGMMA." in line:
                # HGMMA.shape.types D, A, B, C: A is "gdesc[...]" from
                # shared memory, a register from the threads
                operands = line.split(" HGMMA.")[1].split(";")[0].split(",")
                if len(operands) > 1 and operands[1].strip().startswith(
                        "gdesc"):
                    counts[fn]["HGMMA_SMEM_A"] = counts[fn].get(
                        "HGMMA_SMEM_A", 0) + 1
    out = {}
    for name in keys:
        found = {fn: c for fn, c in counts.items() if kernel_of(fn, name)}
        log(f"[gemm] SASS of {name}'s kernels: {found}")
        if not found or any(c.get("HGMMA", 0) < 1 for c in found.values()):
            raise AssertionError(f"{name}: no HGMMA in its SASS: the "
                                 "tensor cores are not used")
        out[name] = (found if ops else
                     {fn: c.get("HGMMA", 0) for fn, c in found.items()})
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
    run12 = tsc_bigs_run(torch, np, dev, patches_anneal)
    model, em, init, y_dev = (run12[k] for k in ("model", "em", "init",
                                                 "y_dev"))
    D, H, Hp, gamma, N, iters, s_block = 64, 32, 10, 5, 131072, 6, 1024
    params = em.params
    serve = {dense: model.inference(params, run12["held_out"], top_L=10,
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
            "scanned_launches": scanned_launches, "run12": run12,
            "ms": est[0], "plain_ms": est[1],
            **bigs_bound(N, S, Hp, K)}


def gsc_estep_bound(N, D, H, Hp, gamma):
    """``bound`` of GSC's E-step over N rows: the two D x H products; per
    row the H singletons in closed form (5 multiply-adds a unit), each
    support of m units among the H' candidates (its Cholesky factor m^3/3,
    the solve 2 m^2, the inverse m^3, log det and b^T kappa 2 m, the
    moments m + m (m + 1)), the softmax over the 1 + H + S columns and the
    candidate frame's H' + H'^2 moments into H and H x H.  Reads y, the
    weights and W; writes F, xs, <sz sz^T> and <sz>."""
    from math import comb
    supports = sum(comb(Hp, m) * (m ** 3 / 3.0 + 2 * m * m + m ** 3 + 3 * m
                                  + m * (m + 1))
                   for m in range(2, gamma + 1))
    S = sum(comb(Hp, m) for m in range(2, gamma + 1))
    per_row = 2 * D * H + 5 * H + supports + (1 + H + S) + Hp + Hp * Hp
    return bound(2.0 * N * per_row,
                 4.0 * (N * D + 2 * N + 2 * D * H + H * H + H))


def bigs_bound(N, S, Hp, K):
    """The big-S function's bound over N rows and S states: nL + nM
    multiply-adds per (row, state); its inputs (proj, Gf, the state
    tables) read once, its eight outputs written once."""
    nX = Hp + Hp * Hp
    nL = Hp + Hp * (Hp + 1) // 2
    nM = nL + K + 2
    return bound(2.0 * (nL + nM) * N * S,
                 4.0 * (N * nX + S * (nX + K + 3) + N * (nX + K + 5)))


def tsc_bigs_run(torch, np, dev, patches_anneal):
    """Phase 12's run: TSC at the width of bench.py's tsc_bigs (D=64, H=32,
    H'=10, gamma=5, S=12564, s_block=1024) through 6 iterations of
    ``EM.run`` on 131072 planted-dictionary rows; the launch counts are set
    to 0 just before it."""
    from prosper_tpu_torch import EM
    from prosper_tpu_torch.data.bars import planted_dictionary
    from prosper_tpu_torch.models import TSC
    from prosper_tpu_torch.ops import cuda_lib
    D, H, N = 64, 32, 131072
    model = TSC(D, H, 10, 5, chunk=8192, s_block=1024)
    gt = {"W": planted_dictionary(D, H, seed=0), "pi": np.float32(0.1),
          "sigma": np.float32(1.0)}
    data = model.generate_data(gt, N, seed=1)
    held_out = model.generate_data(gt, 8192, seed=2)
    init = model.standard_init(data, seed=3, device=dev)
    y_dev = torch.tensor(data["y"], device=dev)
    torch.cuda.synchronize()
    reset_launches(cuda_lib)
    em = EM(model, patches_anneal(6), {"y": y_dev}, params=init, seed=4,
            device=dev)
    em.run()
    return {"model": model, "em": em, "init": init, "y_dev": y_dev,
            "y_host": data["y"], "held_out": held_out}


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
    ``run`` and ``run_scanned``, one E-step against the CPU, the E-step
    kernel against the plain version on the card at N rows (time, bound,
    agreement) and a decode.  Every E-step on the card runs the kernel of
    ``ops/gsc_cuda.py`` (one ``gsc_estep`` launch and its two GEMMs); the
    decode is plain PyTorch.  Returns the ``scanned`` entry, the decode's
    rows/s and the kernel's entry of the ``kernels`` line."""
    from prosper_tpu_torch import EM, LinearAnnealing
    from prosper_tpu_torch.core import gscstep
    from prosper_tpu_torch.data.bars import (bars_gt_params,
                                             count_recovered_bars,
                                             planted_dictionary)
    from prosper_tpu_torch.io.weights import params_from_numpy
    from prosper_tpu_torch.models import GSC
    from prosper_tpu_torch.models.base import sched_floats
    from prosper_tpu_torch.ops import cuda_lib, gsc_cuda

    def kernel_path(n):
        return {k: n for k in ("gsc_estep", "sgemm_nn", "sgemm_tn")}

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
    expect_launches(cuda_lib, "[gsc bars]", **kernel_path(70))
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
    launches = expect_launches(cuda_lib, tag, **kernel_path(iters))
    check_path(torch, np, tag, em, serve, H)
    log(f"{tag} mu {float(params['mu']):.4f}, psi {float(params['psi']):.4f}"
        f", sigma {float(params['sigma']):.4f} after {iters} iterations "
        "(planted: 1, 0.25, 1)")
    scanned, scanned_launches = scanned_path(
        torch, np, cuda_lib, tag, em,
        lambda: EM(model, patches_anneal(iters), {"y": y_dev}, params=init,
                   seed=4, device=dev),
        init, 4, smi, **kernel_path(iters))
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
    reset_launches(cuda_lib)
    for d in (dev, torch.device("cpu")):
        p = params_from_numpy(p_q, d)
        out[d.type] = model.estep_sums(p, torch.tensor(y_q, device=d),
                                       torch.tensor(w_q, device=d),
                                       sched_floats(a))
    expect_launches(cuda_lib, f"{tag} E-step", **kernel_path(1))
    err = max(against_cpu(torch, f"{tag} E-step F", out[dev.type][0],
                          out["cpu"][0], 1e-4),
              against_cpu(torch, f"{tag} E-step", out[dev.type][1],
                          out["cpu"][1], 1e-4))
    log(f"{tag} one annealed E-step on 4096 rows on the card agrees with the "
        f"CPU within rtol 1e-4 (largest difference {err:.3e})")

    # the kernel against the plain version on the card, all N rows (in
    # quarters, W in 1/64ths: the same candidates), timed in turns
    p = params_from_numpy(p_q, dev)
    y_n = torch.tensor(quantised(np, data["y"], 0.25), device=dev)
    w_n = torch.tensor((np.arange(N) % 7 > 0).astype(np.float32),
                       device=dev)
    sa = model.state_arrays(dev)
    args = (y_n, w_n, p["W"], p["sigma"] ** 2, p["pi"], p["mu"], p["psi"],
            sa, Hp, 0.7, 1.0)
    ref = gscstep.gsc_et_estep(*args, chunk=8192)
    got = gsc_cuda.gsc_et_estep_cuda(*args)
    again = gsc_cuda.gsc_et_estep_cuda(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], again[0])
            and all(torch.equal(got[1][k], again[1][k]) for k in got[1])):
        raise AssertionError(f"{tag} two runs of the GSC E-step kernel "
                             "differ")
    k_err = max(against_cpu(torch, f"{tag} kernel F", got[0], ref[0].cpu(),
                            1e-4),
                against_cpu(torch, f"{tag} kernel", got[1],
                            {k: v.cpu() for k, v in ref[1].items()}, 1e-4))
    ms, plain_ms = interleaved_ms(
        torch, lambda: gscstep.gsc_et_estep(*args, chunk=8192),
        lambda: gsc_cuda.gsc_et_estep_cuda(*args), 5)
    est_bound = gsc_estep_bound(N, D, H, Hp, gamma)
    smem, bps = gsc_cuda.kernel_occupancy(H, sa, Hp)
    log(f"{tag} E-step kernel {ms:.3f} ms vs plain {plain_ms:.3f} ms (N={N}, "
        f"{plain_ms / ms:.1f} x), bound {est_bound['bound_ms']:.4f} ms by "
        f"{est_bound['bound_by']} "
        f"({100 * est_bound['bound_ms'] / ms:.2f} % of it); agrees within "
        f"rtol 1e-4 (largest difference {k_err:.3e}), two runs "
        f"bit-identical; {smem} bytes of shared memory a block, {bps} "
        f"blocks an SM  [{smi}]")
    kernel = {"launches": launches["gsc_estep"],
              "scanned_launches": scanned_launches["gsc_estep"],
              "ms": ms, "plain_ms": plain_ms, **est_bound,
              "max_abs_err": max(err, k_err)}

    # the decode: 8192 rows from the card, compact and dense
    y_ho = torch.tensor(held_out["y"], device=dev)
    reset_launches(cuda_lib)
    dec = {dense: cuda_ms(torch, lambda d=dense: model.inference(
        params, {"y": y_ho}, top_L=10, dense_states=d), 3)
        for dense in (False, True)}
    expect_launches(cuda_lib, tag)
    log(f"{tag} decode of 8192 rows: compact {dec[False]:.3f} ms = "
        f"{8192 / dec[False] * 1e3:.0f} rows/s, dense {dec[True]:.3f} ms = "
        f"{8192 / dec[True] * 1e3:.0f} rows/s  [{smi}]")
    return scanned, {"compact_ms": dec[False], "dense_ms": dec[True],
                     "rows_per_s": 8192 / dec[False] * 1e3}, kernel


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
    step's spans (``io/tracing.py`` switched on) in a profiler trace beside
    ``rows_kernel``.  Returns the numbers."""
    import contextlib
    import io
    import os
    import tempfile

    from prosper_tpu_torch import EM, cli
    from prosper_tpu_torch.data.bars import planted_dictionary
    from prosper_tpu_torch.io import hdf5
    from prosper_tpu_torch.io import tracing
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
        tracing.enable(True)
        try:
            with tracing.profile_trace(os.path.join(tmp, "prof")) as prof:
                em.step_once()
                torch.cuda.synchronize()
        finally:
            tracing.enable(False)
        names = [e.name for e in prof.events()]
        cuda_names = [e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        if not ({"prosper::estep", "prosper::mstep"} <= set(names)
                and any("rows_kernel" in n for n in cuda_names)):
            raise AssertionError("[cli] the step's spans or rows_kernel are "
                                 "missing from the profiler trace")
        if not os.path.exists(os.path.join(tmp, "prof", "trace.0.json")):
            raise AssertionError("[cli] profile_trace wrote no trace")
        out["seconds"] = time.perf_counter() - t0
    log(f"[cli] generate, train --scan (launch sites {launches}), train "
        f"killed after 4 iterations + train --resume (launches {resumed}; "
        f"bit-identical to --scan), infer (launches {inferred}), diagnose "
        f"--json ({out['diagnose']}), python -m prosper_tpu_torch.cli train "
        f"in a subprocess ({out['subprocess_train_s']:.1f} s, bit-identical "
        f"to --scan), the step's spans beside rows_kernel in the profiler "
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
        r = run_protocol(0, device=dev, log=log, keep_data=True)
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
    em, y_host = r.pop("em"), r.pop("y")
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
            "launches": launches}, y_host


def same_stream(torch, tag, ref, sem, first=0):
    """Where ``sem`` differs from ``ref`` bit for bit (parameters, F_prev,
    every scalar but dt of every iteration from ``first`` on, the
    generator's next draw): a list of findings, empty when they agree."""
    bad = [f"{tag}: {k} differs" for k in ref.params
           if not torch.equal(ref.params[k], sem.params[k])]
    if not torch.equal(ref.F_prev, sem.F_prev):
        bad.append(f"{tag}: F_prev differs")
    hr = [{k: v for k, v in h.items() if k != "dt"}
          for h in ref.history[first:]]
    he = [{k: v for k, v in h.items() if k != "dt"} for h in sem.history]
    if hr != he:
        bad.append(f"{tag}: scalars differ: {he} against {hr}")
    if not torch.equal(next_draw(torch, ref.generator),
                       next_draw(torch, sem.generator)):
        bad.append(f"{tag}: the generator's next draw differs")
    return bad


def in_memory_cut_as_segments(torch, np, fam, anneal, y_host, seg, init,
                              dev):
    """The in-memory ``EM.run`` on ``y_host`` padded with weight-0 rows to
    whole segments of ``seg`` rows, its E-steps cutting the rows into
    chunks of ``seg`` (``cuda_lib.P_LIMIT_BYTES``) and adding the chunks'
    sums in order: the arithmetic of the streamed run, so it must equal it
    bit for bit."""
    from prosper_tpu_torch import EM
    from prosper_tpu_torch.ops import cuda_lib
    N = y_host.shape[0]
    rows = -(-N // seg) * seg
    y = torch.zeros((rows, y_host.shape[1]), dtype=torch.float32,
                    device=dev)
    y[:N] = torch.as_tensor(y_host, device=dev)
    valid = (torch.arange(rows, device=dev) < N).float()
    # the workspace the row chunks are cut by: (rows, H) floats, (rows,
    # H' H) for the big-S E-step
    width = max(fam.H, fam.Hprime * fam.H) if getattr(fam, "s_block", 0) \
        else fam.H
    saved = cuda_lib.P_LIMIT_BYTES
    cuda_lib.P_LIMIT_BYTES = seg * 4 * width
    try:
        em = EM(fam, anneal, {"y": y, "valid": valid}, params=init, seed=4,
                device=dev)
        em.run()
    finally:
        cuda_lib.P_LIMIT_BYTES = saved
    return em


def against_in_memory(torch, np, tag, sem, cut, em):
    """Where the streamed run ``sem`` leaves the in-memory runs: ``cut``
    (rows cut into chunks as the segments, ``in_memory_cut_as_segments``)
    must equal it bit for bit (parameters, F_prev, every scalar but dt,
    the generator's next draw); ``em`` (the default cut) must keep the same
    rows in every iteration (n_used) with F_mean within rtol 1e-4.  Returns
    (findings, the parameters' largest differences from ``em`` with the
    largest entry of each)."""
    bad = []
    for k in em.params:
        if not torch.equal(sem.params[k], cut.params[k]):
            bad.append(f"{tag}: {k} differs from the in-memory run cut as "
                       "the segments")
    if not torch.equal(sem.F_prev, cut.data["F_prev"]):
        bad.append(f"{tag}: F_prev differs from the in-memory run cut as "
                   "the segments")
    hs = [{k: v for k, v in h.items() if k != "dt"} for h in sem.history]
    hc = [{k: v for k, v in h.items() if k != "dt"} for h in cut.history]
    if hs != hc:
        bad.append(f"{tag}: scalars {hs} differ from the in-memory run cut "
                   f"as the segments {hc}")
    if not torch.equal(next_draw(torch, sem.generator),
                       next_draw(torch, cut.generator)):
        bad.append(f"{tag}: the generator's next draw differs from the "
                   "in-memory run's")
    n_s = [h["n_used"] for h in sem.history]
    n_m = [h["n_used"] for h in em.history]
    if n_s != n_m:
        bad.append(f"{tag}: n_used {n_s}, in memory {n_m}")
    f_s = np.array([h["F_mean"] for h in sem.history])
    f_m = np.array([h["F_mean"] for h in em.history])
    if not np.allclose(f_s, f_m, rtol=1e-4, atol=0.0):
        bad.append(f"{tag}: F_mean {f_s.tolist()}, in memory "
                   f"{f_m.tolist()}")
    diff = {k: {"max_abs_diff": (sem.params[k] - em.params[k]).abs().max()
                .item(), "max_abs": em.params[k].abs().max().item(),
                "within_rtol5e-4_atol1e-4": torch.allclose(
                    sem.params[k], em.params[k], rtol=5e-4, atol=1e-4)}
            for k in em.params}
    return bad, diff


def union_ms(spans):
    """Merged [start, end) spans (microseconds) of a trace."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_figures(np, torch, sem, tmp, tag):
    """One rolling iteration of ``sem`` under the profiler: the HtoD copy
    time on the copy stream (the stream of the largest HtoD copy), the part
    of it under kernels of the other streams (ms and share), the achieved
    GB/s, the host's fill and wait per segment, and the iteration's ms."""
    import os

    from torch.profiler import ProfilerActivity, profile
    st0 = dict(sem.uploader.stats)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h = sem.step_once()
        torch.cuda.synchronize()
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    st = {k: sem.uploader.stats[k] - st0[k] for k in ("bytes", "segments",
                                                      "fill_s", "wait_s")}
    htod = [e for e in events if e.get("cat") == "gpu_memcpy"
            and "HtoD" in e.get("name", "")]
    if not htod:
        raise AssertionError(f"{tag}: no HtoD copy in the trace")
    copy_stream = max(htod, key=lambda e: e["dur"]).get("args",
                                                        {}).get("stream")
    copies = union_ms([(e["ts"], e["ts"] + e["dur"]) for e in htod
                       if e.get("args", {}).get("stream") == copy_stream])
    kernels = union_ms([(e["ts"], e["ts"] + e["dur"]) for e in events
                        if e.get("cat") == "kernel"
                        and e.get("args", {}).get("stream") != copy_stream])
    if not kernels:
        raise AssertionError(f"{tag}: no kernel on the compute stream")
    under, i, j = 0.0, 0, 0
    while i < len(copies) and j < len(kernels):
        a = max(copies[i][0], kernels[j][0])
        b = min(copies[i][1], kernels[j][1])
        under += max(0.0, b - a)
        if copies[i][1] < kernels[j][1]:
            i += 1
        else:
            j += 1
    copy_us = sum(b - a for a, b in copies)
    busy_us = sum(b - a for a, b in kernels)
    return {"iteration_ms": h["dt"] * 1e3, "htod_ms": copy_us / 1e3,
            "htod_under_kernels_ms": under / 1e3,
            "htod_under_kernels_share": under / copy_us,
            "kernels_busy_ms": busy_us / 1e3,
            "htod_GBps": st["bytes"] / (copy_us * 1e-6) / 1e9,
            "bytes": st["bytes"], "segments": st["segments"],
            "fill_ms_per_segment": st["fill_s"] / st["segments"] * 1e3,
            "wait_ms_per_segment": st["wait_s"] / st["segments"] * 1e3}


class forbid_plain:
    """Within the block, the plain versions of the E-steps raise: a
    streamed run on the card goes through the kernels alone."""

    def __enter__(self):
        from prosper_tpu_torch.core import etstep, gscstep, maxstep
        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (etstep, "linear_et_estep"), (etstep, "bigs_multi"),
            (maxstep, "max_et_estep"), (gscstep, "gsc_et_estep"))]

        def make(name):
            def boom(*a, **k):
                raise AssertionError(f"the plain {name} ran on the "
                                     "streamed path")
            return boom
        for m, n, _ in self.saved:
            setattr(m, n, make(n))

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def stream_path(torch, np, dev, smi, y_host, patches_anneal):
    """Phase 21: ``StreamingEM`` at the patches width on phase 20's N = 10^6
    host rows (BSC, D=256, H=300, H'=8, gamma=4), segments of 131072 rows
    (8 segments, the tail 82,496 real rows), 6 iterations of phase 6's
    schedule, four ways from the same parameters and seed: (a) the rolling
    tier from the ndarray (page-locked in place), (b) the rolling tier from
    an np.memmap of the same rows (two pinned staging buffers), (c) the
    cached tier, (d) the in-memory ``EM.run`` on the card.  (a), (b), (c)
    bit-identical; n_used equal to (d)'s in every iteration and the
    parameters within rtol 5e-4 / atol 1e-4 of (d)'s; each kernel launched
    once a segment and no plain version run; a run checkpointed at
    iteration 3 and resumed in a fresh StreamingEM bit-identical to (a).
    Then MCA (D=256, H=300, H'=6, gamma=3), big-S TSC (D=64, H=32,
    H'=10, gamma=5, s_block=1024) and GSC (D=256, H=300, H'=6, gamma=3)
    on 262144 rows in 2 segments, 3 iterations each, against their
    in-memory runs.  One profiled rolling iteration of (a) and of (b)
    gives the overlap of the uploads with the compute.  Returns the
    ``stream`` line's numbers and the streamed launches by kernel (BSC's
    run (a), MCA's, TSC's and GSC's)."""
    import os
    import tempfile

    from prosper_tpu_torch import EM, StreamingEM
    from prosper_tpu_torch.data.bars import planted_dictionary
    from prosper_tpu_torch.models import BSC, GSC, MCA, TSC
    from prosper_tpu_torch.ops import cuda_lib

    bad = []
    N, D, seg, iters = y_host.shape[0], y_host.shape[1], 131072, 6
    model = BSC(D, 300, 8, 4, chunk=8192)
    init = model.standard_init({"y": y_host[:seg]}, seed=3, device=dev)

    def streamed(y, **kw):
        return StreamingEM(model, patches_anneal(iters), y, seg_size=seg,
                           params=init, seed=4, device=dev, **kw)

    def ms(run):
        dts = [h["dt"] * 1e3 for h in run.history]
        return {"first": dts[0], "median_rest": float(np.median(dts[1:]))}

    out = {"N": N, "seg_size": seg, "iters": iters}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = os.path.join(tmp, "y.f32")
        mm = np.memmap(path, np.float32, "w+", shape=y_host.shape)
        mm[:] = y_host
        mm.flush()
        del mm
        y_mm = np.memmap(path, np.float32, "r", shape=y_host.shape)
        out["memmap_write_s"] = time.perf_counter() - t0
        runs = {}
        for name, y, kw in (("rolling_ndarray", y_host, {"cache_bytes": 0}),
                            ("rolling_memmap", y_mm, {"cache_bytes": 0}),
                            ("cached", y_host, {})):
            reset_launches(cuda_lib)
            sem = streamed(y, **kw)
            with forbid_plain():
                sem.run()
            torch.cuda.synchronize()
            n = sem.n_seg * iters
            got = expect_launches(cuda_lib, f"[stream] {name}", estep=n,
                                  sgemm_nn=n, sgemm_tn=n)
            if name == "rolling_ndarray":
                launches = dict(got)
            runs[name] = sem
            out[name] = dict(ms(sem), **{k: sem.uploader.stats[k] for k in (
                "bytes", "segments", "registered", "register_s", "fill_s",
                "wait_s")}, cached=sem._cache_all)
            log(f"[stream] {name}: {sem.n_seg} segments of {sem.seg_size} "
                f"rows (tail {N - (sem.n_seg - 1) * seg}), iteration ms "
                f"{[round(h['dt'] * 1e3, 3) for h in sem.history]}, "
                f"n_used {[h['n_used'] for h in sem.history]}, uploads "
                f"{sem.uploader.stats}, launches {got}  [{smi}]")
        if runs["rolling_ndarray"].n_seg != 8:
            bad.append("[stream] expected 8 segments")
        for name in ("rolling_memmap", "cached"):
            bad += same_stream(torch, f"[stream] {name} vs rolling_ndarray",
                               runs["rolling_ndarray"], runs[name])
        y_dev = torch.as_tensor(y_host, device=dev)
        em = EM(model, patches_anneal(iters), {"y": y_dev}, params=init,
                seed=4, device=dev)
        em.run()
        del y_dev
        cut = in_memory_cut_as_segments(torch, np, model,
                                        patches_anneal(iters), y_host, seg,
                                        init, dev)
        out["in_memory"] = ms(em)
        log(f"[stream] in-memory EM.run: iteration ms "
            f"{[round(h['dt'] * 1e3, 3) for h in em.history]}, n_used "
            f"{[h['n_used'] for h in em.history]}  [{smi}]")
        found, out["params_vs_in_memory"] = against_in_memory(
            torch, np, "[stream] BSC N=10^6", runs["cached"], cut, em)
        bad += found
        log(f"[stream] BSC N=10^6 against the in-memory run: "
            f"{out['params_vs_in_memory']}; bit-identical to the in-memory "
            f"run cut as the segments: {not found}  [{smi}]")
        del em, cut

        # resume: a run checkpointed at iteration 3, cut after 4, resumed
        ck = os.path.join(tmp, "stream.h5")
        a = streamed(y_host, cache_bytes=0, checkpoint_path=ck,
                     checkpoint_every=3)
        for _ in range(4):
            a.step_once()
        a.close()
        b = StreamingEM(model, patches_anneal(iters), y_host, seg_size=seg,
                        params=init, seed=999, device=dev, cache_bytes=0)
        if b.resume(ck) != 3:
            bad.append("[stream] resume did not return step 3")
        b.run()
        bad += same_stream(torch, "[stream] resumed vs rolling_ndarray",
                           runs["rolling_ndarray"], b, first=3)
        del a, b

        # the overlap: one profiled rolling iteration from each source
        for name, y in (("rolling_ndarray", y_host),
                        ("rolling_memmap", y_mm)):
            sem = streamed(y, cache_bytes=0)
            sem.step_once()                     # set-up and first pass
            fig = overlap_figures(np, torch, sem, tmp, f"[stream] {name}")
            sem.close()
            out[name]["overlap"] = fig
            log(f"[stream] {name} overlap: HtoD {fig['htod_ms']:.3f} ms on "
                f"the copy stream, {fig['htod_under_kernels_ms']:.3f} ms "
                f"({100 * fig['htod_under_kernels_share']:.1f} %) under "
                f"kernels of the compute stream (busy "
                f"{fig['kernels_busy_ms']:.3f} ms), {fig['htod_GBps']:.2f} "
                f"GB/s, host fill {fig['fill_ms_per_segment']:.3f} ms and "
                f"wait {fig['wait_ms_per_segment']:.3f} ms a segment, "
                f"iteration {fig['iteration_ms']:.3f} ms  [{smi}]")
        del y_mm, runs

    # MCA, big-S TSC and GSC: 262144 rows in 2 segments, 3 iterations
    W_gt = planted_dictionary(256, 300, seed=0)
    for tag, fam, kern in (
            ("mca", MCA(256, 300, 6, 3),
             {"max_estep": 6, "sgemm_nn": 6, "sgemm_tn": 6}),
            ("tsc_bigs", TSC(64, 32, 10, 5, chunk=8192, s_block=1024),
             {"bigs": 6}),
            ("gsc", GSC(256, 300, 6, 3, chunk=8192),
             {"gsc_estep": 6, "sgemm_nn": 6, "sgemm_tn": 6})):
        gt = {"W": W_gt if tag != "tsc_bigs" else planted_dictionary(
                  64, 32, seed=0),
              "pi": np.float32(2.0 / 300 if tag != "tsc_bigs" else 0.1),
              "sigma": np.float32(1.0)}
        if tag == "gsc":
            gt.update(mu=np.float32(1.0), psi=np.float32(0.25))
        data = fam.generate_data(gt, 2 * seg, seed=1)
        p0 = fam.standard_init(data, seed=3, device=dev)
        reset_launches(cuda_lib)
        sem = StreamingEM(fam, patches_anneal(3), data["y"], seg_size=seg,
                          params=p0, seed=4, device=dev, cache_bytes=0)
        with forbid_plain():
            sem.run()
        torch.cuda.synchronize()
        got = expect_launches(cuda_lib, f"[stream] {tag}", **kern)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        em = EM(fam, patches_anneal(3), {"y": torch.as_tensor(
            data["y"], device=dev)}, params=p0, seed=4, device=dev)
        em.run()
        cut = in_memory_cut_as_segments(torch, np, fam, patches_anneal(3),
                                        data["y"], seg, p0, dev)
        found, diff = against_in_memory(torch, np, f"[stream] {tag}", sem,
                                        cut, em)
        bad += found
        out[tag] = {"streamed": ms(sem), "in_memory": ms(em),
                    "n_seg": sem.n_seg, "bytes": sem.uploader.stats["bytes"],
                    "params_vs_in_memory": diff}
        log(f"[stream] {tag}: {sem.n_seg} segments, streamed iteration ms "
            f"{[round(h['dt'] * 1e3, 3) for h in sem.history]}, in memory "
            f"{[round(h['dt'] * 1e3, 3) for h in em.history]}, n_used "
            f"{[h['n_used'] for h in sem.history]} / "
            f"{[h['n_used'] for h in em.history]}, launches {got}; against "
            f"the in-memory run {diff}; bit-identical to the in-memory run "
            f"cut as the segments: {not found}  [{smi}]")
        del sem, em, cut, data
    if bad:
        raise AssertionError("[stream] " + "; ".join(bad))
    return out, launches



# ---- 22. the data-parallel runtime, and the open check of two row cuts ------

#: "a few ulps x sqrt(N)": a sum of N float32 terms is held within this many
#: ulps of its largest entry, times sqrt(N), of the float64 sum of the same
#: step
ULPS_SQRT_N = 4.0


def linear_sums_f64(torch, y, w, W, sigma2, log_odds, sa, Hp, signed, beta,
                    prior_beta=1.0, chunk=32768, P32=None, compute_dtype=None):
    """One linear E-step's sums (xs, ss, s, abs, vc, y2, n, F) from the same
    inputs as the kernel's, every operation in float64: the plain version's
    arithmetic (``core/etstep.py::_chunk_estats``), rows in chunks whose
    sums are added in float64.  ``P32(rows)``, where given, is the float32
    projection y W of the rows that the E-step's own GEMM computes: the
    candidates and logits then start from the step's P, and what differs
    from the kernel's sums is the rest of the arithmetic and the order of
    the sums, not the projection's rounding.  With a 16-bit
    ``compute_dtype`` xs is the float64 product of y and sw rounded to it
    (and P, where no ``P32`` is given, that of y and W)."""
    import math

    def rnd(t):
        return t if compute_dtype is None else t.to(compute_dtype)

    from prosper_tpu_torch.core.select import top_hprime_candidates
    f = torch.float64
    W = W.to(f)
    gram = W.T @ W
    gd = torch.diagonal(gram)
    wn = torch.sqrt(torch.clamp(gd, min=1e-30))
    D, H = W.shape
    st, ou, ab = sa.states.to(f), sa.outer.to(f), sa.abs_states.to(f)
    vcs, v = sa.value_counts.to(f), sa.values.to(f)
    K = v.shape[0]
    lo = log_odds.to(f)
    i2 = 0.5 / torch.as_tensor(sigma2, device=W.device).to(f)
    prior_multi = vcs @ lo
    const = (-beta * 0.5 * D * torch.log(math.pi / i2)
             - prior_beta * H * torch.log1p(torch.exp(lo).sum()))
    tot = {}
    for i in range(0, y.shape[0], chunk):
        yc, wc = y[i:i + chunk].to(f), w[i:i + chunk].to(f)
        C = yc.shape[0]
        P = (rnd(y[i:i + chunk]).to(f) @ rnd(W).to(f) if P32 is None
             else P32(y[i:i + chunk]).to(f))
        cand = top_hprime_candidates(P, wn, Hp, signed)
        proj = P.gather(1, cand)
        Gf = gram[cand[:, :, None], cand[:, None, :]].reshape(C, Hp * Hp)
        lik_single = (2.0 * P[:, :, None] * v - gd[None, :, None] * v * v) * i2
        logits = torch.cat([
            torch.zeros_like(P[:, :1]),
            (beta * lik_single + prior_beta * lo).reshape(C, H * K),
            beta * (2.0 * proj @ st.T - Gf @ ou.T) * i2
            + prior_beta * prior_multi], dim=1)
        m = logits.max(dim=1, keepdim=True).values
        p = torch.exp(logits - m)
        Z = p.sum(dim=1, keepdim=True)
        q = p / Z
        y2 = (yc * yc).sum(dim=1)
        F = (m + torch.log(Z))[:, 0] - beta * y2 * i2 + const
        qs, qm = q[:, 1:1 + H * K].reshape(C, H, K), q[:, 1 + H * K:]
        sw = (qs @ v).scatter_add(1, cand, qm @ st) * wc[:, None]
        idx = (cand[:, :, None] * H + cand[:, None, :]).reshape(-1)
        ss = (torch.zeros(H * H, dtype=f, device=W.device)
              .index_add_(0, idx, ((qm @ ou) * wc[:, None]).reshape(-1))
              .reshape(H, H)
              + torch.diag(((qs @ (v * v)) * wc[:, None]).sum(dim=0)))
        part = {"xs": rnd(y[i:i + chunk]).to(f).T @ rnd(sw).to(f),
                "ss": ss, "s": sw.sum(dim=0),
                "abs": ((qs.sum(dim=(1, 2)) + qm @ ab) * wc).sum(),
                "vc": ((qs.sum(dim=1) + qm @ vcs) * wc[:, None]).sum(dim=0),
                "y2": (y2 * wc).sum(), "n": wc.sum(), "F": (F * wc).sum()}
        tot = part if not tot else {k: tot[k] + t for k, t in part.items()}
    return tot


def bsc_sums_f64(torch, y, w, W, sigma2, pi, sa, Hp, beta, prior_beta=1.0,
                 chunk=32768, P32=None):
    """``linear_sums_f64`` for BSC with its prior ``pi``."""
    pi = torch.as_tensor(pi, device=W.device).double()
    return linear_sums_f64(torch, y, w, W, sigma2,
                           (torch.log(pi) - torch.log1p(-pi)).reshape(1), sa,
                           Hp, False, beta, prior_beta, chunk, P32)


def against_f64(torch, np, sums, ref, N):
    """Each key of a float32 E-step's ``sums`` against the float64 ``ref``:
    the largest difference, relative to the largest entry, and in units of
    ulp(largest entry) x sqrt(N) (the bound is ``ULPS_SQRT_N`` of them)."""
    out = {}
    for k, r in ref.items():
        r = r.double()
        d = (sums[k].double() - r).abs().max().item()
        top = r.abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(top)) - 23) if top > 0 else 2.0 ** -149
        out[k] = {"rel": d / top if top > 0 else d,
                  "ulps_sqrt_n": float(d / (ulp * np.sqrt(N)))}
    return out


def open_check(torch, np, dev, smi, y_host, patches_anneal):
    """Queue 3's open check (``ROADMAP.md``): the first E-step of phase 6's
    schedule (the initial W of phase 21 with the step's W noise, beta 0.5)
    at the patches width on N = 10^6 rows (phase 20's), through the kernels
    in both row cuts of the in-memory E-step, the default one
    (``cuda_lib.row_chunks``: 893,952 rows, then the rest) and 131072-row
    chunks (the streamed run's segments).  Each cut's sums against the
    float64 sums of the same step (``bsc_sums_f64`` from the step's
    projection, ``sgemm_nn``'s P), and the two cuts against each other,
    within ``ULPS_SQRT_N`` ulps x sqrt(N) (the float64 sums from a float64
    projection are reported beside them).  Then the W drift between the two
    cuts after the 6 M-steps of the schedule (the default-cut ``EM.run``
    against ``in_memory_cut_as_segments``, which equals the streamed run bit
    for bit): the schedule's sensitivity to the order of float32 sums at
    this N (phase 22b measures it at its own N the same way).  Returns the
    numbers, with "failures" (empty
    when the check holds)."""
    from prosper_tpu_torch import EM
    from prosper_tpu_torch.models import BSC
    from prosper_tpu_torch.models.base import device_sched, sched_floats
    from prosper_tpu_torch.ops import cuda_lib, gemm_cuda, linear_cuda

    N, seg = y_host.shape[0], 131072
    model = BSC(256, 300, 8, 4, chunk=8192)
    init = model.standard_init({"y": y_host[:seg]}, seed=3, device=dev)
    sched = device_sched(sched_floats(patches_anneal(6)), dev)
    p1 = model.noisify(init, sched, torch.Generator(device=dev).manual_seed(4))
    y = torch.as_tensor(y_host, device=dev)
    w = torch.ones(N, device=dev)
    sa = model.state_arrays(dev)
    args = (y, w, p1["W"], p1["sigma"] ** 2, model.log_odds(p1), sa, 8,
            False, 0.5, 1.0)
    t0 = time.perf_counter()
    ref = bsc_sums_f64(torch, y, w, p1["W"], p1["sigma"] ** 2, p1["pi"], sa,
                       8, 0.5, P32=lambda rows: gemm_cuda.sgemm_nn_cuda(
                           rows, p1["W"]))
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    ref_P64 = bsc_sums_f64(torch, y, w, p1["W"], p1["sigma"] ** 2, p1["pi"],
                           sa, 8, 0.5)
    out, sums = {"N": N, "beta": 0.5, "f64_s": f64_s}, {}
    saved = cuda_lib.P_LIMIT_BYTES
    for name, limit in (("default", saved), ("chunks_131072", seg * 4 * 300)):
        cuda_lib.P_LIMIT_BYTES = limit
        try:
            chunks = cuda_lib.row_chunks(N, 300)
            _, sums[name] = linear_cuda.linear_et_estep_cuda(
                *args, collect_true=False)
        finally:
            cuda_lib.P_LIMIT_BYTES = saved
        out[name] = {"chunks": [j - i for i, j in chunks],
                     "against_f64": against_f64(torch, np, sums[name], ref,
                                                N),
                     "against_f64_projection": against_f64(
                         torch, np, sums[name], ref_P64, N)}
    out["between_cuts"] = against_f64(torch, np, sums["default"],
                                      {k: sums["chunks_131072"][k]
                                       for k in ref}, N)
    del y, w
    em = EM(model, patches_anneal(6), {"y": torch.as_tensor(y_host,
                                                            device=dev)},
            params=init, seed=4, device=dev)
    em.run()
    cut = in_memory_cut_as_segments(torch, np, model, patches_anneal(6),
                                    y_host, seg, init, dev)
    drift = {k: {"max_abs_diff": (em.params[k] - cut.params[k]).abs().max()
                 .item(), "max_abs": em.params[k].abs().max().item()}
             for k in em.params}
    out["W_drift_6_iterations"] = drift["W"]
    out["sensitivity"] = drift["W"]["max_abs_diff"] / drift["W"]["max_abs"]
    out["n_used_equal"] = ([h["n_used"] for h in em.history]
                           == [h["n_used"] for h in cut.history])
    worst = {name: max(v["ulps_sqrt_n"] for v in out[name].values())
             for name in ("between_cuts",)}
    worst.update({name: max(v["ulps_sqrt_n"] for v in out[name]
                            ["against_f64"].values())
                  for name in ("default", "chunks_131072")})
    out["worst_ulps_sqrt_n"] = worst
    out["failures"] = [f"{name}: {v:.4g} ulps x sqrt(N)"
                       for name, v in worst.items() if v > ULPS_SQRT_N]
    log(f"[check] the first E-step of phase 6's schedule at N={N}: the "
        f"default row cut {out['default']['chunks']} and 131072-row chunks "
        f"against float64 sums of the same step (max |diff| / max |sum|, and "
        f"in ulps x sqrt(N)): default {out['default']['against_f64']}, "
        f"131072 {out['chunks_131072']['against_f64']}; the cuts against "
        f"each other {out['between_cuts']}; against float64 sums from a "
        f"float64 projection: default "
        f"{out['default']['against_f64_projection']}, 131072 "
        f"{out['chunks_131072']['against_f64_projection']}; the float64 sums "
        f"in {f64_s:.1f} s; W after 6 M-steps: the cuts differ by "
        f"{drift['W']['max_abs_diff']:.3g} (max |W| "
        f"{drift['W']['max_abs']:.3g}; sensitivity "
        f"{out['sensitivity']:.3g}), n_used equal {out['n_used_equal']}; "
        f"beyond {ULPS_SQRT_N} ulps x sqrt(N): {out['failures'] or 'none'}  "
        f"[{smi}]")
    return out


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def expected_all_reduces(anneal):
    """The all-reduces a step under a runtime issues, per iteration of
    ``anneal``: the sums with N_total (1), and with the Ncut cut its n_sel,
    the extent (lo and hi in one) and 3 histogram rounds (5 more)."""
    from prosper_tpu_torch.engine.em import schedule_window
    from prosper_tpu_torch.models.base import step_pattern
    return [1 + 5 * step_pattern(s).ncut
            for s in schedule_window(anneal, anneal.steps)]


def nccl_kernels(torch, run):
    """Device events of ``run()`` whose name is NCCL's, from a profiler
    trace: (count, names)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the tracer may miss the first kernels launched after it starts
        # (one run lost the first step's two: sgemm_nn and max_estep), so a
        # kernel of no interest goes first and is waited for
        torch.ones(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "nccl" in e.name.lower()]
    return len(names), sorted(set(names))


def distributed_path(torch, np, dev, smi, ref, patches_anneal,
                     sensitivity_1e6):
    """Phase 22: the data-parallel runtime (``parallel/mesh.py``) on the
    card.  22a: a one-rank NCCL group on localhost drives phase 6's run
    (BSC at the patches width, 131072 rows, 6 iterations) through ``run``
    and ``run_scanned`` (the all-reduces captured in the graphs),
    ``inference`` of phase 6's 8192 held-out rows and a ``StreamingEM`` of
    131072 rows in 2 segments (3 iterations): each bit-identical to the run
    without a runtime; the all-reduces issued and held by the replays
    against the count the schedule gives, NCCL's kernels in a trace of the
    replays, host ms per iteration with and without the runtime.  22b: two
    ranks of a gloo group on this one card (two processes of this script,
    the kernels built here first), 65536 ``stride_data`` rows each, phase
    6's run through ``run`` with revival on (it fires nothing; its
    broadcast runs): parameters replicated exactly, one E-step launch per
    iteration on each rank, n_used and N_total of every iteration as phase
    6's, the first step's sums within ``ULPS_SQRT_N`` ulps x sqrt(N) of the
    float64 sums, and the two ranks' decodes, concatenated, phase 6's bit
    for bit.  The two ranks' run equals phase 6's run with its E-step's rows
    cut as the ranks hold them (``in_memory_cut_as_segments``, two chunks of
    65536 rows) bit for bit: the same sums, added in the same order.  W is
    held to phase 6's within the schedule's sensitivity at this N: the W
    drift between those two row cuts of the one-process run (the open
    check's measure; ``sensitivity_1e6`` is its value at N = 10^6)."""
    import os
    import tempfile

    import torch.distributed as dist

    from prosper_tpu_torch import EM, StreamingEM
    from prosper_tpu_torch.data.bars import planted_dictionary
    from prosper_tpu_torch.engine.em import schedule_window, uniform_runs
    from prosper_tpu_torch.models import GSC, MCA, TSC
    from prosper_tpu_torch.models.base import device_sched, sched_floats
    from prosper_tpu_torch.ops import cuda_lib, gemm_cuda
    from prosper_tpu_torch.parallel.mesh import (COLLECTIVES, MeshRuntime,
                                                 init_multihost)

    model, em6, init = ref["model"], ref["em"], ref["init"]
    y_dev, y_host = ref["y_dev"], ref["y_host"]
    held_out, serve = ref["held_out"], ref["serve"]
    iters = len(em6.history)
    out = {"iterations": iters, "N": y_host.shape[0]}
    bad = []

    # ---- 22a: NCCL, one rank ----
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    init_multihost(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    rt = MeshRuntime(device=dev)
    if rt.backend != "nccl":
        raise AssertionError(f"[22a] the group's backend is {rt.backend}")

    def make(runtime=rt):
        return EM(model, patches_anneal(iters), {"y": y_dev}, params=init,
                  seed=4, device=None if runtime else dev, runtime=runtime)
    want = expected_all_reduces(patches_anneal(iters))
    reset_launches(cuda_lib)
    c0 = COLLECTIVES["all_reduce"]
    em = make()
    em.run()
    torch.cuda.synchronize()
    issued = COLLECTIVES["all_reduce"] - c0
    # the launches of the runs under the runtime, by kernel
    launches = dict(expect_launches(cuda_lib, "[22a] run", estep=iters,
                                    sgemm_nn=iters, sgemm_tn=iters))
    same_run(torch, "[22a] run under NCCL", em6, em)
    if issued != sum(want):
        bad.append(f"[22a] run issued {issued} all-reduces, the schedule "
                   f"gives {want}")
    n_eager, eager_names = nccl_kernels(torch, make().run)
    scanned, _ = scanned_path(torch, np, cuda_lib, "[22a] NCCL", em6, make,
                              init, 4, smi, estep=iters, sgemm_nn=iters,
                              sgemm_tn=iters)
    em_s = make()
    em_s.run_scanned()
    replayed = em_s.scan_stats["replayed_all_reduces"]
    # the replays: every iteration but the first of each pattern
    want_replayed = sum((hi - lo - 1) * want[lo] for lo, hi, _ in
                        uniform_runs(schedule_window(patches_anneal(iters),
                                                     iters)))
    if replayed != want_replayed:
        bad.append(f"[22a] the replays hold {replayed} all-reduces, "
                   f"expected {want_replayed}")

    def replays_only():
        em_s.anneal.reset(0)
        em_s.params = {k: v.clone() for k, v in init.items()}
        em_s.data = dict(em_s.data,
                         F_prev=torch.zeros_like(em_s.data["F_prev"]))
        em_s.generator.manual_seed(4)
        em_s.history.clear()
        em_s.run_scanned()
    n_replay, replay_names = nccl_kernels(torch, replays_only)
    same_run(torch, "[22a] replays under NCCL", em6, em_s)
    out["launches_under_runtime"] = launches
    out["nccl"] = {
        "all_reduces_per_iteration": want,
        "issued_by_run": issued, "held_by_replays": replayed,
        "expected_held_by_replays": want_replayed,
        "nccl_kernels_traced_run": n_eager,
        "nccl_kernels_traced_replays": n_replay,
        "nccl_kernels_per_iteration_replays": n_replay / iters,
        "nccl_kernel_names": sorted(set(eager_names + replay_names)),
        "run_scanned": scanned}
    reset_launches(cuda_lib)
    for dense in (False, True):
        got = model.inference(em6.params, held_out, top_L=10,
                              dense_states=dense, runtime=rt)
        torch.cuda.synchronize()
        for k, v in serve[dense].items():
            if not torch.equal(got[k], v):
                bad.append(f"[22a] inference(runtime=) {k} (dense {dense}) "
                           "differs from phase 6's")
    for k, v in expect_launches(cuda_lib, "[22a] inference", decode=2,
                                sgemm_nn=2).items():
        launches[k] += v
    streams = []
    for runtime in (None, rt):
        reset_launches(cuda_lib)
        sem = StreamingEM(model, patches_anneal(3), y_host, seg_size=65536,
                          params=init, seed=4, runtime=runtime,
                          device=None if runtime else dev)
        sem.run()
        torch.cuda.synchronize()
        got = expect_launches(cuda_lib, "[22a] StreamingEM", estep=6,
                              sgemm_nn=6, sgemm_tn=6)
        streams.append(sem)
    for k, v in got.items():
        launches[k] += v
    bad += same_stream(torch, "[22a] StreamingEM under NCCL", streams[0],
                       streams[1])
    # the max family's, the big-S and the GSC kernels under the runtime
    W_mca = planted_dictionary(256, 300, seed=0)
    for tag, fam, gt, kern in (
            ("mca", MCA(256, 300, 6, 3),
             {"W": W_mca, "pi": np.float32(2.0 / 300),
              "sigma": np.float32(1.0)},
             {"max_estep": 3, "sgemm_nn": 3, "sgemm_tn": 3}),
            ("tsc_bigs", TSC(64, 32, 10, 5, chunk=8192, s_block=1024),
             {"W": planted_dictionary(64, 32, seed=0), "pi": np.float32(0.1),
              "sigma": np.float32(1.0)}, {"bigs": 3}),
            ("gsc", GSC(256, 300, 6, 3, chunk=8192),
             {"W": W_mca, "pi": np.float32(2.0 / 300),
              "sigma": np.float32(1.0), "mu": np.float32(1.0),
              "psi": np.float32(0.25)},
             {"gsc_estep": 3, "sgemm_nn": 3, "sgemm_tn": 3})):
        data = fam.generate_data(gt, 32768, seed=1)
        p0 = fam.standard_init(data, seed=3, device=dev)
        y_fam = torch.as_tensor(data["y"], device=dev)
        pair = []
        for runtime in (None, rt):
            reset_launches(cuda_lib)
            em_f = EM(fam, patches_anneal(3), {"y": y_fam}, params=p0,
                      seed=4, runtime=runtime,
                      device=None if runtime else dev)
            em_f.run()
            torch.cuda.synchronize()
            got = expect_launches(cuda_lib, f"[22a] {tag}", **kern)
            pair.append(em_f)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        same_run(torch, f"[22a] {tag} under NCCL", pair[0], pair[1])
        del data, y_fam, pair
    # host ms an iteration, without and with the runtime, in turns
    times = {"none": {"run": [], "run_scanned": []},
             "nccl": {"run": [], "run_scanned": []}}
    for name in ("none", "nccl", "nccl", "none"):
        runtime = rt if name == "nccl" else None
        a = make(runtime)
        a.run()
        times[name]["run"].append(
            float(np.median([h["dt"] for h in a.history[1:]])) * 1e3)
        b = make(runtime)
        b.run_scanned()
        b.anneal.reset(0)
        b.params = {k: v.clone() for k, v in init.items()}
        b.generator.manual_seed(4)
        b.history.clear()
        b.run_scanned()
        times[name]["run_scanned"].append(b.history[-1]["dt"] * 1e3)
    out["host_ms_per_iteration"] = {n: {k: float(np.mean(v))
                                        for k, v in t.items()}
                                    for n, t in times.items()}
    out["host_ms_readings"] = times
    dist.destroy_process_group()
    log(f"[22a] NCCL, one rank: run, run_scanned (4 passes), inference of "
        f"8192 rows and StreamingEM (2 segments, 3 iterations) bit-identical "
        f"to the runs without a runtime; all-reduces per iteration {want}, "
        f"issued by run {issued}, held by {em_s.scan_stats['replays']} "
        f"replays {replayed}; NCCL kernels traced: run {n_eager}, replays "
        f"{n_replay} ({sorted(set(eager_names + replay_names))}); MCA, "
        f"big-S TSC and GSC (32768 rows, 3 iterations) bit-identical too; launches "
        f"under the runtime {launches}; host ms per iteration "
        f"{out['host_ms_per_iteration']}  [{smi}]")

    # ---- 22b: two gloo ranks on this card ----
    cut = in_memory_cut_as_segments(torch, np, model, patches_anneal(iters),
                                    y_host, y_host.shape[0] // 2, init, dev)
    W6 = em6.params["W"].cpu().numpy()
    tolerance = (float(np.abs(cut.params["W"].cpu().numpy() - W6).max())
                 / float(np.abs(W6).max()))
    p1 = model.noisify(init, device_sched(sched_floats(patches_anneal(iters)),
                                          dev),
                       torch.Generator(device=dev).manual_seed(4))
    f64 = bsc_sums_f64(torch, y_dev, torch.ones(y_dev.shape[0], device=dev),
                       p1["W"], p1["sigma"] ** 2, p1["pi"],
                       model.state_arrays(dev), 8, 0.5,
                       P32=lambda rows: gemm_cuda.sgemm_nn_cuda(rows,
                                                                p1["W"]))
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "y.npy"), y_host)
        np.save(os.path.join(tmp, "held_out.npy"), held_out["y"])
        np.savez(os.path.join(tmp, "init.npz"),
                 **{k: v.cpu().numpy() for k, v in init.items()})
        np.savez(os.path.join(tmp, "params6.npz"),
                 **{k: v.cpu().numpy() for k, v in em6.params.items()})
        res, wall = start_ranks("--rank22", tmp, "[22b]")
    for r in res:
        for k in em6.params:
            if not np.array_equal(r[f"p.{k}"], res[0][f"p.{k}"]):
                bad.append(f"[22b] {k} differs between the ranks")
        if float(r["reperr"]) != 0.0:
            bad.append(f"[22b] replication error {float(r['reperr'])}")
        want_l = {"estep": iters, "sgemm_nn": iters + 2,
                  "sgemm_tn": iters, "decode": 2}
        got_l = {k: int(r[f"launch.{k}"]) for k in cuda_lib.LAUNCHES}
        if got_l != {k: want_l.get(k, 0) for k in got_l}:
            bad.append(f"[22b] a rank's launches {got_l}, expected {want_l}")
        for k in ("n_used", "N_total"):
            if list(r[f"h.{k}"]) != [h[k] for h in em6.history]:
                bad.append(f"[22b] {k} {list(r[f'h.{k}'])}, phase 6's "
                           f"{[h[k] for h in em6.history]}")
        for k in em6.params:
            if not np.array_equal(r[f"p.{k}"], cut.params[k].cpu().numpy()):
                bad.append(f"[22b] {k} differs from phase 6's run cut as "
                           "the ranks' rows")
        for k in cut.history[0]:
            if k not in ("dt", "iteration", "T") and list(r[f"h.{k}"]) != [
                    h[k] for h in cut.history]:
                bad.append(f"[22b] {k} differs from phase 6's run cut as "
                           "the ranks' rows")
        if int(r["broadcasts"]) < 1:
            bad.append("[22b] the revival's broadcast did not run")
    first = against_f64(torch, np, {k: torch.as_tensor(res[0][f"s.{k}"])
                                     for k in f64},
                        {k: v.cpu() for k, v in f64.items()},
                        y_dev.shape[0])
    worst = max(v["ulps_sqrt_n"] for v in first.values())
    if worst > ULPS_SQRT_N:
        bad.append(f"[22b] the first step's sums are {worst:.3g} ulps x "
                   f"sqrt(N) off the float64 sums: {first}")
    drift = {k: {"max_abs_diff": float(np.abs(
        res[0][f"p.{k}"] - em6.params[k].cpu().numpy()).max()),
        "max_abs": float(np.abs(em6.params[k].cpu().numpy()).max())}
        for k in em6.params}
    rel = drift["W"]["max_abs_diff"] / drift["W"]["max_abs"]
    if rel > tolerance:
        bad.append(f"[22b] W is {rel:.3g} (relative to max |W|) off phase "
                   f"6's, above the sensitivity {tolerance:.3g}")
    for dense in (False, True):
        for k, v in serve[dense].items():
            got = np.concatenate([r[f"d{int(dense)}.{k}"] for r in res])
            if not np.array_equal(got, v.cpu().numpy()):
                bad.append(f"[22b] the two ranks' decode {k} (dense "
                           f"{dense}) differs from phase 6's")
    out["gloo_two_ranks"] = {
        "rows_per_rank": [int(r["rows"]) for r in res],
        "replication_error": [float(r["reperr"]) for r in res],
        "launches_per_rank": {k: int(res[0][f"launch.{k}"])
                              for k in cuda_lib.LAUNCHES},
        "revival_broadcasts": int(res[0]["broadcasts"]),
        "first_step_sums_against_f64": first,
        "params_against_phase6": drift, "W_rel": rel,
        "tolerance_sensitivity_131072": tolerance,
        "sensitivity_1e6": sensitivity_1e6,
        "equals_phase6_cut_as_ranks": not any("cut as" in b for b in bad),
        "host_ms_per_iteration": [float(r["ms"]) for r in res],
        "wall_s": wall}
    log(f"[22b] gloo, two ranks on one card, {out['gloo_two_ranks']['rows_per_rank']} "
        f"rows: replication error {out['gloo_two_ranks']['replication_error']}"
        f", launches per rank {out['gloo_two_ranks']['launches_per_rank']}, "
        f"n_used and N_total as phase 6's; first step's sums against float64 "
        f"{first}; equal to phase 6's run cut as the ranks' rows bit for "
        f"bit: {out['gloo_two_ranks']['equals_phase6_cut_as_ranks']}; W off "
        f"phase 6's by {rel:.3g} of max |W| (the sensitivity at N=131072 "
        f"{tolerance:.3g}, at 10^6 {sensitivity_1e6:.3g}); decode "
        f"concatenated = phase 6's; host ms per "
        f"iteration {out['gloo_two_ranks']['host_ms_per_iteration']}, "
        f"{wall:.1f} s wall with the start of both processes  [{smi}]")
    if bad:
        raise AssertionError("[22] " + "; ".join(bad))
    return out


def rank22(rank: int, port: int, tmp: str) -> int:
    """One rank of phase 22b (``python3 chip_smoke.py --rank22 R PORT DIR``,
    started by ``distributed_path``): its ``stride_data`` rows of DIR's
    y.npy through phase 6's run under a two-rank gloo group on cuda:0."""
    import os

    import numpy as np
    import torch

    from prosper_tpu_torch import EM
    from prosper_tpu_torch.models import BSC
    from prosper_tpu_torch.models import linear as linear_mod
    from prosper_tpu_torch.ops import cuda_lib
    from prosper_tpu_torch.parallel.mesh import (MeshRuntime, init_multihost,
                                                 replication_error,
                                                 stride_data)

    dev = torch.device("cuda", 0)
    init_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo", device=dev)
    rt = MeshRuntime(device=dev)
    y = np.load(os.path.join(tmp, "y.npy"), mmap_mode="r")
    first, last = stride_data(y.shape[0])
    y_mine = torch.as_tensor(np.ascontiguousarray(y[first:last]), device=dev)
    init = dict(np.load(os.path.join(tmp, "init.npz")))
    model = BSC(256, 300, 8, 4, chunk=8192)
    sums = {}
    real = linear_mod.reduce_sums

    def first_sums(*args):
        out = real(*args)
        if not sums:
            sums.update({k: v.double().cpu().numpy()
                         for k, v in out[0].items()})
        return out
    linear_mod.reduce_sums = first_sums
    broadcasts = []
    real_b = EM._bcast_revived_W

    def counted(self, W, revived):
        broadcasts.append(revived)
        return real_b(self, W, revived)
    EM._bcast_revived_W = counted
    for k in cuda_lib.LAUNCHES:
        cuda_lib.LAUNCHES[k] = 0
    em = EM(model, patches_anneal(), {"y": y_mine}, params=init, seed=4,
            runtime=rt, revive_duplicates=(2, 1.01))
    em.run()
    torch.cuda.synchronize()
    p6 = {k: torch.as_tensor(v, device=dev)
          for k, v in np.load(os.path.join(tmp, "params6.npz")).items()}
    held = np.load(os.path.join(tmp, "held_out.npy"))
    a, b = stride_data(held.shape[0])
    out = {f"p.{k}": v.cpu().numpy() for k, v in em.params.items()}
    for dense in (False, True):
        d = model.inference(p6, {"y": held[a:b]}, top_L=10,
                            dense_states=dense, runtime=rt)
        out.update({f"d{int(dense)}.{k}": v.cpu().numpy()
                    for k, v in d.items()})
    torch.cuda.synchronize()
    out.update({f"s.{k}": v for k, v in sums.items()})
    out.update({f"launch.{k}": v for k, v in cuda_lib.LAUNCHES.items()})
    out["reperr"] = float(replication_error(em.params, rt.group))
    out.update({f"h.{k}": np.asarray([h[k] for h in em.history])
                for k in em.history[0] if k not in ("dt", "iteration", "T")})
    out["broadcasts"] = len(broadcasts)
    out["rows"] = last - first
    out["ms"] = float(np.median([h["dt"] for h in em.history[1:]])) * 1e3
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    return 0


# ---- 23. state sharding: a ("data", "state") mesh of two gloo ranks ---------


def pad_states(tables, s_block):
    """``bigs_multi``'s operands (proj, Gf, then six state tables) with the
    state tables padded by zero rows, of ``valid`` 0, to a multiple of
    ``s_block``."""
    import torch
    S = tables[2].shape[0]
    pad = -S % s_block
    return tables[:2] + tuple(
        torch.nn.functional.pad(t, (0, 0, 0, pad) if t.dim() == 2
                                else (0, pad)) for t in tables[2:])


def first_step_params(torch, dev, model, init, patches_anneal):
    """The noisified parameters and the schedule of the first iteration of
    ``EM(..., seed=4)`` from ``init`` under phase 6's schedule."""
    from prosper_tpu_torch.models.base import device_sched, sched_floats
    host = sched_floats(patches_anneal(6))
    sched = device_sched(host, dev)
    p1 = model.noisify(init, sched,
                       torch.Generator(device=dev).manual_seed(4))
    return p1, host["beta"], host["prior_beta"]


def state_slices(torch, np, dev, smi, err, run12, patches_anneal):
    """23c, in this process: phase 12's first E-step's operands cut as the
    two state ranks' slices of the kernel's layout (``ceil(S / 2)`` = 6282
    states each): ``bigs_multi_cuda`` on each unpadded slice against
    ``core.etstep.bigs_multi`` on the slice padded to s_block = 1024
    (phase 11's tolerances); a slice of padding alone (state rank 15 of 16
    in the plain layout at s_block = 1024) gives ``empty_moments`` through
    both, bit for bit, the kernel without a launch; the kernel timed on
    state rank 0's 6282 states against the plain version."""
    from prosper_tpu_torch.core import etstep
    from prosper_tpu_torch.ops import bigs_cuda, cuda_lib
    model, y = run12["model"], run12["y_dev"]
    p1, beta, prior_beta = first_step_params(torch, dev, model,
                                             run12["init"], patches_anneal)
    W, sa, Hp = p1["W"], model.state_arrays(dev), model.Hprime
    gram = W.T @ W
    front = (y, W, gram, torch.diagonal(gram), model.log_odds(p1), sa, Hp,
             True)
    scal = (0.5 / p1["sigma"] ** 2, beta, prior_beta)
    S, K = sa.value_counts.shape
    args = {}
    for srank in (0, 1):
        lo, hi, _ = etstep.state_slice(S, 2, srank)
        kt = etstep.bigs_front(*front, 1, shard=(srank, 2))[2]
        args[srank] = (kt, hi - lo, pad_states(kt, 1024))
        on = bigs_cuda.bigs_multi_cuda(*kt, *scal, 1, n_states=hi - lo)
        ref = etstep.bigs_multi(*args[srank][2], *scal, 1024)
        torch.cuda.synchronize()
        for i, field in enumerate(("m", "l", "m_t", "l_t", "a_abs", "a_s",
                                   "a_ss", "a_vc")):
            tol = 1e-4 if field in ("m", "m_t") else 1e-3
            torch.testing.assert_close(on[i], ref[i], rtol=tol, atol=tol,
                                       msg=f"[23c] state rank {srank} "
                                           f"{field}")
            err["bigs"] = max(err["bigs"], (on[i] - ref[i]).abs().max().item())
    pt = etstep.bigs_front(*front, 1024, shard=(15, 16))[2]
    reset_launches(cuda_lib)
    empty = bigs_cuda.bigs_multi_cuda(*pt, *scal, 1024, n_states=0)
    expect_launches(cuda_lib, "[23c] a slice of padding alone")
    for a, b, c in zip(empty, etstep.bigs_multi(*pt, *scal, 1024),
                       bigs_cuda.empty_moments(y.shape[0], Hp, K, dev)):
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise AssertionError("[23c] a slice of padding alone differs "
                                 "from empty_moments")
    kt, n0, pt0 = args[0]
    ms = interleaved_ms(
        torch, lambda: etstep.bigs_multi(*pt0, *scal, 1024),
        lambda: bigs_cuda.bigs_multi_cuda(*kt, *scal, 1, n_states=n0),
        reps=3)
    out = {"states_per_rank": n0, "ms": ms[0], "plain_ms": ms[1],
           **bigs_bound(y.shape[0], n0, Hp, K)}
    log(f"[23c] the big-S kernel on each state rank's slice ({n0} states, "
        f"N={y.shape[0]}) agrees with the plain version on it; a slice of "
        f"padding alone gives empty_moments through both, no launch; "
        f"kernel {ms[0]:.3f} ms vs plain {ms[1]:.3f} ms, bound "
        f"{out['bound_ms']:.3f} ms  [{smi}]")
    return out


def state_path(torch, np, dev, smi, err, p6, run12, patches_anneal):
    """Phase 23: state sharding on the card.  23c in this process
    (``state_slices``); then this script started twice (``--rank23 R PORT
    DIR``), two gloo ranks on cuda:0 as the (1, 2) ``("data", "state")``
    mesh (NCCL refuses two ranks on one device): 23a phase 12's big-S TSC
    run and 23b phase 6's BSC patches run (S = 154, s_block = 0) through
    ``EM.run`` on all their rows, each rank on its half of the states
    through the big-S kernel alone; 23d MCA with ``backend="cuda"`` under
    the state axis raises.  Each run against the one-process run of the
    kernel path it takes (phase 12's run; for 23b phase 6's model with
    s_block > 0, the big-S kernel over all 154 states, run here): the
    parameters replicated exactly, the first E-step's F the same bits on
    both ranks and within rtol 1e-4 of the one-process E-step's (phase 11's
    tolerance), its sums within ``ULPS_SQRT_N`` ulps x sqrt(N) of float64
    sums of the same step (22b's measure; the one-process E-step's own
    reading beside it), Q_mean after the run within
    tests/test_state_sharding.py's tolerance of the one-process run's
    (2e-3; 1e-3 for big S), and W within the larger of that file's 2e-3
    (of max |W|) and twice the schedule's sensitivity to float32
    arithmetic, measured here on the one-process run: against itself cut
    into two row chunks (22b's measure) and against the plain version's
    run (each row's arithmetic in another order, as a state slice's
    combine changes it; at the patches width the schedule carries that to
    1.6e-3 of max |W| in 6 iterations, PERF.md).  23b is reported
    against phase 6's run (the rows kernel, its projection by the split-TF32
    GEMM) too.  Returns the numbers for the ``state`` line."""
    import os
    import tempfile

    from prosper_tpu_torch import EM
    from prosper_tpu_torch.models import BSC
    from prosper_tpu_torch.ops import cuda_lib, linear_cuda
    out, bad = {"slices": state_slices(torch, np, dev, smi, err, run12,
                                       patches_anneal)}, []
    bsc_bigs = BSC(256, 300, 8, 4, chunk=8192, s_block=1024)
    em_b = EM(bsc_bigs, patches_anneal(6),
              {"y": torch.as_tensor(p6["y_host"], device=dev)},
              params=p6["init"], seed=4, device=dev)
    em_b.run()
    # tag: (the ranks' model, the one-process model of the same kernel
    # path and its run, init, rows, class, Q_mean's rtol)
    runs = {"a": (run12["model"], run12["model"], run12["em"],
                  run12["init"], run12["y_host"], "TSC", 1e-3),
            "b": (p6["model"], bsc_bigs, em_b, p6["init"], p6["y_host"],
                  "BSC", 2e-3)}
    refs = {}
    for tag, (_, model, em1, init, y_host, _, _) in runs.items():
        y = torch.as_tensor(y_host, device=dev)
        w = torch.ones(y.shape[0], device=dev)
        p1, beta, prior_beta = first_step_params(torch, dev, model, init,
                                                 patches_anneal)
        sa = model.state_arrays(dev)
        eargs = (y, w, p1["W"], p1["sigma"] ** 2, model.log_odds(p1), sa,
                 model.Hprime, model.signed_select, beta, prior_beta)
        F1, s1 = linear_cuda.linear_et_estep(*eargs, s_block=model.s_block)
        f64 = linear_sums_f64(torch, *eargs, chunk=8192,
                              P32=lambda rows: rows @ p1["W"])
        cut = in_memory_cut_as_segments(torch, np, model, patches_anneal(6),
                                        y_host, y_host.shape[0] // 2, init,
                                        dev)
        plain = EM(type(model)(model.D, model.H, model.Hprime, model.gamma,
                               chunk=model.chunk, s_block=model.s_block,
                               backend="plain"), patches_anneal(6),
                   {"y": y}, params=init, seed=4, device=dev)
        plain.run()
        W1 = em1.params["W"]

        def drift(run):
            return ((run.params["W"] - W1).abs().max()
                    / W1.abs().max()).item()
        refs[tag] = {
            "F1": F1.cpu().numpy(),
            "f64": {k: v.cpu() for k, v in f64.items()},
            "one_process_sums_against_f64": against_f64(
                torch, np, s1, f64, y.shape[0]),
            "sensitivity": drift(cut), "plain_drift": drift(plain)}
        del y, w, cut, plain
    with tempfile.TemporaryDirectory() as tmp:
        cfg = {"device": "cuda:0", "iters": 6, "mca": [16, 12, 5, 3]}
        for tag, (model, _, _, init, y_host, cls, _) in runs.items():
            np.save(os.path.join(tmp, f"y_{tag}.npy"), y_host)
            np.savez(os.path.join(tmp, f"init_{tag}.npz"),
                     **{k: v.cpu().numpy() for k, v in init.items()})
            cfg[tag] = {"cls": cls, "args": [model.D, model.H, model.Hprime,
                                             model.gamma],
                        "kw": {"chunk": model.chunk,
                               "s_block": model.s_block}}
        with open(os.path.join(tmp, "cfg.json"), "w") as f:
            json.dump(cfg, f)
        res, wall = start_ranks("--rank23", tmp, "[23]")
    chunks_b = len(cuda_lib.row_chunks(p6["y_host"].shape[0],
                                       8 * p6["model"].H))
    want_l = {"a": {"bigs": 6}, "b": {"bigs": 6 * chunks_b}}
    for tag, (_, _, em1, _, _, cls, q_rtol) in runs.items():
        ref = refs[tag]
        for rank, r in enumerate(res):
            if tuple(r["coords"]) != (0, rank):
                bad.append(f"[23{tag}] rank {rank}'s coordinates "
                           f"{r['coords']}")
            for k in em1.params:
                if not np.array_equal(r[f"{tag}.p.{k}"], res[0][f"{tag}.p.{k}"]):
                    bad.append(f"[23{tag}] {k} differs between the ranks")
            if float(r[f"{tag}.reperr"]) != 0.0:
                bad.append(f"[23{tag}] replication error "
                           f"{float(r[f'{tag}.reperr'])}")
            got_l = {k: int(r[f"{tag}.launch.{k}"]) for k in cuda_lib.LAUNCHES}
            if got_l != {k: want_l[tag].get(k, 0) for k in got_l}:
                bad.append(f"[23{tag}] a rank's launches {got_l}, expected "
                           f"{want_l[tag]} and nothing else")
            if not np.array_equal(r[f"{tag}.F1"], res[0][f"{tag}.F1"]):
                bad.append(f"[23{tag}] the first step's F differs between "
                           "the ranks")
        F1 = res[0][f"{tag}.F1"]
        F_err = float(np.abs(F1 - ref["F1"]).max())
        if not np.allclose(F1, ref["F1"], rtol=1e-4, atol=1e-4):
            bad.append(f"[23{tag}] the first step's F is {F_err:.3g} off the "
                       "one-process E-step's")
        first = against_f64(torch, np, {k: torch.as_tensor(
            res[0][f"{tag}.s.{k}"]) for k in ref["f64"]}, ref["f64"],
            F1.shape[0])
        worst = max(v["ulps_sqrt_n"] for v in first.values())
        if worst > ULPS_SQRT_N:
            bad.append(f"[23{tag}] the first step's sums are {worst:.3g} "
                       f"ulps x sqrt(N) off the float64 sums: {first}")
        W1 = em1.params["W"].cpu().numpy()
        W2 = res[0][f"{tag}.p.W"]
        W_rel = float(np.abs(W2 - W1).max() / np.abs(W1).max())
        W_tol = max(2e-3, 2 * ref["sensitivity"], 2 * ref["plain_drift"])
        if W_rel > W_tol:
            bad.append(f"[23{tag}] W is {W_rel:.3g} of max |W| off the "
                       f"one-process run's, above {W_tol:.3g}")
        q1 = np.asarray([h["Q_mean"] for h in em1.history])
        q2 = res[0][f"{tag}.h.Q_mean"]
        if not np.allclose(q2, q1, rtol=q_rtol, atol=0.0):
            bad.append(f"[23{tag}] Q_mean {list(q2)}, the one-process run's "
                       f"{list(q1)}")
        out[tag] = {
            "model": f"{cls}{tuple(cfg[tag]['args'])}",
            "launches_per_rank": {k: int(res[0][f"{tag}.launch.{k}"])
                                  for k in cuda_lib.LAUNCHES},
            "replication_error": [float(r[f"{tag}.reperr"]) for r in res],
            "first_step_F_max_abs_diff": F_err,
            "first_step_sums_against_f64": first,
            "one_process_sums_against_f64":
                ref["one_process_sums_against_f64"],
            "W_max_abs_diff": float(np.abs(W2 - W1).max()),
            "W_rel": W_rel, "W_tolerance": W_tol,
            "sensitivity_two_row_chunks": ref["sensitivity"],
            "plain_version_drift": ref["plain_drift"],
            "Q_mean_max_rel_diff": float(np.max(np.abs(q2 - q1)
                                                / np.abs(q1))),
            "n_used_equal": list(res[0][f"{tag}.h.n_used"])
            == [h["n_used"] for h in em1.history],
            "host_ms_per_iteration": [float(r[f"{tag}.ms"]) for r in res],
            "one_process_host_ms_per_iteration": float(np.median(
                [h["dt"] for h in em1.history[1:]])) * 1e3}
        if tag == "b":
            W6 = p6["em"].params["W"].cpu().numpy()
            out[tag]["phase6_rows_kernel"] = {
                "W_rel": float(np.abs(W2 - W6).max() / np.abs(W6).max()),
                "host_ms_per_iteration": float(np.median(
                    [h["dt"] for h in p6["em"].history[1:]])) * 1e3}
        log(f"[23{tag}] {out[tag]['model']} on the (1, 2) mesh: launches "
            f"per rank {out[tag]['launches_per_rank']}, replication error "
            f"{out[tag]['replication_error']}, the first step's F "
            f"{F_err:.3g} off the one-process E-step's, its sums against "
            f"float64 {first} (the one-process E-step's "
            f"{ref['one_process_sums_against_f64']}); after the run W "
            f"{out[tag]['W_rel']:.3g} of max |W| off the one-process run's "
            f"(the schedule's sensitivity {ref['sensitivity']:.3g}; the "
            f"plain version's run {ref['plain_drift']:.3g} off), Q_mean "
            f"{out[tag]['Q_mean_max_rel_diff']:.3g}, n_used equal "
            f"{out[tag]['n_used_equal']}; host ms per iteration "
            f"{out[tag]['host_ms_per_iteration']} against "
            f"{out[tag]['one_process_host_ms_per_iteration']:.3f} in one "
            f"process; against phase 6's run (the rows kernel): "
            f"{out[tag].get('phase6_rows_kernel', 'n/a')}  [{smi}]")
    if not all(bool(r["d"]) for r in res):
        bad.append('[23d] MCA with backend="cuda" under the state axis did '
                   'not raise the ValueError naming backend="plain"')
    out["d_raised"] = all(bool(r["d"]) for r in res)
    out["wall_s"] = wall
    log(f"[23d] MCA with backend=\"cuda\" under the state axis raised the "
        f"ValueError on both ranks: {out['d_raised']}; phase 23's two "
        f"processes took {wall:.1f} s with their start")
    if bad:
        raise AssertionError("[23] " + "; ".join(bad))
    return out


def start_ranks(flag, tmp, tag, n=2):
    """This script started ``n`` times (``flag R PORT DIR``), the ranks of
    one gloo group on the card; their results (``rank{R}.npz`` in DIR)
    and the wall seconds.  A rank that fails fails the phase."""
    import os

    import numpy as np
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, __file__, flag, str(r), str(port), tmp], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{tag} rank {r} failed ({p.returncode}):"
                                 f"\n{text[-6000:]}")
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
            for r in range(n)], wall


def rank23(rank: int, port: int, tmp: str) -> int:
    """One rank of phase 23 (``python3 chip_smoke.py --rank23 R PORT DIR``,
    started by ``state_path``): the (1, 2) ``("data", "state")`` mesh of
    two gloo ranks on DIR's device (cfg.json); 23a and 23b through
    ``EM.run`` on all of DIR's rows, each rank on its half of the states,
    with their first E-step's F and sums kept; 23d MCA with
    ``backend="cuda"`` under the state axis."""
    import os

    import numpy as np
    import torch

    from prosper_tpu_torch import EM, models
    from prosper_tpu_torch.models import linear as linear_mod
    from prosper_tpu_torch.models.base import device_sched, sched_floats
    from prosper_tpu_torch.ops import cuda_lib
    from prosper_tpu_torch.parallel.mesh import (MeshRuntime, init_multihost,
                                                 replication_error)

    with open(os.path.join(tmp, "cfg.json")) as f:
        cfg = json.load(f)
    dev = torch.device(cfg["device"])
    init_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo", device=dev)
    rt = MeshRuntime(device=dev, mesh_shape=(1, 2),
                     axis_names=("data", "state"))
    out = {"coords": np.asarray([rt.data_index, rt.state_index])}
    first = {}
    real = linear_mod.reduce_sums

    def first_sums(*args):
        res = real(*args)
        if not first:
            first.update({k: v.double().cpu().numpy()
                          for k, v in res[0].items()})
        return res
    linear_mod.reduce_sums = first_sums
    for tag in ("a", "b"):
        spec = cfg[tag]
        model = getattr(models, spec["cls"])(*spec["args"], **spec["kw"])
        y = torch.as_tensor(np.load(os.path.join(tmp, f"y_{tag}.npy")),
                            device=dev)
        init = dict(np.load(os.path.join(tmp, f"init_{tag}.npz")))
        first.clear()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        for k in cuda_lib.LAUNCHES:
            cuda_lib.LAUNCHES[k] = 0
        em = EM(model, patches_anneal(cfg["iters"]), {"y": y}, params=init,
                seed=4, runtime=rt)
        em.step_once()
        out[f"{tag}.F1"] = em.data["F_prev"].cpu().numpy()
        em.run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out.update({f"{tag}.launch.{k}": v
                    for k, v in cuda_lib.LAUNCHES.items()})
        out.update({f"{tag}.p.{k}": v.cpu().numpy()
                    for k, v in em.params.items()})
        out.update({f"{tag}.s.{k}": v for k, v in first.items()})
        out[f"{tag}.reperr"] = float(replication_error(em.params, rt.group))
        out.update({f"{tag}.h.{k}": np.asarray([h[k] for h in em.history])
                    for k in ("Q_mean", "n_used")})
        out[f"{tag}.ms"] = float(np.median([h["dt"]
                                            for h in em.history[1:]])) * 1e3
        del em, y
    mca = models.MCA(*cfg["mca"], backend="cuda")
    y = torch.randn((64, mca.D), generator=torch.Generator().manual_seed(0))
    p = mca.standard_init({"y": y}, device=dev)
    try:
        mca.estep_sums(p, y.to(dev), torch.ones(64, device=dev),
                       device_sched(sched_floats(patches_anneal(6)), dev),
                       state_axis=rt.state_group, n_state_shards=2)
        out["d"] = False
    except ValueError as e:
        out["d"] = 'backend="plain"' in str(e)
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    return 0


def bound_16bit(flops, nbytes):
    """``bound`` for a product of ``flops`` in one pass of the tensor cores
    at the 16-bit (bf16 and fp16) peak."""
    t_ops, t_bytes = flops / PEAK_16BIT_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def hgemm_phase(torch, np, dev, smi, err):
    """Phase 24a: the two 16-bit GEMM kernels (``compute_dtype``) against
    their plain version, the float64 product of the operands rounded to the
    type, at the shapes of ``gemm_phase``, bf16 and fp16: exactly on inputs
    quantised to 1/4 (exact in either type), within rtol 1e-5 / atol 2e-7
    per unit of depth on Gaussian ones and more than 1e-4 (of the largest
    entry) away from the unrounded product there, repeated calls
    bit-identical, the tn kernel's ``accumulate`` too.  hgemm_tn_splitn's
    two kernels (``gemm_cuda.hgemm_tn_bulk``): the shapes take both, and
    at the main path's shape operands moved off their 16-byte alignment
    take the cp.async kernel, which must give the bulk-copy kernel's bits;
    one-hot rows of y and sw, each (p, q) in one row with y's entry naming
    p (or sw's naming q), must put every name where it belongs.  Then their
    times at 131072 and 8192 rows beside the plain version on the card
    (``matmul_as``: the rounding, then a float32 ``torch.matmul``), the
    library call ``torch.mm(a.to(dt), b.to(dt), out_dtype=torch.float32)``
    with its casts (where the card's torch has ``aten::mm.dtype``) and the
    bound of one 16-bit pass; the HGMMA of their SASS, and in the bulk-copy
    kernel's the design: tensor copies (UTMALDG) and every HGMMA reading
    both operands from shared memory.  Returns each kernel's entries for
    the JSON line."""
    from prosper_tpu_torch.core.etstep import matmul_as
    from prosper_tpu_torch.ops import cuda_lib, gemm_cuda

    hnn, htn = gemm_cuda.hgemm_nn_cuda, gemm_cuda.hgemm_tn_splitn_cuda
    paths = gemm_cuda.HGEMM_TN_PATHS
    for k in paths:
        paths[k] = 0
    halves = (("bf16", torch.bfloat16), ("fp16", torch.float16))
    gen = torch.Generator(device=dev).manual_seed(24)
    share = {"hgemm_nn": 0.0, "hgemm_tn": 0.0}
    shapes = [(131072, 256, 300)] + [(N, D, H) for N in (1000, 16385)
                                     for D in (25, 256) for H in (10, 300)]
    for N, D, H in shapes:
        for quantised in (True, False):
            def draw(*shape):
                a = torch.randn(shape, generator=gen, device=dev)
                return torch.round(a * 4) / 4 if quantised else a
            y, W, sw, base = draw(N, D), draw(D, H), draw(N, H), draw(D, H)
            y[3] = 0.0                                  # a row of zeros
            exact_nn = y.double() @ W.double()
            exact_tn = y.double().T @ sw.double()
            for tag, dt in halves:
                ry, rW, rsw = (t.to(dt).double() for t in (y, W, sw))
                ref_tn = ry.T @ rsw
                for name, out, again, ref, exact, depth in (
                        ("hgemm_nn", hnn(y, W, dt), hnn(y, W, dt), ry @ rW,
                         exact_nn, D),
                        ("hgemm_tn", htn(y, sw, dt), htn(y, sw, dt), ref_tn,
                         exact_tn, N),
                        ("hgemm_tn", htn(y, sw, dt, out=base.clone(),
                                         accumulate=True),
                         htn(y, sw, dt, out=base.clone(), accumulate=True),
                         base.double() + ref_tn, base.double() + exact_tn,
                         N)):
                    what = f"{name} {tag} {N}x{D}x{H}"
                    e, used = gemm_check(torch, what, out, again, ref,
                                         quantised, depth)
                    err[name] = max(err[name], e)
                    if quantised:
                        continue
                    off = ((out.double() - exact).abs().max()
                           / exact.abs().max()).item()
                    if off <= 1e-4:
                        raise AssertionError(f"{what}: only {off:.3g} away "
                                             "from the unrounded product")
                    share[name] = max(share[name], used)
                    log(f"[24a] {what} on Gaussian inputs: max abs error "
                        f"{e:.3e}, {100 * used:.1f} % of the tolerance; "
                        f"{off:.3g} of max |ref| off the unrounded product")
    log(f"[24a] hgemm_nn and hgemm_tn_splitn (bf16, fp16) agree with the "
        f"float64 product of the rounded operands at {len(shapes)} shapes "
        "(exactly on quantised inputs; repeated calls bit-identical)")
    shape_paths = dict(paths)
    if min(shape_paths.values()) < 1:
        raise AssertionError(f"[24a] the shapes did not take both of "
                             f"hgemm_tn_splitn's kernels: {shape_paths}")
    N, D, H = shapes[0]
    y, sw = (torch.randn(s, generator=gen, device=dev)
             for s in ((N, D), (N, H)))
    for tag, dt in halves:
        before = dict(paths)
        bulk = htn(y, sw, dt)
        off = htn(off_alignment(torch, y), sw, dt)
        torch.cuda.synchronize()
        if paths != dict(before, bulk=before["bulk"] + 1,
                         cp_async=before["cp_async"] + 1):
            raise AssertionError(f"[24a] {tag}: the dispatch took {paths}")
        if not torch.equal(bulk, off):
            raise AssertionError(f"[24a] {tag}: the bulk-copy and cp.async "
                                 "kernels differ at the main path's shape")
        for P, Q in ((D, H), (H, D)):
            one_hot_names(torch, dev, gen, htn, dt, P, Q, f"[24a] {tag}")
    log(f"[24a] hgemm_tn_splitn's dispatch: {shape_paths} calls at the "
        f"shapes above; at {N}x{D}x{H} the cp.async kernel (operands off "
        "their 16-byte alignment) gives the bulk-copy kernel's bits; one-hot "
        "rows name every (p, q) right at 256x300 and 300x256 (bf16, fp16)")

    sass = gemm_sass(("hgemm_nn", "hgemm_tn"), ops=True)
    design = {}
    if sass["hgemm_tn"] is not None:
        design = {fn: c for fn, c in sass["hgemm_tn"].items()
                  if "htn_bulk_kernel" in fn}
        if len(design) != 2 or any(
                c.get("HGMMA", 0) < 1 or c.get("UTMALDG", 0) < 1
                or c.get("HGMMA_SMEM_A", 0) != c["HGMMA"]
                for c in design.values()):
            raise AssertionError(f"[24a] the bulk-copy kernel's SASS lacks "
                                 f"its design: {design}")
        log(f"[24a] SASS of the bulk-copy kernel: tensor copies (UTMALDG) "
            f"and HGMMA with both operands from shared memory: {design}")
        sass = {k: {fn: c.get("HGMMA", 0) for fn, c in v.items()}
                for k, v in sass.items()}
    mm_dtype = "dtype" in torch.ops.aten.mm.overloads()
    if not mm_dtype:
        log("[24a] this torch has no aten::mm.dtype (torch.mm with "
            "out_dtype): no library time")
    out = {"hgemm_nn": {}, "hgemm_tn": {}}
    for N in (131072, 8192):          # the main path's rows; a decode's
        D, H = 256, 300
        y, W, sw = (torch.randn(s, generator=gen, device=dev)
                    for s in ((N, D), (D, H), (N, H)))
        flops = 2.0 * N * D * H
        b = bound_16bit(flops, 4.0 * (N * D + D * H + N * H))
        for tag, dt in halves:
            nn = interleaved_ms(torch, lambda: matmul_as(y, W, dt),
                                lambda: hnn(y, W, dt), reps=10)
            tn = interleaved_ms(torch, lambda: matmul_as(y.T, sw, dt),
                                lambda: htn(y, sw, dt), reps=10)
            lib = ((cuda_ms(torch, lambda: torch.mm(
                       y.to(dt), W.to(dt), out_dtype=torch.float32), 10),
                    cuda_ms(torch, lambda: torch.mm(
                        y.T.to(dt), sw.to(dt), out_dtype=torch.float32), 10))
                   if mm_dtype else (None, None))
            log(f"[24a] {tag} N={N}, D={D}, H={H}: hgemm_nn {nn[0]:.3f} ms "
                f"({flops / nn[0] / 1e9:.1f} TFLOP/s), plain {nn[1]:.3f}, "
                f"torch.mm {lib[0]} ms; hgemm_tn_splitn {tn[0]:.3f} ms "
                f"({flops / tn[0] / 1e9:.1f} TFLOP/s), plain {tn[1]:.3f}, "
                f"torch.mm {lib[1]} ms; bound of one 16-bit pass "
                f"{b['bound_ms']:.3f} ms by {b['bound_by']} (hgemm_nn "
                f"{100 * b['bound_ms'] / nn[0]:.1f} %, hgemm_tn_splitn "
                f"{100 * b['bound_ms'] / tn[0]:.1f} % of it)  [{smi}]")
            for name, t, lt in (("hgemm_nn", nn, lib[0]),
                                ("hgemm_tn", tn, lib[1])):
                if N == 131072 and tag == "bf16":
                    out[name].update({"ms": t[0], "plain_ms": t[1],
                                      "library_ms": lt, **b,
                                      "tolerance_share": share[name],
                                      "sass": sass[name]})
                    if name == "hgemm_tn":
                        # the cp.async kernel, on y moved off its alignment
                        yo = off_alignment(torch, y)
                        cp_ms = cuda_ms(torch, lambda: htn(yo, sw, dt), 10)
                        log(f"[24a] bf16 N={N}: hgemm_tn_splitn's cp.async "
                            f"kernel {cp_ms:.3f} ms, its bulk-copy kernel "
                            f"{t[0]:.3f} ms  [{smi}]")
                        out[name].update({
                            "cp_async_ms": cp_ms,
                            "smem_bytes": cuda_lib.load_library()
                            .hgemm_tn_bulk_smem_bytes(),
                            "paths_at_24a_shapes": shape_paths,
                            "sass_design": design})
                else:
                    sfx = tag if N == 131072 else f"{tag}_{N}_rows"
                    out[name].update({f"ms_{sfx}": t[0],
                                      f"plain_ms_{sfx}": t[1],
                                      f"library_ms_{sfx}": lt})
                    if tag == "bf16":
                        out[name][f"bound_ms_{N}_rows"] = b["bound_ms"]
    return out


def off_alignment(torch, t):
    """A contiguous copy of ``t`` whose data start 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def one_hot_names(torch, dev, gen, htn, dt, P, Q, tag):
    """The permutation check of hgemm_tn_splitn at (P, Q): P * Q rows in a
    random order, row (p, q) with one nonzero in y (column p) and one in sw
    (column q), so that entry (p, q) of y^T sw is the product of the two;
    once y's entry names p (sw's is 1), once sw's names q.  Names are
    p + 1 (fp16: exact to 2048) or p % 256 + 1 (bf16: exact to 256); a
    wrong offset in a layout puts a wrong name somewhere."""
    n = P * Q
    rows = torch.randperm(n, device=dev, generator=gen)
    idx = torch.arange(n, device=dev)
    p, q = idx // Q, idx % Q
    cap = 256 if dt == torch.bfloat16 else n
    for which, name in (("p", (p % cap + 1).float()),
                        ("q", (q % cap + 1).float())):
        y = torch.zeros(n, P, device=dev)
        sw = torch.zeros(n, Q, device=dev)
        y[rows, p] = name if which == "p" else 1.0
        sw[rows, q] = name if which == "q" else 1.0
        want = torch.zeros(P, Q, device=dev)
        want[p, q] = name
        got = htn(y, sw, dt)
        torch.cuda.synchronize()
        bad = (got != want).nonzero()
        if len(bad):
            pp, qq = bad[0].tolist()
            raise AssertionError(
                f"{tag} one-hot {P}x{Q} naming {which}: {len(bad)} entries "
                f"wrong, ({pp}, {qq}) holds {got[pp, qq].item()}, not "
                f"{want[pp, qq].item()}")


def half_path(torch, np, dev, smi, err, p6, run12, patches_anneal):
    """Phase 24: the linear family's ``compute_dtype`` on the card.  24a:
    ``hgemm_phase``.  24b: phase 6's BSC patches run (D=256, H=300, H'=8,
    gamma=4, 131072 rows, 6 iterations, from phase 6's init) at
    ``compute_dtype=torch.bfloat16`` through ``run`` and ``scanned_path``:
    bit-identical, exactly 6 E-steps and 6 of each 16-bit GEMM, no
    split-TF32 GEMM but the two decodes' ``sgemm_nn`` (a decode stays
    float32); its first E-step's sums against float64 sums over the
    rounded operands (``against_f64``, bound ``ULPS_SQRT_N``); W and Q_mean
    after the run beside phase 6's float32 run (a reported distance); E-step
    #1 at bf16 beside float32.  24c: one bf16 E-step of phase 12's big-S TSC
    and one of phase 23's state-sharded BSC (two state ranks as threads of
    this process, ``tests/state_threads.py``) against their plain versions
    on the card, within phase 11's tolerances.  Returns (the ``half``
    line, the two kernels' entries for the ``kernels`` line)."""
    import os

    from prosper_tpu_torch import EM
    from prosper_tpu_torch.core import etstep
    from prosper_tpu_torch.models import BSC
    from prosper_tpu_torch.ops import cuda_lib, gemm_cuda, linear_cuda
    bf = torch.bfloat16
    t0 = time.perf_counter()
    kern = hgemm_phase(torch, np, dev, smi, err)
    stamp("phase 24a")

    # ---- 24b: phase 6's run at bf16 ----------------------------------------
    y, init, em6 = p6["em"].data["y"], p6["init"], p6["em"]
    model = BSC(256, 300, 8, 4, chunk=8192, compute_dtype=bf)

    def make_em():
        return EM(model, patches_anneal(), {"y": y}, params=init, seed=4,
                  device=dev)
    reset_launches(cuda_lib)
    em = make_em()
    em.run()
    serve = {dense: model.inference(em.params, p6["held_out"], top_L=10,
                                    dense_states=dense)
             for dense in (False, True)}
    torch.cuda.synchronize()
    launches = expect_launches(cuda_lib, "[24b]", estep=6, decode=2,
                               sgemm_nn=2, hgemm_nn=6, hgemm_tn=6)
    run_paths = dict(gemm_cuda.HGEMM_TN_PATHS)
    check_path(torch, np, "[24b]", em, serve, 300)
    scanned, scanned_launches = scanned_path(
        torch, np, cuda_lib, "[24b]", em, make_em, init, 4, smi, estep=6,
        hgemm_nn=6, hgemm_tn=6)
    traced = scanned["replay_kernels_traced"]
    if traced["hgemm_tn_bulk"] != traced["hgemm_tn"] or traced["hgemm_tn"] < 6:
        raise AssertionError(f"[24b] run_scanned's replays ran "
                             f"hgemm_tn_splitn's bulk-copy kernel "
                             f"{traced['hgemm_tn_bulk']} times of "
                             f"{traced['hgemm_tn']}")
    p1, beta, prior_beta = first_step_params(torch, dev, model, init,
                                             patches_anneal)
    w = torch.ones(y.shape[0], device=dev)
    sa = model.state_arrays(dev)
    eargs = (y, w, p1["W"], p1["sigma"] ** 2, model.log_odds(p1), sa, 8,
             False, beta, prior_beta)
    _, s1 = linear_cuda.linear_et_estep_cuda(*eargs, compute_dtype=bf)
    f64 = linear_sums_f64(torch, *eargs, chunk=8192, compute_dtype=bf,
                          P32=lambda rows: gemm_cuda.hgemm_nn_cuda(
                              rows, p1["W"], bf))
    first = against_f64(torch, np, s1, f64, y.shape[0])
    # xs is bounded apart: where the float32 and the float64 sw straddle a
    # bf16 rounding boundary they round a bf16 ulp (2^-8) apart
    worst = max(v["ulps_sqrt_n"] for k, v in first.items() if k != "xs")
    if worst > ULPS_SQRT_N or first["xs"]["rel"] > 2.0 ** -8:
        raise AssertionError(f"[24b] the first bf16 E-step's sums are "
                             f"{worst:.3g} ulps x sqrt(N) off the float64 "
                             f"sums over the rounded operands: {first}")
    W6, Wb = em6.params["W"], em.params["W"]
    cos = (Wb * W6).sum(dim=0) / (Wb.norm(dim=0) * W6.norm(dim=0)).clamp(
        min=1e-30)
    q6 = np.asarray([h["Q_mean"] for h in em6.history])
    qb = np.asarray([h["Q_mean"] for h in em.history])
    P = em.params
    est = interleaved_ms(
        torch,
        lambda: linear_cuda.linear_et_estep_cuda(
            y, w, P["W"], P["sigma"] ** 2, model.log_odds(P), sa, 8, False,
            1.0, 1.0),
        lambda: linear_cuda.linear_et_estep_cuda(
            y, w, P["W"], P["sigma"] ** 2, model.log_odds(P), sa, 8, False,
            1.0, 1.0, compute_dtype=bf), reps=5)
    out = {"b": {
        "model": "BSC(256, 300, 8, 4, compute_dtype=torch.bfloat16)",
        "launches": launches, "scanned": scanned,
        "first_step_sums_against_f64": first,
        "W_rel_to_phase6_float32": ((Wb - W6).abs().max()
                                    / W6.abs().max()).item(),
        "atoms_cosine_to_phase6_min": cos.min().item(),
        "atoms_cosine_to_phase6_below_0.99": int((cos < 0.99).sum()),
        "Q_mean": qb.tolist(), "Q_mean_phase6_float32": q6.tolist(),
        "Q_mean_max_rel_diff": float(np.max(np.abs(qb - q6) / np.abs(q6))),
        "estep_ms_bf16": est[0], "estep_ms_float32": est[1]}}
    log(f"[24b] BSC patches at bf16: launches {launches}; first E-step's "
        f"sums against float64 over the rounded operands {first}; after 6 "
        f"iterations W {out['b']['W_rel_to_phase6_float32']:.3g} of max |W| "
        f"off phase 6's float32 run ({out['b']['atoms_cosine_to_phase6_below_0.99']}"
        f" of 300 atoms at cosine < 0.99 to its atoms, the least "
        f"{out['b']['atoms_cosine_to_phase6_min']:.4f}), Q_mean {qb.tolist()} (float32 "
        f"{q6.tolist()}); host ms per iteration run "
        f"{scanned['run_ms']:.3f}, replaying {scanned['run_scanned_ms']:.3f}; "
        f"E-step #1 at bf16 {est[0]:.3f} ms, float32 {est[1]:.3f} ms  "
        f"[{smi}]")
    stamp("phase 24b")

    # ---- 24c: big-S TSC and the state-sharded BSC, one bf16 E-step each ---
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from state_threads import run_state_shards

    def against_plain(tag, got, ref, want):
        """Phase 11's tolerances (F rtol 1e-4, sums 1e-3); xs within 2^-8
        of its largest entry: the kernel's and the plain version's sw
        differ in float32 rounding, and where they straddle a bf16 rounding
        boundary their roundings are a bf16 ulp apart."""
        (F1, s1), (F0, s0) = got, ref
        torch.testing.assert_close(F1, F0, rtol=1e-4, atol=1e-4,
                                   msg=f"{tag} F")
        for k in s0:
            if k == "xs":
                torch.testing.assert_close(
                    s1[k], s0[k], rtol=0.0,
                    atol=2.0 ** -8 * s0[k].abs().max().item(),
                    msg=f"{tag} {k}")
            else:
                torch.testing.assert_close(s1[k], s0[k], rtol=1e-3,
                                           atol=1e-3, msg=f"{tag} {k}")
        return {"F_max_abs_diff": (F1 - F0).abs().max().item(),
                "xs_rel": ((s1["xs"] - s0["xs"]).abs().max()
                           / s0["xs"].abs().max()).item(),
                "other_sums_max_abs_diff": max(
                    (s1[k] - s0[k]).abs().max().item()
                    for k in s0 if k != "xs"), "launches": want}
    m12, P12 = run12["model"], run12["em"].params
    y12 = run12["y_dev"]
    a12 = (y12, torch.ones(y12.shape[0], device=dev), P12["W"],
           P12["sigma"] ** 2, m12.log_odds(P12), m12.state_arrays(dev),
           m12.Hprime, True, 1.0, 1.0)
    reset_launches(cuda_lib)
    got = linear_cuda.linear_et_estep(*a12, s_block=m12.s_block,
                                      compute_dtype=bf)
    torch.cuda.synchronize()
    want = expect_launches(cuda_lib, "[24c] big-S TSC", bigs=1, hgemm_nn=1,
                           hgemm_tn=1)
    out["c_bigs"] = against_plain("[24c] big-S TSC", got,
                                  etstep.linear_et_estep(
                                      *a12, chunk=8192, s_block=m12.s_block,
                                      compute_dtype=bf), want)
    reset_launches(cuda_lib)
    parts, _ = run_state_shards(2, lambda g: linear_cuda.linear_et_estep(
        *eargs, state_axis=g, n_state_shards=2, compute_dtype=bf))
    torch.cuda.synchronize()
    n_chunks = len(cuda_lib.row_chunks(y.shape[0], 8 * 300))
    want = expect_launches(cuda_lib, "[24c] state-sharded BSC",
                           bigs=2 * n_chunks, hgemm_nn=2 * n_chunks,
                           hgemm_tn=2 * n_chunks)
    plain, _ = run_state_shards(2, lambda g: etstep.linear_et_estep(
        *eargs, chunk=8192, state_axis=g, n_state_shards=2,
        compute_dtype=bf))
    if not torch.equal(parts[0][0], parts[1][0]):
        raise AssertionError("[24c] state-sharded BSC: F differs between the "
                             "state ranks")
    out["c_state"] = {f"rank{r}": against_plain(
        f"[24c] state-sharded BSC rank {r}", parts[r], plain[r], want)
        for r in range(2)}
    log(f"[24c] one bf16 E-step against the plain version on the card: "
        f"big-S TSC {out['c_bigs']}, BSC on two state ranks "
        f"{out['c_state']}  [{smi}]")
    out["phase_s"] = time.perf_counter() - t0
    stamp("phase 24")
    for name in kern:
        kern[name].update(launches=launches[name],
                          scanned_launches=scanned_launches[name])
    # which of hgemm_tn_splitn's kernels 24b's run launched, and how often
    # its bulk-copy kernel ran in the traced replays of run_scanned
    kern["hgemm_tn"].update(paths=run_paths,
                            replays_traced_bulk=traced["hgemm_tn_bulk"])
    return out, kern


def patches_anneal(iters=6):
    """Phase 6's schedule: T 2 -> 1 and W noise 0.5 -> 0 over the first 60 %,
    the Ncut cut 0 -> 1 from 40 %."""
    from prosper_tpu_torch import LinearAnnealing
    a = LinearAnnealing(iters)
    a["T"] = [(0.0, 2.0), (0.6, 1.0)]
    a["W_noise"] = [(0.0, 0.5), (0.6, 0.0)]
    a["Ncut_factor"] = [(0.4, 0.0), (1.0, 1.0)]
    return a


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
            ("max E-step rows kernel (D=256, H=300, H'=6, S=35)",
             lib.max_et_smem_bytes(256, 300, 6, 35)),
            ("max E-step routing kernel (H=300, H'=6)",
             lib.max_et_route_smem_bytes(6, 300)),
            (f"big-S kernel (H'=10, K=2: 65 logit and 69 moment columns, "
             f"{lib.bigs_multi_warps(65, 69)} warps a block)",
             lib.bigs_multi_smem_bytes(65, 69)),
            ("sgemm_nn kernel", lib.sgemm_smem_bytes(0)),
            ("sgemm_tn_splitn kernel", lib.sgemm_smem_bytes(1)),
            ("hgemm_nn kernel", lib.hgemm_smem_bytes(0)),
            ("hgemm_tn_splitn bulk-copy kernel",
             lib.hgemm_tn_bulk_smem_bytes()),
            ("hgemm_tn_splitn cp.async kernel (shapes tensor maps cannot "
             "take)", lib.hgemm_smem_bytes(1))):
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
           "sgemm_nn": 0.0, "sgemm_tn": 0.0, "hgemm_nn": 0.0, "hgemm_tn": 0.0}
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

    # ---- 15.-17. GSC (its E-step kernel) and the mixtures (plain PyTorch) ----
    scanned["gsc_patches"], gsc_decode, gk = gsc_path(torch, np, dev, smi,
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
    rec20, y_1e6 = recovery_path(torch, np, dev, smi)
    recovery.update(rec20)
    seconds["20"] = time.perf_counter() - t0
    stamp("phase 20")
    # ---- 21. streaming: StreamingEM over host segments on a copy stream ----
    t0 = time.perf_counter()
    stream, stream_launches = stream_path(torch, np, dev, smi, y_1e6,
                                          patches_anneal)
    seconds["21"] = time.perf_counter() - t0
    stamp("phase 21")
    # ---- the open check: two row cuts of the E-step at N = 10^6 -----------
    t0 = time.perf_counter()
    check = open_check(torch, np, dev, smi, y_1e6, patches_anneal)
    del y_1e6
    seconds["check"] = time.perf_counter() - t0
    stamp("the open check")
    if check["failures"]:
        raise AssertionError(f"[check] a row cut's sums are off: "
                             f"{check['failures']}")
    # ---- 22. the data-parallel runtime: NCCL at one rank, two gloo ranks --
    t0 = time.perf_counter()
    distributed = distributed_path(
        torch, np, dev, smi, {"model": model, "em": em, "init": init,
                              "y_dev": y_dev, "y_host": data["y"],
                              "held_out": held_out, "serve": serve},
        patches_anneal, check["sensitivity"])
    distributed["open_check"] = check
    seconds["22"] = time.perf_counter() - t0
    stamp("phase 22")
    # ---- 23. state sharding: the (1, 2) ("data", "state") mesh ------------
    t0 = time.perf_counter()
    run12 = bg.pop("run12")
    state = state_path(torch, np, dev, smi, err,
                       {"model": model, "em": em, "init": init,
                        "y_host": data["y"]}, run12, patches_anneal)
    seconds["23"] = time.perf_counter() - t0
    stamp("phase 23")
    # ---- 24. compute_dtype: the 16-bit GEMM kernels and their paths -------
    half, hk = half_path(torch, np, dev, smi, err,
                         {"em": em, "init": init, "held_out": held_out},
                         run12, patches_anneal)
    seconds["24"] = half["phase_s"]

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

    dl = distributed["launches_under_runtime"]
    kernels = [
        {"name": "linear_et_estep", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/linear_et_estep.cu",
         "replaces": "prosper_tpu/ops/linear_pallas.py:244",
         "launches": launches["estep"],
         "scanned_launches": scanned_launches["estep"],
         "stream_launches": stream_launches.get("estep", 0),
         "distributed_launches": dl["estep"],
         "max_abs_err": err["estep"], "ms": est[0], "plain_ms": est[1], **est_bound, "library_ms": None},
        {"name": "linear_et_decode", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/linear_et_decode.cu",
         "replaces": "prosper_tpu/ops/linear_pallas.py:435",
         "launches": launches["decode"], "scanned_launches": 0,
         "stream_launches": stream_launches.get("decode", 0),
         "distributed_launches": dl["decode"],
         "max_abs_err": err["decode"],
         "ms": dec[0], "plain_ms": dec[1], **dec_bound, "library_ms": None},
        {"name": "max_et_estep", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/max_et_estep.cu",
         "replaces": "prosper_tpu/ops/max_pallas.py:559; "
                     "prosper_tpu/ops/max_pallas.py:433",
         "launches": mxl["max_estep"], "scanned_launches": mxs["max_estep"],
         "stream_launches": stream_launches.get("max_estep", 0),
         "distributed_launches": dl["max_estep"],
         "max_abs_err": err["max_estep"],
         **mx, "library_ms": None},
        {"name": "bigs_multi", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/bigs_multi.cu",
         "replaces": "prosper_tpu/ops/bigs_pallas.py:155",
         "launches": bgl["bigs"], "scanned_launches": bgs["bigs"],
         "stream_launches": stream_launches.get("bigs", 0),
         "distributed_launches": dl["bigs"],
         # phase 23: launches on each state rank (23a + 23b), and the
         # kernel on one rank's slice of phase 12's states
         "state_launches": (state["a"]["launches_per_rank"]["bigs"]
                            + state["b"]["launches_per_rank"]["bigs"]),
         "state_slice": {k: state["slices"][k] for k in (
             "states_per_rank", "ms", "plain_ms", "bound_ms", "bound_by")},
         "max_abs_err": err["bigs"], **bg,
         "library_ms": None},
        # the two products inside the bodies of the TPU kernels; one launch
        # per E-step of the linear and of the MCA patches path, and
        # sgemm_nn once more per decode
        {"name": "sgemm_nn", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/sgemm.cuh",
         "replaces": "prosper_tpu/ops/linear_pallas.py:63; "
                     "prosper_tpu/ops/max_pallas.py:65",
         "launches": gemm_launches("sgemm_nn"),
         "scanned_launches": scanned_gemm_launches("sgemm_nn"),
         "stream_launches": stream_launches.get("sgemm_nn", 0),
         "distributed_launches": dl["sgemm_nn"],
         "max_abs_err": err["sgemm_nn"], **gm["sgemm_nn"]},
        {"name": "sgemm_tn_splitn", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/sgemm.cuh",
         "replaces": "prosper_tpu/ops/linear_pallas.py:179; "
                     "prosper_tpu/ops/max_pallas.py:169",
         "launches": gemm_launches("sgemm_tn"),
         "scanned_launches": scanned_gemm_launches("sgemm_tn"),
         "stream_launches": stream_launches.get("sgemm_tn", 0),
         "distributed_launches": dl["sgemm_tn"],
         "max_abs_err": err["sgemm_tn"], **gm["sgemm_tn"]},
        # the same two products at a linear model's 16-bit compute_dtype
        # (the JAX package's XLA dots of prosper_tpu/core/etstep.py, inside
        # kernel #1 here); launches: phase 24b's bf16 run
        {"name": "hgemm_nn", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/sgemm.cuh",
         "replaces": "prosper_tpu/ops/linear_pallas.py:63; "
                     "prosper_tpu/core/etstep.py:206,426",
         "max_abs_err": err["hgemm_nn"], **hk["hgemm_nn"]},
        {"name": "hgemm_tn_splitn", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/hgemm_tn.cuh",
         "replaces": "prosper_tpu/ops/linear_pallas.py:179; "
                     "prosper_tpu/core/etstep.py:331,596",
         "max_abs_err": err["hgemm_tn"], **hk["hgemm_tn"]},
        # GSC's E-step: no TPU kernel (plain XLA in the JAX package);
        # launches: phase 16's run and its run_scanned, phase 21's and
        # phase 22a's GSC runs
        {"name": "gsc_et_estep", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/gsc_et_estep.cu",
         "replaces": "none (prosper_tpu/core/gscstep.py, plain XLA)",
         "stream_launches": stream_launches.get("gsc_estep", 0),
         "distributed_launches": dl["gsc_estep"],
         **gk, "library_ms": None},
    ]
    for k in kernels:
        # the 16-bit GEMMs' path is phase 24's: no stream or runtime phase
        half_k = k["name"].startswith("hgemm")
        log(f"[kernels] {k['name']}: {k['ms']:.3f} ms, bound "
            f"{k['bound_ms']:.3f} ms by {k['bound_by']} "
            f"({100 * k['bound_ms'] / k['ms']:.1f} % of it), "
            f"{k['launches']} launches through run, "
            f"{k['scanned_launches']} through run_scanned's eager steps and "
            f"captures, {k.get('stream_launches', 0)} through StreamingEM, "
            f"{k.get('distributed_launches', 0)} under the runtime  [{smi}]")
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was launched no time on its "
                                 "main path")
        if k["name"] != "linear_et_decode" and k["scanned_launches"] < 1:
            raise AssertionError(f"{k['name']} was launched no time through "
                                 "run_scanned")
        if half_k:
            continue
        if k["name"] != "linear_et_decode" and k["stream_launches"] < 1:
            raise AssertionError(f"{k['name']} was launched no time through "
                                 "StreamingEM")
        if k["distributed_launches"] < 1:
            raise AssertionError(f"{k['name']} was launched no time under "
                                 "the runtime (phase 22)")
        if k["name"] == "bigs_multi" and k["state_launches"] < 1:
            raise AssertionError("bigs_multi was launched no time under the "
                                 "state axis (phase 23)")
    log(json.dumps({"scanned": dict(scanned, card=smi),
                    "gsc_decode": dict(gsc_decode, card=smi)}))
    log(json.dumps({"recovery": dict(recovery, phase_s=seconds, card=smi)}))
    log(json.dumps({"stream": dict(stream, card=smi)}))
    log(json.dumps({"distributed": dict(distributed, card=smi)}))
    log(json.dumps({"state": dict(state, card=smi)}))
    log(json.dumps({"half": dict(half, card=smi)}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase22_alone() -> int:
    """``python3 chip_smoke.py --phase 22``: the build, phase 6's run and
    decode again, the open check on phase 20's rows, and phase 22, without
    the other phases."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev, smi = alone_setup(torch)
    model, em, init, data, held_out, gt = patches_run(torch, np, dev)
    y_dev = em.data["y"]
    serve = {dense: model.inference(em.params, held_out, top_L=10,
                                    dense_states=dense)
             for dense in (False, True)}
    y_1e6 = model.generate_data(gt, 1_000_000, seed=1)["y"]
    stamp("phase 6's run and phase 20's rows")
    check = open_check(torch, np, dev, smi, y_1e6, patches_anneal)
    del y_1e6
    stamp("the open check")
    # phase 22 runs all the same; a failed check fails the run after it
    out = distributed_path(
        torch, np, dev, smi, {"model": model, "em": em, "init": init,
                              "y_dev": y_dev, "y_host": data["y"],
                              "held_out": held_out, "serve": serve},
        patches_anneal, check["sensitivity"])
    stamp("phase 22")
    out["open_check"] = check
    log(json.dumps({"distributed": dict(out, card=smi)}))
    if check["failures"]:
        raise AssertionError(f"[check] a row cut's sums are off: "
                             f"{check['failures']}")
    return 0


def alone_setup(torch):
    """The card's name and power limit, float32 matmuls in full float32,
    the kernels built: what a phase run alone starts with."""
    from prosper_tpu_torch.ops import cuda_lib
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_lib.load_library()
    stamp("build")
    return torch.device("cuda"), smi


def patches_run(torch, np, dev):
    """Phase 6's run: BSC at the patches width (D=256, H=300, H'=8,
    gamma=4) through 6 iterations of ``EM.run`` on 131072 planted-
    dictionary rows.  Returns (model, em, init, data, held_out, gt)."""
    from prosper_tpu_torch import EM
    from prosper_tpu_torch.data.bars import planted_dictionary
    from prosper_tpu_torch.models import BSC
    model = BSC(256, 300, 8, 4, chunk=8192)
    gt = {"W": planted_dictionary(256, 300, seed=0),
          "pi": np.float32(2.0 / 300), "sigma": np.float32(1.0)}
    data = model.generate_data(gt, 131072, seed=1)
    held_out = model.generate_data(gt, 8192, seed=2)
    init = model.standard_init(data, seed=3, device=dev)
    em = EM(model, patches_anneal(), {"y": torch.tensor(data["y"],
                                                        device=dev)},
            params=init, seed=4, device=dev)
    em.run()
    return model, em, init, data, held_out, gt


def phase23_alone() -> int:
    """``python3 chip_smoke.py --phase 23``: the build, phase 6's and phase
    12's runs again, and phase 23, without the other phases."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev, smi = alone_setup(torch)
    model, em, init, data, _, _ = patches_run(torch, np, dev)
    run12 = tsc_bigs_run(torch, np, dev, patches_anneal)
    stamp("phase 6's and phase 12's runs")
    err = {"bigs": 0.0}
    out = state_path(torch, np, dev, smi, err,
                     {"model": model, "em": em, "init": init,
                      "y_host": data["y"]}, run12, patches_anneal)
    stamp("phase 23")
    log(json.dumps({"state": dict(out, max_abs_err=err["bigs"], card=smi)}))
    return 0


def max_alone() -> int:
    """``python3 chip_smoke.py --phase max``: the build (with the max
    kernels' registers and spills, and the blocks an SM holds at the
    patches width) and phases 7-10 alone."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from prosper_tpu_torch.ops import cuda_lib, max_cuda
    dev, smi = alone_setup(torch)
    func = None
    for line in cuda_lib.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
        elif func and "max_estep" in func and ("registers" in line
                                               or "spill" in line):
            log("[build]", func, line.strip())
    lib = cuda_lib.load_library()
    hcols, _ = max_cuda.route_units(300, 6)
    for magnitude in (False, True):
        rows, route = max_cuda.blocks_per_sm(lib, 256, 300, 6, 35, hcols,
                                             magnitude)
        log(f"[build] max E-step kernels (D=256, H=300, H'=6, gamma=3, "
            f"magnitude={magnitude}): rows kernel "
            f"{max_cuda.smem_bytes(256, 300, 6, 35)} bytes of shared memory "
            f"a block, {rows} blocks an SM; routing kernel "
            f"{max_cuda.route_smem_bytes(6, hcols)} bytes, {route} blocks")
    err = {"max_estep": 0.0}
    mx = max_family(torch, np, dev, smi, err, patches_anneal)
    stamp("phases 7-10")
    log(json.dumps({"max": {"ms": mx["ms"], "plain_ms": mx["plain_ms"],
                            "bound_ms": mx["bound_ms"],
                            "max_abs_err": err["max_estep"],
                            "scanned": mx["scanned"], "card": smi}}))
    return 0


def gsc_alone() -> int:
    """``python3 chip_smoke.py --phase gsc``: the build (with the GSC
    E-step kernel's registers and spills) and phases 15-16 alone."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from prosper_tpu_torch.ops import cuda_lib
    dev, smi = alone_setup(torch)
    func = None
    for line in cuda_lib.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
        elif func and "gsc_estep" in func and ("registers" in line
                                               or "spill" in line):
            log("[build]", func, line.strip())
    scanned, decode, kernel = gsc_path(torch, np, dev, smi, patches_anneal)
    stamp("phases 15-16")
    log(json.dumps({"gsc": dict(kernel, scanned=scanned, decode=decode,
                                card=smi)}))
    return 0


def phase24_alone() -> int:
    """``python3 chip_smoke.py --phase 24``: the build, phase 6's and phase
    12's runs again, and phase 24, without the other phases."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev, smi = alone_setup(torch)
    _, em, init, _, held_out, _ = patches_run(torch, np, dev)
    run12 = tsc_bigs_run(torch, np, dev, patches_anneal)
    stamp("phase 6's and phase 12's runs")
    err = {"hgemm_nn": 0.0, "hgemm_tn": 0.0}
    half, hk = half_path(torch, np, dev, smi, err,
                         {"em": em, "init": init, "held_out": held_out},
                         run12, patches_anneal)
    log(json.dumps({"half": dict(half, card=smi)}))
    log(json.dumps({"kernels": [dict(hk[k], name=k, max_abs_err=err[k])
                                for k in hk]}))
    return 0


if __name__ == "__main__":
    for flag, rank_fn in (("--rank22", rank22), ("--rank23", rank23)):
        if sys.argv[1:2] == [flag]:
            sys.exit(rank_fn(int(sys.argv[2]), int(sys.argv[3]),
                             sys.argv[4]))
    if sys.argv[1:3] == ["--phase", "22"]:
        sys.exit(phase22_alone())
    if sys.argv[1:3] == ["--phase", "23"]:
        sys.exit(phase23_alone())
    if sys.argv[1:3] == ["--phase", "24"]:
        sys.exit(phase24_alone())
    if sys.argv[1:3] == ["--phase", "max"]:
        sys.exit(max_alone())
    if sys.argv[1:3] == ["--phase", "gsc"]:
        sys.exit(gsc_alone())
    sys.exit(main())
