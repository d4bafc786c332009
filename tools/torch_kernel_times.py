#!/usr/bin/env python3
"""Times, profiles and ablations of prosper_tpu_torch's CUDA kernels on one
NVIDIA GPU, at the shapes of chip_smoke.py's paths (N = 131072 rows; BSC
D=256, H=300, H'=8, gamma=4; MCA D=256, H=300, H'=6, gamma=3; big-S TSC
D=64, H=32, H'=10, gamma=5, s_block=1024; decode of 8192 rows).

    python3 tools/torch_kernel_times.py times [--repo DIR]
        CUDA-event times of the E-step, decode, max E-step, big-S E-step
        and GSC E-step wrappers, and of the big-S kernel alone (with and without the
        un-annealed channel), of the package found in DIR (default: this
        checkout), each timing started on an idle card; the decode also
        with its calls queued behind other device work, where the host's
        share does not show; one JSON line.
    python3 tools/torch_kernel_times.py compare --parent DIR
        `times` of an unpacked parent commit in DIR and of this checkout, in
        turns (parent, change, change, parent), one process each; then
        whether the GEMM wrappers' outputs on the same seeded inputs are
        bit-identical to the parent's: sgemm_nn, sgemm_tn_splitn and
        hgemm_nn must be (the command fails otherwise), hgemm_tn_splitn is
        reported.
    python3 tools/torch_kernel_times.py profile [--only NAMES]
        torch.profiler over EM iterations of BSC, MCA, big-S TSC and GSC
        (D=256, H=300, H'=6, gamma=3 in chunks of 8192 rows, and of 32768:
        "gsc_chunk32768"), four through `EM.step_once` (the loop of `run`)
        and four through `EM.run_scanned` (replays of the captured step; the
        schedule's upload and the scalars' read-back are inside the window),
        and over BSC inference calls of 8192 rows: device time by kernel,
        the device's busy time and its idle share of the window, the host
        clock per iteration both ways; for GSC also the share of the busy
        time that `slot_sum_ss` (the <sz sz^T> scatter) takes, timed alone
        at the chunk's shape.  NAMES: a comma-separated subset of
        bsc,mca,tsc,gsc,gsc_chunk32768.
    python3 tools/torch_kernel_times.py capture
        What one capture of the EM step into a CUDA graph costs on the host
        (`EM.scan_stats["capture_s"]`) for BSC, MCA and big-S TSC, as the
        engine captures and with what `torch.cuda.graph` does on entry put
        before it (a synchronise, `gc.collect()`, `empty_cache()`), in turns
        (as it is, with, with, as it is), a fresh EM each; and the device
        memory reserved afterwards.
    python3 tools/torch_kernel_times.py ablate [--only TEXT] [--repo DIR]
        Builds edited copies of the sources of the package in DIR (default:
        this checkout) with one part of the linear rows kernel, of the max
        kernel, of the big-S kernel, of the GSC kernel or of a GEMM kernel
        switched off (the
        results are then wrong; only the time is read) and prints what each
        part saves; then variants that keep the results right: the GEMM
        kernels with other numbers of stages, the TF32 split by cvt, every
        depth of sgemm_nn summed one k8 step at a time, and the big-S kernel
        at its largest block, the GSC kernel's lanes walking the supports
        largest first.  Where DIR is another tree, an edit whose
        text is not in its sources (a kernel it does not have) is reported
        and skipped; in this checkout every edit must find its text.  The
        "gemm tn" edits take the 16-bit tn kernel of an unpacked parent
        apart (`--repo`), the "hgemm tn" edits this tree's.

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

#: hgemm_tn_splitn's bulk-copy kernel issues a slab's two tensor copies;
#: without them the stage's mbarrier expects no bytes and completes at once
HTN_COPIES = ("      mbar_expect(bar, RAW);        // both boxes, zero-filled "
              "past the edges\n"
              "      tma_box(st, &mx, p0, r_begin + t * BK, bar);\n"
              "      tma_box(st + RAW_A, &my, q0, r_begin + t * BK, bar);\n")
HTN_NO_COPIES = "      mbar_expect(bar, 0);\n"
#: (name, file, text to replace, replacement), or (name, file, [(text,
#: replacement), ...]): parts switched off by `ablate`
ABLATIONS = [
    ("front end: candidate selection (the decode, max and gsc kernels')",
     "linear_et_frontend.cuh",
     "const int bi = row_argmax(sc, H, lane, &b);",
     "const int bi = a; b = 0.f;"),
    ("front end: multi-state logits (the decode's)",
     "linear_et_frontend.cuh", "int sb = 0;", "int sb = S;"),
    ("rows: selection (the threshold sort, the gather and the ranks)",
     "linear_et_estep.cuh",
     "      select_top<NU>(key, pr, Hp, lane, slot, sm.sel + warp * 3 * 32, cand,\n"
     "                     X);",
     "      if (lane < Hp) {\n        cand[lane] = lane;\n        X[lane] = pr[0];\n"
     "        slot[lane] = (signed char)lane;\n      }\n      __syncwarp();"),
    ("rows: the selection keys' corrections (P / wn as P * (1 / wn))",
     "linear_et_estep.cuh",
     "const float s = div_by(pr[i], sm.wn[h], sm.rwn[h]);",
     "const float s = pr[i] * sm.rwn[h];"),
    ("rows: the candidates' Gram entries (read from the L2)",
     "linear_et_estep.cuh",
     "X[Hp + i] = p.gram[(size_t)cand[i / Hp] * H + cand[i % Hp]];",
     "X[Hp + i] = 0.25f;"),
    ("rows: multi-state logits (each state's slots and slot pairs)",
     "linear_et_estep.cuh",
     "for (unsigned m1 = msk; m1 != 0u; m1 &= m1 - 1u) {",
     "for (unsigned m1 = 0u; m1 != 0u; m1 &= m1 - 1u) {"),
    ("rows: the multi states' exponentials (an add in their place)",
     "linear_et_estep.cuh", [
         ("expf((beta * lik + pb * sm.prior[s]) - mx)",
          "(1.f + (beta * lik + pb * sm.prior[s]) - mx)"),
         ("expf((lik + sm.prior[s]) - mxt)",
          "(1.f + (lik + sm.prior[s]) - mxt)")]),
    ("rows: multi-state moments (each row's states)", "linear_et_estep.cuh",
     "for (unsigned bits = rb[wd]; bits != 0u;) {",
     "for (unsigned bits = 0u; bits != 0u;) {"),
    ("rows: the singleton pass's exponentials (an add in their place)",
     "linear_et_estep.cuh", [
         ("expf((beta * lik + pb * sm.lo[k]) - mx)",
          "(1.f + (beta * lik + pb * sm.lo[k]) - mx)"),
         ("expf((lik + sm.lo[k]) - mxt)", "(1.f + (lik + sm.lo[k]) - mxt)")]),
    ("rows: the quotients' corrections (q = e / Z as e * (1 / Z))",
     "linear_et_estep.cuh", [("div_by(e1v[i], Z, rZ)", "e1v[i] * rZ"),
                             ("div_by(L[s], Z, rZ)", "L[s] * rZ")]),
    ("rows: the warps' sums of w <s> and w <s_h^2> in shared memory",
     "linear_et_estep.cuh", [("if (w != 0.f) accd[h] += (q * vv) * w;", ""),
                             ("          accs[h] += pr[i];\n", "")]),
    ("rows: ss scatter (one barrier a tile)", "linear_et_estep.cuh",
     "if (warp < nrows && wrb[warp] != 0.f) {",
     "if (warp < nrows && wrb[warp] > 3e38f) {"),
    ("rows: the whole rows kernel (launch skipped)", "linear_et_estep.cuh",
     "  rows_kernel<NU, K1><<<n_blocks, RTHREADS, smem, stream>>>(p);",
     "  if (false) rows_kernel<NU, K1><<<n_blocks, RTHREADS, smem, stream>>>"
     "(p);"),
    ("gsc: the supports' solves (logits 0, kappa and Sigma unset)",
     "gsc_et_estep.cu",
     "support_any<G>(m, code, X, Hp, ks + s, S, log_psi, mm, hip);",
     "(float)code * 1e-30f;"),
    ("gsc: the supports' moments", "gsc_et_estep.cu",
     "        moments_any<G>(m, q, ks + s, S);\n", ""),
    ("gsc: the gather of the moments into the candidate frame",
     "gsc_et_estep.cu",
     "for (int e = istart[k]; e < istart[k + 1]; ++e) acc += ks[ientry[e]];",
     ""),
    ("gsc: the ss scatter", "gsc_et_estep.cu",
     "if (w != 0.f) {\n        const int* cr", "if (w > 3e38f) {\n"
     "        const int* cr"),
    ("gsc: the singletons' exponentials (an add in their place)",
     "gsc_et_estep.cu", "expf((beta * lik + pb * lo) - mx)",
     "(1.f + (beta * lik + pb * lo) - mx)"),
    ("max: phase 0 (the lattice in registers, ybar (2y - ybar))",
     "max_et_estep.cuh", "for (int dd = lane; dd < D; dd += 32) {",
     "for (int dd = lane; dd < 0; dd += 32) {"),
    ("max: phase 0's sums over the warp", "max_et_estep.cuh",
     "  pass_sums<LO, HI>(acc, L, lane,\n", "  L[LO / 32] += acc[0];\n"
     "  if (false) pass_sums<LO, HI>(acc, L, lane,\n"),
    ("max: the routing tables", "max_et_estep.cuh",
     "        route_table<HP>(p.T + (size_t)n * HP * E, sm.sidx, qm, w, lane);",
     ""),
    ("max: phase 1 (routing)",
     "max_et_estep.cuh", "for (int n0 = r_begin; n0 < r_end; n0 += RB) {",
     "for (int n0 = r_begin; n0 < 0; n0 += RB) {"),
    ("max: the routing kernel's sums (its ranks and masses kept)",
     "max_et_estep.cuh",
     "    const unsigned mine = own[lane * WARPS + warp];\n",
     "    const unsigned mine = 0u;\n"),
    ("bigs: logits product", "bigs_multi.cu",
     "for (int k = 0; k < nL; ++k) {", "for (int k = 0; k < 0; ++k) {"),
    ("bigs: expf (an add in its place)", "bigs_multi.cu", "expf(",
     "(1.f + "),
    ("bigs: moment product", "bigs_multi.cu",
     "for (int s4 = 0; s4 < T; s4 += 4) {",
     "for (int s4 = 0; s4 < 0; s4 += 4) {"),
    ("bigs: staging of the A and B tiles after the first", "bigs_multi.cu",
     "if (t + 1 < nt) {", "if (false) {"),
    ("gemm nn: the copies of B's split image", "sgemm.cuh",
     "      cp_async16(dst + 4 * c, src + 4 * c, true);",
     "      cp_async16(dst + 4 * c, src + 4 * c, false);"),
    ("gemm nn: the stores of C", "sgemm.cuh",
     "      if (r >= N || c >= H) continue;\n"
     "      float* p = C + (size_t)r * H + c;",
     "      if (r >= 0) continue;\n      float* p = C + (size_t)r * H + c;"),
    ("gemm tn: the loads of the raw slabs", "sgemm.cuh",
     "    load_rows<VEC, BM, BK>(xs_of(s), XS, X, P, r0, p0, r_end);\n"
     "    load_rows<VEC, BN, BK>(ys_of(s), YS, Y, Q, r0, q0, r_end);", ""),
    ("gemm tn: the split and transposition of the B slab", "sgemm.cuh",
     "  auto split_b = [&](int s, int b, int j0, int j1) {",
     "  auto split_b = [&](int s, int b, int j0, int j1) {\n    return;"),
    ("gemm tn: the strided reads and rounding of the register operand",
     "sgemm.cuh",
     "ahi[ks][e] = pack16<T>(xs[k * XS + p], xs[(k + 1) * XS + p]);",
     "ahi[ks][e] = 0x3f803f80u;"),
    ("gemm tn: the 16-bit MMAs (hgemm_nn's too)", "sgemm.cuh",
     "      wgmma_16<T>(part, ahi[k], desc_sw128(bh + 32 * (K0 + k)), k > 0);",
     "      ;"),
    ("gemm tn: the waits for the MMAs (the nn kernels' too)", "sgemm.cuh",
     "float (&part)[NACC]) {\n  wgmma_wait0();", "float (&part)[NACC]) {"),
    ("hgemm tn: the tensor copies", "hgemm_tn.cuh", HTN_COPIES,
     HTN_NO_COPIES),
    ("hgemm tn: the rounding", "hgemm_tn.cuh",
     "      round_rows<T, BM>(in, out, rows, ct);\n"
     "      round_rows<T, BN>(in + BK * BM, out + RND_A, rows, ct);\n", ""),
    ("hgemm tn: the MMAs", "hgemm_tn.cuh",
     "      wgmma_mn<T>(part, desc_mn(ta), desc_mn(tb), 0);\n"
     "      wgmma_mn<T>(part, desc_mn(ta + 2 * ATOM), desc_mn(tb + 2 * ATOM), "
     "1);\n", ""),
    ("hgemm tn: the wait for the MMAs", "hgemm_tn.cuh",
     "      sg::wgmma_wait0();\n", ""),
    ("hgemm tn: all but the tensor copies (the consumers' loop, the "
     "rounding and the converters' wait for a free rounded slab)",
     "hgemm_tn.cuh", [
         ("    for (int t = 0; t < nt; ++t) {\n      mbar_wait(full_rnd(b), pb);",
          "    for (int t = 0; t < 0; ++t) {\n      mbar_wait(full_rnd(b), pb);"),
         ("      mbar_wait(free_rnd(b), pb ^ 1);\n", ""),
         ("      round_rows<T, BM>(in, out, rows, ct);\n"
          "      round_rows<T, BN>(in + BK * BM, out + RND_A, rows, ct);\n",
          "")]),
    ("hgemm tn: the tensor copies and the rounding (what is left: the MMAs "
     "and the hand-over of slabs)", "hgemm_tn.cuh", [
         (HTN_COPIES, HTN_NO_COPIES),
         ("      round_rows<T, BM>(in, out, rows, ct);\n"
          "      round_rows<T, BN>(in + BK * BM, out + RND_A, rows, ct);\n",
          "")]),
]
#: the calls `ablate` times for every edited copy
ABLATED = ("linear_et_estep", "linear_et_decode", "max_et_estep",
           "bigs_multi_annealed", "bigs_multi_saturated",
           "bigs_multi_annealed_16k_rows", "sgemm_nn", "sgemm_tn_splitn",
           "hgemm_tn_splitn_bf16", "gsc_et_estep")
#: the GEMM wrappers `compare` holds to the parent's outputs, bit for bit
SAME_BITS = ("sgemm_nn", "sgemm_tn_splitn", "hgemm_nn_bf16", "hgemm_nn_fp16")
#: and those whose bits it reports
REPORTED_BITS = ("hgemm_tn_splitn_bf16", "hgemm_tn_splitn_fp16")
#: variants of the kernels (right results, other choices)
VARIANTS = [
    ("nothing, but sgemm_nn with 3 stages of slabs in flight", "sgemm.cuh",
     "constexpr int NN_STAGES = 4;", "constexpr int NN_STAGES = 3;"),
    ("nothing, but sgemm_tn_splitn with 4 raw stages", "sgemm.cuh",
     "constexpr int TN_STAGES = 3;", "constexpr int TN_STAGES = 4;"),
    ("nothing, but the sgemm kernels' TF32 split by cvt.rna",
     "sgemm.cuh", "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
     'uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
     "  return r;"),
    ("nothing, but sgemm_nn summing every depth one k8 step at a time",
     "sgemm.cuh", "one = n_slabs == 1;", "one = true;"),
    ("nothing, but the big-S kernel at its largest block whatever the rows",
     "bigs_multi.cu", "while (nw > 1 &&", "while (false &&"),
    ("nothing, but hgemm tn with 5 raw and 2 rounded stages (its first "
     "design)", "hgemm_tn.cuh",
     "constexpr int RAW_STAGES = 3;\nconstexpr int RND_STAGES = 3;",
     "constexpr int RAW_STAGES = 5;\nconstexpr int RND_STAGES = 2;"),
    ("nothing, but hgemm tn with 2 raw and 2 rounded stages", "hgemm_tn.cuh",
     "constexpr int RAW_STAGES = 3;\nconstexpr int RND_STAGES = 3;",
     "constexpr int RAW_STAGES = 2;\nconstexpr int RND_STAGES = 2;"),
    ("nothing, but hgemm tn with 4 raw stages", "hgemm_tn.cuh",
     "constexpr int RAW_STAGES = 3;", "constexpr int RAW_STAGES = 4;"),
    ("nothing, but hgemm tn's tensor maps without L2 promotion",
     "hgemm_tn.cuh", "CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
     "CU_TENSOR_MAP_L2_PROMOTION_NONE"),
    ("nothing, but the gsc kernel's lanes walking the supports largest "
     "first", "gsc_et_estep.cu", "for (int s = lane; s < S; s += 32) {",
     "for (int s = S - 1 - lane; s >= 0; s -= 32) {")]


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


def queued_ms(torch, fn, reps=20):
    """Device time of ``fn()`` where its host side may be the slower one:
    the calls are queued behind some 10 ms of other device work, so that
    the card never waits for the host between them."""
    fn()
    blocker = torch.randn(6144, 6144, device="cuda")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    blocker @ blocker
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PROFILED = ("bsc", "mca", "tsc", "gsc", "gsc_chunk32768")


def setups(torch, np, which=("bsc", "mca", "tsc")):
    """Models, data on the card and initial parameters of the paths, as
    chip_smoke.py makes them."""
    from prosper_tpu_torch.data.bars import planted_dictionary
    from prosper_tpu_torch.models import BSC, GSC, MCA, TSC
    dev = torch.device("cuda")
    out = {}
    for name, model, pi in (
            ("bsc", lambda: BSC(256, 300, 8, 4, chunk=8192), 2.0 / 300),
            ("mca", lambda: MCA(256, 300, 6, 3), 2.0 / 300),
            ("tsc", lambda: TSC(64, 32, 10, 5, chunk=8192, s_block=1024),
             0.1),
            ("gsc", lambda: GSC(256, 300, 6, 3, chunk=8192), 2.0 / 300),
            ("gsc_chunk32768", lambda: GSC(256, 300, 6, 3, chunk=32768),
             2.0 / 300)):
        if name not in which:
            continue
        m = model()
        gt = {"W": planted_dictionary(m.D, m.H, seed=0), "pi": np.float32(pi),
              "sigma": np.float32(1.0)}
        if isinstance(m, GSC):                 # the slab of bench.py:657
            gt.update(mu=np.float32(1.0), psi=np.float32(0.25))
        data = m.generate_data(gt, N, seed=1)
        out[name] = (m, torch.tensor(data["y"], device=dev),
                     m.standard_init(data, seed=3, device=dev))
    return out


def kernel_calls(torch, np):
    """{name: a call of one wrapper at its main-path shape}."""
    import importlib.util
    from prosper_tpu_torch.ops import linear_cuda, max_cuda
    dev = torch.device("cuda")
    gsc = importlib.util.find_spec("prosper_tpu_torch.ops.gsc_cuda")
    su = setups(torch, np, ("bsc", "mca", "tsc") + (("gsc",) if gsc else ()))
    w = torch.ones(N, device=dev)
    calls = {}
    m, y, p = su["bsc"]
    sa, lo, s2 = m.state_arrays(dev), m.log_odds(p), p["sigma"] ** 2
    calls["linear_et_estep"] = lambda: linear_cuda.linear_et_estep_cuda(
        y, w, p["W"], s2, lo, sa, 8, False, 1.0, 1.0)
    if hasattr(linear_cuda, "sgemm_nn_cuda"):      # the GEMMs, where present
        sw = torch.randn(N, 300, device=dev,
                         generator=torch.Generator(dev).manual_seed(14))
        calls["sgemm_nn"] = lambda: linear_cuda.sgemm_nn_cuda(y, p["W"])
        calls["sgemm_tn_splitn"] = (
            lambda: linear_cuda.sgemm_tn_splitn_cuda(y, sw))
    if hasattr(linear_cuda, "hgemm_nn_cuda"):      # the 16-bit GEMMs
        for tag, dt in (("bf16", torch.bfloat16), ("fp16", torch.float16)):
            calls[f"hgemm_nn_{tag}"] = (
                lambda dt=dt: linear_cuda.hgemm_nn_cuda(y, p["W"], dt))
            calls[f"hgemm_tn_splitn_{tag}"] = (
                lambda dt=dt: linear_cuda.hgemm_tn_splitn_cuda(y, sw, dt))
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
    # the big-S kernel alone, on the unpadded tables the E-step hands it
    from prosper_tpu_torch.core import etstep
    from prosper_tpu_torch.ops import bigs_cuda
    gram = pt["W"].T @ pt["W"]
    _, _, tables = etstep.bigs_front(yt, pt["W"], gram, torch.diagonal(gram),
                                     lot, sat, 10, True, 1)
    margs = (*tables, 0.5 / pt["sigma"] ** 2, 1.0, 1.0, 1)
    for tag, true_ch in (("annealed", True), ("saturated", False)):
        calls[f"bigs_multi_{tag}"] = (
            lambda c=true_ch: bigs_cuda.bigs_multi_cuda(*margs,
                                                        collect_true=c))
    few = (tables[0][:N // 8].contiguous(), tables[1][:N // 8].contiguous(),
           *margs[2:])
    calls["bigs_multi_annealed_16k_rows"] = (
        lambda: bigs_cuda.bigs_multi_cuda(*few, collect_true=True))
    if gsc:                                # GSC's E-step, where present
        from prosper_tpu_torch.ops import gsc_cuda
        mg, yg, pg = su["gsc"]
        calls["gsc_et_estep"] = lambda: gsc_cuda.gsc_et_estep_cuda(
            yg, w, pg["W"], pg["sigma"] ** 2, pg["pi"], pg["mu"], pg["psi"],
            mg.state_arrays(dev), 6, 0.7, 1.0)
    return calls


def cmd_times(args):
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    calls = kernel_calls(torch, np)
    # the GEMMs take a tenth of a millisecond: more launches a timing
    out = {k: cuda_ms(torch, fn, 50 if "gemm" in k else 5)
           for k, fn in calls.items()}
    out["linear_et_decode_queued"] = queued_ms(torch,
                                               calls["linear_et_decode"])
    if args.save:
        for k in SAME_BITS + REPORTED_BITS:
            if k in calls:
                np.save(Path(args.save) / f"{k}.npy", calls[k]().cpu().numpy())
    print(json.dumps({"repo": str(args.repo), "ms": out, "card": smi()}),
          flush=True)


def cmd_compare(args):
    import numpy as np
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        saved = {}
        for i, repo in enumerate((args.parent, ROOT, ROOT, args.parent)):
            out = Path(tmp) / f"run{i}"
            out.mkdir()
            r = subprocess.run([sys.executable, __file__, "times", "--repo",
                                str(repo), "--save", str(out)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                sys.exit(f"times failed in {repo}:\n{r.stdout}\n{r.stderr}")
            rows.append(json.loads(r.stdout.strip().splitlines()[-1]))
            print(json.dumps(rows[-1]), flush=True)
            saved[i] = {f.stem: np.load(f) for f in out.glob("*.npy")}
    for k in rows[0]["ms"]:
        if k not in rows[1]["ms"]:
            continue
        par = (rows[0]["ms"][k] + rows[3]["ms"][k]) / 2
        new = (rows[1]["ms"][k] + rows[2]["ms"][k]) / 2
        print(f"{k}: parent {rows[0]['ms'][k]:.3f} / {rows[3]['ms'][k]:.3f} "
              f"ms, change {rows[1]['ms'][k]:.3f} / {rows[2]['ms'][k]:.3f} ms"
              f", parent / change = {par / new:.3f}  [{rows[0]['card']}]")
    differ = []
    for k in SAME_BITS + REPORTED_BITS:
        if k not in saved[0] or k not in saved[1]:
            continue
        runs = [saved[i][k] for i in range(4)]
        same = all(np.array_equal(runs[0], x) for x in runs[1:])
        print(f"[bits] {k}: change's output {'bit-identical to' if same else 'DIFFERS from'} "
              f"the parent's (two runs each, max abs difference "
              f"{float(np.abs(runs[1] - runs[0]).max()):.3g})  "
              f"[{rows[0]['card']}]")
        if not same and k in SAME_BITS:
            differ.append(k)
    if differ:
        sys.exit(f"outputs differ from the parent's: {differ}")


def _device_profile(torch, tag, card, run, n):
    """Profile ``run()`` (n iterations or calls) and print the device's busy
    time per iteration, its idle share of the window and the ten kernels
    that take most of it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        sys.exit("the profiler recorded no device events")
    busy = sum(e.device_time for e in ev) / (n * 1e3)
    span = (max(e.time_range.end for e in ev)
            - min(e.time_range.start for e in ev)) / (n * 1e3)
    by = {}
    for e in ev:
        by[e.name] = by.get(e.name, 0.0) + e.device_time / (n * 1e3)
    print(f"[profile] {tag}: device busy {busy:.3f} ms per iteration in a "
          f"window of {span:.3f} ms: idle share "
          f"{100 * (1 - busy / span):.1f} %  [{card}]")
    for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[profile]   {v:8.3f} ms  {k[:100]}")
    return busy


def cmd_profile(args):
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from prosper_tpu_torch import EM, LinearAnnealing
    from prosper_tpu_torch.core.etstep import slot_sum_ss
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi()
    which = args.only.split(",") if args.only else PROFILED
    for name, (model, y, init) in setups(torch, np, which).items():
        for tag, T, ncut in (("annealed, Ncut on", 1.5, 0.5),
                             ("saturated", 1.0, 1.0)):
            a = LinearAnnealing(8)
            a["T"], a["Ncut_factor"] = T, ncut
            em = EM(model, a, {"y": y}, params=init, seed=4,
                    device=torch.device("cuda"))
            for _ in range(3):
                em.step_once()
            torch.cuda.synchronize()
            print(f"[profile] {name} {tag}: host clock per iteration, run "
                  f"{em.history[-1]['dt'] * 1e3:.3f} ms (unprofiled)  "
                  f"[{card}]")
            busy = _device_profile(torch, f"{name} {tag}, run", card,
                                   lambda: [em.step_once() for _ in range(4)],
                                   4)
            if name.startswith("gsc"):
                # slot_sum_ss alone at the chunk's shape, once per chunk
                C, Hp, H = model.chunk, model.Hprime, model.H
                gen = torch.Generator(device="cuda").manual_seed(0)
                cand = torch.rand(C, H, generator=gen, device="cuda").argsort(
                    dim=1)[:, :Hp]
                ssw = torch.randn(C, Hp * Hp, generator=gen, device="cuda")
                ms = cuda_ms(torch, lambda: slot_sum_ss(ssw, cand, H)) * (
                    y.shape[0] // C)
                print(f"[profile] {name} {tag}: slot_sum_ss {ms:.3f} ms per "
                      f"iteration ({y.shape[0] // C} chunks of {C} rows) = "
                      f"{100 * ms / busy:.1f} % of the busy time  [{card}]")
            a = LinearAnnealing(12)
            a["T"], a["Ncut_factor"] = T, ncut
            em = EM(model, a, {"y": y}, params=init, seed=4,
                    device=torch.device("cuda"))
            em.run_scanned(4)              # one eager step, the capture
            torch.cuda.synchronize()
            _device_profile(torch, f"{name} {tag}, run_scanned", card,
                            lambda: em.run_scanned(4), 4)
            if em.scan_stats["replays"] != 7:
                sys.exit(f"run_scanned did not replay: {em.scan_stats}")
            print(f"[profile] {name} {tag}: host clock per iteration, "
                  f"run_scanned {em.history[-1]['dt'] * 1e3:.3f} ms  [{card}]")
        if name == "bsc":        # serving: 8192 rows from the card and from
            held = y[:N_DECODE].contiguous()                  # host memory
            for tag, data in (("tensor on the card", held),
                              ("numpy array", held.cpu().numpy())):
                def serve():
                    return [model.inference(init, {"y": data}, top_L=10,
                                            dense_states=False)
                            for _ in range(4)]
                serve()
                torch.cuda.synchronize()
                _device_profile(torch, f"bsc inference of {N_DECODE} rows, "
                                f"{tag}", card, serve, 4)


def cmd_capture(args):
    sys.path.insert(0, str(ROOT))
    import gc
    import numpy as np
    import torch
    from prosper_tpu_torch import EM, LinearAnnealing
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi()
    plain_capture = EM._capture

    def cleared_first(self, scan, pattern):
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        return plain_capture(self, scan, pattern)

    for name, (model, y, init) in setups(torch, np).items():
        def one(capture):
            EM._capture = capture
            a = LinearAnnealing(8)
            a["T"], a["Ncut_factor"] = 1.5, 0.5
            em = EM(model, a, {"y": y}, params=init, seed=4,
                    device=torch.device("cuda"))
            em.run_scanned(4)
            torch.cuda.synchronize()
            if em.scan_stats["graphs"] != 1 or em.scan_stats["replays"] != 3:
                sys.exit(f"run_scanned did not replay: {em.scan_stats}")
            return (em.scan_stats["capture_s"] * 1e3,
                    torch.cuda.memory_reserved() / 2 ** 20)
        one(plain_capture)                        # kernels built, tables made
        ms = [one(c) for c in (plain_capture, cleared_first, cleared_first,
                               plain_capture)]
        EM._capture = plain_capture
        print(f"[capture] {name}: one capture as it is {ms[0][0]:.1f} / "
              f"{ms[3][0]:.1f} ms, after synchronize + gc.collect + "
              f"empty_cache {ms[1][0]:.1f} / {ms[2][0]:.1f} ms; MiB reserved "
              f"afterwards {ms[0][1]:.0f} / {ms[3][1]:.0f} and {ms[1][1]:.0f} "
              f"/ {ms[2][1]:.0f}  [{card}]", flush=True)


def cmd_ablate(args):
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import numpy as np
    import torch
    from prosper_tpu_torch.ops import cuda_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi()
    src = cuda_lib.CSRC
    base = None
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, fname, old, *new) in enumerate(
                [("nothing", None, "", "")]
                + [a for a in ABLATIONS + VARIANTS if args.only in a[0]]):
            new = new[0] if new else None
            d = Path(tmp) / f"v{i}"
            shutil.copytree(src, d)
            if fname:
                text = (d / fname).read_text() if (d / fname).exists() else ""
                pairs = old if isinstance(old, list) else [(old, new)]
                if any(text.count(o) < 1 for o, _ in pairs):
                    # another tree may lack a kernel; this checkout may not
                    if Path(args.repo).resolve() == ROOT:
                        sys.exit(f"{fname}: the text of {name!r} not found")
                    print(f"[ablate] without {name}: not in {args.repo}'s "
                          f"{fname}, skipped  [{card}]", flush=True)
                    continue
                for o, n in pairs:
                    text = text.replace(o, n)
                (d / fname).write_text(text)
            cuda_lib.CSRC, cuda_lib._lib = d, None
            calls = kernel_calls(torch, np) if i == 0 else calls
            # the GEMMs take a tenth of a millisecond: more launches a timing
            ms = {k: cuda_ms(torch, calls[k], 50 if "gemm" in k else 5)
                  for k in ABLATED if k in calls}
            base = base or ms
            print(f"[ablate] without {name}: " + ", ".join(
                f"{k} {ms[k]:.3f} ms (saves {base[k] - ms[k]:.3f})"
                for k in ms) + f"  [{card}]", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("times")
    t.add_argument("--repo", default=str(ROOT))
    t.add_argument("--save", default="",
                   help="a directory for the GEMM wrappers' outputs (.npy)")
    t.set_defaults(fn=cmd_times)
    c = sub.add_parser("compare")
    c.add_argument("--parent", required=True)
    c.set_defaults(fn=cmd_compare)
    p = sub.add_parser("profile")
    p.add_argument("--only", default="",
                   help="comma-separated subset of " + ",".join(PROFILED))
    p.set_defaults(fn=cmd_profile)
    sub.add_parser("capture").set_defaults(fn=cmd_capture)
    a = sub.add_parser("ablate")
    a.add_argument("--only", default="",
                   help="only the parts whose name contains this text")
    a.add_argument("--repo", default=str(ROOT),
                   help="the tree whose sources are edited (default: this "
                        "checkout)")
    a.set_defaults(fn=cmd_ablate)
    args = ap.parse_args()
    os.chdir(ROOT)
    args.fn(args)


if __name__ == "__main__":
    main()
