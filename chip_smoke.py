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
  planted-dictionary rows and a decode of 8192 held-out rows;
* the max family: MCA bars through ``EM.run`` on CUDA, one softened-max
  step (rho > 0, the plain version on the card) against the CPU, then MCA
  and MMCA at the patches width of bench.py (D=256, H=300, H'=6, gamma=3,
  35 multi states) on 131072 rows, each with a decode of 8192 rows;
* the big-S linear E-step (``s_block > 0``): TSC at the width of bench.py's
  tsc_bigs (D=64, H=32, H'=10, gamma=5, 12564 multi states, s_block=1024),
  an annealed EM run on 131072 planted-dictionary rows through the big-S
  kernel and a plain decode of 8192 held-out rows.

Each path's launch counts are set to 0 just before it and checked just
after.  Every phase raises on failure.  Prints one JSON line of per-kernel
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
# published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores, and device memory
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def log(*a):
    print(*a, flush=True)


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


def gemm_phase(torch, np, dev, smi, err):
    """The two GEMM kernels against float64 ``torch.matmul``: exactly on
    inputs quantised to 1/4 (every product and partial sum is then exact in
    float32), within rounding on Gaussian ones, repeated calls
    bit-identical; then their times at the main path's shape beside
    ``torch.matmul`` in float32 (the library call, which the port never
    makes).  Returns each kernel's times for the JSON line."""
    from prosper_tpu_torch.ops import gemm_cuda

    gen = torch.Generator(device=dev).manual_seed(7)
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
    log(f"[gemm] sgemm_nn and sgemm_tn_splitn agree with float64 matmul at "
        f"{len(shapes)} shapes (exactly on quantised inputs; repeated calls "
        "bit-identical)")

    N, D, H = shapes[0]
    y, W, sw = draw(N, D), draw(D, H), draw(N, H)
    nn = interleaved_ms(torch, lambda: torch.matmul(y, W),
                        lambda: gemm_cuda.sgemm_nn_cuda(y, W), reps=10)
    tn = interleaved_ms(torch, lambda: torch.matmul(y.T, sw),
                        lambda: gemm_cuda.sgemm_tn_splitn_cuda(y, sw), reps=10)
    flops = 2.0 * N * D * H
    log(f"[gemm] N={N}, D={D}, H={H}: sgemm_nn {nn[0]:.3f} ms "
        f"({flops / nn[0] / 1e9:.1f} TFLOP/s) vs torch.matmul {nn[1]:.3f} ms; "
        f"sgemm_tn_splitn {tn[0]:.3f} ms ({flops / tn[0] / 1e9:.1f} TFLOP/s) "
        f"vs torch.matmul {tn[1]:.3f} ms  [{smi}]")
    nbytes = 4.0 * (N * D + D * H + N * H)
    return {name: {"ms": t[0], "plain_ms": t[1], "library_ms": t[1],
                   **bound(flops, nbytes)}
            for name, t in (("sgemm_nn", nn), ("sgemm_tn", tn))}


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

    def plain_estep_sums(params, y, weight, sched, saturated=False):
        return maxstep.max_et_estep(
            y, weight, params["W"], params["sigma"] ** 2,
            model._log_odds(params), sa, Hp, False, sched["beta"],
            sched["prior_beta"], chunk=model.chunk,
            collect_true=not saturated)

    plain_model = MCA(D, H, Hp, gamma)
    plain_model.estep_sums = plain_estep_sums
    em_p = EM(plain_model, patches_anneal(iters), {"y": y_dev}, params=init,
              seed=4, device=dev)
    em_p.run()
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
    return {"launches": launches, "ms": est[0], "plain_ms": est[1],
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
    # logits and moments are sums in another order than cuBLAS's, hence F
    # (and the running max) within rtol 1e-4, every sum within rtol 1e-3
    rng = np.random.default_rng(11)
    shapes = [  # (name, N, D, H, Hp, gamma, values, signed, s_block)
        ("bsc", 1000, 16, 12, 6, 4, (1.0,), False, 48),
        ("tsc", 1000, 16, 12, 6, 4, (-1.0, 1.0), True, 48),
        ("dsc", 999, 16, 12, 6, 4, (-1.0, 1.0, 2.0), True, 48),
        ("tsc_bigs", 16384, 64, 32, 10, 5, (-1.0, 1.0), True, 1024),
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

    def plain_estep_sums(params, y, weight, sched, saturated=False):
        return etstep.linear_et_estep(
            y, weight, params["W"], params["sigma"] ** 2,
            model.log_odds(params), sa, Hp, True, sched["beta"],
            sched["prior_beta"], chunk=model.chunk,
            collect_true=not saturated, s_block=s_block)

    plain_model = TSC(D, H, Hp, gamma, chunk=8192, s_block=s_block)
    plain_model.estep_sums = plain_estep_sums
    em_p = EM(plain_model, patches_anneal(iters), {"y": y_dev}, params=init,
              seed=4, device=dev)
    em_p.run()
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
    # logits, moments and the un-annealed logits per (row, state), over the
    # operands the kernel is handed and the moments it returns
    nA = kargs[0].shape[1] + kargs[1].shape[1] + 2
    nB = nA + kargs[4].shape[1]
    return {"launches": launches, "ms": est[0], "plain_ms": est[1],
            **bound(2.0 * (2 * nA + nB) * N * S,
                    4.0 * (N * (nA - 2) + S * (nA + nB) + N * (nB + 4)))}


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
    for line in cuda_lib.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log("[build]", line.strip())
    lib = cuda_lib.load_library()
    for name, smem in (
            ("linear E-step rows kernel (H=300, H'=8, S=154, K=1)",
             lib.linear_et_rows_smem_bytes(300, 8, 154, 1)),
            ("max E-step kernel (D=256, H=300, H'=6, S=35)",
             lib.max_et_smem_bytes(256, 300, 6, 35))):
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
            torch.cuda.synchronize()
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
            "versions (beta 0.6 and 1, collect_true on/off bit-identical)")

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
                               sgemm_nn=iters, sgemm_tn=iters)
    log(f"[patches] launches on the main path: {launches}")
    check_path(torch, np, "[patches]", em, serve, H)

    # timing: kernel path against the plain version on the card
    em_ms = float(np.median([h["dt"] for h in em.history[1:]])) * 1e3
    sa = model.state_arrays(dev)

    def plain_estep_sums(params, y, weight, sched, saturated=False):
        return etstep.linear_et_estep(
            y, weight, params["W"], params["sigma"] ** 2,
            model.log_odds(params), sa, Hp, False, sched["beta"],
            sched["prior_beta"], chunk=model.chunk,
            collect_true=not saturated)

    plain_model = BSC(D, H, Hp, gamma, chunk=8192)
    plain_model.estep_sums = plain_estep_sums
    em_p = EM(plain_model, patches_anneal(), {"y": y_dev}, params=init,
              seed=4, device=dev)
    em_p.run()
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

    # ---- 7.-10. the max family -----------------------------------------------
    mx = max_family(torch, np, dev, smi, err, patches_anneal)

    # ---- 11.-12. the big-S linear E-step ------------------------------------
    bg = bigs_path(torch, np, dev, smi, err, patches_anneal)

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

    def gemm_launches(name):
        return launches[name] + mxl[name]

    kernels = [
        {"name": "linear_et_estep", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/linear_et_estep.cu",
         "replaces": "prosper_tpu/ops/linear_pallas.py:244",
         "launches": launches["estep"], "max_abs_err": err["estep"],
         "ms": est[0], "plain_ms": est[1], **est_bound, "library_ms": None},
        {"name": "linear_et_decode", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/linear_et_decode.cu",
         "replaces": "prosper_tpu/ops/linear_pallas.py:435",
         "launches": launches["decode"], "max_abs_err": err["decode"],
         "ms": dec[0], "plain_ms": dec[1], **dec_bound, "library_ms": None},
        {"name": "max_et_estep", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/max_et_estep.cu",
         "replaces": "prosper_tpu/ops/max_pallas.py:559; "
                     "prosper_tpu/ops/max_pallas.py:433",
         "launches": mxl["max_estep"], "max_abs_err": err["max_estep"],
         **mx, "library_ms": None},
        {"name": "bigs_multi", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/bigs_multi.cu",
         "replaces": "prosper_tpu/ops/bigs_pallas.py:155",
         "launches": bgl["bigs"], "max_abs_err": err["bigs"], **bg,
         "library_ms": None},
        # the two products inside the bodies of the E-step TPU kernels; one
        # launch per E-step of the linear and of the MCA patches path
        {"name": "sgemm_nn", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/sgemm.cu",
         "replaces": "prosper_tpu/ops/linear_pallas.py:63; "
                     "prosper_tpu/ops/max_pallas.py:65",
         "launches": gemm_launches("sgemm_nn"),
         "max_abs_err": err["sgemm_nn"], **gm["sgemm_nn"]},
        {"name": "sgemm_tn_splitn", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/sgemm.cu",
         "replaces": "prosper_tpu/ops/linear_pallas.py:179; "
                     "prosper_tpu/ops/max_pallas.py:169",
         "launches": gemm_launches("sgemm_tn"),
         "max_abs_err": err["sgemm_tn"], **gm["sgemm_tn"]},
    ]
    for k in kernels:
        log(f"[kernels] {k['name']}: {k['ms']:.3f} ms, bound "
            f"{k['bound_ms']:.3f} ms by {k['bound_by']} "
            f"({100 * k['bound_ms'] / k['ms']:.1f} % of it), "
            f"{k['launches']} launches  [{smi}]")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
