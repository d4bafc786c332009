#!/usr/bin/env python3
"""Smoke run of prosper_tpu_torch (the PyTorch + CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from prosper_tpu_torch/csrc with nvcc, holds
each kernel against its plain PyTorch version on the card, recovers the
bars through ``EM.run`` on CUDA, then drives the main path at the width of
the repo's headline configuration (BSC on 16x16 patches: D=256, H=300,
H'=8, gamma=4, 154 multi states) -- an annealed EM run on 131072 planted-
dictionary rows and a decode of 8192 held-out rows -- and checks that the
run went through both kernels.  Every phase raises on failure.  Prints one
JSON line of per-kernel results and ends with
{"ok": true, "device": {"platform": "gpu", ...}}.
Exits non-zero without a result when no CUDA device is present.
"""

import json
import subprocess
import sys
import time

BARS_SEED = 0          # a seed whose noisy bars run recovers all 10 bars


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
    from prosper_tpu_torch.ops import linear_cuda

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
    linear_cuda.load_library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in linear_cuda.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log("[build]", line.strip())

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
    err = {"estep": 0.0, "decode": 0.0}
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
    linear_cuda.LAUNCHES.update(estep=0, decode=0)
    em = EM(model, anneal, {"y": data["y"]}, seed=BARS_SEED, device=dev)
    params = em.run()
    n_rec = count_recovered_bars(params["W"].cpu().numpy(), gt["W"], 0.85)
    sig, pi = float(params["sigma"]), float(params["pi"])
    log(f"[bars] {n_rec}/10 bars, sigma {sig:.4f}, pi {pi:.4f}, "
        f"E-step launches {linear_cuda.LAUNCHES['estep']}")
    if n_rec != 10 or abs(sig - 2.0) >= 0.3 or abs(pi - 0.2) >= 0.08:
        raise AssertionError("bars not recovered on the card")
    if linear_cuda.LAUNCHES["estep"] != 60:
        raise AssertionError("the bars run did not take the E-step kernel "
                             "once per iteration")

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

    def patches_anneal():
        a = LinearAnnealing(iters)
        a["T"] = [(0.0, 2.0), (0.6, 1.0)]
        a["W_noise"] = [(0.0, 0.5), (0.6, 0.0)]
        a["Ncut_factor"] = [(0.4, 0.0), (1.0, 1.0)]
        return a

    y_dev = torch.tensor(data["y"], device=dev)
    torch.cuda.synchronize()
    linear_cuda.LAUNCHES.update(estep=0, decode=0)
    em = EM(model, patches_anneal(), {"y": y_dev}, params=init, seed=4,
            device=dev)
    params = em.run()
    serve = {dense: model.inference(params, held_out, top_L=10,
                                    dense_states=dense)
             for dense in (False, True)}
    torch.cuda.synchronize()
    launches = dict(linear_cuda.LAUNCHES)
    log(f"[patches] launches on the main path: {launches}")
    if launches != {"estep": iters, "decode": 2}:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"{iters} E-steps and 2 decodes")
    Q = [h["Q_mean"] for h in em.history]
    log("[patches] Q_mean by iteration: " + " ".join(f"{q:.3f}" for q in Q))
    log("[patches] n_used by iteration: "
        + " ".join(f"{h['n_used']:.0f}" for h in em.history))
    if not (np.isfinite(Q).all() and Q[-1] > Q[0]):
        raise AssertionError("Q_mean is not finite or did not rise")
    if not torch.isfinite(em.data["F_prev"]).all():
        raise AssertionError("non-finite F")
    compact, dense = serve[False], serve[True]
    for out in (compact, dense):
        for k in ("F", "s_mean", "recon", "top_probs"):
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"non-finite {k} in the decode")
        if (out["top_probs"][:, 1:] > out["top_probs"][:, :-1]).any():
            raise AssertionError("top_probs not in descending order")
    if not torch.equal(etstep.densify_top_states(compact, H),
                       dense["top_states"]):
        raise AssertionError("compact decode does not densify to the dense")
    if dense["top_states"].shape != (8192, 10, H):
        raise AssertionError("dense top_states has the wrong shape")

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

    kernels = [
        {"name": "linear_et_estep", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/linear_et_estep.cu",
         "replaces": "prosper_tpu/ops/linear_pallas.py:244",
         "launches": launches["estep"], "max_abs_err": err["estep"],
         "ms": est[0], "plain_ms": est[1]},
        {"name": "linear_et_decode", "route": "cuda",
         "source": "prosper_tpu_torch/csrc/linear_et_decode.cu",
         "replaces": "prosper_tpu/ops/linear_pallas.py:435",
         "launches": launches["decode"], "max_abs_err": err["decode"],
         "ms": dec[0], "plain_ms": dec[1]},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
