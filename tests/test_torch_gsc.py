"""The port's GSC (spike-and-slab sparse coding) against the JAX package.

Each case hands both packages the same numpy inputs.  The E-step is held to
JAX's ``gsc_et_estep`` (F and the sums within rtol 1e-4: both are float32,
summed in another order) and to a float64 brute-force oracle (rtol 5e-3, as
``tests/test_gsc_oracle.py`` holds JAX's); one ``step_fn`` to JAX's
``jit_step`` (no noise, ``partial`` = 1; rtol 1e-4) and the decode to JAX's
``GSC.inference``.  The small solvers are held to float64 numpy.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp

from prosper_tpu.core.etstep import state_arrays_from as jax_sa
from prosper_tpu.core.gscstep import _gsc_level_plan as jax_level_plan
from prosper_tpu.core.gscstep import gsc_et_estep as jax_estep
from prosper_tpu.core.states import binary_state_space as jax_space
from prosper_tpu.engine.anneal import LinearAnnealing as JAnneal
from prosper_tpu.models import gsc as jgsc
from prosper_tpu.models.base import make_blank_data as j_blank
from prosper_tpu.models.base import sched_from_anneal
from prosper_tpu_torch import EM, LinearAnnealing
from prosper_tpu_torch.core import etstep as tet
from prosper_tpu_torch.core import gscstep
from prosper_tpu_torch.core.states import binary_state_space
from prosper_tpu_torch.data.bars import bars_gt_params, count_recovered_bars
from prosper_tpu_torch.io.weights import params_from_numpy
from prosper_tpu_torch.models import GSC
from prosper_tpu_torch.models.base import (device_sched, make_blank_data,
                                           sched_floats)

KEYS = ("xs", "ss", "s", "abs", "y2", "n", "F", "F_true")


# -- the small solvers ----------------------------------------------------------

def _spd(n, batch, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((batch, n, n))
    return (A @ A.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_solvers_entry_wise_and_padded_agree_with_float64(n):
    """Cholesky factor, log-det, solve and inverse of 64 random SPD
    matrices: the entry-wise form, the padded tensor form and float64
    numpy within rtol 1e-4 (float32 recurrences)."""
    M = _spd(n, 64, seed=n)
    b = np.random.default_rng(10 + n).standard_normal((64, n)).astype(
        np.float32)
    Mt, bt = torch.tensor(M), torch.tensor(b)
    M64 = M.astype(np.float64)
    L64 = np.linalg.cholesky(M64)
    want = dict(L=L64, logdet=np.linalg.slogdet(M64)[1],
                x=np.linalg.solve(M64, b.astype(np.float64)[..., None])[..., 0],
                inv=np.linalg.inv(M64))

    L = gscstep.chol_small(Mt)
    padded = dict(L=L, logdet=gscstep.cho_logdet_small(L),
                  x=gscstep.cho_solve_vec_small(L, bt),
                  inv=gscstep.cho_inverse_small(L))
    Lb = gscstep.chol_bl([[Mt[:, i, j] for j in range(n)] for i in range(n)])
    zero = torch.zeros(64)
    Sig = gscstep.inverse_bl(Lb)
    entry = dict(
        L=torch.stack([torch.stack([Lb[i][j] if j <= i else zero
                                    for j in range(n)], -1)
                       for i in range(n)], -2),
        logdet=gscstep.logdet_bl(Lb),
        x=torch.stack(gscstep.solve_bl(Lb, [bt[:, i] for i in range(n)]), -1),
        inv=torch.stack([torch.stack(Sig[i], -1) for i in range(n)], -2))
    for k in want:
        for form in (padded, entry):
            np.testing.assert_allclose(form[k].numpy(), want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    # the pivot clamp: a zero matrix gives a finite factor
    assert torch.isfinite(gscstep.chol_small(torch.zeros(2, n, n))).all()
    assert torch.isfinite(gscstep.chol_bl([[zero] * n] * n)[n - 1][n - 1]).all()


@pytest.mark.parametrize("Hp,gamma", [(5, 3), (6, 3), (6, 4), (3, 2)])
def test_level_plan_covers_every_state_once(Hp, gamma):
    act = binary_state_space(Hp, gamma).states > 0.5
    plan = gscstep._gsc_level_plan(act)
    jplan = jax_level_plan(np.asarray(jax_space(Hp, gamma).states) > 0.5)
    assert len(plan) == len(jplan) == gamma - 1
    rebuilt = np.zeros_like(act)
    for (off, idx), (joff, jidx) in zip(plan, jplan):
        assert off == joff
        np.testing.assert_array_equal(idx, jidx)
        for r, slots in enumerate(idx):
            assert not rebuilt[off + r].any()
            rebuilt[off + r, slots] = True
    np.testing.assert_array_equal(rebuilt, act)


def test_levels_are_built_once_per_state_table():
    sa = tet.state_arrays_from(binary_state_space(5, 3), "cpu")
    levels = gscstep.gsc_levels(sa)
    assert gscstep.gsc_levels(sa) is levels
    other = tet.state_arrays_from(binary_state_space(5, 3), "cpu")
    assert gscstep.gsc_levels(other) is not levels
    assert [(lv.off, lv.S, lv.m) for lv in levels] == [(0, 10, 2),
                                                       (10, 10, 3)]
    # each table sums a level's values into the slots its states hold
    for lv in levels:
        assert torch.equal(lv.E.sum(dim=2), torch.ones(lv.m, lv.S))
        assert torch.equal(lv.EE.sum(dim=2), torch.tensor(
            [[1.0 if i == j else 2.0] * lv.S for i, j in lv.pairs]))


# -- the E-step -------------------------------------------------------------------

def gsc_oracle(y, W, sigma, pi, mu, psi, Hp, gamma, candidates, beta=1.0,
               prior_beta=1.0):
    """Explicit per-support Gaussian algebra in float64 (the oracle of
    ``tests/test_gsc_oracle.py``)."""
    y = np.asarray(y, np.float64)
    W = np.asarray(W, np.float64)
    N, D = y.shape
    H = W.shape[1]
    sigma2 = sigma ** 2
    lo = np.log(pi) - np.log(1 - pi)
    sums = dict(xs=np.zeros((D, H)), ss=np.zeros((H, H)), s=np.zeros(H),
                abs=0.0, y2=0.0, n=0.0, F=0.0)
    F_out = np.zeros(N)
    for n in range(N):
        supports = [()] + [(h,) for h in range(H)]
        for k in range(2, gamma + 1):
            for sup in itertools.combinations(range(Hp), k):
                supports.append(tuple(int(candidates[n][i]) for i in sup))
        logits, stats = [], []
        for sup in supports:
            k = len(sup)
            if k == 0:
                lik, kap, Sig = 0.0, None, None
            else:
                Ws = W[:, list(sup)]
                M = np.eye(k) / psi + Ws.T @ Ws / sigma2
                b = Ws.T @ y[n] / sigma2 + mu / psi
                Sig = np.linalg.inv(M)
                kap = Sig @ b
                lik = (-0.5 * k * np.log(psi) - 0.5 * np.linalg.slogdet(M)[1]
                       - k * mu * mu / (2 * psi) + 0.5 * b @ kap)
            logits.append(beta * lik + prior_beta * k * lo)
            stats.append((sup, kap, Sig))
        logits = np.array(logits)
        Fn = (logsumexp(logits) - beta * 0.5 * (y[n] @ y[n]) / sigma2
              - beta * 0.5 * D * np.log(2 * np.pi * sigma2)
              + prior_beta * H * np.log(1 - pi))
        F_out[n] = Fn
        q = np.exp(logits - logsumexp(logits))
        sz, szsz = np.zeros(H), np.zeros((H, H))
        for qi, (sup, kap, Sig) in zip(q, stats):
            if sup:
                idx = list(sup)
                sz[idx] += qi * kap
                szsz[np.ix_(idx, idx)] += qi * (Sig + np.outer(kap, kap))
                sums["abs"] += qi * len(sup)
        sums["xs"] += np.outer(y[n], sz)
        sums["ss"] += szsz
        sums["s"] += sz
        sums["y2"] += y[n] @ y[n]
        sums["n"] += 1
        sums["F"] += Fn
    return F_out, sums


def _estep_pair(y, w, W, sigma2, pi, mu, psi, Hp, gamma, beta, prior_beta,
                chunk, collect_true=True):
    """(F, sums) of the port and of JAX on the same inputs."""
    sa = tet.state_arrays_from(binary_state_space(Hp, gamma), "cpu")
    F_t, s_t = gscstep.gsc_et_estep(
        torch.tensor(y), torch.tensor(w), torch.tensor(W),
        torch.tensor(sigma2), torch.tensor(pi), torch.tensor(mu),
        torch.tensor(psi), sa, Hp, beta, prior_beta, chunk=chunk,
        collect_true=collect_true)
    jsa = jax_sa(jax_space(Hp, gamma))
    F_j, s_j = jax.jit(lambda *a: jax_estep(
        *a[:7], jsa, Hp, *a[7:], chunk=chunk, collect_true=collect_true))(
        jnp.asarray(y), jnp.asarray(w), jnp.asarray(W), jnp.float32(sigma2),
        jnp.float32(pi), jnp.float32(mu), jnp.float32(psi),
        jnp.float32(beta), jnp.float32(prior_beta))
    return F_t, s_t, np.asarray(F_j), {k: np.asarray(v) for k, v in s_j.items()}


def _assert_close_to_jax(F_t, s_t, F_j, s_j, rtol=1e-4):
    np.testing.assert_allclose(F_t.numpy(), F_j, rtol=rtol, atol=1e-4)
    assert set(s_t) == set(KEYS)
    for k in KEYS:
        scale = max(float(np.abs(s_j[k]).max()), 1.0)
        np.testing.assert_allclose(s_t[k].numpy(), s_j[k], rtol=rtol,
                                   atol=rtol * scale, err_msg=k)


@pytest.mark.parametrize("mu,psi,beta", [(0.0, 1.0, 1.0), (0.7, 2.5, 1.0),
                                         (0.3, 0.8, 0.4)])
def test_estep_matches_jax_and_the_oracle(mu, psi, beta):
    """The three slab cases of ``tests/test_gsc_oracle.py``; H' = H, so the
    candidates are all units whatever the ties."""
    N, D, H, Hp, gamma = 10, 8, 5, 5, 3
    rng = np.random.default_rng(8)
    W = rng.standard_normal((D, H)).astype(np.float32)
    y = (rng.standard_normal((N, D)) * 1.5).astype(np.float32)
    w = np.ones(N, np.float32)
    F_t, s_t, F_j, s_j = _estep_pair(y, w, W, 1.1 ** 2, 0.25, mu, psi, Hp,
                                     gamma, beta, 1.0, chunk=2048)
    _assert_close_to_jax(F_t, s_t, F_j, s_j)
    F_o, s_o = gsc_oracle(y, W, 1.1, 0.25, mu, psi, Hp, gamma,
                          np.tile(np.arange(H), (N, 1)), beta=beta)
    np.testing.assert_allclose(F_t.numpy(), F_o, rtol=5e-4, atol=5e-4)
    for k in s_o:
        np.testing.assert_allclose(s_t[k].numpy(), s_o[k], rtol=5e-3,
                                   atol=5e-3, err_msg=k)


@pytest.mark.parametrize("case", ["chunks", "zero_weights", "no_true",
                                  "prior_beta"])
def test_estep_matches_jax_with_candidates(case):
    """H' < H (the candidates matter), 192 rows: in chunks of 64 against
    one, rows of weight 0, the un-annealed channel off, prior_beta < 1."""
    N, D, H, Hp, gamma = 192, 12, 10, 5, 3
    rng = np.random.default_rng(5)
    W = rng.standard_normal((D, H)).astype(np.float32)
    y = (rng.standard_normal((N, D)) * 1.5).astype(np.float32)
    w = (rng.random(N) > 0.1).astype(np.float32)
    if case == "zero_weights":
        w[:100] = 0.0
    chunk = 64 if case == "chunks" else N
    out = _estep_pair(y, w, W, 0.8, 0.12, 0.3, 1.4, Hp, gamma,
                      0.7 if case != "no_true" else 1.0,
                      0.5 if case == "prior_beta" else 1.0, chunk,
                      collect_true=case != "no_true")
    _assert_close_to_jax(*out)
    if case == "no_true":
        assert torch.equal(out[1]["F_true"], out[1]["F"])
    if case == "chunks":
        sa = tet.state_arrays_from(binary_state_space(Hp, gamma), "cpu")
        one = gscstep.gsc_et_estep(
            *(torch.tensor(a) for a in (y, w, W)), 0.8, 0.12, 0.3, 1.4, sa,
            Hp, 0.7, 1.0, chunk=N)
        assert torch.equal(one[0], out[0])          # F row by row
        for k in KEYS:
            torch.testing.assert_close(out[1][k], one[1][k], rtol=1e-5,
                                       atol=1e-5)


def test_estep_rejects_a_chunk_that_does_not_split_n():
    sa = tet.state_arrays_from(binary_state_space(5, 3), "cpu")
    y = torch.zeros(100, 8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        gscstep.gsc_et_estep(y, torch.ones(100), torch.ones(8, 6), 1.0, 0.2,
                             0.0, 1.0, sa, 5, 1.0, 1.0, chunk=64)


# -- one EM step ------------------------------------------------------------------

def _step_inputs(seed=3, N=128, D=16, H=8):
    rng = np.random.default_rng(seed)
    gt = {"W": rng.standard_normal((D, H)).astype(np.float32) * 3.0,
          "pi": np.float32(0.2), "sigma": np.float32(0.5),
          "mu": np.float32(1.0), "psi": np.float32(0.5)}
    y = GSC(D, H, 5, 3).generate_data(gt, N, seed=seed)["y"]
    F_prev = (rng.standard_normal(N) * 5 - 40).astype(np.float32)
    return y, F_prev


@pytest.mark.parametrize("ncut", ["off", "lagged", "current"])
@pytest.mark.parametrize("T", [1.5, 1.0])
def test_step_matches_jax_jit_step(ncut, T):
    """No noise, ``partial`` = 1: annealed (T = 1.5) and saturated, the
    data cut off, ranked by F_prev (lagged) and by this iteration's F
    (``ncut_current``).  Parameters, F and scalars within rtol 1e-4."""
    D, H, Hp, gamma = 16, 8, 5, 3
    y, F_prev = _step_inputs()
    kw = dict(chunk=64, ncut_current=ncut == "current")
    jm, tm = jgsc.GSC(D, H, Hp, gamma, **kw), GSC(D, H, Hp, gamma, **kw)
    p_np = {k: np.asarray(v) for k, v in
            jm.standard_init({"y": y}, seed=1).items()}
    p_np["mu"], p_np["psi"] = np.float32(0.4), np.float32(0.7)
    p_np["pi"] = np.float32(0.3)            # the cut keeps about 88 %
    a, ja = LinearAnnealing(10), JAnneal(10)
    for x in (a, ja):
        x["T"] = T
        x["Ncut_factor"] = 0.0 if ncut == "off" else 0.6
    saturated = T == 1.0
    jdata = dict(j_blank(y), F_prev=jnp.asarray(F_prev))
    p_j, F_j, s_j = jm.jit_step(saturated)(
        {k: jnp.asarray(v) for k, v in p_np.items()}, jdata,
        sched_from_anneal(ja), jax.random.PRNGKey(0))
    tdata = dict(make_blank_data(y, device="cpu"),
                 F_prev=torch.tensor(F_prev))
    p_t, F_t, s_t = tm.step_fn(params_from_numpy(p_np, "cpu"), tdata,
                               sched_floats(a), torch.Generator())
    assert set(p_t) == set(p_j) == set(GSC.param_names)
    for k in p_t:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=1e-4)
    for k in s_j:
        np.testing.assert_allclose(float(s_t[k]), float(s_j[k]), rtol=1e-4,
                                   err_msg=k)
    if saturated:
        assert float(s_t["Q"]) == float(s_t["F_total"])
    if ncut != "off":
        assert float(s_t["n_used"]) < 128


def test_unported_options_raise():
    y = np.zeros((8, 16), np.float32)
    model = GSC(16, 8, 5, 3)
    params = model.standard_init({"y": y}, device="cpu")
    sched = sched_floats(LinearAnnealing(2))
    data = make_blank_data(y, device="cpu")
    # state sharding is ported (tests/test_torch_state_sharding.py): more
    # than one state shard needs the state group, and a state axis of one
    # shard runs unsharded, bit for bit
    ref = model.step_fn(params, data, sched, torch.Generator())
    with pytest.raises(ValueError, match="state group"):
        model.step_fn(params, data, sched, torch.Generator(),
                      n_state_shards=2)
    with pytest.raises(ValueError, match="state group"):
        model.estep_sums(params, data["y"], data["valid"],
                         device_sched(sched, "cpu"), state_axis="s",
                         n_state_shards=2)
    for shard in ({"state_axis": "s"}, {"n_state_shards": 1}):
        got = model.step_fn(params, data, sched, torch.Generator(), **shard)
        for k in ref[0]:
            assert torch.equal(got[0][k], ref[0][k]), k
        assert torch.equal(got[1], ref[1])
    # sharded serving is ported (tests/test_torch_mesh.py): a MeshRuntime
    with pytest.raises(TypeError, match="MeshRuntime"):
        model.inference(params, {"y": y}, runtime=object())
    # the port's GSC selects its E-step as MCA does (the JAX class has no
    # kernel and no backend): "plain" is the plain version on any device,
    # the same bits as the default on a CPU tensor; other names raise
    with pytest.raises(ValueError, match="backend"):
        GSC(16, 8, 5, 3, backend="triton")
    plain = GSC(16, 8, 5, 3, backend="xla")
    assert (model.backend, plain.backend) == ("cuda", "plain")
    got = plain.step_fn(params, data, sched, torch.Generator())
    for k in ref[0]:
        assert torch.equal(got[0][k], ref[0][k]), k
    assert torch.equal(got[1], ref[1])


def test_init_and_generation_follow_jax():
    D, H = 16, 8
    y, _ = _step_inputs()
    p_t = GSC(D, H, 5, 3).standard_init({"y": y}, seed=2, device="cpu")
    p_j = jgsc.GSC(D, H, 5, 3).standard_init({"y": y}, seed=2)
    assert set(p_t) == set(p_j) == {"W", "pi", "sigma", "mu", "psi"}
    for k in p_t:
        np.testing.assert_array_equal(p_t[k].numpy(), np.asarray(p_j[k]))
    gt = {"W": np.ones((D, H), np.float32), "pi": np.float32(0.3),
          "sigma": np.float32(0.5), "mu": np.float32(1.0),
          "psi": np.float32(0.2)}
    a = GSC(D, H, 5, 3).generate_data(gt, 50, seed=4)
    b = jgsc.GSC(D, H, 5, 3).generate_data(gt, 50, seed=4)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# -- the decode --------------------------------------------------------------------

@pytest.mark.parametrize("dense", [True, False])
def test_inference_matches_jax(dense):
    """Every field of ``inference`` against JAX's, 300 rows in chunks of
    128, at T = 1.25: F, b_mean, s_mean and recon within rtol 1e-4, the
    top-L probabilities within 1e-5 and their states exactly."""
    D, H, Hp, gamma = 16, 8, 5, 3
    y, _ = _step_inputs(seed=6, N=300)
    jm, tm = jgsc.GSC(D, H, Hp, gamma, chunk=128), GSC(D, H, Hp, gamma,
                                                        chunk=128)
    p_np = {k: np.asarray(v) for k, v in
            jm.standard_init({"y": y}, seed=1).items()}
    p_np["mu"], p_np["psi"], p_np["pi"] = (np.float32(0.8), np.float32(0.3),
                                           np.float32(0.25))
    a, ja = LinearAnnealing(4), JAnneal(4)
    a["T"] = ja["T"] = 1.25
    out_j = jm.inference({k: jnp.asarray(v) for k, v in p_np.items()},
                         {"y": y}, top_L=6, anneal=ja, dense_states=dense)
    out_t = tm.inference(params_from_numpy(p_np, "cpu"), {"y": y}, top_L=6,
                         anneal=a, dense_states=dense)
    assert set(out_t) == set(out_j)
    for k in out_j:
        want = np.asarray(out_j[k])
        got = out_t[k].numpy()
        assert got.shape == want.shape, k
        if k in ("F", "b_mean", "s_mean", "recon"):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        elif k == "top_probs":
            np.testing.assert_allclose(got, want, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    if not dense:
        full = tm.inference(params_from_numpy(p_np, "cpu"), {"y": y},
                            top_L=6, anneal=a, dense_states=True)
        assert torch.equal(tet.densify_top_states(out_t, H),
                           full["top_states"])


def test_decode_and_estep_agree():
    """The padded form (decode) against the entry-wise form (E-step) on the
    same rows: F row by row, and the weighted sum of the slab means against
    the sums' ``s``, within rtol 1e-5."""
    D, H, Hp, gamma, N = 16, 8, 5, 3, 200
    y, _ = _step_inputs(seed=9, N=N)
    model = GSC(D, H, Hp, gamma, chunk=N)
    params = model.standard_init({"y": y}, seed=1, device="cpu")
    params["mu"], params["psi"] = torch.tensor(0.6), torch.tensor(0.4)
    w = torch.tensor((np.arange(N) % 3 > 0).astype(np.float32))
    F, sums = model.estep_sums(params, torch.tensor(y), w,
                               sched_floats(LinearAnnealing(2)))
    out = model.inference(params, {"y": y}, top_L=4)
    torch.testing.assert_close(out["F"], F, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close((out["s_mean"] * w[:, None]).sum(0),
                               sums["s"], rtol=1e-5, atol=1e-5)
    assert ((out["b_mean"] >= 0) & (out["b_mean"] <= 1 + 1e-6)).all()


# -- bars --------------------------------------------------------------------------

def test_gsc_bars_recovery_through_the_port():
    """The tuned configuration of ``examples/barstest/param_bars_gsc.py``:
    R = 4 (8 bars), slab N(1, 0.3^2), 1500 rows, 70 iterations with T 2 -> 1
    and W noise 0.5 -> 0 over the first 70 %; 8/8 bars at signed cosine
    > 0.8 through ``EM.run`` on the CPU."""
    R = 4
    model = GSC(R * R, 2 * R, 5, 3, chunk=1500)
    gt = bars_gt_params(model, intensity=5.0, sigma=1.0)
    gt["mu"], gt["psi"] = np.float32(1.0), np.float32(0.09)
    data = model.generate_data(gt, 1500, seed=31)
    anneal = LinearAnnealing(70)
    anneal["T"] = [(0.0, 2.0), (0.7, 1.0)]
    anneal["W_noise"] = [(0.0, 0.5), (0.7, 0.0)]
    params = EM(model, anneal, {"y": data["y"]}, seed=17,
                device="cpu").run()
    n_rec = count_recovered_bars(params["W"].numpy(), gt["W"],
                                 threshold=0.8, signed=True)
    assert n_rec == 2 * R, f"recovered {n_rec}/{2 * R} bars (GSC)"
    assert abs(float(params["sigma"]) - 1.0) < 0.4
