"""The port's max family (MCA, MMCA) against the JAX package.

Each case hands both packages the same numpy inputs.  The E-step is held
to the JAX XLA E-step (core/maxstep.py) and to both Pallas kernels in
interpret mode, as tests/test_max_pallas.py runs them: F within rtol 2e-5
/ atol 1e-4 and the sums within rtol 1e-4 / atol 2e-4 (the reduction
orders differ).  One EM step, the saturated switch, the decode, the bars
runs and the annealing channels follow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.core.etstep import densify_top_states as jax_densify
from prosper_tpu.core.etstep import state_arrays_from as jax_sa
from prosper_tpu.core.maxstep import max_et_estep as jax_estep
from prosper_tpu.core.states import binary_state_space as jax_space
from prosper_tpu.engine.anneal import LinearAnnealing as JAnneal
from prosper_tpu.engine.em import EM as JEM
from prosper_tpu.models import mca as jmca
from prosper_tpu.models.base import make_blank_data as j_blank
from prosper_tpu.models.base import sched_floats as j_sched_floats
from prosper_tpu.models.base import sched_from_anneal
from prosper_tpu.ops.max_pallas import (max_et_estep_pallas,
                                        max_et_estep_pallas_dtiled)
from prosper_tpu_torch import EM, LinearAnnealing
from prosper_tpu_torch.core import etstep as tet
from prosper_tpu_torch.core import maxstep
from prosper_tpu_torch.core.states import binary_state_space
from prosper_tpu_torch.data.bars import bars_gt_params, count_recovered_bars
from prosper_tpu_torch.io.weights import params_from_numpy, params_to_numpy
from prosper_tpu_torch.models import MCA, MMCA
from prosper_tpu_torch.models.base import (device_sched, make_blank_data,
                                           sched_floats)
from prosper_tpu_torch.ops import max_cuda

KEYS = ("numer", "denom", "s", "abs", "resid", "y2", "n", "F", "F_true")
FAMILY = {"mca": (jmca.MCA, MCA), "mmca": (jmca.MMCA, MMCA)}


def _inputs(D, H, Hp, gamma, N, seed, magnitude, pi=0.15, quarters=False):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((D, H)).astype(np.float32)
    if not magnitude:
        W = np.abs(W)                 # MCA is a non-negative-dictionary model
    y = (rng.standard_normal((N, D)) * 2.0).astype(np.float32)
    if quarters:
        W, y = np.round(W * 8) / 4, np.round(y * 4) / 4
    w = (rng.random(N) < 0.8).astype(np.float32)
    return dict(y=y, w=w, W=W.astype(np.float32), Hp=Hp, gamma=gamma,
                lo=np.float32(np.log(pi / (1 - pi))), magnitude=magnitude)


def _jax_args(a, sigma2, beta, prior_beta):
    return (jnp.asarray(a["y"]), jnp.asarray(a["w"]), jnp.asarray(a["W"]),
            jnp.float32(sigma2), jnp.float32(a["lo"]),
            jax_sa(jax_space(a["Hp"], a["gamma"])), a["Hp"], a["magnitude"],
            jnp.float32(beta), jnp.float32(prior_beta))


def _torch_args(a, sigma2, beta, prior_beta):
    sa = tet.state_arrays_from(binary_state_space(a["Hp"], a["gamma"]), "cpu")
    return (torch.tensor(a["y"]), torch.tensor(a["w"]), torch.tensor(a["W"]),
            torch.tensor(np.float32(sigma2)), torch.tensor(a["lo"]), sa,
            a["Hp"], a["magnitude"], beta, prior_beta)


def _assert_match(F_t, s_t, F_j, s_j, rtol=1e-4, atol=2e-4):
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=2e-5,
                               atol=1e-4)
    for k in KEYS:
        np.testing.assert_allclose(s_t[k].numpy(), np.asarray(s_j[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("magnitude", [False, True], ids=["mca", "mmca"])
@pytest.mark.parametrize("beta,prior_beta", [(1.0, 1.0), (0.5, 1.0),
                                             (0.7, 0.7)])
def test_plain_estep_matches_jax_xla(magnitude, beta, prior_beta):
    a = _inputs(16, 24, 5, 3, 160, 3, magnitude)
    F_j, s_j = jax_estep(*_jax_args(a, 1.3, beta, prior_beta), chunk=32)
    F_t, s_t = maxstep.max_et_estep(*_torch_args(a, 1.3, beta, prior_beta),
                                    chunk=32)
    _assert_match(F_t, s_t, F_j, s_j)


@pytest.mark.parametrize("magnitude", [False, True], ids=["mca", "mmca"])
def test_plain_estep_matches_resident_pallas_kernel(magnitude):
    """tests/test_max_pallas.py:34's shape, kernel in interpret mode."""
    a = _inputs(16, 24, 5, 3, 160, 3, magnitude)
    F_j, s_j = max_et_estep_pallas(*_jax_args(a, 1.3, 0.5, 1.0), tile=32,
                                   interpret=True)
    F_t, s_t = max_cuda.max_et_estep(*_torch_args(a, 1.3, 0.5, 1.0),
                                     chunk=160)
    _assert_match(F_t, s_t, F_j, s_j)


@pytest.mark.parametrize("magnitude", [False, True], ids=["mca", "mmca"])
def test_plain_estep_matches_dtiled_pallas_kernel(magnitude):
    """tests/test_max_pallas.py:137's shape (D=24 in blocks of 8)."""
    a = _inputs(24, 20, 5, 3, 96, 13, magnitude, pi=0.12)
    F_j, s_j = max_et_estep_pallas_dtiled(*_jax_args(a, 1.1, 0.6, 0.6),
                                          tile=32, d_block=8, interpret=True)
    F_t, s_t = max_cuda.max_et_estep(*_torch_args(a, 1.1, 0.6, 0.6),
                                     chunk=96)
    _assert_match(F_t, s_t, F_j, s_j)


@pytest.mark.parametrize("magnitude", [False, True], ids=["mca", "mmca"])
@pytest.mark.parametrize("rho", [2.0, 200.0])
def test_softened_max_matches_jax(magnitude, rho):
    a = _inputs(16, 12, 6, 3, 64, 11, magnitude)
    F_j, s_j = jax_estep(*_jax_args(a, 1.0, 1.0, 1.0), chunk=64,
                         rho=jnp.float32(rho))
    F_t, s_t = maxstep.max_et_estep(*_torch_args(a, 1.0, 1.0, 1.0), chunk=64,
                                    rho=rho)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=1e-4)
    for k in KEYS:
        np.testing.assert_allclose(s_t[k].numpy(), np.asarray(s_j[k]),
                                   rtol=1e-4, atol=2e-4, err_msg=k)
    _, hard = maxstep.max_et_estep(*_torch_args(a, 1.0, 1.0, 1.0), chunk=64)
    if rho == 2.0:       # a soft max spreads the responsibilities
        assert not torch.allclose(s_t["denom"], hard["denom"], atol=1e-3)


def test_all_zero_weight_gives_zero_sums_and_finite_F():
    a = _inputs(8, 16, 4, 2, 64, 9, True)
    a["w"][:] = 0.0
    F, s = maxstep.max_et_estep(*_torch_args(a, 0.8, 1.0, 1.0), chunk=32)
    for k in KEYS:
        np.testing.assert_allclose(s[k].numpy(), 0.0, atol=1e-6, err_msg=k)
    assert np.isfinite(F.numpy()).all()


def _step_inputs(family, seed=11):
    D, H, N = 16, 24, 96
    rng = np.random.default_rng(seed)
    W0 = rng.standard_normal((D, H)).astype(np.float32)
    if family == "mca":
        W0 = np.abs(W0)
    y = rng.standard_normal((N, D)).astype(np.float32)
    F_prev = (rng.standard_normal(N) * 5 - 30).astype(np.float32)
    params = {"W": W0, "pi": np.float32(0.1), "sigma": np.float32(1.0)}
    return params, y, F_prev


@pytest.mark.parametrize("family", ["mca", "mmca"])
@pytest.mark.parametrize("ncut,rho", [("lagged", 0.0), ("current", 0.0),
                                      ("lagged", 4.0)])
def test_one_step_matches_jax(family, ncut, rho):
    jcls, tcls = FAMILY[family]
    kw = dict(chunk=32, ncut_current=ncut == "current")
    jm, tm = jcls(16, 24, 4, 3, **kw), tcls(16, 24, 4, 3, **kw)
    p_np, y, F_prev = _step_inputs(family)
    a, ja = LinearAnnealing(10), JAnneal(10)
    a["T"] = ja["T"] = 1.5
    a["Ncut_factor"] = ja["Ncut_factor"] = 0.6
    a["rho"] = ja["rho"] = rho
    p_j, F_j, s_j = jm.jit_step(False)(
        {k: jnp.asarray(v) for k, v in p_np.items()},
        dict(j_blank(y), F_prev=jnp.asarray(F_prev)), sched_from_anneal(ja),
        jax.random.PRNGKey(0))
    p_t, F_t, s_t = tm.step_fn(
        params_from_numpy(p_np, "cpu"),
        dict(make_blank_data(y, device="cpu"), F_prev=torch.tensor(F_prev)),
        sched_floats(a), torch.Generator())
    got = params_to_numpy(p_t)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(p_j[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=1e-4)
    for k in s_j:
        np.testing.assert_allclose(float(s_t[k]), float(s_j[k]), rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("family", ["mca", "mmca"])
def test_saturated_step_bit_identical(family):
    model = FAMILY[family][1](16, 24, 4, 3, chunk=32)
    p_np, y, F_prev = _step_inputs(family, seed=3)
    data = dict(make_blank_data(y, device="cpu"), F_prev=torch.tensor(F_prev))
    a = LinearAnnealing(10)
    a["W_noise"] = 0.3
    a["Ncut_factor"] = 0.5
    sched = device_sched(sched_floats(a), "cpu")   # beta = prior_beta = 1
    assert sched["pattern"].saturated
    unsat = dict(sched, pattern=sched["pattern"]._replace(saturated=False))
    params = params_from_numpy(p_np, "cpu")
    p0, F0, s0 = model.step_fn(params, data, unsat,
                               torch.Generator().manual_seed(3))
    p1, F1, s1 = model.step_fn(params, data, sched,
                               torch.Generator().manual_seed(3))
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    assert torch.equal(F0, F1)
    assert float(s1["Q"]) == pytest.approx(float(s0["Q"]), rel=1e-6)
    assert float(s1["Q"]) == float(s1["F_total"])


def test_em_pads_like_jax():
    """N = 100 above the chunk of 32 pads with weight-0 rows to 128, and
    the run follows the JAX package's (no parameter noise) from the
    port's default init, which reads the 100 valid rows only."""
    a = _inputs(16, 12, 5, 3, 100, 2, False)
    ta, ja = LinearAnnealing(3), JAnneal(3)
    ta["T"] = ja["T"] = [(0.0, 2.0), (1.0, 1.0)]
    jm = jmca.MCA(16, 12, 5, 3, chunk=32)
    em_t = EM(MCA(16, 12, 5, 3, chunk=32), ta, {"y": a["y"]}, device="cpu")
    em_j = JEM(jm, ja, {"y": a["y"]},
               params=jm.standard_init({"y": a["y"]}))
    assert em_t.data["y"].shape == tuple(em_j.data["y"].shape) == (128, 16)
    em_t.run()
    em_j.run()
    got = params_to_numpy(em_t.params)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(em_j.params[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for ht, hj in zip(em_t.history, em_j.history):
        np.testing.assert_allclose(ht["F_mean"], hj["F_mean"], rtol=1e-4)


EXACT = ("top_states", "top_single_unit", "top_single_value",
         "top_cand_states", "cand")


@pytest.mark.parametrize("family", ["mca", "mmca"])
@pytest.mark.parametrize("dense", [True, False])
def test_inference_matches_jax(family, dense):
    """F, s_mean, recon within rtol 1e-4; on inputs quantised to quarters
    (exact in float32) the top-L identities match exactly."""
    jcls, tcls = FAMILY[family]
    a = _inputs(16, 12, 5, 3, 96, 5, family == "mmca", quarters=True)
    params = {"W": a["W"], "pi": np.float32(0.15), "sigma": np.float32(1.5)}
    ref = jcls(16, 12, 5, 3, chunk=32).inference(
        {k: jnp.asarray(v) for k, v in params.items()}, {"y": a["y"]},
        top_L=6, dense_states=dense)
    got = tcls(16, 12, 5, 3, chunk=32).inference(
        params_from_numpy(params, "cpu"), {"y": a["y"]}, top_L=6,
        dense_states=dense)
    assert set(got) == set(ref)
    for k in ("F", "s_mean", "recon", "top_probs"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in EXACT:
        if k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                          err_msg=k)
    if not dense:
        np.testing.assert_array_equal(
            tet.densify_top_states(got, 12).numpy(),
            np.asarray(jax_densify(ref, 12)))


def _bars_anneal(cls):
    """tests/test_max_oracle.py's schedule."""
    a = cls(60)
    a["T"] = [(0.0, 2.0), (0.7, 1.0)]
    a["W_noise"] = [(0.0, 1.0), (0.7, 0.0)]
    a["Ncut_factor"] = [(0.5, 0.0), (0.8, 1.0)]
    return a


def test_mca_bars_recovery_through_the_port():
    model = MCA(16, 8, 6, 3, chunk=1000)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    data = model.generate_data(gt, 1000, seed=21)
    before = dict(max_cuda.LAUNCHES)
    em = EM(model, _bars_anneal(LinearAnnealing), {"y": data["y"]}, seed=13,
            device="cpu")
    params = em.run()
    assert max_cuda.LAUNCHES == before             # CPU: plain version only
    assert count_recovered_bars(params["W"].numpy(), gt["W"], 0.8) == 8
    assert abs(float(params["sigma"]) - 1.0) < 0.3
    Q = [h["Q_mean"] for h in em.history]
    assert Q[-1] > Q[5]


def test_mmca_bars_recovery_through_the_port():
    model = MMCA(16, 8, 6, 3, chunk=1000)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0, neg_bars=True)
    data = model.generate_data(gt, 1000, seed=22)
    params = EM(model, _bars_anneal(LinearAnnealing), {"y": data["y"]},
                seed=14, device="cpu").run()
    assert count_recovered_bars(params["W"].numpy(), gt["W"], 0.8,
                                signed=True) >= 7


def test_generate_data_matches_jax():
    for (jcls, tcls), neg in ((FAMILY["mca"], False), (FAMILY["mmca"], True)):
        jm, tm = jcls(16, 8, 6, 3), tcls(16, 8, 6, 3)
        gt = bars_gt_params(tm, intensity=10.0, sigma=1.0, neg_bars=neg)
        d_t = tm.generate_data(gt, 50, seed=4)
        d_j = jm.generate_data({k: jnp.asarray(v) for k, v in gt.items()}, 50,
                               seed=4)
        np.testing.assert_array_equal(d_t["y"], np.asarray(d_j["y"]))


def test_sched_floats_carries_rho_and_mu_noise():
    a, ja = LinearAnnealing(10), JAnneal(10)
    a["rho"] = ja["rho"] = [(0.0, 5.0), (1.0, 50.0)]
    a["mu_noise"] = ja["mu_noise"] = 0.25
    a["T"] = ja["T"] = 1.5
    a.next()
    ja.next()
    got, ref = sched_floats(a), j_sched_floats(ja)
    assert got == ref
    assert 5.0 < got["rho"] < 50.0 and got["mu_noise"] == 0.25


def test_binary_state_space_matches_jax():
    for Hp, gamma in ((6, 3), (5, 2), (7, 4)):
        got, ref = binary_state_space(Hp, gamma), jax_space(Hp, gamma)
        for f in ("states", "abs_states", "value_counts", "values", "outer"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))


def test_dp_plan_flat_matches_levels():
    """The kernel's flat plan (parent < Hp: a slot; else Hp + state) names
    the same parents as the per-level plan."""
    space = binary_state_space(6, 4)
    plan = maxstep.dp_plan(torch.tensor(space.states))
    S, Hp = space.states.shape
    par, add = plan.flat[:S].tolist(), plan.flat[S:].tolist()
    for s in range(S):
        sup = set(np.flatnonzero(space.states[s]).tolist())
        parent = ({par[s]} if par[s] < Hp else
                  set(np.flatnonzero(space.states[par[s] - Hp]).tolist()))
        assert parent | {add[s]} == sup and add[s] == max(sup)


def test_wrapper_takes_the_plain_version_on_cpu_and_checks_limits():
    a = _inputs(16, 12, 5, 3, 64, 1, True)
    args = _torch_args(a, 1.0, 0.8, 1.0)
    before = dict(max_cuda.LAUNCHES)
    F_w, s_w = max_cuda.max_et_estep(*args, chunk=32)
    F_p, s_p = maxstep.max_et_estep(*args, chunk=32)
    assert torch.equal(F_w, F_p)
    for k in KEYS:
        assert torch.equal(s_w[k], s_p[k]), k
    assert max_cuda.LAUNCHES == before
    with pytest.raises(ValueError):      # the kernel itself takes CUDA only
        max_cuda.max_et_estep_cuda(*args)
    with pytest.raises(ValueError):      # N not a multiple of the chunk
        maxstep.max_et_estep(*args, chunk=48)


def test_unported_options_raise():
    """``dp_winner=False`` (the per-state loop form, which state sharding
    runs on each slice) is ported: held against the JAX package's loop
    form, hard and softened, MCA and MMCA, within ``_assert_match``'s
    tolerances.  More than one state shard needs the state group; a state
    axis of one shard runs unsharded, bit for bit (the sharded runs are in
    tests/test_torch_state_sharding.py)."""
    for magnitude in (False, True):
        a = _inputs(16, 12, 5, 3, 64, 1, magnitude)
        args = _torch_args(a, 1.0, 0.8, 1.0)
        for rho in (None, 2.0):
            F_j, s_j = jax_estep(*_jax_args(a, 1.0, 0.8, 1.0), chunk=32,
                                 rho=jnp.float32(0.0 if rho is None else rho),
                                 dp_winner=False)
            F_t, s_t = maxstep.max_et_estep(*args, chunk=32, rho=rho,
                                            dp_winner=False)
            _assert_match(F_t, s_t, F_j, s_j)
    with pytest.raises(ValueError, match="state group"):
        maxstep.max_et_estep(*args, chunk=32, n_state_shards=2)
    model = MCA(16, 12, 5, 3)
    params = model.standard_init({"y": a["y"]}, device="cpu")
    data = make_blank_data(a["y"], device="cpu")
    sched = sched_floats(LinearAnnealing(2))
    ref = model.step_fn(params, data, sched, torch.Generator())
    got = model.step_fn(params, data, sched, torch.Generator(),
                        state_axis="s")
    for k in ref[0]:
        assert torch.equal(got[0][k], ref[0][k]), k
    assert torch.equal(got[1], ref[1])
    # sharded serving is ported (tests/test_torch_mesh.py): a MeshRuntime
    with pytest.raises(TypeError, match="MeshRuntime"):
        model.inference(params, {"y": a["y"]}, runtime=object())
    with pytest.raises(ValueError):
        MCA(16, 12, 13, 3)
