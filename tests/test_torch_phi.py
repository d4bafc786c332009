"""DSC with a learned value set Phi, and the state-space helpers that came
with it, against the JAX package: ``slot_value_onehot`` and
``ternary_state_space`` exactly, ``traced_state_arrays`` against the static
tables, the ``phi_c`` / ``phi_M`` sums, the M-step with its gauge fix, one
EM step against ``jit_step``, and a short recovery run.  Tolerances: rtol
1e-4 where sums are taken in another order than XLA's, exact where only
small integers or one matrix product of them are involved.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.core import etstep as jet
from prosper_tpu.core import states as jstates
from prosper_tpu.engine.anneal import LinearAnnealing as JAnneal
from prosper_tpu.models import linear as jlinear
from prosper_tpu.models.base import make_blank_data as j_blank
from prosper_tpu.models.base import sched_from_anneal
from prosper_tpu_torch import EM, LinearAnnealing
from prosper_tpu_torch.core import etstep as tet
from prosper_tpu_torch.core import states as tstates
from prosper_tpu_torch.io.weights import params_from_numpy, params_to_numpy
from prosper_tpu_torch.models import DSC
from prosper_tpu_torch.models.base import make_blank_data, sched_floats
from prosper_tpu_torch.ops import linear_cuda

PHI = (-1.0, 1.0, 2.0)
LEARN = ("W", "pi", "sigma", "phi")


@pytest.mark.parametrize("Hp,gamma,values", [
    (5, 3, (1.0,)), (5, 3, (-1.0, 1.0)), (6, 3, PHI), (4, 4, (0.5, -2.0))])
def test_slot_value_onehot_is_exact(Hp, gamma, values):
    ts = tstates.discrete_state_space(Hp, gamma, values)
    js = jstates.discrete_state_space(Hp, gamma, values)
    got, want = tstates.slot_value_onehot(ts), jstates.slot_value_onehot(js)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # it factors the states: states = onehot @ values
    np.testing.assert_array_equal(got @ ts.values, ts.states)
    np.testing.assert_array_equal(got.sum(axis=1), ts.value_counts)


def test_slot_value_onehot_needs_distinct_values():
    space = tstates.discrete_state_space(4, 2, (1.0, 2.0))
    twice = tstates.StateSpace(space.states, space.abs_states,
                               space.value_counts, np.float32([1.0, 1.0]),
                               space.outer)
    with pytest.raises(ValueError, match="distinct"):
        tstates.slot_value_onehot(twice)


@pytest.mark.parametrize("Hp,gamma", [(4, 2), (6, 3), (5, 5)])
def test_ternary_state_space_is_exact(Hp, gamma):
    got = tstates.ternary_state_space(Hp, gamma)
    want = jstates.ternary_state_space(Hp, gamma)
    for field in ("states", "abs_states", "value_counts", "values", "outer"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.S == tstates.n_multi_states(Hp, gamma, 2)


@pytest.mark.parametrize("phi", [PHI, (-0.6, 1.4, 1.7)])
def test_traced_state_arrays_match_the_static_tables(phi):
    """At the configured values the traced tables are the static ones (one
    product of a 0/1 indicator with the values: exact); at other values
    they are the tables of that value set, and the JAX package's."""
    space = tstates.discrete_state_space(6, 3, phi)
    static = tet.state_arrays_from(space, "cpu")
    base = tet.state_arrays_from(tstates.discrete_state_space(6, 3, PHI),
                                 "cpu")
    so = torch.tensor(tstates.slot_value_onehot(
        tstates.discrete_state_space(6, 3, PHI)))
    got = tet.traced_state_arrays(so, base.value_counts, base.abs_states,
                                  torch.tensor(phi))
    for field in ("states", "outer", "abs_states", "value_counts", "values"):
        assert torch.equal(getattr(got, field), getattr(static, field)), field
    ref = jet.traced_state_arrays(
        jstates.slot_value_onehot(jstates.discrete_state_space(6, 3, PHI)),
        space.value_counts, space.abs_states, jnp.asarray(phi, jnp.float32))
    np.testing.assert_array_equal(got.states.numpy(), np.asarray(ref.states))
    np.testing.assert_array_equal(got.outer.numpy(), np.asarray(ref.outer))


def _estep_inputs(N=96, D=12, H=8, Hp=5, gamma=3, seed=3):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((D, H)).astype(np.float32)
    y = (rng.standard_normal((N, D)) * 2.0).astype(np.float32)
    w = (rng.random(N) > 0.2).astype(np.float32)
    pi = np.float32([0.05, 0.08, 0.04])
    lo = (np.log(pi) - np.log(1 - pi.sum())).astype(np.float32)
    return y, w, W, lo, Hp, gamma


@pytest.mark.parametrize("chunk", [96, 32])
@pytest.mark.parametrize("beta", [1.0, 0.7])
def test_phi_sums_match_jax(beta, chunk):
    """``phi_c`` (K,) and ``phi_M`` (K, K), and every other sum beside
    them, against ``linear_et_estep(collect_phi=True)`` of the JAX package,
    in one chunk and in three; rtol 1e-4."""
    y, w, W, lo, Hp, gamma = _estep_inputs()
    jspace = jstates.discrete_state_space(Hp, gamma, PHI)
    tspace = tstates.discrete_state_space(Hp, gamma, PHI)
    F_j, s_j = jet.linear_et_estep(
        jnp.asarray(y), jnp.asarray(w), jnp.asarray(W), jnp.float32(1.69),
        jnp.asarray(lo), jet.state_arrays_from(jspace), Hp, True,
        jnp.float32(beta), jnp.float32(1.0), chunk=chunk, collect_phi=True,
        slot_onehot=jnp.asarray(jstates.slot_value_onehot(jspace)))
    F_t, s_t = tet.linear_et_estep(
        torch.tensor(y), torch.tensor(w), torch.tensor(W), torch.tensor(1.69),
        torch.tensor(lo), tet.state_arrays_from(tspace, "cpu"), Hp, True,
        beta, 1.0, chunk=chunk, collect_phi=True,
        slot_onehot=torch.tensor(tstates.slot_value_onehot(tspace)))
    assert s_t["phi_c"].shape == (3,) and s_t["phi_M"].shape == (3, 3)
    assert set(s_t) == set(s_j)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=1e-4)
    for k in s_j:
        np.testing.assert_allclose(s_t[k].numpy(), np.asarray(s_j[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_collect_phi_refuses_what_it_cannot_serve():
    y, w, W, lo, Hp, gamma = _estep_inputs()
    sa = tet.state_arrays_from(tstates.discrete_state_space(Hp, gamma, PHI),
                               "cpu")
    args = (torch.tensor(y), torch.tensor(w), torch.tensor(W),
            torch.tensor(1.69), torch.tensor(lo), sa, Hp, True, 1.0, 1.0)
    with pytest.raises(ValueError, match="slot_onehot"):
        tet.linear_et_estep(*args, collect_phi=True)
    with pytest.raises(ValueError, match="s_block"):
        tet.linear_et_estep(*args, collect_phi=True, s_block=8,
                            slot_onehot=torch.zeros(sa.states.shape[0], Hp, 3))


@pytest.mark.parametrize("to_learn", [LEARN, ("pi", "sigma", "phi")])
def test_phi_mstep_matches_jax(to_learn):
    """phi <- (M + ridge I)^-1 c, with the gauge fix when W is learned too
    (the anchor keeps its magnitude, W absorbs the inverse) and without it
    when W is fixed; against the JAX ``m_step`` at rtol 1e-4 and against
    the closed form."""
    D, H, K = 12, 6, 3
    tm = DSC(D, H, 6, 3, phi=PHI, to_learn=to_learn)
    jm = jlinear.DSC(D, H, 6, 3, phi=PHI, to_learn=to_learn)
    assert tm.learn_phi and tm.param_names == jm.param_names
    assert (tm._phi_anchor, tm._phi_anchor_val) == (2, 2.0)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((K, 5))
    M = (A @ A.T + np.eye(K)).astype(np.float32)
    B = rng.standard_normal((H, 9))
    sums = {"phi_M": M, "phi_c": rng.standard_normal(K).astype(np.float32),
            "ss": (B @ B.T + np.eye(H)).astype(np.float32),
            "xs": rng.standard_normal((D, H)).astype(np.float32),
            "abs": np.float32(10.0), "vc": np.float32([3.0, 4.0, 3.0]),
            "y2": np.float32(100.0), "n": np.float32(50.0)}
    params = {"W": rng.standard_normal((D, H)).astype(np.float32),
              "pi": np.float32([0.05, 0.05, 0.05]), "sigma": np.float32(1.0),
              "phi": np.float32(PHI)}
    new_j = jm.m_step({k: jnp.asarray(v) for k, v in params.items()},
                      {k: jnp.asarray(v) for k, v in sums.items()},
                      jnp.float32(0.0), jnp.float32(0.1))
    new_t = tm.m_step(params_from_numpy(params, "cpu"),
                      params_from_numpy(sums, "cpu"), torch.tensor(0.0),
                      torch.tensor(0.1))
    assert set(new_t) == set(new_j)
    for k in new_j:
        np.testing.assert_allclose(new_t[k].numpy(), np.asarray(new_j[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    M64 = M.astype(np.float64)
    phi = np.linalg.solve(M64 + 1e-6 * (np.trace(M64) / K + 1) * np.eye(K),
                          sums["phi_c"].astype(np.float64))
    if "W" in to_learn:
        phi = phi * (2.0 / phi[2])
        assert float(new_t["phi"][2]) == pytest.approx(2.0, rel=1e-6)
    else:
        assert torch.equal(new_t["W"], torch.tensor(params["W"]))
    np.testing.assert_allclose(new_t["phi"].numpy(), phi, rtol=1e-4)


@pytest.mark.parametrize("saturated", [False, True])
def test_learned_phi_step_matches_jit_step(saturated):
    """One EM step of DSC with learned Phi from a distorted value set,
    against ``jit_step``: parameters (phi among them), F and scalars within
    rtol 1e-4."""
    D, H, Hp, gamma, N = 16, 10, 5, 3, 256
    kw = dict(phi=PHI, to_learn=LEARN, chunk=64)
    jm, tm = jlinear.DSC(D, H, Hp, gamma, **kw), DSC(D, H, Hp, gamma, **kw)
    rng = np.random.default_rng(4)
    y = (rng.standard_normal((N, D)) * 2.0).astype(np.float32)
    p_np = {k: np.asarray(v) for k, v in
            jm.standard_init({"y": y}, seed=1).items()}
    p_np["phi"] = np.float32([-0.6, 1.4, 1.7])
    a, ja = LinearAnnealing(10), JAnneal(10)
    a["T"] = ja["T"] = 1.0 if saturated else 1.5
    p_j, F_j, s_j = jm.jit_step(saturated)(
        {k: jnp.asarray(v) for k, v in p_np.items()}, j_blank(y),
        sched_from_anneal(ja), jax.random.PRNGKey(0))
    p_t, F_t, s_t = tm.step_fn(params_from_numpy(p_np, "cpu"),
                               make_blank_data(y, device="cpu"),
                               sched_floats(a), torch.Generator())
    assert set(p_t) == set(p_j) == set(LEARN)
    for k in p_j:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=1e-4)
    for k in s_j:
        np.testing.assert_allclose(float(s_t[k]), float(s_j[k]), rtol=1e-4,
                                   err_msg=k)


def test_standard_init_and_sampling_carry_phi():
    D, H = 12, 6
    tm = DSC(D, H, 5, 3, phi=PHI, to_learn=LEARN)
    jm = jlinear.DSC(D, H, 5, 3, phi=PHI, to_learn=LEARN)
    y = np.random.default_rng(1).standard_normal((64, D)).astype(np.float32)
    p_t = params_to_numpy(tm.standard_init({"y": y}, seed=3, device="cpu"))
    p_j = jm.standard_init({"y": y}, seed=3)
    assert set(p_t) == set(p_j)
    for k in p_j:
        np.testing.assert_array_equal(p_t[k], np.asarray(p_j[k]), err_msg=k)
    assert "phi" not in DSC(D, H, 5, 3).standard_init({"y": y}, device="cpu")
    # generate_data reads params["phi"], as the JAX package's
    gt = dict(p_t, pi=np.float32([0.1, 0.1, 0.1]),
              phi=np.float32([-3.0, 0.5, 4.0]))
    d_t = tm.generate_data(gt, 200, seed=5)
    d_j = jm.generate_data({k: jnp.asarray(v) for k, v in gt.items()}, 200,
                           seed=5)
    np.testing.assert_array_equal(d_t["s"], d_j["s"])
    np.testing.assert_array_equal(d_t["y"], d_j["y"])
    assert set(np.unique(d_t["s"])) == {-3.0, 0.0, 0.5, 4.0}


def test_learned_phi_runs_scanned_like_run_and_serves():
    """On CPU tensors learned Phi takes the plain version under either
    backend; ``run_scanned`` follows ``run`` bit for bit, and ``inference``
    decodes with the learned values.  On the card the default backend
    refuses it and names ``backend="plain"``: no kernel collects the
    value-set sums (the routes' checks are reached here with a stand-in
    for a CUDA tensor: they read nothing else before they raise)."""
    D, H, Hp, gamma = 16, 8, 5, 3
    rng = np.random.default_rng(2)
    y = (rng.standard_normal((200, D)) * 2.0).astype(np.float32)

    def em(backend):
        a = LinearAnnealing(6)
        a["T"] = [(0.0, 1.5), (0.6, 1.0)]
        a["W_noise"] = [(0.0, 0.2), (0.6, 0.0)]
        model = DSC(D, H, Hp, gamma, phi=PHI, to_learn=LEARN, chunk=64,
                    backend=backend, s_block=8)   # s_block: not read
        return model, EM(model, a, {"y": y}, seed=3, device="cpu")
    (_, ref), (model, got) = em("cuda"), em("plain")
    ref.run()
    got.run_scanned()
    for k in ref.params:
        assert torch.equal(ref.params[k], got.params[k]), k
    assert not torch.equal(got.params["phi"], torch.tensor(PHI))
    out = model.inference(got.params, {"y": y[:32]}, top_L=4)
    routed = ref.model.inference(got.params, {"y": y[:32]}, top_L=4)
    assert set(routed) == set(out)
    for k in out:                        # the route on a CPU tensor: plain
        assert torch.equal(routed[k], out[k]), k
    values = set(np.unique(out["top_states"].numpy()).round(5))
    assert values <= {0.0, *np.float32(got.params["phi"].numpy()).round(5)}
    assert torch.isfinite(out["F"]).all()
    card = SimpleNamespace(is_cuda=True)
    with pytest.raises(ValueError, match='backend="plain"'):
        linear_cuda.linear_et_estep(card, *[None] * 9, collect_phi=True)
    with pytest.raises(ValueError, match='backend="plain"'):
        linear_cuda.linear_et_decode(card, *[None] * 9, learned_phi=True)


def test_dsc_phi_recovery():
    """Planted DSC data, Phi initialised with wrong magnitudes: EM with
    Phi learning recovers the planted value ratios (the comparison is
    gauge-invariant), as ``tests/test_phi_learning.py`` asks of the JAX
    package; within 0.08 of each ratio."""
    rng = np.random.default_rng(7)
    D, H, Hp, gamma, N = 25, 8, 8, 3, 512
    gt_phi = np.array([-1.0, 1.0, 2.0])
    model = DSC(D, H, Hp, gamma, phi=tuple(gt_phi), to_learn=LEARN)
    W_gt = rng.standard_normal((D, H)).astype(np.float32) * 2.0
    gt = {"W": W_gt, "pi": np.float32([0.08, 0.08, 0.08]),
          "sigma": np.float32(0.3), "phi": np.float32(gt_phi)}
    data = model.generate_data(gt, N, seed=1)
    model2 = DSC(D, H, Hp, gamma, phi=(-0.6, 1.4, 1.7), to_learn=LEARN)
    anneal = LinearAnnealing(12)
    anneal["T"] = [(0.0, 1.5), (0.5, 1.0)]
    params0 = model2.standard_init({"y": data["y"]}, device="cpu")
    params0["W"] = torch.tensor(
        W_gt + 0.3 * rng.standard_normal(W_gt.shape).astype(np.float32))
    em = EM(model2, anneal, {"y": data["y"]}, params=params0, seed=2,
            device="cpu")
    params = em.run_scanned()
    phi = np.sort(params["phi"].numpy().astype(np.float64))
    np.testing.assert_allclose(phi / phi[-1], np.sort(gt_phi) / 2.0,
                               atol=0.08)
    assert abs(phi).max() == pytest.approx(1.7, rel=1e-5)   # the gauge
    Q = [h["Q_mean"] for h in em.history]
    assert Q[-1] > Q[2]
