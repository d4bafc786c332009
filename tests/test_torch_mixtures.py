"""The port's mixtures (MoG, MoP) against the JAX package.

Each case hands both packages the same numpy inputs: one ``step_fn``
against JAX's ``step_fn`` (``partial`` = 1, annealed and saturated;
parameters, F and scalars within rtol 1e-5: the same float32 arithmetic,
summed in another order), ``inference`` against JAX's, and the recovery
runs of ``tests/test_mixtures.py`` through the port's ``EM``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from prosper_tpu.engine.anneal import LinearAnnealing as JAnneal
from prosper_tpu.engine.em import EM as JEM
from prosper_tpu.models import mixtures as jmix
from prosper_tpu.models.base import make_blank_data as j_blank
from prosper_tpu.models.base import sched_from_anneal
from prosper_tpu_torch import EM, LinearAnnealing
from prosper_tpu_torch.io.weights import params_from_numpy, params_to_numpy
from prosper_tpu_torch.models.base import make_blank_data, sched_floats
from prosper_tpu_torch.models.mixtures import MixtureModel, MoG, MoP

FAMILY = {"mog": (jmix.MoG, MoG), "mop": (jmix.MoP, MoP)}


def _data(name, N=256, D=8, seed=2):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((N, D)).astype(np.float32)
    if name == "mop":
        y = np.abs(np.floor(3.0 * y))                  # counts
    return y


def _init(name, y, K=4, seed=0):
    return {k: np.asarray(v) for k, v in
            FAMILY[name][0](y.shape[1], K).standard_init({"y": y},
                                                         seed=seed).items()}


@pytest.mark.parametrize("T", [1.5, 1.0])
@pytest.mark.parametrize("name", ["mog", "mop"])
def test_step_matches_jax(name, T):
    """Annealed (T = 1.5, prior annealed too) and saturated (T = 1)."""
    y = _data(name)
    jm, tm = FAMILY[name][0](8, 4), FAMILY[name][1](8, 4)
    p_np = _init(name, y)
    a, ja = LinearAnnealing(5), JAnneal(5)
    for x in (a, ja):
        x["T"] = T
        x["anneal_prior"] = True
    saturated = T == 1.0
    p_j, F_j, s_j = jm.jit_step(saturated)(
        {k: jnp.asarray(v) for k, v in p_np.items()}, j_blank(y),
        sched_from_anneal(ja), jax.random.PRNGKey(0))
    p_t, F_t, s_t = tm.step_fn(params_from_numpy(p_np, "cpu"),
                               make_blank_data(y, device="cpu"),
                               sched_floats(a), torch.Generator())
    assert set(p_t) == set(p_j) == set(tm.param_names)
    for k in p_t:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=1e-5)
    assert set(s_t) == set(s_j)
    for k in s_j:
        np.testing.assert_allclose(float(s_t[k]), float(s_j[k]), rtol=1e-5,
                                   err_msg=k)
    if saturated:
        assert float(s_t["Q"]) == float(s_t["F_total"])
    else:
        assert float(s_t["Q"]) != float(s_t["F_total"])


@pytest.mark.parametrize("partial", [0.3, 0.65])
@pytest.mark.parametrize("name", ["mog", "mop"])
def test_partial_keeps_the_exact_count(name, partial):
    """``partial`` < 1 uses ceil(partial * n_valid) rows, never a padding
    row; the F of every row is returned all the same."""
    y = _data(name, N=200)
    valid = np.ones(200, np.float32)
    valid[-30:] = 0.0
    tm = FAMILY[name][1](8, 4)
    a = LinearAnnealing(5)
    a["partial"] = partial
    data = make_blank_data(y, valid, device="cpu")
    p = params_from_numpy(_init(name, y), "cpu")
    _, F, s = tm.step_fn(p, data, sched_floats(a),
                         torch.Generator().manual_seed(1))
    assert float(s["n_used"]) == np.ceil(np.float32(partial) * 170)
    assert float(s["N_total"]) == 170.0
    assert F.shape == (200,) and torch.isfinite(F).all()
    # the same draw again: the same rows
    _, _, s2 = tm.step_fn(p, data, sched_floats(a),
                          torch.Generator().manual_seed(1))
    assert float(s2["F_total"]) == float(s["F_total"])


@pytest.mark.parametrize("name", ["mog", "mop"])
def test_inference_matches_jax(name):
    y = _data(name, N=300, seed=4)
    jm, tm = FAMILY[name][0](8, 4), FAMILY[name][1](8, 4)
    p_np = _init(name, y, seed=3)
    out_j = jm.inference({k: jnp.asarray(v) for k, v in p_np.items()},
                         {"y": y})
    out_t = tm.inference(params_from_numpy(p_np, "cpu"), {"y": y})
    assert set(out_t) == set(out_j)
    np.testing.assert_allclose(out_t["resp"].numpy(),
                               np.asarray(out_j["resp"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out_t["F"].numpy(), np.asarray(out_j["F"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(out_t["assign"].numpy(),
                                  np.asarray(out_j["assign"]))


@pytest.mark.parametrize("name", ["mog", "mop"])
def test_init_and_generation_follow_jax(name):
    y = _data(name)
    jm, tm = FAMILY[name][0](8, 4), FAMILY[name][1](8, 4)
    p_t = tm.standard_init({"y": y}, seed=5, device="cpu")
    p_j = jm.standard_init({"y": y}, seed=5)
    assert set(p_t) == set(p_j)
    for k in p_t:
        assert p_t[k].dtype == torch.float32
        np.testing.assert_array_equal(p_t[k].numpy(), np.asarray(p_j[k]))
    assert tm.standard_init({"y": torch.tensor(y)})["pi"].device.type == "cpu"
    a = tm.generate_data(p_j, 40, seed=6)
    b = jm.generate_data(p_j, 40, seed=6)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_unported_options_raise():
    y = _data("mog")
    tm = MoG(8, 4)
    p = params_from_numpy(_init("mog", y), "cpu")
    with pytest.raises(NotImplementedError, match="distributed"):
        tm.step_fn(p, make_blank_data(y, device="cpu"),
                   sched_floats(LinearAnnealing(2)), torch.Generator(),
                   axis_name="data")
    assert not MixtureModel.requires_chunk_multiple
    with pytest.raises(NotImplementedError):
        MixtureModel(8, 4).component_loglik(p, torch.tensor(y))


# -- recovery (tests/test_mixtures.py through the port) -------------------------

def _match(est, true):
    """Hungarian match of components: mean distance of matched rows."""
    C = np.linalg.norm(est[:, None, :] - true[None, :, :], axis=2)
    r, c = linear_sum_assignment(C)
    return C[r, c].mean()


def test_mog_recovers_components():
    D, K, N = 8, 3, 4000
    rng = np.random.default_rng(0)
    mu_true = rng.standard_normal((K, D)) * 4.0
    gt = {"pi": np.array([0.5, 0.3, 0.2], np.float32),
          "mu": mu_true.astype(np.float32),
          "sigma": np.array([0.5, 0.7, 0.6], np.float32)}
    model = MoG(D, K)
    data = model.generate_data(gt, N, seed=1)
    em = EM(model, LinearAnnealing(40), {"y": data["y"]}, seed=3,
            device="cpu")
    params = em.run()
    err = _match(params["mu"].numpy(), mu_true)
    assert err < 0.2, f"component mean error {err:.3f}"
    Q = [h["Q_mean"] for h in em.history]
    assert all(b >= a - 1e-3 for a, b in zip(Q[-10:], Q[-9:]))


def test_mog_assignment_accuracy():
    D, K, N = 5, 3, 2000
    rng = np.random.default_rng(5)
    gt = {"pi": np.full(K, 1 / K, np.float32),
          "mu": (rng.standard_normal((K, D)) * 5).astype(np.float32),
          "sigma": np.full(K, 0.4, np.float32)}
    model = MoG(D, K)
    data = model.generate_data(gt, N, seed=6)
    out = model.inference(params_from_numpy(gt, "cpu"), data)
    assert (out["assign"].numpy() == data["s"]).mean() > 0.97


def test_mop_recovers_rates():
    D, K, N = 6, 2, 4000
    gt = {"pi": np.array([0.6, 0.4], np.float32),
          "lam": np.array([[1, 2, 3, 4, 5, 6],
                           [9, 8, 7, 6, 5, 4]], np.float32)}
    model = MoP(D, K)
    data = model.generate_data(gt, N, seed=2)
    params = EM(model, LinearAnnealing(30), {"y": data["y"]}, seed=4,
                device="cpu").run()
    err = _match(params["lam"].numpy(), gt["lam"].astype(np.float64))
    assert err < 0.6, f"rate error {err:.3f}"
    np.testing.assert_allclose(np.sort(params["pi"].numpy()), [0.4, 0.6],
                               atol=0.05)


@pytest.mark.parametrize("name", ["mog", "mop"])
def test_em_follows_the_jax_em(name):
    """Ten iterations from the same data and init, T 2 -> 1 and ``partial``
    = 1: both EMs' parameters within rtol 1e-4 and every scalar of every
    iteration within rtol 1e-5."""
    y = _data(name, N=512, seed=8)

    def anneal(cls):
        a = cls(10)
        a["T"] = [(0.0, 2.0), (0.5, 1.0)]
        return a
    jm, tm = FAMILY[name][0](8, 4), FAMILY[name][1](8, 4)
    em_t = EM(tm, anneal(LinearAnnealing), {"y": y}, seed=1, device="cpu")
    em_j = JEM(jm, anneal(JAnneal), {"y": y}, seed=1)
    em_t.run()
    em_j.run()
    got = params_to_numpy(em_t.params)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(em_j.params[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for ht, hj in zip(em_t.history, em_j.history):
        for k in ("F_mean", "Q_mean", "n_used", "N_total"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5, err_msg=k)
