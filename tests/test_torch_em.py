"""The port's EM training path against the JAX package: one-step parity,
whole bars runs, the saturated-step contract, config errors, and the rule
that the port imports neither JAX nor the JAX package."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.engine.anneal import LinearAnnealing as JAnneal
from prosper_tpu.engine.em import EM as JEM
from prosper_tpu.models import linear as jlinear
from prosper_tpu.models.base import make_blank_data as j_blank
from prosper_tpu.models.base import sched_from_anneal
from prosper_tpu_torch import EM, LinearAnnealing
from prosper_tpu_torch.data.bars import bars_gt_params, count_recovered_bars
from prosper_tpu_torch.io.weights import params_from_numpy, params_to_numpy
from prosper_tpu_torch.models import BSC, DSC, TSC
from prosper_tpu_torch.models.base import (device_sched, make_blank_data,
                                           sched_floats)
from prosper_tpu_torch.ops import linear_cuda

PORT = pathlib.Path(__file__).resolve().parent.parent / "prosper_tpu_torch"
FAMILY = {"bsc": (jlinear.BSC, BSC), "tsc": (jlinear.TSC, TSC),
          "dsc": (jlinear.DSC, DSC)}


def _assert_params_close(p_t, p_j, rtol, atol=1e-6):
    got = params_to_numpy(p_t)
    assert set(got) == set(p_j)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(p_j[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("family", ["bsc", "tsc", "dsc"])
@pytest.mark.parametrize("ncut", ["off", "lagged", "current"])
def test_one_step_matches_jax(family, ncut):
    jcls, tcls = FAMILY[family]
    D, H, Hp, gamma, N = 16, 10, 5, 3, 256
    kw = dict(chunk=64, ncut_current=ncut == "current")
    jm, tm = jcls(D, H, Hp, gamma, **kw), tcls(D, H, Hp, gamma, **kw)
    rng = np.random.default_rng(4)
    y = (rng.standard_normal((N, D)) * 2.0).astype(np.float32)
    F_prev = (rng.standard_normal(N) * 5 - 40).astype(np.float32)
    p_np = {k: np.asarray(v) for k, v in
            jm.standard_init({"y": y}, seed=1).items()}
    a = LinearAnnealing(10)
    a["T"] = 1.5
    a["Ncut_factor"] = 0.0 if ncut == "off" else 0.6
    ja = JAnneal(10)
    ja["T"], ja["Ncut_factor"] = a["T"], a["Ncut_factor"]

    jdata = dict(j_blank(y), F_prev=jnp.asarray(F_prev))
    p_j, F_j, s_j = jm.jit_step(False)(
        {k: jnp.asarray(v) for k, v in p_np.items()}, jdata,
        sched_from_anneal(ja), jax.random.PRNGKey(0))
    tdata = dict(make_blank_data(y, device="cpu"),
                 F_prev=torch.tensor(F_prev))
    p_t, F_t, s_t = tm.step_fn(params_from_numpy(p_np, "cpu"), tdata,
                               sched_floats(a), torch.Generator())

    _assert_params_close(p_t, p_j, rtol=1e-4)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=1e-4)
    for k in s_j:
        np.testing.assert_allclose(float(s_t[k]), float(s_j[k]), rtol=1e-4,
                                   err_msg=k)


def _bars(noise: bool, steps: int, cls):
    a = cls(steps)
    a["T"] = [(0.0, 2.0), (0.7, 1.0)]
    a["Ncut_factor"] = [(0.0, 0.0), (0.5, 0.0), (0.9, 1.0)]
    if noise:
        a["W_noise"] = [(0.0, 1.0), (0.7, 0.0)]
    return a


def _bars_data(model):
    gt = bars_gt_params(model, intensity=10.0, sigma=2.0)
    return gt, model.generate_data(gt, 1000, seed=11)


def test_noise_free_bars_run_follows_jax():
    """Without parameter noise the run is deterministic: the port follows
    the JAX trajectory (W within rtol 1e-3 after 5 iterations) and both end
    at 10/10 bars with the same sigma."""
    tm, jm = BSC(25, 10, 6, 3), jlinear.BSC(25, 10, 6, 3)
    gt, data = _bars_data(tm)
    em_t = EM(tm, _bars(False, 60, LinearAnnealing), {"y": data["y"]},
              seed=5, device="cpu")
    em_j = JEM(jm, _bars(False, 60, JAnneal), {"y": data["y"]}, seed=5)
    for _ in range(5):
        em_t.step_once()
        em_j.step_once()
    np.testing.assert_allclose(em_t.params["W"].numpy(),
                               np.asarray(em_j.params["W"]), rtol=1e-3,
                               atol=1e-4)
    p_t, p_j = em_t.run(), em_j.run()
    for W in (p_t["W"].numpy(), np.asarray(p_j["W"])):
        assert count_recovered_bars(W, gt["W"], threshold=0.85) == 10
    assert abs(float(p_t["sigma"]) - float(p_j["sigma"])) < 1e-2
    assert abs(float(p_t["pi"]) - float(p_j["pi"])) < 1e-2


def test_noisy_bars_run_with_jax_noise_follows_jax():
    """torch.Generator and jax.random give different numbers, so the port
    is handed the JAX run's own W-noise draws: the two runs then end in the
    same optimum (seed 5 lands at sigma 2.186 in both, not at 1.975)."""
    seed = 5
    tm, jm = BSC(25, 10, 6, 3), jlinear.BSC(25, 10, 6, 3)
    gt, data = _bars_data(tm)
    rng, draws = jax.random.PRNGKey(seed), []
    for _ in range(60):                     # JEM.step_once's key chain
        rng, sub = jax.random.split(rng)
        k_noise = jax.random.split(sub)[0]
        k_W = jax.random.split(k_noise, 4)[0]
        draws.append(torch.tensor(np.asarray(
            jax.random.normal(k_W, (25, 10), jnp.float32))))
    draws = iter(draws)

    def jax_noisify(params, sched, generator):
        return dict(params, W=params["W"] + sched["W_noise"] * next(draws),
                    pi=torch.clamp(params["pi"], 1e-6, 1.0 - 1e-6),
                    sigma=torch.clamp(params["sigma"], min=1e-5))
    tm.noisify = jax_noisify
    p_t = EM(tm, _bars(True, 60, LinearAnnealing), {"y": data["y"]},
             seed=seed, device="cpu").run()
    p_j = JEM(jm, _bars(True, 60, JAnneal), {"y": data["y"]}, seed=seed).run()
    assert (count_recovered_bars(p_t["W"].numpy(), gt["W"], 0.85)
            == count_recovered_bars(np.asarray(p_j["W"]), gt["W"], 0.85))
    assert abs(float(p_t["sigma"]) - float(p_j["sigma"])) < 1e-2
    np.testing.assert_allclose(p_t["W"].numpy(), np.asarray(p_j["W"]),
                               rtol=1e-2, atol=1e-2)


def test_noisy_bars_recovery_through_the_port():
    """tests/test_bars_bsc.py's schedule and criteria, through the port."""
    model = BSC(25, 10, 6, 3)
    gt, data = _bars_data(model)
    before = dict(linear_cuda.LAUNCHES)
    em = EM(model, _bars(True, 60, LinearAnnealing), {"y": data["y"]},
            seed=0, device="cpu")
    params = em.run()
    assert linear_cuda.LAUNCHES == before          # CPU: plain version only
    assert count_recovered_bars(params["W"].numpy(), gt["W"], 0.85) == 10
    Q = [h["Q_mean"] for h in em.history]
    assert Q[-1] > Q[5]
    tail = Q[-8:]
    assert all(b >= a - 1e-3 for a, b in zip(tail, tail[1:]))
    assert abs(float(params["sigma"]) - 2.0) < 0.3
    assert abs(float(params["pi"]) - 0.2) < 0.08


@pytest.mark.parametrize("family", ["bsc", "dsc"])
def test_saturated_step_bit_identical(family):
    model = FAMILY[family][1](25, 10, 6, 3, chunk=64)
    rng = np.random.default_rng(0)
    y = rng.standard_normal((128, 25)).astype(np.float32)
    params = model.standard_init({"y": y}, seed=1, device="cpu")
    data = make_blank_data(y, device="cpu")
    a = LinearAnnealing(10)
    a["W_noise"] = 0.3
    a["Ncut_factor"] = 0.5
    sched = device_sched(sched_floats(a), "cpu")   # beta = prior_beta = 1
    assert sched["pattern"].saturated
    unsat = dict(sched, pattern=sched["pattern"]._replace(saturated=False))
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
    """N above the chunk is padded with weight-0 rows to a chunk multiple,
    as in the JAX package.  The default init reads the valid rows only (the
    JAX package's also reads its padding): it equals the JAX package's
    standard_init on the unpadded data, and from there both runs agree."""
    rng = np.random.default_rng(2)
    y = rng.standard_normal((100, 16)).astype(np.float32)
    a, ja = LinearAnnealing(3), JAnneal(3)
    a["T"] = ja["T"] = [(0.0, 2.0), (1.0, 1.0)]
    jm = jlinear.BSC(16, 8, 5, 3, chunk=64)
    em_t = EM(BSC(16, 8, 5, 3, chunk=64), a, {"y": y}, device="cpu")
    em_j = JEM(jm, ja, {"y": y}, params=jm.standard_init({"y": y}))
    assert em_t.data["y"].shape == tuple(em_j.data["y"].shape) == (128, 16)
    assert em_t.data["valid"].sum().item() == 100
    _assert_params_close(em_t.params, em_j.params, rtol=0, atol=0)
    em_t.run()
    em_j.run()
    _assert_params_close(em_t.params, em_j.params, rtol=1e-4)
    for ht, hj in zip(em_t.history, em_j.history):
        assert ht["iteration"] == hj["iteration"] and ht["T"] == hj["T"]
        np.testing.assert_allclose(ht["F_mean"], hj["F_mean"], rtol=1e-4)


@pytest.mark.parametrize("args", [(25, 10, 11, 3), (25, 10, 6, 1),
                                  (25, 10, 6, 7)])
def test_bad_configs_raise_value_error(args):
    with pytest.raises(ValueError):
        jlinear.BSC(*args)
    with pytest.raises(ValueError):
        BSC(*args)


def test_unported_options_raise():
    y = np.zeros((8, 25), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TSC(25, 10, 6, 3, compute_dtype=torch.bfloat16)
    assert DSC(25, 10, 6, 3, to_learn=("W", "pi", "sigma", "phi")).learn_phi
    # runtime= is ported (tests/test_torch_mesh.py); it takes a MeshRuntime
    with pytest.raises(TypeError, match="MeshRuntime"):
        EM(BSC(25, 10, 6, 3), LinearAnnealing(2), {"y": y}, device="cpu",
           runtime=1)
    # the options of the data log, the checkpoints and the recovery protocol
    # are ported
    em = EM(BSC(25, 10, 6, 3), LinearAnnealing(2), {"y": y}, device="cpu",
            dlog=None, log_params_every=2, checkpoint_path=None,
            checkpoint_every=1, revive_duplicates=(1, 0.9),
            split_norm_frac=1.5, split_coact=True, reseed_worst_frac=0.1)
    assert em.revive_duplicates == (1, 0.9, 0.75, 0.0)
    with pytest.raises(TypeError):
        EM(BSC(25, 10, 6, 3), LinearAnnealing(2), {"y": y}, device="cpu",
           no_such_option=1)
    model = BSC(25, 10, 6, 3)
    params = model.standard_init({"y": y}, device="cpu")
    with pytest.raises(TypeError, match="MeshRuntime"):
        model.inference(params, {"y": y}, runtime=object())
    # state sharding is ported (tests/test_torch_state_sharding.py): more
    # than one state shard needs the state group, and a state axis of one
    # shard runs unsharded, bit for bit
    sched = sched_floats(LinearAnnealing(2))
    data = make_blank_data(y, device="cpu")
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


def test_weights_round_trip():
    p = {"W": np.arange(6, dtype=np.float32).reshape(2, 3),
         "pi": np.float32(0.25), "sigma": np.float64(1.5)}
    t = params_from_numpy(p, "cpu")
    assert all(v.dtype == torch.float32 for v in t.values())
    back = params_to_numpy(t)
    for k in p:
        np.testing.assert_array_equal(back[k], np.float32(p[k]))


def test_port_imports_neither_jax_nor_the_jax_package():
    banned = {"jax", "jaxlib", "prosper_tpu"}
    # build/ holds what the kernels' first use generates, not the port
    files = sorted(f for f in PORT.rglob("*.py")
                   if "build" not in f.relative_to(PORT).parts)
    assert len(files) >= 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not banned.intersection(roots), (path, roots)
