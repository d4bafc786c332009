"""The port's big-S (``s_block``) E-step against the JAX package: the plain
recurrence ``bigs_multi`` against the Pallas kernel ``bigs_multi_pallas``
(interpret mode, f32 operands), the chunked E-step against JAX's s_block
scan, one EM step against ``jit_step`` (XLA and Pallas), the decode, and a
short TSC bars run.  Inputs are made with numpy from a seed and handed to
both packages.

Tolerances: the recurrence rtol 5e-5 and the E-step's F rtol 2e-5 / atol
1e-4 with sums rtol 1e-4, those of ``tests/test_bigs_pallas.py`` and
``tests/test_linear_oracle.py``; the packages sum in different orders (the
port's ⟨ssᵀ⟩ is one one-hot GEMM, JAX's Hp per-slot GEMMs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.core.etstep import linear_et_estep as jax_estep
from prosper_tpu.core.etstep import state_arrays_from as jax_sa
from prosper_tpu.core.states import discrete_state_space as jax_space
from prosper_tpu.data.bars import bars_gt_params
from prosper_tpu.engine.anneal import LinearAnnealing as JAnneal
from prosper_tpu.engine.em import EM as JEM
from prosper_tpu.models import linear as jlinear
from prosper_tpu.models.base import make_blank_data as j_blank
from prosper_tpu.models.base import sched_from_anneal
from prosper_tpu.ops.bigs_pallas import bigs_multi_pallas
from prosper_tpu_torch import EM, LinearAnnealing
from prosper_tpu_torch.core import etstep as tet
from prosper_tpu_torch.core.states import discrete_state_space
from prosper_tpu_torch.io.weights import params_from_numpy, params_to_numpy
from prosper_tpu_torch.models import BSC, DSC, TSC
from prosper_tpu_torch.models.base import make_blank_data, sched_floats
from prosper_tpu_torch.ops import bigs_cuda, linear_cuda

KEYS = ("xs", "ss", "s", "vc", "abs", "y2", "n", "F", "F_true")
OUT = ("m", "l", "m_t", "l_t", "a_abs", "a_s", "a_ss", "a_vc")
FAMILY = {"bsc": ((1.0,), False, jlinear.BSC, BSC, {}),
          "tsc": ((-1.0, 1.0), True, jlinear.TSC, TSC, {}),
          "dsc": ((-1.0, 1.0, 2.0), True, jlinear.DSC, DSC,
                  {"phi": (-1.0, 1.0, 2.0)})}


def _tables(Hp, gamma, values, s_block, lo):
    """Padded state tables, prior and validity, as numpy (f32)."""
    sp = discrete_state_space(Hp, gamma, list(values))
    S = sp.states.shape[0]
    pad = -S % s_block

    def p(a):
        a = np.asarray(a, np.float32)
        return np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
    st, ot, vc, ab = (p(sp.states), p(sp.outer), p(sp.value_counts),
                      p(sp.abs_states))
    prior = (vc @ lo).astype(np.float32)
    valid = (np.arange(S + pad) < S).astype(np.float32)
    return st, ot, vc, prior, valid, ab, S


@pytest.mark.parametrize("family", ["bsc", "tsc"])
@pytest.mark.parametrize("beta,prior_beta", [(1.0, 1.0), (0.6, 1.0),
                                             (0.8, 0.8)])
@pytest.mark.parametrize("collect_true", [True, False])
def test_bigs_multi_matches_pallas_kernel(family, beta, prior_beta,
                                          collect_true):
    values = FAMILY[family][0]
    C, D, H, Hp, gamma, s_block = 128, 16, 24, 6, 4, 16
    rng = np.random.default_rng(3)
    lo = np.full(len(values), np.log(0.1 / 0.9), np.float32)
    st, ot, vc, prior, valid, ab, S = _tables(Hp, gamma, values, s_block, lo)
    assert S % s_block != 0, "the test must exercise the state padding"
    W = rng.standard_normal((D, H)).astype(np.float32)
    y = (rng.standard_normal((C, D)) * 1.5).astype(np.float32)
    cand = np.argsort(-np.abs(y @ W), axis=1, kind="stable")[:, :Hp]
    proj = np.take_along_axis(y @ W, cand, 1).astype(np.float32)
    G = W.T @ W
    Gf = G[cand[:, :, None], cand[:, None, :]].reshape(C, Hp * Hp)
    Gf = Gf.astype(np.float32)
    inv2s2 = np.float32(0.5 / 1.2)
    tables = (st, ot, vc, prior, valid, ab)
    ref = bigs_multi_pallas(
        jnp.asarray(proj), jnp.asarray(Gf), *map(jnp.asarray, tables),
        inv2s2, jnp.float32(beta), jnp.float32(prior_beta), s_block,
        tile=128, interpret=True, collect_true=collect_true, precise=True)
    got = tet.bigs_multi(torch.tensor(proj), torch.tensor(Gf),
                         *map(torch.tensor, tables), torch.tensor(inv2s2),
                         beta, prior_beta, s_block, collect_true)
    for name, g, r in zip(OUT, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-5,
                                   atol=1e-5, err_msg=name)


def _estep_inputs(family, beta, prior_beta, N=384, D=16, H=12, Hp=6,
                  gamma=4, seed=7):
    values, signed = FAMILY[family][:2]
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((N, D)) * 1.5).astype(np.float32)
    W = rng.standard_normal((D, H)).astype(np.float32)
    W[:, 3] = 0.0                                       # a dead unit
    w = (rng.random(N) > 0.2).astype(np.float32)
    w[:64] = 0.0                                        # a zero-weight block
    K = len(values)
    lo = np.full(K, np.log(0.2 / K / 0.8), np.float32)
    common = (np.float32(1.3), lo)
    jargs = (jnp.asarray(y), jnp.asarray(w), jnp.asarray(W),
             *map(jnp.asarray, common), jax_sa(jax_space(Hp, gamma, values)),
             Hp, signed, jnp.float32(beta), jnp.float32(prior_beta))
    targs = (torch.tensor(y), torch.tensor(w), torch.tensor(W),
             *map(torch.tensor, common),
             tet.state_arrays_from(discrete_state_space(Hp, gamma, values),
                                   "cpu"), Hp, signed, beta, prior_beta)
    return jargs, targs


def _assert_estep_close(F_t, s_t, F_r, s_r, rtol=1e-4):
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_r), rtol=2e-5,
                               atol=1e-4)
    for k in KEYS:
        np.testing.assert_allclose(s_t[k].numpy(), np.asarray(s_r[k]),
                                   rtol=rtol, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("family", ["bsc", "tsc", "dsc"])
@pytest.mark.parametrize("beta", [0.7, 1.0])
@pytest.mark.parametrize("prior_beta", [1.0, 0.0])
def test_bigs_estep_matches_jax_scan(family, beta, prior_beta):
    """s_block = 48 divides no S here, so padded states are in play; at
    prior_beta = 0 they must stay masked (the JAX package's ADVICE r2
    regression, tests/test_linear_oracle.py:224)."""
    jargs, targs = _estep_inputs(family, beta, prior_beta)
    assert targs[5].states.shape[0] % 48 != 0
    F_j, s_j = jax_estep(*jargs, chunk=128, s_block=48)
    F_t, s_t = tet.linear_et_estep(*targs, chunk=128, s_block=48)
    _assert_estep_close(F_t, s_t, F_j, s_j)


@pytest.mark.parametrize("family", ["bsc", "tsc", "dsc"])
@pytest.mark.parametrize("prior_beta", [1.0, 0.0])
def test_bigs_estep_matches_the_standard_path(family, prior_beta):
    _, targs = _estep_inputs(family, 0.8, prior_beta, seed=11)
    F0, s0 = tet.linear_et_estep(*targs, chunk=128)
    F1, s1 = tet.linear_et_estep(*targs, chunk=128, s_block=48)
    _assert_estep_close(F1, s1, F0, s0, rtol=2e-5)


@pytest.mark.parametrize("family", ["bsc", "tsc", "dsc"])
def test_bigs_step_matches_the_standard_step(family):
    """As tests/test_linear_oracle.py:176 holds JAX's s_block path to its
    standard one: one EM step, F, the M-step output and the scalars."""
    values, signed, _, tcls, kw = FAMILY[family]
    rng = np.random.default_rng(3)
    y = rng.standard_normal((384, 16)).astype(np.float32)
    m_std = tcls(16, 12, 6, 4, chunk=128, **kw)
    m_blk = tcls(16, 12, 6, 4, chunk=128, s_block=48, **kw)
    params = m_std.standard_init({"y": y}, seed=4, device="cpu")
    data = make_blank_data(y, device="cpu")
    sched = sched_floats(LinearAnnealing(10))
    p1, F1, s1 = m_std.step_fn(params, data, sched, torch.Generator())
    p2, F2, s2 = m_blk.step_fn(params, data, sched, torch.Generator())
    np.testing.assert_allclose(F2.numpy(), F1.numpy(), rtol=2e-5, atol=1e-4)
    for k in p1:
        np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(), rtol=2e-5,
                                   atol=1e-5, err_msg=k)
    for k in ("F_mean", "Q_mean", "n_used"):
        np.testing.assert_allclose(float(s2[k]), float(s1[k]), rtol=2e-5)


def _tsc_step_inputs():
    D, H, Hp, gamma, N = 16, 20, 6, 4, 96
    y = np.random.default_rng(7).standard_normal((N, D)).astype(np.float32)
    valid = np.r_[np.ones(80), np.zeros(16)].astype(np.float32)
    jm = jlinear.TSC(D, H, Hp, gamma, chunk=N, s_block=16)
    params = {k: np.asarray(v) for k, v in
              jm.standard_init({"y": y}, seed=5).items()}
    return (D, H, Hp, gamma, N), y, valid, params


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("saturated", [False, True])
def test_tsc_bigs_step_matches_jax_jit_step(backend, saturated):
    """One step of TSC(16, 20, 6, 4, s_block=16) against JAX's jit_step
    through its XLA scan and through its Pallas kernel (interpret mode,
    f32 operands), zero-weight rows included, as
    tests/test_bigs_pallas.py:79 holds the two JAX routes together."""
    (D, H, Hp, gamma, N), y, valid, params = _tsc_step_inputs()
    a = JAnneal(10)
    a["T"] = 1.0 if saturated else 1.6
    jm = jlinear.TSC(D, H, Hp, gamma, chunk=N, s_block=16, backend=backend)
    jm._pallas_interpret = jm._pallas_precise = True
    p_j, F_j, s_j = jm.jit_step(saturated=saturated)(
        {k: jnp.asarray(v) for k, v in params.items()},
        j_blank(y, valid=valid), sched_from_anneal(a), jax.random.PRNGKey(0))
    ta = LinearAnnealing(10)
    ta["T"] = a["T"]
    tm = TSC(D, H, Hp, gamma, chunk=N, s_block=16)
    p_t, F_t, s_t = tm.step_fn(params_from_numpy(params, "cpu"),
                               make_blank_data(y, valid, device="cpu"),
                               sched_floats(ta), torch.Generator(), saturated)
    got = params_to_numpy(p_t)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(p_j[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=2e-5,
                               atol=1e-4)
    for k in ("F_mean", "Q_mean", "n_used"):
        np.testing.assert_allclose(float(s_t[k]), float(s_j[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("family", ["bsc", "tsc", "dsc"])
def test_saturated_bigs_step_bit_identical(family):
    """The saturated step skips the un-annealed channel; the parameters and
    F come out bit-identical (tests/test_saturated.py:35 for JAX)."""
    values, signed, _, tcls, kw = FAMILY[family]
    model = tcls(25, 10, 6, 3, chunk=64, s_block=64, **kw)
    y = np.random.default_rng(0).standard_normal((128, 25)).astype(
        np.float32)
    params = model.standard_init({"y": y}, seed=1, device="cpu")
    data = make_blank_data(y, device="cpu")
    a = LinearAnnealing(10)
    a["W_noise"] = 0.3
    a["Ncut_factor"] = 0.5
    sched = sched_floats(a)                        # beta = prior_beta = 1
    p0, F0, s0 = model.step_fn(params, data, sched,
                               torch.Generator().manual_seed(3), False)
    p1, F1, s1 = model.step_fn(params, data, sched,
                               torch.Generator().manual_seed(3), True)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    assert torch.equal(F0, F1)
    assert float(s1["Q"]) == pytest.approx(float(s0["Q"]), rel=1e-6)
    assert float(s1["Q"]) == float(s1["F_total"])


@pytest.mark.parametrize("dense", [True, False])
def test_bigs_inference_matches_jax(dense):
    (D, H, Hp, gamma, N), y, _, params = _tsc_step_inputs()
    ref = jlinear.TSC(D, H, Hp, gamma, chunk=32, s_block=16).inference(
        {k: jnp.asarray(v) for k, v in params.items()}, {"y": y}, top_L=6,
        dense_states=dense)
    before = dict(linear_cuda.LAUNCHES)
    got = TSC(D, H, Hp, gamma, chunk=32, s_block=16).inference(
        params_from_numpy(params, "cpu"), {"y": y}, top_L=6,
        dense_states=dense)
    assert linear_cuda.LAUNCHES == before
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["F"].numpy(), np.asarray(ref["F"]),
                               rtol=2e-5, atol=2e-5)
    for k, rtol, atol in (("s_mean", 1e-4, 1e-5), ("recon", 1e-4, 1e-4),
                          ("top_probs", 1e-4, 1e-6)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=rtol, atol=atol, err_msg=k)
    for k in ("top_states", "top_single_unit", "top_single_value",
              "top_cand_states", "cand"):
        if k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                          err_msg=k)


def test_noise_free_tsc_bars_run_with_s_block_follows_jax():
    """Without parameter noise the run is deterministic: five iterations of
    TSC bars with s_block through ``EM.run(device="cpu")`` follow the JAX
    trajectory (W within rtol 1e-3)."""
    D, H, Hp, gamma = 16, 8, 6, 3
    tm = TSC(D, H, Hp, gamma, chunk=500, s_block=32)
    jm = jlinear.TSC(D, H, Hp, gamma, chunk=500, s_block=32)
    gt = bars_gt_params(jm, intensity=10.0, sigma=1.0)
    data = jm.generate_data(gt, 1000, seed=41)

    def anneal(cls):
        a = cls(5)
        a["T"] = [(0.0, 2.0), (0.8, 1.0)]
        a["Ncut_factor"] = [(0.4, 0.0), (1.0, 1.0)]
        return a
    y = np.asarray(data["y"])
    em_t = EM(tm, anneal(LinearAnnealing), {"y": y}, seed=23, device="cpu")
    em_j = JEM(jm, anneal(JAnneal), {"y": y}, seed=23)
    p_t, p_j = em_t.run(), em_j.run()
    np.testing.assert_allclose(p_t["W"].numpy(), np.asarray(p_j["W"]),
                               rtol=1e-3, atol=1e-4)
    for k in ("pi", "sigma"):
        np.testing.assert_allclose(float(p_t[k]), float(p_j[k]), rtol=1e-3)
    np.testing.assert_allclose([h["Q_mean"] for h in em_t.history],
                               [h["Q_mean"] for h in em_j.history],
                               rtol=1e-4)


def test_wrapper_takes_the_plain_version_on_cpu():
    """On a CPU tensor the big-S E-step's dispatcher runs the plain version
    and launches nothing; the kernel's wrapper itself takes CUDA only."""
    _, targs = _estep_inputs("tsc", 0.7, 1.0)
    before = dict(linear_cuda.LAUNCHES)
    F0, s0 = tet.linear_et_estep(*targs, chunk=128, s_block=48)
    F1, s1 = linear_cuda.linear_et_estep(*targs, chunk=128, s_block=48)
    assert linear_cuda.LAUNCHES == before
    assert torch.equal(F0, F1)
    for k in KEYS:
        assert torch.equal(s0[k], s1[k]), k
    values = (-1.0, 1.0)
    lo = np.full(2, np.log(0.05), np.float32)
    st, ot, vc, prior, valid, ab, _ = _tables(6, 4, values, 16, lo)
    rng = np.random.default_rng(1)
    proj = torch.tensor(rng.standard_normal((40, 6)), dtype=torch.float32)
    Gf = torch.tensor(rng.standard_normal((40, 36)), dtype=torch.float32)
    args = (proj, Gf, *map(torch.tensor, (st, ot, vc, prior, valid, ab)),
            torch.tensor(0.4), 0.7, 1.0, 16)
    with pytest.raises(ValueError):      # the kernel itself takes CUDA only
        bigs_cuda.bigs_multi_cuda(*args)
    with pytest.raises(ValueError):      # tables must be padded to s_block
        tet.bigs_multi(*args[:-1], 48)
