"""The linear family's ``compute_dtype`` in the port against the JAX
package's: the two D x H products at bf16 and fp16 (the plain version of
the 16-bit GEMM kernels), one EM step of BSC, TSC, DSC and big-S TSC,
``run_scanned`` against ``run``, the float32 defaults, a state axis, and
the rule that a 16-bit cast reaches those two products and nothing else.

Both packages get the same numpy inputs.  The kernels themselves run on
the card (``tests/test_torch_cuda.py``); here the routes take CPU tensors
and run ``core/etstep.py::matmul_as``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.engine.anneal import LinearAnnealing as JAnneal
from prosper_tpu.models import linear as jlinear
from prosper_tpu.models.base import make_blank_data as j_blank
from prosper_tpu.models.base import sched_from_anneal
from prosper_tpu_torch import EM, LinearAnnealing
from prosper_tpu_torch.core import etstep
from prosper_tpu_torch.core.states import discrete_state_space
from prosper_tpu_torch.io.weights import params_from_numpy, params_to_numpy
from prosper_tpu_torch.models import BSC, DSC, TSC
from prosper_tpu_torch.models.base import make_blank_data, sched_floats
from prosper_tpu_torch.ops import bigs_cuda, gemm_cuda, linear_cuda

FAMILY = {"bsc": (jlinear.BSC, BSC), "tsc": (jlinear.TSC, TSC),
          "dsc": (jlinear.DSC, DSC)}
HALF = {"bf16": (torch.bfloat16, jnp.bfloat16),
        "fp16": (torch.float16, jnp.float16)}


def _jax_dot(a, b, dt):
    return np.asarray(jnp.dot(jnp.asarray(a).astype(dt),
                              jnp.asarray(b).astype(dt),
                              preferred_element_type=jnp.float32))


@pytest.mark.parametrize("half", list(HALF))
def test_the_two_products_match_jaxs_compute_dtype_dots(half):
    """P = y W and xs = y^T sw at a 16-bit type against JAX's
    ``jnp.dot(a.astype(dt), b.astype(dt), preferred_element_type=f32)``:
    within rtol 1e-5 / atol 2e-7 per unit of depth, and more than 1e-4
    (relative to the largest entry) away from the unrounded product."""
    tdt, jdt = HALF[half]
    rng = np.random.default_rng(11)
    y = rng.standard_normal((512, 256)).astype(np.float32)
    W = (rng.standard_normal((256, 300)) * 0.3).astype(np.float32)
    sw = rng.random((512, 300)).astype(np.float32)
    for got, want, exact, depth in (
            (etstep.matmul_as(torch.tensor(y), torch.tensor(W), tdt),
             _jax_dot(y, W, jdt), y.astype(np.float64) @ W, 256),
            (etstep.matmul_as(torch.tensor(y).T, torch.tensor(sw), tdt),
             _jax_dot(y.T, sw, jdt), y.T.astype(np.float64) @ sw, 512)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=2e-7 * depth)
        assert (np.abs(got.numpy() - exact).max()
                > 1e-4 * np.abs(exact).max())
    with pytest.raises(ValueError, match="bfloat16"):
        gemm_cuda.hgemm_nn_cuda(torch.tensor(y), torch.tensor(W),
                                torch.float64)


@pytest.mark.parametrize("half", list(HALF))
def test_ties_round_to_even_as_torch_and_jax_round(half):
    """Operands exactly halfway between two neighbours of the 16-bit type
    (times the identity, which keeps each rounded value): the product
    holds ``x.to(dtype)`` and JAX's ``astype``, ties to even, on both
    sides of the product."""
    tdt, jdt = HALF[half]
    rng = np.random.default_rng(3)
    lo = torch.tensor(rng.standard_normal((64, 64)), dtype=tdt)
    nxt = (lo.view(torch.int16) + 1).view(tdt)      # the next, away from 0
    mid = (lo.float() + nxt.float()) / 2            # exact in float32
    want = mid.to(tdt).float()
    assert not torch.equal(want, mid)
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(jnp.asarray(mid.numpy()).astype(jdt)
                                 .astype(jnp.float32)))
    eye = torch.eye(64)
    for got in (etstep.matmul_as(mid, eye, tdt),
                etstep.matmul_as(eye, mid, tdt)):
        assert torch.equal(got, want)


def _step_inputs(family, D, H, Hp, gamma, N, seed, y):
    if y is None:
        y = (np.random.default_rng(seed).standard_normal((N, D))
             * 2.0).astype(np.float32)
    p_np = {k: np.asarray(v) for k, v in FAMILY[family][0](
        D, H, Hp, gamma).standard_init({"y": y}, seed=1).items()}
    return y, p_np


@functools.lru_cache(maxsize=None)
def _jax_step(family, shape, jkw, y_seed=None):
    """One ``jit_step`` of the JAX model (``jkw`` as sorted items), made
    once per test process."""
    y = (None if y_seed is None else np.random.default_rng(y_seed)
         .standard_normal((128, shape[0])).astype(np.float32))
    y, p_np = _step_inputs(family, *shape, 4, y)
    ja = JAnneal(10)
    ja["T"] = 1.5
    return FAMILY[family][0](*shape[:4], **dict(jkw)).jit_step(False)(
        {k: jnp.asarray(v) for k, v in p_np.items()}, j_blank(y),
        sched_from_anneal(ja), jax.random.PRNGKey(0))


def _port_step(family, shape=(16, 10, 5, 3, 256), tkw=None, y_seed=None):
    """The port's ``step_fn`` from the inputs of ``_jax_step``."""
    y = (None if y_seed is None else np.random.default_rng(y_seed)
         .standard_normal((128, shape[0])).astype(np.float32))
    y, p_np = _step_inputs(family, *shape, 4, y)
    a = LinearAnnealing(10)
    a["T"] = 1.5
    return FAMILY[family][1](*shape[:4], **(tkw or {})).step_fn(
        params_from_numpy(p_np, "cpu"), make_blank_data(y, device="cpu"),
        sched_floats(a), torch.Generator())


def _assert_step_close(out_t, out_j, rtol=1e-4):
    (p_t, F_t, s_t), (p_j, F_j, s_j) = out_t, out_j
    got = params_to_numpy(p_t)
    assert set(got) == set(p_j)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(p_j[k]), rtol=rtol,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=rtol)
    for k in s_j:
        np.testing.assert_allclose(float(s_t[k]), float(s_j[k]), rtol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("form", ["dtype", "name"])
@pytest.mark.parametrize("family", ["bsc", "tsc", "dsc"])
def test_one_step_at_bfloat16_matches_jax(family, form):
    """One ``step_fn`` at ``compute_dtype=torch.bfloat16`` (or the name)
    against JAX's ``jit_step`` at ``jnp.bfloat16``, within the rtol 1e-4 of
    the float32 step parity; W differs from the port's float32 step."""
    cdt = torch.bfloat16 if form == "dtype" else "bfloat16"
    shape = (16, 10, 5, 3, 256)
    out_t = _port_step(family, shape, dict(chunk=64, compute_dtype=cdt))
    _assert_step_close(out_t, _jax_step(
        family, shape, (("chunk", 64), ("compute_dtype", jnp.bfloat16))))
    f32 = _port_step(family, shape, dict(chunk=64))
    assert not np.allclose(out_t[0]["W"].numpy(), f32[0]["W"].numpy(),
                           rtol=1e-5, atol=0.0)


def test_big_s_step_at_bfloat16_matches_jax():
    """The configuration of the JAX package's own big-S ``compute_dtype``
    test (``tests/test_linear_oracle.py``): TSC(16, 12, 6, 4, chunk=128,
    s_block=48, compute_dtype="bfloat16") on 128 rows, one step against
    ``jit_step``."""
    kw = dict(chunk=128, s_block=48, compute_dtype="bfloat16")
    shape = (16, 12, 6, 4, 128)
    _assert_step_close(_port_step("tsc", shape, kw, y_seed=9),
                       _jax_step("tsc", shape, tuple(sorted(kw.items())),
                                 y_seed=9))


def test_run_scanned_is_bit_identical_to_run_at_bfloat16():
    """``run_scanned`` and ``run`` of a bf16 BSC over 150 rows (two chunks,
    one part padding) and annealed -> saturated with noise and the data
    cut: the same parameters and scalars, bit for bit."""
    rng = np.random.default_rng(3)
    y = (rng.standard_normal((150, 16)) * 2.0).astype(np.float32)

    def em():
        a = LinearAnnealing(4)
        a["T"] = [(0.0, 2.0), (0.6, 1.0)]
        a["W_noise"] = [(0.0, 0.5), (0.6, 0.0)]
        a["Ncut_factor"] = [(0.4, 0.0), (1.0, 1.0)]
        return EM(BSC(16, 10, 5, 3, chunk=128, compute_dtype="bfloat16"), a,
                  {"y": y}, seed=7, device="cpu")
    ref, scanned = em(), em()
    ref.run()
    scanned.run_scanned()
    for k in ref.params:
        assert torch.equal(ref.params[k], scanned.params[k]), k
    for hr, hs in zip(ref.history, scanned.history):
        for k in hr:
            if k != "dt":
                assert hr[k] == hs[k], k


def test_float32_defaults_are_todays_path_and_bad_dtypes_raise():
    """``compute_dtype=None``, ``torch.float32`` and ``"float32"`` give the
    step of a model built without it, bit for bit; anything else than the
    accepted values raises a ValueError naming them."""
    ref = _port_step("tsc")
    for cdt in (None, torch.float32, "float32"):
        got = _port_step("tsc", tkw=dict(compute_dtype=cdt))
        assert TSC(16, 10, 5, 3, compute_dtype=cdt).compute_dtype is None
        for k in ref[0]:
            assert torch.equal(got[0][k], ref[0][k]), (cdt, k)
        assert torch.equal(got[1], ref[1])
    assert BSC(16, 10, 5, 3, compute_dtype="float16").compute_dtype is \
        torch.float16
    for bad in (torch.float64, "bf16", jnp.bfloat16, 16):
        with pytest.raises(ValueError, match="'bfloat16'"):
            DSC(16, 10, 5, 3, compute_dtype=bad)


def test_a_state_axis_step_at_bfloat16_matches_the_unsharded_step():
    """One bf16 step of TSC on a (1, 2) grid (``tests/state_threads.py``:
    two state ranks in this process): every rank ends with the same
    parameters.  Each state rank rounds its own part of sw to bf16 before
    xs = y^T sw and the parts are added after, as the JAX package's state
    psum adds them, so the step is held to the unsharded bf16 step within
    2^-8 of the largest entry (two bf16 roundings), and is nearer to it
    than the float32 step is."""
    from state_threads import run_state_shards
    y = (np.random.default_rng(4).standard_normal((128, 16)) * 2.0).astype(
        np.float32)
    a = LinearAnnealing(10)
    a["T"] = 1.5

    def step(model, state_axis=None):
        p = model.standard_init({"y": y}, seed=1, device="cpu")
        return model.step_fn(p, make_blank_data(y, device="cpu"),
                             sched_floats(a), torch.Generator(),
                             state_axis=state_axis,
                             n_state_shards=1 if state_axis is None else 2)
    model = TSC(16, 10, 5, 3, chunk=64, compute_dtype=torch.bfloat16)
    ref, f32 = step(model), step(TSC(16, 10, 5, 3, chunk=64))
    parts, _ = run_state_shards(2, lambda g: step(model, g))
    for p_s, F_s, _ in parts:
        assert torch.equal(F_s, parts[0][1])
        for k in ref[0]:
            assert torch.equal(p_s[k], parts[0][0][k]), k
            scale = ref[0][k].abs().max()
            torch.testing.assert_close(p_s[k], ref[0][k], rtol=0.0,
                                       atol=2.0 ** -8 * scale, msg=k)
        torch.testing.assert_close(F_s, ref[1], rtol=1e-5, atol=1e-5)
    off = (parts[0][0]["W"] - ref[0]["W"]).abs().max()
    assert off < (f32[0]["W"] - ref[0]["W"]).abs().max()


def _estep_args(values=(-1.0, 1.0), Hp=6, zero_y=False):
    rng = np.random.default_rng(21)
    N, D, H = 96, 16, 12
    y = torch.tensor(rng.standard_normal((N, D)) * 2.0, dtype=torch.float32)
    if zero_y:
        y = torch.zeros_like(y)
    W = torch.tensor(rng.standard_normal((D, H)), dtype=torch.float32)
    w = torch.tensor(rng.random(N) > 0.2, dtype=torch.float32)
    lo = torch.full((len(values),), -2.0)
    sa = etstep.state_arrays_from(discrete_state_space(Hp, 3, values), "cpu")
    return (y, w, W, torch.tensor(1.7), lo, sa, Hp, len(values) > 1, 0.6,
            0.9)


def test_a_16_bit_cast_reaches_only_the_two_products():
    """(a) The plain bf16 E-step is, bit for bit, P = matmul_as(y, W), the
    rows stage (``linear_et_estep_rows``: the rows kernel's plain version)
    on float32 y and W, then xs = matmul_as(y^T, sw): no rounded y reaches
    ||y||^2 and no rounded W the Gram matrix or the rows' inputs.  (b) With
    y = 0 both products are 0 whatever they round, so the bf16 E-step
    equals the float32 one bit for bit on every path: plain fused, plain
    big-S, the kernels' dispatch on the CPU, the big-S wrapper and a state
    axis of 2."""
    from state_threads import run_state_shards
    bf = torch.bfloat16
    args = _estep_args()
    y, w, W = args[:3]
    F, sums = etstep.linear_et_estep(*args, chunk=96, compute_dtype=bf)
    P = etstep.matmul_as(y, W, bf)
    F_r, sw, rest = etstep.linear_et_estep_rows(y, w, P, *args[2:])
    assert torch.equal(F, F_r)
    assert torch.equal(sums["xs"], etstep.matmul_as(y.T, sw, bf))
    for k in rest:
        assert torch.equal(sums[k], rest[k]), k

    args = _estep_args(zero_y=True)
    paths = {
        "fused": lambda cdt: etstep.linear_et_estep(
            *args, chunk=48, compute_dtype=cdt),
        "bigs": lambda cdt: etstep.linear_et_estep(
            *args, chunk=48, s_block=16, compute_dtype=cdt),
        "dispatch": lambda cdt: linear_cuda.linear_et_estep(
            *args, chunk=96, compute_dtype=cdt),
        "bigs_wrapper": lambda cdt: bigs_cuda.linear_et_estep_bigs(
            *args, 16, compute_dtype=cdt),
        "state": lambda cdt: run_state_shards(
            2, lambda g: linear_cuda.linear_et_estep(
                *args, state_axis=g, n_state_shards=2,
                compute_dtype=cdt))[0][0],
    }
    for name, run in paths.items():
        (F16, s16), (F32, s32) = run(bf), run(None)
        assert torch.equal(F16, F32), name
        for k in s32:
            assert torch.equal(s16[k], s32[k]), (name, k)
