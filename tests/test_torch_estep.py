"""The port's plain E-step against the JAX package's XLA E-step and its
Pallas kernel (interpret mode, as tests/test_pallas.py runs it).

F is held at rtol/atol 2e-4 and the sums at 2e-3, the tolerances of
tests/test_pallas.py: the reduction orders differ between the three."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.core.etstep import linear_et_estep as jax_estep
from prosper_tpu.core.etstep import state_arrays_from as jax_sa
from prosper_tpu.core.states import discrete_state_space as jax_space
from prosper_tpu.ops.linear_pallas import linear_et_estep_pallas
from prosper_tpu_torch.core import etstep as tet
from prosper_tpu_torch.core.states import discrete_state_space
from prosper_tpu_torch.ops import linear_cuda

KEYS = ("xs", "ss", "s", "vc", "abs", "y2", "n", "F", "F_true")
FAMILIES = [([1.0], False), ([-1.0, 1.0], True), ([0.5, 1.0, 2.0], False),
            ([-1.0, 1.0, 2.0], True)]


def _inputs(N, values, signed, beta, seed=0, weight=None, D=16, H=12, Hp=6,
            gamma=3):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((N, D)) * 1.5).astype(np.float32)
    W = rng.standard_normal((D, H)).astype(np.float32)
    if weight is None:
        weight = (rng.random(N) > 0.2).astype(np.float32)
    K = len(values)
    lo = np.full(K, np.log(0.2 / K / 0.8), np.float32)
    return dict(y=y, w=np.asarray(weight, np.float32), W=W, lo=lo,
                values=values, signed=signed, beta=np.float32(beta), Hp=Hp,
                gamma=gamma, sigma2=np.float32(1.3))


def _jax_args(a):
    sa = jax_sa(jax_space(a["Hp"], a["gamma"], a["values"]))
    return (jnp.asarray(a["y"]), jnp.asarray(a["w"]), jnp.asarray(a["W"]),
            jnp.float32(a["sigma2"]), jnp.asarray(a["lo"]), sa, a["Hp"],
            a["signed"], jnp.float32(a["beta"]), jnp.float32(1.0))


def _torch_args(a, pad_to=None):
    y, w = a["y"], a["w"]
    if pad_to is not None:
        y = np.concatenate([y, np.zeros((pad_to - len(y), y.shape[1]),
                                        np.float32)])
        w = np.concatenate([w, np.zeros(pad_to - len(w), np.float32)])
    sa = tet.state_arrays_from(
        discrete_state_space(a["Hp"], a["gamma"], a["values"]), "cpu")
    return (torch.tensor(y), torch.tensor(w), torch.tensor(a["W"]),
            torch.tensor(a["sigma2"]), torch.tensor(a["lo"]), sa, a["Hp"],
            a["signed"], float(a["beta"]), 1.0)


def _assert_match(F_t, sums_t, F_j, sums_j, N):
    np.testing.assert_allclose(F_t.numpy()[:N], np.asarray(F_j),
                               rtol=2e-4, atol=2e-4)
    for k in KEYS:
        np.testing.assert_allclose(sums_t[k].numpy(), np.asarray(sums_j[k]),
                                   rtol=2e-3, atol=2e-3, err_msg=k)


@pytest.mark.parametrize("values,signed", FAMILIES)
@pytest.mark.parametrize("beta", [0.7, 1.0])
@pytest.mark.parametrize("collect_true", [True, False])
def test_plain_estep_matches_jax_xla(values, signed, beta, collect_true):
    a = _inputs(100, values, signed, beta)
    F_j, s_j = jax_estep(*_jax_args(a), chunk=4096, collect_true=collect_true)
    F_t, s_t = tet.linear_et_estep(*_torch_args(a), chunk=4096,
                                   collect_true=collect_true)
    _assert_match(F_t, s_t, F_j, s_j, 100)


@pytest.mark.parametrize("N", [33, 57, 100])
def test_chunked_padded_estep_matches_pallas_kernel(N):
    """The port's chunked E-step on weight-0-padded data against the Pallas
    kernel, which pads its last tile the same way."""
    a = _inputs(N, [1.0], False, 0.7)
    F_j, s_j = linear_et_estep_pallas(*_jax_args(a), tile=32, interpret=True)
    F_t, s_t = tet.linear_et_estep(*_torch_args(a, pad_to=-(-N // 32) * 32),
                                   chunk=32)
    _assert_match(F_t, s_t, F_j, s_j, N)


def test_zero_weight_tile_matches_pallas_kernel():
    w = np.ones(64, np.float32)
    w[32:] = 0.0
    a = _inputs(64, [-1.0, 1.0], True, 1.0, weight=w)
    F_j, s_j = linear_et_estep_pallas(*_jax_args(a), tile=32, interpret=True)
    F_t, s_t = tet.linear_et_estep(*_torch_args(a), chunk=32)
    _assert_match(F_t, s_t, F_j, s_j, 64)


def test_all_zero_weight_gives_zero_sums():
    a = _inputs(64, [1.0], False, 1.0, weight=np.zeros(64))
    F_t, s_t = tet.linear_et_estep(*_torch_args(a), chunk=32)
    for k in KEYS:
        np.testing.assert_allclose(s_t[k].numpy(), 0.0, atol=1e-6,
                                   err_msg=k)
    assert np.isfinite(F_t.numpy()).all()


def test_unchunkable_size_raises():
    a = _inputs(50, [1.0], False, 1.0)
    with pytest.raises(ValueError):
        tet.linear_et_estep(*_torch_args(a), chunk=32)


def test_kernel_wrapper_takes_the_plain_version_on_cpu():
    a = _inputs(64, [-1.0, 1.0, 2.0], True, 0.7)
    before = dict(linear_cuda.LAUNCHES)
    F_w, s_w = linear_cuda.linear_et_estep(*_torch_args(a), chunk=32)
    F_p, s_p = tet.linear_et_estep(*_torch_args(a), chunk=32)
    assert torch.equal(F_w, F_p)
    for k in KEYS:
        assert torch.equal(s_w[k], s_p[k]), k
    assert linear_cuda.LAUNCHES == before
    with pytest.raises(ValueError):      # the kernel itself takes CUDA only
        linear_cuda.linear_et_estep_cuda(*_torch_args(a))
