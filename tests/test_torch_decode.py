"""The port's posterior decode (serving path) against the JAX package's
XLA decode and its fused Pallas decode kernel (interpret mode), as
tests/test_decode_pallas.py holds the two JAX paths to each other: F,
s_mean, recon and top_probs to float32 tolerance, and the top-state
identities (dense and compact) exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.core.etstep import densify_top_states as jax_densify
from prosper_tpu.core.etstep import linear_et_posterior as jax_posterior
from prosper_tpu.core.etstep import linear_et_posterior_pallas
from prosper_tpu.core.etstep import state_arrays_from as jax_sa
from prosper_tpu.core.states import discrete_state_space as jax_space
from prosper_tpu.models.linear import BSC as JBSC
from prosper_tpu.models.linear import DSC as JDSC
from prosper_tpu_torch.core import etstep as tet
from prosper_tpu_torch.core.states import discrete_state_space
from prosper_tpu_torch.models import BSC, DSC
from prosper_tpu_torch.ops import linear_cuda

EXACT = ("top_states", "top_single_unit", "top_single_value",
         "top_cand_states", "cand")


def _setup(values, seed=0, N=100, D=12, H=11, Hp=5, gamma=3):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((N, D)).astype(np.float32)
    W = rng.standard_normal((D, H)).astype(np.float32)
    K = len(values)
    pi = 0.4 / (H * K)
    lo = np.full((K,), np.float32(np.log(pi) - np.log1p(-K * pi)))
    return y, W, lo, Hp, gamma


def _both(values, signed, dense, beta=1.0, prior_beta=1.0, top_L=7, seed=0,
          sigma2=0.64):
    y, W, lo, Hp, gamma = _setup(values, seed)
    kw = dict(Hp=Hp, signed_select=signed, top_L=top_L, dense_states=dense)
    sa_j = jax_sa(jax_space(Hp, gamma, list(values)))
    jargs = (jnp.asarray(y), jnp.asarray(W), jnp.float32(sigma2),
             jnp.asarray(lo), sa_j)
    jb = dict(beta=jnp.float32(beta), prior_beta=jnp.float32(prior_beta))
    ref_xla = jax_posterior(*jargs, chunk=32, **kw, **jb)
    ref_pl = linear_et_posterior_pallas(*jargs, interpret=True, **kw, **jb)
    sa_t = tet.state_arrays_from(discrete_state_space(Hp, gamma, values),
                                 "cpu")
    got = tet.linear_et_posterior(torch.tensor(y), torch.tensor(W),
                                  torch.tensor(np.float32(sigma2)),
                                  torch.tensor(lo), sa_t, chunk=32,
                                  beta=beta, prior_beta=prior_beta, **kw)
    return got, ref_xla, ref_pl


def _assert_match(got, ref):
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["F"].numpy(), np.asarray(ref["F"]),
                               rtol=2e-5, atol=2e-5)
    for k, rtol, atol in (("s_mean", 1e-4, 1e-5), ("recon", 1e-4, 1e-4),
                          ("top_probs", 1e-4, 1e-6)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=rtol, atol=atol, err_msg=k)
    for k in EXACT:
        if k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                          err_msg=k)


@pytest.mark.parametrize("values,signed", [((1.0,), False),
                                           ((-1.0, 1.0), True),
                                           ((-1.0, 1.0, 2.0), True)])
@pytest.mark.parametrize("dense", [True, False])
def test_plain_decode_matches_jax_xla_and_pallas(values, signed, dense):
    got, ref_xla, ref_pl = _both(values, signed, dense)
    _assert_match(got, ref_xla)
    _assert_match(got, ref_pl)


def test_annealed_decode_and_densify_round_trip():
    got, ref, _ = _both((1.0,), False, dense=False, beta=0.5, prior_beta=0.7,
                        top_L=5, seed=3, sigma2=1.21)
    _assert_match(got, ref)
    dense = tet.densify_top_states(got, 11)
    np.testing.assert_array_equal(dense.numpy(),
                                  np.asarray(jax_densify(ref, 11)))
    full, _, _ = _both((1.0,), False, dense=True, beta=0.5, prior_beta=0.7,
                       top_L=5, seed=3, sigma2=1.21)
    assert torch.equal(dense, full["top_states"])


def test_top_states_from_topk_decodes_canonical_indices():
    """0 = zero state, 1 + h*K + k = singleton, 1 + H*K + s = multi."""
    H, K = 4, 2
    values = torch.tensor([-1.0, 2.0])
    states = torch.tensor([[2.0, -1.0], [-1.0, -1.0]])
    cand = torch.tensor([[3, 1]], dtype=torch.int32)
    top_u = torch.tensor([[0, 1 + 2 * K + 1, 1 + H * K + 1]],
                         dtype=torch.int32)
    top_q = torch.tensor([[0.5, 0.3, 0.2]])
    out = tet.top_states_from_topk(top_q, top_u, H, K, values, states, cand,
                                   dense=True)
    expect = torch.tensor([[[0.0, 0, 0, 0], [0, 0, 2, 0], [0, -1, 0, -1]]])
    assert torch.equal(out["top_states"], expect)
    compact = tet.top_states_from_topk(top_q, top_u, H, K, values, states,
                                       cand, dense=False)
    compact["cand"] = cand
    assert compact["top_single_unit"].tolist() == [[-1, 2, -1]]
    assert torch.equal(tet.densify_top_states(compact, H), expect)


@pytest.mark.parametrize("dense", [True, False, None])
def test_model_inference_matches_jax_model(dense):
    rng = np.random.default_rng(9)
    D, H = 20, 14
    y = rng.standard_normal((96, D)).astype(np.float32)
    W = rng.standard_normal((D, H)).astype(np.float32)
    pi = np.full(3, 0.01, np.float32)
    params = {"W": W, "pi": pi, "sigma": np.float32(1.0)}
    ref = JDSC(D, H, 5, 3).inference(
        {k: jnp.asarray(v) for k, v in params.items()}, {"y": y}, top_L=4,
        dense_states=dense)
    got = DSC(D, H, 5, 3).inference(
        {k: torch.as_tensor(v) for k, v in params.items()}, {"y": y},
        top_L=4, dense_states=dense)
    _assert_match(got, ref)


def test_kernel_path_on_cpu_is_the_plain_decode():
    y, W, lo, Hp, gamma = _setup((1.0,))
    sa = tet.state_arrays_from(discrete_state_space(Hp, gamma, [1.0]), "cpu")
    args = (torch.tensor(y), torch.tensor(W), torch.tensor(0.7),
            torch.tensor(lo), sa, Hp, False, 6)
    before = dict(linear_cuda.LAUNCHES)
    a = tet.linear_et_posterior(*args, dense_states=False,
                                decode=linear_cuda.linear_et_decode)
    b = tet.linear_et_posterior(*args, dense_states=False)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert linear_cuda.LAUNCHES == before


def test_top_l_beyond_the_union_raises():
    y = np.zeros((4, 12), np.float32)
    params = {"W": torch.ones(12, 11), "pi": torch.tensor(0.1),
              "sigma": torch.tensor(1.0)}
    with pytest.raises(ValueError):
        BSC(12, 11, 5, 3).inference(params, {"y": y}, top_L=1 + 11 + 20 + 1)
    with pytest.raises(ValueError):
        JBSC(12, 11, 5, 3, backend="pallas").inference(
            {k: jnp.asarray(v.numpy()) for k, v in params.items()},
            {"y": y}, top_L=1 + 11 + 20 + 1)
