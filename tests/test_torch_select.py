"""Parity of the port's candidate selection and data sub-selection with the
JAX package (core/select.py, truncated_prior_logmass)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.core import etstep as jet
from prosper_tpu.core import select as jsel
from prosper_tpu_torch.core import etstep as tet
from prosper_tpu_torch.core import select as tsel


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("signed", [False, True])
def test_top_hprime_candidates_matches_jax(signed):
    rng = np.random.default_rng(0)
    # quarter-integers: many exact ties, which must go to the lowest index
    P = (np.round(rng.standard_normal((200, 17)) * 4) / 4).astype(np.float32)
    w_norm = np.abs(rng.standard_normal(17)).astype(np.float32) + 0.5
    w_norm[3] = 0.0                                 # floored at 1e-12
    ref = jsel.top_hprime_candidates(jnp.asarray(P), jnp.asarray(w_norm), 6,
                                     signed)
    got = tsel.top_hprime_candidates(_t(P), _t(w_norm), 6, signed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_top_l_argmax_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.integers(0, 5, size=(300, 40)).astype(np.float32) / 4
    ref_q, ref_u = jsel.top_l_argmax(jnp.asarray(q), 12)
    got_q, got_u = tsel.top_l_argmax(_t(q), 12)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(ref_u))
    with pytest.raises(ValueError):
        tsel.top_l_argmax(_t(q), 41)


@pytest.mark.parametrize("keep_frac", [0.2, 0.5, 0.93, 1.0])
@pytest.mark.parametrize("partial", [False, True])
def test_ncut_threshold_selects_the_same_rows(keep_frac, partial):
    rng = np.random.default_rng(2)
    N = 3000
    F = (rng.standard_normal(N) * 30 - 100).astype(np.float32)
    valid = np.ones(N, np.float32)
    valid[-37:] = 0.0                                # padding rows
    if partial:
        valid[rng.random(N) < 0.4] = 0.0
    keep = np.float32(np.ceil(keep_frac * valid.sum()))
    ref = jsel.global_quantile_threshold(jnp.asarray(F), jnp.asarray(valid),
                                         jnp.asarray(keep), None)
    got = tsel.global_quantile_threshold(_t(F), _t(valid),
                                         torch.tensor(keep))
    assert got.item() == float(ref)
    mask_ref = np.asarray(valid * (F >= np.asarray(ref)))
    mask_got = (_t(valid) * (_t(F) >= got).float()).numpy()
    np.testing.assert_array_equal(mask_got, mask_ref)
    assert abs(mask_got.sum() - keep) <= 2


@pytest.mark.parametrize("log_pi", [np.log(0.2), np.log(2 / 300), -1e-9])
@pytest.mark.parametrize("H,gamma", [(10, 3), (300, 4)])
def test_prior_logmass_and_keep_count_match_jax(log_pi, H, gamma):
    lp = np.float32(log_pi)
    rA, rB = jet.truncated_prior_logmass(jnp.float32(lp), H, gamma)
    gA, gB = tet.truncated_prior_logmass(torch.tensor(lp), H, gamma)
    np.testing.assert_allclose(gA.item(), float(rA), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gB.item(), float(rB), rtol=1e-6, atol=1e-6)
    for n, f in [(1000.0, 0.5), (131072.0, 1.0), (57.0, 0.0)]:
        ref = jsel.ncut_keep_count(jnp.float32(n), jnp.float32(f), rA)
        got = tsel.ncut_keep_count(torch.tensor(n), f, gA)
        assert abs(got.item() - float(ref)) <= 1.0


@pytest.mark.parametrize("frac", [0.01, 0.3, 0.999])
def test_exact_count_mask(frac):
    g = torch.Generator().manual_seed(0)
    valid = torch.ones(500)
    valid[450:] = 0.0
    m = tsel.exact_count_mask(g, 500, frac, valid=valid)
    assert m.sum().item() == np.clip(np.ceil(frac * 450), 1, 500)
    assert m[450:].sum().item() == 0.0
    ref = jsel.exact_count_mask(jax.random.PRNGKey(0), 500, frac,
                                valid=jnp.asarray(valid.numpy()))
    assert float(jnp.sum(ref)) == m.sum().item()
