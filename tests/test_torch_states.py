"""Parity of the port's host-side pieces with the JAX package: state
enumeration, annealing schedules and the synthetic-data toolkit."""

import numpy as np
import pytest

from prosper_tpu.core import states as jstates
from prosper_tpu.data import bars as jbars
from prosper_tpu.engine.anneal import LinearAnnealing as JAnneal
from prosper_tpu_torch.core import states as tstates
from prosper_tpu_torch.data import bars as tbars
from prosper_tpu_torch.engine.anneal import LinearAnnealing as TAnneal


@pytest.mark.parametrize("Hp,gamma,values,min_active", [
    (6, 3, [1.0], 2),
    (5, 3, [-1.0, 1.0], 2),
    (5, 3, [-1.0, 1.0, 2.0], 2),
    (8, 4, [1.0], 2),
    (4, 3, [0.5, 2.0], 1),
])
def test_discrete_state_space_matches_jax(Hp, gamma, values, min_active):
    ref = jstates.discrete_state_space(Hp, gamma, values,
                                       min_active=min_active,
                                       use_native=False)
    got = tstates.discrete_state_space(Hp, gamma, values,
                                       min_active=min_active)
    for name in ("states", "abs_states", "value_counts", "values", "outer"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.S == tstates.n_multi_states(Hp, gamma, len(values),
                                           min_active)


def test_patches_state_count():
    # the headline configuration: C(8,2) + C(8,3) + C(8,4) multi states
    assert tstates.n_multi_states(8, 4, 1) == 154
    assert tstates.discrete_state_space(8, 4, [1.0]).S == 154


@pytest.mark.parametrize("args", [(3, 4, [1.0]), (3, 2, [0.0, 1.0]),
                                  (3, 2, [])])
def test_state_space_rejects_what_jax_rejects(args):
    with pytest.raises(ValueError):
        jstates.discrete_state_space(*args, use_native=False)
    with pytest.raises(ValueError):
        tstates.discrete_state_space(*args)


def _mixed(cls, steps):
    a = cls(steps)
    a["T"] = [(0.0, 2.0), (0.5, 1.0)]
    a["W_noise"] = [(0.9, 5.0), (5, 1.0), (0.2, 0.0)]   # fraction + absolute
    a["Ncut_factor"] = [(0.0, 0.0), (0.5, 0.0), (0.9, 1.0)]
    a["partial"] = 0.7
    a["anneal_prior"] = True
    return a


@pytest.mark.parametrize("steps", [1, 7, 60])
def test_linear_annealing_matches_jax(steps):
    ref, got = _mixed(JAnneal, steps), _mixed(TAnneal, steps)
    while not ref.finished:
        assert got.as_scalars() == ref.as_scalars()
        assert got["W_noise"] == ref["W_noise"]
        ref.next()
        got.next()
    assert got.finished
    with pytest.raises(StopIteration):
        got.next()
    got.reset(0)
    assert got.position == 0
    with pytest.raises(ValueError):
        TAnneal(0)


def test_bars_toolkit_matches_jax():
    np.testing.assert_array_equal(tbars.generate_bars_dict(10, neg_bars=True),
                                  jbars.generate_bars_dict(10, neg_bars=True))

    class Cfg:
        D, H = 25, 12
    for k in ("W", "pi", "sigma"):
        np.testing.assert_array_equal(tbars.bars_gt_params(Cfg, sigma=2.0)[k],
                                      jbars.bars_gt_params(Cfg, sigma=2.0)[k])
    rng = np.random.default_rng(0)
    Wt = tbars.generate_bars_dict(10)
    Wl = Wt[:, rng.permutation(10)] + 0.3 * rng.standard_normal((25, 10))
    for signed in (False, True):
        a = tbars.cosine_match(Wl, Wt, signed)
        b = jbars.cosine_match(Wl, Wt, signed)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_allclose(a[1], b[1])
    assert (tbars.count_recovered_bars(Wl, Wt, 0.8)
            == jbars.count_recovered_bars(Wl, Wt, 0.8))


def test_planted_dictionary_matches_example():
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "patches_scale_run.py")
    spec = importlib.util.spec_from_file_location("patches_scale_run", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    np.testing.assert_array_equal(tbars.planted_dictionary(256, 300, seed=3),
                                  mod.planted_dictionary(256, 300, seed=3))
