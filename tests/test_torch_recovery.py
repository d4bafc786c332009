"""The recovery protocol of the port against the JAX package's.

``coactivation_split`` and one ``_maybe_revive_duplicates`` call per revival
branch (duplicates, dead columns, worst-F re-seeding, co-activation splits,
the symmetric split) give the same W, ``revival_stats`` and revival chain
state in both packages, exactly: the revival is host numpy on the same
``np.random.default_rng(seed + 1)`` chain, fed the same W, data and F_prev.
Then the port's own cases of tests/test_blend_split.py and
tests/test_restarts.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from prosper_tpu.engine.anneal import LinearAnnealing as JAnneal
from prosper_tpu.engine.em import EM as JEM
from prosper_tpu.engine.em import coactivation_split as j_split
from prosper_tpu.models.linear import BSC as JBSC
from prosper_tpu_torch import EM, LinearAnnealing, run_restarts
from prosper_tpu_torch.data.bars import bars_gt_params, count_recovered_bars
from prosper_tpu_torch.engine.em import coactivation_split
from prosper_tpu_torch.models import BSC


def _fused_rows(seed=0, D=64, n=2000):
    """tests/test_blend_split.py's data: two atoms, mostly alone."""
    rng = np.random.default_rng(seed)
    a1 = np.zeros(D)
    a1[[0, 3, 7, 11, 20, 33]] = 10.0
    a2 = np.zeros(D)
    a2[[5, 14, 28, 40, 51, 60]] = 10.0
    rows = []
    for _ in range(n):
        r = rng.random()
        x = 0.5 * rng.standard_normal(D)
        if r < 0.05:
            x += a1
        elif r < 0.10:
            x += a2
        elif r < 0.105:
            x += a1 + a2
        rows.append(x)
    return a1, a2, np.array(rows)


def test_coactivation_split_equals_jax():
    a1, a2, Y = _fused_rows()
    got, ref = coactivation_split(a1 + a2, Y), j_split(a1 + a2, Y)
    assert got is not None and ref is not None
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    # a single atom has no two-group structure: both reject
    rng = np.random.default_rng(1)
    single = np.zeros(64)
    single[[2, 9, 17, 25, 44, 58]] = 10.0
    Y1 = 0.5 * rng.standard_normal((1500, 64))
    Y1[:100] += single
    assert coactivation_split(single, Y1) is None
    assert j_split(single, Y1) is None
    # and a lower contrast gate (the offline sweep's) on the same inputs
    for g, r in zip(coactivation_split(a1 + a2, Y, contrast_threshold=0.22),
                    j_split(a1 + a2, Y, contrast_threshold=0.22)):
        np.testing.assert_array_equal(g, r)


def _bars(N=1500, seed=3):
    model = BSC(25, 10, 6, 3)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    return model, gt, model.generate_data(gt, N, seed=seed)


BRANCHES = {
    # name: (W0 edit, EM options, the revival_stats counter that must move)
    "duplicates": ("dup", dict(revive_duplicates=(1, 0.9, 1.0)), "reseeded"),
    "dead": ("dead", dict(revive_duplicates=(1, 0.99, 1.0, 0.1)),
             "reseeded"),
    "reseed_worst": ("dup", dict(revive_duplicates=(1, 0.9, 1.0),
                                 reseed_worst_frac=0.1), "reseeded"),
    "split_coact": ("blend", dict(revive_duplicates=(1, 0.9, 1.0),
                                  split_norm_frac=1.25, split_coact=True),
                    "coact_split"),
    "symmetric_split": ("blend", dict(revive_duplicates=(1, 0.9, 1.0),
                                      split_norm_frac=1.25), "sym_split"),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_revival_branch_equals_jax(branch):
    """A JAX EM and a port EM on the CPU, built from the same params, data,
    F_prev and seed, after one revival: W bit for bit, the same counts and
    the same revival chain state (and again after a second revival, which
    starts from the chain the first left)."""
    edit, opts, counter = BRANCHES[branch]
    _, gt, data = _bars()
    gtW = np.asarray(gt["W"])
    W0 = gtW + 0.01 * np.random.default_rng(4).standard_normal(gtW.shape)
    if edit == "dup":
        W0[:, 9] = W0[:, 0] * 0.9
    elif edit == "dead":
        W0[:, 3] = 1e-4
    else:        # a blend of bars 8 and 9; column 9 frees by duplicating 0
        W0[:, 8] = gtW[:, 8] + gtW[:, 9]
        W0[:, 9] = gtW[:, 0]
    params = {"W": W0.astype(np.float32), "pi": np.float32(0.2),
              "sigma": np.float32(1.0)}
    N = data["y"].shape[0]
    F_prev = np.random.default_rng(5).standard_normal(N).astype(np.float32)
    valid = np.ones(N, np.float32)
    valid[::7] = 0.0
    feed = {"y": data["y"], "valid": valid, "F_prev": F_prev}

    jem = JEM(JBSC(25, 10, 6, 3), JAnneal(6),
              {k: jnp.asarray(v) for k, v in feed.items()},
              params={k: jnp.asarray(v) for k, v in params.items()}, seed=9,
              **opts)
    em = EM(BSC(25, 10, 6, 3), LinearAnnealing(6), dict(feed),
            params=params, seed=9, device="cpu", **opts)
    for _ in range(2):
        jem.anneal.next()
        em.anneal.next()
        jem._maybe_revive_duplicates()
        em._maybe_revive_duplicates()
        np.testing.assert_array_equal(em.params["W"].numpy(),
                                      np.asarray(jem.params["W"]))
        assert em.revival_stats == jem.revival_stats
        np.testing.assert_array_equal(em.revival_rng_state(),
                                      jem.revival_rng_state())
        assert em._last_revive == jem._last_revive
    assert em.revival_stats[counter] > 0, em.revival_stats
    assert not np.array_equal(em.params["W"].numpy(), W0.astype(np.float32))


def test_em_blend_split_end_to_end():
    """A fused-bars init un-blends through revival and co-activation
    splitting (tests/test_blend_split.py through the port)."""
    model, gt, data = _bars()
    gtW = np.asarray(gt["W"])
    W0 = gtW.copy()
    W0[:, 8] = gtW[:, 8] + gtW[:, 9]
    W0[:, 9] = gtW[:, 0]
    params0 = {"W": W0 + 0.01, "pi": np.float32(0.2),
               "sigma": np.float32(1.0)}
    anneal = LinearAnnealing(12)
    anneal["T"] = 1.0
    em = EM(model, anneal, {"y": data["y"]}, params=params0, seed=2,
            device="cpu", revive_duplicates=(3, 0.9, 1.0),
            split_norm_frac=1.25, split_coact=True)
    params = em.run()
    assert em.revival_stats["coact_split"] >= 1
    assert count_recovered_bars(params["W"].numpy(), gtW, 0.85) == 10


def test_split_coact_alone_defaults_pool_threshold():
    model = BSC(16, 8, 5, 3)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    y = model.generate_data(gt, 200, seed=1)["y"]
    em = EM(model, LinearAnnealing(2), {"y": y}, seed=0, device="cpu",
            revive_duplicates=(1, 0.9), split_coact=True)
    assert em.split_norm_frac == 1.5
    assert em.revive_duplicates == (1, 0.9, 0.75, 0.0)
    em2 = EM(model, LinearAnnealing(2), {"y": y}, seed=0, device="cpu",
             revive_duplicates=(1, 0.9), split_coact=True,
             split_norm_frac=2.0)
    assert em2.split_norm_frac == 2.0
    with pytest.raises(ValueError, match="revive_duplicates"):
        EM(model, LinearAnnealing(2), {"y": y}, device="cpu",
           revive_duplicates=(1,))


@pytest.mark.parametrize("scanned", [True, False], ids=["scanned", "run"])
def test_run_restarts_selects_best_final_f(scanned):
    model = BSC(16, 8, 5, 3)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    data = model.generate_data(gt, 600, seed=7)
    ems = []

    def build(i):
        anneal = LinearAnnealing(20)
        anneal["T"] = [(0.0, 2.0), (0.7, 1.0)]
        anneal["W_noise"] = [(0.0, 1.0), (0.7, 0.0)]
        em = EM(model, anneal, {"y": data["y"]}, seed=100 + i, device="cpu",
                params=model.standard_init(data, seed=200 + i, device="cpu"))
        ems.append(em)
        return em

    params, summary = run_restarts(build, 3, scanned=scanned)
    assert len(summary["F_means"]) == 3
    best = summary["best"]
    assert summary["F_means"][best] == max(summary["F_means"])
    assert params["W"] is ems[best].params["W"]
    assert count_recovered_bars(params["W"].numpy(), gt["W"], 0.8) == 8
    with pytest.raises(ValueError):
        run_restarts(build, 0)
