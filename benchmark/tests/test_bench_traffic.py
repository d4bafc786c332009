"""The traffic and the data repeat exactly under one seed; other seeds get
the same work in another order."""

from __future__ import annotations

import json
from collections import Counter

import torch

from benchmark import data
from benchmark.drivers import decode
from benchmark.tests.conftest import ROOT

SEED = 2 ** 31 + 977


def _mix(name):
    return json.loads((ROOT / "benchmark" / "traffic"
                       / f"{name}.json").read_text())


def test_request_plans_repeat_under_a_seed():
    for name in ("image_patches", "image_patches_sat"):
        tr = _mix(name)
        a, b = decode.plan(tr, SEED, 20.0), decode.plan(tr, SEED, 20.0)
        assert a == b
        c = decode.plan(tr, SEED + 1, 20.0)
        assert a != c
        assert Counter(r["rows"] for r in a) == Counter(r["rows"] for r in c)
        assert sorted(r["due"] for r in a) == sorted(r["due"] for r in c)
        assert {r["rows"] for r in a} == {58081, 247009, 374241}
        assert all(0 <= r["offset"] <= tr["pool_rows"] - r["rows"]
                   for r in a)
        assert a[-1]["due"] >= 20.0
        assert [r["due"] for r in a] == [i / tr["rate_per_s"]
                                         for i in range(len(a))]
        keep = decode.checked(tr, a, SEED, 20.0)
        assert keep == decode.checked(tr, a, SEED, 20.0)
        assert max(a[i]["rows"] for i in keep) == 374241


def test_rows_and_parameters_repeat_under_a_seed():
    cfg = {"D": 16, "H": 12, "superposition": "linear",
           "planted": {"active_pixels": 3, "intensity": 10.0,
                       "pi_times_H": 2.0, "sigma": 1.0}}
    W1, y1 = data.training_data(cfg, SEED, 700, 0, "cpu")
    W2, y2 = data.training_data(cfg, SEED, 700, 0, "cpu")
    assert torch.equal(W1, W2) and torch.equal(y1, y2)
    assert (W1 > 0).sum(dim=0).eq(3).all()
    _, y3 = data.training_data(cfg, SEED, 700, 1, "cpu")
    assert not torch.equal(y1, y3)
    mean, std = data.moments(y1)
    assert torch.allclose(mean, y1.double().mean(dim=0))
    assert abs(std - float(y1.double().std(correction=0))) < 1e-9

    def init(run):
        return data.init_params(mean, std, 12,
                                data.generator("cpu", SEED, "init", run))
    p1, p2 = init(0), init(0)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert not torch.equal(p1["W"], init(1)["W"])


def test_max_rows_take_the_largest_active_atom():
    W = torch.tensor([[10.0, 0.0], [0.0, 10.0], [10.0, 10.0]])
    g = data.generator("cpu", 3, "t")
    y = data.rows(W, 2000, 0.5, 0.0, "max", g)
    assert set(torch.unique(y).tolist()) <= {0.0, 10.0}
    both = (y[:, 0] == 10) & (y[:, 1] == 10)
    assert bool((y[both, 2] == 10).all())


def test_derived_seeds_differ_by_use_and_take_large_seeds():
    assert data.derive(SEED, "a") != data.derive(SEED, "b")
    assert data.derive(2 ** 40, "a") == data.derive(2 ** 40, "a")
    assert 0 <= data.derive(2 ** 40, "a") < 2 ** 63
