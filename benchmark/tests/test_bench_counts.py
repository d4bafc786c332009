"""The count functions against counts made by hand at small shapes, and
the peaks."""

from __future__ import annotations

import pytest

from benchmark.metrics import counts


def test_states_counted_by_hand():
    assert counts.n_states(8, 4) == 28 + 56 + 70 == 154
    assert counts.n_states(6, 3) == 15 + 20 == 35
    assert counts.n_states(3, 2) == 3


def test_linear_estep_by_hand():
    # N=2 rows, D=3, H=4, H'=2, S=1 (one state of both candidates)
    c = counts.linear_estep(2, 3, 4, 2, 1)
    gemms = 2 * (2 * 2 * 3 * 4)            # y W and y^T <s>
    per_state = 2 * (2 * (2 + 4) + 1 + 1)  # logit and moments, values, |s|
    assert c["flops"] == gemms + 2 * 1 * per_state
    assert c["bytes"] == 4 * (2 * 3 + 2 * 2 + 2 * 3 * 4 + 4 * 4)


def test_max_estep_by_hand():
    c = counts.max_estep(2, 3, 4, 5)
    assert c["flops"] == 2 * (2 * 2 * 3 * 4) + 8 * 2 * 5 * 3
    assert c["bytes"] == 4 * (2 * 3 + 2 * 2 + 3 * 4 + 2 * 4 * 3)


def test_decode_by_hand():
    c = counts.linear_decode(2, 3, 4, 2, 1, 5)
    assert c["flops"] == 2 * 2 * 3 * 4 + 2 * 2 * 1 * (2 + 4 + 2)
    assert c["bytes"] == 4 * (2 * 3 + 3 * 4 + 2 * (1 + 4 + 10 + 2))
    whole = counts.linear_inference(2, 3, 4, 2, 1, 5)
    assert whole["flops"] == c["flops"] + 2 * 3 * 16 + 2 * 2 * 3 * 4


def test_the_headline_shapes():
    """The counts the predictions were made from: 352 GFLOP an iteration
    of BSC and 379 of MCA at 10^6 rows, 0.71 and 0.77 ms at 495 TFLOP/s."""
    bsc = counts.linear_estep(10 ** 6, 256, 300, 8, 154)
    mca = counts.max_estep(10 ** 6, 256, 300, 35)
    assert bsc["flops"] == pytest.approx(3.52e11, rel=1e-2)
    assert mca["flops"] == pytest.approx(3.79e11, rel=1e-2)
    assert counts.least_seconds(bsc, "float32") == pytest.approx(7.1e-4,
                                                                 rel=1e-2)
    assert counts.least_seconds(mca, "float32") == pytest.approx(7.66e-4,
                                                                 rel=1e-2)


def test_peaks_and_the_bound_by_bytes():
    assert counts.PEAK_FLOPS == {"float32": 495e12, "bfloat16": 989e12,
                                 "float16": 989e12}
    assert counts.PEAK_BYTES == 3.35e12
    w = {"flops": 1.0, "bytes": 3.35e12}
    assert counts.least_seconds(w, "float32") == 1.0


def test_train_iteration_adds_the_m_step():
    cfg = {"D": 3, "H": 4, "Hprime": 2, "gamma": 2, "superposition": "linear"}
    it = counts.train_iteration(cfg, 2)
    assert it["flops"] == (counts.linear_estep(2, 3, 4, 2, 1)["flops"]
                           + counts.linear_mstep(3, 4)["flops"])
    cfg["superposition"] = "max"
    assert counts.train_iteration(cfg, 2)["flops"] == (
        counts.max_estep(2, 3, 4, 1)["flops"]
        + counts.max_mstep(3, 4)["flops"])
    cfg["superposition"] = "gaussian"
    with pytest.raises(ValueError, match="gaussian"):
        counts.train_iteration(cfg, 2)
