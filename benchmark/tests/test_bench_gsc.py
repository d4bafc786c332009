"""The GSC cell (``gsc_patches_train``, kind ``train_gsc``) at a tiny size on
the CPU: its counts against counts made by hand, a run's last line, and
``correct`` false for the control and for each fault, planted in the
program (a step that returns its state, half of the rows, a cut that keeps
every row, Sigma_s left out of <sz sz^T>) and in the reference's place."""

from __future__ import annotations

import argparse
import json

import pytest

from benchmark import calibrate_gsc, harness, run
from benchmark.metrics import counts, counts_gsc

SEED = 2 ** 32 + 71
CELL = "gsc_patches_train"


@pytest.fixture
def gsc_root(tiny_root):
    """``tiny_root`` with the GSC configuration and mix shrunk too."""
    bench = tiny_root / "benchmark"
    p = bench / "configs" / "gsc_patches.json"
    cfg = json.loads(p.read_text())
    cfg.update(D=16, H=12, Hprime=5, gamma=3, chunk=256)
    cfg["planted"]["active_pixels"] = 3
    p.write_text(json.dumps(cfg))
    p = bench / "traffic" / "em_protocol_gsc.json"
    tr = json.loads(p.read_text())
    tr.update(rows=3000, iterations=20, warmup_iterations=8)
    p.write_text(json.dumps(tr))
    return tiny_root


def _ctx(root, seconds=0.6):
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=seconds,
                              trace=0, started=None)
    return args, run.context(args, device="cpu", root=root)


def _correct(root):
    args, ctx = _ctx(root)
    return run.run_cell(ctx, args, root=root)[0]["correct"]


def test_gsc_counts_by_hand():
    # N=2 rows, D=3, H=4, H'=2, gamma=2: one support, of both candidates
    support = 8 / 3 + 2 * 4 + 8 + 2 * 2 + 2 + 2 * 3
    assert counts_gsc.support_madds(2) == pytest.approx(support)
    per_row = 2 * 3 * 4 + 5 * 4 + support + (1 + 4 + 1) + 2 + 4
    c = counts_gsc.gsc_estep(2, 3, 4, 2, 2)
    assert c["flops"] == pytest.approx(2 * 2 * per_row)
    assert c["bytes"] == 4 * (2 * 3 + 2 * 2 + 2 * 3 * 4 + 4 * 4 + 4)
    cfg = {"D": 3, "H": 4, "Hprime": 2, "gamma": 2}
    it = counts_gsc.train_iteration(cfg, 2)
    assert it["flops"] == pytest.approx(
        c["flops"] + counts.linear_mstep(3, 4)["flops"] + 2 * 4)
    assert it["bytes"] == c["bytes"] + counts.linear_mstep(3, 4)["bytes"]


def test_gsc_the_headline_shape():
    """315 GFLOP an iteration at 10^6 rows, the two products 98 % of it:
    0.636 ms at 495 TFLOP/s."""
    e = counts_gsc.gsc_estep(10 ** 6, 256, 300, 6, 3)
    assert e["flops"] == pytest.approx(3.149e11, rel=1e-3)
    assert 4.0 * 10 ** 6 * 256 * 300 / e["flops"] > 0.97
    assert counts.least_seconds(e, "float32") == pytest.approx(6.36e-4,
                                                               rel=1e-3)


def test_gsc_a_cpu_run_is_correct(gsc_root):
    args, ctx = _ctx(gsc_root)
    result, chk = run.run_cell(ctx, args, root=gsc_root)
    assert result["correct"], chk
    assert set(result["metrics"]) == {"setup_s", "train_rows_per_s"}
    assert set(chk) == {"F_rel", "param_rel", "F_rel.cut", "param_rel.cut"}
    assert result["attempted"] > 0 and result["failed"] == 0


def test_gsc_the_control_and_the_faults_fail_in_the_reference(gsc_root):
    _, ctx = _ctx(gsc_root)
    row = calibrate_gsc.train_row(ctx, True)
    assert harness.passed(harness.checks(row["program"], ctx.limits)), row
    assert set(row) == {"program", "control", "float32", "half_batch",
                        "unchanged", "no_slab_cov", "keep_every_row"}
    for name, values in row.items():
        # the float32 reference is a witness of rounding, not a fault
        if name not in ("program", "float32"):
            assert not harness.passed(harness.checks(values, ctx.limits)), (
                name, values)


def test_gsc_a_step_that_returns_its_state_fails(gsc_root, monkeypatch):
    from prosper_tpu_torch.models.gsc import GSC
    orig = GSC.step_fn

    def unchanged(self, params, data, sched, generator, *a, **k):
        _, F, scalars = orig(self, params, data, sched, generator, *a, **k)
        return dict(params), F, scalars
    monkeypatch.setattr(GSC, "step_fn", unchanged)
    assert not _correct(gsc_root)


def test_gsc_half_the_batch_left_out_fails(gsc_root, monkeypatch):
    from prosper_tpu_torch.models.gsc import GSC
    orig = GSC.estep_sums

    def half(self, params, y, weight, *a, **k):
        w = weight.clone()
        w[w.shape[0] // 2:] = 0.0
        return orig(self, params, y, w, *a, **k)
    monkeypatch.setattr(GSC, "estep_sums", half)
    assert not _correct(gsc_root)


def test_gsc_a_data_cut_that_keeps_every_row_fails(gsc_root, monkeypatch):
    import torch

    from prosper_tpu_torch.models import base
    monkeypatch.setattr(base, "ncut_keep_count",
                        lambda N_total, *a: torch.ceil(N_total * 1.0))
    assert not _correct(gsc_root)


def test_gsc_the_slab_covariance_left_out_fails(gsc_root, monkeypatch):
    """kappa kappa^T alone in <sz sz^T> of every support of 2 or 3 units."""
    import torch

    from prosper_tpu_torch.core import gscstep

    def no_cov(L):
        zero = torch.zeros_like(L[0][0])
        return [[zero] * len(L) for _ in L]
    monkeypatch.setattr(gscstep, "inverse_bl", no_cov)
    assert not _correct(gsc_root)
