"""``correct`` comes out false for the control and for every fault a cell
can have, with the cells' own limits, at a size a CPU test run holds.

The faults are planted in the program underneath a run that skips the
harness's look for a card: a step that returns its state unchanged, half
of the rows left out of the E-step (the means taken over the rest), a
data cut that keeps every row, the exchange between ranks left out (four
gloo processes), and a decoded answer altered where it is produced.  The control is the reference
computed with TF32 products in the program's place."""

from __future__ import annotations

import argparse

import pytest

from benchmark import calibrate, harness, run
from benchmark.tests.conftest import ROOT

SEED = 2 ** 32 + 71


def _ctx(root, cell, seconds=0.6):
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=seconds,
                              trace=0, started=None)
    return args, run.context(args, device="cpu", root=root)


def _correct(root, cell):
    args, ctx = _ctx(root, cell)
    return run.run_cell(ctx, args, root=root)[0]["correct"]


def _fails(ctx, values):
    return not harness.passed(harness.checks(values, ctx.limits))


@pytest.mark.parametrize("cell", ["bsc_patches_train", "mca_patches_train",
                                  "bsc_patches_decode"])
def test_the_control_fails_and_the_program_passes(tiny_root, cell):
    _, ctx = _ctx(tiny_root, cell)
    row_of = (calibrate.train_row if ctx.traffic["kind"] == "train"
              else calibrate.decode_row)
    row = row_of(ctx, True)
    assert not _fails(ctx, row["program"]), row
    for name, values in row.items():
        # the float32 reference is a witness of rounding, not a fault
        if name not in ("program", "float32"):
            assert _fails(ctx, values), (name, values)


@pytest.mark.parametrize("cell", ["bsc_patches_train", "mca_patches_train"])
def test_a_step_that_returns_its_state_fails(tiny_root, monkeypatch, cell):
    from prosper_tpu_torch.models import base
    for cls in base.ETModel.__subclasses__() + [c for k in
                                                base.ETModel.__subclasses__()
                                                for c in k.__subclasses__()]:
        if "step_fn" in vars(cls):
            orig = vars(cls)["step_fn"]

            def unchanged(self, params, data, sched, generator, *a,
                          _orig=orig, **k):
                _, F, scalars = _orig(self, params, data, sched, generator,
                                      *a, **k)
                return dict(params), F, scalars
            monkeypatch.setattr(cls, "step_fn", unchanged)
    assert not _correct(tiny_root, cell)


@pytest.mark.parametrize("cell", ["bsc_patches_train", "mca_patches_train"])
def test_half_the_batch_left_out_fails(tiny_root, monkeypatch, cell):
    from prosper_tpu_torch.models.linear import LinearETModel
    from prosper_tpu_torch.models.mca import MCA
    for cls in (LinearETModel, MCA):
        orig = cls.estep_sums

        def half(self, params, y, weight, *a, _orig=orig, **k):
            w = weight.clone()
            w[w.shape[0] // 2:] = 0.0
            return _orig(self, params, y, w, *a, **k)
        monkeypatch.setattr(cls, "estep_sums", half)
    assert not _correct(tiny_root, cell)


def test_an_altered_answer_fails(tiny_root, monkeypatch):
    from prosper_tpu_torch.models.linear import LinearETModel
    orig = LinearETModel.inference

    def altered(self, *a, **k):
        out = orig(self, *a, **k)
        out["s_mean"][0, 1] += 0.5
        return out
    monkeypatch.setattr(LinearETModel, "inference", altered)
    assert not _correct(tiny_root, "bsc_patches_decode_sat")


WORKER = '''
import sys
import prosper_tpu_torch.models.linear as linear
linear.reduce_sums = lambda sums, N_total, *a, **k: (sums, N_total)
sys.path.insert(0, {root!r})
from benchmark import run
sys.exit(run.main())
'''


@pytest.mark.parametrize("fault", [False, True])
def test_the_exchange_left_out_fails(tiny_root, monkeypatch, fault):
    """Four ranks (gloo, CPU) of the data-parallel cell: sound, they pass;
    with the sums never reduced over the ranks, they fail."""
    if fault:
        script = tiny_root / "no_exchange.py"
        script.write_text(WORKER.format(root=str(tiny_root)))
    else:
        script = tiny_root / "benchmark" / "run.py"
    monkeypatch.setattr(run, "WORKER", script)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    args, ctx = _ctx(tiny_root, "bsc_patches_train_dp4", seconds=0.5)
    assert ctx.chips == 4
    result, chk = run.run_cell(ctx, args, root=tiny_root)
    assert result["correct"] is (not fault), chk
    assert result["device"]["count"] == 4


@pytest.mark.parametrize("cell", ["bsc_patches_train", "mca_patches_train"])
def test_a_data_cut_that_keeps_every_row_fails(tiny_root, monkeypatch,
                                                cell):
    import torch

    from prosper_tpu_torch.models import base
    monkeypatch.setattr(base, "ncut_keep_count",
                        lambda N_total, *a: torch.ceil(N_total * 1.0))
    assert not _correct(tiny_root, cell)
