"""Checkpoint -> resume -> continue through the port (the port's versions of
tests/test_resume.py).

A checkpoint of the port holds the parameters, the step, the generator's
state, F_prev and the revival chain's state and cadence, so on the CPU a
resumed run equals the uninterrupted one bit for bit (``torch.equal``),
through ``run`` and through ``run_scanned``, with and without revival, at
aligned and misaligned cadences.
"""

import json

import h5py
import numpy as np
import pytest
import torch

from prosper_tpu_torch import EM, LinearAnnealing
from prosper_tpu_torch.data.bars import bars_gt_params
from prosper_tpu_torch.io import checkpoint
from prosper_tpu_torch.io.datalog import DataLog, StoreToH5, StoreToJSONL
from prosper_tpu_torch.models import BSC


def _anneal(steps=20):
    a = LinearAnnealing(steps)
    a["T"] = [(0.0, 1.5), (0.6, 1.0)]
    a["W_noise"] = [(0.0, 0.5), (0.6, 0.0)]                  # the generator
    a["Ncut_factor"] = [(0.0, 0.0), (0.3, 0.0), (0.8, 1.0)]  # F_prev
    return a


def _fixture():
    model = BSC(25, 10, 6, 3)
    gt = bars_gt_params(model, intensity=10.0, sigma=2.0)
    data = model.generate_data(gt, 400, seed=11)
    return model, {"y": data["y"]}


def _go(em, loop):
    return em.run() if loop == "run" else em.run_scanned()


def _assert_same_end(ref: EM, em: EM, first: int):
    """``em`` (resumed at ``first``) ended where ``ref`` did, bit for bit:
    parameters, F_prev, the generator's state (and with revival the
    revival chain's), and the scalars of every iteration from ``first``
    on."""
    for k in ref.params:
        assert torch.equal(em.params[k], ref.params[k]), k
    assert torch.equal(em.data["F_prev"], ref.data["F_prev"])
    assert torch.equal(em.generator.get_state(), ref.generator.get_state())
    if ref.revive_duplicates is not None:
        np.testing.assert_array_equal(em.revival_rng_state(),
                                      ref.revival_rng_state())
    assert len(em.history) == len(ref.history) - first
    for he, hr in zip(em.history, ref.history[first:]):
        assert {k: v for k, v in he.items() if k != "dt"} == \
            {k: v for k, v in hr.items() if k != "dt"}


@pytest.mark.parametrize("loop", ["run", "scanned"])
@pytest.mark.parametrize("revive,cut", [(None, 10), ((5, 0.50, 1.0), 10),
                                        ((6, 0.50, 1.0), 8)],
                         ids=["no_revival", "revival", "revival_misaligned"])
def test_resumed_run_equals_uninterrupted(tmp_path, loop, revive, cut):
    """Interrupted at ``cut`` and resumed into a fresh EM with another seed
    (the checkpoint's generator state wins), through ``run`` or
    ``run_scanned``; revival every 5 (fires at 5, 10, 15) or every 6 with
    the checkpoint at 8, between two firings (``revive_last`` keeps the
    cadence)."""
    model, data = _fixture()
    ckpt = str(tmp_path / "c.h5")
    em1 = EM(model, _anneal(), dict(data), seed=5, device="cpu",
             revive_duplicates=revive)
    _go(em1, loop)

    em2 = EM(model, _anneal(), dict(data), seed=5, device="cpu",
             checkpoint_path=ckpt, checkpoint_every=cut,
             revive_duplicates=revive)
    if loop == "run":
        for _ in range(cut):
            em2.step_once()
    else:
        em2.run_scanned(cut)
    _, step, state, extra = checkpoint.restore_full(ckpt, "cpu")
    assert step == cut and state is not None and "F_prev" in extra
    if revive is not None:
        assert int(extra["revive_last"]) == (cut // revive[0]) * revive[0]
        # the test has teeth only if revival drew before the cut
        fresh = EM(model, _anneal(), dict(data), seed=5, device="cpu",
                   revive_duplicates=revive)
        assert not np.array_equal(extra["revive_rng"],
                                  fresh.revival_rng_state())
        assert em2.revival_stats["revived"] > 0

    em3 = EM(model, _anneal(), dict(data), seed=999, device="cpu",
             revive_duplicates=revive)
    assert em3.resume(ckpt) == cut
    _go(em3, loop)
    _assert_same_end(em1, em3, cut)


def test_resume_mixes_run_and_run_scanned(tmp_path):
    """A checkpoint written by ``run`` resumes through ``run_scanned`` on
    the same trajectory (both draw from one generator the same way)."""
    model, data = _fixture()
    ckpt = str(tmp_path / "c.h5")
    revive = (4, 0.5, 1.0)
    em1 = EM(model, _anneal(), dict(data), seed=5, device="cpu",
             revive_duplicates=revive)
    em1.run()
    em2 = EM(model, _anneal(), dict(data), seed=5, device="cpu",
             checkpoint_path=ckpt, checkpoint_every=7,
             revive_duplicates=revive)
    for _ in range(7):
        em2.step_once()
    em3 = EM(model, _anneal(), dict(data), seed=1, device="cpu",
             revive_duplicates=revive)
    assert em3.resume(ckpt) == 7
    em3.run_scanned()
    _assert_same_end(em1, em3, 7)


@pytest.mark.parametrize("loop", ["run", "scanned"])
def test_checkpoint_cadence_with_unequal_periods(tmp_path, monkeypatch,
                                                 loop):
    """checkpoint_every=6 and revival every 4: checkpoints fire at 6, 12,
    18, 24 through ``run`` and through ``run_scanned``, whose windows end
    where either action is due (4, 6, 8, 12, ...).  The JAX package cuts
    its scan at multiples of the smaller period and checkpoints at the
    crossings 8, 16, 24; ending the windows at each due point keeps
    ``run``'s cadence, and a resumed run's revivals where the uninterrupted
    run has them (``test_resumed_run_equals_uninterrupted``)."""
    saves = []
    real_save = checkpoint.save

    def spy(path, params, step, generator=None, extra=None):
        saves.append(step)
        real_save(path, params, step=step, generator=generator, extra=extra)

    monkeypatch.setattr(checkpoint, "save", spy)
    model, data = _fixture()
    em = EM(model, _anneal(24), dict(data), seed=5, device="cpu",
            checkpoint_path=str(tmp_path / "c.h5"), checkpoint_every=6,
            revive_duplicates=(4, 0.99))
    _go(em, loop)
    assert saves == [6, 12, 18, 24], saves


def _logged_run(tmp_path, name, loop, collect=False):
    log = DataLog()
    log.set_handler(("W", "pi", "sigma", "F_mean", "iteration"), StoreToH5,
                    str(tmp_path / f"{name}.h5"))
    log.set_handler(None, StoreToJSONL, str(tmp_path / f"{name}.jsonl"))
    model, data = _fixture()
    em = EM(model, _anneal(12), dict(data), seed=5, device="cpu", dlog=log,
            log_params_every=3)
    if loop == "run":
        em.run()
    else:
        em.run_scanned(collect_params=collect)
    log.close()
    return em


def test_run_scanned_collect_params_logs_what_run_logs(tmp_path):
    """collect_params=True: the per-iteration parameters of run_scanned go
    to the data log with the thinning of ``log_params_every`` (W at
    iterations 0, 3, 6, 9; pi and sigma at every one), equal to ``run``'s
    bit for bit; without it the scalars alone."""
    _logged_run(tmp_path, "loop", "run")
    _logged_run(tmp_path, "scan", "scanned", collect=True)
    _logged_run(tmp_path, "bare", "scanned")
    with h5py.File(tmp_path / "loop.h5") as f1, \
            h5py.File(tmp_path / "scan.h5") as f2, \
            h5py.File(tmp_path / "bare.h5") as f3:
        assert f1["W"].shape == (4, 25, 10) and f1["pi"].shape == (12,)
        assert set(f2) == set(f1)
        for k in f1:
            np.testing.assert_array_equal(np.asarray(f2[k]),
                                          np.asarray(f1[k]), err_msg=k)
        assert set(f3) == {"F_mean", "iteration"}
        np.testing.assert_array_equal(np.asarray(f3["F_mean"]),
                                      np.asarray(f1["F_mean"]))
    rows = [[json.loads(line) for line in open(tmp_path / f"{n}.jsonl")]
            for n in ("loop", "scan")]
    assert len(rows[0]) == len(rows[1]) == 12
    for a, b in zip(*rows):
        assert ({k: v for k, v in a.items() if k != "dt"}
                == {k: v for k, v in b.items() if k != "dt"})


def test_cli_truncate_logs(tmp_path):
    """Resume rewinds result.h5 / metrics.jsonl to the checkpoint step:
    one row per iteration for scalars and vectors, W at the multiples of
    log_params_every."""
    from prosper_tpu_torch.cli import _truncate_logs

    with h5py.File(tmp_path / "result.h5", "w") as f:
        for name, rows, shape in [("F_mean", 17, ()), ("pi", 17, ()),
                                  ("W", 9, (3, 2))]:
            f.create_dataset(name, shape=(rows,) + shape,
                             maxshape=(None,) + shape,
                             chunks=(1,) + shape if shape else (64,))
    with open(tmp_path / "metrics.jsonl", "w") as f:
        for i in range(17):
            f.write('{"it": %d}\n' % i)

    _truncate_logs(str(tmp_path), step=10, log_params_every=2)

    with h5py.File(tmp_path / "result.h5") as f:
        assert f["F_mean"].shape[0] == 10
        assert f["pi"].shape[0] == 10
        assert f["W"].shape[0] == 5          # iterations 0, 2, 4, 6, 8
    assert sum(1 for _ in open(tmp_path / "metrics.jsonl")) == 10


def test_resume_without_a_state_for_the_device_warns(tmp_path):
    """A checkpoint whose generator state is of another device type (here
    marked as written on the card) or absent (the JAX package's) restarts
    the noise chain from the seed, with a warning, and still restores the
    parameters, step and F_prev; an F_prev of another length raises."""
    model, data = _fixture()
    em = EM(model, _anneal(), dict(data), seed=5, device="cpu")
    for _ in range(3):
        em.step_once()
    path = str(tmp_path / "c.h5")
    em.save_checkpoint(path)
    with h5py.File(path, "a") as f:
        f["torch_rng"].attrs["device_type"] = "cuda"
    fresh = EM(model, _anneal(), dict(data), seed=7, device="cpu")
    seeded = fresh.generator.get_state()
    with pytest.warns(RuntimeWarning, match="restart from the seed"):
        assert fresh.resume(path) == 3
    assert torch.equal(fresh.generator.get_state(), seeded)
    assert torch.equal(fresh.params["W"], em.params["W"])
    assert torch.equal(fresh.data["F_prev"], em.data["F_prev"])

    short = EM(model, _anneal(), {"y": data["y"][:300]}, seed=7,
               device="cpu")
    with pytest.raises(ValueError, match="F_prev"):
        short.resume(path)
