"""AutoTable, DataLog and checkpoints of the port: round trips, and
cross-reading with the JAX package (tests/test_io.py's cases, then each
package on the other's files)."""

import json

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.engine.anneal import LinearAnnealing as JAnneal
from prosper_tpu.engine.em import EM as JEM
from prosper_tpu.io import checkpoint as jckpt
from prosper_tpu.io import datalog as jdatalog
from prosper_tpu.models.linear import BSC as JBSC
from prosper_tpu_torch import EM, LinearAnnealing
from prosper_tpu_torch.io import checkpoint
from prosper_tpu_torch.io import datalog as tdatalog
from prosper_tpu_torch.io.autotable import AutoTable
from prosper_tpu_torch.io.datalog import (DataLog, StoreToH5, StoreToJSONL,
                                          StoreToTxt, TextPrinter)
from prosper_tpu_torch.models import BSC


def test_autotable_roundtrip(tmp_path):
    p = str(tmp_path / "t.h5")
    with AutoTable(p) as t:
        for i in range(5):
            t.append("W", np.full((3, 2), i, np.float32))
            t.append("Q", np.float64(i * 1.5))
        assert t["W"].shape == (5, 3, 2)
        np.testing.assert_allclose(t["Q"], [0.0, 1.5, 3.0, 4.5, 6.0])
    with AutoTable(p, "r") as t:
        assert set(t.keys()) == {"W", "Q"}
        assert t["W"][4, 0, 0] == 4
    with AutoTable(str(tmp_path / "u.h5")) as t:
        t.append("x", np.zeros(3))
        with pytest.raises(ValueError):
            t.append("x", np.zeros(4))


def test_datalog_dispatch_takes_tensors(tmp_path, capsys):
    """Handlers per channel; tensors go to the host inside ``append``; a
    channel no handler takes is not copied."""
    log = DataLog()
    h5 = log.set_handler(("Q", "pi", "W"), StoreToH5, str(tmp_path / "r.h5"))
    log.set_handler("Q", TextPrinter)
    txt = str(tmp_path / "r.txt")
    log.set_handler("pi", StoreToTxt, txt)

    class Untouchable:
        def __array__(self, *a, **k):
            raise AssertionError("an ignored channel was read")

    log.append_all({"Q": torch.tensor(1.0), "pi": 0.1,
                    "W": torch.ones(2, 3), "ignored": Untouchable()})
    log.append_all({"Q": 2.0, "pi": torch.tensor(0.2),
                    "W": torch.zeros(2, 3)})
    log.append("Q", torch.tensor(3.0))
    assert "Q = 1.0" in capsys.readouterr().out
    assert log.ignored("nope") and not log.ignored("Q")
    np.testing.assert_allclose(h5.table["Q"], [1.0, 2.0, 3.0])
    np.testing.assert_allclose(h5.table["pi"], [0.1, 0.2], rtol=1e-6)
    assert h5.table["W"].shape == (2, 2, 3)
    assert "ignored" not in h5.table.keys()
    log.close()
    assert open(txt).read().splitlines()[0] == "pi = 0.1"


def test_datalog_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    log = DataLog()
    log.set_handler(None, StoreToJSONL, path)
    log.append_all({"Q": 1.0, "W": torch.zeros((2, 2))})   # arrays skipped
    log.append_all({"Q": torch.tensor(2.0)})
    log.close()
    assert [json.loads(line) for line in open(path)] == [{"Q": 1.0},
                                                         {"Q": 2.0}]


def _records(n=4):
    rng = np.random.default_rng(0)
    return [{"F_mean": float(rng.standard_normal()),
             "pi": np.float32(rng.random()),
             "W": rng.standard_normal((5, 3)).astype(np.float32),
             "iteration": i} for i in range(n)]


def test_both_datalogs_write_the_same_files(tmp_path):
    """The same records (the port's as tensors) through both packages'
    DataLogs: equal H5 datasets and equal JSONL lines."""
    outs = {}
    for name, mod, conv in (
            ("jax", jdatalog, lambda v: jnp.asarray(v)),
            ("port", tdatalog, torch.as_tensor)):
        log = mod.DataLog()
        log.set_handler(None, mod.StoreToH5, str(tmp_path / f"{name}.h5"))
        log.set_handler(None, mod.StoreToJSONL,
                        str(tmp_path / f"{name}.jsonl"))
        for rec in _records():
            log.append_all({k: conv(v) if not isinstance(v, (int, float))
                            else v for k, v in rec.items()})
        log.close()
        outs[name] = open(tmp_path / f"{name}.jsonl").read()
    assert outs["jax"] == outs["port"]
    with h5py.File(tmp_path / "jax.h5") as a, \
            h5py.File(tmp_path / "port.h5") as b:
        assert set(a) == set(b) == {"F_mean", "pi", "W", "iteration"}
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_checkpoint_roundtrip(tmp_path):
    params = {"W": torch.arange(12.0).reshape(4, 3),
              "pi": torch.tensor(0.2), "sigma": torch.tensor(1.5)}
    g = torch.Generator().manual_seed(3)
    torch.randn(5, generator=g)
    p = str(tmp_path / "c.h5")
    checkpoint.save(p, params, step=7, generator=g,
                    extra={"F_prev": torch.arange(6.0),
                           "revive_last": np.int64(5)})
    got, step, state, extra = checkpoint.restore_full(p, "cpu")
    assert step == 7
    for k in params:
        assert torch.equal(got[k], params[k]) and got[k].dtype == torch.float32
    assert torch.equal(state, g.get_state())
    np.testing.assert_array_equal(extra["F_prev"], np.arange(6.0))
    assert int(extra["revive_last"]) == 5
    with h5py.File(p) as f:       # a fixed-length string to h5py
        assert "rng" not in f and f["torch_rng"].attrs["device_type"] == b"cpu"
    assert checkpoint.restore(p, "cpu")[1] == 7


def _jax_fixture():
    model = JBSC(16, 8, 5, 3)
    rng = np.random.default_rng(2)
    y = rng.standard_normal((200, 16)).astype(np.float32)
    anneal = JAnneal(6)
    anneal["W_noise"] = [(0.0, 0.3), (0.5, 0.0)]
    return model, y, anneal


def test_each_package_reads_the_others_checkpoint(tmp_path):
    """JAX's ``restore_full`` on a port checkpoint: equal params, step and
    extra, rng None; the port's on a JAX checkpoint: the same, state None;
    ``EM.resume`` takes a JAX checkpoint with a warning and goes on from
    its params and F_prev."""
    jmodel, y, janneal = _jax_fixture()
    jem = JEM(jmodel, janneal, {"y": y}, seed=1,
              checkpoint_path=str(tmp_path / "j.h5"), checkpoint_every=3)
    for _ in range(3):
        jem.step_once()
    params, step, state, extra = checkpoint.restore_full(
        str(tmp_path / "j.h5"), "cpu")
    jparams, jstep, jrng, jextra = jckpt.restore_full(str(tmp_path / "j.h5"))
    assert step == jstep == 3 and state is None and jrng is not None
    for k in jparams:
        np.testing.assert_array_equal(params[k].numpy(),
                                      np.asarray(jparams[k]))
    np.testing.assert_array_equal(extra["F_prev"], jextra["F_prev"])

    anneal = LinearAnnealing(6)
    em = EM(BSC(16, 8, 5, 3), anneal, {"y": y}, seed=1, device="cpu",
            checkpoint_path=str(tmp_path / "p.h5"), checkpoint_every=3)
    with pytest.warns(RuntimeWarning, match="no cpu generator state"):
        assert em.resume(str(tmp_path / "j.h5")) == 3
    np.testing.assert_array_equal(em.data["F_prev"].numpy(),
                                  jextra["F_prev"])
    em.run()
    pparams, pstep, prng, pextra = jckpt.restore_full(str(tmp_path / "p.h5"))
    assert pstep == 6 and prng is None
    for k in em.params:
        np.testing.assert_array_equal(np.asarray(pparams[k]),
                                      em.params[k].numpy())
    np.testing.assert_array_equal(pextra["F_prev"],
                                  em.data["F_prev"].numpy())


def test_resume_from_h5_reads_both_packages_result_files(tmp_path):
    """``resume_from_h5`` of each package on the other's ``result.h5``
    (a StoreToH5 log of a run) returns the same params."""
    jmodel, y, janneal = _jax_fixture()
    jlog = jdatalog.DataLog()
    jlog.set_handler(None, jdatalog.StoreToH5, str(tmp_path / "j.h5"))
    JEM(jmodel, janneal, {"y": y}, seed=1, dlog=jlog).run()
    jlog.close()
    log = DataLog()
    log.set_handler(None, StoreToH5, str(tmp_path / "p.h5"))
    anneal = LinearAnnealing(6)
    anneal["W_noise"] = [(0.0, 0.3), (0.5, 0.0)]
    EM(BSC(16, 8, 5, 3), anneal, {"y": y}, seed=1, device="cpu",
       dlog=log).run()
    log.close()
    for name in ("j.h5", "p.h5"):
        for row in (-1, 2):
            ours, s1 = checkpoint.resume_from_h5(str(tmp_path / name),
                                                 row=row, device="cpu")
            theirs, s2 = jckpt.resume_from_h5(str(tmp_path / name), row=row)
            assert s1 == s2 == (5 if row == -1 else 2)
            for k in theirs:
                np.testing.assert_array_equal(ours[k].numpy(),
                                              np.asarray(theirs[k]))
    with pytest.raises(KeyError):
        checkpoint.resume_from_h5(str(tmp_path / "p.h5"),
                                  param_names=("mu",), device="cpu")
