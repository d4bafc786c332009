"""The port's command line (``python -m prosper_tpu_torch.cli``), all on
``--device cpu``, against the JAX package's CLI on the same JSON config:
``generate`` writes equal arrays, ``train`` of a noise-free BSC config ends
within rtol 1e-4, ``infer`` on one checkpoint matches within the decode
tolerances of tests/test_torch_decode.py, ``diagnose`` prints the same
report.  Then the port alone: a run killed mid-way and resumed equals the
uninterrupted run bit for bit (through ``run`` and ``--scan``), the configs,
and the data-parallel switches outside ``torchrun``."""

import glob
import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from prosper_tpu import cli as jcli
from prosper_tpu_torch import cli
from prosper_tpu_torch.data.bars import generate_bars_dict
from prosper_tpu_torch.engine.em import EM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(tmp_path, name="cfg.json", **over):
    """A BSC bars config (D=16, H=8) with gt_params, N = 300 (no padding:
    N <= chunk), no parameter noise and partial 1 unless ``over`` adds
    them."""
    anneal = {"steps": 6, "T": [[0.0, 2.0], [0.7, 1.0]]}
    anneal.update(over.pop("anneal", {}))
    cfg = {"model": {"type": "bsc", "D": 16, "H": 8, "Hprime": 5,
                     "gamma": 3},
           "anneal": anneal,
           "gt_params": {"W": generate_bars_dict(8, intensity=10.0).tolist(),
                         "pi": 0.25, "sigma": 1.0},
           "N": 300, "seed": 3, "checkpoint_every": 2, **over}
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """generate, train, infer and diagnose through both CLIs on one config
    and one data file (JAX's): {name: path}."""
    d = tmp_path_factory.mktemp("cli")
    cfg = _config(d)
    out = {"cfg": cfg}
    clis = (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"]))
    for tag, main, dev in clis:
        out[f"{tag}_gen"] = str(d / f"{tag}_gen.h5")
        assert main(["generate", cfg, "-N", "256", "--seed", "5",
                     "-o", out[f"{tag}_gen"]]) == 0
        out[f"{tag}_run"] = str(d / f"{tag}_run")
        assert main(["train", cfg, "--data", out["jax_gen"], "-o",
                     out[f"{tag}_run"], "-q"] + dev) == 0
    for tag, main, dev in clis:
        # both decode the port's checkpoint: the decode alone differs
        out[f"{tag}_inf"] = str(d / f"{tag}_inf.h5")
        assert main(["infer", cfg, "-c", os.path.join(out["port_run"],
                                                      "checkpoint.h5"),
                     "--data", out["jax_gen"], "-o", out[f"{tag}_inf"],
                     "--top", "4"] + dev) == 0
    return out


def test_generate_equals_jax(both):
    with h5py.File(both["jax_gen"]) as a, h5py.File(both["port_gen"]) as b:
        assert a["patches"].dtype == b["patches"].dtype == np.float32
        np.testing.assert_array_equal(np.asarray(b["patches"]),
                                      np.asarray(a["patches"]))


def test_train_matches_jax(both):
    with h5py.File(os.path.join(both["jax_run"], "result.h5")) as a, \
            h5py.File(os.path.join(both["port_run"], "result.h5")) as b:
        assert set(a) == set(b)
        for k in ("W", "pi", "sigma"):
            assert a[k].shape == b[k].shape
            np.testing.assert_allclose(np.asarray(b[k]), np.asarray(a[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(np.asarray(b["F_mean"]),
                                   np.asarray(a["F_mean"]), rtol=1e-4)
    rows = [len(open(os.path.join(both[f"{t}_run"], "metrics.jsonl"))
                .readlines()) for t in ("jax", "port")]
    assert rows == [6, 6]


def test_infer_matches_jax(both):
    with h5py.File(both["jax_inf"]) as a, h5py.File(both["port_inf"]) as b:
        assert set(a) == set(b)
        np.testing.assert_allclose(np.asarray(b["F"]), np.asarray(a["F"]),
                                   rtol=2e-5, atol=2e-5)
        for k, rtol, atol in (("s_mean", 1e-4, 1e-5), ("recon", 1e-4, 1e-4),
                              ("top_probs", 1e-4, 1e-6)):
            np.testing.assert_allclose(np.asarray(b[k]), np.asarray(a[k]),
                                       rtol=rtol, atol=atol, err_msg=k)
        np.testing.assert_array_equal(np.asarray(b["top_states"]),
                                      np.asarray(a["top_states"]))


@pytest.mark.parametrize("args", [["--json"], ["--json", "--gt", "CFG"],
                                  ["--gt", "CFG"]],
                         ids=["health_json", "recovery_json",
                              "recovery_text"])
def test_diagnose_prints_what_jax_prints(both, args, capsys):
    """Both CLIs on the JAX run's checkpoint and on the port's: the same
    output, character for character."""
    args = [both["cfg"] if a == "CFG" else a for a in args]
    for run in ("jax_run", "port_run"):
        ckpt = os.path.join(both[run], "checkpoint.h5")
        capsys.readouterr()
        assert jcli.main(["diagnose", "-c", ckpt] + args) == 0
        ref = capsys.readouterr().out
        assert cli.main(["diagnose", "-c", ckpt] + args) == 0
        assert capsys.readouterr().out == ref
        if "--json" in args:
            assert json.loads(ref)["step"] == 6


def _crash_after(monkeypatch, name, calls):
    """Make ``EM.<name>`` raise on its call number ``calls + 1``."""
    real = getattr(EM, name)
    seen = []

    def wrapped(self, *a, **k):
        if len(seen) == calls:
            raise KeyboardInterrupt("killed")
        seen.append(1)
        return real(self, *a, **k)
    monkeypatch.setattr(EM, name, wrapped)


@pytest.mark.parametrize("scan", [False, True], ids=["run", "scan"])
def test_resume_mid_run_equals_uninterrupted(tmp_path, monkeypatch, scan):
    """A noisy run (W noise, a data cut, revival) killed after 5 iterations
    (through ``run``; checkpoint at 4) or after two windows (``--scan``,
    windows end at 2, 3, 4, 6 where a checkpoint or revival is due;
    checkpoint at 2), a log row to drop either way, and resumed with
    ``--resume``:
    result.h5, metrics.jsonl (but ``dt``) and the final checkpoint equal the
    uninterrupted run's."""
    cfg = _config(tmp_path, anneal={"W_noise": [[0.0, 0.5], [0.6, 0.0]],
                                    "Ncut_factor": [[0.5, 0.0], [0.9, 1.0]]},
                  revive_duplicates=[3, 0.5, 1.0])
    flags = ["-q", "--device", "cpu"] + (["--scan"] if scan else [])
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert cli.main(["train", cfg, "-o", a] + flags) == 0
    with monkeypatch.context() as m:
        _crash_after(m, "_scan_window" if scan else "step_once",
                     2 if scan else 5)
        with pytest.raises(KeyboardInterrupt):
            cli.main(["train", cfg, "-o", b] + flags)
    rows = len(open(os.path.join(b, "metrics.jsonl")).readlines())
    assert rows == (3 if scan else 5)
    assert cli.main(["train", cfg, "-o", b, "--resume"] + flags) == 0

    with h5py.File(os.path.join(a, "result.h5")) as fa, \
            h5py.File(os.path.join(b, "result.h5")) as fb:
        assert set(fa) == set(fb)
        for k in fa:
            if k != "dt":
                np.testing.assert_array_equal(np.asarray(fb[k]),
                                              np.asarray(fa[k]), err_msg=k)
    la, lb = ([{k: v for k, v in json.loads(line).items() if k != "dt"}
               for line in open(os.path.join(d, "metrics.jsonl"))]
              for d in (a, b))
    assert len(la) == 6 and la == lb
    with h5py.File(os.path.join(a, "checkpoint.h5")) as fa, \
            h5py.File(os.path.join(b, "checkpoint.h5")) as fb:
        for group in ("params", "extra"):
            for k in fa[group]:
                np.testing.assert_array_equal(np.asarray(fb[group][k]),
                                              np.asarray(fa[group][k]))
        np.testing.assert_array_equal(np.asarray(fb["torch_rng"]),
                                      np.asarray(fa["torch_rng"]))


def test_train_py_config_backend_and_result_file(tmp_path, capsys):
    """A port ``.py`` config trains (``--backend plain``); ``infer`` reads
    a result.h5 when given no checkpoint; ``diagnose`` reads an npz."""
    p = tmp_path / "cfg.py"
    p.write_text(
        "from prosper_tpu_torch.engine.anneal import LinearAnnealing\n"
        "from prosper_tpu_torch.models import BSC\n"
        "from prosper_tpu_torch.data.bars import bars_gt_params\n"
        "model = BSC(D=16, H=8, Hprime=5, gamma=3)\n"
        "gt_params = bars_gt_params(model, intensity=10.0, sigma=1.0)\n"
        "N = 300\nseed = 3\n"
        "anneal = LinearAnnealing(15)\n"
        "anneal['T'] = [(0.0, 2.0), (0.7, 1.0)]\n"
        "anneal['W_noise'] = [(0.0, 1.0), (0.7, 0.0)]\n")
    out = str(tmp_path / "run")
    assert cli.main(["train", str(p), "-o", out, "-q", "--device", "cpu",
                     "--backend", "plain"]) == 0
    rows = [json.loads(line) for line in open(os.path.join(out,
                                                           "metrics.jsonl"))]
    assert len(rows) == 15 and rows[-1]["Q_mean"] > rows[0]["Q_mean"]
    gen, inf = str(tmp_path / "g.h5"), str(tmp_path / "i.h5")
    assert cli.main(["generate", str(p), "-N", "40", "-o", gen]) == 0
    assert cli.main(["infer", str(p), "-c", os.path.join(out, "result.h5"),
                     "--data", gen, "-o", inf, "--top", "3",
                     "--device", "cpu"]) == 0
    with h5py.File(inf) as f:
        assert f["top_states"].shape == (40, 3, 8)
    npz = str(tmp_path / "w.npz")
    with h5py.File(os.path.join(out, "checkpoint.h5")) as f:
        np.savez(npz, W=np.asarray(f["params"]["W"]))
    capsys.readouterr()
    assert cli.main(["diagnose", "-c", npz, "--gt", str(p)]) == 0
    assert "/8 atoms" in capsys.readouterr().out


def test_train_json_config_at_bfloat16(tmp_path):
    """A JSON config whose model table holds ``"compute_dtype":
    "bfloat16"`` trains through the port's ``train`` (the table goes to the
    constructor as keyword arguments, as the JAX CLI passes it): the
    checkpoint's parameters equal those of the in-process ``EM`` run of the
    same model within rtol 1e-4, and differ from the float32 run's."""
    model = {"type": "bsc", "D": 16, "H": 8, "Hprime": 5, "gamma": 3}
    cfgs = {"bf16": _config(tmp_path, "bf16.json",
                            model=dict(model, compute_dtype="bfloat16")),
            "f32": _config(tmp_path, "f32.json", model=model)}
    got = {}
    for tag, cfg in cfgs.items():
        out = tmp_path / tag
        assert cli.main(["train", cfg, "-o", str(out), "-q", "--device",
                         "cpu"]) == 0
        with h5py.File(out / "checkpoint.h5") as f:
            assert f.attrs["step"] == 6
            got[tag] = {k: np.asarray(f["params"][k]) for k in f["params"]}
    cfg = cli.load_config(cfgs["bf16"])
    m = cfg["model"]
    assert m.compute_dtype is torch.bfloat16
    data = m.generate_data(cfg["gt_params"], cfg["N"], seed=cfg["seed"])
    em = EM(m, cfg["anneal"], {"y": data["y"]}, seed=cfg["seed"],
            device="cpu")
    em.run()
    for k, v in em.params.items():
        np.testing.assert_allclose(got["bf16"][k], v.numpy(), rtol=1e-4,
                                   err_msg=k)
    assert not np.allclose(got["bf16"]["W"], got["f32"]["W"], rtol=1e-5,
                           atol=0.0)


def test_every_port_config_loads():
    """Every config of prosper_tpu_torch/examples/barstest builds a model
    and an annealer of the port, and the declarative examples/patches_bsc.toml
    builds a port BSC."""
    from prosper_tpu_torch.models import BSC
    configs = glob.glob(os.path.join(ROOT, "prosper_tpu_torch", "examples",
                                     "barstest", "param_*.py"))
    assert len(configs) == 6
    for path in configs:
        cfg = cli.load_config(path)
        assert hasattr(cfg["model"], "step_fn"), path
        assert not cfg["anneal"].finished and "gt_params" in cfg, path
        assert type(cfg["model"]).__module__.startswith("prosper_tpu_torch")
    cfg = cli.load_config(os.path.join(ROOT, "examples", "patches_bsc.toml"))
    assert isinstance(cfg["model"], BSC)
    assert (cfg["model"].D, cfg["model"].H, cfg["model"].chunk) == (256, 300,
                                                                    8192)
    assert cfg["anneal"].steps == 50


@pytest.mark.parametrize("flags,item", [(["--mesh", "data=2"], "distributed"),
                                        (["--multihost"], "distributed")])
def test_unported_switches_raise(tmp_path, flags, item):
    """The switches of ROADMAP item ``item``, ported since, outside
    ``torchrun``: ``--mesh data=2`` finds one rank and refuses before any
    file is opened; ``--multihost`` trains in one process, as ``train``
    does (tests/test_torch_multiprocess.py runs both on several ranks)."""
    cfg = _config(tmp_path)
    out = tmp_path / "run"
    argv = ["train", cfg, "-o", str(out), "--device", "cpu", "-q"]
    if flags[0] == "--mesh":
        with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
            cli.main(argv + flags)
        assert not out.exists()
        return
    assert cli.main(argv + flags) == 0
    ref = tmp_path / "ref"
    assert cli.main(["train", cfg, "-o", str(ref), "--device", "cpu",
                     "-q"]) == 0
    with h5py.File(out / "checkpoint.h5") as a, \
            h5py.File(ref / "checkpoint.h5") as b:
        for k in b["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])


def test_train_stream_then_resume(tmp_path):
    """``train --stream SEG`` trains through StreamingEM (the counterpart of
    tests/test_cli.py::test_cli_train_stream): logs and a checkpoint, Q
    improves; ``--resume`` of the finished run adds no log row; ``--stream``
    with ``--mesh`` or ``--multihost`` is refused before any log file is
    truncated."""
    cfg = _config(tmp_path, anneal={"steps": 15,
                                    "W_noise": [[0.0, 0.5], [0.6, 0.0]],
                                    "Ncut_factor": [[0.5, 0.0], [0.9, 1.0]]})
    out = str(tmp_path / "runs")
    flags = ["-q", "--device", "cpu", "--stream", "100"]
    assert cli.main(["train", cfg, "-o", out] + flags) == 0
    with h5py.File(os.path.join(out, "checkpoint.h5")) as f:
        assert f.attrs["step"] == 15 and "torch_rng" in f
        assert f["extra"]["F_prev"].shape == (300,)
    rows = [json.loads(line) for line in open(os.path.join(out,
                                                           "metrics.jsonl"))]
    assert len(rows) == 15
    assert rows[-1]["Q_mean"] > rows[0]["Q_mean"]
    assert min(r["n_used"] for r in rows) < 300       # the cut ran
    for extra in (["--mesh", "data=4"], ["--multihost"]):
        with pytest.raises(SystemExit, match="single-device"):
            cli.main(["train", cfg, "-o", out] + flags + extra)
        assert len(open(os.path.join(out, "metrics.jsonl")).readlines()) \
            == 15
    assert cli.main(["train", cfg, "-o", out, "--resume"] + flags) == 0
    assert len(open(os.path.join(out, "metrics.jsonl")).readlines()) == 15


def test_train_stream_resume_mid_run_equals_uninterrupted(tmp_path,
                                                          monkeypatch):
    """A streamed run killed after 5 iterations (checkpoint at 4) and
    resumed with ``--resume`` ends with the uninterrupted run's logs and
    checkpoint."""
    from prosper_tpu_torch.engine.stream import StreamingEM
    cfg = _config(tmp_path, anneal={"W_noise": [[0.0, 0.5], [0.6, 0.0]],
                                    "Ncut_factor": [[0.5, 0.0], [0.9, 1.0]]},
                  checkpoint_every=4)
    flags = ["-q", "--device", "cpu", "--stream", "128"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert cli.main(["train", cfg, "-o", a] + flags) == 0
    real, seen = StreamingEM.step_once, []

    def crash(self, *args, **kw):
        if len(seen) == 5:
            raise KeyboardInterrupt("killed")
        seen.append(1)
        return real(self, *args, **kw)
    with monkeypatch.context() as m:
        m.setattr(StreamingEM, "step_once", crash)
        with pytest.raises(KeyboardInterrupt):
            cli.main(["train", cfg, "-o", b] + flags)
    assert len(open(os.path.join(b, "metrics.jsonl")).readlines()) == 5
    assert cli.main(["train", cfg, "-o", b, "--resume"] + flags) == 0
    la, lb = ([{k: v for k, v in json.loads(line).items() if k != "dt"}
               for line in open(os.path.join(d, "metrics.jsonl"))]
              for d in (a, b))
    assert len(la) == 6 and la == lb
    with h5py.File(os.path.join(a, "checkpoint.h5")) as fa, \
            h5py.File(os.path.join(b, "checkpoint.h5")) as fb:
        for group in ("params", "extra"):
            for k in fa[group]:
                np.testing.assert_array_equal(np.asarray(fb[group][k]),
                                              np.asarray(fa[group][k]))
        np.testing.assert_array_equal(np.asarray(fb["torch_rng"]),
                                      np.asarray(fa["torch_rng"]))


def test_jax_configs_are_refused(tmp_path):
    with pytest.raises(ValueError, match="prosper_tpu_torch/examples/barstest"):
        cli.load_config(os.path.join(ROOT, "examples", "barstest",
                                     "param_bars_bsc.py"))
    p = tmp_path / "nomodel.py"
    p.write_text("N = 3\n")
    with pytest.raises(ValueError, match="builds no model"):
        cli.load_config(str(p))
    with pytest.raises(ValueError, match="unknown config format"):
        cli.load_config(str(tmp_path / "c.yaml"))


def test_module_entry_point(tmp_path):
    cfg = _config(tmp_path)
    dest = str(tmp_path / "g.h5")
    r = subprocess.run([sys.executable, "-m", "prosper_tpu_torch.cli",
                        "generate", cfg, "-N", "50", "-o", dest], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    with h5py.File(dest) as f:
        assert f["patches"].shape == (50, 16)
