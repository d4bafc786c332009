"""The port's data modules against the JAX package's: the diagnosis
(``dictionary_stats``, ``diagnose_recovery``, ``split_blend_sweep``,
``format_report``) on synthetic dictionaries and on the converged seed-2
patches dictionary ``tools/patches_seed2_diag.npz``; the patch pipeline;
and the port's tracing (tracepoints, profiler annotation, Chrome trace)."""

import json
import os

import numpy as np
import pytest
import torch

from prosper_tpu.data import diagnosis as jdiag
from prosper_tpu.data import patches as jpatches
from prosper_tpu_torch.data import diagnosis, patches
from prosper_tpu_torch.io import tracing

NPZ = os.path.join(os.path.dirname(__file__), "..", "tools",
                   "patches_seed2_diag.npz")


def _planted(D=100, H=12, k=5, seed=0, intensity=10.0):
    rng = np.random.default_rng(seed)
    W = np.zeros((D, H), np.float64)
    for h in range(H):
        W[rng.choice(D, size=k, replace=False), h] = intensity
    return W


def _assert_same(a, b, path="report"):
    """Equal nested reports: dicts, lists, tuples, arrays and numbers."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


def _blended():
    """tests/test_diagnosis.py's dictionary with a blend, a duplicate and a
    dead column, and a clean noisy one."""
    gt = _planted(seed=1)
    Wl = gt.copy()
    Wl[:, 0] = gt[:, 0] + gt[:, 1]
    Wl[:, 1] = gt[:, 2] + 0.01
    Wl[:, 3] = 1e-4
    clean = _planted(seed=2)
    noisy = clean + 0.05 * np.random.default_rng(3).standard_normal(
        clean.shape)
    return [(Wl, gt), (noisy, clean)]


@pytest.mark.parametrize("case", [0, 1], ids=["blend_dup_dead", "clean"])
@pytest.mark.parametrize("signed", [False, True])
def test_diagnosis_equals_jax(case, signed):
    W, gt = _blended()[case]
    _assert_same(diagnosis.dictionary_stats(W), jdiag.dictionary_stats(W))
    rep = diagnosis.diagnose_recovery(W, gt, signed=signed)
    ref = jdiag.diagnose_recovery(W, gt, signed=signed)
    _assert_same(rep, ref)
    assert diagnosis.format_report(rep) == jdiag.format_report(ref)


def _sweep_data(seed, gt, N=20000):
    rng = np.random.default_rng(seed)
    s = rng.random((N, gt.shape[1])) < 0.12
    return s @ gt.T + 0.4 * rng.standard_normal((N, gt.shape[0]))


@pytest.mark.parametrize("relaxed", [False, True])
def test_split_blend_sweep_equals_jax(relaxed):
    """tests/test_diagnosis.py's sweeps: a blend with a junk donor, and one
    served only by the relaxed-duplicate donor pool."""
    gt = _planted(D=144, H=16, seed=4)
    Wl = gt.copy()
    Wl[:, 5] = gt[:, 5] + gt[:, 6]
    if relaxed:
        Wl[:, 6] = gt[:, 7] + 0.8 * gt[:, 8]
    else:
        Wl[:, 6] = np.abs(np.random.default_rng(0).standard_normal(144)) * 2
    Y = _sweep_data(7 if relaxed else 0, gt)
    out = diagnosis.split_blend_sweep(Wl, Y)
    _assert_same(out, jdiag.split_blend_sweep(Wl, Y))
    assert (5, 6) in out["splits"]


@pytest.fixture(scope="module")
def seed2():
    d = np.load(NPZ)
    rng = np.random.default_rng(3)
    s = rng.random((65536, 300)) < 2.0 / 300
    Y = s @ d["gtW"].T.astype(np.float64) + rng.standard_normal((65536, 256))
    return d, Y


def test_real_seed2_dictionary_diagnosis_and_sweep(seed2):
    """The converged seed-2 patches dictionary: 289 recovered, every miss a
    blend, as the JAX package reads it; the sweep equals JAX's and lifts
    recovery to >= 296 before any polish."""
    d, Y = seed2
    rep = diagnosis.diagnose_recovery(d["W"], d["gtW"])
    _assert_same(rep, jdiag.diagnose_recovery(d["W"], d["gtW"]))
    assert rep["recovered"].size == 289
    assert set(rep["missed_classes"].values()) == {"blend"}
    out = diagnosis.split_blend_sweep(d["W"], Y)
    _assert_same(out, jdiag.split_blend_sweep(d["W"], Y))
    assert diagnosis.diagnose_recovery(out["W"], d["gtW"])[
        "recovered"].size >= 296


def test_patch_pipeline_equals_jax(tmp_path):
    y = np.arange(100 * 4, dtype=np.float32).reshape(100, 4)
    p = str(tmp_path / "d.h5")
    patches.write_h5_dataset(p, y)
    jp = str(tmp_path / "j.h5")
    jpatches.write_h5_dataset(jp, y)
    for path in (p, jp):
        parts = [patches.load_h5_shard(path, parts=3, index=i)
                 for i in range(3)]
        for i, part in enumerate(parts):
            np.testing.assert_array_equal(
                part, jpatches.load_h5_shard(path, parts=3, index=i))
        np.testing.assert_array_equal(np.concatenate(parts), y)
    np.testing.assert_array_equal(patches.load_h5_shard(p), y)
    for N, parts_ in ((100, 3), (7, 4), (5, 8)):
        for i in range(parts_):
            assert (patches.stride_data(N, parts_, i)
                    == jpatches.stride_data(N, parts_, i))

    _assert_same(patches.pad_for_mesh(y, n_shards=8, chunk=16),
                 jpatches.pad_for_mesh(y, n_shards=8, chunk=16))
    _assert_same(patches.pad_for_mesh(y[:64], n_shards=1, chunk=64),
                 jpatches.pad_for_mesh(y[:64], n_shards=1, chunk=64))
    imgs = np.random.default_rng(0).random((3, 32, 32))
    for kw in (dict(), dict(remove_dc=False, normalize=True)):
        np.testing.assert_array_equal(
            patches.extract_patches(imgs, 8, 50, seed=1, **kw),
            jpatches.extract_patches(imgs, 8, 50, seed=1, **kw))
    A = np.random.default_rng(2).standard_normal((4, 4))
    yc = np.random.default_rng(2).standard_normal((5000, 4)) @ A.T
    _assert_same(patches.whiten(yc), jpatches.whiten(yc))
    np.testing.assert_array_equal(
        patches.synthetic_patches(200, patch_size=16, seed=3),
        jpatches.synthetic_patches(200, patch_size=16, seed=3))


def test_tracing(tmp_path):
    """Tracepoints land in the trace file (%d -> process index); a traced
    region shows as a profiler event; ``profile_trace`` writes a Chrome
    trace."""
    path = str(tmp_path / "trace.%d.txt")
    tracing.set_tracefile(path)
    try:
        tracing.tracepoint("start")
        with tracing.profile_trace(str(tmp_path / "prof")) as prof:
            with tracing.traced_region("em step"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    finally:
        tracing.set_tracefile(None)
    lines = open(tmp_path / "trace.0.txt").read().splitlines()
    assert [line.split(None, 2)[1:] for line in lines] == [
        ["p0", "start"], ["p0", "em step begin"], ["p0", "em step end"]]
    assert any(e.name == "em step" for e in prof.events())
    trace = json.load(open(tmp_path / "prof" / "trace.0.json"))
    assert any(e.get("name") == "em step" for e in trace["traceEvents"])
    tracing.tracepoint("off")            # disabled: no file, no error
