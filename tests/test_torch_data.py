"""The port's data modules against the JAX package's: the diagnosis
(``dictionary_stats``, ``diagnose_recovery``, ``split_blend_sweep``,
``format_report``) on synthetic dictionaries and on the converged seed-2
patches dictionary ``tools/patches_seed2_diag.npz``; the patch pipeline;
and the port's tracing (the switch, spans in a profile and a Chrome trace,
the timing events of ``timed_regions``, the spans of a training run and a
decode)."""

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


class _CountedEvent:
    """Stands in for ``torch.cuda.Event``: counts its constructions and
    records."""
    made = 0

    def __init__(self, **kw):
        type(self).made += 1
        self.kw, self.records = kw, 0

    def record(self):
        self.records += 1


@pytest.fixture
def counted_events(monkeypatch):
    _CountedEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", _CountedEvent)
    return _CountedEvent


@pytest.fixture
def spans_on():
    tracing.enable(True)
    try:
        yield
    finally:
        tracing.enable(False)


def _spans(prof):
    """(name, start ns, end ns) of the ``prosper::`` events of a profile."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(tracing.PREFIX)]


def test_tracing(tmp_path, counted_events):
    """Off (the default) a region is one shared no-op context: no profiler
    event, no timing event, nothing appended.  On, nested regions are
    nested ``prosper::`` events of the profile and of ``profile_trace``'s
    Chrome trace, and inside ``timed_regions`` each region records a pair
    of timing events, innermost first."""
    from torch.profiler import ProfilerActivity, profile
    assert not tracing.enabled()
    assert tracing.traced_region("a") is tracing.traced_region("b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.timed_regions() as pairs:
            with tracing.traced_region("outer"):
                with tracing.traced_region("inner"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    assert _spans(prof) == [] and pairs == []
    assert counted_events.made == 0

    tracing.enable(True)
    try:
        assert tracing.enabled()
        with tracing.profile_trace(str(tmp_path / "prof")) as prof:
            with tracing.traced_region("outer"):
                with tracing.traced_region("inner"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
        assert counted_events.made == 0
        with tracing.timed_regions() as pairs:
            with tracing.traced_region("outer"):
                with tracing.traced_region("inner"):
                    pass
        with tracing.traced_region("after"):
            pass
    finally:
        tracing.enable(False)
    spans = {name: (s, e) for name, s, e in _spans(prof)}
    assert set(spans) == {"prosper::outer", "prosper::inner"}
    (os_, oe), (is_, ie) = spans["prosper::outer"], spans["prosper::inner"]
    assert os_ <= is_ <= ie <= oe
    trace = json.load(open(tmp_path / "prof" / "trace.0.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"prosper::outer", "prosper::inner"} <= names
    assert [p[0] for p in pairs] == ["inner", "outer"]
    assert counted_events.made == 4
    for _, start, end in pairs:
        assert start.kw == end.kw == {"enable_timing": True,
                                      "external": True}
        assert start.records == end.records == 1


@pytest.mark.parametrize("name", ["bsc", "mca"])
def test_spans_of_a_training_run_and_a_decode(name, spans_on,
                                              counted_events):
    """With the spans on, a training run on the CPU shows its driver and
    step spans and a decode its call and the three pieces inside it; the
    run is bit-identical to one with the spans off, and on the CPU no
    timing event is made and no layer is timed."""
    from torch.profiler import ProfilerActivity, profile

    from prosper_tpu_torch import EM, LinearAnnealing
    from prosper_tpu_torch.models import BSC, MCA

    def run():
        a = LinearAnnealing(6)
        a["T"] = [(0.0, 2.0), (0.5, 1.0)]
        a["Ncut_factor"] = [(0.4, 0.0), (1.0, 1.0)]
        model = (BSC if name == "bsc" else MCA)(16, 8, 5, 3, chunk=64)
        y = np.abs(np.random.default_rng(3).standard_normal((150, 16))
                   ).astype(np.float32)
        em = EM(model, a, {"y": y}, seed=7, device="cpu")
        em.run_scanned(4)
        em.run_scanned()
        return em
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        em = run()
    names = [n for n, _, _ in _spans(prof)]
    assert names.count("prosper::em.build") == 1
    assert names.count("prosper::em.window_end") == 2
    assert names.count("prosper::estep") == names.count("prosper::mstep") == 6
    assert names.count("prosper::ncut") >= 1
    tracing.enable(False)
    off = run()
    for k in em.params:
        assert torch.equal(em.params[k], off.params[k]), k
    assert em.scan_stats == off.scan_stats
    assert em.scan_stats["layer_ms"] == {}
    assert em.scan_stats["timed_iterations"] == 0
    assert counted_events.made == 0
    if name != "bsc":
        return
    tracing.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        em.model.inference(em.params, {"y": np.ones((40, 16), np.float32)},
                           top_L=3)
    spans = _spans(prof)
    assert sorted(n for n, _, _ in spans) == [
        "prosper::decode", "prosper::inference", "prosper::recon_rows",
        "prosper::top_states"]
    _, root_s, root_e = next(s for s in spans if s[0] == "prosper::inference")
    assert all(root_s <= s <= e <= root_e for _, s, e in spans)
