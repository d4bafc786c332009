"""Streaming EM through the port (``prosper_tpu_torch/engine/stream.py``):
the port's versions of tests/test_streaming.py, on the CPU.

``StreamingEM`` follows the in-memory ``EM`` of the port: the same
generator chain (noise, then the masks), the same Ncut masks (the threshold
is the device function itself, over the lagged F kept on the device), the
sums of the segments added instead of one pass over all rows, so the
parameters agree within rtol 5e-4 / atol 1e-4 (the float32 sums in another
order) and the kept counts exactly; with segments of one chunk each the
sums are added in the in-memory order and the runs agree bit for bit.  The
cached and the rolling tier, and
an ``np.memmap`` against the ``np.ndarray``, are the same arithmetic on the
same rows: bit for bit.  One test holds the port's ``StreamingEM`` to the
JAX package's on the same numpy data and parameters.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from prosper_tpu.engine.anneal import LinearAnnealing as JLinearAnnealing
from prosper_tpu.engine.stream import StreamingEM as JStreamingEM
from prosper_tpu.models.linear import BSC as JBSC
from prosper_tpu_torch import EM, LinearAnnealing, StreamingEM
from prosper_tpu_torch.core.select import global_quantile_threshold
from prosper_tpu_torch.data.bars import (bars_gt_params, cosine_match,
                                         count_recovered_bars)
from prosper_tpu_torch.engine.stream import host_quantile_threshold
from prosper_tpu_torch.models import BSC, DSC, GSC, MCA, TSC
from prosper_tpu_torch.models.mixtures import MoG
from prosper_tpu_torch.utils.staging import SegmentUploader, rows_to_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _anneal(steps=6, ncut=True, noise=0.2, cls=LinearAnnealing):
    a = cls(steps)
    a["T"] = [(0.0, 1.5), (0.7, 1.0)]
    if noise:
        a["W_noise"] = [(0.0, noise), (0.5, 0.0)]
    if ncut:
        a["Ncut_factor"] = [(0.0, 0.0), (0.3, 0.0), (0.8, 1.0)]
    return a


def _run_pair(model, gt, N, seg_size, steps=6, seed=3, ncut=True):
    data = model.generate_data(gt, N, seed=seed)
    p0 = model.standard_init(data, seed=seed + 1, device="cpu")
    em = EM(model, _anneal(steps, ncut), {"y": data["y"]}, params=dict(p0),
            seed=11, device="cpu")
    p_mem = em.run()
    sem = StreamingEM(model, _anneal(steps, ncut), data["y"],
                      seg_size=seg_size, params=dict(p0), seed=11,
                      device="cpu")
    p_str = sem.run()
    return em, p_mem, sem, p_str


def _close(p_mem, p_str):
    for k in p_mem:
        torch.testing.assert_close(p_str[k], p_mem[k], rtol=5e-4, atol=1e-4,
                                   msg=k)


def _same(a, b):
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _bsc():
    model = BSC(16, 8, 5, 3, chunk=64)
    return model, bars_gt_params(model, intensity=10.0, sigma=1.0)


# -- the threshold ---------------------------------------------------------------

def _distribution(kind, seed):
    """(values, valid, keep) of one seeded case."""
    rng = np.random.default_rng(seed)
    N = int(rng.integers(200, 3000))
    valid = (rng.random(N) > 0.1).astype(np.float32)
    if kind == "gauss":
        v = rng.standard_normal(N) * 40 - 10
    elif kind == "heavy":
        v = rng.standard_cauchy(N) * 5
    elif kind == "equal":               # every value the same
        v = np.full(N, -123.25)
    elif kind == "ties":                # few distinct values: bin edges
        v = rng.integers(-4, 5, N) * 0.5
    elif kind == "edges":               # values on the first round's edges
        v = -300.0 + 2.0 * rng.integers(0, 128, N)
    else:                               # free energies of a wide spread
        v = -380.0 + 11.0 * rng.standard_normal(N)
    v = v.astype(np.float32)
    n_valid = int(valid.sum())
    keep = float(rng.choice([1, n_valid, max(1, n_valid // 2),
                             int(0.947 * n_valid) + 1]))
    return v, valid, keep


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["gauss", "heavy", "equal", "ties", "edges",
                                  "free_energy"])
def test_host_quantile_threshold_matches_the_device_function(kind, seed):
    """The host twin picks the device function's threshold and mask, on
    24 seeded distributions (ties, all-equal values, values on bin edges,
    keeps of 1, all, half and the ET fraction of the valid rows)."""
    v, valid, keep = _distribution(kind, seed)
    t_dev = global_quantile_threshold(torch.from_numpy(v),
                                      torch.from_numpy(valid),
                                      torch.tensor(keep, dtype=torch.float32))
    t_host = host_quantile_threshold(v, valid, keep)
    assert np.float32(t_host) == t_dev.item()
    np.testing.assert_array_equal(v >= np.float32(t_host),
                                  (torch.from_numpy(v) >= t_dev).numpy())


def test_host_quantile_threshold_allreduce_is_not_ported():
    """``allreduce`` is ported since this test was named: with the
    reduction of one rank (the identity) the threshold is unchanged; the
    reduction over ranks is in tests/test_torch_multiprocess.py."""
    seen = []

    def one_rank(x, op):
        seen.append(op)
        return x
    for kind, seed in (("ties", 0), ("gauss", 1), ("edges", 2)):
        v, valid, keep = _distribution(kind, seed)
        assert (host_quantile_threshold(v, valid, keep, allreduce=one_rank)
                == host_quantile_threshold(v, valid, keep))
    assert seen[:5] == ["min", "max", "sum", "sum", "sum"]


# -- streamed against in-memory ---------------------------------------------------

def test_streaming_matches_inmemory_bsc_with_ncut():
    model, gt = _bsc()
    em, p_mem, sem, p_str = _run_pair(model, gt, N=512, seg_size=128)
    assert sem.n_seg == 4
    _close(p_mem, p_str)
    np.testing.assert_allclose([h["F_mean"] for h in sem.history],
                               [h["F_mean"] for h in em.history], rtol=1e-4)
    # the same Ncut masks: the same kept counts every iteration
    n_mem = [h["n_used"] for h in em.history]
    assert n_mem == [h["n_used"] for h in sem.history]
    assert min(n_mem) < 512                  # the cut kept fewer rows


def test_streaming_segments_of_one_chunk_are_the_in_memory_run():
    """With segments of one chunk each (and N a multiple of them) the
    segments' sums are added in the order the in-memory E-step adds its
    chunks': the streamed run is the in-memory run bit for bit, W noise and
    the data cut included."""
    model = BSC(16, 8, 5, 3, chunk=128)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    em, p_mem, sem, p_str = _run_pair(model, gt, N=512, seg_size=128)
    _same(p_mem, p_str)
    assert torch.equal(em.data["F_prev"], sem.F_prev)
    assert [{k: v for k, v in h.items() if k != "dt"} for h in em.history] \
        == [{k: v for k, v in h.items() if k != "dt"} for h in sem.history]
    assert torch.equal(em.generator.get_state(), sem.generator.get_state())


def test_streaming_tail_padding():
    """N not a multiple of seg_size: the tail segment is padded with
    weight-0 rows and the run still follows the in-memory one."""
    model = BSC(16, 8, 5, 3, chunk=32)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    em, p_mem, sem, p_str = _run_pair(model, gt, N=416, seg_size=160,
                                      steps=4)
    assert (sem.n_seg, sem.seg_size) == (3, 160)
    assert sem.valid.shape == (480,) and sem.N_total.item() == 416.0
    _close(p_mem, p_str)
    assert [h["n_used"] for h in em.history] == \
        [h["n_used"] for h in sem.history]


@pytest.mark.parametrize("family", ["tsc", "mca", "gsc", "dsc_phi"])
def test_streaming_other_families(family):
    if family == "gsc":
        model = GSC(16, 8, 5, 3, chunk=64)
        rng = np.random.default_rng(6)
        gt = {"W": rng.standard_normal((16, 8)).astype(np.float32) * 2.0,
              "pi": np.float32(0.15), "sigma": np.float32(0.5),
              "mu": np.float32(1.0), "psi": np.float32(0.5)}
    elif family == "dsc_phi":
        # learned Phi: the phi_c / phi_M sums add over the segments too
        model = DSC(16, 8, 5, 3, phi=(-1.0, 1.0, 2.0),
                    to_learn=("W", "pi", "sigma", "phi"), chunk=64)
        gt = {"W": np.random.default_rng(51).standard_normal(
                  (16, 8)).astype(np.float32) * 2.0,
              "pi": np.full((3,), 0.05, np.float32),
              "sigma": np.float32(0.5)}
    else:
        model = (MCA if family == "mca" else TSC)(16, 8, 5, 3, chunk=64)
        gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    em, p_mem, sem, p_str = _run_pair(model, gt, N=256, seg_size=128,
                                      steps=4)
    assert set(p_str) == set(p_mem)
    _close(p_mem, p_str)


def test_streaming_first_iteration_ncut_keeps_all():
    """Iteration 0 with the cut on: F_prev is all zeros, so the threshold
    keeps every row (as the in-memory path does)."""
    model, gt = _bsc()
    data = model.generate_data(gt, 128, seed=5)
    a = LinearAnnealing(2)
    a["Ncut_factor"] = [(0.0, 1.0), (1.0, 1.0)]
    sem = StreamingEM(model, a, data["y"], seg_size=64,
                      params=model.standard_init(data, seed=6, device="cpu"),
                      seed=1, device="cpu")
    assert sem.step_once()["n_used"] == 128.0


def test_streaming_cache_tier_is_bit_identical_to_rolling():
    """The cached tier (every segment resident after the first pass) and the
    rolling tier (two buffers in turn) end bit for bit alike: parameters,
    every scalar, F_prev and the generator."""
    model, gt = _bsc()
    data = model.generate_data(gt, 384, seed=21)
    p0 = model.standard_init(data, seed=22, device="cpu")
    runs = []
    for cache_bytes in (8 << 30, 0):
        sem = StreamingEM(model, _anneal(5), data["y"], seg_size=128,
                          params=dict(p0), seed=9, device="cpu",
                          cache_bytes=cache_bytes)
        assert sem._cache_all == bool(cache_bytes)
        sem.step_once()
        # after one pass the cache holds every segment and uploads no more
        assert sem.uploader.stats["segments"] == 3
        sem.run()
        assert sem.uploader.stats["segments"] == (3 if cache_bytes else 15)
        runs.append(sem)
    c, r = runs
    _same(c.params, r.params)
    assert torch.equal(c.F_prev, r.F_prev)
    assert torch.equal(c.generator.get_state(), r.generator.get_state())
    assert [{k: v for k, v in h.items() if k != "dt"} for h in c.history] \
        == [{k: v for k, v in h.items() if k != "dt"} for h in r.history]


def test_streaming_memmap_equals_ndarray(tmp_path):
    model, gt = _bsc()
    data = model.generate_data(gt, 300, seed=23)
    p0 = model.standard_init(data, seed=24, device="cpu")
    path = str(tmp_path / "y.f32")
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=data["y"].shape)
    mm[:] = data["y"]
    mm.flush()
    ro = np.memmap(path, dtype=np.float32, mode="r", shape=data["y"].shape)
    ends = []
    for y in (data["y"], ro):
        sem = StreamingEM(model, _anneal(4), y, seg_size=128,
                          params=dict(p0), seed=9, device="cpu",
                          cache_bytes=0)
        ends.append(sem.run())
    _same(*ends)


@pytest.mark.parametrize("what", ["mixture", "ncut_current", "runtime"])
def test_streaming_rejects_what_it_cannot_stream(what):
    a = LinearAnnealing(2)
    y = np.zeros((64, 16), np.float32)
    if what == "mixture":
        with pytest.raises(TypeError, match="streaming protocol"):
            StreamingEM(MoG(D=16, K=4), a, y, seg_size=32, device="cpu")
    elif what == "ncut_current":
        with pytest.raises(ValueError, match="ncut_current"):
            StreamingEM(BSC(16, 8, 5, 3, chunk=32, ncut_current=True), a, y,
                        seg_size=32, device="cpu")
    else:
        # a runtime streams (tests/test_torch_multiprocess.py); it must be
        # a MeshRuntime
        with pytest.raises(TypeError, match="MeshRuntime"):
            StreamingEM(BSC(16, 8, 5, 3, chunk=32), a, y, seg_size=32,
                        device="cpu", runtime=object())


# -- checkpoints ---------------------------------------------------------------

def test_streaming_checkpoint_resume_replays_bit_for_bit(tmp_path):
    """A streamed run stopped past its step-4 checkpoint and resumed by a
    StreamingEM built with another seed ends where the uninterrupted run ends:
    parameters, F_prev, the generator and every scalar, bit for bit."""
    model, gt = _bsc()
    data = model.generate_data(gt, 256, seed=61)
    p0 = model.standard_init(data, seed=62, device="cpu")
    ck = str(tmp_path / "stream_ckpt.h5")
    full = StreamingEM(model, _anneal(8), data["y"], seg_size=128,
                       params=dict(p0), seed=13, device="cpu")
    full.run()
    a = StreamingEM(model, _anneal(8), data["y"], seg_size=128,
                    params=dict(p0), seed=13, device="cpu",
                    checkpoint_path=ck, checkpoint_every=4)
    for _ in range(5):                 # past the step-4 checkpoint
        a.step_once()
    b = StreamingEM(model, _anneal(8), data["y"], seg_size=128,
                    params=dict(p0), seed=999, device="cpu")
    assert b.resume(ck) == 4
    b.run()
    _same(full.params, b.params)
    assert torch.equal(full.F_prev, b.F_prev)
    assert torch.equal(full.generator.get_state(), b.generator.get_state())
    assert [{k: v for k, v in h.items() if k != "dt"}
            for h in full.history[4:]] == \
        [{k: v for k, v in h.items() if k != "dt"} for h in b.history]


def test_streaming_resume_raises_on_what_would_not_replay(tmp_path):
    """An F_prev of another length than N (the JAX package skips it
    silently) and a checkpoint without this device's generator state
    raise, and leave the StreamingEM as it was."""
    from prosper_tpu_torch.io import checkpoint
    model, gt = _bsc()
    data = model.generate_data(gt, 256, seed=61)
    p0 = model.standard_init(data, seed=62, device="cpu")
    sem = StreamingEM(model, _anneal(4), data["y"], seg_size=128,
                      params=dict(p0), seed=13, device="cpu")
    g = torch.Generator().manual_seed(1)
    short = str(tmp_path / "short.h5")
    checkpoint.save(short, p0, step=2, generator=g,
                    extra={"F_prev": np.zeros(255, np.float32)})
    with pytest.raises(ValueError, match="F_prev has shape"):
        sem.resume(short)
    norng = str(tmp_path / "norng.h5")
    checkpoint.save(norng, p0, step=2,
                    extra={"F_prev": np.zeros(256, np.float32)})
    with pytest.raises(ValueError, match="no cpu generator state"):
        sem.resume(norng)
    assert sem.anneal.position == 0
    _same(sem.params, {k: torch.as_tensor(v) for k, v in p0.items()})


# -- partial ---------------------------------------------------------------------

def test_streaming_partial_exact_counts():
    """With ``partial`` < 1 StreamingEM draws an exact-count mask
    per segment: 4 * ceil(0.6 * 256) = 616 rows, where the in-memory
    EM's one mask keeps ceil(0.6 * 1024) = 615."""
    model, gt = _bsc()
    data = model.generate_data(gt, 1024, seed=31)
    p0 = model.standard_init(data, seed=32, device="cpu")

    def anneal():
        a = LinearAnnealing(3)
        a["partial"] = 0.6
        return a
    em = EM(model, anneal(), {"y": data["y"]}, params=dict(p0), seed=41,
            device="cpu")
    em.run()
    sem = StreamingEM(model, anneal(), data["y"], seg_size=256,
                      params=dict(p0), seed=41, device="cpu")
    sem.run()
    assert all(h["n_used"] == 615.0 for h in em.history)
    assert all(h["n_used"] == 616.0 for h in sem.history)


def test_streaming_partial_ncut_deviation_bounded():
    """``partial`` < 1 with the cut on: the streamed threshold ranks all
    rows and the per-segment partial masks intersect it, the in-memory one
    ranks the subset.  From the generating optimum both keep every bar,
    sigma and pi within the bounds of tests/test_streaming.py:240, and the
    dictionaries within cosine 0.98 of each other."""
    model = BSC(25, 10, 6, 3, chunk=64)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0, pi=0.2)
    data = model.generate_data(gt, 2048, seed=33)
    p0 = {"W": np.asarray(gt["W"], np.float32),
          "pi": np.float32(gt["pi"]), "sigma": np.float32(gt["sigma"])}

    def anneal():
        a = LinearAnnealing(10)
        a["partial"] = 0.6
        a["Ncut_factor"] = [(0.0, 0.0), (0.2, 0.0), (0.6, 1.0)]
        return a
    em = EM(model, anneal(), {"y": data["y"]}, params=dict(p0), seed=41,
            device="cpu")
    p_mem = em.run()
    sem = StreamingEM(model, anneal(), data["y"], seg_size=512,
                      params=dict(p0), seed=41, device="cpu")
    p_str = sem.run()
    n_mem, n_str = em.history[-1]["n_used"], sem.history[-1]["n_used"]
    assert n_mem <= 2048 * 0.6 + 1
    assert n_str != n_mem
    for p in (p_mem, p_str):
        assert count_recovered_bars(p["W"].numpy(), gt["W"], 0.85) == 10
        assert 0.9 < float(p["sigma"]) < 1.25
    np.testing.assert_allclose(float(p_str["sigma"]), float(p_mem["sigma"]),
                               rtol=0.2)
    np.testing.assert_allclose(float(p_str["pi"]), float(p_mem["pi"]),
                               rtol=0.15)
    _, cos = cosine_match(p_str["W"].numpy(), p_mem["W"].numpy())
    assert cos.min() > 0.98, cos.min()


# -- the JAX package's StreamingEM -------------------------------------------------

def test_streaming_matches_jax_streaming():
    """The JAX package's StreamingEM and the port's, on the same numpy data
    and parameters with the W noise off (the two generators draw other
    numbers): within rtol 1e-4 after 4 iterations, the same kept counts."""
    jmodel = JBSC(16, 8, 5, 3, chunk=64)
    model, gt = _bsc()
    data = model.generate_data(gt, 512, seed=71)
    p0 = {k: np.asarray(v) for k, v in
          model.standard_init(data, seed=72, device="cpu").items()}
    js = JStreamingEM(jmodel, _anneal(4, noise=0, cls=JLinearAnnealing),
                      data["y"], seg_size=128, params=dict(p0), seed=5)
    pj = js.run()
    ts = StreamingEM(model, _anneal(4, noise=0), data["y"], seg_size=128,
                     params=dict(p0), seed=5, device="cpu")
    pt = ts.run()
    for k in pj:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert [h["n_used"] for h in ts.history] == \
        [h["n_used"] for h in js.history]


# -- the staging helpers -----------------------------------------------------------

def test_segment_uploader_pads_the_tail_with_zeros():
    y = np.arange(70 * 3, dtype=np.float32).reshape(70, 3)
    up = SegmentUploader(y, 32, "cpu")
    assert up.n_seg == 3 and up.bounds(2) == (64, 70)
    seen = []
    for k in range(up.n_seg):
        up.put(k)
        seen.append(up.get(k).clone())
        up.release(k)
    np.testing.assert_array_equal(torch.cat(seen)[:70].numpy(), y)
    assert not torch.cat(seen)[70:].any()
    assert up.stats["bytes"] == y.nbytes and up.stats["segments"] == 3


def test_rows_to_device_on_the_cpu():
    y = np.arange(12, dtype=np.float64).reshape(4, 3)
    t = rows_to_device(y, "cpu")
    assert t.dtype == torch.float32 and t.shape == (4, 3)
    np.testing.assert_array_equal(t.numpy(), y)
    same = torch.ones(2, 3, dtype=torch.float64)
    assert rows_to_device(same, "cpu").dtype == torch.float32


def test_stream_and_cli_import_no_jax():
    """In a fresh interpreter the streaming module and the command line
    import neither JAX nor the JAX package."""
    code = ("import sys\n"
            "import prosper_tpu_torch.engine.stream, prosper_tpu_torch.cli\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'prosper_tpu' or m.startswith('prosper_tpu.')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
