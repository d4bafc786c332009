"""``EM.run_scanned`` of the port, the pieces it stands on (the pattern key,
the device-side schedule, the ``backend`` switch, the big-S row chunks, the
init on valid rows, ``_extra_init`` and ``mu_noise``), and the ``partial``
parity with the JAX package.

On the CPU ``run_scanned`` runs the device-side step (schedule row ``i`` of a
tensor, scalars into row ``i`` of a tensor) in a plain loop; it is the step a
CUDA graph replays on the card (``tests/test_torch_cuda.py``).  "Bit-identical"
below is ``torch.equal``: both sides run the same float32 arithmetic in the
same order.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.engine.anneal import LinearAnnealing as JAnneal
from prosper_tpu.engine.em import EM as JEM
from prosper_tpu.models import linear as jlinear
from prosper_tpu.models import mca as jmca
from prosper_tpu.models.base import make_blank_data as j_blank
from prosper_tpu.models.base import sched_floats as j_sched_floats
from prosper_tpu.models.base import sched_from_anneal
from prosper_tpu_torch import EM, LinearAnnealing
from prosper_tpu_torch.core import etstep
from prosper_tpu_torch.core.states import (binary_state_space,
                                           discrete_state_space)
from prosper_tpu_torch.data.bars import bars_gt_params
from prosper_tpu_torch.engine.em import schedule_window, uniform_runs
from prosper_tpu_torch.io.weights import params_from_numpy, params_to_numpy
from prosper_tpu_torch.models import BSC, DSC, GSC, MCA, MMCA, TSC
from prosper_tpu_torch.models.base import (SCHED_KEYS, ETModel, StepPattern,
                                           make_blank_data, sched_floats,
                                           sched_from_row, sched_row,
                                           step_pattern)
from prosper_tpu_torch.models.linear import LinearETModel
from prosper_tpu_torch.models.mixtures import MoG, MoP
from prosper_tpu_torch.ops import (bigs_cuda, cuda_lib, gsc_cuda, linear_cuda,
                                   max_cuda)

MODELS = {
    "bsc": lambda **kw: BSC(16, 10, 5, 3, chunk=128, **kw),
    "tsc": lambda **kw: TSC(16, 10, 5, 3, chunk=128, **kw),
    "mca": lambda **kw: MCA(16, 8, 5, 3, chunk=128, **kw),
    "tsc_bigs": lambda **kw: TSC(16, 10, 5, 3, chunk=128, s_block=16, **kw),
    "gsc": lambda **kw: GSC(16, 8, 5, 3, chunk=128, **kw),
    "mog": lambda **kw: MoG(16, 6, **kw),
    "mop": lambda **kw: MoP(16, 6, **kw),
}


def _crossing_anneal(steps=6):
    """Annealed -> saturated, noise on -> off, the data cut off -> on, and
    ``partial`` < 1 over the first three iterations: four patterns in six
    iterations, (0, 2), (2, 3), (3, 4) and (4, 6)."""
    a = LinearAnnealing(steps)
    a["T"] = [(0.0, 2.0), (0.8, 1.0)]
    a["W_noise"] = [(0.0, 0.5), (0.8, 0.0)]
    a["sigma_noise"] = [(0.0, 0.05), (0.4, 0.0)]
    a["Ncut_factor"] = [(0.4, 0.0), (1.0, 1.0)]
    a["partial"] = [(0.0, 0.7), (0.4, 0.7), (0.6, 1.0)]
    return a


def _data(model, N=150, seed=3):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((N, model.D)) * 2.0).astype(np.float32)
    if isinstance(model, MCA):
        y = np.abs(y)
    if isinstance(model, MoP):
        y = np.abs(np.floor(y))                       # counts
    return y


def _em(name, y, seed=7, **kw):
    return EM(MODELS[name](**kw), _crossing_anneal(), {"y": y}, seed=seed,
              device="cpu")


def _assert_same_run(a: EM, b: EM):
    """Parameters, F_prev, every scalar of every iteration and the
    generator's state, bit for bit."""
    assert set(a.params) == set(b.params)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert torch.equal(a.data["F_prev"], b.data["F_prev"])
    assert len(a.history) == len(b.history)
    for ha, hb in zip(a.history, b.history):
        assert set(ha) == set(hb)
        for k in ha:
            if k != "dt":
                assert ha[k] == hb[k], (ha["iteration"], k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.anneal.position == b.anneal.position


# -- (a) run_scanned against run ---------------------------------------------

@pytest.mark.parametrize("mode", ["scanned", "scanned_then_run",
                                  "run_then_scanned"])
@pytest.mark.parametrize("name", list(MODELS))
def test_run_scanned_is_bit_identical_to_run(name, mode):
    """150 rows above the chunk of 128 (padded to 256: two chunks, one of
    them part padding), six iterations over four patterns, the fewest that
    hold them all: ``run_scanned`` alone, ``run_scanned(3)`` then ``run``,
    and two ``step_once`` then ``run_scanned`` all give ``run``'s
    trajectory, each crossing patterns."""
    y = _data(MODELS[name]())
    ref, em = _em(name, y), _em(name, y)
    ref.run()
    if mode == "scanned":
        out = em.run_scanned()
    elif mode == "scanned_then_run":
        em.run_scanned(3)
        assert em.anneal.position == 3 and len(em.history) == 3
        out = em.run()
    else:
        for _ in range(2):
            em.step_once()
        em.run_scanned(2)
        out = em.run_scanned(100)                 # k = min(n_steps, remaining)
    assert out is em.params
    assert em.anneal.finished
    assert len(uniform_runs(schedule_window(_crossing_anneal(), 6))) == 4
    _assert_same_run(em, ref)


def test_run_scanned_contract():
    """k <= 0 returns at once; the history has k records with the keys of
    ``step_once``'s and one ``dt = total / k``; the annealer is read without
    being moved; ``collect_params`` without a data log changes nothing."""
    y = _data(MODELS["bsc"]())
    em = _em("bsc", y)
    before = em.params
    assert em.run_scanned(0) is before and em.history == []
    window = schedule_window(em.anneal, 6)
    assert em.anneal.position == 0 and len(window) == 6
    em.run_scanned(4)
    one = _em("bsc", y)
    one.step_once()
    assert [set(h) for h in em.history] == [set(one.history[0])] * 4
    assert len({h["dt"] for h in em.history}) == 1 and em.history[0]["dt"] > 0
    assert [h["iteration"] for h in em.history] == list(range(4))
    assert [h["T"] for h in em.history] == [
        float(_crossing_anneal().value_at("T", j)) for j in range(4)]
    em.run_scanned(1, collect_params=True)       # no data log: nothing read
    em.run_scanned()
    assert em.run_scanned() is em.params and len(em.history) == 6
    assert em.scan_stats["graphs"] == 0           # no graph on the CPU


def test_second_em_on_the_same_model_starts_clean():
    """The carry belongs to the EM, not to the model: a second EM on the
    same model object with other data and another seed follows its own
    ``run``."""
    model = MODELS["bsc"]()
    EM(model, _crossing_anneal(), {"y": _data(model, seed=3)}, seed=1,
       device="cpu").run_scanned()
    y2 = _data(model, N=200, seed=9)
    em = EM(model, _crossing_anneal(), {"y": y2}, seed=2, device="cpu")
    ref = EM(MODELS["bsc"](), _crossing_anneal(), {"y": y2}, seed=2,
             device="cpu")
    em.run_scanned()
    ref.run()
    _assert_same_run(em, ref)


# -- (b) the step fed its schedule as a row of 0-d tensors --------------------

@pytest.mark.parametrize("iteration", [0, 2, 3, 5])
@pytest.mark.parametrize("name", ["bsc", "mca", "tsc_bigs", "gsc", "mog",
                                  "mop"])
def test_step_from_a_device_schedule_row_equals_step_from_floats(name,
                                                                 iteration):
    """What a graph replays: ``step_fn`` on row i of a (k, n_channels)
    tensor with the pattern beside it, against ``step_fn`` on the host
    floats of iteration i (one iteration of each of the four patterns)."""
    model = MODELS[name]()
    y = _data(model, N=256)
    scheds = schedule_window(_crossing_anneal(), 6)
    table = torch.tensor([sched_row(s) for s in scheds])
    assert table.shape == (6, len(SCHED_KEYS)) and table.dtype == torch.float32
    params = model.standard_init({"y": y}, seed=1, device="cpu")
    data = dict(make_blank_data(y, device="cpu"), F_prev=torch.tensor(
        np.random.default_rng(0).standard_normal(256).astype(np.float32)))
    i = torch.tensor([iteration])
    row = sched_from_row(table.index_select(0, i)[0],
                         step_pattern(scheds[iteration]))
    assert all(row[k].dim() == 0 for k in SCHED_KEYS)
    out_f = model.step_fn(params, data, scheds[iteration],
                          torch.Generator().manual_seed(5))
    out_t = model.step_fn(params, data, row, torch.Generator().manual_seed(5))
    for k in out_f[0]:
        assert torch.equal(out_f[0][k], out_t[0][k]), k
    assert torch.equal(out_f[1], out_t[1])
    for k in out_f[2]:
        assert torch.equal(out_f[2][k], out_t[2][k]), k


# -- (c) the pattern key -------------------------------------------------------

def test_uniform_runs_equal_the_saturated_split_where_only_beta_moves():
    """With a temperature ramp alone the runs are the JAX package's
    saturated / annealed split (``prosper_tpu/engine/em.py``:
    run_scanned)."""
    a, ja = LinearAnnealing(12), JAnneal(12)
    a["T"] = ja["T"] = [(0.0, 2.0), (0.3, 1.0), (0.6, 1.0), (0.8, 1.5)]
    a["anneal_prior"] = ja["anneal_prior"] = True
    jscheds = []
    for j in range(12):
        ja.position = j
        jscheds.append(j_sched_floats(ja))
    sats = [s["beta"] == 1.0 and s["prior_beta"] == 1.0 for s in jscheds]
    want, start = [], 0
    for j in range(1, 13):
        if j == 12 or sats[j] != sats[start]:
            want.append((start, j, sats[start]))
            start = j
    got = uniform_runs(schedule_window(a, 12))
    assert [(lo, hi, p.saturated) for lo, hi, p in got] == want
    assert len(want) == 3
    assert all(p == StepPattern(p.saturated, *([False] * 7))
               for _, _, p in got)


def test_uniform_runs_split_on_the_whole_key():
    scheds = schedule_window(_crossing_anneal(), 6)
    runs = uniform_runs(scheds)
    assert [(lo, hi) for lo, hi, _ in runs] == [(0, 2), (2, 3), (3, 4),
                                                (4, 6)]
    p = [r[2] for r in runs]
    assert p[0] == StepPattern(False, True, False, True, False, True, False,
                               False)
    assert p[1]._replace(sigma_noise=True) == p[0]
    assert p[2] == p[1]._replace(partial=False, ncut=True)
    assert p[3] == StepPattern(True, False, False, False, False, False, True,
                               False)
    rho = dict(scheds[0], rho=4.0)
    assert step_pattern(rho).soft and not step_pattern(scheds[0]).soft
    assert step_pattern(scheds[5]).saturated
    assert not step_pattern(dict(scheds[5], prior_beta=0.5)).saturated
    for s in scheds:                      # a pure function of the floats
        assert step_pattern(s) == step_pattern(dict(s))


# -- (d) against the JAX package's run_scanned --------------------------------

def test_run_scanned_follows_the_jax_run_scanned():
    """Noise-free, ``partial`` = 1 bars run from the same parameters: five
    iterations through both ``run_scanned``; W within rtol 1e-3 (sums in
    another order, amplified over five M-steps), scalars within 1e-3."""
    tm, jm = BSC(25, 10, 6, 3), jlinear.BSC(25, 10, 6, 3)
    gt = bars_gt_params(tm, intensity=10.0, sigma=2.0)
    y = tm.generate_data(gt, 500, seed=11)["y"]
    p0 = {k: np.asarray(v) for k, v in
          jm.standard_init({"y": y}, seed=1).items()}

    def anneal(cls):
        a = cls(12)
        a["T"] = [(0.0, 2.0), (0.3, 1.0)]
        a["Ncut_factor"] = [(0.0, 0.0), (0.2, 0.0), (0.5, 1.0)]
        return a
    em_t = EM(tm, anneal(LinearAnnealing), {"y": y}, params=p0, seed=5,
              device="cpu")
    em_j = JEM(jm, anneal(JAnneal), {"y": y},
               params={k: jnp.asarray(v) for k, v in p0.items()}, seed=5)
    em_t.run_scanned(5)
    em_j.run_scanned(5)
    got = params_to_numpy(em_t.params)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(em_j.params[k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    assert len(em_t.history) == len(em_j.history) == 5
    for ht, hj in zip(em_t.history, em_j.history):
        assert ht["iteration"] == hj["iteration"]
        for k in ("F_mean", "Q_mean", "n_used", "N_total"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=1e-3, err_msg=k)
    assert len({h["dt"] for h in em_t.history}) == 1
    assert em_t.anneal.position == em_j.anneal.position == 5


# -- (f) the backend switch ---------------------------------------------------

@pytest.mark.parametrize("cls", [BSC, TSC, DSC, MCA, MMCA])
def test_backend_names(cls):
    for name, want in (("cuda", "cuda"), ("pallas", "cuda"),
                       ("plain", "plain"), ("xla", "plain")):
        assert cls(16, 8, 5, 3, backend=name).backend == want
    assert cls(16, 8, 5, 3).backend == "cuda"
    with pytest.raises(ValueError, match="backend"):
        cls(16, 8, 5, 3, backend="triton")


def test_backend_names_of_the_base_class():
    m = LinearETModel(16, 8, 5, 3, values=[1.0], backend="xla")
    assert m.backend == "plain"
    assert LinearETModel(16, 8, 5, 3, values=[1.0]).backend == "cuda"
    with pytest.raises(ValueError, match="backend"):
        LinearETModel(16, 8, 5, 3, values=[1.0], backend="")


@pytest.mark.parametrize("backend", ["cuda", "plain", "pallas", "xla"])
def test_bsc_trains_with_every_backend_name(backend):
    y = _data(MODELS["bsc"]())
    em, ref = _em("bsc", y, backend=backend), _em("bsc", y)
    em.run_scanned()
    ref.run()
    _assert_same_run(em, ref)             # one plain version on the CPU


@pytest.mark.parametrize("backend", ["cuda", "plain"])
def test_mca_past_the_kernel_limit_steps_like_jax(backend):
    """MCA with H' = 8, gamma = 4 has S = 154 multi states, more than the
    max kernel's 128: one step on the CPU against ``jit_step``, rtol 1e-4
    (sums in another order)."""
    D, H, Hp, gamma, N = 12, 10, 8, 4, 128
    tm = MCA(D, H, Hp, gamma, chunk=64, backend=backend)
    jm = jmca.MCA(D, H, Hp, gamma, chunk=64)
    assert tm.space.states.shape[0] == 154
    rng = np.random.default_rng(4)
    y = np.abs(rng.standard_normal((N, D)) * 2.0).astype(np.float32)
    p_np = {k: np.asarray(v) for k, v in
            jm.standard_init({"y": y}, seed=1).items()}
    a, ja = LinearAnnealing(10), JAnneal(10)
    a["T"] = ja["T"] = 1.5
    p_j, F_j, s_j = jm.jit_step(False)(
        {k: jnp.asarray(v) for k, v in p_np.items()}, j_blank(y),
        sched_from_anneal(ja), jax.random.PRNGKey(0))
    p_t, F_t, s_t = tm.step_fn(params_from_numpy(p_np, "cpu"),
                               make_blank_data(y, device="cpu"),
                               sched_floats(a), torch.Generator())
    for k in p_t:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=1e-4)
    for k in s_j:
        np.testing.assert_allclose(float(s_t[k]), float(s_j[k]), rtol=1e-4)


@pytest.mark.parametrize("family", ["linear", "bigs", "max", "gsc"])
def test_limit_messages_name_the_plain_backend(family, monkeypatch):
    """What a model past a kernel's limit is told on the card, for each
    family: the limit checks, and the kernel wrappers' refusals.  Both are
    plain Python, reached here on CPU tensors with the shared device check
    taken out: a wrapper refuses before it loads the library."""
    for mod in (linear_cuda, max_cuda, gsc_cuda):
        monkeypatch.setattr(mod, "check_input", lambda y: None)

    def refused(what, fn, *args):
        with pytest.raises(ValueError, match=what + r'.*backend="plain"'):
            fn(*args)
    y, w = torch.zeros(8, 4), torch.ones(8)
    if family == "linear":
        for bad in ((33, 1, 300), (8, 9, 300), (8, 1, 1025)):
            refused("H <= 1024", linear_cuda.check_limits, *bad)
        linear_cuda.check_limits(32, 8, 1024)
        refused("s_block > 0", linear_cuda._check_smem,
                cuda_lib.SMEM_LIMIT + 1, 99999)
        sa = etstep.state_arrays_from(discrete_state_space(5, 3, (1.0,)),
                                      "cpu")
        W, lo = torch.zeros(4, 1025), torch.zeros(1)
        refused("H <= 1024", linear_cuda.linear_et_estep_cuda, y, w, W, 1.0,
                lo, sa, 5, False, 1.0, 1.0)
        refused("H <= 1024", linear_cuda.linear_et_decode_cuda, y, W, 1.0,
                lo, sa, 5, False, 4, 1.0, 1.0)
    elif family == "bigs":
        refused("152", bigs_cuda.check_limits, 16, 2)  # 16 + 136 + 4 = 156
        bigs_cuda.check_limits(15, 2)                  # 15 + 120 + 4 = 139
    elif family == "max":
        refused("S <= 128", max_cuda.check_limits, 8, 154)
        refused("Hp <= 8", max_cuda.check_limits, 9, 100)
        max_cuda.check_limits(8, 128)
        sa = etstep.state_arrays_from(binary_state_space(8, 4), "cpu")
        refused("S <= 128", max_cuda.max_et_estep_cuda, y, w,
                torch.zeros(4, 16), 1.0, torch.tensor(-1.0), sa, 8, False,
                1.0, 1.0)
    else:
        for Hp, gamma in ((9, 3), (6, 5)):
            sa = etstep.state_arrays_from(binary_state_space(Hp, gamma),
                                          "cpu")
            refused("kernel limits", gsc_cuda.gsc_et_estep_cuda, y, w,
                    torch.zeros(4, 16), 1.0, 0.1, 0.0, 1.0, sa, Hp, 1.0,
                    1.0)


# -- (g) the big-S row chunks -------------------------------------------------

@pytest.mark.parametrize("collect_true", [True, False])
def test_bigs_estep_in_two_row_chunks_matches_one(monkeypatch, collect_true):
    """1536 rows cut at 1024 by a small workspace limit against all rows at
    once: F equal row by row, sums within rtol 1e-6 (two partial sums
    added, against one sum over all rows; an entry that cancels to near
    zero carries the rounding of its large terms, so the floor is 1e-6 of
    the sum's largest entry)."""
    N, D, H, Hp, gamma = 1536, 12, 10, 5, 3
    rng = np.random.default_rng(8)
    sa = etstep.state_arrays_from(
        discrete_state_space(Hp, gamma, (-1.0, 1.0)), "cpu")
    y = torch.tensor(rng.standard_normal((N, D)).astype(np.float32) * 2)
    w = torch.tensor((rng.random(N) < 0.8).astype(np.float32))
    W = torch.tensor(rng.standard_normal((D, H)).astype(np.float32))
    lo = torch.full((2,), float(np.log(0.05 / 0.9)))
    args = (y, w, W, torch.tensor(1.5), lo, sa, Hp, True, 0.7, 1.0, 16,
            collect_true)
    assert len(cuda_lib.row_chunks(N, Hp * H)) == 1
    F1, s1 = bigs_cuda.linear_et_estep_bigs(*args)
    Fd, sd = etstep._chunk_estats_bigs(
        y, w, W, W.T @ W, torch.diagonal(W.T @ W), *args[3:])
    assert torch.equal(F1, Fd)                    # one chunk: the direct call
    for k in sd:
        assert torch.equal(s1[k], sd[k]), k
    monkeypatch.setattr(cuda_lib, "P_LIMIT_BYTES", 4 * Hp * H * 1024)
    assert cuda_lib.row_chunks(N, Hp * H) == [(0, 1024), (1024, 1536)]
    F2, s2 = bigs_cuda.linear_et_estep_bigs(*args)
    assert torch.equal(F2, F1)
    assert set(s2) == set(s1)
    for k in s1:
        torch.testing.assert_close(
            s2[k], s1[k], rtol=1e-6,
            atol=1e-6 * s1[k].abs().max().item(), msg=k)


# -- (h) init on valid rows, _extra_init, mu_noise, rng -----------------------

def test_default_init_ignores_padding_rows():
    rng = np.random.default_rng(2)
    y = (rng.standard_normal((100, 16)) + 3.0).astype(np.float32)
    model = BSC(16, 8, 5, 3, chunk=64)
    em = EM(model, LinearAnnealing(2), {"y": y}, device="cpu")
    assert em.data["y"].shape == (128, 16)
    want = model.standard_init({"y": y}, device="cpu")
    padded = model.standard_init({"y": em.data["y"]}, device="cpu")
    for k in want:
        assert torch.equal(em.params[k], want[k]), k
    assert not torch.equal(want["W"], padded["W"])
    # rows the caller marked invalid take no part either
    valid = np.ones(100, np.float32)
    valid[60:] = 0.0
    y_bad = y.copy()
    y_bad[60:] = 1e3
    em = EM(model, LinearAnnealing(2), {"y": y_bad, "valid": valid},
            device="cpu")
    want = model.standard_init({"y": y[:60]}, device="cpu")
    for k in want:
        assert torch.equal(em.params[k], want[k]), k


class _WithMu(ETModel):
    param_names = ("W", "pi", "sigma", "mu")

    def _extra_init(self, y, rng):
        return {"mu": y.mean() + rng.standard_normal(self.H)}


def test_standard_init_calls_extra_init_in_the_reference_order():
    """W is drawn first, then the subclass's parameters from the same
    stream (``prosper_tpu/models/base.py::standard_init``)."""
    rng = np.random.default_rng(0)
    y = rng.standard_normal((50, 6)).astype(np.float32)
    model = _WithMu(6, 4, 3, 2)
    p = model.standard_init({"y": y}, seed=9, device="cpu")
    ref = np.random.default_rng(9)
    y64 = y.astype(np.float64)
    W = y64.mean(axis=0)[:, None] + (y64.std() / 2.0) * ref.standard_normal(
        (6, 4))
    mu = y64.mean() + ref.standard_normal(4)
    np.testing.assert_array_equal(p["W"].numpy(), W.astype(np.float32))
    np.testing.assert_array_equal(p["mu"].numpy(), mu.astype(np.float32))
    assert p["mu"].dtype == torch.float32
    assert set(BSC(6, 4, 3, 2).standard_init({"y": y}, device="cpu")) == {
        "W", "pi", "sigma"}
    assert ETModel(6, 4, 3, 2)._extra_init(y64, ref) == {}


def test_noisify_jitters_mu_only_where_the_model_has_one():
    model = _WithMu(6, 4, 3, 2)
    params = {"W": torch.zeros(6, 4), "pi": torch.tensor(0.2),
              "sigma": torch.tensor(1.0), "mu": torch.zeros(4)}
    a = LinearAnnealing(4)
    a["mu_noise"] = 0.5
    sched = sched_floats(a)
    assert step_pattern(sched).mu_noise
    out = model.noisify(params, sched, torch.Generator().manual_seed(1))
    want = 0.5 * torch.randn(4, generator=torch.Generator().manual_seed(1))
    assert torch.equal(out["mu"], want)           # the only channel drawn
    assert torch.equal(out["W"], params["W"])
    no_mu = {k: v for k, v in params.items() if k != "mu"}
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    assert "mu" not in model.noisify(no_mu, sched, g)
    assert torch.equal(g.get_state(), state)      # and nothing is drawn
    a["mu_noise"] = 0.0
    g = torch.Generator().manual_seed(1)
    out = model.noisify(params, sched_floats(a), g)
    assert torch.equal(out["mu"], params["mu"])
    assert torch.equal(g.get_state(), state)


@pytest.mark.parametrize("name", ["bsc", "mca"])
def test_generate_from_hidden_takes_an_unused_rng(name):
    model = MODELS[name]()
    rng = np.random.default_rng(0)
    W = np.abs(rng.standard_normal((model.D, model.H)))
    s = (rng.random((20, model.H)) < 0.3).astype(np.float64)
    params = {"W": W, "pi": np.float32(0.3), "sigma": np.float32(1.0)}
    state = rng.bit_generator.state
    a = model.generate_from_hidden(params, s, rng)
    assert rng.bit_generator.state == state
    np.testing.assert_array_equal(a, model.generate_from_hidden(params, s))


# -- (j) partial < 1 and the Ncut x partial keep count ------------------------

def _partial_inputs(partial, ncut):
    D, H, Hp, gamma, N = 16, 10, 5, 3, 256
    rng = np.random.default_rng(6)
    y = (rng.standard_normal((N, D)) * 2.0).astype(np.float32)
    F_prev = (rng.standard_normal(N) * 5 - 40).astype(np.float32)
    valid = np.ones(N, np.float32)
    valid[-16:] = 0.0
    a, ja = LinearAnnealing(10), JAnneal(10)
    for x in (a, ja):
        x["T"] = 1.5
        x["partial"] = partial
        x["Ncut_factor"] = ncut
    return D, H, Hp, gamma, y, F_prev, valid, a, ja


@pytest.mark.parametrize("ncut", [0.0, 0.6])
@pytest.mark.parametrize("family", ["bsc", "tsc"])
def test_one_step_with_partial_matches_jax_given_its_mask(family, ncut):
    """``partial`` = 0.6: the two random streams differ, so the port is
    handed the mask the JAX step draws (its ``partial_mask`` on the second
    half of the step's key); parameters, F and scalars within rtol 1e-4
    (sums in another order)."""
    D, H, Hp, gamma, y, F_prev, valid, a, ja = _partial_inputs(0.6, ncut)
    jcls, tcls = {"bsc": (jlinear.BSC, BSC), "tsc": (jlinear.TSC, TSC)}[family]
    jm, tm = jcls(D, H, Hp, gamma, chunk=64), tcls(D, H, Hp, gamma, chunk=64)
    p_np = {k: np.asarray(v) for k, v in
            jm.standard_init({"y": y}, seed=1).items()}
    jdata = {"y": jnp.asarray(y), "valid": jnp.asarray(valid),
             "F_prev": jnp.asarray(F_prev)}
    key = jax.random.PRNGKey(3)
    jsched = sched_from_anneal(ja)
    mask = np.asarray(jm.partial_mask(jdata, jsched,
                                      jax.random.split(key)[1], None))
    assert mask.sum() == np.ceil(np.float32(0.6) * 240) and mask[-16:].sum() == 0
    p_j, F_j, s_j = jm.jit_step(False)(
        {k: jnp.asarray(v) for k, v in p_np.items()}, jdata, jsched, key)
    tm.partial_mask = (lambda data, sched, generator, group=None:
                       torch.tensor(mask))
    tdata = {"y": torch.tensor(y), "valid": torch.tensor(valid),
             "F_prev": torch.tensor(F_prev)}
    p_t, F_t, s_t = tm.step_fn(params_from_numpy(p_np, "cpu"), tdata,
                               sched_floats(a), torch.Generator())
    for k in p_t:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=1e-4)
    for k in s_j:
        np.testing.assert_allclose(float(s_t[k]), float(s_j[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(s_t["n_used"]) <= mask.sum()
    if ncut > 0:
        assert float(s_t["n_used"]) < mask.sum()  # the cut bites the subset


@pytest.mark.parametrize("partial", [0.3, 0.6, 1.0])
def test_ncut_keep_count_applies_to_the_partial_subset(partial):
    """The cut keeps ceil(frac * sum(pmask)) rows of the subset under
    consideration, not of all valid rows: the same rows as the JAX
    package's ``ncut_weight``."""
    D, H, Hp, gamma, y, F_prev, valid, a, ja = _partial_inputs(partial, 0.8)
    jm, tm = jlinear.BSC(D, H, Hp, gamma), BSC(D, H, Hp, gamma)
    rng = np.random.default_rng(1)
    pmask = valid * (rng.random(valid.shape[0]) < partial)
    logA = np.float32(-1.2)
    w_j = np.asarray(jm.ncut_weight(jnp.asarray(pmask), jnp.asarray(F_prev),
                                    sched_from_anneal(ja), jnp.float32(logA),
                                    None))
    w_t = tm.ncut_weight(torch.tensor(pmask), torch.tensor(F_prev),
                         sched_floats(a), torch.tensor(logA)).numpy()
    np.testing.assert_array_equal(w_t, w_j)
    frac = 1.0 - (1.0 - np.exp(logA)) * 0.8
    assert abs(w_t.sum() - np.ceil(frac * pmask.sum())) <= 2   # 128^3 bins
    assert w_t.sum() < pmask.sum() and (w_t <= pmask).all()


def test_exact_count_mask_takes_a_device_fraction():
    """The ``partial`` fraction as a 0-d tensor picks the same rows as the
    host float."""
    from prosper_tpu_torch.core.select import exact_count_mask
    valid = torch.ones(200)
    valid[150:] = 0.0
    m_f = exact_count_mask(torch.Generator().manual_seed(2), 200, 0.37,
                           valid=valid)
    m_t = exact_count_mask(torch.Generator().manual_seed(2), 200,
                           torch.tensor(0.37), valid=valid)
    assert torch.equal(m_f, m_t) and m_f.sum() == np.ceil(
        np.float32(0.37) * 150)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        exact_count_mask(torch.Generator(), 10, torch.tensor(0.5),
                         device="cpu")
