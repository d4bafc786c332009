"""The port's GSC against its plain reference, ``torch_reference_gsc.py``
(float64 PyTorch written from the model's equations, importing nothing of
the port), and GSC's spans.

Every case is small (D = 16, H = 12, H' = 5, gamma = 3) on seeded random
weights and rows drawn from the spike-and-slab model.  The port computes in
float32 and the reference in float64, so the gaps are float32 rounding: at
this size 1e-8 - 1.3e-6 relative for F and for each parameter.  Every
tolerance below is 1e-5 (relative, on F per datapoint and on the norm of
each parameter or sum): 8 x the largest rounding seen, and 10^3 x below
what leaving Sigma_s out of <sz sz^T> (kappa kappa^T alone) moves, which
each case checks fails it.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch_reference_gsc as ref  # noqa: E402
from benchmark.reference import Prec, cut_weights  # noqa: E402
from prosper_tpu_torch import EM, LinearAnnealing  # noqa: E402
from prosper_tpu_torch.core.gscstep import gsc_et_estep  # noqa: E402
from prosper_tpu_torch.io import tracing  # noqa: E402
from prosper_tpu_torch.models import GSC  # noqa: E402
from prosper_tpu_torch.models.base import (device_sched,  # noqa: E402
                                           make_blank_data, sched_floats)

D, H, HP, GAMMA = 16, 12, 5, 3
CFG = {"D": D, "H": H, "Hprime": HP, "gamma": GAMMA}
#: float32 against float64 (see the module's docstring)
RTOL = 1e-5
F64 = Prec("float64")
SCHEDULE = {"T": [[0.0, 2.0], [1.0, 1.0]], "W_noise": [[0.0, 0.3], [0.5, 0.0]],
            "Ncut_factor": [[0.5, 0.0], [1.0, 1.0]]}


def _problem(seed, N=512):
    """Rows of the spike-and-slab model and a start near its dictionary."""
    g = torch.Generator().manual_seed(seed)
    W = torch.randn(D, H, generator=g)
    on = torch.rand(N, H, generator=g) < 0.2
    z = 1.0 + 0.5 * torch.randn(N, H, generator=g)
    y = (torch.where(on, z, 0.0) @ W.T
         + 0.8 * torch.randn(N, D, generator=g)).float()
    init = {"W": (W + 0.3 * torch.randn(D, H, generator=g)).float(),
            "pi": torch.tensor(0.15), "sigma": torch.tensor(1.1),
            "mu": torch.tensor(0.6), "psi": torch.tensor(0.5)}
    return y, init


def _rel(a, b):
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64)
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _f64(p):
    return {k: v.double() for k, v in p.items()}


def test_the_two_copies_are_the_same_bytes():
    assert ((ROOT / "tests" / "torch_reference_gsc.py").read_bytes()
            == (ROOT / "benchmark" / "reference_gsc.py").read_bytes())


def test_the_reference_imports_no_jax_and_nothing_of_the_port():
    """Its imports and theirs: torch and the benchmark's float64
    reference helpers alone, in a fresh interpreter."""
    for path in (ROOT / "tests" / "torch_reference_gsc.py",
                 ROOT / "benchmark" / "reference.py"):
        tops = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops.add(node.module.split(".")[0])
        assert tops <= {"__future__", "itertools", "math", "typing", "torch",
                        "benchmark"}, (path, tops)
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import torch_reference_gsc\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'jax', 'jaxlib', 'prosper_tpu',"
            " 'prosper_tpu_torch'}),"
            " torch_reference_gsc.torch.backends.cuda.matmul.allow_tf32,"
            " torch_reference_gsc.torch.backends.cudnn.allow_tf32)"
            % (str(ROOT / "tests"), str(ROOT)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(ROOT / "tests"))
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == ["[]", "False", "False"]


@pytest.mark.parametrize("beta", [0.5, 1.0], ids=["annealed", "saturated"])
def test_estep_matches_the_reference(beta):
    """F per row and every sum of ``gsc_et_estep`` (in chunks, some rows
    weighted 0) against the reference's E-step."""
    y, p = _problem(3)
    w = (torch.arange(y.shape[0]) % 7 > 0).float()
    model = GSC(D, H, HP, GAMMA, chunk=128)
    F, sums = gsc_et_estep(y, w, p["W"], p["sigma"] ** 2, p["pi"], p["mu"],
                           p["psi"], model.state_arrays("cpu"), HP, beta, 1.0,
                           chunk=128)
    for cov in (True, False):
        r = ref.gsc_estep([(y.double(), w.double())], p["W"].double(),
                          p["pi"].double(), p["sigma"].double(),
                          p["mu"].double(), p["psi"].double(), beta, 1.0, HP,
                          GAMMA, F64, slab_cov=cov)
        F_ref = torch.cat(r.pop("F_rows"))
        gaps = {k: _rel(sums[k], r[k]) for k in sums}
        gaps["F_rows"] = float(((F.double() - F_ref).abs()
                                / F_ref.abs()).max())
        if cov:
            assert max(gaps.values()) < RTOL, gaps
        else:
            assert gaps["ss"] > 100 * RTOL, gaps


@pytest.mark.parametrize("ncut", [False, True], ids=["no_cut", "cut"])
def test_one_step_fn_matches_the_reference(ncut):
    """One ``GSC.step_fn`` (T = 1.5, no noise): F, the free energy per
    datapoint and the five new parameters; with the cut on, both sides
    rank the rows by the same previous F."""
    y, p = _problem(5)
    model = GSC(D, H, HP, GAMMA, chunk=128)
    a = LinearAnnealing(2)
    a["T"] = 1.5
    a["Ncut_factor"] = 1.0 if ncut else 0.0
    F_prev = ref.gsc_estep([(y.double(), torch.ones(y.shape[0],
                                                    dtype=torch.float64))],
                           *_f64(p).values(), 1.0, 1.0, HP, GAMMA,
                           F64)["F_rows"]
    data = make_blank_data(y, device="cpu")
    data["F_prev"] = F_prev[0].float()
    new, F, scalars = model.step_fn(p, data, device_sched(sched_floats(a),
                                                          "cpu"),
                                    torch.Generator())
    beta = 1.0 / 1.5
    w = (cut_weights(F_prev, p["pi"].double(), H, GAMMA, 1.0)[0] if ncut
         else torch.ones(y.shape[0], dtype=torch.float64))
    assert float(scalars["n_used"]) == float(w.sum())
    assert (float(w.sum()) < y.shape[0]) is ncut
    for cov in (True, False):
        q = _f64(p)
        sums = ref.gsc_estep([(y.double(), w)], q["W"], q["pi"], q["sigma"],
                             q["mu"], q["psi"], float(torch.tensor(
                                 beta, dtype=torch.float32)), 1.0, HP, GAMMA,
                             F64, slab_cov=cov)
        F_ref = torch.cat(sums.pop("F_rows"))
        want = ref.gsc_mstep(sums, q["W"], q["pi"], H, GAMMA, F64)
        gaps = {k: _rel(new[k], want[k]) for k in ref.PARAMS}
        gaps["F_rows"] = float(((F.double() - F_ref).abs()
                                / F_ref.abs()).max())
        gaps["F_mean"] = abs(float(scalars["F_mean"])
                             - float(sums["F"] / sums["n"])) / abs(
                                 float(sums["F"] / sums["n"]))
        if cov:
            assert max(gaps.values()) < RTOL, gaps
        else:
            assert max(gaps.values()) > 100 * RTOL, gaps


def test_run_scanned_matches_the_reference_em_steps():
    """Three iterations through ``EM.run_scanned`` (T 2 -> 1, W noise 0.3
    -> 0, the full cut in the third) against the reference's ``em_steps``
    from the same start, the W noise drawn from the EM's seed."""
    y, p = _problem(7)
    a = LinearAnnealing(3)
    for k, v in SCHEDULE.items():
        a[k] = [tuple(x) for x in v]
    em = EM(GSC(D, H, HP, GAMMA, chunk=128), a, {"y": y}, params=p, seed=19,
            device="cpu")
    em.run_scanned()
    assert em.history[-1]["n_used"] < y.shape[0]
    for cov in (True, False):
        g = torch.Generator().manual_seed(19)
        steps = ref.em_steps(CFG, [y.double()], p, SCHEDULE, 3, 3,
                             lambda t: torch.randn((D, H), generator=g), F64,
                             slab_cov=cov)
        gaps = {k: _rel(em.params[k], steps[-1][k]) for k in ref.PARAMS}
        for h, r in zip(em.history, steps):
            for key in ("F_mean", "Q_mean"):
                gaps[key] = max(gaps.get(key, 0.0),
                                abs(h[key] - r[key]) / abs(r[key]))
        if cov:
            assert max(gaps.values()) < RTOL, gaps
        else:
            assert max(gaps.values()) > 100 * RTOL, gaps


@pytest.fixture
def spans_on():
    tracing.enable(True)
    try:
        yield
    finally:
        tracing.enable(False)


def test_gsc_spans_open_and_leave_the_bits(spans_on):
    """With the spans on, a GSC ``run_scanned`` on the CPU opens ``estep``,
    ``ncut`` and ``mstep`` each iteration (``ncut`` where the cut is on)
    and ``slab_solve`` and ``slab_moments`` each chunk of rows of each
    E-step; with them off it gives the same bits, and on the CPU no layer
    is timed."""
    from torch.profiler import ProfilerActivity, profile
    y, p = _problem(11, N=300)

    def run():
        a = LinearAnnealing(3)
        for k, v in SCHEDULE.items():
            a[k] = [tuple(x) for x in v]
        em = EM(GSC(D, H, HP, GAMMA, chunk=128), a, {"y": y}, params=p,
                seed=23, device="cpu")
        em.run_scanned()
        return em
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = run()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith(tracing.PREFIX)]
    count = {n[len(tracing.PREFIX):]: names.count(n) for n in set(names)}
    chunks = 3                     # 300 rows padded to 384, chunks of 128
    assert count["estep"] == count["mstep"] == 3
    assert count["ncut"] == 1
    assert count["slab_solve"] == count["slab_moments"] == 3 * chunks
    tracing.enable(False)
    off = run()
    for k in on.params:
        assert torch.equal(on.params[k], off.params[k]), k
    assert np.array_equal([h["F_mean"] for h in on.history],
                          [h["F_mean"] for h in off.history])
    assert on.scan_stats["layer_ms"] == off.scan_stats["layer_ms"] == {}
