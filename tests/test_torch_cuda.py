"""The CUDA kernels of the port (the two GEMMs, the linear E-step and
decode, the max family's E-step, the big-S recurrence) against their plain
versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present.  On a machine
with a card:  python -m pytest --noconftest -q tests/test_torch_cuda.py
(``--noconftest`` because the suite's conftest configures JAX, which such a
machine need not have).  The inputs are quantised to multiples of 1/4, so
P = y W and the Gram matrix are exact in float32 whatever the order of
summation, and the candidates and top-L identities must match exactly.
"""

import numpy as np
import pytest
import torch

from prosper_tpu_torch.core import etstep, maxstep
from prosper_tpu_torch.core.states import (binary_state_space,
                                           discrete_state_space)
from prosper_tpu_torch.ops import (bigs_cuda, cuda_lib, gemm_cuda, linear_cuda,
                                   max_cuda)

pytestmark = pytest.mark.cuda

CASES = [  # (N, D, H, Hp, gamma, values, signed)
    (1000, 25, 10, 6, 3, (1.0,), False),
    (1000, 25, 10, 6, 3, (-1.0, 1.0), True),
    (999, 25, 16, 6, 3, (-1.0, 1.0, 2.0), True),
    (4096, 256, 300, 8, 4, (1.0,), False),
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, device, seed=0):
    N, D, H, Hp, gamma, values, signed = case
    rng = np.random.default_rng(seed)
    y = np.round(rng.standard_normal((N, D)) * 6) / 4
    W = np.round(rng.standard_normal((D, H)) * 4) / 4
    w = (rng.random(N) > 0.2).astype(np.float32)
    w[:40] = 0.0                                   # whole tiles of weight 0
    K = len(values)
    lo = np.full(K, np.log(0.4 / (H * K)) - np.log1p(-0.4 / H), np.float32)
    sa = etstep.state_arrays_from(discrete_state_space(Hp, gamma, values),
                                  device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return t(y), t(w), t(W), t(lo), sa, Hp, signed


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"H{c[2]}K{len(c[5])}")
@pytest.mark.parametrize("beta", [0.6, 1.0])
def test_estep_kernel_matches_plain(case, beta, device):
    y, w, W, lo, sa, Hp, signed = _inputs(case, device)
    sigma2 = torch.tensor(2.5, device=device)
    args = (y, w, W, sigma2, lo, sa, Hp, signed, beta, 1.0)
    F0, ref = etstep.linear_et_estep(*args, chunk=y.shape[0])
    F1, on = linear_cuda.linear_et_estep_cuda(*args, collect_true=True)
    _, off = linear_cuda.linear_et_estep_cuda(*args, collect_true=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(F1, F0, rtol=1e-4, atol=1e-4)
    for k in ref:
        torch.testing.assert_close(on[k], ref[k], rtol=1e-3, atol=1e-3,
                                   msg=k)
        if k != "F_true":
            assert torch.equal(on[k], off[k]), k


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"H{c[2]}K{len(c[5])}")
@pytest.mark.parametrize("beta", [0.6, 1.0])
def test_decode_kernel_matches_plain(case, beta, device):
    y, _, W, lo, sa, Hp, signed = _inputs(case, device, seed=1)
    sigma2 = torch.tensor(2.5, device=device)
    args = (y, W, sigma2, lo, sa, Hp, signed, 10, beta, 0.8)
    ref = etstep.linear_et_decode(*args)
    out = linear_cuda.linear_et_decode_cuda(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("F", "s_mean", "top_q"), out[:3], ref[:3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=name)
    assert torch.equal(out[3], ref[3]), "top_u"
    assert torch.equal(out[4], ref[4]), "cand"


def test_wrapper_rejects_cpu_tensors_and_bad_shapes(device):
    y, w, W, lo, sa, Hp, signed = _inputs(CASES[0], device)
    with pytest.raises(ValueError):
        linear_cuda.linear_et_estep_cuda(y.cpu(), w, W, 1.0, lo, sa, Hp,
                                         signed, 1.0, 1.0)
    with pytest.raises(ValueError):
        linear_cuda.linear_et_estep_cuda(y, w[:-1], W, 1.0, lo, sa, Hp,
                                         signed, 1.0, 1.0)
    with pytest.raises(ValueError):
        linear_cuda.linear_et_decode_cuda(y, W, 1.0, lo, sa, Hp, signed,
                                          10_000, 1.0, 1.0)


def test_estep_wrapper_repeats_bit_identical_and_chunks_rows(device,
                                                             monkeypatch):
    """Two calls give the same bits (no atomics anywhere); a workspace limit
    that cuts N into chunks of rows changes only the order of the sums."""
    y, w, W, lo, sa, Hp, signed = _inputs(CASES[3], device)
    args = (y, w, W, torch.tensor(2.5, device=device), lo, sa, Hp, signed,
            1.0, 1.0)
    F1, one = linear_cuda.linear_et_estep_cuda(*args)
    F2, two = linear_cuda.linear_et_estep_cuda(*args)
    monkeypatch.setattr(cuda_lib, "P_LIMIT_BYTES", 1024 * 4 * W.shape[1])
    F3, cut = linear_cuda.linear_et_estep_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(F1, F2) and torch.equal(F1, F3)
    for k in one:
        assert torch.equal(one[k], two[k]), k
        torch.testing.assert_close(cut[k], one[k], rtol=1e-4, atol=1e-4,
                                   msg=k)


# ---- the two GEMM kernels ---------------------------------------------------

GEMM_SHAPES = [(131072, 256, 300)] + [(N, D, H) for N in (1000, 16385)
                                      for D in (25, 256) for H in (10, 300)]


@pytest.mark.parametrize("shape", GEMM_SHAPES,
                         ids=lambda s: "N%dD%dH%d" % s)
@pytest.mark.parametrize("quantised", [True, False], ids=["quarters", "randn"])
def test_gemm_kernels_match_float64(shape, quantised, device):
    """Both kernels against float64 matmul, N a multiple of no tile, rows of
    zeros among the operands: exact on inputs quantised to 1/4 (every
    partial sum is exact in float32), within 2e-7 per term of the chain
    otherwise; two calls give the same bits."""
    N, D, H = shape
    rng = np.random.default_rng(N + D + H)

    def draw(*sh):
        a = rng.standard_normal(sh)
        a = np.round(a * 4) / 4 if quantised else a
        return torch.as_tensor(a.astype(np.float32), device=device)
    y, W, sw, base = draw(N, D), draw(D, H), draw(N, H), draw(D, H)
    y[:40] = 0.0
    sw[-3:] = 0.0
    for out, again, ref, depth in (
            (gemm_cuda.sgemm_nn_cuda(y, W), gemm_cuda.sgemm_nn_cuda(y, W),
             y.double() @ W.double(), D),
            (gemm_cuda.sgemm_tn_splitn_cuda(y, sw),
             gemm_cuda.sgemm_tn_splitn_cuda(y, sw),
             y.double().T @ sw.double(), N),
            (gemm_cuda.sgemm_tn_splitn_cuda(y, sw, out=base.clone(),
                                            accumulate=True),
             gemm_cuda.sgemm_tn_splitn_cuda(y, sw, out=base.clone(),
                                            accumulate=True),
             base.double() + y.double().T @ sw.double(), N)):
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        if quantised:
            assert torch.equal(out.double(), ref)
        else:
            torch.testing.assert_close(out.double(), ref, rtol=1e-5,
                                       atol=2e-7 * depth)


def test_gemm_wrappers_reject_bad_outputs_and_dispatch(device):
    a = torch.zeros(64, 8, device=device)
    b = torch.zeros(8, 12, device=device)
    with pytest.raises(ValueError):                  # out of the wrong shape
        gemm_cuda.sgemm_tn_splitn_cuda(a, a, out=torch.zeros(8, 12,
                                                             device=device))
    with pytest.raises(ValueError):                  # accumulate into nothing
        gemm_cuda.sgemm_tn_splitn_cuda(a, a, accumulate=True)
    with pytest.raises(ValueError):                  # operands on two devices
        gemm_cuda.sgemm_nn_cuda(a, b.cpu())
    before = dict(gemm_cuda.LAUNCHES)
    assert gemm_cuda.sgemm_nn(a, b).is_cuda
    assert gemm_cuda.sgemm_tn_splitn(a, a).is_cuda
    assert gemm_cuda.LAUNCHES["sgemm_nn"] == before["sgemm_nn"] + 1
    assert gemm_cuda.LAUNCHES["sgemm_tn"] == before["sgemm_tn"] + 1


# ---- the max-family E-step kernel (MCA / MMCA) ------------------------------

MAX_CASES = [  # (N, D, H, Hp, gamma): bars, mca_small, patches
    (1000, 16, 8, 6, 3),
    (4096, 64, 100, 6, 3),
    (16384, 256, 300, 6, 3),
]


def _max_inputs(case, magnitude, device, seed=0):
    N, D, H, Hp, gamma = case
    rng = np.random.default_rng(seed)
    W = np.round(rng.standard_normal((D, H)) * 8) / 4
    if not magnitude:
        W = np.abs(W)                     # MCA: a non-negative dictionary
    y = np.round(rng.standard_normal((N, D)) * 8) / 4
    w = (rng.random(N) > 0.2).astype(np.float32)
    w[:40] = 0.0                                   # whole tiles of weight 0
    sa = etstep.state_arrays_from(binary_state_space(Hp, gamma), device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    lo = t(np.log(2.0 / H) - np.log1p(-2.0 / H))
    return t(y), t(w), t(W), lo, sa, Hp


@pytest.mark.parametrize("case", MAX_CASES, ids=lambda c: f"D{c[1]}H{c[2]}")
@pytest.mark.parametrize("magnitude", [False, True], ids=["mca", "mmca"])
@pytest.mark.parametrize("beta", [0.6, 1.0])
def test_max_estep_kernel_matches_plain(case, magnitude, beta, device):
    y, w, W, lo, sa, Hp = _max_inputs(case, magnitude, device)
    sigma2 = torch.tensor(2.5, device=device)
    args = (y, w, W, sigma2, lo, sa, Hp, magnitude, beta, 1.0)
    F0, ref = maxstep.max_et_estep(*args, chunk=2048)
    F1, on = max_cuda.max_et_estep_cuda(*args, collect_true=True)
    _, off = max_cuda.max_et_estep_cuda(*args, collect_true=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(F1, F0, rtol=1e-4, atol=1e-4)
    for k in ref:
        torch.testing.assert_close(on[k], ref[k], rtol=1e-3, atol=1e-3,
                                   msg=k)
        if beta == 1.0 and k != "F_true":
            assert torch.equal(on[k], off[k]), k


def test_max_wrapper_repeats_bit_identical_and_chunks_rows(device,
                                                           monkeypatch):
    y, w, W, lo, sa, Hp = _max_inputs(MAX_CASES[1], True, device)
    args = (y, w, W, torch.tensor(2.5, device=device), lo, sa, Hp, True,
            1.0, 1.0)
    F1, one = max_cuda.max_et_estep_cuda(*args)
    F2, two = max_cuda.max_et_estep_cuda(*args)
    monkeypatch.setattr(cuda_lib, "P_LIMIT_BYTES", 1024 * 4 * W.shape[1])
    F3, cut = max_cuda.max_et_estep_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(F1, F2) and torch.equal(F1, F3)
    for k in one:
        assert torch.equal(one[k], two[k]), k
        torch.testing.assert_close(cut[k], one[k], rtol=1e-4, atol=1e-4,
                                   msg=k)


def test_max_wrapper_rejects_cpu_tensors_bad_shapes_and_limits(device):
    y, w, W, lo, sa, Hp = _max_inputs(MAX_CASES[0], False, device)
    args = (lo, sa, Hp, False, 1.0, 1.0)
    with pytest.raises(ValueError):
        max_cuda.max_et_estep_cuda(y.cpu(), w, W, 1.0, *args)
    with pytest.raises(ValueError):
        max_cuda.max_et_estep_cuda(y, w[:-1], W, 1.0, *args)
    with pytest.raises(ValueError):
        max_cuda.max_et_estep_cuda(y, w, W[:-1].contiguous(), 1.0, *args)
    big = etstep.state_arrays_from(binary_state_space(9, 3), device)
    W9 = torch.ones(16, 9, device=device)
    with pytest.raises(ValueError):                # H' beyond the kernel's
        max_cuda.max_et_estep_cuda(y, w, W9, 1.0, lo, big, 9, False, 1.0,
                                   1.0)


# ---- the big-S recurrence (s_block > 0) -------------------------------------

BIGS_CASES = [  # (N, D, H, Hp, gamma, values, signed, s_block)
    (1000, 16, 12, 6, 4, (1.0,), False, 48),
    (1000, 16, 12, 6, 4, (-1.0, 1.0), True, 48),
    (999, 16, 12, 6, 4, (-1.0, 1.0, 2.0), True, 48),
    (4096, 64, 32, 10, 5, (-1.0, 1.0), True, 1024),
]
MULTI_OUT = ("m", "l", "m_t", "l_t", "a_abs", "a_s", "a_ss", "a_vc")


def _bigs_inputs(case, beta, prior_beta, device, seed=0):
    """E-step arguments with a dead unit and zero-weight rows, and the
    operands the E-step hands the recurrence."""
    N, D, H, Hp, gamma, values, signed, s_block = case
    y, w, W, lo, sa, Hp, signed = _inputs(
        (N, D, H, Hp, gamma, values, signed), device, seed)
    W[:, 2] = 0.0
    sigma2 = torch.tensor(2.5, device=device)
    gram = W.T @ W
    _, _, tables = etstep.bigs_front(y, W, gram, torch.diagonal(gram), lo,
                                     sa, Hp, signed, s_block)
    margs = (*tables, 0.5 / sigma2, beta, prior_beta, s_block)
    return (y, w, W, sigma2, lo, sa, Hp, signed, beta, prior_beta), margs


@pytest.mark.parametrize("case", BIGS_CASES,
                         ids=lambda c: f"H{c[2]}Hp{c[3]}K{len(c[5])}")
@pytest.mark.parametrize("beta,prior_beta", [(0.6, 1.0), (1.0, 1.0),
                                             (1.0, 0.8), (0.6, 0.0)])
def test_bigs_kernel_matches_plain(case, beta, prior_beta, device):
    """The running max within rtol 1e-4, the masses and moments within
    1e-3 (another summation order than cuBLAS's); repeated calls, and
    everything but the un-annealed pair with collect_true off, are
    bit-identical."""
    _, margs = _bigs_inputs(case, beta, prior_beta, device)
    ref = etstep.bigs_multi(*margs, collect_true=True)
    on = bigs_cuda.bigs_multi_cuda(*margs, collect_true=True)
    off = bigs_cuda.bigs_multi_cuda(*margs, collect_true=False)
    again = bigs_cuda.bigs_multi_cuda(*margs, collect_true=True)
    torch.cuda.synchronize()
    for name, a, b, c, d in zip(MULTI_OUT, on, ref, off, again):
        tol = 1e-4 if name in ("m", "m_t") else 1e-3
        torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=name)
        assert torch.equal(a, d), name
        if name not in ("m_t", "l_t"):
            assert torch.equal(a, c), name


@pytest.mark.parametrize("case", BIGS_CASES,
                         ids=lambda c: f"H{c[2]}Hp{c[3]}K{len(c[5])}")
@pytest.mark.parametrize("beta,prior_beta", [(0.6, 1.0), (1.0, 1.0),
                                             (1.0, 0.0)])
def test_bigs_estep_kernel_matches_plain(case, beta, prior_beta, device):
    args, _ = _bigs_inputs(case, beta, prior_beta, device, seed=1)
    s_block = case[-1]
    F0, ref = etstep.linear_et_estep(*args, chunk=args[0].shape[0],
                                     s_block=s_block)
    F1, on = linear_cuda.linear_et_estep(*args, s_block=s_block)
    _, off = linear_cuda.linear_et_estep(*args, s_block=s_block,
                                         collect_true=False)
    _, again = linear_cuda.linear_et_estep(*args, s_block=s_block)
    torch.cuda.synchronize()
    torch.testing.assert_close(F1, F0, rtol=1e-4, atol=1e-4)
    for k in ref:
        torch.testing.assert_close(on[k], ref[k], rtol=1e-3, atol=1e-3,
                                   msg=k)
        assert torch.equal(on[k], again[k]), k
        if beta == prior_beta == 1.0 and k != "F_true":
            assert torch.equal(on[k], off[k]), k


def test_bigs_wrapper_rejects_cpu_tensors_bad_shapes_and_layouts(device):
    _, margs = _bigs_inputs(BIGS_CASES[1], 1.0, 1.0, device)
    proj, Gf, st, ot, vc, prior, valid, ab = margs[:8]
    rest = margs[8:]
    with pytest.raises(ValueError):                          # CPU tensors
        bigs_cuda.bigs_multi_cuda(*(t.cpu() for t in margs[:8]), *rest)
    with pytest.raises(ValueError):                          # a wrong shape
        bigs_cuda.bigs_multi_cuda(proj, Gf[:, :-1].contiguous(),
                                  *margs[2:8], *rest)
    with pytest.raises(ValueError):                          # non-contiguous
        bigs_cuda.bigs_multi_cuda(proj.T.contiguous().T, *margs[1:8], *rest)


@pytest.mark.parametrize("case", BIGS_CASES,
                         ids=lambda c: f"H{c[2]}Hp{c[3]}K{len(c[5])}")
def test_bigs_kernel_takes_unpadded_tables(case, device):
    """The kernel masks states past the table itself: on the unpadded
    tables the E-step hands it, it gives what the plain version gives on
    tables padded to s_block."""
    args, margs = _bigs_inputs(case, 0.6, 0.0, device, seed=2)
    y, _, W, _, lo, sa, Hp, signed = args[:8]
    gram = W.T @ W
    _, _, tables = etstep.bigs_front(y, W, gram, torch.diagonal(gram), lo,
                                     sa, Hp, signed, 1)
    assert tables[2].shape[0] == sa.states.shape[0]
    ref = etstep.bigs_multi(*margs, collect_true=True)
    on = bigs_cuda.bigs_multi_cuda(*tables, *margs[8:], collect_true=True)
    torch.cuda.synchronize()
    for name, a, b in zip(MULTI_OUT, on, ref):
        tol = 1e-4 if name in ("m", "m_t") else 1e-3
        torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=name)


def test_fused_estep_names_s_block_for_a_big_state_space(device):
    """At the tsc_bigs width the fused kernel's tile outgrows shared memory;
    the error says so and names the big-S route, and that route runs."""
    case = (256, 64, 32, 10, 5, (-1.0, 1.0), True)
    y, w, W, lo, sa, Hp, signed = _inputs(case, device)
    args = (y, w, W, torch.tensor(2.5, device=device), lo, sa, Hp, signed,
            1.0, 1.0)
    with pytest.raises(ValueError, match="s_block"):
        linear_cuda.linear_et_estep_cuda(*args)
    F, _ = linear_cuda.linear_et_estep(*args, s_block=1024)
    assert torch.isfinite(F).all()
