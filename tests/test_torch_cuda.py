"""The CUDA kernels of the port (the two GEMMs, the linear E-step and
decode, the max family's E-step, the big-S recurrence, GSC's E-step)
against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present.  On a machine
with a card:  python -m pytest --noconftest -q tests/test_torch_cuda.py
(``--noconftest`` because the suite's conftest configures JAX, which such a
machine need not have).  The inputs are quantised to multiples of 1/4, so
P = y W and the Gram matrix are exact in float32 whatever the order of
summation, and the candidates and top-L identities must match exactly.
"""

import time

import numpy as np
import pytest
import torch

from prosper_tpu_torch.core import etstep, gscstep, maxstep
from prosper_tpu_torch.core.states import (binary_state_space,
                                           discrete_state_space)
from prosper_tpu_torch import utils
from prosper_tpu_torch.ops import (bigs_cuda, cuda_lib, gemm_cuda, gsc_cuda,
                                   linear_cuda, max_cuda)
from test_torch_rows_tables import (parent_rows_smem_words,
                                    rows_smem_words, table_words)

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


def _assert_estep_matches_plain(args, device):
    """The E-step kernels against the plain version (F rtol 1e-4, the sums
    1e-3, as ``test_estep_kernel_matches_plain``); two calls bit-identical;
    collect_true off equal to on, bit for bit, but F_true."""
    F0, ref = etstep.linear_et_estep(*args, chunk=args[0].shape[0])
    F1, on = linear_cuda.linear_et_estep_cuda(*args, collect_true=True)
    F2, again = linear_cuda.linear_et_estep_cuda(*args, collect_true=True)
    _, off = linear_cuda.linear_et_estep_cuda(*args, collect_true=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(F1, F0, rtol=1e-4, atol=1e-4)
    assert torch.equal(F1, F2)
    for k in ref:
        torch.testing.assert_close(on[k], ref[k], rtol=1e-3, atol=1e-3,
                                   msg=k)
        assert torch.equal(on[k], again[k]), k
        if k != "F_true":
            assert torch.equal(on[k], off[k]), k


SHARED_CASES = [(1003, 25, 10, 6, 3, (-1.0, 1.0), True),
                (2003, 256, 300, 8, 4, (1.0,), False)]


@pytest.mark.parametrize("case", SHARED_CASES,
                         ids=lambda c: f"H{c[2]}K{len(c[5])}")
@pytest.mark.parametrize("beta", [0.6, 1.0])
def test_estep_kernel_tiles_whose_rows_share_candidates(case, beta, device):
    """Rows of one tile of 8 that share candidates: every row twice in a
    row, and a whole tile of one row, so that the rows kernel's ss scatter
    sums shared addresses (each by the tile's first row that holds it);
    rows of weight 0 inside tiles, which hold no address; N a multiple of
    no tile."""
    y, w, W, lo, sa, Hp, signed = _inputs(case, device, seed=4)
    y[1::2] = y[0::2][:y[1::2].shape[0]]
    y[16:24] = y[16]
    w[40:] = 1.0
    w[[41, 42, 45, 50, 57, 63, 100]] = 0.0
    _assert_estep_matches_plain(
        (y, w, W, torch.tensor(2.5, device=device), lo, sa, Hp, signed,
         beta, 1.0), device)


@pytest.mark.parametrize("Hp,gamma,values",
                         [(8, 4, (1.0,)), (8, 4, (-1.0, 1.0)),
                          (6, 3, (-1.0, 1.0, 2.0))],
                         ids=["K1", "K2", "K3"])
def test_estep_kernel_value_counts_at_the_patches_width(Hp, gamma, values,
                                                        device):
    """K = 1, 2, 3 at H = 300: BSC and TSC at H' = 8, gamma = 4 (TSC's
    1,680 multi states fit a block since the tables are bit masks), DSC at
    H' = 6, gamma = 3: its 7,434 multi states at H' = 8, gamma = 4 fit no
    block, and raise naming backend="plain", as they always did."""
    case = (2003, 256, 300, Hp, gamma, values, len(values) > 1)
    y, w, W, lo, sa, Hp, signed = _inputs(case, device, seed=5)
    _assert_estep_matches_plain(
        (y, w, W, torch.tensor(2.5, device=device), lo, sa, Hp, signed,
         0.6, 1.0), device)
    if len(values) == 3:
        wide = etstep.state_arrays_from(discrete_state_space(8, 4, values),
                                        device)
        with pytest.raises(ValueError, match='backend="plain"'):
            linear_cuda.linear_et_estep_cuda(y, w, W, 2.5, lo, wide, 8,
                                             signed, 0.6, 1.0)


@pytest.mark.parametrize("signed", [False, True])
def test_estep_kernel_when_every_score_ties(signed, device):
    """Every column of W alike: all H scores of a row tie, more than 32
    units qualify for the candidates, and the selection takes its second
    way (the lanes' own keys, a rescan by each round's winner); ties go to
    the lowest units, as in the plain version."""
    case = (333, 64, 80, 6, 3, (-1.0, 1.0) if signed else (1.0,), signed)
    y, w, W, lo, sa, Hp, signed = _inputs(case, device, seed=7)
    W[:, 1:] = W[:, :1]
    _assert_estep_matches_plain(
        (y, w, W, torch.tensor(2.5, device=device), lo, sa, Hp, signed,
         0.6, 1.0), device)


WIDE_CASES = [(1024, 8, 4, (1.0,)), (1024, 16, 2, (1.0,)),
              (790, 17, 2, (1.0,)), (300, 8, 8, (1.0,)),
              (64, 4, 2, (-4.0, -3.0, -2.0, -1.0, 1.0, 2.0, 3.0, 4.0))]


@pytest.mark.parametrize("H,Hp,gamma,values", WIDE_CASES,
                         ids=lambda c: str(c) if not isinstance(c, tuple)
                         else f"K{len(c)}")
def test_estep_kernel_runs_the_widest_models_it_ever_took(H, Hp, gamma,
                                                         values, device):
    """Models at the edge of what ``check_limits`` and the shared-memory
    check admitted before the redesign (H = 1024; H' = 16 and 17 at
    gamma = 2; every subset of 8 slots; K = 8) still run through the rows
    kernel and match the plain version; the shared memory a block takes is
    ``tests/test_torch_rows_tables.py``'s count of it."""
    K = len(values)
    case = (333, 32, H, Hp, gamma, values, K > 1)
    y, w, W, lo, sa, Hp, signed = _inputs(case, device, seed=6)
    S = sa.states.shape[0]
    assert 4 * parent_rows_smem_words(H, Hp, S, K) <= cuda_lib.SMEM_LIMIT
    smem, blocks = linear_cuda.rows_occupancy(cuda_lib.load_library(), H,
                                              Hp, sa)
    table = linear_cuda._rows_table(sa).numel()
    assert table <= table_words(Hp, S, K)
    assert smem == 4 * rows_smem_words(H, Hp, S, K, table) and blocks >= 1
    _assert_estep_matches_plain(
        (y, w, W, torch.tensor(2.5, device=device), lo, sa, Hp, signed,
         0.6, 1.0), device)


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


def test_decode_kernel_ragged_rows_full_top_L_and_repeats(device):
    """N a multiple of no tile of 8 rows and top_L = 1 + H*K + S, every
    posterior entry ranked: the decode agrees with the plain version (ties
    to the lowest index, taken entries knocked out), and two calls give the
    same bits."""
    case = (1003, 25, 10, 6, 3, (-1.0, 1.0), True)
    y, _, W, lo, sa, Hp, signed = _inputs(case, device, seed=3)
    full = 1 + W.shape[1] * 2 + sa.states.shape[0]
    sigma2 = torch.tensor(2.5, device=device)
    for top_L in (10, full):
        args = (y, W, sigma2, lo, sa, Hp, signed, top_L, 0.6, 0.8)
        ref = etstep.linear_et_decode(*args)
        before = dict(cuda_lib.LAUNCHES)
        out = linear_cuda.linear_et_decode_cuda(*args)
        again = linear_cuda.linear_et_decode_cuda(*args)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES["decode"] == before["decode"] + 2
        assert cuda_lib.LAUNCHES["sgemm_nn"] == before["sgemm_nn"] + 2
        for name, a, b in zip(("F", "s_mean", "top_q"), out[:3], ref[:3]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=name)
        assert torch.equal(out[3], ref[3]), "top_u"
        assert torch.equal(out[4], ref[4]), "cand"
        for a, b in zip(out, again):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        linear_cuda.linear_et_decode_cuda(*args[:7], full + 1, 0.6, 0.8)


def test_decode_wrapper_chunks_rows(device, monkeypatch):
    """A workspace limit that cuts N into chunks of rows changes nothing:
    the rows are independent."""
    y, _, W, lo, sa, Hp, signed = _inputs(CASES[3], device, seed=1)
    args = (y, W, torch.tensor(2.5, device=device), lo, sa, Hp, signed, 10,
            1.0, 1.0)
    one = linear_cuda.linear_et_decode_cuda(*args)
    monkeypatch.setattr(cuda_lib, "P_LIMIT_BYTES", 1024 * 4 * W.shape[1])
    cut = linear_cuda.linear_et_decode_cuda(*args)
    torch.cuda.synchronize()
    for a, b in zip(one, cut):
        assert torch.equal(a, b)


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
    assert gemm_cuda.sgemm_nn_cuda(a, b).is_cuda
    assert gemm_cuda.sgemm_tn_splitn_cuda(a, a).is_cuda
    assert gemm_cuda.LAUNCHES["sgemm_nn"] == before["sgemm_nn"] + 1
    assert gemm_cuda.LAUNCHES["sgemm_tn"] == before["sgemm_tn"] + 1


def _gemm_draw(rng, quantised, device, *shape):
    a = rng.standard_normal(shape)
    a = np.round(a * 4) / 4 if quantised else a
    return torch.as_tensor(a.astype(np.float32), device=device)


def _exact_or_close(out, again, ref, quantised, depth):
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    if quantised:
        assert torch.equal(out.double(), ref)
    else:
        torch.testing.assert_close(out.double(), ref, rtol=1e-5,
                                   atol=2e-7 * depth)


@pytest.mark.parametrize("quantised", [True, False], ids=["quarters", "randn"])
def test_gemm_nn_at_the_decode_shape(quantised, device):
    """sgemm_nn at a decode's shape (8192 rows of the patches width)."""
    rng = np.random.default_rng(8192)
    y = _gemm_draw(rng, quantised, device, 8192, 256)
    W = _gemm_draw(rng, quantised, device, 256, 300)
    _exact_or_close(gemm_cuda.sgemm_nn_cuda(y, W),
                    gemm_cuda.sgemm_nn_cuda(y, W), y.double() @ W.double(),
                    quantised, 256)


@pytest.mark.parametrize("N", [16385, 131072])
@pytest.mark.parametrize("quantised", [True, False], ids=["quarters", "randn"])
def test_gemm_tn_in_the_max_familys_orientation(N, quantised, device):
    """The max family's singleton numer: out (300, 256) += P^T y for P
    (N, 300), y (N, 256), the register side of the kernel the narrower
    operand (the product stored transposed)."""
    rng = np.random.default_rng(N)
    P = _gemm_draw(rng, quantised, device, N, 300)
    y = _gemm_draw(rng, quantised, device, N, 256)
    base = _gemm_draw(rng, quantised, device, 300, 256)
    P[:40] = 0.0
    _exact_or_close(
        gemm_cuda.sgemm_tn_splitn_cuda(P, y, out=base.clone(),
                                       accumulate=True),
        gemm_cuda.sgemm_tn_splitn_cuda(P, y, out=base.clone(),
                                       accumulate=True),
        base.double() + P.double().T @ y.double(), quantised, N)


@pytest.mark.parametrize("shape", [(4096, 256, 300), (1000, 25, 10)],
                         ids=lambda s: "N%dD%dH%d" % s)
def test_gemm_wide_dynamic_range(shape, device):
    """Rows of y and columns of W (nn), columns of both operands (tn),
    scaled by 2^k for k in -20..20: each output is a scaled Gaussian sum,
    held to the float32 tolerance relative to its own scale.  A missing or
    wrong lo term (2^-11 relative) fails it."""
    N, D, H = shape
    rng = np.random.default_rng(N + D)
    y = _gemm_draw(rng, False, device, N, D)
    W = _gemm_draw(rng, False, device, D, H)
    sw = _gemm_draw(rng, False, device, N, H)

    def powers(n):
        return torch.as_tensor(2.0 ** (np.arange(n) % 41 - 20),
                               dtype=torch.float32, device=device)
    r, c, cy = powers(N), powers(H).flip(0), powers(D)
    ys, Ws = y * r[:, None], W * c[None, :]
    out = gemm_cuda.sgemm_nn_cuda(ys, Ws)
    scale = (r[:, None] * c[None, :]).double()
    ref = ys.double() @ Ws.double()
    torch.testing.assert_close(out.double() / scale, ref / scale, rtol=1e-5,
                               atol=2e-7 * D)
    yc, swc = y * cy[None, :], sw * c[None, :]
    out = gemm_cuda.sgemm_tn_splitn_cuda(yc, swc)
    scale = (cy[:, None] * c[None, :]).double()
    ref = yc.double().T @ swc.double()
    torch.testing.assert_close(out.double() / scale, ref / scale, rtol=1e-5,
                               atol=2e-7 * N)


@pytest.mark.parametrize("shape", [(4096, 256, 300), (1000, 25, 10)],
                         ids=lambda s: "N%dD%dH%d" % s)
def test_gemm_wrappers_replay_in_a_cuda_graph(shape, device):
    """Each wrapper captured into a CUDA graph (the split image of W and the
    split partials come from the graph's pool) and replayed on new inputs
    copied into the captured ones: the same bits as eager calls."""
    N, D, H = shape
    rng = np.random.default_rng(N + D + H)
    y, W = (_gemm_draw(rng, False, device, *s) for s in ((N, D), (D, H)))
    sw, base = (_gemm_draw(rng, False, device, *s) for s in ((N, H), (D, H)))
    acc = torch.empty_like(base)

    def calls():
        acc.copy_(base)
        return (gemm_cuda.sgemm_nn_cuda(y, W),
                gemm_cuda.sgemm_tn_splitn_cuda(y, sw),
                gemm_cuda.sgemm_tn_splitn_cuda(sw, y),
                gemm_cuda.sgemm_tn_splitn_cuda(y, sw, out=acc,
                                               accumulate=True))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()                                    # built, attributes set
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        for t in (y, W, sw, base):
            t.copy_(_gemm_draw(rng, False, device, *t.shape))
        graph.replay()
        replayed = [t.clone() for t in captured]
        eager = [t.clone() for t in calls()]
        torch.cuda.synchronize()
        for a, b in zip(replayed, eager):
            assert torch.equal(a, b)
        torch.testing.assert_close(replayed[0].double(),
                                   y.double() @ W.double(), rtol=1e-5,
                                   atol=2e-7 * D)


# ---- the max-family E-step kernel (MCA / MMCA) ------------------------------

MAX_CASES = [  # (N, D, H, Hp, gamma): bars, mca_small, patches
    (1000, 16, 8, 6, 3),
    (4096, 64, 100, 6, 3),
    (16384, 256, 300, 6, 3),
] + [  # every H' the kernel is compiled for, at gamma = 2 and at the largest
    # gamma with S <= 128; a ragged N and a D that is no multiple of 32
    (999, 40, 20, Hp, gamma) for Hp, top in ((2, 2), (3, 3), (4, 4), (5, 5),
                                            (6, 6), (7, 7), (8, 3))
    for gamma in sorted({2, top})] + [
    (999, 40, 1000, 6, 3),    # the routing kernel's units in two groups
]


def _max_case_id(c):
    return f"D{c[1]}H{c[2]}" + ("" if c[3:] == (6, 3) else f"Hp{c[3]}g{c[4]}")


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


@pytest.mark.parametrize("case", MAX_CASES, ids=_max_case_id)
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


def test_max_kernel_shared_memory_and_blocks_match_the_host(device):
    """The source's shared memory a block of each kernel is the wrapper's,
    and every instantiation fits at least one block of each an SM."""
    lib = cuda_lib.load_library()
    for N, D, H, Hp, gamma in MAX_CASES:
        S = binary_state_space(Hp, gamma).S
        assert lib.max_et_smem_bytes(D, H, Hp, S) == max_cuda.smem_bytes(
            D, H, Hp, S)
        hcols, _ = max_cuda.route_units(H, Hp)
        for h in (hcols, 7):
            assert lib.max_et_route_smem_bytes(Hp, h) == \
                max_cuda.route_smem_bytes(Hp, h)
        for magnitude in (False, True):
            assert min(max_cuda.blocks_per_sm(lib, D, H, Hp, S, hcols,
                                              magnitude)) >= 1


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
    (1000, 16, 13, 6, 3, (1.0,), False, 16),            # S = 35, odd
    (777, 16, 12, 3, 2, (-1.0, 1.0), True, 8),          # H' = 3: nL = 9
    (500, 16, 12, 4, 3, (1.0,), False, 8),      # 17 moment columns: 3 single
    (600, 16, 20, 12, 3, (1.0,), False, 64),    # 93: blocks of 8 warps
    (600, 16, 20, 15, 2, (1.0,), False, 32),    # 138: the widest tile
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


def test_bigs_second_moments_come_out_symmetric(device):
    """The kernel sums one triangle of <s_a s_b> and the wrapper mirrors
    it."""
    _, margs = _bigs_inputs(BIGS_CASES[3], 0.6, 1.0, device)
    a_ss = bigs_cuda.bigs_multi_cuda(*margs)[6]
    Hp = margs[0].shape[1]
    a_ss = a_ss.reshape(-1, Hp, Hp)
    assert torch.equal(a_ss, a_ss.transpose(1, 2))


def test_bigs_wrapper_rejects_cpu_tensors_bad_shapes_and_layouts(device):
    _, margs = _bigs_inputs(BIGS_CASES[1], 1.0, 1.0, device)
    proj, Gf, st, ot, vc, prior, valid, ab = margs[:8]
    rest = margs[8:]
    wide = etstep.state_arrays_from(discrete_state_space(16, 2, (1.0,)),
                                    device)
    with pytest.raises(ValueError, match="moment columns"):  # H' = 16
        bigs_cuda.tri_tables(cuda_lib.load_library(), wide.states,
                             wide.outer, wide.value_counts, wide.abs_states)
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


# -- run_scanned: the EM step as a CUDA graph ---------------------------------

def _scan_models():
    from prosper_tpu_torch.models import BSC, GSC, MCA, TSC
    return {
        "bsc": lambda **kw: BSC(25, 16, 6, 3, chunk=256, **kw),
        "mca": lambda **kw: MCA(25, 16, 6, 3, chunk=256, **kw),
        "gsc": lambda **kw: GSC(25, 16, 6, 3, chunk=256, **kw),
        "tsc_bigs": lambda **kw: TSC(25, 12, 6, 4, chunk=256, s_block=64,
                                     **kw),
    }


def _scan_anneal(steps=8, partial=False, rho=False):
    """Annealed -> saturated, W noise on -> off, the data cut off -> on."""
    from prosper_tpu_torch import LinearAnnealing
    a = LinearAnnealing(steps)
    a["T"] = [(0.0, 2.0), (0.5, 1.0)]
    a["W_noise"] = [(0.0, 0.5), (0.5, 0.0)]
    a["Ncut_factor"] = [(0.3, 0.0), (1.0, 1.0)]
    if partial:
        a["partial"] = [(0.0, 0.7), (0.4, 0.7), (0.45, 1.0)]
    if rho:
        a["rho"] = [(0.0, 4.0), (0.4, 4.0), (0.45, 0.0)]
    return a


def _scan_data(name, N, seed=3):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((N, 25)) * 2.0).astype(np.float32)
    return np.abs(y) if name == "mca" else y


def _scan_pair(name, N, device, seed=7, anneal=_scan_anneal, **kw):
    from prosper_tpu_torch import EM
    y = _scan_data(name, N)
    make = _scan_models()[name]
    return [EM(make(**kw), anneal(), {"y": y}, seed=seed, device=device)
            for _ in range(2)]


def _assert_same_run(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert torch.equal(a.data["F_prev"], b.data["F_prev"])
    assert len(a.history) == len(b.history)
    for ha, hb in zip(a.history, b.history):
        for k in ha:
            if k != "dt":
                assert ha[k] == hb[k], (ha["iteration"], k)
    # the generator's state: the next draw
    assert torch.equal(
        torch.randn(64, generator=a.generator, device=a.device),
        torch.randn(64, generator=b.generator, device=b.device))


@pytest.mark.parametrize("N", [256, 777], ids=["N256", "N777_padded"])
@pytest.mark.parametrize("name", ["bsc", "mca", "tsc_bigs"])
def test_run_scanned_replays_are_bit_identical_to_run(name, N, device):
    """Graph replays against eager ``run``: parameters, F_prev, every
    scalar and the generator's next draw; every pattern is captured.
    ``LAUNCHES`` counts launch sites: the eager first steps and the
    captures pass them, a replay passes none, and what the replays hold is
    in ``scan_stats["replayed_launches"]``."""
    ref, em = _scan_pair(name, N, device)
    for k in cuda_lib.LAUNCHES:
        cuda_lib.LAUNCHES[k] = 0
    ref.run()
    torch.cuda.synchronize()
    eager = dict(cuda_lib.LAUNCHES)
    for k in cuda_lib.LAUNCHES:
        cuda_lib.LAUNCHES[k] = 0
    em.run_scanned()
    torch.cuda.synchronize()
    mine = ({"bigs"} if name == "tsc_bigs" else
            {{"bsc": "estep", "mca": "max_estep", "gsc": "gsc_estep"}[name],
             "sgemm_nn", "sgemm_tn"})
    assert eager == {k: 8 if k in mine else 0 for k in eager}
    _assert_same_run(em, ref)
    stats = em.scan_stats
    # iterations 0-2, 3 and 4-7 are three patterns: the first iteration of
    # each runs eagerly, the two runs longer than one are captured
    assert (stats["graphs"], stats["eager_steps"], stats["replays"]) == (
        2, 3, 5)
    assert dict(cuda_lib.LAUNCHES) == {k: 3 + 2 if k in mine else 0
                                       for k in eager}
    assert stats["replayed_launches"] == {k: 5 for k in mine}


@pytest.mark.parametrize("name", ["bsc", "mca", "tsc_bigs"])
def test_run_scanned_mixes_with_run_and_reuses_its_graphs(name, device):
    """``run_scanned(3)``, two ``step_once``, ``run_scanned()``: one
    trajectory; the second call replays the graphs of the first where the
    pattern is the same."""
    ref, em = _scan_pair(name, 512, device)
    ref.run()
    em.run_scanned(3)
    graphs = em.scan_stats["graphs"]
    em.step_once()
    em.step_once()
    em.run_scanned()
    _assert_same_run(em, ref)
    assert em.scan_stats["graphs"] >= graphs


def test_second_em_on_one_model_reuses_nothing_stale(device):
    """Fresh data and a fresh seed on the same model object: the same
    result as its own eager run."""
    from prosper_tpu_torch import EM
    model = _scan_models()["bsc"]()
    EM(model, _scan_anneal(), {"y": _scan_data("bsc", 512, seed=1)}, seed=1,
       device=device).run_scanned()
    y = _scan_data("bsc", 640, seed=2)
    em = EM(model, _scan_anneal(), {"y": y}, seed=9, device=device)
    ref = EM(model, _scan_anneal(), {"y": y}, seed=9, device=device)
    em.run_scanned()
    ref.run()
    _assert_same_run(em, ref)


def test_replays_run_the_kernels_of_eager_steps(device):
    """A profiler trace of the card: four replays of one graph run each of
    the path's kernels as often as four eager steps do."""
    from torch.profiler import ProfilerActivity, profile
    from prosper_tpu_torch import EM, LinearAnnealing

    def traced(run):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        return {k: sum(k in n for n in names)
                for k in ("rows_kernel", "nn_kernel", "tn_kernel")}

    def em():
        return EM(_scan_models()["bsc"](), LinearAnnealing(9),
                  {"y": _scan_data("bsc", 512)}, seed=7, device=device)
    scanned, eager = em(), em()
    scanned.run_scanned(5)                # one eager step, a capture, replays
    for _ in range(5):
        eager.step_once()
    replays = scanned.scan_stats["replays"]
    in_replays = traced(lambda: scanned.run_scanned(4))
    assert scanned.scan_stats["replays"] == replays + 4
    in_steps = traced(lambda: [eager.step_once() for _ in range(4)])
    assert in_replays == in_steps
    assert all(v >= 4 for v in in_replays.values())
    _assert_same_run(scanned, eager)


@pytest.mark.parametrize("name", ["bsc", "mca"])
def test_layer_timers_of_run_scanned(name, device):
    """With the spans on, each graph holds a timing event pair a region and
    ``scan_stats`` sums the E-step's, the cut's and the M-step's device ms
    over the iterations of the captured patterns (7 of 8: iteration 3, a
    pattern of one iteration, runs eagerly and is not captured); the run,
    its graphs and what the replays held equal a run with the spans off,
    which times nothing.  The layers fit in the window's time."""
    from prosper_tpu_torch.io import tracing
    off, on = _scan_pair(name, 4096, device)
    off.run_scanned()
    tracing.enable(True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on.run_scanned()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        tracing.enable(False)
    _assert_same_run(on, off)
    a, b = dict(on.scan_stats), dict(off.scan_stats)
    for k in ("capture_s", "layer_ms", "timed_iterations"):
        a.pop(k), b.pop(k)
    assert a == b
    assert off.scan_stats["layer_ms"] == {}
    assert off.scan_stats["timed_iterations"] == 0
    layer_ms = on.scan_stats["layer_ms"]
    assert set(layer_ms) == {"estep", "ncut", "mstep"}
    assert all(v > 0 for v in layer_ms.values())
    assert on.scan_stats["timed_iterations"] == 7
    assert sum(layer_ms.values()) < wall_ms


@pytest.mark.parametrize("name", ["bsc", "mca"])
def test_layer_timers_stop_with_the_switch(name, device):
    """A graph captured with the spans on keeps its timing events, but
    once the spans are off its replays add nothing to ``layer_ms``: the
    first window (iterations 0-1, before the cut starts: an eager step and
    one replay of the pattern captured with the events) is timed, the rest
    (iteration 2 replays that graph) is not, and the run equals one never
    timed."""
    from prosper_tpu_torch.io import tracing
    off, on = _scan_pair(name, 4096, device)
    off.run_scanned()
    tracing.enable(True)
    try:
        on.run_scanned(2)
    finally:
        tracing.enable(False)
    timed = {k: on.scan_stats[k] for k in ("layer_ms", "timed_iterations")}
    assert timed["timed_iterations"] == 2
    assert set(timed["layer_ms"]) == {"estep", "mstep"}
    timed["layer_ms"] = dict(timed["layer_ms"])
    on.run_scanned()
    assert on.scan_stats["timed_iterations"] == 2
    assert on.scan_stats["layer_ms"] == timed["layer_ms"]
    _assert_same_run(on, off)


def _assert_close_run(a, b, rtol):
    for k in a.params:
        torch.testing.assert_close(a.params[k], b.params[k], rtol=rtol,
                                   atol=rtol, msg=k)
    for ha, hb in zip(a.history, b.history):
        for k in ("F_mean", "Q_mean", "n_used", "N_total"):
            assert ha[k] == pytest.approx(hb[k], rel=rtol), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("what", ["partial", "rho", "plain", "phi"])
def test_run_scanned_other_patterns_follow_run(what, device):
    """``partial`` < 1 (a sort), the softened max, ``backend="plain"`` and
    learned Phi capture like the rest.  The last three run the plain
    version on the card, whose ``index_add_`` sums with atomics in an order
    that changes from run to run: ``run_scanned`` is held to ``run`` as
    closely as two eager runs agree, bit for bit where they do, else within
    rtol 1e-3 after eight iterations (and the generator's state exactly)."""
    from prosper_tpu_torch import EM
    from prosper_tpu_torch.models import DSC

    def three():
        if what == "phi":
            y = _scan_data("dsc", 512)
            return [EM(DSC(25, 12, 5, 3, chunk=256, backend="plain",
                           to_learn=("W", "pi", "sigma", "phi")),
                       _scan_anneal(), {"y": y}, seed=7, device=device)
                    for _ in range(3)]
        name = "mca" if what in ("rho", "plain") else "bsc"
        kw = {"backend": "plain"} if what == "plain" else {}
        anneal = lambda: _scan_anneal(partial=what == "partial",  # noqa: E731
                                      rho=what == "rho")
        return (_scan_pair(name, 512, device, anneal=anneal, **kw)
                + _scan_pair(name, 512, device, anneal=anneal, **kw)[:1])
    ref, em, again = three()
    ref.run()
    again.run()
    em.run_scanned()
    assert em.scan_stats["graphs"] >= 2
    if all(torch.equal(ref.params[k], again.params[k]) for k in ref.params):
        _assert_same_run(em, ref)
    else:
        assert what != "partial"          # the kernels' path is deterministic
        _assert_close_run(em, ref, rtol=1e-3)


def test_run_scanned_raises_where_a_step_cannot_be_captured(device):
    """A step that reads a device value on the host cannot be captured:
    ``run_scanned`` raises and names the pattern; ``run`` steps such a
    model, and another EM still captures afterwards."""
    from prosper_tpu_torch import EM
    from prosper_tpu_torch.models import BSC

    class Peeking(BSC):
        def noisify(self, params, sched, generator):
            float(params["sigma"])                  # a host read
            return super().noisify(params, sched, generator)

    y = _scan_data("bsc", 512)
    ref, em = (EM(Peeking(25, 16, 6, 3, chunk=256), _scan_anneal(),
                  {"y": y}, seed=7, device=device) for _ in range(2))
    with pytest.raises(RuntimeError, match="W_noise=True.*could not be captured"):
        em.run_scanned()
    assert em.scan_stats["graphs"] == 0 and em.scan_stats["replays"] == 0
    assert all(torch.isfinite(v).all() for v in ref.run().values())
    ok, ok_ref = _scan_pair("bsc", 512, device)
    ok.run_scanned()
    ok_ref.run()
    _assert_same_run(ok, ok_ref)
    assert ok.scan_stats["graphs"] == 2


# -- schedule values on the device, limits, big-S row chunks, learned Phi -----

def test_kernels_take_beta_as_device_tensors(device):
    """beta and prior_beta as 0-d tensors on the card give the bits of the
    host floats, for the three E-step wrappers."""
    b, pb = 0.6, 0.8
    bt, pbt = (torch.tensor(v, device=device) for v in (b, pb))
    y, w, W, lo, sa, Hp, signed = _inputs(CASES[1], device)
    s2 = torch.tensor(2.5, device=device)
    outs = [linear_cuda.linear_et_estep_cuda(y, w, W, s2, lo, sa, Hp, signed,
                                             *pair) for pair in ((b, pb),
                                                                 (bt, pbt))]
    bigs = [linear_cuda.linear_et_estep(y, w, W, s2, lo, sa, Hp, signed,
                                        *pair, s_block=64)
            for pair in ((b, pb), (bt, pbt))]
    sam = etstep.state_arrays_from(binary_state_space(6, 3), device)
    ym, Wm = y.abs(), W.abs()
    mx = [max_cuda.max_et_estep_cuda(ym, w, Wm, s2, lo[0], sam, 6, False,
                                     *pair) for pair in ((b, pb), (bt, pbt))]
    torch.cuda.synchronize()
    for (F0, s0), (F1, s1) in (outs, bigs, mx):
        assert torch.equal(F0, F1)
        for k in s0:
            assert torch.equal(s0[k], s1[k]), k
    with pytest.raises(TypeError):
        cuda_lib.schedule_pair(bt, pb, device)


def test_model_past_the_max_kernel_limit_trains_with_backend_plain(device):
    """MCA with H' = 8, gamma = 4 has 154 multi states: the kernel's wrapper
    raises and names ``backend="plain"``; with it the model trains on the
    card, and one step agrees with the CPU (rtol 1e-4, sums in another
    order)."""
    from prosper_tpu_torch import EM
    from prosper_tpu_torch.io.weights import params_from_numpy
    from prosper_tpu_torch.models import MCA
    from prosper_tpu_torch.models.base import make_blank_data, sched_floats
    y = _scan_data("mca", 256)
    with pytest.raises(ValueError, match='backend="plain"'):
        EM(MCA(25, 16, 8, 4), _scan_anneal(), {"y": y}, device=device).run()
    before = dict(cuda_lib.LAUNCHES)
    model = MCA(25, 16, 8, 4, backend="plain")
    em = EM(model, _scan_anneal(), {"y": y}, seed=1, device=device)
    params = em.run_scanned()
    assert dict(cuda_lib.LAUNCHES) == before        # no kernel of ours ran
    assert all(torch.isfinite(v).all() for v in params.values())
    p0 = {k: v.cpu().numpy() for k, v in
          model.standard_init({"y": y}, seed=2, device="cpu").items()}
    # the two devices' generators differ: compare a noise-free step
    sched = dict(sched_floats(_scan_anneal()), W_noise=0.0)
    out = {d: model.step_fn(params_from_numpy(p0, d),
                            make_blank_data(y, device=d), sched,
                            torch.Generator(device=d))
           for d in ("cpu", device)}
    for k, v in out["cpu"][0].items():
        torch.testing.assert_close(out[device][0][k].cpu(), v, rtol=1e-4,
                                   atol=1e-6, msg=k)


def test_bigs_estep_in_two_row_chunks_on_the_card(device, monkeypatch):
    """The big-S E-step cut into two chunks of rows by a small workspace
    limit against one chunk: F bit-identical, sums within rtol 1e-5 of each
    sum's largest entry (two partial sums added); two kernel launches."""
    args, _ = _bigs_inputs(BIGS_CASES[1], 0.6, 1.0, device)
    N = args[0].shape[0]
    y, w = (torch.cat([t, t[: 1536 - N]]) if N < 1536 else t[:1536]
            for t in args[:2])
    args = (y.contiguous(), w.contiguous(), *args[2:])
    F1, s1 = linear_cuda.linear_et_estep(*args, s_block=48)
    Hp, H = args[6], args[2].shape[1]
    monkeypatch.setattr(cuda_lib, "P_LIMIT_BYTES", 4 * Hp * H * 1024)
    before = cuda_lib.LAUNCHES["bigs"]
    F2, s2 = linear_cuda.linear_et_estep(*args, s_block=48)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["bigs"] == before + 2
    assert torch.equal(F1, F2)
    for k in s1:
        torch.testing.assert_close(
            s2[k], s1[k], rtol=1e-5,
            atol=1e-5 * s1[k].abs().max().item(), msg=k)


def test_learned_phi_step_on_the_card_matches_the_cpu(device):
    """DSC with learned Phi and ``backend="plain"`` takes the plain version
    on the card (no kernel launch); one noise-free step agrees with the CPU
    within rtol 1e-4.  With the default backend the step and the decode
    raise on the card and name ``backend="plain"``: no kernel collects the
    value-set sums."""
    from prosper_tpu_torch import LinearAnnealing
    from prosper_tpu_torch.io.weights import params_from_numpy
    from prosper_tpu_torch.models import DSC
    from prosper_tpu_torch.models.base import make_blank_data, sched_floats
    kw = dict(to_learn=("W", "pi", "sigma", "phi"), chunk=256)
    model = DSC(25, 12, 5, 3, backend="plain", **kw)
    y = np.round(_scan_data("dsc", 512) * 4) / 4
    p0 = {k: v.numpy() for k, v in
          model.standard_init({"y": y}, seed=2, device="cpu").items()}
    p0["phi"] = np.float32([-0.5, 1.25, 1.75])
    a = LinearAnnealing(4)
    a["T"] = 1.5
    before = dict(cuda_lib.LAUNCHES)
    kernels = DSC(25, 12, 5, 3, **kw)
    on_card = params_from_numpy(p0, device)
    with pytest.raises(ValueError, match='backend="plain"'):
        kernels.step_fn(on_card, make_blank_data(y.astype(np.float32),
                                                 device=device),
                        sched_floats(a), torch.Generator(device=device))
    with pytest.raises(ValueError, match='backend="plain"'):
        kernels.inference(on_card, {"y": y.astype(np.float32)})
    out = {d: model.step_fn(params_from_numpy(p0, d),
                            make_blank_data(y.astype(np.float32), device=d),
                            sched_floats(a), torch.Generator(device=d))
           for d in ("cpu", device)}
    assert dict(cuda_lib.LAUNCHES) == before
    for k, v in out["cpu"][0].items():
        torch.testing.assert_close(out[device][0][k].cpu(), v, rtol=1e-4,
                                   atol=1e-5, msg=k)
    torch.testing.assert_close(out[device][1].cpu(), out["cpu"][1],
                               rtol=1e-4, atol=1e-4)


# -- GSC's E-step kernel --------------------------------------------------------

GSC_CASES = [  # (N, D, H, Hp, gamma)
    (4096, 256, 300, 6, 3),          # the patch width
    (1000, 25, 40, 8, 4),            # the kernel's limits
    (999, 25, 16, 3, 2),
    (333, 16, 10, 5, 3),
]


def _gsc_inputs(case, device, seed=0):
    """Quantised rows and W (P = y W and the Gram matrix exact: the same
    candidates on both paths), 40 leading rows of weight 0, the slab's
    scalars as 0-d tensors on the card."""
    N, D, H, Hp, gamma = case
    rng = np.random.default_rng(seed)
    y = np.round(rng.standard_normal((N, D)) * 6) / 4
    W = np.round(rng.standard_normal((D, H)) * 4) / 4
    w = (rng.random(N) > 0.2).astype(np.float32)
    w[:40] = 0.0
    sa = etstep.state_arrays_from(binary_state_space(Hp, gamma), device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return (t(y), t(w), t(W), t(2.5), t(0.05), t(0.4), t(1.6), sa, Hp)


@pytest.mark.parametrize("case", GSC_CASES,
                         ids=lambda c: "H%dHp%dg%d" % c[2:])
@pytest.mark.parametrize("beta", [0.6, 1.0])
def test_gsc_estep_kernel_matches_plain(case, beta, device):
    """The kernel against the plain version on the card: F and every sum;
    with the un-annealed channel off the same sums bit for bit, F_true =
    F; each call counts once in ``LAUNCHES["gsc_estep"]``, its two GEMMs
    beside it."""
    args = _gsc_inputs(case, device) + (beta, 1.0)
    F0, ref = gscstep.gsc_et_estep(*args, chunk=case[0])
    before = dict(cuda_lib.LAUNCHES)
    F1, on = gsc_cuda.gsc_et_estep_cuda(*args, collect_true=True)
    F2, off = gsc_cuda.gsc_et_estep_cuda(*args, collect_true=False)
    torch.cuda.synchronize()
    assert {k: cuda_lib.LAUNCHES[k] - before[k] for k in before} == {
        k: 2 if k in ("gsc_estep", "sgemm_nn", "sgemm_tn") else 0
        for k in before}
    assert set(on) == set(ref)
    torch.testing.assert_close(F1, F0, rtol=1e-4, atol=1e-4)
    assert torch.equal(F1, F2)
    for k in ref:
        scale = max(ref[k].abs().max().item(), 1.0)
        torch.testing.assert_close(on[k], ref[k], rtol=1e-4,
                                   atol=1e-5 * scale, msg=k)
        assert torch.equal(on[k], off[k] if k != "F_true" else on[k]), k
    assert torch.equal(off["F_true"], off["F"])


def test_gsc_estep_kernel_repeats_bit_identical_and_replays_in_a_graph(
        device, monkeypatch):
    """Two calls give the same bits; a call captured into a CUDA graph and
    replayed on new rows copied into the captured ones gives the eager
    call's bits; a workspace limit that cuts N into chunks of rows changes
    only the order of the sums."""
    args = _gsc_inputs(GSC_CASES[0], device) + (
        torch.tensor(0.7, device=device), torch.tensor(1.0, device=device))
    y = args[0]
    one = gsc_cuda.gsc_et_estep_cuda(*args)
    two = gsc_cuda.gsc_et_estep_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(one[0], two[0])
    for k in one[1]:
        assert torch.equal(one[1][k], two[1][k]), k
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gsc_cuda.gsc_et_estep_cuda(*args)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        captured = gsc_cuda.gsc_et_estep_cuda(*args)
    rng = np.random.default_rng(5)
    y.copy_(torch.as_tensor(np.round(rng.standard_normal(tuple(y.shape)) * 6)
                            / 4, dtype=torch.float32, device=device))
    graph.replay()
    replayed = (captured[0].clone(),
                {k: v.clone() for k, v in captured[1].items()})
    eager = gsc_cuda.gsc_et_estep_cuda(*args)
    torch.cuda.synchronize()
    assert not torch.equal(replayed[0], one[0])
    assert torch.equal(replayed[0], eager[0])
    for k in eager[1]:
        assert torch.equal(replayed[1][k], eager[1][k]), k
    monkeypatch.setattr(cuda_lib, "P_LIMIT_BYTES", 1024 * 4 * 300)
    cut = gsc_cuda.gsc_et_estep_cuda(*args)
    assert torch.equal(cut[0], eager[0])
    for k in eager[1]:
        torch.testing.assert_close(cut[1][k], eager[1][k], rtol=1e-4,
                                   atol=1e-4, msg=k)


def test_gsc_estep_wrapper_rejects_cpu_tensors_bad_shapes_and_wide_models(
        device):
    """The kernel's wrapper raises on CPU tensors, mismatched shapes and a
    model past its limits.  On the card the dispatcher runs nothing else:
    a model past the limits (H' = 9, supports of 5 units) raises a
    ValueError naming ``backend="plain"``, with no launch (a state axis:
    ``test_state_axis_dispatch_rules_on_the_card``); the model's
    ``backend="plain"`` runs the plain version there, launching nothing,
    and the default runs the kernel."""
    from prosper_tpu_torch.models import GSC
    from prosper_tpu_torch.models.base import (device_sched, pattern_of,
                                               sched_floats)
    from prosper_tpu_torch.engine.anneal import LinearAnnealing
    y, w, W, s2, pi, mu, psi, sa, Hp = _gsc_inputs(GSC_CASES[3], device)
    rest = (s2, pi, mu, psi, sa, Hp, 1.0, 1.0)
    with pytest.raises(ValueError):
        gsc_cuda.gsc_et_estep_cuda(y.cpu(), w.cpu(), W.cpu(), *rest)
    with pytest.raises(ValueError):
        gsc_cuda.gsc_et_estep_cuda(y, w[:-1], W, *rest)
    with pytest.raises(ValueError):
        gsc_cuda.gsc_et_estep_cuda(y, w, W[:-1], *rest)
    wide = etstep.state_arrays_from(binary_state_space(9, 3), device)
    tall = etstep.state_arrays_from(binary_state_space(6, 5), device)
    before = dict(cuda_lib.LAUNCHES)
    for sa_x, Hp_x in ((wide, 9), (tall, 6)):
        for estep in (gsc_cuda.gsc_et_estep_cuda, gsc_cuda.gsc_et_estep):
            with pytest.raises(ValueError, match='backend="plain"'):
                estep(y, w, W, s2, pi, mu, psi, sa_x, Hp_x, 1.0, 1.0)
    assert dict(cuda_lib.LAUNCHES) == before
    sched = device_sched(sched_floats(LinearAnnealing(2)), device)
    params = {"W": W, "sigma": torch.sqrt(s2), "pi": pi, "mu": mu,
              "psi": psi}
    H, D = W.shape[1], W.shape[0]
    for Hp_x, gamma in ((9, 3), (6, 5)):
        with pytest.raises(ValueError, match='backend="plain"'):
            GSC(D, H, Hp_x, gamma).estep_sums(params, y, w, sched)
        got = GSC(D, H, Hp_x, gamma, backend="plain").estep_sums(
            params, y, w, sched)
        want = gscstep.gsc_et_estep(
            y, w, W, params["sigma"] ** 2, pi, mu, psi,
            etstep.state_arrays_from(binary_state_space(Hp_x, gamma),
                                     device), Hp_x, sched["beta"],
            sched["prior_beta"], chunk=4096,
            collect_true=not pattern_of(sched).saturated)
        assert dict(cuda_lib.LAUNCHES) == before
        assert torch.equal(got[0], want[0])
        for k in want[1]:
            assert torch.equal(got[1][k], want[1][k]), k
    GSC(D, H, 5, 3).estep_sums(params, y, w, sched)
    torch.cuda.synchronize()
    assert {k: cuda_lib.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k in ("gsc_estep", "sgemm_nn", "sgemm_tn")) for k in before}


def test_gsc_rows_span_times_the_kernel(device):
    """With the spans on, GSC's captured steps time the ``gsc_rows`` region
    (the kernel) inside the E-step; the plain version's ``slab_solve`` and
    ``slab_moments`` regions do not run on the card."""
    from prosper_tpu_torch import EM
    from prosper_tpu_torch.io import tracing
    y = _plain_data("gsc", 4096)
    off, on = (EM(_plain_models()["gsc"](), _scan_anneal(), {"y": y}, seed=7,
                  device=device) for _ in range(2))
    off.run_scanned()
    tracing.enable(True)
    try:
        on.run_scanned()
    finally:
        tracing.enable(False)
    _assert_same_run(on, off)
    layer_ms = on.scan_stats["layer_ms"]
    assert set(layer_ms) == {"estep", "ncut", "mstep", "gsc_rows"}
    assert 0 < layer_ms["gsc_rows"] < layer_ms["estep"]


# -- GSC and the mixtures on the card: GSC's E-step kernel, the rest plain -----

def _plain_models():
    from prosper_tpu_torch.models import GSC
    from prosper_tpu_torch.models.mixtures import MoG, MoP
    return {"gsc": lambda: GSC(25, 12, 6, 3, chunk=256),
            "mog": lambda: MoG(25, 6), "mop": lambda: MoP(25, 6)}


def _plain_data(name, N, seed=3):
    y = _scan_data(name, N, seed)
    return np.abs(np.floor(y)) if name == "mop" else y


@pytest.mark.parametrize("name", ["gsc", "mog", "mop"])
def test_plain_model_step_on_the_card_matches_the_cpu(name, device):
    """One noise-free annealed step on the card against the CPU: parameters
    and F within rtol 1e-4 (float32 on both, summed in other orders; GSC's
    small Cholesky factors differ in the last bits); GSC's decode too.
    GSC's step launches its E-step kernel and the two GEMMs once each (its
    decode is plain PyTorch); the mixtures launch no kernel of the port."""
    from prosper_tpu_torch import LinearAnnealing
    from prosper_tpu_torch.io.weights import params_from_numpy
    from prosper_tpu_torch.models.base import make_blank_data, sched_floats
    model = _plain_models()[name]()
    y = _plain_data(name, 512)
    p0 = {k: v.numpy() for k, v in
          model.standard_init({"y": y}, seed=2, device="cpu").items()}
    if name == "gsc":
        p0.update(mu=np.float32(0.5), psi=np.float32(0.6),
                  pi=np.float32(0.2))
    a = LinearAnnealing(4)
    a["T"] = 1.5
    before = dict(cuda_lib.LAUNCHES)
    out = {d: model.step_fn(params_from_numpy(p0, d),
                            make_blank_data(y, device=d), sched_floats(a),
                            torch.Generator(device=d))
           for d in ("cpu", device)}
    for k, v in out["cpu"][0].items():
        torch.testing.assert_close(out[device][0][k].cpu(), v, rtol=1e-4,
                                   atol=1e-5, msg=k)
    torch.testing.assert_close(out[device][1].cpu(), out["cpu"][1],
                               rtol=1e-4, atol=1e-4)
    for k, v in out["cpu"][2].items():
        assert float(out[device][2][k]) == pytest.approx(float(v), rel=1e-4)
    if name == "gsc":
        dec = {d: model.inference(params_from_numpy(p0, d), {"y": y},
                                  top_L=5) for d in ("cpu", device)}
        for k in ("F", "b_mean", "s_mean", "recon", "top_probs"):
            torch.testing.assert_close(dec[device][k].cpu(), dec["cpu"][k],
                                       rtol=1e-4, atol=1e-5, msg=k)
    torch.cuda.synchronize()
    mine = ("gsc_estep", "sgemm_nn", "sgemm_tn") if name == "gsc" else ()
    assert dict(cuda_lib.LAUNCHES) == {
        k: v + (k in mine) for k, v in before.items()}


@pytest.mark.parametrize("name", ["gsc", "mog", "mop"])
def test_plain_model_run_scanned_is_bit_identical_to_run(name, device):
    """Graph replays against eager ``run`` for GSC, MoG and MoP: parameters,
    F_prev, every scalar and the generator's next draw; three patterns, two
    captured; GSC's eager steps and captures pass its E-step's launch sites
    (the kernel and its two GEMMs) and its replays hold them; the mixtures
    launch no kernel of the port."""
    from prosper_tpu_torch import EM
    y = _plain_data(name, 777)
    make = _plain_models()[name]
    model = make()
    ref, em = (EM(model, _scan_anneal(), {"y": y}, seed=7, device=device)
               for _ in range(2))
    before = dict(cuda_lib.LAUNCHES)
    ref.run()
    em.run_scanned()
    torch.cuda.synchronize()
    _assert_same_run(em, ref)
    stats = em.scan_stats
    assert (stats["graphs"], stats["eager_steps"], stats["replays"]) == (
        2, 3, 5)
    mine = ("gsc_estep", "sgemm_nn", "sgemm_tn") if name == "gsc" else ()
    assert stats["replayed_launches"] == {k: 5 for k in mine}
    assert dict(cuda_lib.LAUNCHES) == {
        k: v + 8 * (k in mine) + (3 + 2) * (k in mine)
        for k, v in before.items()}
    assert all(torch.isfinite(v).all() for v in em.params.values())


# -- checkpoints, resume, the recovery protocol and the CLI on the card -------

def _resume_anneal(steps=10):
    from prosper_tpu_torch import LinearAnnealing
    a = LinearAnnealing(steps)
    a["T"] = [(0.0, 2.0), (0.5, 1.0)]
    a["W_noise"] = [(0.0, 0.5), (0.5, 0.0)]
    a["Ncut_factor"] = [(0.5, 0.0), (1.0, 1.0)]
    return a


@pytest.mark.parametrize("loop", ["run", "scanned"])
def test_resume_on_the_card_equals_uninterrupted(loop, device, tmp_path):
    """BSC through the kernels with revival every 3: interrupted at 4 (a
    checkpoint between two revivals), resumed into a fresh EM with another
    seed; parameters, F_prev, every scalar and the generator's next draw
    bit-identical to the uninterrupted run (the kernel path is
    deterministic on the card)."""
    from prosper_tpu_torch import EM
    make = _scan_models()["bsc"]
    y = _scan_data("bsc", 777)
    kw = dict(device=device, revive_duplicates=(3, 0.5, 1.0))
    go = (lambda em: em.run()) if loop == "run" else (
        lambda em: em.run_scanned())
    ref = EM(make(), _resume_anneal(), {"y": y}, seed=7, **kw)
    go(ref)
    ckpt = str(tmp_path / "c.h5")
    em = EM(make(), _resume_anneal(), {"y": y}, seed=7, checkpoint_path=ckpt,
            checkpoint_every=4, **kw)
    if loop == "run":
        for _ in range(4):
            em.step_once()
    else:
        em.run_scanned(4)
    assert em.revival_stats["revived"] > 0
    fresh = EM(make(), _resume_anneal(), {"y": y}, seed=1, **kw)
    assert fresh.resume(ckpt) == 4
    go(fresh)
    ref.history = ref.history[4:]
    _assert_same_run(fresh, ref)
    np.testing.assert_array_equal(fresh.revival_rng_state(),
                                  ref.revival_rng_state())


def test_collect_params_on_the_card_logs_what_run_logs(device, tmp_path):
    from prosper_tpu_torch import EM
    from prosper_tpu_torch.io import hdf5
    from prosper_tpu_torch.io.datalog import DataLog, StoreToH5
    files = []
    for collect in (None, True):
        log = DataLog()
        files.append(str(tmp_path / f"{collect}.h5"))
        log.set_handler(("W", "pi", "F_mean"), StoreToH5, files[-1])
        em = EM(_scan_models()["bsc"](), _resume_anneal(),
                {"y": _scan_data("bsc", 512)}, seed=7, device=device,
                dlog=log, log_params_every=3)
        em.run() if collect is None else em.run_scanned(collect_params=True)
        log.close()
    with hdf5.File(files[0]) as a, hdf5.File(files[1]) as b:
        assert a["W"].shape[0] == 4 and set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))


@pytest.mark.parametrize("branch", ["coact", "symmetric", "dead_worst"])
def test_revival_on_the_card_equals_the_cpu(branch, device):
    """One ``_maybe_revive_duplicates`` on a CUDA EM and on a CPU EM built
    from the same params, data, F_prev and seed: the same W, bit for bit."""
    from prosper_tpu_torch import EM, LinearAnnealing
    from prosper_tpu_torch.data.bars import bars_gt_params
    from prosper_tpu_torch.models import BSC
    model = BSC(25, 10, 6, 3)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    data = model.generate_data(gt, 1500, seed=3)
    W0 = np.asarray(gt["W"]).copy()
    W0[:, 8] = gt["W"][:, 8] + gt["W"][:, 9]
    W0[:, 9] = gt["W"][:, 0]
    W0[:, 3] = 1e-4
    opts = {"coact": dict(split_norm_frac=1.25, split_coact=True),
            "symmetric": dict(split_norm_frac=1.25),
            "dead_worst": dict(reseed_worst_frac=0.1)}[branch]
    feed = {"y": data["y"], "F_prev": np.random.default_rng(5)
            .standard_normal(1500).astype(np.float32)}
    ems = [EM(model, LinearAnnealing(4), dict(feed),
              params={"W": W0, "pi": np.float32(0.2),
                      "sigma": np.float32(1.0)}, seed=9, device=d,
              revive_duplicates=(1, 0.9, 1.0, 0.1), **opts)
           for d in (device, "cpu")]
    for em in ems:
        em.anneal.next()
        em._maybe_revive_duplicates()
    assert torch.equal(ems[0].params["W"].cpu(), ems[1].params["W"])
    assert ems[0].revival_stats == ems[1].revival_stats
    assert ems[0].revival_stats["revived"] >= 2
    np.testing.assert_array_equal(ems[0].revival_rng_state(),
                                  ems[1].revival_rng_state())


def test_card_checkpoint_restores_on_the_card(device, tmp_path):
    """The CUDA generator's state goes to ``torch_rng`` marked cuda and
    comes back on the card; on the CPU there is no state for it, and
    ``EM.resume`` warns that the noise chain restarts from the seed."""
    from prosper_tpu_torch import EM
    from prosper_tpu_torch.io import checkpoint, hdf5
    em = EM(_scan_models()["bsc"](), _resume_anneal(),
            {"y": _scan_data("bsc", 512)}, seed=7, device=device)
    em.run_scanned(3)
    path = str(tmp_path / "c.h5")
    em.save_checkpoint(path)
    with hdf5.File(path) as f:
        assert f["torch_rng"].attrs["device_type"] == "cuda"
    params, step, state, _ = checkpoint.restore_full(path, device)
    assert step == 3 and params["W"].device.type == "cuda"
    assert torch.equal(state, em.generator.get_state())
    assert checkpoint.restore_full(path, "cpu")[2] is None
    cpu = EM(_scan_models()["bsc"](), _resume_anneal(),
             {"y": _scan_data("bsc", 512)}, seed=7, device="cpu")
    with pytest.warns(RuntimeWarning, match="restart from the seed"):
        assert cpu.resume(path) == 3


def _cli_config(tmp_path):
    import json
    from prosper_tpu_torch.data.bars import planted_dictionary
    cfg = {"model": {"type": "bsc", "D": 64, "H": 40, "Hprime": 6,
                     "gamma": 3, "chunk": 1024},
           "anneal": {"steps": 5, "T": [[0.0, 2.0], [0.6, 1.0]],
                      "W_noise": [[0.0, 0.3], [0.6, 0.0]]},
           "gt_params": {"W": planted_dictionary(64, 40).tolist(),
                         "pi": 0.05, "sigma": 1.0},
           "N": 4096, "seed": 3, "checkpoint_every": 2}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("scan", [False, True], ids=["run", "scan"])
def test_cli_train_and_infer_on_the_card_launch_the_kernels(scan, device,
                                                            tmp_path):
    from prosper_tpu_torch import cli
    cfg = _cli_config(tmp_path)
    out, data = str(tmp_path / "run"), str(tmp_path / "d.h5")
    assert cli.main(["generate", cfg, "-N", "4096", "-o", data]) == 0
    for k in cuda_lib.LAUNCHES:
        cuda_lib.LAUNCHES[k] = 0
    assert cli.main(["train", cfg, "--data", data, "-o", out, "-q"]
                    + (["--scan"] if scan else [])) == 0
    torch.cuda.synchronize()
    got = dict(cuda_lib.LAUNCHES)
    # run: one E-step an iteration; --scan: the eager first steps and the
    # captures of its patterns pass the launch sites, the replays do not
    if not scan:
        assert got["estep"] == 5
    assert got["estep"] >= 1
    assert got["sgemm_nn"] == got["sgemm_tn"] == got["estep"]
    for k in cuda_lib.LAUNCHES:
        cuda_lib.LAUNCHES[k] = 0
    assert cli.main(["infer", cfg, "-c", f"{out}/checkpoint.h5", "--data",
                     data, "-o", str(tmp_path / "i.h5")]) == 0
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == {
        "decode": 1, "sgemm_nn": 1}


def test_cli_device_cpu_launches_no_kernel(device, tmp_path):
    from prosper_tpu_torch import cli
    cfg = _cli_config(tmp_path)
    out, data = str(tmp_path / "run"), str(tmp_path / "d.h5")
    assert cli.main(["generate", cfg, "-N", "4096", "-o", data]) == 0
    for k in cuda_lib.LAUNCHES:
        cuda_lib.LAUNCHES[k] = 0
    assert cli.main(["train", cfg, "--data", data, "-o", out, "-q", "--scan",
                     "--device", "cpu"]) == 0
    assert cli.main(["infer", cfg, "-c", f"{out}/checkpoint.h5", "--data",
                     data, "-o", str(tmp_path / "i.h5"), "--device",
                     "cpu"]) == 0
    assert not any(cuda_lib.LAUNCHES.values())


# -- streaming: segments on a copy stream ----------------------------------------

def _stream_runs(name, y, device, **kw):
    """A StreamingEM of ``name`` over ``y`` (segments of one 256-row chunk)
    through the 8 iterations of ``_scan_anneal``, run to its end."""
    from prosper_tpu_torch import StreamingEM
    sem = StreamingEM(_scan_models()[name](), _scan_anneal(), y, seg_size=256,
                      seed=7, device=device,
                      params=_scan_models()[name]().standard_init(
                          {"y": y}, seed=3, device=device), **kw)
    sem.run()
    return sem


def _assert_same_stream(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert torch.equal(a.F_prev, b.F_prev)
    assert [{k: v for k, v in h.items() if k != "dt"} for h in a.history] \
        == [{k: v for k, v in h.items() if k != "dt"} for h in b.history]
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("how", ["ndarray", "memmap", "slow_host",
                                 "slow_compute"])
def test_streaming_rolling_equals_cached_on_the_card(how, device, tmp_path,
                                                     monkeypatch):
    """The rolling tier (two device buffers in turn, uploads on a copy
    stream) against the cached tier, bit for bit: from a page-locked
    ndarray, from a memmap through the pinned staging buffers, with the
    host made slow (a sleeping segment reader: the staging buffers' guard)
    and with the compute made slow (a sleep on the compute stream before
    each E-step: without the write-after-read guard the copy stream would
    overwrite a buffer that an E-step still reads)."""
    from prosper_tpu_torch.utils.staging import SegmentUploader
    y = _scan_data("bsc", 777)
    cached = _stream_runs("bsc", y, device)
    assert cached.n_seg == 4
    assert cached._cache_all and cached.uploader.stats["segments"] == 4
    if how in ("memmap", "slow_host"):
        path = str(tmp_path / "y.f32")
        mm = np.memmap(path, np.float32, "w+", shape=y.shape)
        mm[:] = y
        mm.flush()
        y = np.memmap(path, np.float32, "r", shape=y.shape)
    if how == "slow_host":
        real_fill = SegmentUploader._fill

        def slow_fill(self, out, lo, hi):
            time.sleep(0.02)
            real_fill(self, out, lo, hi)
        monkeypatch.setattr(SegmentUploader, "_fill", slow_fill)
    if how == "slow_compute":
        from prosper_tpu_torch.models import BSC
        real_estep = BSC.estep_sums

        def slow_estep(self, *a, **kw):
            torch.cuda._sleep(20_000_000)          # ~10 ms on the stream
            return real_estep(self, *a, **kw)
        monkeypatch.setattr(BSC, "estep_sums", slow_estep)
    rolling = _stream_runs("bsc", y, device, cache_bytes=0)
    assert not rolling._cache_all
    assert rolling.uploader.stats["segments"] == 4 * 8
    assert rolling.uploader.stats["registered"] == (
        how in ("ndarray", "slow_compute"))
    _assert_same_stream(rolling, cached)


@pytest.mark.parametrize("name", ["bsc", "mca", "tsc_bigs", "gsc"])
def test_streaming_launches_the_kernels_once_a_segment(name, device):
    """Each streamed E-step launches its kernel once a segment (the
    linear, max and GSC ones with their two GEMMs), and the run follows the
    in-memory EM: the same kept counts, the parameters within the
    tolerance of tests/test_streaming.py."""
    from prosper_tpu_torch import EM
    y = _scan_data(name, 777)
    for k in cuda_lib.LAUNCHES:
        cuda_lib.LAUNCHES[k] = 0
    sem = _stream_runs(name, y, device, cache_bytes=0)
    torch.cuda.synchronize()
    per_pass = sem.n_seg * 8
    mine = ({"bigs"} if name == "tsc_bigs" else
            {{"bsc": "estep", "mca": "max_estep", "gsc": "gsc_estep"}[name],
             "sgemm_nn", "sgemm_tn"})
    assert dict(cuda_lib.LAUNCHES) == {k: per_pass if k in mine else 0
                                       for k in cuda_lib.LAUNCHES}
    em = EM(_scan_models()[name](), _scan_anneal(), {"y": y}, seed=7,
            device=device, params=_scan_models()[name]().standard_init(
                {"y": y}, seed=3, device=device))
    em.run()
    assert [h["n_used"] for h in sem.history] == \
        [h["n_used"] for h in em.history]
    for k in em.params:
        torch.testing.assert_close(sem.params[k], em.params[k], rtol=5e-4,
                                   atol=1e-4, msg=k)


def test_streaming_resume_on_the_card(device, tmp_path):
    from prosper_tpu_torch import StreamingEM
    y = _scan_data("bsc", 777)
    full = _stream_runs("bsc", y, device, cache_bytes=0)
    ck = str(tmp_path / "c.h5")
    model = _scan_models()["bsc"]()
    p0 = model.standard_init({"y": y}, seed=3, device=device)
    a = StreamingEM(model, _scan_anneal(), y, seg_size=256, seed=7,
                    device=device, params=p0, cache_bytes=0,
                    checkpoint_path=ck, checkpoint_every=3)
    for _ in range(4):
        a.step_once()
    a.close()
    b = StreamingEM(model, _scan_anneal(), y, seg_size=256, seed=1,
                    device=device, params=p0, cache_bytes=0)
    assert b.resume(ck) == 3
    b.run()
    for k in full.params:
        assert torch.equal(full.params[k], b.params[k]), k
    assert torch.equal(full.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("name", ["bsc", "mca"])
def test_inference_from_numpy_equals_from_the_card(name, device):
    """``inference`` on a numpy y (staged through pinned memory) gives
    what it gives on the same rows already on the card."""
    model = _scan_models()[name]()
    y = _scan_data(name, 513)
    params = model.standard_init({"y": y}, seed=3, device=device)
    a = model.inference(params, {"y": y}, top_L=4)
    b = model.inference(params, {"y": torch.as_tensor(y, device=device)},
                        top_L=4)
    torch.cuda.synchronize()
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- the data-parallel runtime at one rank: NCCL, and gloo on the card --------

@pytest.fixture(scope="module")
def nccl_rt(tmp_path_factory):
    """A MeshRuntime over a one-rank NCCL group on the card (a file store):
    the collectives are issued, and a one-rank all-reduce keeps every
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from prosper_tpu_torch.parallel.mesh import MeshRuntime
    store = tmp_path_factory.mktemp("nccl") / "store"
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield MeshRuntime(device="cuda:0")
    dist.destroy_process_group()


def _runtime_pair(name, rt, N=777, anneal=_scan_anneal, **kw):
    """(EM without a runtime, EM under ``rt``) from one seed and init."""
    from prosper_tpu_torch import EM
    y = _scan_data(name, N)
    make = _scan_models()[name]
    model = make()
    p0 = model.standard_init({"y": y}, seed=3, device="cuda")
    return (EM(model, anneal(), {"y": y}, params=p0, seed=7, device="cuda",
               **kw),
            EM(model, anneal(), {"y": y}, params=p0, seed=7, runtime=rt,
               **kw))


@pytest.mark.parametrize("name", ["bsc", "mca", "tsc_bigs", "gsc"])
def test_one_nccl_rank_run_is_bit_identical_to_run(name, device, nccl_rt):
    from prosper_tpu_torch.parallel.mesh import COLLECTIVES
    ref, em = _runtime_pair(name, nccl_rt)
    ref.run()
    before = COLLECTIVES["all_reduce"]
    em.run()
    torch.cuda.synchronize()
    _assert_same_run(em, ref)
    # the sums and N_total every step (1), the Ncut cut's n_sel, extent and
    # three histograms on the 5 iterations with it (5 more)
    assert COLLECTIVES["all_reduce"] - before == 8 + 5 * 5


@pytest.mark.parametrize("name", ["bsc", "mca", "tsc_bigs", "gsc"])
def test_one_nccl_rank_run_scanned_captures_the_collectives(name, device,
                                                            nccl_rt):
    """``run_scanned`` under NCCL: the all-reduces are captured with the
    step, and the replays equal ``run`` without a runtime bit for bit."""
    ref, em = _runtime_pair(name, nccl_rt)
    ref.run()
    em.run_scanned()
    torch.cuda.synchronize()
    _assert_same_run(em, ref)
    stats = em.scan_stats
    assert (stats["graphs"], stats["eager_steps"], stats["replays"]) == (
        2, 3, 5)
    # replays 1-2 of the annealed pattern (1 each), 3 of the cut (6 each)
    assert stats["replayed_all_reduces"] == 2 * 1 + 3 * 6


def test_one_nccl_rank_partial_revival_streaming_and_decode(device, nccl_rt):
    from prosper_tpu_torch import StreamingEM
    ref, em = _runtime_pair("bsc", nccl_rt,
                            anneal=lambda: _scan_anneal(partial=True),
                            revive_duplicates=(2, 0.3))
    ref.run()
    em.run()
    _assert_same_run(em, ref)
    assert em.revival_stats == ref.revival_stats
    assert ref.revival_stats["revived"] > 0
    model = _scan_models()["bsc"]()
    y = _scan_data("bsc", 768)
    p0 = model.standard_init({"y": y}, seed=3, device="cuda")
    a = StreamingEM(model, _scan_anneal(), y, seg_size=256, params=p0,
                    seed=7, device="cuda")
    b = StreamingEM(model, _scan_anneal(), y, seg_size=256, params=p0,
                    seed=7, runtime=nccl_rt)
    a.run()
    b.run()
    _assert_same_stream(a, b)
    for dense in (False, True):
        d0 = model.inference(p0, {"y": y}, top_L=4, dense_states=dense)
        d1 = model.inference(p0, {"y": y}, top_L=4, dense_states=dense,
                             runtime=nccl_rt)
        for k in d0:
            assert torch.equal(d0[k], d1[k]), k


def test_gloo_on_the_card_runs_and_refuses_run_scanned(device, nccl_rt):
    """Gloo reduces CUDA tensors (through the host), as two ranks sharing
    one card do; a gloo group cannot be captured, so ``run_scanned`` on the
    card refuses it by name."""
    import torch.distributed as dist

    from prosper_tpu_torch.parallel.mesh import MeshRuntime
    rt = MeshRuntime(group=dist.new_group(backend="gloo"), device="cuda:0")
    assert rt.backend == "gloo" and rt.host_group is rt.group
    ref, em = _runtime_pair("bsc", rt)
    ref.run()
    em.run()
    _assert_same_run(em, ref)
    _, em = _runtime_pair("bsc", rt)
    with pytest.raises(ValueError, match="gloo"):
        em.run_scanned()


# -- state sharding on the card (tests/state_threads.py stands in for the
# state group: n threads, one per state rank, in this process) ---------------


@pytest.mark.parametrize("case,n", [(CASES[1], 2), (CASES[1], 4),
                                    ((500, 16, 8, 3, 2, (1.0,), False), 4)],
                         ids=["tsc_n2", "tsc_n4", "bsc_S3_n4"])
def test_state_slices_through_the_bigs_kernel(case, n, device):
    """Under a state axis the linear E-step runs the big-S kernel on each
    state rank's slice of ``ceil(S / n)`` states, whatever ``s_block`` is:
    F the same bits on every rank and within rtol 1e-4 of the unsharded
    kernel E-step's, the sums added over the ranks within rtol 1e-3 of its
    (phase 11's tolerances of chip_smoke.py); one launch a rank whose slice
    holds a state, none for a slice of padding alone (S = 3 over 4: the
    last), and one cache entry of reduced tables a slice."""
    from state_threads import run_state_shards
    y, w, W, lo, sa, Hp, signed = _inputs(case, device)
    args = (y, w, W, torch.tensor(2.0, device=device), lo, sa, Hp, signed,
            0.6, 1.0)
    F0, s0 = linear_cuda.linear_et_estep(*args, s_block=16)
    S = sa.states.shape[0]
    real = sum(etstep.state_slice(S, n, r)[1] > etstep.state_slice(S, n, r)[0]
               for r in range(n))
    before = cuda_lib.LAUNCHES["bigs"]
    parts, calls = run_state_shards(n, lambda g: linear_cuda.linear_et_estep(
        *args, state_axis=g, n_state_shards=n))
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["bigs"] - before == real
    assert calls == [2] * n
    for F, _ in parts:
        assert torch.equal(F, parts[0][0])
    torch.testing.assert_close(parts[0][0], F0, rtol=1e-4, atol=1e-4)
    for k in s0:
        torch.testing.assert_close(sum(p[1][k] for p in parts), s0[k],
                                   rtol=1e-3, atol=1e-3, msg=k)
    keys = {key[1] for key in utils._PER_TENSOR
            if key[0] == id(sa.states) and isinstance(key[1], tuple)}
    assert {("bigs_tri", n, r) for r in range(n)} <= keys


def test_state_axis_dispatch_rules_on_the_card(device):
    """Under a state axis on the card: MCA and MMCA with ``backend="cuda"``
    raise a ValueError naming ``backend="plain"`` (the kernel needs the
    whole subset lattice) and run with ``backend="plain"``, and so does GSC
    (its kernel needs every support); a linear model past the big-S
    kernel's limits (H' = 16: 155 moment columns) raises the kernel's
    ValueError naming ``backend="plain"``.  Nothing falls back."""
    from prosper_tpu_torch.models import BSC, GSC, MCA, MMCA
    from prosper_tpu_torch.models.base import device_sched, sched_floats
    from prosper_tpu_torch.engine.anneal import LinearAnnealing
    from state_threads import run_state_shards
    sched = device_sched(sched_floats(LinearAnnealing(2)), device)
    y = torch.randn((64, 16), generator=torch.Generator().manual_seed(0))
    for cls in (MCA, MMCA, GSC):
        model = cls(16, 12, 5, 3)
        p = model.standard_init({"y": y}, device=device)
        with pytest.raises(ValueError, match='backend="plain"'):
            run_state_shards(2, lambda g: model.estep_sums(
                p, y.to(device), torch.ones(64, device=device), sched,
                state_axis=g, n_state_shards=2))
        plain = cls(16, 12, 5, 3, backend="plain")
        parts, _ = run_state_shards(2, lambda g: plain.estep_sums(
            p, y.to(device), torch.ones(64, device=device), sched,
            state_axis=g, n_state_shards=2))
        assert torch.isfinite(parts[0][0]).all()
    wide = BSC(16, 20, 16, 2)
    p = wide.standard_init({"y": y}, device=device)
    with pytest.raises(ValueError, match='backend="plain"'):
        run_state_shards(2, lambda g: wide.estep_sums(
            p, y.to(device), torch.ones(64, device=device), sched,
            state_axis=g, n_state_shards=2))


# -- the 16-bit GEMM kernels (compute_dtype) ----------------------------------

HALF = [torch.bfloat16, torch.float16]
HGEMM_SHAPES = sorted({c[:3] for c in CASES}) + [(16385, 256, 300)]


def _rounded(a, dtype):
    return a.to(dtype).double()


@pytest.mark.parametrize("shape", HGEMM_SHAPES, ids=lambda s: "N%dD%dH%d" % s)
@pytest.mark.parametrize("quantised", [True, False], ids=["quarters", "randn"])
@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "fp16"])
def test_hgemm_kernels_match_their_plain_version(shape, quantised, dtype,
                                                 device):
    """Both 16-bit kernels against the float64 product of the rounded
    operands (their plain version in float64), rows of zeros among the
    operands: exact on inputs quantised to 1/4 (exact in either 16-bit
    type, so nothing is rounded and every partial sum is exact), within
    the float32 tolerance otherwise and more than 1e-4 away from the
    product of the unrounded operands; two calls give the same bits; the
    tn kernel's ``accumulate`` adds to ``out``; the split-TF32 counts do
    not move."""
    N, D, H = shape
    rng = np.random.default_rng(N + D + H)
    y, W = _gemm_draw(rng, quantised, device, N, D), _gemm_draw(
        rng, quantised, device, D, H)
    sw, base = _gemm_draw(rng, quantised, device, N, H), _gemm_draw(
        rng, quantised, device, D, H)
    y[:40] = 0.0
    sw[-3:] = 0.0
    before = dict(cuda_lib.LAUNCHES)
    for out, again, ref, exact, depth in (
            (gemm_cuda.hgemm_nn_cuda(y, W, dtype),
             gemm_cuda.hgemm_nn_cuda(y, W, dtype),
             _rounded(y, dtype) @ _rounded(W, dtype),
             y.double() @ W.double(), D),
            (gemm_cuda.hgemm_tn_splitn_cuda(y, sw, dtype),
             gemm_cuda.hgemm_tn_splitn_cuda(y, sw, dtype),
             _rounded(y, dtype).T @ _rounded(sw, dtype),
             y.double().T @ sw.double(), N),
            (gemm_cuda.hgemm_tn_splitn_cuda(y, sw, dtype, out=base.clone(),
                                            accumulate=True),
             gemm_cuda.hgemm_tn_splitn_cuda(y, sw, dtype, out=base.clone(),
                                            accumulate=True),
             base.double() + _rounded(y, dtype).T @ _rounded(sw, dtype),
             base.double() + y.double().T @ sw.double(), N)):
        _exact_or_close(out, again, ref, quantised, depth)
        if not quantised:
            assert ((out.double() - exact).abs().max()
                    > 1e-4 * exact.abs().max())
    counts = {k: cuda_lib.LAUNCHES[k] - before[k] for k in before}
    assert counts == dict({k: 0 for k in before}, hgemm_nn=2, hgemm_tn=4)


@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "fp16"])
def test_hgemm_kernels_round_ties_to_even(dtype, device):
    """Operands halfway between two neighbours of the 16-bit type, and the
    identity for the other operand: each kernel returns its operand rounded
    as ``Tensor.to`` rounds it (to nearest, ties to even), on both sides of
    each product."""
    rng = np.random.default_rng(5)
    n = 96
    lo = torch.as_tensor(rng.standard_normal((n, n)).astype(np.float32),
                         device=device).to(dtype)
    nxt = (lo.view(torch.int16) + 1).view(dtype)    # the next, away from 0
    mid = (lo.float() + nxt.float()) / 2            # exact in float32
    want = mid.to(dtype).float()
    assert not torch.equal(want, mid)
    eye = torch.eye(n, device=device)
    for got in (gemm_cuda.hgemm_nn_cuda(mid, eye, dtype),
                gemm_cuda.hgemm_nn_cuda(eye, mid.T.contiguous(), dtype).T,
                gemm_cuda.hgemm_tn_splitn_cuda(eye, mid, dtype),
                gemm_cuda.hgemm_tn_splitn_cuda(mid.T.contiguous(), eye,
                                               dtype)):
        torch.cuda.synchronize()
        assert torch.equal(got, want)


HTN_SHAPES = sorted({c[:3] for c in CASES}) + [
    (4000 * k + d, 256, 300) for k in (1, 2) for d in (-1, 1)] + [
    (16385, 256, 300), (131072, 256, 300), (4001, 100, 36), (999, 8, 152)]


def _off_alignment(t):
    """A contiguous copy of t whose data start 4 bytes past a 16-byte
    boundary (hgemm_tn_splitn's cp.async kernel then takes it)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("shape", HTN_SHAPES, ids=lambda s: "N%dD%dH%d" % s)
@pytest.mark.parametrize("quantised", [True, False], ids=["quarters", "randn"])
@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "fp16"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off"])
def test_hgemm_tn_kernels_match_their_plain_version(shape, quantised, dtype,
                                                    aligned, device):
    """hgemm_tn_splitn's two kernels against the float64 product of the
    rounded operands, N around the splits' 4000 rows and the slabs' 32:
    the dispatch takes the bulk-copy kernel where the rule says so and the
    cp.async kernel otherwise (operands off their 16-byte alignment, rows
    no multiple of 4 floats); exact on quarter-quantised inputs, within
    the float32 tolerance on Gaussian ones; two calls bit-identical;
    ``accumulate`` adds to ``out``; and the two kernels give the same
    bits."""
    N, D, H = shape
    rng = np.random.default_rng(N + D + H)
    y, sw = (_gemm_draw(rng, quantised, device, N, k) for k in (D, H))
    base = _gemm_draw(rng, quantised, device, D, H)
    y[:40] = 0.0
    sw[-3:] = 0.0
    a = y if aligned else _off_alignment(y)
    want = "bulk" if gemm_cuda.hgemm_tn_bulk(
        D, H, a.data_ptr(), sw.data_ptr()) else "cp_async"
    assert (want == "bulk") == (aligned and D % 4 == 0 and H % 4 == 0)
    before = dict(gemm_cuda.HGEMM_TN_PATHS)
    ref = _rounded(y, dtype).T @ _rounded(sw, dtype)
    tn = gemm_cuda.hgemm_tn_splitn_cuda
    _exact_or_close(tn(a, sw, dtype), tn(a, sw, dtype), ref, quantised, N)
    _exact_or_close(tn(a, sw, dtype, out=base.clone(), accumulate=True),
                    tn(a, sw, dtype, out=base.clone(), accumulate=True),
                    base.double() + ref, quantised, N)
    after = gemm_cuda.HGEMM_TN_PATHS
    assert after[want] - before[want] == 4
    assert sum(after.values()) - sum(before.values()) == 4
    other = _off_alignment(y) if aligned else y
    assert torch.equal(tn(a, sw, dtype), tn(other, sw, dtype))


@pytest.mark.parametrize("PQ", [(256, 300), (300, 256), (100, 36)],
                         ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "fp16"])
def test_hgemm_tn_one_hot_rows_name_every_entry(PQ, dtype, device):
    """P * Q rows in a random order, row (p, q) with one nonzero in y
    (column p) and one in sw (column q): entry (p, q) of the product is the
    product of the two.  Once y's entry names p, once sw's names q (exact
    in the 16-bit type: p % 256 + 1 at bf16), so a wrong offset in the
    kernel's MN-major layouts or its swizzle shows which entry went
    where."""
    P, Q = PQ
    n = P * Q
    g = torch.Generator(device).manual_seed(P + Q)
    rows = torch.randperm(n, device=device, generator=g)
    idx = torch.arange(n, device=device)
    p, q = idx // Q, idx % Q
    cap = 256 if dtype == torch.bfloat16 else n
    before = gemm_cuda.HGEMM_TN_PATHS["bulk"]
    for which, name in (("p", (p % cap + 1).float()),
                        ("q", (q % cap + 1).float())):
        y = torch.zeros(n, P, device=device)
        sw = torch.zeros(n, Q, device=device)
        y[rows, p] = name if which == "p" else 1.0
        sw[rows, q] = name if which == "q" else 1.0
        want = torch.zeros(P, Q, device=device)
        want[p, q] = name
        got = gemm_cuda.hgemm_tn_splitn_cuda(y, sw, dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, want), which
    assert gemm_cuda.HGEMM_TN_PATHS["bulk"] == before + 2


@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "fp16"])
def test_hgemm_tn_cp_async_kernel_rounds_ties_to_even(dtype, device):
    """As test_hgemm_kernels_round_ties_to_even (whose operands take the
    bulk-copy kernel), through the cp.async kernel."""
    rng = np.random.default_rng(6)
    n = 96
    lo = torch.as_tensor(rng.standard_normal((n, n)).astype(np.float32),
                         device=device).to(dtype)
    nxt = (lo.view(torch.int16) + 1).view(dtype)
    mid = (lo.float() + nxt.float()) / 2
    want = mid.to(dtype).float()
    eye = torch.eye(n, device=device)
    before = gemm_cuda.HGEMM_TN_PATHS["cp_async"]
    for got in (gemm_cuda.hgemm_tn_splitn_cuda(_off_alignment(eye), mid,
                                               dtype),
                gemm_cuda.hgemm_tn_splitn_cuda(
                    _off_alignment(mid.T.contiguous()), eye, dtype)):
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert gemm_cuda.HGEMM_TN_PATHS["cp_async"] == before + 2


def test_hgemm_tn_replays_in_a_cuda_graph(device):
    """The bulk-copy kernel's tensor maps are kernel arguments, captured
    with the graph: replays on new inputs copied into the captured ones
    give the bits of eager calls."""
    rng = np.random.default_rng(3)
    y, sw = (_gemm_draw(rng, False, device, 4001, k) for k in (256, 300))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gemm_cuda.hgemm_tn_splitn_cuda(y, sw, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = gemm_cuda.hgemm_tn_splitn_cuda(y, sw, torch.bfloat16)
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        for t in (y, sw):
            t.copy_(_gemm_draw(rng, False, device, *t.shape))
        graph.replay()
        eager = gemm_cuda.hgemm_tn_splitn_cuda(y, sw, torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"H{c[2]}K{len(c[5])}")
@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "fp16"])
def test_estep_kernel_at_a_16_bit_compute_dtype_matches_plain(case, dtype,
                                                              device):
    """The fused E-step at a 16-bit ``compute_dtype``: its two GEMM stages
    are the 16-bit kernels (one launch each, no split-TF32 launch) and it
    matches the plain version at the same ``compute_dtype`` as the float32
    E-step matches its own (y and W quantised: P exact, sw rounded)."""
    y, w, W, lo, sa, Hp, signed = _inputs(case, device)
    args = (y, w, W, torch.tensor(2.5, device=device), lo, sa, Hp, signed,
            0.6, 1.0)
    F0, ref = etstep.linear_et_estep(*args, chunk=y.shape[0],
                                     compute_dtype=dtype)
    before = dict(cuda_lib.LAUNCHES)
    F1, on = linear_cuda.linear_et_estep_cuda(*args, compute_dtype=dtype)
    torch.cuda.synchronize()
    counts = {k: cuda_lib.LAUNCHES[k] - before[k] for k in before}
    assert counts == dict({k: 0 for k in before}, estep=1, hgemm_nn=1,
                          hgemm_tn=1)
    torch.testing.assert_close(F1, F0, rtol=1e-4, atol=1e-4)
    for k in ref:
        torch.testing.assert_close(on[k], ref[k], rtol=1e-3, atol=1e-3,
                                   msg=k)


@pytest.mark.parametrize("path", ["fused", "bigs", "state"])
def test_a_16_bit_cast_reaches_only_the_two_products_on_the_card(path,
                                                                 device):
    """With y = 0 both products are 0 whatever they round, so a bf16 E-step
    equals the float32 one bit for bit unless a cast reached the Gram
    matrix, ||y||^2 or another input of the rows or big-S stages: on the
    fused path, the big-S path and a state axis of 2 (the 16-bit kernels
    launched in each)."""
    from state_threads import run_state_shards
    y, w, W, lo, sa, Hp, signed = _inputs(CASES[1], device)
    W = W + 0.01 * torch.randn(W.shape, device=device,
                               generator=torch.Generator(device).manual_seed(2))
    y = torch.zeros_like(y)
    args = (y, w, W, torch.tensor(2.5, device=device), lo, sa, Hp, signed,
            0.6, 1.0)

    def run(dtype):
        if path == "state":
            return run_state_shards(2, lambda g: linear_cuda.linear_et_estep(
                *args, state_axis=g, n_state_shards=2,
                compute_dtype=dtype))[0][0]
        return linear_cuda.linear_et_estep(
            *args, s_block=16 if path == "bigs" else 0, compute_dtype=dtype)
    before = cuda_lib.LAUNCHES["hgemm_nn"]
    (F16, s16), (F32, s32) = run(torch.bfloat16), run(None)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["hgemm_nn"] > before
    assert torch.equal(F16, F32)
    for k in s32:
        assert torch.equal(s16[k], s32[k]), k
