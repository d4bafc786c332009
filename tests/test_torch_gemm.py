"""The GEMM wrappers' input checks (``ops/gemm_cuda.py``), the shared
refusal of CPU tensors by every kernel wrapper, and the staged form of the
E-steps that the CUDA path runs (P = y W, the per-datapoint stage, then
the last product) against the fused plain versions, at 1e-6: it is the
same arithmetic cut at two products."""

import numpy as np
import pytest
import torch

from prosper_tpu_torch.core import etstep, maxstep
from prosper_tpu_torch.core.states import (binary_state_space,
                                           discrete_state_space)
from prosper_tpu_torch.ops import (bigs_cuda, cuda_lib, gemm_cuda, gsc_cuda,
                                   linear_cuda, max_cuda)


def _draw(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("rows_match", [False, True], ids=["nn", "tn"])
def test_gemm_wrappers_reject_bad_inputs(rows_match):
    def fn(a, b):
        gemm_cuda._check_pair(a, b, rows_match)
    a = torch.zeros(8, 4)
    b = torch.zeros(8, 5) if rows_match else torch.zeros(4, 5)
    fn(a, b)                                        # the good pair passes
    with pytest.raises(ValueError):                 # shapes that do not fit
        fn(a, torch.zeros(3, 5))
    with pytest.raises(ValueError):                 # not float32
        fn(a.double(), b.double())
    with pytest.raises(ValueError):                 # not contiguous
        fn(torch.zeros(4, 8).T, b)
    with pytest.raises(ValueError):                 # not a matrix
        fn(a[0], b)
    with pytest.raises(ValueError):                 # an empty operand
        fn(a[:, :0], b[:0] if not rows_match else b)


_SA = etstep.state_arrays_from(discrete_state_space(5, 3, (1.0,)), "cpu")
_S = _SA.states.shape[0]
_Y, _WEIGHT, _W = torch.zeros(8, 4), torch.ones(8), torch.zeros(4, 6)
_LINEAR = (_Y, _WEIGHT, _W, 1.0, torch.zeros(1), _SA, 5, False, 1.0, 1.0)
#: every kernel wrapper, called on CPU tensors
KERNEL_CALLS = {
    "sgemm_nn": lambda: gemm_cuda.sgemm_nn_cuda(_Y, _W),
    "sgemm_tn": lambda: gemm_cuda.sgemm_tn_splitn_cuda(_Y, _Y),
    "linear_estep": lambda: linear_cuda.linear_et_estep_cuda(*_LINEAR),
    "linear_decode": lambda: linear_cuda.linear_et_decode_cuda(
        _Y, _W, 1.0, torch.zeros(1), _SA, 5, False, 4, 1.0, 1.0),
    "bigs_estep": lambda: bigs_cuda.linear_et_estep_bigs_cuda(*_LINEAR, 16),
    "bigs_multi": lambda: bigs_cuda.bigs_multi_cuda(
        torch.zeros(8, 5), torch.zeros(8, 25), _SA.states, _SA.outer,
        _SA.value_counts, torch.zeros(_S), torch.ones(_S), _SA.abs_states,
        0.5, 1.0, 1.0, 16),
    "max_estep": lambda: max_cuda.max_et_estep_cuda(
        _Y, _WEIGHT, _W, 1.0, torch.tensor(-1.0), _SA, 5, False, 1.0, 1.0),
    "gsc_estep": lambda: gsc_cuda.gsc_et_estep_cuda(
        _Y, _WEIGHT, _W, 1.0, 0.1, 0.0, 1.0, _SA, 5, 1.0, 1.0),
}


@pytest.mark.parametrize("kernel", list(KERNEL_CALLS))
def test_gemm_kernels_reject_cpu_tensors(kernel, monkeypatch):
    """Every kernel wrapper refuses CPU tensors through the shared check
    (``cuda_lib.check_input``), before the library is built or loaded."""
    def no_build():
        raise AssertionError("the library was built for a CPU tensor")
    monkeypatch.setattr(cuda_lib, "_build", no_build)
    monkeypatch.setattr(cuda_lib, "_lib", None)
    with pytest.raises(ValueError, match="the CUDA kernels take CUDA tensors"):
        KERNEL_CALLS[kernel]()


def _weights(rng, N):
    w = (rng.random(N) > 0.2).astype(np.float32)
    w[:5] = 0.0
    return torch.tensor(w)


@pytest.mark.parametrize("values,signed", [((1.0,), False),
                                           ((-1.0, 1.0), True),
                                           ((-1.0, 1.0, 2.0), True)],
                         ids=["bsc", "tsc", "dsc"])
@pytest.mark.parametrize("beta,collect_true", [(0.6, True), (1.0, True),
                                               (1.0, False)])
def test_linear_estep_staged_equals_fused(values, signed, beta, collect_true):
    """P by sgemm_nn, the rows stage, xs by sgemm_tn_splitn: the E-step."""
    N, D, H, Hp, gamma = 203, 25, 12, 6, 3
    rng = np.random.default_rng(len(values))
    y, W = torch.tensor(_draw(rng, N, D) * 1.5), torch.tensor(_draw(rng, D, H))
    w = _weights(rng, N)
    K = len(values)
    lo = torch.full((K,), float(np.log(0.2 / K / 0.8)))
    sa = etstep.state_arrays_from(discrete_state_space(Hp, gamma, values),
                                  "cpu")
    args = (W, torch.tensor(1.3), lo, sa, Hp, signed, beta, 1.0)
    F0, ref = etstep.linear_et_estep(y, w, *args, chunk=N,
                                     collect_true=collect_true)
    P = torch.matmul(y, W)
    F1, sw, sums = etstep.linear_et_estep_rows(y, w, P, *args,
                                               collect_true=collect_true)
    sums["xs"] = torch.matmul(y.T, sw)
    assert sw.shape == (N, H) and (sw[:5] == 0).all()
    torch.testing.assert_close(F1, F0, rtol=1e-6, atol=1e-6)
    assert set(sums) == set(ref)
    for k in ref:
        torch.testing.assert_close(sums[k], ref[k], rtol=1e-6, atol=1e-6,
                                   msg=k)


@pytest.mark.parametrize("magnitude", [False, True], ids=["mca", "mmca"])
@pytest.mark.parametrize("beta,collect_true", [(0.6, True), (1.0, True),
                                               (1.0, False)])
def test_max_estep_staged_equals_fused(magnitude, beta, collect_true):
    """P by sgemm_nn, the rows stage, numer += SQ^T y by sgemm_tn_splitn."""
    N, D, H, Hp, gamma = 150, 16, 10, 6, 3
    rng = np.random.default_rng(3 + magnitude)
    Wn = _draw(rng, D, H) * 2
    y, W = torch.tensor(_draw(rng, N, D) * 2), torch.tensor(
        Wn if magnitude else np.abs(Wn))
    w = _weights(rng, N)
    lo = torch.tensor(float(np.log(2.0 / H) - np.log1p(-2.0 / H)))
    sa = etstep.state_arrays_from(binary_state_space(Hp, gamma), "cpu")
    args = (W, torch.tensor(1.3), lo, sa, Hp, magnitude, beta, 1.0)
    F0, ref = maxstep.max_et_estep(y, w, *args, chunk=N,
                                   collect_true=collect_true)
    P = torch.matmul(y, W)
    F1, qsw, sums = maxstep.max_et_estep_rows(y, w, P, *args,
                                              collect_true=collect_true)
    sums["numer"] = sums["numer"] + torch.matmul(qsw.T, y)
    assert qsw.shape == (N, H) and (qsw[:5] == 0).all()
    torch.testing.assert_close(F1, F0, rtol=1e-6, atol=1e-6)
    assert set(sums) == set(ref)
    for k in ref:
        torch.testing.assert_close(sums[k], ref[k], rtol=1e-6, atol=1e-6,
                                   msg=k)


# -- hgemm_tn_splitn's two kernels ---------------------------------------------

@pytest.mark.parametrize("M,K,a_off,b_off,bulk", [
    (256, 300, 0, 0, True),        # the patches width
    (300, 256, 0, 0, True),        # the max family's orientation
    (4, 8, 0, 0, True),
    (25, 300, 0, 0, False),        # a row of A is no multiple of 16 bytes
    (256, 10, 0, 0, False),        # nor of B
    (256, 300, 4, 0, False),       # A 4 bytes past a 16-byte boundary
    (256, 300, 0, 8, False),       # B 8 bytes past
    (256, 300, 16, 32, True),      # whole 16-byte steps
], ids=lambda v: str(v))
def test_hgemm_tn_dispatch_rule_is_a_function_of_shapes_and_pointers(
        M, K, a_off, b_off, bulk):
    """The bulk-copy kernel takes a (N, M) and b (N, K) whose row segments
    are whole 16-byte pieces on 16-byte boundaries; everything else goes to
    the cp.async kernel, whatever N is."""
    base = 1 << 20
    for N in (1, 1000, 131072):
        assert gemm_cuda.hgemm_tn_bulk(M, K, base + a_off,
                                       base + b_off) is bulk, N


@pytest.mark.parametrize("N", [1, 31, 32, 255, 256, 999, 4001, 33791, 33792,
                               131071, 131072, 131073, 10 ** 6])
def test_split_rows_are_whole_slabs_of_the_bulk_kernel(N):
    """The splits of N depend on N alone, cover [0, N) once, and each is a
    whole number of the bulk-copy kernel's slabs (only the last split of N
    may end inside a slab, where the kernel writes zeros past N)."""
    rows = gemm_cuda.split_rows(N)
    assert rows == gemm_cuda.split_rows(N)
    assert rows % gemm_cuda.HTN_SLAB_ROWS == 0
    bounds = [(z * rows, min(N, (z + 1) * rows))
              for z in range(-(-N // rows))]
    assert bounds[0][0] == 0 and bounds[-1][1] == N
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(lo < hi for lo, hi in bounds)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_hgemm_kernels_reject_cpu_tensors_and_bad_shapes(dtype):
    for fn, b in ((gemm_cuda.hgemm_tn_splitn_cuda, torch.zeros(8, 4)),
                  (gemm_cuda.hgemm_nn_cuda, torch.zeros(4, 5))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(torch.zeros(8, 4), b, dtype)
        with pytest.raises(ValueError, match="bfloat16"):   # not 16-bit
            fn(torch.zeros(8, 4), b, torch.float64)
    tn = gemm_cuda._check_pair                      # their shape checks
    tn(torch.zeros(8, 4), torch.zeros(8, 5), True)
    with pytest.raises(ValueError):                 # rows that do not match
        tn(torch.zeros(8, 4), torch.zeros(7, 5), True)
    with pytest.raises(ValueError):                 # not float32
        tn(torch.zeros(8, 4).to(dtype), torch.zeros(8, 5).to(dtype), True)
    with pytest.raises(ValueError):                 # not contiguous
        tn(torch.zeros(4, 8).T, torch.zeros(8, 5), True)
    with pytest.raises(ValueError):                 # an empty operand
        tn(torch.zeros(8, 0), torch.zeros(8, 5), True)
