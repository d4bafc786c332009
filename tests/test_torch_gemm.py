"""The two GEMM wrappers of the port (``ops/gemm_cuda.py``) on CPU tensors,
and the staged form of the E-steps that the CUDA path runs (P = y W, the
per-datapoint stage, then the last product) against the fused plain
versions.

The wrappers are held to numpy float64 at rtol 1e-5 (a float32 product
against a float64 one); the staged form to the fused one at 1e-6: it is the
same arithmetic cut at two products."""

import numpy as np
import pytest
import torch

from prosper_tpu_torch.core import etstep, maxstep
from prosper_tpu_torch.core.states import (binary_state_space,
                                           discrete_state_space)
from prosper_tpu_torch.ops import gemm_cuda

SHAPES = [(1000, 25, 10), (1000, 256, 300), (257, 25, 300), (129, 256, 10),
          (1, 7, 3)]
ids = [f"N{n}D{d}H{h}" for n, d, h in SHAPES]


def _draw(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_sgemm_nn_on_cpu_matches_float64(shape):
    N, D, H = shape
    rng = np.random.default_rng(N + D + H)
    a, b = _draw(rng, N, D), _draw(rng, D, H)
    out = gemm_cuda.sgemm_nn(torch.tensor(a), torch.tensor(b))
    assert out.shape == (N, H) and out.dtype == torch.float32
    ref = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.sqrt(D))


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_sgemm_tn_splitn_on_cpu_matches_float64(shape):
    N, M, K = shape
    rng = np.random.default_rng(N + M + K + 1)
    a, b = _draw(rng, N, M), _draw(rng, N, K)
    a[N // 2] = 0.0                                 # a row that adds nothing
    out = gemm_cuda.sgemm_tn_splitn(torch.tensor(a), torch.tensor(b))
    assert out.shape == (M, K) and out.dtype == torch.float32
    ref = a.astype(np.float64).T @ b.astype(np.float64)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.sqrt(N))


@pytest.mark.parametrize("fn,rows_match", [(gemm_cuda.sgemm_nn, False),
                                           (gemm_cuda.sgemm_tn_splitn, True)],
                         ids=["nn", "tn"])
def test_gemm_wrappers_reject_bad_inputs(fn, rows_match):
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


@pytest.mark.parametrize("fn", [gemm_cuda.sgemm_nn_cuda,
                                gemm_cuda.sgemm_tn_splitn_cuda],
                         ids=["nn", "tn"])
def test_gemm_kernels_reject_cpu_tensors(fn):
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(torch.zeros(8, 4), torch.zeros(8, 4))


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
    P = gemm_cuda.sgemm_nn(y, W)
    F1, sw, sums = etstep.linear_et_estep_rows(y, w, P, *args,
                                               collect_true=collect_true)
    sums["xs"] = gemm_cuda.sgemm_tn_splitn(y, sw)
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
    P = gemm_cuda.sgemm_nn(y, W)
    F1, qsw, sums = maxstep.max_et_estep_rows(y, w, P, *args,
                                              collect_true=collect_true)
    sums["numer"] = sums["numer"] + gemm_cuda.sgemm_tn_splitn(qsw, y)
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
    tn = gemm_cuda.hgemm_tn_splitn
    assert tn(torch.zeros(8, 4), torch.zeros(8, 5), dtype).shape == (4, 5)
    with pytest.raises(ValueError):                 # rows that do not match
        tn(torch.zeros(8, 4), torch.zeros(7, 5), dtype)
    with pytest.raises(ValueError):                 # not float32
        tn(torch.zeros(8, 4).double(), torch.zeros(8, 5).double(), dtype)
    with pytest.raises(ValueError):                 # not contiguous
        tn(torch.zeros(4, 8).T, torch.zeros(8, 5), dtype)
    with pytest.raises(ValueError):                 # an empty operand
        tn(torch.zeros(8, 0), torch.zeros(8, 5), dtype)
    with pytest.raises(ValueError):                 # not a 16-bit type
        tn(torch.zeros(8, 4), torch.zeros(8, 5), torch.float64)
