"""The numerical contract of the port's two GEMM kernels (``csrc/sgemm.cu``),
emulated in plain torch on the CPU.

On the card ``sgemm_nn`` and ``sgemm_tn_splitn`` run as split-TF32 products:
each float32 operand x is cut into hi = x rounded to TF32 and lo = x - hi
rounded to TF32 (to nearest, ties away from zero, as ``cvt.rna.tf32.f32``
rounds), and a product is a_hi b_hi + a_hi b_lo + a_lo b_hi (a_lo b_lo
dropped).  Here the rounding is done with integer operations on the bit
patterns, as the kernels do it, and the three products are formed in float64
and rounded to float32 once: the tests show that the split itself keeps the
float32 tolerance the card tests hold the kernels to (rtol 1e-5, atol 2e-7
per unit of depth, against float64, on the card tests' own Gaussian shapes
and seeds), that it is exact on inputs quantised to multiples of 1/4, and
that hi + lo holds x to 2^-22 relative.  The tensor cores' own rounding of
their sums is what the card tests (``tests/test_torch_cuda.py``) add."""

import numpy as np
import pytest
import torch

# the shapes of tests/test_torch_cuda.py::test_gemm_kernels_match_float64
GEMM_SHAPES = [(131072, 256, 300)] + [(N, D, H) for N in (1000, 16385)
                                      for D in (25, 256) for H in (10, 300)]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero: 0x1000 added to the bit pattern, the low 13
    bits cleared (sign and magnitude apart, so the magnitude rounds)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    return ((u ^ 0x80000000) - 0x80000000).to(torch.int32).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo), both TF32, hi + lo = x to 2^-22 relative."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels form it from the split: the three TF32
    products, summed in float64, rounded to float32."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    return (ah @ bl + al @ bh + ah @ bh).float()


def _draw(rng, shape, quantised):
    a = rng.standard_normal(shape)
    a = np.round(a * 4) / 4 if quantised else a
    return torch.as_tensor(a.astype(np.float32))


def _low_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) & 0x1FFF


def test_tf32_rounding_to_nearest_ties_away_from_zero():
    one = 0x3F800000                      # 1.0: the TF32 ulp is 2^-10
    for low, up in ((0x0FFF, False), (0x1000, True), (0x1001, True),
                    (0x0001, False), (0x1FFF, True)):
        for sign in (0, -0x80000000):
            bits = torch.tensor([one + low + sign], dtype=torch.int32)
            got = tf32_rna(bits.view(torch.float32))
            want = torch.tensor([one + (0x2000 if up else 0) + sign],
                                dtype=torch.int32).view(torch.float32)
            assert torch.equal(got, want), (hex(low), sign)
    # the carry into the exponent: just below 2.0 rounds to 2.0
    x = torch.tensor([0x3FFFF000], dtype=torch.int32).view(torch.float32)
    assert tf32_rna(x).item() == 2.0
    assert tf32_rna(-x).item() == -2.0


@pytest.mark.parametrize("seed", [0, 1])
def test_split_holds_x_to_2_pow_minus_22(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(200000)
         * 2.0 ** rng.integers(-60, 61, 200000)).astype(np.float32)
    x = torch.as_tensor(x)
    hi, lo = split_tf32(x)
    assert torch.equal(_low_bits(hi), torch.zeros_like(_low_bits(hi)))
    assert torch.equal(_low_bits(lo), torch.zeros_like(_low_bits(lo)))
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    # lo is the smaller part: at most half a TF32 ulp of hi
    assert (lo.double().abs() <= 2.0 ** -11 * hi.double().abs()).all()


@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=lambda s: "N%dD%dH%d" % s)
def test_split_product_within_float32_tolerance(shape):
    """The card tests' Gaussian inputs (their seed, a block of zero rows):
    the split-TF32 products of sgemm_nn, sgemm_tn_splitn and its
    accumulating form within rtol 1e-5, atol 2e-7 per unit of depth of
    float64."""
    N, D, H = shape
    rng = np.random.default_rng(N + D + H)
    y, W, sw, base = (_draw(rng, s, False) for s in ((N, D), (D, H), (N, H),
                                                    (D, H)))
    y[:40] = 0.0
    sw[-3:] = 0.0
    for got, ref, depth in (
            (split_matmul(y, W), y.double() @ W.double(), D),
            (split_matmul(y.T, sw), y.double().T @ sw.double(), N),
            ((base.double() + split_matmul(y.T, sw).double()).float(),
             base.double() + y.double().T @ sw.double(), N)):
        torch.testing.assert_close(got.double(), ref, rtol=1e-5,
                                   atol=2e-7 * depth)


@pytest.mark.parametrize("shape", [(1000, 25, 10), (16385, 256, 300)],
                         ids=lambda s: "N%dD%dH%d" % s)
def test_split_product_exact_on_quarters(shape):
    """Inputs quantised to multiples of 1/4 fit whole into hi (lo = 0), so
    the products and their sums are exact: the kernels' exactness checks
    hold."""
    N, D, H = shape
    rng = np.random.default_rng(N + D + H)
    y, W, sw = (_draw(rng, s, True) for s in ((N, D), (D, H), (N, H)))
    for t in (y, W, sw):
        hi, lo = split_tf32(t)
        assert torch.equal(hi, t) and not lo.any()
    assert torch.equal(split_matmul(y, W).double(), y.double() @ W.double())
    assert torch.equal(split_matmul(y.T, sw).double(),
                       y.double().T @ sw.double())


def test_dropping_lo_would_break_the_tolerance():
    """hi alone (one TF32 product) misses the float32 tolerance by far: the
    lo terms are what the contract needs."""
    rng = np.random.default_rng(7)
    y, W = _draw(rng, (1000, 256), False), _draw(rng, (256, 300), False)
    hi_only = (tf32_rna(y).double() @ tf32_rna(W).double()).float()
    ref = y.double() @ W.double()
    with pytest.raises(AssertionError):
        torch.testing.assert_close(hi_only.double(), ref, rtol=1e-5,
                                   atol=2e-7 * 256)
    torch.testing.assert_close(split_matmul(y, W).double(), ref, rtol=1e-5,
                               atol=2e-7 * 256)
