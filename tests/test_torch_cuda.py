"""The CUDA kernels of the port (the linear E-step and decode, the max
family's E-step) against their plain versions, on the card.

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
from prosper_tpu_torch.ops import linear_cuda, max_cuda

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
