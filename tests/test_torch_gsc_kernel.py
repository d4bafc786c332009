"""The routing and host tables of GSC's E-step kernel (``ops/gsc_cuda.py``)
on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Here: the dispatcher on CPU tensors is the plain version, bit for bit, on
``tests/test_torch_gsc.py``'s E-step cases; the host-built support table
names every support of ``_gsc_level_plan`` once with its slots, and its
gather lists name every term of the supports' moments once, in the right
item of the candidate frame; ``within_limits`` reads the model's widths,
and on a CPU tensor a model past them takes the plain version and
launches nothing (on a CUDA tensor it raises: ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from prosper_tpu_torch.core import etstep as tet
from prosper_tpu_torch.core import gscstep
from prosper_tpu_torch.core.states import binary_state_space
from prosper_tpu_torch.ops import cuda_lib, gsc_cuda

KEYS = ("xs", "ss", "s", "abs", "y2", "n", "F", "F_true")

CASES = {  # the E-step cases of tests/test_torch_gsc.py
    "mu0_psi1_beta1": dict(mu=0.0, psi=1.0, beta=1.0),
    "mu.7_psi2.5_beta1": dict(mu=0.7, psi=2.5, beta=1.0),
    "mu.3_psi.8_beta.4": dict(mu=0.3, psi=0.8, beta=0.4),
    "chunks": dict(chunk=64),
    "zero_weights": dict(zero=True),
    "no_true": dict(beta=1.0, collect_true=False),
    "prior_beta": dict(prior_beta=0.5),
}


def _inputs(N, D, H, seed):
    rng = np.random.default_rng(seed)
    W = torch.tensor(rng.standard_normal((D, H)).astype(np.float32))
    y = torch.tensor((rng.standard_normal((N, D)) * 1.5).astype(np.float32))
    w = torch.tensor((rng.random(N) > 0.1).astype(np.float32))
    return y, w, W


@pytest.mark.parametrize("case", list(CASES))
def test_dispatcher_on_cpu_tensors_is_the_plain_estep(case):
    c = dict(mu=0.3, psi=1.4, beta=0.7, prior_beta=1.0, chunk=192,
             zero=False, collect_true=True)
    c.update(CASES[case])
    N, D, H, Hp, gamma = 192, 12, 10, 5, 3
    y, w, W = _inputs(N, D, H, seed=5)
    if c["zero"]:
        w[:100] = 0.0
    sa = tet.state_arrays_from(binary_state_space(Hp, gamma), "cpu")
    args = (y, w, W, 0.8, 0.12, c["mu"], c["psi"], sa, Hp, c["beta"],
            c["prior_beta"])
    before = dict(cuda_lib.LAUNCHES)
    F1, s1 = gsc_cuda.gsc_et_estep(*args, chunk=c["chunk"],
                                   collect_true=c["collect_true"])
    F0, s0 = gscstep.gsc_et_estep(*args, chunk=c["chunk"],
                                  collect_true=c["collect_true"])
    assert dict(cuda_lib.LAUNCHES) == before
    assert torch.equal(F1, F0)
    assert set(s1) == set(KEYS)
    for k in KEYS:
        assert torch.equal(s1[k], s0[k]), k


@pytest.mark.parametrize("Hp,gamma", [(5, 3), (6, 3), (6, 4), (3, 2),
                                      (8, 4)])
def test_support_tables_cover_every_support_once(Hp, gamma):
    """Each support's code holds its size and slots as the level plan has
    them; each gather list names, in order of the supports, the moment
    rows of exactly the supports that hold its slot or slot pair, and every
    term of every support is named once."""
    act = binary_state_space(Hp, gamma).states > 0.5
    S = act.shape[0]
    table, g = gsc_cuda.support_tables(act)
    assert g == gamma and table.dtype == np.int32
    NI = Hp + Hp * (Hp + 1) // 2
    codes, starts = table[:S], table[S:S + NI + 1]
    entries = table[S + NI + 1:]
    assert starts[0] == 0 and starts[-1] == entries.size
    slots = {}
    for off, idx in gscstep._gsc_level_plan(act):
        for r, sl in enumerate(idx):
            s = off + r
            assert codes[s] & 15 == len(sl)
            assert [(codes[s] >> (4 + 4 * i)) & 15
                    for i in range(len(sl))] == list(sl)
            assert codes[s] >> (4 + 4 * len(sl)) == 0
            slots[s] = list(sl)
    assert sorted(slots) == list(range(S))

    want = [[] for _ in range(NI)]
    for s, sl in slots.items():
        for i, a in enumerate(sl):
            want[a].append(i * S + s)
            for j in range(i + 1):
                pair = Hp + a * (a + 1) // 2 + sl[j]
                want[pair].append((gamma + i * (i + 1) // 2 + j) * S + s)
    for k in range(NI):
        got = list(entries[starts[k]:starts[k + 1]])
        assert got == sorted(want[k], key=lambda e: e % S), k
    m = np.array([len(slots[s]) for s in range(S)])
    assert entries.size == int((m + m * (m + 1) // 2).sum())
    assert np.unique(entries).size == entries.size


def test_a_model_past_the_limits_takes_the_plain_path():
    """``within_limits`` reads H', H and the support sizes; on a CPU
    tensor a model past them runs the plain version through the
    dispatcher, launching nothing."""
    def limits(Hp, gamma, H=300):
        sa = tet.state_arrays_from(binary_state_space(Hp, gamma), "cpu")
        return gsc_cuda.within_limits(torch.zeros(4, H), sa, Hp)
    assert limits(6, 3) and limits(8, 4) and limits(3, 2)
    assert limits(6, 3, H=1024)
    assert not limits(9, 3)
    assert not limits(6, 5)
    assert not limits(6, 3, H=1025)
    N, D, H, Hp, gamma = 64, 10, 12, 9, 3
    y, w, W = _inputs(N, D, H, seed=2)
    sa = tet.state_arrays_from(binary_state_space(Hp, gamma), "cpu")
    before = dict(cuda_lib.LAUNCHES)
    F1, s1 = gsc_cuda.gsc_et_estep(y, w, W, 0.8, 0.12, 0.3, 1.4, sa, Hp,
                                   1.0, 1.0, chunk=N)
    F0, s0 = gscstep.gsc_et_estep(y, w, W, 0.8, 0.12, 0.3, 1.4, sa, Hp,
                                  1.0, 1.0, chunk=N)
    assert dict(cuda_lib.LAUNCHES) == before
    assert torch.equal(F1, F0)
    for k in KEYS:
        assert torch.equal(s1[k], s0[k]), k
