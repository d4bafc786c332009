"""The host-built state tables of the linear E-step's rows kernel
(``ops/linear_cuda.py::rows_tables``) on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Here the int32 table is read back by its documented layout, independently
of the code that writes it: the states' slot masks and value indices give back
``states``, ``outer`` and ``value_counts`` of ``discrete_state_space``
exactly; the moment rows' state masks give back ``states`` and ``outer``
column by column; the pieces of each row cover its words once, in order,
and go to the lanes largest first; a table that is not the states' outer
product is refused; and a
block of the kernel takes no more shared memory than one of the dense
kernel it replaced wherever that one fitted, so no model it took is newly
refused.
"""

import numpy as np
import pytest

from prosper_tpu_torch.core.states import (discrete_state_space,
                                           n_multi_states)
from prosper_tpu_torch.ops import cuda_lib
from prosper_tpu_torch.ops.linear_cuda import (LANES, PIECE_COST,
                                               rows_tables)

SPACES = {  # (Hp, gamma, values): BSC, TSC and DSC spaces
    "bsc_patches": (8, 4, (1.0,)),
    "bsc_bars": (6, 3, (1.0,)),
    "bsc_every_subset": (5, 5, (1.0,)),
    "tsc": (6, 3, (-1.0, 1.0)),
    "tsc_wide": (10, 3, (-1.0, 1.0)),
    "dsc": (6, 3, (-1.0, 1.0, 2.0)),
    "dsc_fractions": (4, 2, (0.5, -2.0, 3.0, -0.25)),
}


def _read(table, S, Hp, K):
    """The table's parts by its layout: (smask, sval (S, KW), rbits (R, SW),
    rstart, lstart, prow, pw0, pw1, lorder), as unsigned words."""
    R = Hp + Hp * (Hp + 1) // 2
    KW = 0 if K == 1 else -(-Hp // 8)
    SW = -(-S // 32)
    fixed = (S, S * KW, R * SW, R + 1, LANES + 1)
    assert table.dtype == np.int32 and (table.size - sum(fixed)) % 4 == 0
    P = (table.size - sum(fixed)) // 4
    assert 1 <= P <= Hp + Hp * Hp
    words = table.view(np.uint32).astype(np.int64)
    parts, o = [], 0
    for n in fixed + (P,) * 4:
        parts.append(words[o:o + n])
        o += n
    smask, sval, rbits, *rest = parts
    return (smask, sval.reshape(S, KW), rbits.reshape(R, SW), *rest)


def _slot_value(sval, s, a):
    return 0 if sval.shape[1] == 0 else (sval[s, a // 8] >> (4 * (a % 8))) & 15


@pytest.mark.parametrize("name", SPACES)
def test_state_masks_give_back_the_state_space(name):
    Hp, gamma, values = SPACES[name]
    space = discrete_state_space(Hp, gamma, values)
    S, K = space.value_counts.shape
    vals = np.asarray(values, np.float32)
    smask, sval, *_ = _read(rows_tables(space.states, space.outer,
                                        space.values)[0], S, Hp, K)
    states = np.zeros((S, Hp), np.float32)
    outer = np.zeros((S, Hp, Hp), np.float32)
    counts = np.zeros((S, K), np.float32)
    for s in range(S):
        slots = [a for a in range(Hp) if smask[s] >> a & 1]
        assert smask[s] >> Hp == 0
        for a in slots:
            states[s, a] = vals[_slot_value(sval, s, a)]
            counts[s, _slot_value(sval, s, a)] += 1
        for a in slots:
            for b in slots:
                outer[s, a, b] = states[s, a] * states[s, b]
    np.testing.assert_array_equal(states, space.states)
    np.testing.assert_array_equal(outer.reshape(S, -1), space.outer)
    np.testing.assert_array_equal(counts, space.value_counts)


@pytest.mark.parametrize("name", SPACES)
def test_moment_rows_give_back_the_columns_and_share_out_the_lanes(name):
    Hp, gamma, values = SPACES[name]
    space = discrete_state_space(Hp, gamma, values)
    S, K = space.value_counts.shape
    (smask, sval, rbits, rstart, lstart, prow, pw0, pw1,
     lorder) = _read(rows_tables(space.states, space.outer,
                                 space.values)[0], S, Hp, K)
    pairs = [(a, b) for a in range(Hp) for b in range(a + 1)]
    act = space.states != 0
    R, SW = rbits.shape
    for r in range(Hp + len(pairs)):
        held = np.array([rbits[r, s // 32] >> (s % 32) & 1 for s in range(S)],
                        bool)
        assert not np.any(rbits[r, S // 32] >> (S % 32)) if S % 32 else True
        if r < Hp:
            np.testing.assert_array_equal(held, act[:, r])
        else:
            a, b = pairs[r - Hp]
            np.testing.assert_array_equal(held, act[:, a] & act[:, b])
        # a row's pieces cover its words once, in order; where K = 1 a
        # slot's own pair has none (the kernel takes the slot's)
        mine = list(range(rstart[r], rstart[r + 1]))
        assert all(prow[i] == r for i in mine)
        if K == 1 and r >= Hp and pairs[r - Hp][0] == pairs[r - Hp][1]:
            assert mine == []
        else:
            assert [pw0[i] for i in mine] == [0] + [pw1[i] for i in mine[:-1]]
            assert pw1[mine[-1]] == SW
    P = prow.size
    assert rstart[0] == 0 and rstart[-1] == P
    assert sorted(lorder.tolist()) == list(range(P))
    assert lstart[0] == 0 and lstart[-1] == P and np.all(np.diff(lstart) >= 0)
    # largest first to the least-loaded lane: no lane has more than the
    # even share plus one piece
    size = [sum(bin(int(w)).count("1") for w in rbits[prow[i], pw0[i]:pw1[i]])
            + PIECE_COST for i in range(P)]
    load = [sum(size[i] for i in lorder[lstart[j]:lstart[j + 1]])
            for j in range(LANES)]
    assert max(load) <= -(-sum(size) // LANES) + max(size)


def test_a_table_that_is_not_the_outer_product_is_refused():
    space = discrete_state_space(5, 3, (-1.0, 1.0))
    outer = space.outer.copy()
    outer[3, 7] += 1.0
    with pytest.raises(ValueError, match="outer product"):
        rows_tables(space.states, outer, space.values)
    with pytest.raises(ValueError, match="not in values"):
        rows_tables(space.states * 2, space.outer, space.values)


def parent_rows_smem_words(H, Hp, S, K):
    """Shared memory (4-byte words) a block of the rows kernel took before
    its redesign: the dense state table, P's row, the block phase."""
    NX, J = Hp + Hp * Hp, Hp + Hp * Hp + K + 1
    return ((Hp + Hp * Hp + K + 2) * (S | 1) + 4 * H
            + 8 * (H + S + NX + J + 16 + Hp) + 3 * 8 + 5)


def table_words(Hp, S, K):
    """The most words ``rows_tables`` gives a state space of these shapes:
    Hp + Hp^2 pieces."""
    R, KW, SW = Hp + Hp * (Hp + 1) // 2, 0 if K == 1 else -(-Hp // 8), -(-S // 32)
    return S + S * KW + R * SW + R + 1 + LANES + 1 + 4 * (Hp + Hp * Hp)


def rows_smem_words(H, Hp, S, K, table):
    """Shared memory (4-byte words) a block of the rows kernel takes with a
    table of ``table`` words: ``csrc/linear_et_estep.cuh::rows_smem_words``
    (the card tests hold the two together)."""
    NT, NX = Hp * (Hp + 1) // 2, Hp + Hp * Hp
    per_warp = S + NX + Hp + 2 * NT + 2 + K + 5 + 2 * Hp + 2 * H + 3 * 32
    nbytes = 16 * H + 2 * NT
    return (table + K + K * K + K + 3 * H + (K + 2) * S + 8 * per_warp
            + (nbytes + 3) // 4)


def test_no_model_the_dense_kernel_took_is_refused():
    """Over every state space of up to 32 slots, 8 values and 0-2 active
    units at least (the table's sizes follow from the shapes alone) and H
    in steps to 1024: where a block of the dense kernel fitted, one of the
    rows kernel does, and takes no more at the patches width."""
    limit = cuda_lib.SMEM_LIMIT // 4
    checked = 0
    for Hp in range(1, 33):
        for gamma in range(1, Hp + 1):
            for K in range(1, 9):
                for min_active in range(min(gamma, 2) + 1):
                    S = n_multi_states(Hp, gamma, K, min_active)
                    for H in list(range(1, 1025, 31)) + [1024]:
                        if parent_rows_smem_words(H, Hp, S, K) <= limit:
                            assert rows_smem_words(
                                H, Hp, S, K, table_words(Hp, S, K)) <= limit, (
                                H, Hp, gamma, K, min_active)
                            checked += 1
    assert checked > 10000
    assert (rows_smem_words(300, 8, 154, 1, table_words(8, 154, 1))
            < parent_rows_smem_words(300, 8, 154, 1))
