"""Host-side enumeration of truncated latent-state spaces.

Expectation Truncation keeps, per datapoint, the zero state, the singletons
over all H units, and the states over the H' candidate slots with
2 <= |support| <= gamma.  The last part is a static enumeration shared by
every datapoint; it is built once here as small numpy arrays and moved to
the device by the model (``core.etstep.state_arrays_from``).

Counterpart of ``prosper_tpu/core/states.py`` (numpy path): the same arrays
in the same order — by support size, then lexicographic support, then
lexicographic value assignment.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from math import comb

import numpy as np


@dataclass(frozen=True)
class StateSpace:
    """Static enumeration of multi-active states over H' candidate slots.

    states (S, Hp), abs_states (S,), value_counts (S, K), values (K,) and
    outer (S, Hp*Hp) — the flattened per-state outer products s s^T.
    """

    states: np.ndarray
    abs_states: np.ndarray
    value_counts: np.ndarray
    values: np.ndarray
    outer: np.ndarray

    @property
    def S(self) -> int:
        return int(self.states.shape[0])

    @property
    def Hp(self) -> int:
        return int(self.states.shape[1])

    @property
    def K(self) -> int:
        return int(self.values.shape[0])


def n_multi_states(Hp: int, gamma: int, n_values: int = 1,
                   min_active: int = 2) -> int:
    """Exact size of the enumerated multi-active space: sum_k C(Hp,k) K^k."""
    return sum(comb(Hp, k) * (n_values ** k)
               for k in range(min_active, gamma + 1))


def discrete_state_space(Hp: int, gamma: int, values, min_active: int = 2,
                         dtype=np.float32) -> StateSpace:
    """Enumerate all states over Hp slots with min_active..gamma active
    units, each active unit taking one of the non-zero ``values``."""
    values = np.asarray(values, dtype=dtype)
    if values.ndim != 1 or values.size == 0:
        raise ValueError("values must be a non-empty 1-D array of non-zero "
                         "latent values")
    if np.any(values == 0):
        raise ValueError("values must be the NON-zero latent values "
                         "(0 is implicit)")
    if not (0 <= min_active <= gamma <= Hp):
        raise ValueError("need 0 <= min_active <= gamma <= Hp, got "
                         f"{min_active=} {gamma=} {Hp=}")

    K = values.size
    S = n_multi_states(Hp, gamma, K, min_active)
    states = np.zeros((S, Hp), dtype=dtype)
    value_counts = np.zeros((S, K), dtype=dtype)
    i = 0
    for k in range(min_active, gamma + 1):
        for support in itertools.combinations(range(Hp), k):
            for assignment in itertools.product(range(K), repeat=k):
                for slot, vidx in zip(support, assignment):
                    states[i, slot] = values[vidx]
                    value_counts[i, vidx] += 1
                i += 1
    if i != S:
        raise RuntimeError(f"enumerated {i} states, expected {S}")

    abs_states = (states != 0).sum(axis=1).astype(dtype)
    outer = np.einsum("sh,sk->shk", states, states).reshape(
        S, Hp * Hp).astype(dtype)
    return StateSpace(states=states, abs_states=abs_states,
                      value_counts=value_counts, values=values, outer=outer)


def binary_state_space(Hp: int, gamma: int, min_active: int = 2) -> StateSpace:
    """Binary {0,1} states (BSC supports, MCA, MMCA)."""
    return discrete_state_space(Hp, gamma, values=[1.0], min_active=min_active)


def ternary_state_space(Hp: int, gamma: int, min_active: int = 2) -> StateSpace:
    """Ternary {-1, 0, +1} states (TSC)."""
    return discrete_state_space(Hp, gamma, values=[-1.0, 1.0],
                                min_active=min_active)


def slot_value_onehot(space: StateSpace) -> np.ndarray:
    """(S, Hp, K) indicator: slot ``a`` of state ``s`` carries ``values[k]``.

    It separates which value a slot carries (static combinatorics) from the
    values' magnitudes, so a learned value set Phi (DSC with "phi" in
    ``to_learn``) rebuilds ``states = onehot @ phi`` as a function of the
    parameter vector.
    """
    vals = space.values
    if np.unique(vals).size != vals.size:
        raise ValueError("values must be distinct to recover slot indicators")
    return ((space.states[:, :, None] == vals[None, None, :])
            & (space.states[:, :, None] != 0)).astype(np.float32)
