"""Host-side enumeration of truncated latent-state spaces.

Expectation Truncation keeps, per datapoint, the zero state, the singletons
over all H units, and the states over the H' candidate slots with
2 <= |support| <= gamma.  The last part is a static enumeration shared by
every datapoint; it is built once here as small numpy arrays and moved to
the device by the model (``core.etstep.state_arrays_from``).

Counterpart of ``prosper_tpu/core/states.py``: the same arrays in the same
order — by support size, then lexicographic support, then lexicographic
value assignment.  Where ``native/build.sh`` has built the repository's C++
enumerator (``native/libprosper_enum.so``), large spaces are enumerated by
it through ctypes; the numpy path is the reference and the default
everywhere else.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import os
from dataclasses import dataclass
from math import comb
from typing import Optional

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


#: the native enumerator, built by native/build.sh at the repository's root
NATIVE_LIB = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "libprosper_enum.so")


@functools.lru_cache(maxsize=None)
def _native_lib() -> Optional[ctypes.CDLL]:
    """The ctypes binding of ``NATIVE_LIB``, or None where it is not built
    or does not load (looked up once per process)."""
    if not os.path.exists(NATIVE_LIB):
        return None
    try:
        lib = ctypes.CDLL(NATIVE_LIB)
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.prosper_enum_count.restype = ctypes.c_int64
    lib.prosper_enum_count.argtypes = [ctypes.c_int32] * 4
    lib.prosper_enum_fill.restype = ctypes.c_int64
    lib.prosper_enum_fill.argtypes = [ctypes.c_int32] * 4 + [f32p] * 5
    return lib


def _native_space(lib: ctypes.CDLL, Hp: int, gamma: int, values: np.ndarray,
                  min_active: int, S: int) -> Optional[StateSpace]:
    """The space enumerated by the native library, or None where it fills
    another number of states than ``S``."""
    K = values.size
    states = np.zeros((S, Hp), np.float32)
    value_counts = np.zeros((S, K), np.float32)
    abs_states = np.zeros((S,), np.float32)
    outer = np.zeros((S, Hp * Hp), np.float32)
    vals32 = np.ascontiguousarray(values, np.float32)

    def p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    n = lib.prosper_enum_fill(Hp, gamma, K, min_active, p(vals32), p(states),
                              p(value_counts), p(abs_states), p(outer))
    if n != S:
        return None
    return StateSpace(states=states, abs_states=abs_states,
                      value_counts=value_counts, values=values, outer=outer)


def discrete_state_space(Hp: int, gamma: int, values, min_active: int = 2,
                         dtype=np.float32, use_native: bool = True,
                         native_min_states: int = 4096) -> StateSpace:
    """Enumerate all states over Hp slots with min_active..gamma active
    units, each active unit taking one of the non-zero ``values``.  A
    float32 space of at least ``native_min_states`` states is enumerated by
    the native library where it loads (the same arrays, in the same order);
    any other space, or a native fill of the wrong size, by numpy."""
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
    lib = _native_lib() if (use_native and dtype == np.float32) else None
    if lib is not None and S >= native_min_states:
        space = _native_space(lib, Hp, gamma, values, min_active, S)
        if space is not None:
            return space

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
