"""The port's ctypes binding of the native state enumerator
(``native/enumerate.cpp``) against its numpy path: identical tables (the
port's version of tests/test_native_enum.py).  The library is compiled into
a temporary directory with the C++ compiler; the tests skip where that
fails."""

import os
import shutil
import subprocess
from math import comb

import numpy as np
import pytest

from prosper_tpu_torch.core import states as st

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the native enumerator")
    so = str(tmp_path_factory.mktemp("native") / "libprosper_enum.so")
    r = subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-o", so,
                        os.path.join(ROOT, "native", "enumerate.cpp")],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        pytest.skip(f"cannot build the native enumerator: {r.stderr[-400:]}")
    saved = st.NATIVE_LIB
    st.NATIVE_LIB = so
    st._native_lib.cache_clear()
    lib = st._native_lib()
    if lib is None:
        pytest.skip("the native enumerator does not load")
    yield lib
    st.NATIVE_LIB = saved
    st._native_lib.cache_clear()


def _same_space(a, b):
    assert a.S == b.S
    for k in ("states", "value_counts", "abs_states", "outer", "values"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


@pytest.mark.parametrize("Hp,gamma,values", [
    (10, 5, [-1.0, 1.0, 2.0]),     # a large DSC-style space (81891 states)
    (12, 4, [1.0]),                # binary
    (9, 4, [-1.0, 1.0]),           # ternary
    (10, 5, [-1.0, 1.0]),          # the big-S TSC space (12564 states)
])
def test_native_matches_numpy(native_lib, Hp, gamma, values):
    _same_space(st.discrete_state_space(Hp, gamma, values,
                                        native_min_states=0),
                st.discrete_state_space(Hp, gamma, values, use_native=False))


def test_native_count(native_lib):
    expected = sum(comb(10, k) * 3 ** k for k in range(2, 6))
    assert native_lib.prosper_enum_count(10, 5, 3, 2) == expected


def test_numpy_path_without_the_library(monkeypatch):
    """Where the library is not built the numpy path serves, with the same
    tables."""
    ref = st.discrete_state_space(8, 3, [-1.0, 1.0], use_native=False)
    monkeypatch.setattr(st, "NATIVE_LIB", os.path.join(ROOT, "no_such.so"))
    st._native_lib.cache_clear()
    try:
        assert st._native_lib() is None
        _same_space(st.discrete_state_space(8, 3, [-1.0, 1.0],
                                            native_min_states=0), ref)
    finally:
        st._native_lib.cache_clear()
