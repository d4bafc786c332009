"""Build and load the port's CUDA kernel library.

Every source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into an
object file (one ``nvcc`` process per source, all started together), and
the objects are linked into one shared library with a plain C interface,
named by a hash of the sources and flags, in ``prosper_tpu_torch/build/``.
This happens at first CUDA use, never at import; the library is loaded
with ``ctypes``.  The wrappers (``ops/gemm_cuda.py``, ``ops/linear_cuda.py``,
``ops/max_cuda.py``, ``ops/bigs_cuda.py``) share the input checks below and
the launch counts in ``LAUNCHES`` (``ops/gsc_cuda.py`` too).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import weakref
from pathlib import Path
from typing import Dict, Tuple

import torch

#: kernel launches by kernel name; a run resets and reads it to show that
#: its main path went through the kernels.  An E-step counts once per call
#: (``estep``, ``max_estep``, ``gsc_estep``), and its two GEMMs count
#: beside it: the
#: float32 ones (``sgemm_*``), or the 16-bit ones of a linear model's
#: ``compute_dtype`` (``hgemm_*``).
LAUNCHES: Dict[str, int] = {"estep": 0, "decode": 0, "max_estep": 0,
                             "bigs": 0, "gsc_estep": 0, "sgemm_nn": 0,
                             "sgemm_tn": 0, "hgemm_nn": 0, "hgemm_tn": 0}

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("sgemm.cu", "hgemm_bf16.cu", "hgemm_f16.cu", "linear_et_estep.cu",
           "linear_et_decode.cu", "max_et_estep.cu", "max_et_estep_hp2_5.cu",
           "max_et_estep_hp7.cu", "max_et_estep_hp8.cu", "bigs_multi.cu",
           "gsc_et_estep.cu")
HEADERS = ("sgemm.cuh", "hgemm_tn.cuh", "linear_et_frontend.cuh",
           "max_et_estep.cuh", "cp_async.cuh", "launch_once.cuh")
#: -fno-gnu-unique: the launchers' function-local statics (a kernel's
#: shared-memory attribute, set once) stay private to each library, so
#: that two builds loaded in one process (edited copies of the sources, as
#: tools/torch_kernel_times.py loads them) do not share them
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC",
              "-Xcompiler", "-fno-gnu-unique")
SMEM_LIMIT = 232448          # bytes of shared memory a block may use
#: most bytes an E-step's (N, H) workspace for P may take; a larger N is cut
#: into chunks of rows whose sums are added in order
P_LIMIT_BYTES = 1 << 30

_lib = None
#: the compiler's output from the build this process loaded (registers,
#: shared memory and spills per kernel, from -Xptxas=-v)
BUILD_LOG = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def _build() -> Path:
    """Compile the sources in parallel and link them into a library named
    by a hash of the sources and flags; an existing one is reused."""
    global BUILD_LOG
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    lib = BUILD_DIR / f"libprosper_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o,
                                   str(CSRC / s)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, out in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n"
                                   f"{out}")
        so = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        BUILD_LOG = "".join(logs) + proc.stdout + proc.stderr
        os.replace(so, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; idempotent."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    p, i, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    for name, argtypes, restype in (
            ("sgemm_nn", [p] * 4 + [i] * 3 + [p], i),
            ("sgemm_nn_ws_floats", [i, i], z),
            ("sgemm_smem_bytes", [i], z),
            ("sgemm_tn_splitn", [p] * 4 + [i] * 5 + [p], i),
            ("hgemm_nn_bf16", [p] * 4 + [i] * 3 + [p], i),
            ("hgemm_nn_f16", [p] * 4 + [i] * 3 + [p], i),
            ("hgemm_nn_ws_floats", [i, i], z),
            ("hgemm_smem_bytes", [i], z),
            ("hgemm_tn_splitn_bf16", [p] * 4 + [i] * 6 + [p], i),
            ("hgemm_tn_splitn_f16", [p] * 4 + [i] * 6 + [p], i),
            ("hgemm_tn_bulk_smem_bytes", [], z),
            ("linear_et_estep_rows", [p] * 14 + [i] * 9 + [p], i),
            ("linear_et_decode_rows", [p] * 15 + [i] * 9 + [p], i),
            ("linear_et_estep_ws_stride", [i, i], z),
            ("linear_et_rows_smem_bytes", [i] * 4, z),
            ("linear_et_decode_smem_bytes", [i] * 4, z),
            ("max_et_estep", [p] * 16 + [i] * 10 + [p], i),
            ("max_et_ws_a_stride", [i], z),
            ("max_et_ws_b_stride", [i, i], z),
            ("max_et_smem_bytes", [i] * 4, z),
            ("max_et_route_smem_bytes", [i, i], z),
            ("max_et_blocks_per_sm", [i] * 6 + [p], i),
            ("bigs_multi", [p] * 7 + [i] * 7 + [p], i),
            ("bigs_multi_cols", [i], i),
            ("bigs_multi_warps", [i, i], i),
            ("bigs_multi_smem_bytes", [i, i], z),
            ("gsc_et_estep_rows", [p] * 9 + [i] * 9 + [p], i),
            ("gsc_et_ws_stride", [i], z),
            ("gsc_et_smem_bytes", [i] * 5, z),
            ("gsc_et_blocks_per_sm", [i] * 5 + [p], i),
            ("linear_et_error_string", [i], ctypes.c_char_p)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    _lib = lib
    return lib


def check(t: torch.Tensor, name: str, shape, device, dtype=torch.float32):
    """Raise ValueError unless ``t`` is a contiguous ``dtype`` tensor of
    ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=256)
def _device_floats(values: tuple, device) -> torch.Tensor:
    t = torch.tensor(values, dtype=torch.float32)
    return t.to(device, non_blocking=True)


def device_floats(values, device) -> torch.Tensor:
    """Host numbers as a float32 tensor on ``device``, without a
    synchronisation of the device.  Read-only: the same numbers give the
    same tensor again (a schedule's (beta, prior_beta) repeat from call to
    call), so the copy is made once."""
    return _device_floats(tuple(float(v) for v in values),
                          torch.device(device))


def schedule_pair(beta, prior_beta, device) -> torch.Tensor:
    """[beta, prior_beta] as a float32 tensor on ``device``.  Host numbers
    go through ``device_floats``; 0-d tensors on the device (a step that
    reads its schedule from device memory, as a CUDA graph's must) are
    stacked there, with no copy from the host."""
    if isinstance(beta, torch.Tensor) and isinstance(prior_beta, torch.Tensor):
        return torch.stack([beta.reshape(()), prior_beta.reshape(())]).to(
            device=device, dtype=torch.float32)
    if isinstance(beta, torch.Tensor) or isinstance(prior_beta, torch.Tensor):
        raise TypeError("beta and prior_beta must both be host numbers or "
                        "both be tensors")
    return device_floats((beta, prior_beta), device)


def scalars(sigma2, beta, prior_beta, device) -> torch.Tensor:
    """[sigma2, beta, prior_beta] as a float32 tensor on ``device``."""
    s2 = torch.as_tensor(sigma2, dtype=torch.float32, device=device)
    return torch.cat([s2.reshape(1),
                      schedule_pair(beta, prior_beta, device)])


_PER_TENSOR: Dict[tuple, tuple] = {}


def cached_for(owner: torch.Tensor, name: str, build):
    """``build()``, made once for the tensor ``owner`` (by identity) and
    kept for as long as it lives: what a kernel derives from a model's
    state tables alone (transposed or reduced copies) is not rebuilt on
    every call."""
    key = (id(owner), name)
    hit = _PER_TENSOR.get(key)
    if hit is not None and hit[0]() is owner:
        return hit[1]
    value = build()
    _PER_TENSOR[key] = (weakref.ref(
        owner, lambda _, key=key: _PER_TENSOR.pop(key, None)), value)
    return value


def blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes of shared memory (plus the 1 KB the card
    reserves for each) that fit one SM, at most 8."""
    return max(1, min(8, (SMEM_LIMIT + 1024) // (smem + 1024)))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's number of SMs, asked once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def n_blocks(device, smem: int, n_tiles: int) -> int:
    """Persistent blocks for a kernel of ``smem`` bytes per block: as many
    as fit on the card at once, at most one per tile."""
    return min(n_tiles, sm_count(torch.device(device)) * blocks_per_sm(smem))


def row_chunks(N: int, H: int):
    """The bounds (i, j) of the row chunks whose (j - i, H) float32
    workspace fits ``P_LIMIT_BYTES``: all N rows where they fit, else a
    multiple of 1024 rows each."""
    step = max(1024, P_LIMIT_BYTES // (4 * H) // 1024 * 1024)
    return [(i, min(N, i + step)) for i in range(0, N, step)]


def in_row_chunks(N: int, H: int, run):
    """(F, sums) of ``run(i, j)`` over the ``row_chunks``: F concatenated
    and the sums (one tensor, or a dict of them) added in chunk order."""
    parts = [run(i, j) for i, j in row_chunks(N, H)]
    if len(parts) == 1:
        return parts[0]
    sums = parts[0][1]
    for p in parts[1:]:
        sums = ({k: sums[k] + p[1][k] for k in sums}
                if isinstance(sums, dict) else sums + p[1])
    return torch.cat([p[0] for p in parts]), sums


def raise_on(lib, err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.linear_et_error_string(err).decode()}")


#: (kernel name, shape key, device index) -> blocks of each kernel an SM
#: holds at once
_OCCUPANCY: Dict[tuple, Tuple[int, ...]] = {}


def occupancy(lib, name: str, key: tuple, query, n: int = 1
              ) -> Tuple[int, ...]:
    """Blocks of each of ``n`` kernels that one SM of the current device
    holds at once (registers and shared memory), asked of the runtime once
    per ``key``: ``query(out)`` calls the library's occupancy function,
    which fills the ``n`` ints of ``out``.  Raises where a kernel fits no
    SM."""
    full = (name, key, torch.cuda.current_device())
    if full not in _OCCUPANCY:
        out = (ctypes.c_int * n)()
        raise_on(lib, query(out), name)
        if min(out) < 1:
            raise RuntimeError(f"the {name} kernels fit no SM at {key}")
        _OCCUPANCY[full] = tuple(out)
    return _OCCUPANCY[full]
