"""Build and load the port's CUDA kernel library.

Every source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into an
object file (one ``nvcc`` process per source, all started together), and
the objects are linked into one shared library with a plain C interface,
named by a hash of the sources and flags, in ``prosper_tpu_torch/build/``.
This happens at first CUDA use, never at import; the library is loaded
with ``ctypes``.  The wrappers (``ops/linear_cuda.py``, ``ops/max_cuda.py``)
share the input checks below and the launch counts in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import torch

#: kernel launches by kernel name; a run resets and reads it to show that
#: its main path went through the kernels
LAUNCHES: Dict[str, int] = {"estep": 0, "decode": 0, "max_estep": 0}

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("linear_et_estep.cu", "linear_et_decode.cu", "max_et_estep.cu")
HEADERS = ("linear_et_frontend.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")
SMEM_LIMIT = 232448          # bytes of shared memory a block may use

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
            ("linear_et_estep", [p] * 14 + [i] * 9 + [p], i),
            ("linear_et_decode", [p] * 14 + [i] * 8 + [p], i),
            ("linear_et_estep_ws_stride", [i, i, i], z),
            ("linear_et_smem_bytes", [i] * 5, z),
            ("max_et_estep", [p] * 14 + [i] * 8 + [p], i),
            ("max_et_estep_ws_stride", [i, i], z),
            ("max_et_smem_bytes", [i] * 4, z),
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


def scalars(sigma2, beta, prior_beta, device) -> torch.Tensor:
    """[sigma2, beta, prior_beta] as a float32 tensor on ``device``."""
    s2 = torch.as_tensor(sigma2, dtype=torch.float32, device=device)
    bp = torch.tensor([float(beta), float(prior_beta)], dtype=torch.float32)
    return torch.cat([s2.reshape(1), bp.to(device, non_blocking=True)])


def n_blocks(device, smem: int, n_tiles: int) -> int:
    """Persistent blocks for a kernel of ``smem`` bytes per block: as many
    as fit on the card at once, at most one per tile."""
    props = torch.cuda.get_device_properties(device)
    per_sm = max(1, min(8, SMEM_LIMIT // (smem + 1024)))
    return min(n_tiles, props.multi_processor_count * per_sm)


def raise_on(lib, err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.linear_et_error_string(err).decode()}")
