"""Hand-written CUDA kernels for the linear-family ET E-step and decode.

Two kernels share one front end (``csrc/linear_et_frontend.cuh``):

* ``linear_et_estep``  (``csrc/linear_et_estep.cu``) replaces
  ``prosper_tpu/ops/linear_pallas.py::linear_et_estep_pallas``: F per
  datapoint and the weight-masked sufficient statistics (training).
* ``linear_et_decode`` (``csrc/linear_et_decode.cu``) replaces
  ``linear_et_decode_pallas``: F, the posterior mean, the top-L states in
  canonical union indices and the candidates (serving).

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first CUDA use (never at import), into
``prosper_tpu_torch/build/``, and loaded with ``ctypes``.  Each wrapper
checks its inputs, allocates outputs and scratch with ``torch.empty``,
launches on the current stream and adds one to ``LAUNCHES``.  On a CPU
tensor a wrapper runs the kernel's plain version (``core/etstep.py``);
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Tuple

import torch

from prosper_tpu_torch.core import etstep
from prosper_tpu_torch.core.etstep import LinearStateArrays

#: kernel launches by kernel name; a run resets and reads it to show that
#: its main path went through the kernels
LAUNCHES: Dict[str, int] = {"estep": 0, "decode": 0}

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("linear_et_estep.cu", "linear_et_decode.cu")
HEADERS = ("linear_et_frontend.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")
SMEM_LIMIT = 232448          # bytes of shared memory a block may use
HP_MAX, K_MAX, H_MAX = 32, 8, 1024
TILE = 16                    # datapoints per tile, as TILE in the sources

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
    """Compile the kernels into a library named by a hash of the sources
    and flags; an existing library of the same hash is reused."""
    global BUILD_LOG
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    lib = BUILD_DIR / f"liblinear_et_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(CSRC / s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    BUILD_LOG = proc.stdout + proc.stderr
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; idempotent."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.linear_et_estep.argtypes = [p] * 14 + [i] * 9 + [p]
    lib.linear_et_estep.restype = i
    lib.linear_et_decode.argtypes = [p] * 14 + [i] * 8 + [p]
    lib.linear_et_decode.restype = i
    lib.linear_et_estep_ws_stride.argtypes = [i, i, i]
    lib.linear_et_estep_ws_stride.restype = ctypes.c_size_t
    lib.linear_et_smem_bytes.argtypes = [i] * 5
    lib.linear_et_smem_bytes.restype = ctypes.c_size_t
    lib.linear_et_error_string.argtypes = [i]
    lib.linear_et_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(t: torch.Tensor, name: str, shape, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(y, W, log_odds, sa: LinearStateArrays, Hp: int):
    """Validate the shared inputs, then build/load the kernels.
    Returns (lib, N, D, H, S, K, smem bytes)."""
    if y.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {y.device}")
    N, D = y.shape
    H = W.shape[1]
    S, K = sa.value_counts.shape
    dev = y.device
    _check(y, "y", (N, D), dev)
    _check(W, "W", (D, H), dev)
    _check(log_odds, "log_odds", (K,), dev)
    _check(sa.states, "states", (S, Hp), dev)
    _check(sa.outer, "outer", (S, Hp * Hp), dev)
    _check(sa.value_counts, "value_counts", (S, K), dev)
    _check(sa.abs_states, "abs_states", (S,), dev)
    _check(sa.values, "values", (K,), dev)
    if N < 1:
        raise ValueError("need at least one datapoint")
    if not (Hp <= HP_MAX and K <= K_MAX and H <= H_MAX):
        raise ValueError(f"kernel limits: Hp <= {HP_MAX}, K <= {K_MAX}, "
                         f"H <= {H_MAX}; got {Hp=} {K=} {H=}")
    lib = load_library()
    smem = lib.linear_et_smem_bytes(D, H, Hp, S, K)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a tile needs {smem} bytes of shared memory, more "
                         f"than the {SMEM_LIMIT} a block may use")
    return lib, N, D, H, S, K, smem


def _state_minor(sa: LinearStateArrays):
    """The state tables as the kernels read them: transposed, so that the
    lanes of a warp, which walk the states, read consecutive addresses."""
    return (sa.states.T.contiguous(), sa.outer.T.contiguous(),
            sa.value_counts.T.contiguous())


def _scalars(sigma2, beta, prior_beta, device) -> torch.Tensor:
    s2 = torch.as_tensor(sigma2, dtype=torch.float32, device=device)
    bp = torch.tensor([float(beta), float(prior_beta)], dtype=torch.float32)
    return torch.cat([s2.reshape(1), bp.to(device, non_blocking=True)])


def _raise_on(lib, err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.linear_et_error_string(err).decode()}")


def linear_et_estep_cuda(y, weight, W, sigma2, log_odds,
                         sa: LinearStateArrays, Hp: int, signed_select: bool,
                         beta, prior_beta, collect_true: bool = True
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The fused E-step kernel on CUDA tensors; same contract as
    ``core.etstep.linear_et_estep`` (any N, no chunking)."""
    lib, N, D, H, S, K, smem = _check_common(y, W, log_odds, sa, Hp)
    dev = y.device
    _check(weight, "weight", (N,), dev)
    gram = (W.T @ W).contiguous()
    scal = _scalars(sigma2, beta, prior_beta, dev)
    states, outer, vcounts = _state_minor(sa)
    props = torch.cuda.get_device_properties(dev)
    per_sm = max(1, min(8, SMEM_LIMIT // (smem + 1024)))
    n_tiles = -(-N // TILE)
    n_blocks = min(n_tiles, props.multi_processor_count * per_sm)
    stride = lib.linear_et_estep_ws_stride(D, H, K)
    F = torch.empty(N, dtype=torch.float32, device=dev)
    ws = torch.empty(n_blocks * stride, dtype=torch.float32, device=dev)
    sums = torch.empty(stride, dtype=torch.float32, device=dev)
    err = lib.linear_et_estep(
        y.data_ptr(), weight.data_ptr(), W.data_ptr(), gram.data_ptr(),
        states.data_ptr(), outer.data_ptr(), vcounts.data_ptr(),
        sa.abs_states.data_ptr(),
        sa.values.data_ptr(), log_odds.data_ptr(), scal.data_ptr(),
        F.data_ptr(), ws.data_ptr(), sums.data_ptr(),
        N, D, H, Hp, S, K, int(signed_select), int(collect_true), n_blocks,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "linear_et_estep")
    LAUNCHES["estep"] += 1
    o = D * H + H * H
    out = dict(xs=sums[:D * H].view(D, H), ss=sums[D * H:o].view(H, H),
               s=sums[o:o + H], vc=sums[o + H:o + H + K])
    for j, k in enumerate(("abs", "y2", "n", "F", "F_true")):
        out[k] = sums[o + H + K + j]
    return F, out


def linear_et_decode_cuda(y, W, sigma2, log_odds, sa: LinearStateArrays,
                          Hp: int, signed_select: bool, top_L: int, beta,
                          prior_beta):
    """The fused decode kernel on CUDA tensors; same contract as
    ``core.etstep.linear_et_decode``."""
    lib, N, D, H, S, K, _ = _check_common(y, W, log_odds, sa, Hp)
    if top_L > 1 + H * K + S:
        raise ValueError(f"top_L={top_L} exceeds the {1 + H * K + S} "
                         "posterior columns")
    dev = y.device
    gram = (W.T @ W).contiguous()
    scal = _scalars(sigma2, beta, prior_beta, dev)
    states, outer, vcounts = _state_minor(sa)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    F, s_mean, top_q = empty(N), empty(N, H), empty(N, top_L)
    top_u, cand = empty(N, top_L, dtype=torch.int32), empty(
        N, Hp, dtype=torch.int32)
    err = lib.linear_et_decode(
        y.data_ptr(), W.data_ptr(), gram.data_ptr(), states.data_ptr(),
        outer.data_ptr(), vcounts.data_ptr(), sa.values.data_ptr(),
        log_odds.data_ptr(), scal.data_ptr(), F.data_ptr(),
        s_mean.data_ptr(), top_q.data_ptr(), top_u.data_ptr(),
        cand.data_ptr(), N, D, H, Hp, S, K, top_L, int(signed_select),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "linear_et_decode")
    LAUNCHES["decode"] += 1
    return F, s_mean, top_q, top_u, cand


def linear_et_estep(y, weight, W, sigma2, log_odds, sa: LinearStateArrays,
                    Hp: int, signed_select: bool, beta, prior_beta,
                    chunk: int = 2048, collect_true: bool = True):
    """E-step: the kernel on a CUDA tensor, its plain version
    (``core.etstep.linear_et_estep``, chunked by ``chunk``) on a CPU one."""
    if y.device.type == "cpu":
        return etstep.linear_et_estep(y, weight, W, sigma2, log_odds, sa, Hp,
                                      signed_select, beta, prior_beta, chunk,
                                      collect_true)
    return linear_et_estep_cuda(y, weight, W, sigma2, log_odds, sa, Hp,
                                signed_select, beta, prior_beta, collect_true)


def linear_et_decode(y, W, sigma2, log_odds, sa: LinearStateArrays, Hp: int,
                     signed_select: bool, top_L: int, beta, prior_beta,
                     chunk: int = 4096):
    """Decode: the kernel on a CUDA tensor, its plain version
    (``core.etstep.linear_et_decode``, chunked by ``chunk``) on a CPU one."""
    if y.device.type == "cpu":
        return etstep.linear_et_decode(y, W, sigma2, log_odds, sa, Hp,
                                       signed_select, top_L, beta, prior_beta,
                                       chunk)
    return linear_et_decode_cuda(y, W, sigma2, log_odds, sa, Hp,
                                 signed_select, top_L, beta, prior_beta)
