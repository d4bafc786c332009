"""Image-patch data pipeline (the reference's scaling benchmark dataset).

Counterpart of ``prosper_tpu/data/patches.py`` (numpy; HDF5 through
``io/hdf5.py``).  ``stride_data`` is ``parallel/mesh.py``'s: the process
count and index come from ``torch.distributed`` when it is initialised.

Reference behavior: SURVEY.md §2 "Example scripts" / §5.8 — the reference
reads HDF5 image-patch datasets with each MPI rank loading its
``stride_data`` slice.  Here:

  * ``load_h5_shard``   — process-local contiguous slice of an HDF5 dataset
                          (multi-process: each process reads only its shard),
  * ``pad_for_mesh``    — pad the local shard to a multiple of
                          (n_local_shards * chunk) with valid=0 rows so the
                          chunked E-step's sizes divide the chunk,
  * ``extract_patches`` — cut random patches from images, optional DC
                          removal / whitening (standard sparse-coding prep),
  * ``synthetic_patches`` — 1/f-correlated Gaussian patches for benchmarks
                          when no real dataset is on disk.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from prosper_tpu_torch.io import hdf5
from prosper_tpu_torch.parallel.mesh import stride_data


def load_h5_shard(path: str, dataset: str = "patches",
                  parts: Optional[int] = None,
                  index: Optional[int] = None) -> np.ndarray:
    """Read this process's contiguous slice of an (N, D) HDF5 dataset."""
    with hdf5.File(path, "r") as f:
        ds = f[dataset]
        N = ds.shape[0]
        first, last = stride_data(N, parts, index)
        return np.asarray(ds[first:last], np.float32)


def pad_for_mesh(y: np.ndarray, n_shards: int, chunk: int
                 ) -> Dict[str, np.ndarray]:
    """Pad to a multiple of n_shards*chunk; padding rows get valid=0."""
    N = y.shape[0]
    mult = n_shards * chunk
    N_pad = ((N + mult - 1) // mult) * mult
    valid = np.zeros((N_pad,), np.float32)
    valid[:N] = 1.0
    if N_pad != N:
        y = np.concatenate([y, np.zeros((N_pad - N,) + y.shape[1:],
                                        y.dtype)], axis=0)
    return {"y": y.astype(np.float32), "valid": valid}


def extract_patches(images: np.ndarray, patch_size: int, n_patches: int,
                    seed: int = 0, remove_dc: bool = True,
                    normalize: bool = False) -> np.ndarray:
    """Random (patch_size x patch_size) patches from a stack of images.

    images: (n_images, height, width).  Returns (n_patches, patch_size**2).
    """
    rng = np.random.default_rng(seed)
    n_img, Hh, Ww = images.shape
    ps = patch_size
    idx = rng.integers(0, n_img, n_patches)
    ys = rng.integers(0, Hh - ps + 1, n_patches)
    xs = rng.integers(0, Ww - ps + 1, n_patches)
    out = np.empty((n_patches, ps * ps), np.float32)
    for i in range(n_patches):
        out[i] = images[idx[i], ys[i]:ys[i] + ps, xs[i]:xs[i] + ps].ravel()
    if remove_dc:
        out -= out.mean(axis=1, keepdims=True)
    if normalize:
        out /= out.std() + 1e-8
    return out


def whiten(y: np.ndarray, eps: float = 1e-5
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ZCA whitening; returns (whitened, mean, transform)."""
    mean = y.mean(axis=0)
    yc = y - mean
    cov = yc.T @ yc / y.shape[0]
    evals, evecs = np.linalg.eigh(cov)
    T = evecs @ np.diag(1.0 / np.sqrt(evals + eps)) @ evecs.T
    return (yc @ T).astype(np.float32), mean, T


def synthetic_patches(N: int, patch_size: int = 16, seed: int = 0,
                      alpha: float = 1.0) -> np.ndarray:
    """1/f^alpha correlated Gaussian patches (natural-image-like spectra)."""
    rng = np.random.default_rng(seed)
    ps = patch_size
    fx = np.fft.fftfreq(ps)[:, None]
    fy = np.fft.fftfreq(ps)[None, :]
    f = np.sqrt(fx ** 2 + fy ** 2)
    f[0, 0] = 1.0
    amp = 1.0 / (f ** alpha)
    amp[0, 0] = 0.0            # no DC
    spec = (rng.standard_normal((N, ps, ps))
            + 1j * rng.standard_normal((N, ps, ps))) * amp[None]
    patches = np.fft.ifft2(spec, axes=(1, 2)).real.astype(np.float32)
    patches = patches.reshape(N, ps * ps)
    patches /= patches.std() + 1e-8
    return patches


def write_h5_dataset(path: str, y: np.ndarray,
                     dataset: str = "patches") -> None:
    with hdf5.File(path, "w") as f:
        f.create_dataset(dataset, data=np.asarray(y, np.float32),
                         chunks=(min(4096, y.shape[0]),) + y.shape[1:])
