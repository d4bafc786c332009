"""Inputs made on the device from the seed: the planted dictionary, rows
drawn from it and the initial parameters of a training run.

A torch rewrite of the planted-dictionary data of the repository's data
module (each of the H atoms lights ``active`` random pixels at
``intensity``; latents Bernoulli(pi); Gaussian noise sigma) and of the
models' data-driven initialisation (W = the data mean plus noise of
std / sqrt(H), pi = 1 / H, sigma = the data's std).  It imports nothing of
the program: the program and the reference are both handed what this
makes.  Every draw comes from a ``torch.Generator`` seeded by ``derive``,
so one seed gives the same inputs on every run.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

#: rows a call of the generator makes at once (a block of the max
#: superposition takes block x D x H floats)
LINEAR_BLOCK = 65536
MAX_BLOCK = 4096


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed (``tags`` name the use),
    so that no two uses share a stream."""
    h = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *tags))
    return g


def planted_dictionary(D: int, H: int, active: int, intensity: float,
                       g: torch.Generator, device) -> torch.Tensor:
    """(D, H) float32: column h lights ``active`` distinct random pixels."""
    keys = torch.rand((H, D), generator=g, device=device)
    idx = keys.argsort(dim=1)[:, :active]
    W = torch.zeros((H, D), dtype=torch.float32, device=device)
    W.scatter_(1, idx, float(intensity))
    return W.T.contiguous()


def rows(W: torch.Tensor, N: int, pi: float, sigma: float,
         superposition: str, g: torch.Generator) -> torch.Tensor:
    """(N, D) float32 rows of the generative model on W's device: binary
    latents with P(s_h = 1) = pi, the mean W s ("linear") or, per pixel,
    the largest W_dh over the active h ("max"; 0 where none is active, as
    W >= 0), plus sigma times standard normal noise."""
    D, H = W.shape
    if superposition not in ("linear", "max"):
        raise ValueError(f"superposition {superposition!r}: linear or max")
    y = torch.empty((N, D), dtype=torch.float32, device=W.device)
    block = LINEAR_BLOCK if superposition == "linear" else MAX_BLOCK
    for i in range(0, N, block):
        b = min(block, N - i)
        s = (torch.rand((b, H), generator=g, device=W.device) < pi).float()
        if superposition == "linear":
            # binary s and integer-valued W: the product is exact
            ybar = torch.matmul(s.double(), W.double().T).float()
        else:
            ybar = (s[:, None, :] * W[None, :, :]).amax(dim=2)
        y[i:i + b] = ybar + sigma * torch.randn((b, D), generator=g,
                                                device=W.device)
    return y


def moments(y: torch.Tensor, block: int = 65536):
    """(mean (D,), std) of the rows in float64: the mean over rows, the
    population std over every entry."""
    s1 = torch.zeros(y.shape[1], dtype=torch.float64, device=y.device)
    s2 = torch.zeros((), dtype=torch.float64, device=y.device)
    for i in range(0, y.shape[0], block):
        b = y[i:i + block].double()
        s1 += b.sum(dim=0)
        s2 += (b * b).sum()
    n = y.shape[0] * y.shape[1]
    mean = s1 / y.shape[0]
    var = s2 / n - (s1.sum() / n) ** 2
    return mean, math.sqrt(max(float(var), 0.0))


def init_params(mean: torch.Tensor, std: float, H: int,
                g: torch.Generator) -> Dict[str, torch.Tensor]:
    """W = mean + std / sqrt(H) * N(0, 1) (D, H), pi = 1 / H, sigma = std:
    the data-driven start of a training run, float32 on mean's device."""
    D = mean.shape[0]
    noise = torch.randn((D, H), generator=g, device=mean.device,
                        dtype=torch.float64)
    W = (mean[:, None] + (std / math.sqrt(H)) * noise).float()
    dev = mean.device
    return {"W": W.contiguous(),
            "pi": torch.tensor(1.0 / H, dtype=torch.float32, device=dev),
            "sigma": torch.tensor(max(std, 1e-3), dtype=torch.float32,
                                  device=dev)}


def training_data(cfg: Dict, seed: int, n_rows: int, shard: int, device):
    """One shard's rows of a training cell and the planted dictionary they
    come from; every shard shares the dictionary."""
    p = cfg["planted"]
    W = planted_dictionary(cfg["D"], cfg["H"], p["active_pixels"],
                           p["intensity"], generator(device, seed, "dict"),
                           device)
    pi = p["pi_times_H"] / cfg["H"]
    y = rows(W, n_rows, pi, p["sigma"], cfg["superposition"],
             generator(device, seed, "rows", shard))
    return W, y
