"""MCA on synthetic occlusion data through the port.

The port's counterpart of ``examples/mca_occlusion.py``.  Maximal causes
(``ybar_d = max_h W_dh s_h``) model scenes where opaque objects occlude
each other: the brightest cause wins a pixel instead of adding to the
others.  The example plants overlapping rectangular objects on a small
canvas, composes scenes by the per-pixel max, and fits them with MCA and
with the linear BSC, both with revival of duplicate columns: MCA recovers
the objects, BSC blends the occluders where they overlap.

    python -m prosper_tpu_torch.examples.mca_occlusion               # the card
    python -m prosper_tpu_torch.examples.mca_occlusion --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np


def planted_objects(R: int = 8, H: int = 8, seed: int = 0) -> np.ndarray:
    """(D, H) dictionary of overlapping bright rectangles on an R x R
    canvas, crowded into its centre so that they overlap (the same draws as
    the JAX package's example)."""
    rng = np.random.default_rng(seed)
    W = np.zeros((R, R, H), np.float32)
    for h in range(H):
        r0, c0 = rng.integers(1, R - 4, size=2)
        hgt, wid = rng.integers(3, 5, size=2)
        W[r0:r0 + hgt, c0:c0 + wid, h] = rng.uniform(5.0, 12.0)
    return W.reshape(R * R, H)


def main(R: int = 8, H: int = 8, N: int = 4096, iters: int = 80,
         seed: int = 0, device="cuda"):
    """Fit one occlusion data set with MCA and with BSC; returns the objects
    each recovers (cosine > 0.85 under the optimal assignment)."""
    from prosper_tpu_torch.data.bars import cosine_match
    from prosper_tpu_torch.engine.anneal import LinearAnnealing
    from prosper_tpu_torch.engine.em import EM
    from prosper_tpu_torch.models import BSC, MCA

    D = R * R
    gtW = planted_objects(R, H, seed)
    gt = {"W": gtW, "pi": np.float32(2.5 / H), "sigma": np.float32(0.5)}
    # one data set composed by the per-pixel max, fit by both families
    data = MCA(D, H, Hprime=5, gamma=3, chunk=512).generate_data(
        gt, N, seed=seed + 1)

    def train(model, label):
        anneal = LinearAnnealing(iters)
        anneal["T"] = [(0.0, 1.5), (0.6, 1.0)]
        anneal["W_noise"] = [(0.0, 0.5), (0.6, 0.0)]
        em = EM(model, anneal, {"y": data["y"]}, seed=seed + 2,
                device=device, revive_duplicates=(10, 0.9, 0.75))
        params = em.run()
        _, cos = cosine_match(params["W"].cpu().numpy(), gtW)
        rec = int((cos > 0.85).sum())
        print(f"[{label}] recovered {rec}/{H} objects "
              f"(mean cosine {cos.mean():.3f})", flush=True)
        return rec

    rec_mca = train(MCA(D, H, Hprime=5, gamma=3, chunk=512), "mca")
    rec_bsc = train(BSC(D, H, Hprime=5, gamma=3, chunk=512),
                    "bsc-on-occlusion")
    print(f"[occlusion] MCA {rec_mca}/{H} vs linear {rec_bsc}/{H}")
    return rec_mca, rec_bsc


if __name__ == "__main__":
    p = argparse.ArgumentParser(
        prog="python -m prosper_tpu_torch.examples.mca_occlusion")
    p.add_argument("--N", type=int, default=4096)
    p.add_argument("--iters", type=int, default=80)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(N=a.N, iters=a.iters, device=a.device)
