"""Bars test for ternary sparse coding (TSC) — BASELINE configs[1].

The port's copy of examples/barstest/param_bars_tsc.py, built from prosper_tpu_torch
(add --device cpu to train without a CUDA device).

Alternating-sign bars; latents in {-1, 0, +1}.

Run:  python -m prosper_tpu_torch.cli train prosper_tpu_torch/examples/barstest/param_bars_tsc.py
"""

from prosper_tpu_torch.engine.anneal import LinearAnnealing
from prosper_tpu_torch.models import TSC
from prosper_tpu_torch.data.bars import bars_gt_params

R = 5
model = TSC(D=R * R, H=2 * R, Hprime=6, gamma=3)

gt_params = bars_gt_params(model, intensity=10.0, sigma=2.0)
N = 2000
seed = 19

anneal = LinearAnnealing(100)
anneal["T"] = [(0.0, 2.0), (0.7, 1.0)]
anneal["W_noise"] = [(0.0, 1.0), (0.7, 0.0)]
