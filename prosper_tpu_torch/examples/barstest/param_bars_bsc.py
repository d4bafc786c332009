"""Bars test for BSC-ET — the reference's canonical experiment config.

The port's copy of examples/barstest/param_bars_bsc.py, built from prosper_tpu_torch
(add --device cpu to train without a CUDA device).

Reference behavior: SURVEY.md §2 "Example scripts"
(examples/barstest/param-bars-et-bsc.py — mount unavailable): an exec'd
Python param module defining model, annealing, data and output.
BASELINE.json configs[0]: H'=6, gamma=3, N=1000 on 5x5 bars.

Run:  python -m prosper_tpu_torch.cli train prosper_tpu_torch/examples/barstest/param_bars_bsc.py
"""

from prosper_tpu_torch.engine.anneal import LinearAnnealing
from prosper_tpu_torch.models import BSC
from prosper_tpu_torch.data.bars import bars_gt_params

R = 5                       # bars grid -> D = R*R pixels, 2R bars
model = BSC(D=R * R, H=2 * R, Hprime=6, gamma=3)

gt_params = bars_gt_params(model, intensity=10.0, sigma=2.0)
N = 1000
seed = 11

anneal = LinearAnnealing(100)
anneal["T"] = [(0.0, 2.0), (0.7, 1.0)]
anneal["W_noise"] = [(0.0, 1.0), (0.7, 0.0)]
anneal["Ncut_factor"] = [(0.5, 0.0), (0.9, 1.0)]
