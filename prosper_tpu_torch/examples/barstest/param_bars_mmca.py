"""Bars test for MMCA (max-magnitude causes) on alternating-sign bars.

The port's copy of examples/barstest/param_bars_mmca.py, built from prosper_tpu_torch
(add --device cpu to train without a CUDA device).

Run:  python -m prosper_tpu_torch.cli train prosper_tpu_torch/examples/barstest/param_bars_mmca.py
"""

from prosper_tpu_torch.engine.anneal import LinearAnnealing
from prosper_tpu_torch.models import MMCA
from prosper_tpu_torch.data.bars import bars_gt_params

R = 4
model = MMCA(D=R * R, H=2 * R, Hprime=6, gamma=3, chunk=1000)

gt_params = bars_gt_params(model, intensity=10.0, sigma=1.0, neg_bars=True)
N = 1000
seed = 22

anneal = LinearAnnealing(80)
anneal["T"] = [(0.0, 2.0), (0.7, 1.0)]
anneal["W_noise"] = [(0.0, 1.0), (0.7, 0.0)]
anneal["Ncut_factor"] = [(0.5, 0.0), (0.8, 1.0)]
