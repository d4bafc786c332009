"""Bars test for spike-and-slab GSC — BASELINE configs[3].

The port's copy of examples/barstest/param_bars_gsc.py, built from prosper_tpu_torch
(add --device cpu to train without a CUDA device).

Continuous slab amplitudes z ~ N(mu, psi) on binary supports.

Run:  python -m prosper_tpu_torch.cli train prosper_tpu_torch/examples/barstest/param_bars_gsc.py
"""

import numpy as np

from prosper_tpu_torch.engine.anneal import LinearAnnealing
from prosper_tpu_torch.models import GSC
from prosper_tpu_torch.data.bars import bars_gt_params

R = 4
model = GSC(D=R * R, H=2 * R, Hprime=5, gamma=3, chunk=1500)

gt_params = bars_gt_params(model, intensity=5.0, sigma=1.0)
gt_params["mu"] = np.float32(1.0)
gt_params["psi"] = np.float32(0.09)
N = 1500
seed = 31

anneal = LinearAnnealing(80)
anneal["T"] = [(0.0, 2.0), (0.7, 1.0)]
anneal["W_noise"] = [(0.0, 0.5), (0.7, 0.0)]
