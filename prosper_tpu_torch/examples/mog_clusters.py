"""Mixture of Gaussians through the port: recover planted clusters.

The port's counterpart of ``examples/mog_clusters.py``, a config for the
port's command line (the same numbers as the JAX package's):

    python -m prosper_tpu_torch.cli train prosper_tpu_torch/examples/mog_clusters.py -o out
"""

import numpy as np

from prosper_tpu_torch.engine.anneal import LinearAnnealing
from prosper_tpu_torch.models.mixtures import MoG

D, K = 8, 3
model = MoG(D, K)

_rng = np.random.default_rng(0)
gt_params = {
    "pi": np.array([0.5, 0.3, 0.2], np.float32),
    "mu": (_rng.standard_normal((K, D)) * 4).astype(np.float32),
    "sigma": np.array([0.5, 0.7, 0.6], np.float32),
}
N = 4000
seed = 1

anneal = LinearAnnealing(40)
anneal["T"] = [(0.0, 1.5), (0.5, 1.0)]
