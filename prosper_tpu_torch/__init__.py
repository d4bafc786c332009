"""prosper_tpu_torch: the PyTorch + CUDA port of prosper-tpu.

Expectation-Truncation variational EM for the linear sparse-coding family
(BSC, TSC, DSC) on one NVIDIA GPU: ``EM(model, anneal, {"y": y}).run()``
trains, ``model.inference(params, data, top_L)`` serves posterior decodes.
The E-step and the decode run in hand-written CUDA kernels on a CUDA device
(``ops/linear_cuda.py``, built with nvcc at first use) and in their plain
PyTorch versions on the CPU.  The JAX package ``prosper_tpu`` is the
reference this port is held to; the port imports neither it nor JAX.
"""

__version__ = "0.1.0"

from prosper_tpu_torch.engine.anneal import LinearAnnealing
from prosper_tpu_torch.engine.em import EM

__all__ = ["EM", "LinearAnnealing", "__version__"]
