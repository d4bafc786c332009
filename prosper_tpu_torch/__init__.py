"""prosper_tpu_torch: the PyTorch + CUDA port of prosper-tpu.

Expectation-Truncation variational EM on one NVIDIA GPU for the linear
sparse-coding family (BSC, TSC, DSC), the maximal-causes family (MCA,
MMCA) and spike-and-slab sparse coding (GSC), and classic EM for the
mixtures (``models.mixtures.MoG``, ``MoP``):
``EM(model, anneal, {"y": y}).run()`` trains (``run_scanned()``
follows the same trajectory with no host work between iterations: CUDA
graph replays of the step), ``model.inference(params, data, top_L)``
serves posterior decodes.  With ``backend="cuda"`` (the default) the
E-steps (and the linear family's decode) run in hand-written CUDA kernels
on a CUDA device (``ops/linear_cuda.py``, ``ops/max_cuda.py``, built with
nvcc at first use by ``ops/cuda_lib.py``) and in their plain PyTorch
versions on the CPU; ``backend="plain"`` runs the plain versions on any
device.  GSC and the mixtures are plain PyTorch on any device (the JAX
package builds them from XLA ops, with no Pallas kernel).  The JAX package
``prosper_tpu`` is the reference
this port is held to; the port imports neither it nor JAX.
"""

__version__ = "0.1.0"

from prosper_tpu_torch.engine.anneal import LinearAnnealing
from prosper_tpu_torch.engine.em import EM

__all__ = ["EM", "LinearAnnealing", "__version__"]
