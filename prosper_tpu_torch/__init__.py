"""prosper_tpu_torch: the PyTorch + CUDA port of prosper-tpu.

Expectation-Truncation variational EM on one NVIDIA GPU for the linear
sparse-coding family (BSC, TSC, DSC), the maximal-causes family (MCA,
MMCA) and spike-and-slab sparse coding (GSC), and classic EM for the
mixtures (``models.mixtures.MoG``, ``MoP``):
``EM(model, anneal, {"y": y}).run()`` trains (``run_scanned()``
follows the same trajectory with no host work between iterations: CUDA
graph replays of the step), ``model.inference(params, data, top_L)``
serves posterior decodes.  Around it the run a user starts: data logs and
checkpoints (``io/``), resume (``EM.resume``), the recovery protocol
(``EM(revive_duplicates=...)``, ``data/diagnosis.py``) and the command line
(``python -m prosper_tpu_torch.cli train / infer / generate / diagnose``),
and ``StreamingEM``, which trains on a data set that stays on the host and
passes through the card in segments (``train --stream``).
``MeshRuntime`` (``parallel/mesh.py``) trains data-parallel over the ranks
of a ``torch.distributed`` group, one process per device
(``EM(..., runtime=rt)``, ``StreamingEM(..., runtime=rt)``,
``model.inference(..., runtime=rt)``, ``train --mesh data=N`` under
``torchrun``).
With ``backend="cuda"`` (the default) the
E-steps (and the linear family's decode) run in hand-written CUDA kernels
on a CUDA device (``ops/linear_cuda.py``, ``ops/max_cuda.py``, built with
nvcc at first use by ``ops/cuda_lib.py``) and in their plain PyTorch
versions on the CPU; ``backend="plain"`` runs the plain versions on any
device.  GSC's E-step has its own kernel, chosen the same way
(``ops/gsc_cuda.py``; the JAX package builds it from XLA ops, with no
Pallas kernel); the mixtures and GSC's
decode are plain PyTorch on any device.  The JAX package
``prosper_tpu`` is the reference
this port is held to; the port imports neither it nor JAX.
"""

__version__ = "0.1.0"

from prosper_tpu_torch.engine.anneal import LinearAnnealing
from prosper_tpu_torch.engine.em import EM, run_restarts
from prosper_tpu_torch.engine.stream import StreamingEM
from prosper_tpu_torch.parallel.mesh import MeshRuntime

__all__ = ["EM", "LinearAnnealing", "MeshRuntime", "StreamingEM",
           "run_restarts", "__version__"]
