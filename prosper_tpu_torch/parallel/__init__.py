"""The data-parallel runtime (counterpart of ``prosper_tpu/parallel``)."""

from prosper_tpu_torch.parallel.mesh import (MeshRuntime, init_multihost,
                                             maybe_pmax, maybe_pmin,
                                             maybe_psum, pprint,
                                             replication_error, stride_data)

__all__ = [
    "MeshRuntime",
    "init_multihost",
    "maybe_psum",
    "maybe_pmax",
    "maybe_pmin",
    "pprint",
    "replication_error",
    "stride_data",
]
