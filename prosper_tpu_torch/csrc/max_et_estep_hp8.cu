// The max E-step kernels' instantiations for H' = 8 (max_et_estep.cu
// holds their note and the C interface), compiled apart so that the build
// compiles them in parallel with the others.

#include "max_et_estep.cuh"

namespace mxe {

template cudaError_t run<8>(const Launch&, int, float*, int*);

}  // namespace mxe
