// The max E-step kernels' instantiations for H' = 2-5 (max_et_estep.cu
// holds their note and the C interface), compiled apart so that the build
// compiles them in parallel with the others.

#include "max_et_estep.cuh"

namespace mxe {

template cudaError_t run<2>(const Launch&, int, float*, int*);
template cudaError_t run<3>(const Launch&, int, float*, int*);
template cudaError_t run<4>(const Launch&, int, float*, int*);
template cudaError_t run<5>(const Launch&, int, float*, int*);

}  // namespace mxe
