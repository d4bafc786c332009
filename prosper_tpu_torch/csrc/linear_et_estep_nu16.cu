// The rows kernel's instantiations for NU = 16 (H <= 512); linear_et_estep.cu
// holds its note and the C interface.  Compiled apart so that the build
// compiles them in parallel with the others.

#include "linear_et_estep.cuh"

namespace let {

template cudaError_t run_nu<16, true>(const RowsParams&, int, size_t,
                                    int*, cudaStream_t);
template cudaError_t run_nu<16, false>(const RowsParams&, int, size_t,
                                    int*, cudaStream_t);

}  // namespace let
