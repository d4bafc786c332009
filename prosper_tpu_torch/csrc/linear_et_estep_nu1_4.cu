// The rows kernel's instantiations for NU = 1 and 4 (H <= 32, H <= 128); linear_et_estep.cu
// holds its note and the C interface.  Compiled apart so that the build
// compiles them in parallel with the others.

#include "linear_et_estep.cuh"

namespace let {

template cudaError_t run_nu<1, true>(const RowsParams&, int, size_t,
                                    int*, cudaStream_t);
template cudaError_t run_nu<1, false>(const RowsParams&, int, size_t,
                                    int*, cudaStream_t);
template cudaError_t run_nu<4, true>(const RowsParams&, int, size_t,
                                    int*, cudaStream_t);
template cudaError_t run_nu<4, false>(const RowsParams&, int, size_t,
                                    int*, cudaStream_t);

}  // namespace let
