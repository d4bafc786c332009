// The 16-bit GEMM kernels at operand type __half (fp16), the linear
// family's compute_dtype: hgemm_nn_f16 (sgemm.cuh's nn_kernel) and
// hgemm_tn_splitn_f16 (hgemm_tn.cuh's bulk-copy kernel, or sgemm.cuh's
// tn_kernel for the shapes a tensor map cannot describe).

#include "hgemm_tn.cuh"

SG_HGEMM_ENTRIES(f16, __half)
