// The GEMM kernels of sgemm.cuh at operand type __half (fp16): hgemm_nn_f16
// and hgemm_tn_splitn_f16, the linear family's compute_dtype.

#include "sgemm.cuh"

SG_HGEMM_ENTRIES(f16, __half)
