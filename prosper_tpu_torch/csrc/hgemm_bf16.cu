// The GEMM kernels of sgemm.cuh at operand type __nv_bfloat16 (bf16): hgemm_nn_bf16
// and hgemm_tn_splitn_bf16, the linear family's compute_dtype.

#include "sgemm.cuh"

SG_HGEMM_ENTRIES(bf16, __nv_bfloat16)
