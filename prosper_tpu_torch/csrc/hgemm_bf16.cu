// The 16-bit GEMM kernels at operand type __nv_bfloat16 (bf16), the linear
// family's compute_dtype: hgemm_nn_bf16 (sgemm.cuh's nn_kernel) and
// hgemm_tn_splitn_bf16 (hgemm_tn.cuh's bulk-copy kernel, or sgemm.cuh's
// tn_kernel for the shapes a tensor map cannot describe).

#include "hgemm_tn.cuh"

SG_HGEMM_ENTRIES(bf16, __nv_bfloat16)

// Bytes of shared memory a block of hgemm_tn_splitn's bulk-copy kernel
// takes (either 16-bit type).
extern "C" size_t hgemm_tn_bulk_smem_bytes() { return htn::SMEM; }
