// The float32 GEMM kernels of sgemm.cuh (split TF32) at operand type float,
// and their C entry points; the sizes of the scratch and shared memory of
// the 16-bit variants (hgemm_bf16.cu, hgemm_f16.cu), which do not depend on
// which 16-bit type.

#include "sgemm.cuh"

extern "C" {

// Bytes of shared memory a block of sgemm_nn (tn 0) or sgemm_tn_splitn
// (tn 1) takes.
size_t sgemm_smem_bytes(int tn) {
  return tn ? sg::Tr<float>::TN_SMEM : sg::Tr<float>::NN_SMEM;
}

// The same for hgemm_nn_* and hgemm_tn_splitn_*'s tn_kernel, its path for
// the shapes a tensor map cannot describe (either 16-bit type; its bulk-copy
// kernel: hgemm_tn_bulk_smem_bytes, hgemm_bf16.cu).
size_t hgemm_smem_bytes(int tn) {
  return tn ? sg::Tr<__nv_bfloat16>::TN_SMEM : sg::Tr<__nv_bfloat16>::NN_SMEM;
}

// Floats of the scratch sgemm_nn takes for B's split image.
size_t sgemm_nn_ws_floats(int D, int H) {
  return sg::nn_ws_floats<float>(D, H);
}

// Floats of the scratch hgemm_nn_* takes for B's 16-bit image.
size_t hgemm_nn_ws_floats(int D, int H) {
  return sg::nn_ws_floats<__nv_bfloat16>(D, H);
}

// C (N, H) = A (N, D) . B (D, H), float32, row-major, contiguous; img takes
// sgemm_nn_ws_floats(D, H) floats, 16-byte aligned.
int sgemm_nn(const float* A, const float* B, float* img, float* C, int N,
             int D, int H, void* stream) {
  return sg::gemm_nn<float>(A, B, img, C, N, D, H,
                            static_cast<cudaStream_t>(stream));
}

// out (M, K) = A^T . B for A (N, M), B (N, K); with accumulate, added to
// what out holds.  ws takes ceil(N / split_rows) * M * K floats: one
// partial per split, summed into out in split order.
int sgemm_tn_splitn(const float* A, const float* B, float* ws, float* out,
                    int N, int M, int K, int split_rows, int accumulate,
                    void* stream) {
  return sg::gemm_tn_splitn<float>(A, B, ws, out, N, M, K, split_rows,
                                   accumulate,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
