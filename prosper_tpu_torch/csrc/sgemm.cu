// Two float32 GEMM kernels for sm_90a, on the CUDA cores (fmaf only):
//
//   sgemm_nn         C (N, H) = A (N, D) . B (D, H)
//   sgemm_tn_splitn  C (M, K) = A^T . B  for A (N, M), B (N, K), summed over N
//
// all row-major.  They take the D x H products of the ET E-steps out of the
// per-tile loops of the E-step kernels: the projection P = y W (the first
// product in the bodies of prosper_tpu/ops/linear_pallas.py::_kernel and
// prosper_tpu/ops/max_pallas.py::_kernel), the statistics
// xs = y^T (w <s>) of the linear family and the singleton part of numer,
// (w q_single)^T y, of the max family (the last products of those bodies).
//
// What bounds them on the H100: operations.  At the patches width (N =
// 131072, D = 256, H = 300) each product is 20.1 GFLOP over 0.3 GB of
// operands, so the float32 FMA rate of the CUDA cores is the limit, and a
// thread must do many FMAs per shared-memory load to come near it.
//
// What the design does about it: a block of 128 threads owns a 128 x 64
// tile of C; every thread keeps an 8 x 8 tile of it in registers, so one
// depth step costs it four 16-byte shared-memory loads for 64 FMAs.  Depth
// slabs of 16 are staged in shared memory by cp.async, double buffered, so
// the next slab's loads run under this slab's FMAs.  The eight columns of a
// thread are two groups of four, 32 apart, so that the eight threads of a
// quarter warp read 32 consecutive floats of the B slab (no bank conflict);
// the A values of a quarter warp are one address (a broadcast).  With
// thousands of blocks in flight and four or five resident per SM, the
// loads of one block hide behind the FMAs of the others.
//
// sgemm_tn_splitn reduces over N, which is the long dimension (C is only
// M x K = D x H), so N is cut into splits of split_rows rows: the grid is
// (M tiles, K tiles, splits), every split writes its own (M, K) partial
// and reduce_blocks sums the partials in split order.  No float atomics:
// the result is the same in every run.  Both operands arrive as rows of
// N, so a slab is 16 rows of A and of B and needs no transposition.
//
// Ragged shapes are masked: loads past an edge are zero-filled (cp.async
// with a source size of 0), stores past an edge are skipped.  Where a row
// length is no multiple of 4 floats or a pointer not 16-byte aligned, the
// copies are 4 bytes wide instead of 16 (the template parameter VEC).
//
// Numerics: as the other sources (-fmad=false, no fast math); each C entry
// is one fmaf chain over the depth in ascending order (per split).  On
// inputs quantised to multiples of 1/4 the products are exact in any order.

#include <stdint.h>

#include "cp_async.cuh"
#include "linear_et_frontend.cuh"

namespace sg {

constexpr int BM = 128;        // rows of the C tile
constexpr int BN = 64;         // columns of the C tile
constexpr int BK = 16;         // depth of a slab
constexpr int THREADS = 128;   // 16 x 8 threads, an 8 x 8 register tile each
constexpr int AS = BK + 4;     // row stride of sgemm_nn's A slab [m][k]

// Copy a (rows x cols) slab, rows r0.. and columns c0.. of the row-major
// matrix src (ld floats per row, n_rows x n_cols valid), into dst with
// row stride dstride; entries outside the matrix become 0.
template <bool VEC, int ROWS, int COLS>
__device__ inline void load_slab(float* dst, int dstride, const float* src,
                                 int ld, int r0, int c0, int n_rows,
                                 int n_cols) {
  const int tid = threadIdx.x;
  if (VEC) {
    constexpr int CH = COLS / 4;             // 16-byte chunks per row
#pragma unroll
    for (int c = tid; c < ROWS * CH; c += THREADS) {
      const int r = c / CH, cc = (c - r * CH) * 4;
      const bool ok = r0 + r < n_rows && c0 + cc < n_cols;
      const float* s = ok ? src + (size_t)(r0 + r) * ld + c0 + cc : src;
      cp_async16(dst + r * dstride + cc, s, ok);
    }
  } else {
#pragma unroll
    for (int e = tid; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, cc = e - r * COLS;
      const bool ok = r0 + r < n_rows && c0 + cc < n_cols;
      const float* s = ok ? src + (size_t)(r0 + r) * ld + c0 + cc : src;
      cp_async4(dst + r * dstride + cc, s, ok);
    }
  }
}

// acc[i][0..3] += a[i] * b0, acc[i][4..7] += a[i] * b1
__device__ inline void fma_row(float (&acc)[8], float a, const float4& b0,
                               const float4& b1) {
  acc[0] = fmaf(a, b0.x, acc[0]);
  acc[1] = fmaf(a, b0.y, acc[1]);
  acc[2] = fmaf(a, b0.z, acc[2]);
  acc[3] = fmaf(a, b0.w, acc[3]);
  acc[4] = fmaf(a, b1.x, acc[4]);
  acc[5] = fmaf(a, b1.y, acc[5]);
  acc[6] = fmaf(a, b1.z, acc[6]);
  acc[7] = fmaf(a, b1.w, acc[7]);
}

// Write the thread's 8 x 8 tile: rows m0 + ty*8 + i, columns n0 + tx*4 + j
// and n0 + 32 + tx*4 + j, of the (n_rows, n_cols) matrix C.
template <bool VEC>
__device__ inline void store_tile(float* C, int n_rows, int n_cols, int m0,
                                  int n0, int ty, int tx,
                                  const float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= n_rows) continue;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int n = n0 + 32 * g + tx * 4;
      float* c = C + (size_t)m * n_cols + n;
      if (VEC) {
        if (n < n_cols)
          *reinterpret_cast<float4*>(c) = make_float4(
              acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
              acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < n_cols) c[j] = acc[i][4 * g + j];
      }
    }
  }
}

// C (N, H) = A (N, D) . B (D, H).  grid (H tiles, N tiles): the column
// tiles of one row tile are neighbours, so A's rows are read from the L2.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
nn_kernel(const float* __restrict__ A, const float* __restrict__ B,
          float* __restrict__ C, int N, int D, int H) {
  __shared__ __align__(16) float As[2][BM * AS];
  __shared__ __align__(16) float Bs[2][BK * BN];
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (D + BK - 1) / BK;
  load_slab<VEC, BM, BK>(As[0], AS, A, D, m0, 0, N, D);
  load_slab<VEC, BK, BN>(Bs[0], BN, B, H, 0, n0, D, H);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) {
      load_slab<VEC, BM, BK>(As[cur ^ 1], AS, A, D, m0, (t + 1) * BK, N, D);
      load_slab<VEC, BK, BN>(Bs[cur ^ 1], BN, B, H, (t + 1) * BK, n0, D, H);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = As[cur] + ty * 8 * AS;
    const float* bs = Bs[cur] + tx * 4;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + i * AS + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(
            bs + (k4 + kk) * BN);
        const float4 b1 = *reinterpret_cast<const float4*>(
            bs + (k4 + kk) * BN + 32);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
          fma_row(acc[i], av, b0, b1);
        }
      }
    }
    __syncthreads();   // the slab is consumed before it is loaded again
  }
  store_tile<VEC>(C, N, H, m0, n0, ty, tx, acc);
}

// One split's partial of C (M, K) = A^T . B over the rows
// [z * split_rows, (z + 1) * split_rows) of A (N, M) and B (N, K), into
// ws + z * M * K.  grid (M tiles, K tiles, splits).
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
tn_kernel(const float* __restrict__ A, const float* __restrict__ B,
          float* __restrict__ ws, int N, int M, int K, int split_rows) {
  __shared__ __align__(16) float As[2][BK * BM];
  __shared__ __align__(16) float Bs[2][BK * BN];
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int r_begin = blockIdx.z * split_rows;
  const int r_end = min(N, r_begin + split_rows);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (r_end - r_begin + BK - 1) / BK;
  load_slab<VEC, BK, BM>(As[0], BM, A, M, r_begin, m0, r_end, M);
  load_slab<VEC, BK, BN>(Bs[0], BN, B, K, r_begin, n0, r_end, K);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) {
      const int r0 = r_begin + (t + 1) * BK;
      load_slab<VEC, BK, BM>(As[cur ^ 1], BM, A, M, r0, m0, r_end, M);
      load_slab<VEC, BK, BN>(Bs[cur ^ 1], BN, B, K, r0, n0, r_end, K);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = As[cur] + ty * 8;
    const float* bs = Bs[cur] + tx * 4;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * BM);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * BM + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * BN);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * BN + 32);
      fma_row(acc[0], a0.x, b0, b1);
      fma_row(acc[1], a0.y, b0, b1);
      fma_row(acc[2], a0.z, b0, b1);
      fma_row(acc[3], a0.w, b0, b1);
      fma_row(acc[4], a1.x, b0, b1);
      fma_row(acc[5], a1.y, b0, b1);
      fma_row(acc[6], a1.z, b0, b1);
      fma_row(acc[7], a1.w, b0, b1);
    }
    __syncthreads();   // the slab is consumed before it is loaded again
  }
  store_tile<VEC>(ws + (size_t)blockIdx.z * M * K, M, K, m0, n0, ty, tx, acc);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace sg

extern "C" {

// C (N, H) = A (N, D) . B (D, H), float32, row-major, contiguous.
int sgemm_nn(const float* A, const float* B, float* C, int N, int D, int H,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((H + sg::BN - 1) / sg::BN, (N + sg::BM - 1) / sg::BM);
  const bool vec = D % 4 == 0 && H % 4 == 0 && sg::aligned16(A)
                   && sg::aligned16(B) && sg::aligned16(C);
  if (vec)
    sg::nn_kernel<true><<<grid, sg::THREADS, 0, s>>>(A, B, C, N, D, H);
  else
    sg::nn_kernel<false><<<grid, sg::THREADS, 0, s>>>(A, B, C, N, D, H);
  return static_cast<int>(cudaGetLastError());
}

// out (M, K) = A^T . B for A (N, M), B (N, K); with accumulate, added to
// what out holds.  ws takes ceil(N / split_rows) * M * K floats: one
// partial per split, summed into out in split order.
int sgemm_tn_splitn(const float* A, const float* B, float* ws, float* out,
                    int N, int M, int K, int split_rows, int accumulate,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_split = (N + split_rows - 1) / split_rows;
  const dim3 grid((M + sg::BM - 1) / sg::BM, (K + sg::BN - 1) / sg::BN,
                  n_split);
  const bool vec = M % 4 == 0 && K % 4 == 0 && sg::aligned16(A)
                   && sg::aligned16(B) && sg::aligned16(ws);
  if (vec)
    sg::tn_kernel<true><<<grid, sg::THREADS, 0, s>>>(A, B, ws, N, M, K,
                                                     split_rows);
  else
    sg::tn_kernel<false><<<grid, sg::THREADS, 0, s>>>(A, B, ws, N, M, K,
                                                      split_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t mk = (size_t)M * K;
  let::reduce_blocks<<<(unsigned)((mk + 255) / 256), 256, 0, s>>>(
      ws, out, n_split, mk, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
