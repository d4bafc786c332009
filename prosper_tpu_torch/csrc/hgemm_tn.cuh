// hgemm_tn_splitn for sm_90a: R (M, K) = A^T . B of A (N, M) and B (N, K)
// rounded to bf16 or fp16, summed over N in float32, the linear family's
// xs = y^T (w <s>) at a 16-bit compute_dtype (the JAX package's XLA dot in
// prosper_tpu/core/etstep.py::_chunk_estats and _chunk_estats_bigs; inside
// prosper_tpu/ops/linear_pallas.py::_kernel at float32).
//
// What bounds it on the H100: at the patches width (N = 131072, M = 256,
// K = 300) it reads 292 MB of float32 operands, 0.087 ms at 3.35 TB/s, and
// does 20.1 GFLOP of 16-bit products, 0.020 ms at 989 TFLOP/s: bytes.  It is
// a streaming reduction; its design keeps bytes in flight, not the tensor
// cores busy.
//
// What the design does about it.  N is cut into splits (split_rows rows,
// one partial each, summed in split order by reduce_blocks: no atomics),
// and a block owns a BM x BN = 128 x 152 tile of one split's partial (at
// the patches width 2 x 2 tiles x 33 splits: one block an SM, each box of
// an operand read by two blocks, the second time from the L2).  Both
// operands arrive as rows of N, which is the depth of the product: in the
// MMA's terms they are MN-major.  A block is three warpgroups, each in one
// role, handing slabs of BK = 32 rows over through mbarriers, never through
// block barriers:
//
// * the converters (warpgroup 2), one thread of which is also the
//   producer: two bulk tensor copies (TMA, cp.async.bulk.tensor.2d,
//   completing on the stage's mbarrier with a byte count) a slab, the
//   BK x 128 box of A and the BK x 152 box of B, raw float32, into a ring
//   of RAW_STAGES raw slabs; the copy engine fills what lies past N or past
//   an operand's columns with zeros;
// * the four warps round each arrived raw slab to T, elementwise, by
//   cvt.rn.{bf16,f16}x2.f32 (to nearest, ties to even) into MN-major tiles
//   in the 128-byte swizzle (64 values of a row of depth in 128 bytes,
//   eight rows an atom of 1024 bytes), a ring of RND_STAGES; rows past the
//   split's end are written as zeros.  No transposition: half the bytes
//   are written that were read, each thread's loads issued before its
//   stores;
// * two consumer warpgroups, 64 rows of the tile each, issue
//   wgmma.m64n152k16 with both operands read from shared memory through
//   MN-major descriptors (transpose immediates set), no fragment in
//   registers.  setmaxnreg moves registers from the converters to them.
//
// Numerics: those of sgemm.cuh's 16-bit kernels.  Products of two 16-bit
// numbers are exact; each slab's two k16 steps are summed by the tensor
// cores into a fresh float32 accumulator (a depth of 32), which is then
// added to the thread's running sum with fadd, slab after slab, in order.
// So two calls give the same bits, and quarter-quantised inputs give exact
// results.  One wait a slab (wgmma.wait_group 0): two fresh accumulators do
// not fit beside the running sum.
//
// Shapes a tensor map cannot describe (a row stride that is no multiple
// of 16 bytes, a pointer not 16-byte aligned) go to sgemm.cuh's
// tn_kernel<T, false> (cp.async of 4 bytes); the host chooses by that rule
// (ops/gemm_cuda.py::hgemm_tn_bulk), and this kernel refuses other shapes.
// The tensor maps are encoded on the host at each call by the CUDA driver's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint: the
// library links the runtime alone.

#pragma once

#include <cuda.h>

#include "sgemm.cuh"

namespace htn {

using sg::BM;
using sg::BN;
using sg::ROW;

constexpr int BK = 32;               // rows of depth a slab: two k16 steps
// raw slabs in flight, rounded slabs: deeper raw rings were slower on the
// H100 (tools/torch_kernel_times.py ablate's variants), the blocks that
// share a box drifting apart and finding it less often in the L2
constexpr int RAW_STAGES = 3;
constexpr int RND_STAGES = 3;
constexpr int CONSUMERS = 256;       // two warpgroups, 64 tile rows each
constexpr int CONVERTERS = 128;      // one warpgroup; its thread 0 copies
constexpr int THREADS = CONSUMERS + CONVERTERS;
// registers a thread after setmaxnreg: 256 x 208 + 128 x 88 = 384 x 168,
// what a block of 384 threads is given at launch
constexpr int REG_CONSUMER = 208, REG_CONVERTER = 88;
constexpr int ATOM = 1024;           // 8 rows of 128 bytes, swizzled
constexpr int MN = ROW / 2;          // 16-bit values in a row of an atom
constexpr int COL_BYTES = BK / 8 * ATOM;   // an atom column of a slab
constexpr int RAW_A = BK * BM * 4, RAW_B = BK * BN * 4;
constexpr int RAW = RAW_A + RAW_B;     // the bytes of a slab's two boxes
constexpr int RND_A = BM / MN * COL_BYTES;
constexpr int RND_B = (BN + MN - 1) / MN * COL_BYTES;
constexpr int RND = RND_A + RND_B;
// mbarriers: raw slab arrived (RAW_STAGES), rounded slab ready and rounded
// slab free (RND_STAGES each)
constexpr int BARS = RAW_STAGES + 2 * RND_STAGES;
constexpr int SMEM = RND_STAGES * RND + RAW_STAGES * RAW + 8 * BARS + 1024;
static_assert(RND % ATOM == 0 && RAW % 16 == 0 && RAW_A % 16 == 0,
              "tiles on 1024-byte atoms, raw rows on 16 bytes");
static_assert(BM == 2 * MN && BK % 16 == 0 && BN % 8 == 0, "tile shape");
static_assert(SMEM <= 232448, "more shared memory than a block may have");
static_assert(CONSUMERS * REG_CONSUMER + CONVERTERS * REG_CONVERTER
                  == THREADS * (65536 / THREADS / 8 * 8),
              "setmaxnreg must hand over exactly the registers of a launch");

// ---- mbarriers and tensor copies --------------------------------------------

__device__ inline void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also announces the bytes the phase's copies will bring.
__device__ inline void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ inline bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile("{\n"
               ".reg .pred p;\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n"
               "}\n"
               : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Waits until the phase of parity `parity` has completed.  A wait of some
// ten seconds is a fault of the kernel (a byte count that does not match
// its copies), so it traps rather than hang the card.
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// The box of the tensor map at (column c, row r) into dst, completing on
// bar.
__device__ inline void tma_box(uint32_t dst, const CUtensorMap* map, int c,
                               int r, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r),
      "r"(bar) : "memory");
}

// The converters' own barrier (barrier 1; 0 is __syncthreads).
__device__ inline void converters_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONVERTERS) : "memory");
}

// ---- MN-major operands ------------------------------------------------------

// Descriptor of an MN-major tile in the 128-byte swizzle: rows of depth of
// 64 values (128 bytes), eight rows an atom; the atoms of a 64-wide column
// follow one another (stride byte offset: 1024, the next eight rows of
// depth), the next 64 columns start COL_BYTES later (leading byte offset).
__device__ inline uint64_t desc_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4)
         | (static_cast<uint64_t>(COL_BYTES >> 4) << 16)
         | (static_cast<uint64_t>(ATOM >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

#define HT_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
// d (+)= A (64 x 16) . B (16 x 152), both MN-major in shared memory;
// scale_d 0 ignores d's value.
#define HT_WGMMA(TYPES)                                                   \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %78, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n152k16.f32." TYPES " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "               \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "      \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "      \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "      \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "      \
      "%72, %73, %74, %75}, %76, %77, p, 1, 1, 1, 1;\n"                   \
      "}\n"                                                               \
      : HT_D4(0), HT_D4(4), HT_D4(8), HT_D4(12), HT_D4(16), HT_D4(20),    \
        HT_D4(24), HT_D4(28), HT_D4(32), HT_D4(36), HT_D4(40), HT_D4(44), \
        HT_D4(48), HT_D4(52), HT_D4(56), HT_D4(60), HT_D4(64), HT_D4(68), \
        HT_D4(72)                                                         \
      : "l"(da), "l"(db), "r"(scale_d))

template <typename T>
__device__ inline void wgmma_mn(float (&d)[sg::NACC], uint64_t da,
                                uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    HT_WGMMA("bf16.bf16");
  else
    HT_WGMMA("f16.f16");
}

#undef HT_WGMMA
#undef HT_D4

// The place in the MN-major tile of the four values of raw row r from
// column c on: atom column c / 64, atom r / 8, row r % 8 of it, 16-byte
// chunk (c % 64) / 8 swizzled by r % 8, half c % 8 / 4.
__device__ inline int tile_offset(int r, int c) {
  return (c / MN) * COL_BYTES + (r >> 3) * ATOM + (r & 7) * ROW
         + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 4) << 1);
}

// The raw slab's BK rows of COLS floats (packed, rows after one another)
// rounded to T into the MN-major tile at dst; rows from `rows` on are
// written as zeros.  Converter ct takes the 16-byte pieces (four floats)
// ct, ct + 128, ...: a warp reads 512 consecutive bytes and writes whole
// 128-byte rows of the tile, both free of bank conflicts.  All of a
// thread's loads are issued before its first store.
template <typename T, int COLS>
__device__ inline void round_rows(const float* raw, uint8_t* dst, int rows,
                                  int ct) {
  constexpr int QUADS = COLS / 4, ALL = BK * QUADS;
  constexpr int PER = (ALL + CONVERTERS - 1) / CONVERTERS;
  float4 v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = ct + k * CONVERTERS;
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((ALL % CONVERTERS == 0 || i < ALL) && i / QUADS < rows)
      v[k] = reinterpret_cast<const float4*>(raw)[i];
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = ct + k * CONVERTERS;
    if (ALL % CONVERTERS != 0 && i >= ALL) break;
    *reinterpret_cast<uint2*>(dst + tile_offset(i / QUADS, 4 * (i % QUADS))) =
        make_uint2(sg::pack16<T>(v[k].x, v[k].y),
                   sg::pack16<T>(v[k].z, v[k].w));
  }
}

// One split's partial of R (P, Q) = X^T . Y over the rows
// [z * split_rows, (z + 1) * split_rows) of X (N, P) and Y (N, Q), into
// ws + z * P * Q: R itself, or with trans its transpose (Q, P).  grid
// (P tiles, Q tiles, splits).  mx, my: tensor maps of X and Y (tensor_map).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
htn_bulk_kernel(const __grid_constant__ CUtensorMap mx,
                const __grid_constant__ CUtensorMap my,
                float* __restrict__ ws, int N, int P, int Q, int split_rows,
                int trans) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sg::align_1024(smem_raw);
  uint8_t* rnd = smem;                          // RND_STAGES rounded slabs
  uint8_t* raw = smem + RND_STAGES * RND;       // RAW_STAGES raw slabs
  const uint32_t bars = sg::smem_u32(raw + RAW_STAGES * RAW);
  auto full_raw = [&](int s) { return bars + 8 * s; };
  auto full_rnd = [&](int b) { return bars + 8 * (RAW_STAGES + b); };
  auto free_rnd = [&](int b) {
    return bars + 8 * (RAW_STAGES + RND_STAGES + b);
  };
  const int tid = threadIdx.x, lane = tid & 31;
  const int p0 = blockIdx.x * BM, q0 = blockIdx.y * BN;
  const int r_begin = blockIdx.z * split_rows;
  const int r_end = min(N, r_begin + split_rows);
  const int nt = (r_end - r_begin + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < RAW_STAGES; ++s) mbar_init(full_raw(s), 1);
    for (int b = 0; b < RND_STAGES; ++b) {
      mbar_init(full_rnd(b), CONVERTERS / 32);
      mbar_init(free_rnd(b), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- converters; thread 0 of them also issues the copies --------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REG_CONVERTER));
    const int ct = tid - CONSUMERS;
    const bool producer = ct == 0;
    // slab t's two boxes into raw stage s; the stage's mbarrier expects
    // their bytes
    auto issue = [&](int t, int s) {
      const uint32_t bar = full_raw(s), st = sg::smem_u32(raw + s * RAW);
      mbar_expect(bar, RAW);        // both boxes, zero-filled past the edges
      tma_box(st, &mx, p0, r_begin + t * BK, bar);
      tma_box(st + RAW_A, &my, q0, r_begin + t * BK, bar);
    };
    if (producer)
      for (int t = 0; t < min(nt, RAW_STAGES); ++t) issue(t, t);
    int s = 0, ps = 0, b = 0, pb = 0;    // stages and their phases' parity
    for (int t = 0; t < nt; ++t) {
      mbar_wait(full_raw(s), ps);
      mbar_wait(free_rnd(b), pb ^ 1);
      const int rows = min(BK, r_end - (r_begin + t * BK));
      const float* in = reinterpret_cast<const float*>(raw + s * RAW);
      uint8_t* out = rnd + b * RND;
      round_rows<T, BM>(in, out, rows, ct);
      round_rows<T, BN>(in + BK * BM, out + RND_A, rows, ct);
      sg::fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(full_rnd(b));
      converters_sync();              // all have read raw stage s
      if (producer && t + RAW_STAGES < nt) issue(t + RAW_STAGES, s);
      if (++s == RAW_STAGES) s = 0, ps ^= 1;
      if (++b == RND_STAGES) b = 0, pb ^= 1;
    }
  } else {
    // ---- consumers ----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REG_CONSUMER));
    const int wg = tid >> 7;             // 64 rows of the tile each
    float acc[sg::NACC], part[sg::NACC];
#pragma unroll
    for (int i = 0; i < sg::NACC; ++i) acc[i] = part[i] = 0.f;
    int b = 0, pb = 0;
    for (int t = 0; t < nt; ++t) {
      mbar_wait(full_rnd(b), pb);
      const uint32_t ta = sg::smem_u32(rnd + b * RND) + wg * COL_BYTES;
      const uint32_t tb = sg::smem_u32(rnd + b * RND + RND_A);
      sg::fence_regs(part);
      sg::wgmma_fence();
      wgmma_mn<T>(part, desc_mn(ta), desc_mn(tb), 0);
      wgmma_mn<T>(part, desc_mn(ta + 2 * ATOM), desc_mn(tb + 2 * ATOM), 1);
      sg::wgmma_commit();
      sg::wgmma_wait0();
      sg::fence_regs(part);
      __syncwarp();
      if (lane == 0) mbar_arrive(free_rnd(b));
#pragma unroll
      for (int i = 0; i < sg::NACC; ++i) acc[i] += part[i];
      if (++b == RND_STAGES) b = 0, pb ^= 1;
    }

    const sg::Frag f;
    float* out = ws + (size_t)blockIdx.z * P * Q;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = p0 + f.row0 + 8 * h, q = q0 + 8 * j + 2 * f.q + e;
          if (p < P && q < Q)
            out[trans ? (size_t)q * P + p : (size_t)p * Q + q] =
                acc[4 * j + 2 * h + e];
        }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The CUDA driver's cuTensorMapEncodeTiled, asked for once.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &q) == cudaSuccess
                   && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of the row-major float32 (rows, cols) at src, in boxes of
// BK rows and `box` columns, no swizzle, zeros past its edges.
inline cudaError_t tensor_map(CUtensorMap* map, const float* src, int rows,
                              int cols, int box) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t boxdim[2] = {(cuuint32_t)box, (cuuint32_t)BK};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(src), dim, stride, boxdim, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <typename T>
static cudaError_t launch_bulk(dim3 grid, cudaStream_t s, const float* X,
                               const float* Y, float* ws, int N, int P, int Q,
                               int split_rows, int trans) {
  static launch_once::DeviceOnce once;
  cudaError_t e =
      launch_once::prepare_kernel(htn_bulk_kernel<T>, once, true);
  if (e != cudaSuccess) return e;
  CUtensorMap mx, my;
  if ((e = tensor_map(&mx, X, N, P, BM)) != cudaSuccess) return e;
  if ((e = tensor_map(&my, Y, N, Q, BN)) != cudaSuccess) return e;
  htn_bulk_kernel<T><<<grid, THREADS, SMEM, s>>>(mx, my, ws, N, P, Q,
                                                  split_rows, trans);
  return cudaGetLastError();
}

// hgemm_tn_splitn: the bulk-copy kernel where `bulk` (the host's rule,
// ops/gemm_cuda.py::hgemm_tn_bulk: M and K multiples of 4, both pointers
// 16-byte aligned; refused otherwise), else tn_kernel<T, false>; then the
// partials summed in split order (sgemm.cuh's tn_splits, which also chooses
// which operand takes the tile's 128 rows).
template <typename T>
int gemm_tn_splitn16(const float* A, const float* B, float* ws, float* out,
                     int N, int M, int K, int split_rows, int accumulate,
                     int bulk, cudaStream_t s) {
  return sg::tn_splits(
      A, B, ws, out, N, M, K, split_rows, accumulate, s,
      [=](dim3 grid, const float* X, const float* Y, int P, int Q,
          int trans) -> cudaError_t {
        if (!bulk)
          return sg::launch_tn<T, false>(grid, s, X, Y, ws, N, P, Q,
                                         split_rows, trans);
        if (P % 4 != 0 || Q % 4 != 0 || !sg::aligned16(X)
            || !sg::aligned16(Y))
          return cudaErrorInvalidValue;
        return launch_bulk<T>(grid, s, X, Y, ws, N, P, Q, split_rows, trans);
      });
}

}  // namespace htn

// The C entry points of the 16-bit GEMMs at operand type T, named
// hgemm_nn_SUFFIX and hgemm_tn_splitn_SUFFIX: sgemm_nn and sgemm_tn_splitn
// of A and B rounded to T, summed in float32.  hgemm_nn's img takes
// hgemm_nn_ws_floats(D, H) floats, 16-byte aligned (sgemm.cu);
// hgemm_tn_splitn's `bulk` is ops/gemm_cuda.py::hgemm_tn_bulk's choice.
#define SG_HGEMM_ENTRIES(SUFFIX, T)                                          \
  extern "C" int hgemm_nn_##SUFFIX(const float* A, const float* B,          \
                                   float* img, float* C, int N, int D,      \
                                   int H, void* stream) {                   \
    return sg::gemm_nn<T>(A, B, img, C, N, D, H,                            \
                          static_cast<cudaStream_t>(stream));               \
  }                                                                         \
  extern "C" int hgemm_tn_splitn_##SUFFIX(                                  \
      const float* A, const float* B, float* ws, float* out, int N, int M,  \
      int K, int split_rows, int accumulate, int bulk, void* stream) {      \
    return htn::gemm_tn_splitn16<T>(A, B, ws, out, N, M, K, split_rows,     \
                                    accumulate, bulk,                       \
                                    static_cast<cudaStream_t>(stream));     \
  }
