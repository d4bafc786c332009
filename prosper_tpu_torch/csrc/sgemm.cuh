// The GEMM kernels of the ET E-steps for sm_90a, on the tensor cores:
//
//   sgemm_nn         C (N, H) = A (N, D) . B (D, H)
//   sgemm_tn_splitn  C (M, K) = A^T . B  for A (N, M), B (N, K), summed over N
//
// all row-major and float32, in split TF32; and their 16-bit variants
// hgemm_nn and hgemm_tn_splitn, the same functions of the operands rounded
// to bf16 or fp16.  They take the D x H products of the ET E-steps out of
// the per-tile loops of the E-step kernels: the projection P = y W (the
// first product in the bodies of prosper_tpu/ops/linear_pallas.py::_kernel
// and prosper_tpu/ops/max_pallas.py::_kernel), the statistics
// xs = y^T (w <s>) of the linear family and the singleton part of numer,
// (w q_single)^T y, of the max family (the last products of those bodies).
// The 16-bit variants carry the linear family's compute_dtype (the JAX
// package's jnp.dot(a.astype(dt), b.astype(dt), preferred_element_type=f32)
// in prosper_tpu/core/etstep.py::_chunk_estats and _chunk_estats_bigs).
//
// Numerics (split TF32, "3xTF32"): every operand x is cut into two TF32
// numbers, hi = x rounded to TF32 and lo = x - hi rounded to TF32 (both to
// nearest, ties away from zero, as cvt.rna.tf32.f32 rounds), which hold x
// to 2^-22 relative.  A product is a_hi b_lo + a_lo b_hi + a_hi b_hi, the
// two small terms first; a_lo b_lo (2^-22 relative) is dropped.  The tensor
// cores multiply TF32 numbers exactly but add them with their own
// truncation, not as an fmaf chain rounds, so they sum only short runs of
// depth into a fresh accumulator, which is then added to the thread's
// running sum with fadd (round to nearest): a slab of BK = 32 depths, or
// one k8 step at a time where the whole depth is one slab (there the
// absolute tolerance of a float32 sum, a few units in the last place of its
// terms, leaves no room for the tensor cores' truncation of the partial
// sums).  The order of every sum is fixed and no atomics are used, so two
// calls give the same bits.  On inputs quantised to multiples of 1/4,
// hi = x and lo = 0, and every product and partial sum is exact.
//
// Numerics (16-bit): every operand is rounded to bf16 or fp16 to nearest,
// ties to even (cvt.rn.bf16x2.f32 / cvt.rn.f16x2.f32, as torch's .to and
// JAX's astype round; fp16 overflows to +-inf above 65504) on its way into
// the MMA, and one product is taken: the products of two 16-bit numbers are
// exact, and their sums run in fresh float32 accumulators of a slab (BK =
// 64 depths; one k16 step where the depth is one slab; two k16 steps in
// the tn kernel) added with fadd, as above.  So the result is the float32
// product of the rounded operands to float32 accuracy, not the product of
// the float32 operands.
//
// What bounds them on the H100: at the patches width (N = 131072, D = 256,
// H = 300) the three TF32 products are 60.4 GFLOP, 0.122 ms at 495 TFLOP/s,
// against 292 MB of operands and result, 0.087 ms at 3.35 TB/s: operations.
// One 16-bit product is 20.1 GFLOP, 0.020 ms at 989 TFLOP/s: the 16-bit
// variants are bound by the same 292 MB of float32 operands, 0.087 ms.
//
// What the design does about it: the products run as warpgroup MMAs,
// wgmma.m64n152k8.f32.tf32.tf32 (wgmma.m64n152k16.f32.bf16.bf16, .f16.f16),
// with A from registers and B from shared memory.  Shared-memory operands
// are read K-major, in the 128-byte swizzle: rows of 128 bytes (BK = 32
// floats, or 64 16-bit values), eight rows an atom of 1024 bytes.  A block
// of two warpgroups owns a BM x BN = 128 x 152 tile of C (76 accumulator
// floats a thread, and as many for the fresh sum).  Depth slabs are staged
// in shared memory by cp.async in a ring of stages, so that the loads of
// the next slabs, and the reading and splitting (or rounding) of the next A
// fragments, run under this slab's MMAs.  The split runs on the integer
// units (two operations a rounding), not on the slower conversion units
// that cvt uses; the 16-bit rounding is one cvt for two values.  y is read
// once, in float32, and rounded in registers: no cast pass over it.
//
// sgemm_nn: y's rows are K-major, so a warpgroup reads its A fragment from
// the raw float32 slab (stored in the same swizzle, which makes the reads
// free of bank conflicts) and splits it in registers.  W is (D, H), not
// K-major: a small kernel of the same call first writes its split image,
// hi and lo tiles [BN][BK] per column tile and slab (in the 16-bit variant
// one tile of rounded values, half the bytes), already in the swizzled
// layout, so that a stage's B is one contiguous copy.  The grid is
// (column tiles, row tiles): the column tiles of one row tile are
// neighbours, so y is read from the L2 the second time.
//
// sgemm_tn_splitn reduces over N, the long dimension, so N is cut into
// splits of split_rows rows: the grid is (row tiles, column tiles, splits),
// every split writes its own partial and reduce_blocks sums the partials in
// split order.  Both operands arrive as rows of N, that is MN-major.  The
// register operand is read with strided loads from its raw slab (rows
// padded against bank conflicts); the shared-memory operand's raw slab is
// split (or rounded) and transposed by the block into K-major tiles
// (double buffered), under the MMAs of the slab before.  Which operand
// takes the register side is chosen by the host for the fewer padded
// tiles; the result is then stored transposed.
//
// Ragged shapes are masked: loads past an edge are zero-filled (cp.async
// with a source size of 0), stores past an edge are skipped.  Where a row
// length is no multiple of 4 floats or a pointer not 16-byte aligned, the
// copies are 4 bytes wide instead of 16 (the template parameter VEC).
//
// The kernels are templates here; each operand type is instantiated, with
// its C entry points, in a source of its own (sgemm.cu: float;
// hgemm_bf16.cu, hgemm_f16.cu), so that nvcc builds the three in parallel.
// hgemm_tn_splitn runs hgemm_tn.cuh's kernel, designed for the 16-bit
// types (tensor copies, rounding without transposition, both MMA operands
// from shared memory); tn_kernel at a 16-bit type (VEC false) is its path
// for the shapes a tensor map cannot describe.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "launch_once.cuh"
#include "linear_et_frontend.cuh"

namespace sg {

constexpr int BM = 128;        // rows of the C tile: two warpgroups of 64
constexpr int BN = 152;        // columns of the C tile: one wgmma n152
constexpr int ROW = 128;       // bytes of a row of a swizzled tile
constexpr int KS = 4;          // MMA steps of a slab (k8 in TF32, k16)
constexpr int THREADS = 256;   // two warpgroups
constexpr int NACC = BN / 2;   // accumulator floats a thread
constexpr int NN_STAGES = 4;   // slabs in flight in sgemm_nn
constexpr int TN_STAGES = 3;   // raw slabs in flight in sgemm_tn_splitn
constexpr int TN_STAGES16 = 2; // raw slabs in flight in hgemm_tn_splitn
constexpr int B_SLAB = BN * ROW;       // bytes of a K-major B tile (19 atoms)
constexpr int XS = BM + 8;             // row stride of tn's raw register slab
constexpr int YS = BN;                 // row stride of tn's raw B slab

// The operand type T of a kernel: float (split TF32: hi and lo B tiles,
// three products) or a 16-bit type (__nv_bfloat16, __half: one tile, one
// product).  A slab is one 128-byte row of T deep; its raw A slab is
// float32.
template <typename T>
struct Tr {
  static constexpr bool split = std::is_same<T, float>::value;
  static constexpr int BK = ROW / sizeof(T);    // depth of a slab
  static constexpr int NB = split ? 2 : 1;      // B tiles a slab
  static constexpr int A_SLAB = BM * BK * 4;    // bytes of nn's raw A slab
  static constexpr int NN_STAGE = A_SLAB + NB * B_SLAB;
  static constexpr int NN_SMEM = NN_STAGES * NN_STAGE + 1024;
  static constexpr int TN_ST = split ? TN_STAGES : TN_STAGES16;
  static constexpr int TN_RAW = BK * XS * 4 + BK * YS * 4;
  static constexpr int TN_SMEM = 2 * NB * B_SLAB + TN_ST * TN_RAW + 1024;
  static_assert(NN_STAGE % 1024 == 0 && B_SLAB % 1024 == 0
                    && TN_RAW % 16 == 0,
                "the swizzled tiles must start on 1024-byte atoms");
  static_assert(NN_SMEM <= 232448 && TN_SMEM <= 232448,
                "more shared memory than a block may have");
  static_assert(BK / KS * sizeof(T) == 32, "an MMA step is 32 bytes deep");
};

template <int V>
using Int = std::integral_constant<int, V>;

// ---- TF32 split, 16-bit rounding, wgmma and fences --------------------------

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero, as cvt.rna.tf32.f32 rounds; two integer operations on the bit
// pattern, at the full rate of the integer units (the conversion runs on
// the slower conversion units).  Finite x only.
__device__ inline uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo (to 2^-22 relative), both TF32 bit patterns.
__device__ inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// lo and hi rounded to T to nearest even, packed: lo in the low half (the
// lower depth, as the MMA fragments and the K-major tiles hold them).
template <typename T>
__device__ inline uint32_t pack16(float lo, float hi) {
  uint32_t r;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// Descriptor of a K-major tile in the 128-byte swizzle (rows of 128 bytes,
// eight rows an atom of 1024 bytes, atoms one after another); an MMA step
// further into the slab starts 32 bytes later.
__device__ inline uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ inline void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory writes of this thread (cp.async, st.shared) become visible
// to the async proxy that wgmma reads through.
__device__ inline void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the wgmma fences and waits.
__device__ inline void fence_regs(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SG_ACC                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "          \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "          \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "          \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "          \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "          \
  "%72, %73, %74, %75}, "
#define SG_OPERANDS                                                       \
  : SG_D4(0), SG_D4(4), SG_D4(8), SG_D4(12), SG_D4(16), SG_D4(20),        \
    SG_D4(24), SG_D4(28), SG_D4(32), SG_D4(36), SG_D4(40), SG_D4(44),     \
    SG_D4(48), SG_D4(52), SG_D4(56), SG_D4(60), SG_D4(64), SG_D4(68),     \
    SG_D4(72)                                                             \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
// d (+)= A (64 x k, this thread's fragment a) . B (k x 152, K-major in
// shared memory at desc), over the warpgroup; scale_d 0 ignores d's value.
// SHAPE_TYPES: the k and the operand types; TAIL: the immediate scales of
// A and B, and for 16-bit types B's transpose flag (0: K-major).
#define SG_WGMMA(SHAPE_TYPES, TAIL)                                       \
  asm volatile("{\n"                                                      \
               ".reg .pred p;\n"                                          \
               "setp.ne.b32 p, %81, 0;\n"                                 \
               "wgmma.mma_async.sync.aligned.m64n152" SHAPE_TYPES " "     \
               SG_ACC "{%76, %77, %78, %79}, %80, p, " TAIL ";\n"         \
               "}\n" SG_OPERANDS)

__device__ inline void wgmma_tf32(float (&d)[NACC], const uint32_t (&a)[4],
                                  uint64_t desc, int scale_d) {
  SG_WGMMA("k8.f32.tf32.tf32", "1, 1");
}

template <typename T>
__device__ inline void wgmma_16(float (&d)[NACC], const uint32_t (&a)[4],
                                uint64_t desc, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    SG_WGMMA("k16.f32.bf16.bf16", "1, 1, 0");
  else
    SG_WGMMA("k16.f32.f16.f16", "1, 1, 0");
}

#undef SG_WGMMA
#undef SG_OPERANDS
#undef SG_ACC
#undef SG_D4

// The MMAs of the steps [K0, K0 + KN) of a slab, issued (not waited for),
// into part from zero.  Split TF32: the small products first, so that the
// tensor cores' rounding meets a large sum only in the last KN; ahi[k] /
// alo[k]: the fragment of step K0 + k; bh / bl: the slab's B_hi and B_lo
// tiles.  16-bit: one product a step, ahi the rounded fragments (alo and
// bl are not read).
template <typename T, int K0, int KN>
__device__ inline void mma_issue(float (&part)[NACC], const uint32_t (*ahi)[4],
                                 const uint32_t (*alo)[4], uint32_t bh,
                                 uint32_t bl) {
  fence_regs(part);
  wgmma_fence();
  if constexpr (Tr<T>::split) {
#pragma unroll
    for (int k = 0; k < KN; ++k) {
      wgmma_tf32(part, alo[k], desc_sw128(bh + 32 * (K0 + k)), k > 0);
      wgmma_tf32(part, ahi[k], desc_sw128(bl + 32 * (K0 + k)), 1);
    }
#pragma unroll
    for (int k = 0; k < KN; ++k)
      wgmma_tf32(part, ahi[k], desc_sw128(bh + 32 * (K0 + k)), 1);
  } else {
#pragma unroll
    for (int k = 0; k < KN; ++k)
      wgmma_16<T>(part, ahi[k], desc_sw128(bh + 32 * (K0 + k)), k > 0);
  }
  wgmma_commit();
}

// Waits for the MMAs and adds their sum to the running one (fadd).
__device__ inline void mma_retire(float (&acc)[NACC], float (&part)[NACC]) {
  wgmma_wait0();
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] += part[i];
}

// One slab's MMAs as KS / KN sums of KN steps each, every sum fresh and
// added to acc when done; work(Int<c>()) runs under the MMAs of sum c.
template <typename T, int KN, typename Work>
__device__ inline void mma_slab(float (&acc)[NACC], float (&part)[NACC],
                                const uint32_t (&ahi)[KS][4],
                                const uint32_t (&alo)[KS][4], uint32_t bh,
                                Work work) {
  auto sum = [&](auto C) {
    constexpr int c = decltype(C)::value;
    if constexpr (c * KN < KS) {
      mma_issue<T, c * KN, KN>(part, ahi + c * KN, alo + c * KN, bh,
                               bh + B_SLAB);
      work(C);
      mma_retire(acc, part);
    }
  };
  sum(Int<0>());
  sum(Int<1>());
  sum(Int<2>());
  sum(Int<3>());
}

// This thread's place in the m64 x n152 fragments: rows row0 and row0 + 8 of
// the block's tile, columns 8 j + 2 q and 8 j + 2 q + 1.  Its A fragment of
// a step: rows row0 + 8 (e & 1), depths q + 4 (e >> 1) (TF32, k8) or
// 2 q + 8 (e >> 1) and the next (16-bit, k16, two values a register).
struct Frag {
  int row0, q;
  __device__ Frag() {
    const int tid = threadIdx.x, lane = tid & 31;
    row0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    q = lane & 3;
  }
};

// ---- sgemm_nn ---------------------------------------------------------------

// The image of B (D, H) for nn_kernel: per column tile j and slab s, the
// hi tile then the lo tile of the TF32 split (float), or the one tile of
// values rounded to T, each [BN][128 bytes] K-major in the 128-byte
// swizzle (16-byte chunk c of row n at chunk c ^ (n % 8)), zeros past H
// and D.  One thread per row n and chunk c of one tile; consecutive
// threads read consecutive columns of B.
template <typename T>
__global__ void b_image(const float* __restrict__ B, float* __restrict__ img,
                        int D, int H, int n_slabs, int n_tiles) {
  constexpr int BK = Tr<T>::BK, CH = ROW / 16, PER = 16 / sizeof(T);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = i % BN;
  int r = i / BN;
  const int c = r % CH;
  r /= CH;
  const int s = r % n_slabs, j = r / n_slabs;
  if (j >= n_tiles) return;
  const int col = j * BN + n;
  float v[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int k = s * BK + PER * c + e;
    v[e] = col < H && k < D ? B[(size_t)k * H + col] : 0.f;
  }
  float* t = img + (size_t)(j * n_slabs + s) * Tr<T>::NB * B_SLAB / 4
             + n * (ROW / 4) + ((c ^ (n & 7)) << 2);
  if constexpr (Tr<T>::split) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
    *reinterpret_cast<uint4*>(t) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(t + B_SLAB / 4) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  } else {
    *reinterpret_cast<uint4*>(t) =
        make_uint4(pack16<T>(v[0], v[1]), pack16<T>(v[2], v[3]),
                   pack16<T>(v[4], v[5]), pack16<T>(v[6], v[7]));
  }
}

// BM rows m0.. and BK depths k0.. of A (N, D) into dst [BM][BK] floats,
// 16-byte chunk c of row r at chunk c ^ (r % 8); zeros past N and D.
template <bool VEC, int BK>
__device__ inline void load_a_nn(float* dst, const float* A, int N, int D,
                                 int m0, int k0) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int i = tid; i < BM * BK / 4; i += THREADS) {
      const int r = i / (BK / 4), c = i % (BK / 4);
      const bool ok = m0 + r < N && k0 + 4 * c < D;
      const float* s = ok ? A + (size_t)(m0 + r) * D + k0 + 4 * c : A;
      cp_async16(dst + r * BK + ((c ^ (r & 7)) << 2), s, ok);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, k = i % BK;
      const bool ok = m0 + r < N && k0 + k < D;
      const float* s = ok ? A + (size_t)(m0 + r) * D + k0 + k : A;
      cp_async4(dst + r * BK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3), s, ok);
    }
  }
}

// C (N, H) = A (N, D) . B (D, H) from B's image.  grid (H tiles, N tiles):
// the column tiles of one row tile are neighbours, so y is read from the L2
// the second time.  KN: MMA steps summed by the tensor cores alone (KS: a
// slab; 1 for a depth of one slab, where the tolerance of a short sum is
// tight).  pair: H even and C 8-byte aligned (stores of two floats).
template <typename T, bool VEC, int KN>
__global__ void __launch_bounds__(THREADS, 1)
nn_kernel(const float* __restrict__ A, const float* __restrict__ img,
          float* __restrict__ C, int N, int D, int H, int n_slabs,
          int pair) {
  using R = Tr<T>;
  constexpr int BK = R::BK, IMG = R::NB * B_SLAB / 4;   // floats a slab
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const float* img_j = img + (size_t)blockIdx.x * n_slabs * IMG;
  auto stage = [&](int t) { return smem + (t % NN_STAGES) * R::NN_STAGE; };

  auto load = [&](int t) {
    load_a_nn<VEC, BK>(reinterpret_cast<float*>(stage(t)), A, N, D, m0,
                       t * BK);
    const float* src = img_j + (size_t)t * IMG;
    float* dst = reinterpret_cast<float*>(stage(t) + R::A_SLAB);
#pragma unroll
    for (int c = tid; c < IMG / 4; c += THREADS)
      cp_async16(dst + 4 * c, src + 4 * c, true);
  };

  const Frag f;
  // slab t's A fragments, split (or rounded to T, into hi)
  auto frags = [&](int t, uint32_t (&hi)[KS][4], uint32_t (&lo)[KS][4]) {
    const float* as = reinterpret_cast<const float*>(stage(t));
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = f.row0 + (e & 1) * 8;
        if constexpr (R::split) {
          const int k = ks * 8 + f.q + (e >> 1) * 4;
          split_tf32(as[r * BK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3)],
                     hi[ks][e], lo[ks][e]);
        } else {
          const int k = ks * 16 + 2 * f.q + (e >> 1) * 8;
          const float2 v = *reinterpret_cast<const float2*>(
              as + r * BK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3));
          hi[ks][e] = pack16<T>(v.x, v.y);
        }
      }
  };
  float acc[NACC], part[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = part[i] = 0.f;
  // slab t's MMAs (fragments hi / lo); under them the load of slab
  // t + NN_STAGES - 1 into the stage of t - 1 and slab t + 1's fragments
  auto step = [&](int t, uint32_t (&hi)[KS][4], uint32_t (&lo)[KS][4],
                  uint32_t (&hn)[KS][4], uint32_t (&ln)[KS][4]) {
    const bool more = t + 1 < n_slabs;
    mma_slab<T, KN>(acc, part, hi, lo, smem_u32(stage(t) + R::A_SLAB),
                    [&](auto C) {
      constexpr int c = decltype(C)::value;
      if (c == 0 && more) {
        cp_async_wait<NN_STAGES - 3>();
        fence_async_smem();
        __syncthreads();   // slab t + 1 is in; all are done with slab t - 1
        if (t + NN_STAGES - 1 < n_slabs) load(t + NN_STAGES - 1);
        cp_async_commit();
      }
      if (c == (KN < KS ? 1 : 0) && more) frags(t + 1, hn, ln);
    });
  };

#pragma unroll
  for (int s = 0; s < NN_STAGES - 1; ++s) {
    if (s < n_slabs) load(s);
    cp_async_commit();
  }
  cp_async_wait<NN_STAGES - 2>();
  fence_async_smem();
  __syncthreads();
  uint32_t fh[2][KS][4], fl[2][KS][4];
  frags(0, fh[0], fl[0]);
  for (int t = 0; t < n_slabs; t += 2) {
    step(t, fh[0], fl[0], fh[1], fl[1]);
    if (t + 1 < n_slabs) step(t + 1, fh[1], fl[1], fh[0], fl[0]);
  }

#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + f.row0 + 8 * h, c = n0 + 8 * j + 2 * f.q;
      if (r >= N || c >= H) continue;
      float* p = C + (size_t)r * H + c;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pair) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        p[0] = v0;
        if (c + 1 < H) p[1] = v1;
      }
    }
}

// ---- sgemm_tn_splitn --------------------------------------------------------

// BK rows r0.. (below r_end) and COLS columns c0.. (below ld) of the
// row-major src (ld floats a row) into dst with row stride dstride; zeros
// outside.
template <bool VEC, int COLS, int BK>
__device__ inline void load_rows(float* dst, int dstride, const float* src,
                                 int ld, int r0, int c0, int r_end) {
  const int tid = threadIdx.x;
  if (VEC) {
    constexpr int CH = COLS / 4;
#pragma unroll
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = r0 + r < r_end && c0 + c < ld;
      const float* s = ok ? src + (size_t)(r0 + r) * ld + c0 + c : src;
      cp_async16(dst + r * dstride + c, s, ok);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < BK * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = r0 + r < r_end && c0 + c < ld;
      const float* s = ok ? src + (size_t)(r0 + r) * ld + c0 + c : src;
      cp_async4(dst + r * dstride + c, s, ok);
    }
  }
}

// One split's partial of R (P, Q) = X^T . Y over the rows
// [z * split_rows, (z + 1) * split_rows) of X (N, P) and Y (N, Q), into
// ws + z * P * Q: R itself, or with trans its transpose (Q, P).  grid
// (P tiles, Q tiles, splits).  Every slab is two sums of two MMA steps.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
tn_kernel(const float* __restrict__ X, const float* __restrict__ Y,
          float* __restrict__ ws, int N, int P, int Q, int split_rows,
          int trans) {
  using R = Tr<T>;
  constexpr int BK = R::BK, STAGES = R::TN_ST;
  extern __shared__ uint8_t smem_raw[];
  // two buffers of the B tiles (split: hi, lo), then the ring of raw slabs
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* raw = smem + 2 * R::NB * B_SLAB;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * BM, q0 = blockIdx.y * BN;
  const int r_begin = blockIdx.z * split_rows;
  const int r_end = min(N, r_begin + split_rows);
  const int nt = (r_end - r_begin + BK - 1) / BK;

  auto xs_of = [&](int s) {
    return reinterpret_cast<float*>(raw + (s % STAGES) * R::TN_RAW);
  };
  auto ys_of = [&](int s) {
    return reinterpret_cast<float*>(raw + (s % STAGES) * R::TN_RAW
                                    + BK * XS * 4);
  };
  auto load = [&](int s) {
    const int r0 = r_begin + s * BK;
    load_rows<VEC, BM, BK>(xs_of(s), XS, X, P, r0, p0, r_end);
    load_rows<VEC, BN, BK>(ys_of(s), YS, Y, Q, r0, q0, r_end);
  };
  // the raw Y slab s, split (or rounded) and transposed into the K-major
  // tiles of buffer b: this thread's items j0 <= j < j1 (column n, the
  // depths of 16-byte chunk c); a warp reads 32 consecutive columns of a
  // raw row
  auto split_b = [&](int s, int b, int j0, int j1) {
    const float* ys = ys_of(s);
    float* hi = reinterpret_cast<float*>(smem + R::NB * b * B_SLAB);
#pragma unroll
    for (int j = j0; j < j1; ++j) {
      const int i = tid + j * THREADS;
      if (i >= BN * ROW / 16) break;
      const int n = i % BN, c = i / BN;
      const int o = n * (ROW / 4) + ((c ^ (n & 7)) << 2);
      uint32_t h[4];
      if constexpr (R::split) {
        uint32_t l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(ys[(4 * c + e) * YS + n], h[e], l[e]);
        *reinterpret_cast<uint4*>(hi + B_SLAB / 4 + o) =
            make_uint4(l[0], l[1], l[2], l[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h[e] = pack16<T>(ys[(8 * c + 2 * e) * YS + n],
                           ys[(8 * c + 2 * e + 1) * YS + n]);
      }
      *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
    }
  };
  // split_b's items of a thread, the first J_HALF under the first sum
  constexpr int J_ALL = (BN * ROW / 16 + THREADS - 1) / THREADS, J_HALF = 3;

  float acc[NACC], part[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = part[i] = 0.f;
  const Frag f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  split_b(0, 0, 0, J_ALL);
  fence_async_smem();
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    // the stage of slab t - 1 is free: its X fragments were read and its Y
    // split before the last barrier
    if (t + STAGES - 1 < nt) load(t + STAGES - 1);
    cp_async_commit();
    const float* xs = xs_of(t);
    uint32_t ahi[KS][4], alo[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = f.row0 + (e & 1) * 8;
        if constexpr (R::split) {
          const int k = ks * 8 + f.q + (e >> 1) * 4;
          split_tf32(xs[k * XS + p], ahi[ks][e], alo[ks][e]);
        } else {
          const int k = ks * 16 + 2 * f.q + (e >> 1) * 8;
          ahi[ks][e] = pack16<T>(xs[k * XS + p], xs[(k + 1) * XS + p]);
        }
      }
    const bool more = t + 1 < nt;
    // slab t + 1 is split under slab t's MMAs
    mma_slab<T, 2>(acc, part, ahi, alo,
                   smem_u32(smem + R::NB * (t & 1) * B_SLAB), [&](auto C) {
      if (!more) return;
      if (decltype(C)::value == 0) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        split_b(t + 1, (t + 1) & 1, 0, J_HALF);
      } else {
        split_b(t + 1, (t + 1) & 1, J_HALF, J_ALL);
        fence_async_smem();
      }
    });
    __syncthreads();   // slab t + 1 is split; slab t's buffer is free
  }

  float* out = ws + (size_t)blockIdx.z * P * Q;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int p = p0 + f.row0 + 8 * h, q = q0 + 8 * j + 2 * f.q + b;
        if (p < P && q < Q)
          out[trans ? (size_t)q * P + p : (size_t)p * Q + q] =
              acc[4 * j + 2 * h + b];
      }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, bool VEC, int KN>
static cudaError_t launch_nn(cudaStream_t s, const float* A, const float* img,
                             float* C, int N, int D, int H, int n_slabs,
                             int h_tiles, int pair) {
  static launch_once::DeviceOnce once;
  cudaError_t e =
      launch_once::prepare_kernel(nn_kernel<T, VEC, KN>, once, true);
  if (e != cudaSuccess) return e;
  nn_kernel<T, VEC, KN>
      <<<dim3(h_tiles, cdiv(N, BM)), THREADS, Tr<T>::NN_SMEM, s>>>(
          A, img, C, N, D, H, n_slabs, pair);
  return cudaGetLastError();
}

template <typename T, bool VEC>
static cudaError_t launch_tn(dim3 grid, cudaStream_t s, const float* X,
                      const float* Y, float* ws, int N, int P, int Q,
                      int split_rows, int trans) {
  static launch_once::DeviceOnce once;
  cudaError_t e = launch_once::prepare_kernel(tn_kernel<T, VEC>, once, true);
  if (e != cudaSuccess) return e;
  tn_kernel<T, VEC><<<grid, THREADS, Tr<T>::TN_SMEM, s>>>(
      X, Y, ws, N, P, Q, split_rows, trans);
  return cudaGetLastError();
}

template <typename T>
size_t nn_ws_floats(int D, int H) {
  return (size_t)cdiv(H, BN) * cdiv(D, Tr<T>::BK) * Tr<T>::NB * B_SLAB / 4;
}

template <typename T>
int gemm_nn(const float* A, const float* B, float* img, float* C, int N,
            int D, int H, cudaStream_t s) {
  const int h_tiles = cdiv(H, BN), n_slabs = cdiv(D, Tr<T>::BK);
  const int n_chunks = h_tiles * n_slabs * (ROW / 16) * BN;
  b_image<T><<<cdiv(n_chunks, 256), 256, 0, s>>>(B, img, D, H, n_slabs,
                                                  h_tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pair = H % 2 == 0
                   && (reinterpret_cast<uintptr_t>(C) & 7) == 0;
  // a depth of one slab is summed one MMA step at a time, deeper ones a
  // slab at a time (the header's numerics)
  const bool vec = D % 4 == 0 && aligned16(A), one = n_slabs == 1;
  e = vec ? (one ? launch_nn<T, true, 1>(s, A, img, C, N, D, H, n_slabs,
                                         h_tiles, pair)
                 : launch_nn<T, true, KS>(s, A, img, C, N, D, H, n_slabs,
                                          h_tiles, pair))
          : (one ? launch_nn<T, false, 1>(s, A, img, C, N, D, H, n_slabs,
                                          h_tiles, pair)
                 : launch_nn<T, false, KS>(s, A, img, C, N, D, H, n_slabs,
                                           h_tiles, pair));
  return static_cast<int>(e);
}

// The split product: launch(grid, X, Y, P, Q, trans) starts the kernel of
// the split partials of R (P, Q) = X^T . Y into ws, which reduce_blocks
// then sums in split order into out.  The register side (BM rows of the
// tile) takes the operand that pads to fewer tiles; with trans the kernel
// computes out^T and stores it back.
template <typename Launch>
int tn_splits(const float* A, const float* B, float* ws, float* out, int N,
              int M, int K, int split_rows, int accumulate, cudaStream_t s,
              Launch launch) {
  const int n_split = cdiv(N, split_rows);
  const int trans = cdiv(K, BM) * cdiv(M, BN) < cdiv(M, BM) * cdiv(K, BN);
  const float* X = trans ? B : A;
  const float* Y = trans ? A : B;
  const int P = trans ? K : M, Q = trans ? M : K;
  const cudaError_t e =
      launch(dim3(cdiv(P, BM), cdiv(Q, BN), n_split), X, Y, P, Q, trans);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t mk = (size_t)M * K;
  let::reduce_blocks<<<(unsigned)((mk + 255) / 256), 256, 0, s>>>(
      ws, out, n_split, mk, accumulate);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gemm_tn_splitn(const float* A, const float* B, float* ws, float* out,
                   int N, int M, int K, int split_rows, int accumulate,
                   cudaStream_t s) {
  return tn_splits(
      A, B, ws, out, N, M, K, split_rows, accumulate, s,
      [=](dim3 grid, const float* X, const float* Y, int P, int Q, int trans) {
        return P % 4 == 0 && Q % 4 == 0 && aligned16(X) && aligned16(Y)
                   ? launch_tn<T, true>(grid, s, X, Y, ws, N, P, Q,
                                        split_rows, trans)
                   : launch_tn<T, false>(grid, s, X, Y, ws, N, P, Q,
                                         split_rows, trans);
      });
}

}  // namespace sg
