// Big-S multi-state recurrence (the s_block linear E-step) for sm_90a.
//
// Replaces prosper_tpu/ops/bigs_pallas.py::bigs_multi_pallas (body
// _kernel).  Per datapoint n it runs an online logsumexp over the S
// enumerated multi states:
//
//   d[n, s]     = X[n, :] . A[:, s]
//   logit[n, s] = beta * d[n, s] + prior_beta * prior[s]
//   m  <- max(m, max_s logit),  acc <- acc * exp(m_old - m)
//   acc[n, :]  += sum_s exp(logit[n, s] - m) * B[s, :]
//
// and, for the un-annealed channel, the pair (m_t, l_t) of d + prior: one
// dot product serves both channels.  The operands are the reduced ones of
// core/etstep.py::bigs_operands_tri and bigs_tables_tri: the Gram matrix
// and the outer product s s^T are symmetric, so X, A and B carry the
// diagonal and one triangle,
//
//   X = i [2 proj | -g_aa | -(g_ab + g_ba), a < b]     i = 1 / (2 sigma^2)
//   A = [s_a | s_a^2 | s_a s_b, a < b]^T               nL = H' + H'(H'+1)/2
//   B = [s_a | s_a^2 | s_a s_b, a < b | vcounts | |s| | 1]  nM = nL + K + 2
//
// and the wrapper mirrors <s_a s_b>.  The kernel does nL + nM multiply-
// adds per (row, state) with or without the un-annealed channel; the prior
// is an add in the epilogue of the first product, the mask is the kernel's
// own (a state past S, or one whose `valid` is 0, gets the logit NEG).
// It writes acc (C, cols) and stats (3, C) = [m; m_t; l_t].
//
// What bounds it on the H100: the float32 multiply-adds on the CUDA cores.
// At the tsc_bigs width (H' = 10, K = 2: nL = 65, nM = 69, S = 12,564) that
// is 134 per (row, state), 0.44 TFLOP per E-step of N = 131,072 rows, at
// least 6.6 ms at the card's published 67 TFLOP/s.  Beside them each (row,
// state) costs one expf (two with the un-annealed channel) and a handful of
// adds, compares and stores: about a fifth of the instructions.  A and B
// together are 6.9 MB, so every block rereads them from the L2.
//
// What the design does about it:
// * Rows are independent, so nothing crosses blocks (no atomics, no second
//   pass): a call is deterministic, and with collect_true off the m / acc
//   outputs are the same bit for bit (one code path computes them).
// * A warp owns 16 rows for the whole walk over the states, as in
//   FlashAttention-2.  The eight lanes that share a row hold its 64 logits
//   of a tile, so the row maximum and the un-annealed mass are three
//   shuffles, and the running (m, m_t, l_t) and the rescale are registers.
//   p = exp(logit - m) reaches the second product through 4 KB of shared
//   memory private to the warp, behind a __syncwarp().
// * Both products are register-tiled: a thread holds 4 rows x 8 states of
//   the logits (three 16-byte loads for 32 multiply-adds) and 4 rows x
//   cols / 8 moment columns (for nM = 69: 9 columns, four loads for 36).
//   A thread's rows are r, r + 4, r + 8, r + 12 of its warp's 16 (X is
//   stored in that order), so that the 16-byte loads of p hit distinct
//   banks.
// * The A and B tiles of 64 states are staged by cp.async, double
//   buffered: the next tile's copies run under this tile's arithmetic, and
//   the one block barrier a tile is the hand-over of a buffer.
// * A block is 16 warps (256 rows, 201 KB of shared memory at tsc_bigs:
//   X 67 KB, A and B 71 KB, p 64 KB), one block an SM: 16 warps share each
//   staged tile, four to a scheduler.  A wider table gets fewer warps, and
//   so does a call of so few rows that its blocks would not cover the SMs.
// * The state tile is the kernel's own: any S works.  No fast math; expf,
//   not __expf.

#include <cuda_runtime.h>

#include <cstddef>

#include "cp_async.cuh"
#include "launch_once.cuh"

namespace bigs {

constexpr int T = 64;         // states per tile
constexpr int RW = 16;        // rows per warp
constexpr int PS = T + 4;     // row stride of a warp's p tile (16-byte rows)
constexpr int MAXW = 16;      // warps per block, at most
constexpr int G4_MAX = 4;     // moment columns: 32 G4 + 8 G1 <= 152
constexpr size_t SMEM_LIMIT = 232448;
constexpr float NEG = -3e38f;

// moment columns the register tile computes for nM: the least 32 G4 + 8 G1
// (G1 < 4) that holds them; 0 if none does
__host__ __device__ inline int moment_cols(int nM) {
  const int cols = (nM + 7) / 8 * 8;
  return (nM < 1 || cols > 32 * G4_MAX + 24) ? 0 : cols;
}

__host__ __device__ inline size_t smem_floats(int nL, int cols, int nw) {
  return (size_t)nL * RW * nw          // X of the block's rows, k-major
         + 2 * (size_t)(nL + 2) * T    // A tiles with the prior and valid rows
         + 2 * (size_t)T * cols        // B tiles
         + (size_t)nw * RW * PS;       // p, one tile a warp
}

// warps of a block: the most (a power of two) whose tile fits; 0 if none
__host__ __device__ inline int block_warps(int nL, int cols) {
  for (int nw = MAXW; nw >= 1; nw >>= 1)
    if (smem_floats(nL, cols, nw) * sizeof(float) <= SMEM_LIMIT) return nw;
  return 0;
}

__device__ inline float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// max (or sum) over the eight lanes that share a row; every lane gets it
__device__ inline float row_max(float v) {
  for (int o = 4; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float row_sum(float v) {
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// G4 groups of four columns and G1 single columns a thread:
// cols = 32 G4 + 8 G1 moment columns a block.
template <int G4, int G1>
__global__ void __launch_bounds__(32 * MAXW, 1)
bigs_kernel(const float* __restrict__ X, const float* __restrict__ AT,
            const float* __restrict__ PV, const float* __restrict__ B,
            const float* __restrict__ scal, float* __restrict__ acc_out,
            float* __restrict__ stats, int C, int S, int nL, int ldx, int lda,
            int tc) {
  constexpr int COLS = 32 * G4 + 8 * G1;
  constexpr int NC = 4 * G4 + G1;      // moment columns a thread
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int lr = lane >> 3, lc = lane & 7;
  const int R = RW * (nthreads >> 5);
  const size_t a_tile = (size_t)(nL + 2) * T;
  float* xs = reinterpret_cast<float*>(smem4);
  float* as = xs + (size_t)nL * R;
  float* bs = as + 2 * a_tile;
  float* ps = bs + 2 * (size_t)T * COLS + (size_t)warp * RW * PS;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, C - row0);
  const float beta = scal[0], pb = scal[1];

  // one tile of A (with the prior and valid rows) and of B into buffer buf;
  // past the tables the copies fill zeros
  auto load_tile = [&](int t, int buf) {
    const int s0 = t * T;
    float* a = as + buf * a_tile;
    for (int c = tid; c < (nL + 2) * (T / 4); c += nthreads) {
      const int k = c / (T / 4), s = (c - k * (T / 4)) * 4;
      const float* src = k < nL ? AT + (size_t)k * lda
                                : PV + (size_t)(k - nL) * lda;
      const bool ok = s0 + s < lda;
      cp_async16(a + k * T + s, ok ? src + s0 + s : AT, ok);
    }
    float* b = bs + (size_t)buf * T * COLS;
    const size_t b0 = (size_t)s0 * COLS, b_end = (size_t)S * COLS;
    for (int c = tid * 4; c < T * COLS; c += nthreads * 4) {
      const bool ok = b0 + c < b_end;
      cp_async16(b + c, ok ? B + b0 + c : B, ok);
    }
  };
  const int nt = (S + T - 1) / T;
  load_tile(0, 0);
  cp_async_commit();

  // the block's rows of X, k-major; row lr + 4 i of a warp's 16 sits at
  // position 4 lr + i, so that a thread's four rows are one 16-byte load.
  // Rows past C are zeros and are never written out.
  for (int i = tid; i < (ldx / 4) * R; i += nthreads) {
    const int r = i % R, k4 = i / R * 4;
    const int q = r & (RW - 1);
    const int pos = (r - q) + ((q & 3) << 2) + (q >> 2);
    const float4 v = r < nrows ? ld4(X + (size_t)(row0 + r) * ldx + k4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (k4 + c < nL) xs[(size_t)(k4 + c) * R + pos] = e[c];
  }

  float acc[4][NC];
  float m[4], mt[4], lt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = mt[i] = NEG;
    lt[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const float* xw = xs + warp * RW + lr * 4;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t has landed; tile t - 1's buffer is free
    if (t + 1 < nt) {
      load_tile(t + 1, (t + 1) & 1);
      cp_async_commit();
    }
    const float* aw = as + (t & 1) * a_tile + lc * 4;
    const float* bw = bs + (size_t)(t & 1) * T * COLS + lc * 4;

    // 1. d = X . A for rows lr + 4 i, states 4 lc + j and 32 + 4 lc + j
    float d[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) d[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < nL; ++k) {
      const float4 x4 = ld4(xw + (size_t)k * R);
      const float4 a0 = ld4(aw + k * T), a1 = ld4(aw + k * T + 32);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) d[i][j] = fmaf(x[i], a[j], d[i][j]);
    }

    // 2. the logits of both channels and the online softmax, in registers
    float pr[8], r[4];
    bool ok[8];
    {
      const float4 p0 = ld4(aw + nL * T), p1 = ld4(aw + nL * T + 32);
      const float4 v0 = ld4(aw + (nL + 1) * T);
      const float4 v1 = ld4(aw + (nL + 1) * T + 32);
      const float pp[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = t * T + (j >> 2) * 32 + lc * 4 + (j & 3);
        pr[j] = pp[j];
        ok[j] = s < S && vv[j] > 0.f;
      }
    }
    if (tc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, ok[j] ? d[i][j] + pr[j] : NEG);
        const float mn = fmaxf(mt[i], row_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sum += expf((ok[j] ? d[i][j] + pr[j] : NEG) - mn);
        lt[i] = lt[i] * expf(mt[i] - mn) + row_sum(sum);
        mt[i] = mn;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) pr[j] = pb * pr[j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        d[i][j] = ok[j] ? beta * d[i][j] + pr[j] : NEG;
        mx = fmaxf(mx, d[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mx));
      r[i] = expf(m[i] - mn);
      m[i] = mn;
      float* prow = ps + (lr + 4 * i) * PS + lc * 4;
      *reinterpret_cast<float4*>(prow) = make_float4(
          expf(d[i][0] - mn), expf(d[i][1] - mn), expf(d[i][2] - mn),
          expf(d[i][3] - mn));
      *reinterpret_cast<float4*>(prow + 32) = make_float4(
          expf(d[i][4] - mn), expf(d[i][5] - mn), expf(d[i][6] - mn),
          expf(d[i][7] - mn));
    }
    __syncwarp();      // the warp's p tile is written

    // 3. acc = acc * r + p . B for rows lr + 4 i; columns 32 g + 4 lc + e
    // of the G4 groups, then 32 G4 + 8 g + lc (p = 0 and B = 0 past S)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= r[i];
#pragma unroll 2
    for (int s4 = 0; s4 < T; s4 += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 = ld4(ps + (lr + 4 * i) * PS + s4);
        p[i][0] = p4.x; p[i][1] = p4.y; p[i][2] = p4.z; p[i][3] = p4.w;
      }
#pragma unroll
      for (int ss = 0; ss < 4; ++ss) {
        const float* br = bw + (s4 + ss) * COLS;
#pragma unroll
        for (int g = 0; g < G4; ++g) {
          const float4 b4 = ld4(br + 32 * g);
          const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][4 * g + e] = fmaf(p[i][ss], b[e], acc[i][4 * g + e]);
        }
#pragma unroll
        for (int g = 0; g < G1; ++g) {
          const float b = br[32 * G4 + 8 * g - 3 * lc];   // column .. + lc
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][4 * G4 + g] = fmaf(p[i][ss], b, acc[i][4 * G4 + g]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = warp * RW + lr + 4 * i;
    if (row >= nrows) continue;
    const size_t n = (size_t)row0 + row;
    float* out = acc_out + n * COLS;
#pragma unroll
    for (int g = 0; g < G4; ++g)
      *reinterpret_cast<float4*>(out + 32 * g + 4 * lc) = make_float4(
          acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
          acc[i][4 * g + 3]);
#pragma unroll
    for (int g = 0; g < G1; ++g)
      out[32 * G4 + 8 * g + lc] = acc[i][4 * G4 + g];
    if (lc == 0) {
      stats[n] = m[i];
      stats[(size_t)C + n] = mt[i];
      stats[2 * (size_t)C + n] = lt[i];
    }
  }
}

template <int G4, int G1>
cudaError_t launch(const float* X, const float* AT, const float* PV,
                   const float* B, const float* scal, float* acc,
                   float* stats, int C, int S, int nL, int ldx, int lda,
                   int tc, cudaStream_t stream) {
  int nw = block_warps(nL, 32 * G4 + 8 * G1);
  if (nw == 0) return cudaErrorInvalidValue;
  // few rows: smaller blocks, as long as they are fewer than the SMs (the
  // rows' arithmetic does not depend on the block they run in)
  static launch_once::DeviceOnce once;   // one per kernel instance
  int sms = 0;
  cudaError_t e = launch_once::prepare_kernel(bigs_kernel<G4, G1>, once,
                                              false, &sms);
  if (e != cudaSuccess) return e;
  while (nw > 1 && (C + RW * nw - 1) / (RW * nw) < sms) nw >>= 1;
  const size_t smem = smem_floats(nL, 32 * G4 + 8 * G1, nw) * sizeof(float);
  const int R = RW * nw;
  bigs_kernel<G4, G1><<<(C + R - 1) / R, 32 * nw, smem, stream>>>(
      X, AT, PV, B, scal, acc, stats, C, S, nL, ldx, lda, tc);
  return cudaGetLastError();
}

}  // namespace bigs

extern "C" {

// Moment columns the kernel computes (and the row length of B and acc) for
// nM = nL + K + 2 of them; 0 where the register tile does not hold them.
int bigs_multi_cols(int nM) { return bigs::moment_cols(nM); }

// Warps of a block at nL logit and nM moment columns (16 rows each); 0
// where not even one warp's tile fits the shared memory of an SM.
int bigs_multi_warps(int nL, int nM) {
  const int cols = bigs::moment_cols(nM);
  return cols ? bigs::block_warps(nL, cols) : 0;
}

size_t bigs_multi_smem_bytes(int nL, int nM) {
  const int cols = bigs::moment_cols(nM);
  const int nw = cols ? bigs::block_warps(nL, cols) : 0;
  return bigs::smem_floats(nL, cols, nw ? nw : 1) * sizeof(float);
}

// X (C, ldx) row-major, its first nL columns the operand; AT (nL, lda)
// state-minor and PV (2, lda) = [prior; valid], zeros past S; B (S, cols)
// row-major with cols = bigs_multi_cols(nM); scal = [beta, prior_beta].
// ldx and lda are multiples of 4 and every pointer is 16-byte aligned.
// out: acc (C, cols), stats (3, C) = [m; m_t; l_t] (m_t = NEG, l_t = 0
// without collect_true).
int bigs_multi(const float* X, const float* AT, const float* PV,
               const float* B, const float* scal, float* acc, float* stats,
               int C, int S, int nL, int ldx, int lda, int nM,
               int collect_true, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = bigs::moment_cols(nM);
  if (cols == 0 || ldx % 4 || lda % 4 || ldx < nL || lda < S)
    return static_cast<int>(cudaErrorInvalidValue);
#define BIGS_CASE(g4, g1)                                                  \
  case 4 * g4 + g1:                                                        \
    return static_cast<int>(bigs::launch<g4, g1>(                          \
        X, AT, PV, B, scal, acc, stats, C, S, nL, ldx, lda, collect_true,  \
        st));
  switch (4 * (cols / 32) + cols % 32 / 8) {
    BIGS_CASE(0, 1) BIGS_CASE(0, 2) BIGS_CASE(0, 3)
    BIGS_CASE(1, 0) BIGS_CASE(1, 1) BIGS_CASE(1, 2) BIGS_CASE(1, 3)
    BIGS_CASE(2, 0) BIGS_CASE(2, 1) BIGS_CASE(2, 2) BIGS_CASE(2, 3)
    BIGS_CASE(3, 0) BIGS_CASE(3, 1) BIGS_CASE(3, 2) BIGS_CASE(3, 3)
    BIGS_CASE(4, 0) BIGS_CASE(4, 1) BIGS_CASE(4, 2) BIGS_CASE(4, 3)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BIGS_CASE
}

}  // extern "C"
