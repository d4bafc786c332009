// Big-S multi-state recurrence (the s_block linear E-step) for sm_90a.
//
// Replaces prosper_tpu/ops/bigs_pallas.py::bigs_multi_pallas (body
// _kernel).  Per datapoint n it runs an online logsumexp over the S
// enumerated multi states:
//
//   logit[n, s] = Xa[n, :] . A[s, :]      A = [st | ot | prior | mask]
//   m  <- max(m, max_s logit),  acc <- acc * exp(m_old - m)
//   acc[n, :]  += sum_s exp(logit[n, s] - m) * B[s, :]
//                                         B = [st | ot | vcounts | abs | 1]
//
// and, for the un-annealed channel, the pair (m_t, l_t) of Xt . A.  The
// operands are built in torch (ops/bigs_cuda.py, core/etstep.py::
// bigs_operands): beta, 1/(2 sigma^2), prior_beta and the padding mask are
// folded into them, so the kernel is two fused products with a softmax in
// between.  It writes acc (C, nB) and stats (3, C) = [m; m_t; l_t].
//
// What bounds it on the H100: the float32 multiply-adds on the CUDA cores,
// (nA + nB) per (row, state) plus nA for the un-annealed channel: at the
// tsc_bigs width (H'=10, K=2: nA = 112, nB = 114, S = 12,564) that is
// 5.7 MFLOP per row saturated and 8.5 annealed, 0.75 to 1.1 TFLOP per
// E-step of N = 131,072 rows, at least 11 to 17 ms at the card's published
// 67 TFLOP/s.  The N*S to 2*N*S expf calls are a small share.  A and B
// together are about 11 MB, so every block rereads them from the L2.
//
// What the design does about it: rows are independent, so a block owns 64
// rows and nothing crosses blocks (no atomics, no second pass; a call is
// deterministic, and with collect_true off the m/acc outputs are the same
// bit for bit).  The block keeps its rows' X in shared memory and walks
// the states in tiles of 64, staging A and B tiles in shared memory; the
// (64 x 64) logits tile and the running (max, mass, moments) never reach
// device memory.  Both products are register-blocked: each of 256 threads
// holds a 4 x 4 logits tile and a 4 x (4 NC) accumulator tile (NC = 64-
// column groups of B).  The state tile is the kernel's own: any S works,
// states past S contribute nothing.  No fast math; expf, not __expf.

#include <cuda_runtime.h>

#include <cstddef>

namespace bigs {

constexpr int THREADS = 256;
constexpr int R = 64;        // rows (datapoints) per block
constexpr int T = 64;        // states per tile
constexpr int LP = T + 1;    // row stride of the logits tiles: a column
                             // read by 32 consecutive rows is conflict-free
constexpr int PP = R + 4;    // row stride of the state-major p tile
                             // (16-byte rows for float4 reads)
constexpr float NEG = -3e38f;

__host__ __device__ inline size_t smem_floats(int nA, int nbp, int tc) {
  const int ch = tc ? 2 : 1;
  return (size_t)nA * R * ch       // X of the block's rows, k-major
         + (size_t)nA * T          // A tile, k-major
         + (size_t)T * nbp         // B tile
         + (size_t)T * PP          // p tile, state-major
         + (size_t)R * LP * ch     // logits tiles, row-major
         + 4 * R                   // m, m_t, l_t, rescale
         + 3 * 4 * R;              // per-quarter max, max_t, mass_t
}

__device__ inline float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int NC, bool TC>
__global__ void __launch_bounds__(THREADS, 1)
bigs_kernel(const float* __restrict__ Xa, const float* __restrict__ Xt,
            const float* __restrict__ AT, const float* __restrict__ B,
            float* __restrict__ acc_out, float* __restrict__ stats, int C,
            int S, int nA, int nB) {
  constexpr int NBP = 64 * NC;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* xts = xs + (size_t)nA * R;
  float* as = xts + (TC ? (size_t)nA * R : 0);
  float* bs = as + (size_t)nA * T;
  float* ps = bs + (size_t)T * NBP;
  float* ls = ps + (size_t)T * PP;
  float* lts = ls + (size_t)R * LP;
  float* m_s = lts + (TC ? (size_t)R * LP : 0);
  float* mt_s = m_s + R;
  float* lt_s = mt_s + R;
  float* r_s = lt_s + R;
  float* red = r_s + R;        // [4][R] partial maxima of the tile's rows
  float* redt = red + 4 * R;   // [4][R] the same, un-annealed
  float* sumt = redt + 4 * R;  // [4][R] partial masses, un-annealed

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, C - row0);
  const int tr = tid >> 4, tc = tid & 15;  // products: 16 x 16 threads
  const int rr = tid & (R - 1);            // softmax: one row ...
  const int part = tid >> 6;               // ... and a quarter of the tile

  // the block's rows of X, k-major so that 4 rows are one float4; rows
  // past C are zeros and are never written out
  for (int i = tid; i < nA * R; i += THREADS) {
    const int r = i / nA, k = i - r * nA;
    const bool ok = r < nrows;
    xs[k * R + r] = ok ? Xa[(size_t)(row0 + r) * nA + k] : 0.f;
    if (TC) xts[k * R + r] = ok ? Xt[(size_t)(row0 + r) * nA + k] : 0.f;
  }
  if (tid < R) {
    m_s[tid] = NEG;
    mt_s[tid] = NEG;
    lt_s[tid] = 0.f;
  }
  float acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;

  for (int s0 = 0; s0 < S; s0 += T) {
    const int ns = min(T, S - s0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < nA * T; i += THREADS) {
      const int k = i / T, s = i - k * T;
      as[i] = s < ns ? AT[(size_t)k * S + s0 + s] : 0.f;
    }
    for (int i = tid; i < T * NBP; i += THREADS) {
      const int s = i / NBP, c = i - s * NBP;
      bs[i] = (s < ns && c < nB) ? B[(size_t)(s0 + s) * nB + c] : 0.f;
    }
    __syncthreads();

    // 1. logits of rows tr*4.., states tc*4..: Xa . A (and Xt . A)
    {
      float l[4][4], lt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) l[i][j] = lt[i][j] = 0.f;
      for (int k = 0; k < nA; ++k) {
        const float4 x4 = ld4(xs + k * R + tr * 4);
        const float4 a4 = ld4(as + k * T + tc * 4);
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) l[i][j] = fmaf(x[i], a[j], l[i][j]);
        if (TC) {
          const float4 y4 = ld4(xts + k * R + tr * 4);
          const float xt[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) lt[i][j] = fmaf(xt[i], a[j], lt[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tc * 4 + j;
          ls[(tr * 4 + i) * LP + s] = s < ns ? l[i][j] : NEG;
          if (TC) lts[(tr * 4 + i) * LP + s] = s < ns ? lt[i][j] : NEG;
        }
    }
    __syncthreads();

    // 2. online softmax of each row: partial maxima over quarters ...
    {
      float pm = NEG, pmt = NEG;
      for (int s = part * 16; s < part * 16 + 16; ++s) {
        pm = fmaxf(pm, ls[rr * LP + s]);
        if (TC) pmt = fmaxf(pmt, lts[rr * LP + s]);
      }
      red[part * R + rr] = pm;
      if (TC) redt[part * R + rr] = pmt;
    }
    __syncthreads();
    // ... the new running max, p (state-major) and the un-annealed mass
    const float m_new = fmaxf(
        m_s[rr], fmaxf(fmaxf(red[rr], red[R + rr]),
                       fmaxf(red[2 * R + rr], red[3 * R + rr])));
    const float mt_new =
        TC ? fmaxf(mt_s[rr], fmaxf(fmaxf(redt[rr], redt[R + rr]),
                                   fmaxf(redt[2 * R + rr], redt[3 * R + rr])))
           : 0.f;
    {
      float st = 0.f;
      for (int s = part * 16; s < part * 16 + 16; ++s) {
        ps[s * PP + rr] = expf(ls[rr * LP + s] - m_new);
        if (TC) st += expf(lts[rr * LP + s] - mt_new);
      }
      if (TC) sumt[part * R + rr] = st;
    }
    __syncthreads();
    // ... and one thread per row carries the running statistics
    if (part == 0) {
      r_s[rr] = expf(m_s[rr] - m_new);
      m_s[rr] = m_new;
      if (TC) {
        lt_s[rr] = lt_s[rr] * expf(mt_s[rr] - mt_new) +
                   (((sumt[rr] + sumt[R + rr]) + sumt[2 * R + rr]) +
                    sumt[3 * R + rr]);
        mt_s[rr] = mt_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * r + p . B for rows tr*4.., columns q*64 + tc*4..
    {
      float rv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) rv[i] = r_s[tr * 4 + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= rv[i];
      for (int s = 0; s < T; ++s) {  // p = 0 and B = 0 past the table
        const float4 p4 = ld4(ps + s * PP + tr * 4);
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const float4 b4 = ld4(bs + s * NBP + q * 64 + tc * 4);
          const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][q * 4 + j] = fmaf(p[i], b[j], acc[i][q * 4 + j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (r >= nrows) continue;
#pragma unroll
    for (int q = 0; q < NC; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = q * 64 + tc * 4 + j;
        if (c < nB) acc_out[(size_t)(row0 + r) * nB + c] = acc[i][q * 4 + j];
      }
  }
  if (tid < nrows) {
    stats[row0 + tid] = m_s[tid];
    stats[(size_t)C + row0 + tid] = mt_s[tid];
    stats[2 * (size_t)C + row0 + tid] = lt_s[tid];
  }
}

template <int NC, bool TC>
cudaError_t launch(const float* Xa, const float* Xt, const float* AT,
                   const float* B, float* acc, float* stats, int C, int S,
                   int nA, int nB, cudaStream_t stream) {
  const size_t smem = smem_floats(nA, 64 * NC, TC) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bigs_kernel<NC, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  bigs_kernel<NC, TC><<<(C + R - 1) / R, THREADS, smem, stream>>>(
      Xa, Xt, AT, B, acc, stats, C, S, nA, nB);
  return cudaGetLastError();
}

template <bool TC>
cudaError_t dispatch(const float* Xa, const float* Xt, const float* AT,
                     const float* B, float* acc, float* stats, int C, int S,
                     int nA, int nB, cudaStream_t st) {
  switch ((nB + 63) / 64) {
    case 1: return launch<1, TC>(Xa, Xt, AT, B, acc, stats, C, S, nA, nB, st);
    case 2: return launch<2, TC>(Xa, Xt, AT, B, acc, stats, C, S, nA, nB, st);
    case 3: return launch<3, TC>(Xa, Xt, AT, B, acc, stats, C, S, nA, nB, st);
    case 4: return launch<4, TC>(Xa, Xt, AT, B, acc, stats, C, S, nA, nB, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bigs

extern "C" {

size_t bigs_multi_smem_bytes(int nA, int nB, int collect_true) {
  return bigs::smem_floats(nA, 64 * ((nB + 63) / 64), collect_true) *
         sizeof(float);
}

// Xa, Xt (C, nA) row-major; AT (nA, S) state-minor; B (S, nB) row-major;
// out: acc (C, nB), stats (3, C) = [m; m_t; l_t].  Xt is read only with
// collect_true; nB <= 256.
int bigs_multi(const float* Xa, const float* Xt, const float* AT,
               const float* B, float* acc, float* stats, int C, int S,
               int nA, int nB, int collect_true, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      collect_true
          ? bigs::dispatch<true>(Xa, Xt, AT, B, acc, stats, C, S, nA, nB, st)
          : bigs::dispatch<false>(Xa, Xt, AT, B, acc, stats, C, S, nA, nB,
                                  st);
  return static_cast<int>(e);
}

}  // extern "C"
