// Shared front end of the ET kernels for sm_90a: top-H' candidate
// selection, the per-datapoint scalars of F, warp reductions and the
// in-order sum over per-block workspace slices, which every E-step kernel
// uses; and, for the two per-datapoint kernels of the linear family (the
// E-step's rows kernel, linear_et_estep.cu, and the decode's,
// linear_et_decode.cu), the state table in shared memory, the candidates'
// projections and Gram entries and the multi states' likelihood terms.
// All of them read their rows of the projection P = y W, which sgemm.cu
// computes, from device memory.
//
// Replaces prosper_tpu/ops/linear_pallas.py::_frontend and _union_softmax,
// the front end of the TPU kernels linear_et_estep_pallas and
// linear_et_decode_pallas.
//
// What bounds it on the H100: neither bytes nor operations, but the
// latency of short dependent chains (H' iterated argmaxes over H scores,
// the softmax's max and sum) and the shared-memory loads of the state
// table; see linear_et_estep.cu.
//
// What the design does about it: one warp owns one datapoint, so every
// per-row reduction is a warp shuffle; the state table sits in shared
// memory state-minor with an odd row stride, so that the lanes of a warp,
// which walk the states, read 32 distinct banks, and a lane owns four
// states at a time, so that one load of a Gram entry feeds four FMAs.  The
// H x H Gram matrix stays in device memory (the L2) and only the H'^2
// entries each row needs are gathered.
//
// Numerics: the file is compiled without fast math and with -fmad=false, so
// every elementwise expression rounds as PyTorch's separate kernels do;
// sums of products use fmaf explicitly.  Ties in candidate selection and in
// the decode's top-L go to the lowest index, as jnp.argmax / torch.argmax.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

namespace let {

constexpr int TILE = 16;          // datapoints per tile
constexpr int THREADS = 256;      // threads per block
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 8;           // largest number of non-zero latent values
constexpr int HPMAX = 32;         // largest H' (one lane per candidate slot)
constexpr int RWARPS = 8;         // datapoints per tile of the linear family's
constexpr int RTHREADS = 32 * RWARPS;   // per-datapoint kernels, a warp each

struct Dims {
  int N, D, H, Hp, S, K;
  int U;              // union width 1 + H*K + S
  int signed_select;
  int collect_true;
};

struct Tables {       // device pointers, all float32 and contiguous
  const float* gram;     // (H, H)
  const float* states;   // (Hp, S)     state-minor: entry (s, a) at a*S + s
  const float* outer;    // (Hp*Hp, S)  entry (s, i) at i*S + s
  const float* vcounts;  // (K, S)      entry (s, k) at k*S + s
  const float* absst;    // (S,)
  const float* values;   // (K,)
  const float* log_odds; // (K,)
  const float* scal;     // (3,) sigma2, beta, prior_beta
};

struct Smem {         // the view select_candidates takes
  float* ys;      // TILE*D   the tile's datapoints (the max kernel's)
  const float* Ps;  // rows of P = y W, in shared or in device memory
  float* work;    // TILE*H   scores
  float* wn;      // H        column norms, floored
  int* cand;      // TILE*Hp
};

__device__ inline float warp_sum(float v) {
  // xor butterfly: every lane ends with the same, order-fixed sum
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// (value, index) argmax across the warp; ties to the lowest index
__device__ inline void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

// Lane-local argmax over x[lane], x[lane+32], ... (ties to the lowest
// index), then across the warp.  Returns the winning index in every lane.
__device__ inline int row_argmax(const float* x, int n, int lane, float* best) {
  float b = -CUDART_INF_F;
  int bi = 0x7fffffff;
  if (lane < n) { b = x[lane]; bi = lane; }
  for (int j = lane + 32; j < n; j += 32) {
    const float v = x[j];
    if (v > b) { b = v; bi = j; }
  }
  warp_argmax(b, bi);
  *best = b;
  return bi;
}

// One warp, one datapoint r of the tile: the top-H' candidates, Hp
// iterated argmaxes of P / ||W_h|| (of |P| / ||W_h|| when d.signed_select),
// ties to the lowest index, into sm.cand + r*Hp.  sm.work + r*H is scratch;
// sm.Ps may point to rows of P in shared or in device memory.
__device__ inline void select_candidates(int r, int lane, const Dims& d,
                                         const Smem& sm) {
  const int H = d.H, Hp = d.Hp;
  const float* P = sm.Ps + (size_t)r * H;
  float* sc = sm.work + (size_t)r * H;
  int* cand = sm.cand + r * Hp;
  for (int h = lane; h < H; h += 32) {
    const float s = P[h] / sm.wn[h];
    sc[h] = d.signed_select ? fabsf(s) : s;
  }
  __syncwarp();
  for (int a = 0; a < Hp; ++a) {
    float b;
    const int bi = row_argmax(sc, H, lane, &b);
    __syncwarp();
    if (lane == 0) { cand[a] = bi; sc[bi] = -CUDART_INF_F; }
    __syncwarp();
  }
}

// ---- shared by the linear family's per-datapoint kernels --------------------

// Rows of the state table in shared memory, state-minor with the odd row
// stride SP = S | 1: J = Hp + Hp^2 + K + 1 rows [states | outer | vcounts |
// absst], then the multi states' prior, value_counts @ log_odds, as row J.
__host__ __device__ inline size_t state_table_floats(int Hp, int S, int K) {
  return ((size_t)Hp + (size_t)Hp * Hp + K + 2) * (size_t)(S | 1);
}

// Fill the table; the caller's block barrier follows.
__device__ inline void load_state_table(float* tab, const Dims& d,
                                        const Tables& t) {
  const int tid = threadIdx.x, K = d.K, Hp = d.Hp, S = d.S;
  const int NX = Hp + Hp * Hp, J = NX + K + 1, SP = S | 1;
  for (int i = tid; i < J * S; i += RTHREADS) {
    const int row = i / S, s = i - row * S;
    float v;
    if (row < Hp) v = t.states[(size_t)row * S + s];
    else if (row < NX) v = t.outer[(size_t)(row - Hp) * S + s];
    else if (row < NX + K) v = t.vcounts[(size_t)(row - NX) * S + s];
    else v = t.absst[s];
    tab[(size_t)row * SP + s] = v;
  }
  for (int s = tid; s < S; s += RTHREADS) {
    float p = 0.f;
    for (int k = 0; k < K; ++k)
      p = fmaf(t.vcounts[(size_t)k * S + s], t.log_odds[k], p);
    tab[(size_t)J * SP + s] = p;
  }
}

// The singleton (h, k) likelihood term from P[h].
__device__ inline float lik_single(float p, float g, float v, float inv2s2) {
  return ((2.f * p) * v - g * (v * v)) * inv2s2;
}

// One warp, one datapoint: P's row into work, the candidates' projections
// into X[0..Hp) and their Gram entries into X[Hp..Hp + Hp^2).
__device__ inline void gather_candidates(const float* Prow, const int* cand,
                                         float* work, float* X, const Dims& d,
                                         const Tables& t, int lane) {
  const int H = d.H, Hp = d.Hp, HP2 = Hp * Hp;
  for (int h = lane; h < H; h += 32) work[h] = Prow[h];
  __syncwarp();
  for (int a = lane; a < Hp; a += 32) X[a] = work[cand[a]];
  for (int i = lane; i < HP2; i += 32)
    X[Hp + i] = t.gram[(size_t)cand[i / Hp] * H + cand[i % Hp]];
  __syncwarp();
}

// One warp, one datapoint: the likelihood terms of the S multi states into
// L, from X = [proj | Gram] and the table; mx and mxt take in the annealed
// and the un-annealed logits.  A lane owns four states at a time.
__device__ inline void multi_lik(const float* tab, const float* X, float* L,
                                 const Dims& d, float inv2s2, float beta,
                                 float pb, int lane, float& mx, float& mxt) {
  const int Hp = d.Hp, S = d.S, HP2 = Hp * Hp, SP = S | 1;
  const float* prior = tab + (size_t)(Hp + HP2 + d.K + 1) * SP;
  int sb = 0;
  for (; sb + 128 <= S; sb += 128) {     // four states a lane
    float d1[4] = {0.f, 0.f, 0.f, 0.f}, d2[4] = {0.f, 0.f, 0.f, 0.f};
    const float* tr = tab + sb + lane;
    for (int a = 0; a < Hp; ++a, tr += SP) {
      const float x = X[a];
#pragma unroll
      for (int j = 0; j < 4; ++j) d1[j] = fmaf(x, tr[32 * j], d1[j]);
    }
    for (int i = 0; i < HP2; ++i, tr += SP) {
      const float x = X[Hp + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) d2[j] = fmaf(x, tr[32 * j], d2[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = sb + lane + 32 * j;
      const float lik = (2.f * d1[j] - d2[j]) * inv2s2;
      L[s] = lik;
      mx = fmaxf(mx, beta * lik + pb * prior[s]);
      mxt = fmaxf(mxt, lik + prior[s]);
    }
  }
  for (int s = sb + lane; s < S; s += 32) {
    float d1 = 0.f, d2 = 0.f;
    const float* tr = tab + s;
    for (int a = 0; a < Hp; ++a, tr += SP) d1 = fmaf(X[a], *tr, d1);
    for (int i = 0; i < HP2; ++i, tr += SP)
      d2 = fmaf(X[Hp + i], *tr, d2);
    const float lik = (2.f * d1 - d2) * inv2s2;
    L[s] = lik;
    mx = fmaxf(mx, beta * lik + pb * prior[s]);
    mxt = fmaxf(mxt, lik + prior[s]);
  }
}

// out[j] = sum over blocks b, in order, of ws[b][j] (added to what out[j]
// holds when accumulate is set): the second pass of the kernels that sum
// into one workspace slice per block or per split
static __global__ void reduce_blocks(const float* __restrict__ ws,
                                     float* __restrict__ out, int nb,
                                     size_t stride, int accumulate) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= stride) return;
  float acc = accumulate ? out[j] : 0.f;
  for (int b = 0; b < nb; ++b) acc += ws[(size_t)b * stride + j];
  out[j] = acc;
}

// The per-datapoint constant of F:
// -beta ||y||^2 / 2s2 - beta log_norm + prior_beta H log p0.
__device__ inline float free_energy_const(float y2, float inv2s2,
                                          float log_norm, float log_p0,
                                          float beta, float pb, int H) {
  return (-beta) * (y2 * inv2s2) - beta * log_norm + (pb * (float)H) * log_p0;
}

struct Scalars {
  float sigma2, beta, pb, inv2s2, log_norm, log_p0;
};

__device__ inline Scalars load_scalars(const Dims& d, const Tables& t) {
  Scalars s;
  s.sigma2 = t.scal[0];
  s.beta = t.scal[1];
  s.pb = t.scal[2];
  s.inv2s2 = 0.5f / s.sigma2;
  float e = 0.f;
  for (int k = 0; k < d.K; ++k) e += expf(t.log_odds[k]);
  s.log_p0 = -log1pf(e);
  s.log_norm = (0.5f * (float)d.D) * logf((2.f * CUDART_PI_F) * s.sigma2);
  return s;
}

// s_cand[a] = sum_s q_multi[s] states[s, a] for the row; lane a returns it.
__device__ inline float row_scand(const float* qm, const Dims& d,
                                  const Tables& t, int lane) {
  float mine = 0.f;
  for (int a = 0; a < d.Hp; ++a) {
    float acc = 0.f;
    for (int s = lane; s < d.S; s += 32)
      acc = fmaf(qm[s], t.states[(size_t)a * d.S + s], acc);
    acc = warp_sum(acc);
    if (lane == a) mine = acc;
  }
  return mine;
}

// Posterior mean over all H units into out[0..H): singletons, then the
// multi-state moments scattered to the candidates (distinct units).
__device__ inline void row_posterior_mean(float* out, const float* q,
                                          const int* cand, float scand_mine,
                                          const Dims& d, const Tables& t,
                                          int lane) {
  const int K = d.K;
  for (int h = lane; h < d.H; h += 32) {
    const float* qs = q + 1 + (size_t)h * K;
    float acc = qs[0] * t.values[0];
    for (int k = 1; k < K; ++k) acc = fmaf(qs[k], t.values[k], acc);
    out[h] = acc;
  }
  __syncwarp();
  if (lane < d.Hp) out[cand[lane]] += scand_mine;
  __syncwarp();
}

}  // namespace let
