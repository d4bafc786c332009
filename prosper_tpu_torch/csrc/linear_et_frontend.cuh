// Shared front end of the ET kernels for sm_90a: projection GEMM, top-H'
// candidate selection, candidate Gram gather, truncated-union logits and
// the annealed softmax, for a tile of TILE datapoints held in shared
// memory.  The linear family (BSC / TSC / DSC) uses all of it; the max
// family's kernel (max_et_estep.cu) the projection, the selection, the
// scalars and the block reduction.
//
// Replaces prosper_tpu/ops/linear_pallas.py::_frontend and _union_softmax,
// the front end of the TPU kernels linear_et_estep_pallas and
// linear_et_decode_pallas.
//
// What bounds it on the H100: per datapoint the front end does 2*D*H flops
// of projection GEMM (P = y W, in float32 on the CUDA cores: no tensor
// cores, so that the kernel agrees with its plain version to float32
// rounding) and S*(H'+H'^2) flops of union logits, each a short dependent
// chain per lane; the data it reads (y: D floats per row) is small against
// that.  Measured at the patches width (D=256, H=300, S=154), the
// projection takes about a fifth of the E-step kernel and the rest of the
// front end is latency-bound warp work.
//
// What the design does about it: W (D x H) does not fit in shared memory at
// the patches width (256 x 300 floats), so it is streamed through shared
// memory in DS-row slices while every thread keeps HC x TILE partial sums
// of P in registers; y's tile is read once and broadcast from shared memory.
// The H x H Gram matrix stays in global memory (the L2) and only the H'^2
// entries each row needs are gathered.  One warp owns one datapoint for
// selection and softmax, so every per-row reduction is a warp shuffle.
// The lanes of that warp walk the S multi states, so the state tables come
// in state-minor (transposed) layout: 32 lanes read 32 consecutive floats
// instead of 32 rows of the table.
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
constexpr int DS = 16;            // rows of W per shared-memory slice
constexpr int KMAX = 8;           // largest number of non-zero latent values
constexpr int HPMAX = 32;         // largest H' (one lane per candidate slot)

struct Dims {
  int N, D, H, Hp, S, K;
  int U;              // union width 1 + H*K + S
  int signed_select;
  int collect_true;
};

struct Tables {       // device pointers, all float32 and contiguous
  const float* W;        // (D, H)
  const float* gram;     // (H, H)
  const float* states;   // (Hp, S)     state-minor: entry (s, a) at a*S + s
  const float* outer;    // (Hp*Hp, S)  entry (s, i) at i*S + s
  const float* vcounts;  // (K, S)      entry (s, k) at k*S + s
  const float* absst;    // (S,)
  const float* values;   // (K,)
  const float* log_odds; // (K,)
  const float* scal;     // (3,) sigma2, beta, prior_beta
};

struct Smem {
  float* ys;      // TILE*D   the tile's datapoints
  float* Ps;      // TILE*H   P = y W
  float* work;    // TILE*H   scores, then the posterior mean (times w)
  float* buf;     // TILE*U   un-annealed likelihood terms, then q
  float* Wsl;     // DS*H     a slice of W
  float* proj;    // TILE*Hp
  float* Gf;      // TILE*Hp*Hp
  float* sscand;  // TILE*Hp*Hp  w * <s s^T> over the candidates
  float* gd;      // H        diag(gram)
  float* wn;      // H        column norms, floored
  float* prior;   // S        value_counts @ log_odds
  float* accs;    // H        block sums of w <s>
  float* accd;    // H        block sums of w <s_h^2> from singletons
  float* rowF;    // TILE
  float* rowFt;   // TILE
  float* rowAbs;  // TILE
  float* rowY2;   // TILE
  float* rowW;    // TILE
  float* rowVc;   // TILE*KMAX
  float* misc;    // KMAX+5
  int* cand;      // TILE*Hp
};

__host__ __device__ inline size_t smem_floats(int D, int H, int Hp, int S,
                                              int K) {
  const size_t U = 1 + (size_t)H * K + S;
  return (size_t)TILE * D + 2 * (size_t)TILE * H + TILE * U + (size_t)DS * H
         + (size_t)TILE * Hp + 2 * (size_t)TILE * Hp * Hp + 4 * (size_t)H + S
         + 5 * TILE + TILE * KMAX + KMAX + 5 + (size_t)TILE * Hp;
}

__device__ inline Smem carve(float* p, const Dims& d) {
  Smem s;
  s.ys = p;      p += (size_t)TILE * d.D;
  s.Ps = p;      p += (size_t)TILE * d.H;
  s.work = p;    p += (size_t)TILE * d.H;
  s.buf = p;     p += (size_t)TILE * d.U;
  s.Wsl = p;     p += (size_t)DS * d.H;
  s.proj = p;    p += (size_t)TILE * d.Hp;
  s.Gf = p;      p += (size_t)TILE * d.Hp * d.Hp;
  s.sscand = p;  p += (size_t)TILE * d.Hp * d.Hp;
  s.gd = p;      p += d.H;
  s.wn = p;      p += d.H;
  s.prior = p;   p += d.S;
  s.accs = p;    p += d.H;
  s.accd = p;    p += d.H;
  s.rowF = p;    p += TILE;
  s.rowFt = p;   p += TILE;
  s.rowAbs = p;  p += TILE;
  s.rowY2 = p;   p += TILE;
  s.rowW = p;    p += TILE;
  s.rowVc = p;   p += TILE * KMAX;
  s.misc = p;    p += KMAX + 5;
  s.cand = reinterpret_cast<int*>(p);
  return s;
}

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

// Per-block tables: diag(gram), floored column norms, multi-state priors.
__device__ inline void block_setup(const Dims& d, const Tables& t,
                                   const Smem& sm) {
  for (int h = threadIdx.x; h < d.H; h += THREADS) {
    const float g = t.gram[(size_t)h * d.H + h];
    sm.gd[h] = g;
    sm.wn[h] = fmaxf(sqrtf(fmaxf(g, 1e-30f)), 1e-12f);
    sm.accs[h] = 0.f;
    sm.accd[h] = 0.f;
  }
  for (int s = threadIdx.x; s < d.S; s += THREADS) {
    float p = 0.f;
    for (int k = 0; k < d.K; ++k)
      p = fmaf(t.vcounts[(size_t)k * d.S + s], t.log_odds[k], p);
    sm.prior[s] = p;
  }
  for (int i = threadIdx.x; i < KMAX + 5; i += THREADS) sm.misc[i] = 0.f;
}

// Load the tile's rows of y (zeros past N) and compute P = y W into
// shared memory.  Thread t owns columns t, t + THREADS, ... (HC of them)
// for all TILE rows.  Ends with __syncthreads().
template <int HC>
__device__ void tile_projection(const float* __restrict__ y, int row0,
                                int nrows, const Dims& d, const Tables& t,
                                const Smem& sm) {
  const int D = d.D, H = d.H, tid = threadIdx.x;
  for (int i = tid; i < TILE * D; i += THREADS) {
    const int r = i / D;
    sm.ys[i] = r < nrows ? y[(size_t)(row0 + r) * D + (i - r * D)] : 0.f;
  }
  float acc[HC][TILE];
#pragma unroll
  for (int c = 0; c < HC; ++c)
#pragma unroll
    for (int r = 0; r < TILE; ++r) acc[c][r] = 0.f;

  for (int d0 = 0; d0 < D; d0 += DS) {
    const int dn = min(DS, D - d0);
    __syncthreads();   // previous slice consumed (and ys written)
    for (int i = tid; i < dn * H; i += THREADS)
      sm.Wsl[i] = t.W[(size_t)d0 * H + i];
    __syncthreads();
    for (int dd = 0; dd < dn; ++dd) {
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int h = tid + c * THREADS;
        const float wv = h < H ? sm.Wsl[dd * H + h] : 0.f;
#pragma unroll
        for (int r = 0; r < TILE; ++r)
          acc[c][r] = fmaf(sm.ys[r * D + d0 + dd], wv, acc[c][r]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < HC; ++c) {
    const int h = tid + c * THREADS;
    if (h < H) {
#pragma unroll
      for (int r = 0; r < TILE; ++r) sm.Ps[r * H + h] = acc[c][r];
    }
  }
  __syncthreads();
}

// One warp, one datapoint r of the tile: the top-H' candidates, Hp
// iterated argmaxes of P / ||W_h|| (of |P| / ||W_h|| when d.signed_select),
// ties to the lowest index, into sm.cand + r*Hp.  sm.work + r*H is scratch.
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

// out[j] = sum over blocks b, in order, of ws[b][j]: the second pass of the
// E-step kernels, which sum into one workspace slice per persistent block
static __global__ void reduce_blocks(const float* __restrict__ ws,
                                     float* __restrict__ out, int nb,
                                     size_t stride) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= stride) return;
  float acc = 0.f;
  for (int b = 0; b < nb; ++b) acc += ws[(size_t)b * stride + j];
  out[j] = acc;
}

struct RowOut {
  float logZ;    // log of the annealed union mass
  float logZt;   // log of the un-annealed union mass (collect_true only)
  float y2;      // ||y||^2
};

// Annealed logit of canonical union entry u from its likelihood term.
__device__ inline float union_logit(int u, float lik, const Dims& d,
                                    const Tables& t, const Smem& sm,
                                    float beta, float pb) {
  if (u == 0) return 0.f;
  if (u <= d.H * d.K) return beta * lik + pb * t.log_odds[(u - 1) % d.K];
  return beta * lik + pb * sm.prior[u - 1 - d.H * d.K];
}

__device__ inline float union_logit_true(int u, float lik, const Dims& d,
                                         const Tables& t, const Smem& sm) {
  if (u == 0) return 0.f;
  if (u <= d.H * d.K) return lik + t.log_odds[(u - 1) % d.K];
  return lik + sm.prior[u - 1 - d.H * d.K];
}

// One warp, one datapoint r of the tile: candidate selection, proj and
// Gram gathers, union logits and the annealed softmax.  Leaves the
// posterior q over the canonical union [zero | H*K singletons | S multi]
// in sm.buf + r*U and the candidates in sm.cand + r*Hp.
__device__ inline RowOut frontend_row(int r, int lane, const Dims& d,
                               const Tables& t, const Smem& sm,
                               float inv2s2, float beta, float pb) {
  const int H = d.H, K = d.K, Hp = d.Hp, S = d.S, U = d.U, HK = d.H * d.K;
  const float* P = sm.Ps + (size_t)r * H;
  const int* cand = sm.cand + r * Hp;
  select_candidates(r, lane, d, sm);

  // ---- candidate projections and Gram entries --------------------------
  float* pr = sm.proj + r * Hp;
  float* g = sm.Gf + (size_t)r * Hp * Hp;
  for (int a = lane; a < Hp; a += 32) pr[a] = P[cand[a]];
  for (int i = lane; i < Hp * Hp; i += 32)
    g[i] = t.gram[(size_t)cand[i / Hp] * H + cand[i % Hp]];
  __syncwarp();

  // ---- likelihood terms and the running maxima --------------------------
  float* L = sm.buf + (size_t)r * U;
  float mx = 0.f, mxt = 0.f;               // the zero state's logit is 0
  for (int i = lane; i < HK; i += 32) {
    const int h = i / K, k = i - h * K;
    const float v = t.values[k];
    const float lik = ((2.f * P[h]) * v - sm.gd[h] * (v * v)) * inv2s2;
    L[1 + i] = lik;
    mx = fmaxf(mx, union_logit(1 + i, lik, d, t, sm, beta, pb));
    mxt = fmaxf(mxt, union_logit_true(1 + i, lik, d, t, sm));
  }
  for (int s = lane; s < S; s += 32) {
    float d1 = 0.f, d2 = 0.f;
    for (int a = 0; a < Hp; ++a)
      d1 = fmaf(pr[a], t.states[(size_t)a * S + s], d1);
    for (int i = 0; i < Hp * Hp; ++i)
      d2 = fmaf(g[i], t.outer[(size_t)i * S + s], d2);
    const float lik = (2.f * d1 - d2) * inv2s2;
    L[1 + HK + s] = lik;
    mx = fmaxf(mx, union_logit(1 + HK + s, lik, d, t, sm, beta, pb));
    mxt = fmaxf(mxt, union_logit_true(1 + HK + s, lik, d, t, sm));
  }
  mx = warp_max(mx);
  mxt = warp_max(mxt);

  // ---- union masses, then q = exp(logit - m) / Z in place ---------------
  float Z = 0.f, Zt = 0.f;
  for (int u = lane; u < U; u += 32) {
    const float lik = u == 0 ? 0.f : L[u];
    Z += expf(union_logit(u, lik, d, t, sm, beta, pb) - mx);
    if (d.collect_true) Zt += expf(union_logit_true(u, lik, d, t, sm) - mxt);
  }
  Z = warp_sum(Z);
  Zt = warp_sum(Zt);
  for (int u = lane; u < U; u += 32) {
    const float lik = u == 0 ? 0.f : L[u];
    L[u] = expf(union_logit(u, lik, d, t, sm, beta, pb) - mx) / Z;
  }

  float y2 = 0.f;
  const float* yr = sm.ys + (size_t)r * d.D;
  for (int i = lane; i < d.D; i += 32) y2 = fmaf(yr[i], yr[i], y2);
  y2 = warp_sum(y2);
  __syncwarp();

  RowOut o;
  o.logZ = mx + logf(Z);
  o.logZt = d.collect_true ? mxt + logf(Zt) : 0.f;
  o.y2 = y2;
  return o;
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
