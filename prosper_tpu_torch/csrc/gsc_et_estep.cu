// GSC (spike-and-slab sparse coding) ET E-step for sm_90a: the
// per-datapoint part.
//
// It replaces no TPU kernel: the JAX package runs GSC's E-step as plain
// XLA (prosper_tpu/core/gscstep.py::_chunk_gsc_estats), and the port's
// plain version (core/gscstep.py::_chunk_gsc_estats) issues some 420 small
// torch operations a chunk of rows, among them a one-hot GEMM that scatters
// 36 values a row at 2500 times the work the statistic needs.  The wrapper
// (ops/gsc_cuda.py::gsc_et_estep_cuda) runs three stages, as the linear
// family's E-step does:
//
//   1. sgemm_nn          P = y W                      (N, H), sgemm.cu
//   2. gsc_estep_kernel  here: per datapoint the top-H' candidates (signed
//      selection, linear_et_frontend.cuh), the H singletons in closed form,
//      each support's m x m slab system solved in registers (Cholesky
//      factor, log det, kappa = M^-1 b, Sigma = M^-1, b^T kappa), the
//      annealed and the un-annealed softmax over the 1 + H + S columns, F,
//      and the moments; it turns the row of P into w <sz> in place and sums
//      ss (H, H), s (H) and misc = [abs, y2, n, F, F_true] over the rows
//   3. sgemm_tn_splitn   xs = y^T (w <sz>)            (D, H), sgemm.cu
//
// What bounds it on the H100: neither bytes nor operations.  Per datapoint
// it reads a row of P and of y (H + D floats) and does some 4 Kflop: the
// supports' solves (at H' = 6, gamma = 3, 35 supports of 2 or 3 units, a
// few dozen flops, square roots, logarithms and IEEE divides each) and the
// singletons (a divide and three exponentials a unit).  What it waits for
// is the latency of dependent chains (H' iterated argmaxes, each support's
// Cholesky recurrence, the softmax's max, sum and normalisation) and the
// shared-memory loads of the candidate frame.
//
// What the design does about it:
// * One warp owns one datapoint, 8 warps to a block, as the linear family's
//   rows kernel: every per-row reduction is a warp shuffle, and the lanes
//   walk the supports (a support a lane) and the H units.
// * A support's system lives in registers: the kernel is a template on
//   gamma and the solver on the support size m <= 4, unrolled at compile
//   time, so the m x m factor, the solve and the inverse are straight-line
//   code with no indexing into memory.  The support table (size and slots
//   of each support, host-built once per state table) and the lists that
//   gather the supports' moments into the candidate frame sit in shared
//   memory for the life of the block.
// * The posterior is never written to device memory: a row's likelihoods,
//   masses, kappa and Sigma live in its warp's slice of shared memory, and
//   the moments <sz> (H' slots) and <sz sz^T> (H'(H'+1)/2 slot pairs) are
//   gathered there in a fixed order, then scattered to H and H x H.
// * Blocks run in parallel and in no order, so a fixed number of
//   persistent blocks each walks its tiles of 8 datapoints in order,
//   accumulating into its own workspace slice (H*H + H + 5 floats), and
//   reduce_blocks sums the slices in block order.  No float atomics: the
//   sums are deterministic, and a step with collect_true off gives the same
//   sums, bit for bit, as one with it on, but F_true.  Rows of one tile can
//   hit the same ss entry, so the scatter runs one row after another (a
//   block barrier between rows); the H'^2 entries of one row are distinct
//   units and go in parallel.  Rows with weight 0 skip the scatter.
//
// Numerics: IEEE float32 built with -fmad=false and without fast math; the
// solver's recurrences follow core/gscstep.py::chol_bl, solve_bl and
// inverse_bl operation by operation (the pivot clamped at 1e-30), and the
// likelihoods and F follow _chunk_gsc_estats' expressions.  Ties in the
// candidate selection go to the lowest index.

#include "launch_once.cuh"
#include "linear_et_frontend.cuh"

namespace gsc {

using let::RTHREADS;
using let::RWARPS;

constexpr int HPM = 8;     // largest H' (slot indices take 4 bits each)
constexpr int GMAX = 4;    // largest support, gamma
constexpr int NMISC = 5;   // abs, y2, n, F, F_true
enum { RV_F, RV_FT, RV_ABS, RV_Y2, RV_W, ROWV = 8 };

// position of the pair (i, j), i >= j, in a packed lower triangle
__host__ __device__ constexpr int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// rows of a support's moment buffer: kappa (gamma), then Sigma's lower
// triangle (gamma (gamma + 1) / 2)
__host__ __device__ constexpr int moment_rows(int gamma) {
  return gamma + gamma * (gamma + 1) / 2;
}

// items of the candidate frame: <sz> of each slot (Hp), then <sz sz^T> of
// each slot pair a >= b (Hp (Hp + 1) / 2)
__host__ __device__ constexpr int n_items(int Hp) {
  return Hp + Hp * (Hp + 1) / 2;
}

struct Params {
  const float* y;       // (N, D)
  const float* weight;  // (N,)
  float* P;             // (N, H): y W on entry, w <sz> on exit
  const float* gram;    // (H, H)
  const int* table;     // codes (S) | item starts (NI + 1) | item entries
  const float* scal;    // sigma2, pi, mu, psi, beta, prior_beta
  float* F;             // (N,)
  float* ws;            // n_blocks * ws_stride(H)
  int N, D, H, Hp, S, table_ints, collect_true, n_tiles;
};

struct Smem {
  int* tab;       // table_ints: the support table and the gather lists
  float* wn;      // H        column norms, floored
  float* m1;      // H        singleton precision 1/psi + g/sigma2
  float* c1;      // H        singleton likelihood's constant part
  float* sig1;    // H        1 / m1
  float* accs;    // H        block sums of w <sz>
  float* accd;    // H        block sums of w <s_h z_h^2> of the singletons
  float* misc;    // 8
  float* work;    // RWARPS*H scores, P's row, kappa1, then w <sz>
  float* ls;      // RWARPS*H singleton likelihoods, then their masses
  float* t2;      // RWARPS*H q_h (1/m1_h + kappa1_h^2)
  float* L;       // RWARPS*S support likelihoods, then their masses
  float* ks;      // RWARPS*NP*S kappa | Sigma, then the supports' moments
  float* X;       // RWARPS*(Hp + Hp^2) natural parameters | precisions
  float* mom;     // RWARPS*NI the row's moments in the candidate frame
  float* rowv;    // RWARPS*ROWV
  int* cand;      // RWARPS*Hp
};

__host__ __device__ inline size_t smem_words(int H, int Hp, int S, int gamma,
                                             int table_ints) {
  const size_t per_warp = 3 * (size_t)H + S + (size_t)moment_rows(gamma) * S
                          + Hp + (size_t)Hp * Hp + n_items(Hp) + ROWV + Hp;
  return (size_t)table_ints + 6 * (size_t)H + 8 + RWARPS * per_warp;
}

__device__ inline Smem carve(float* p, const Params& q, int gamma) {
  const int H = q.H, Hp = q.Hp, S = q.S;
  Smem s;
  s.tab = reinterpret_cast<int*>(p); p += q.table_ints;
  s.wn = p;     p += H;
  s.m1 = p;     p += H;
  s.c1 = p;     p += H;
  s.sig1 = p;   p += H;
  s.accs = p;   p += H;
  s.accd = p;   p += H;
  s.misc = p;   p += 8;
  s.work = p;   p += (size_t)RWARPS * H;
  s.ls = p;     p += (size_t)RWARPS * H;
  s.t2 = p;     p += (size_t)RWARPS * H;
  s.L = p;      p += (size_t)RWARPS * S;
  s.ks = p;     p += (size_t)RWARPS * moment_rows(gamma) * S;
  s.X = p;      p += (size_t)RWARPS * (Hp + Hp * Hp);
  s.mom = p;    p += (size_t)RWARPS * n_items(Hp);
  s.rowv = p;   p += RWARPS * ROWV;
  s.cand = reinterpret_cast<int*>(p);
  return s;
}

__host__ __device__ inline size_t ws_stride(int H) {
  return (size_t)H * H + H + NMISC;
}

// The likelihood of one support of M units (slots in `code`), from the
// row's natural parameters X[0..Hp) and precisions X[Hp..Hp + Hp^2)
// (Gram / sigma2, plus 1/psi on the diagonal); kappa and Sigma's lower
// triangle go to the support's column of the moment buffer (row stride S).
// The recurrences are chol_bl, logdet_bl, solve_bl and inverse_bl's.
template <int M, int G>
__device__ inline float support_lik(unsigned code, const float* X, int Hp,
                                    float* ksw, int S, float log_psi,
                                    float mm, float hip) {
  int idx[M];
#pragma unroll
  for (int i = 0; i < M; ++i) idx[i] = (code >> (4 + 4 * i)) & 15u;
  const float* Gm = X + Hp;
  float L[M][M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float s = Gm[idx[j] * Hp + idx[j]];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    const float d = sqrtf(fmaxf(s, 1e-30f));
    L[j][j] = d;
    const float inv = 1.f / d;
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      float t = Gm[idx[i] * Hp + idx[j]];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv;
    }
  }
  float ld = logf(L[0][0]);
#pragma unroll
  for (int j = 1; j < M; ++j) ld = ld + logf(L[j][j]);
  ld = 2.f * ld;

  float b[M], yv[M], kap[M];
#pragma unroll
  for (int i = 0; i < M; ++i) b[i] = X[idx[i]];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * yv[k];
    yv[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float s = yv[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) s = s - L[k][i] * kap[k];
    kap[i] = s / L[i][i];
  }
  float bMb = b[0] * kap[0];
#pragma unroll
  for (int i = 1; i < M; ++i) bMb = bMb + b[i] * kap[i];
#pragma unroll
  for (int i = 0; i < M; ++i) ksw[(size_t)i * S] = kap[i];

  // Sigma = M^-1 column by column, from the unit vectors
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float e[M], x[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float s = i == j ? 1.f : 0.f;
#pragma unroll
      for (int k = 0; k < i; ++k) s = s - L[i][k] * e[k];
      e[i] = s / L[i][i];
    }
#pragma unroll
    for (int i = M - 1; i >= 0; --i) {
      float s = e[i];
#pragma unroll
      for (int k = i + 1; k < M; ++k) s = s - L[k][i] * x[k];
      x[i] = s / L[i][i];
    }
#pragma unroll
    for (int i = j; i < M; ++i) ksw[(size_t)(G + tri(i, j)) * S] = x[i];
  }
  const float m = (float)M;
  return (((-0.5f * m) * log_psi - 0.5f * ld) - (m * mm) * hip) + 0.5f * bMb;
}

template <int G>
__device__ inline float support_any(int m, unsigned code, const float* X,
                                    int Hp, float* ksw, int S, float log_psi,
                                    float mm, float hip) {
  if constexpr (G >= 4) {
    if (m == 4)
      return support_lik<4, G>(code, X, Hp, ksw, S, log_psi, mm, hip);
  }
  if constexpr (G >= 3) {
    if (m == 3)
      return support_lik<3, G>(code, X, Hp, ksw, S, log_psi, mm, hip);
  }
  return support_lik<2, G>(code, X, Hp, ksw, S, log_psi, mm, hip);
}

// A support's moments in place of its kappa and Sigma: q kappa_i and
// q (Sigma_ij + kappa_i kappa_j), i >= j.
template <int M, int G>
__device__ inline void support_moments(float q, float* ksw, int S) {
  float kap[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    kap[i] = ksw[(size_t)i * S];
    ksw[(size_t)i * S] = q * kap[i];
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float* e = ksw + (size_t)(G + tri(i, j)) * S;
      *e = q * (*e + kap[i] * kap[j]);
    }
  }
}

template <int G>
__device__ inline void moments_any(int m, float q, float* ksw, int S) {
  if constexpr (G >= 4) {
    if (m == 4) return support_moments<4, G>(q, ksw, S);
  }
  if constexpr (G >= 3) {
    if (m == 3) return support_moments<3, G>(q, ksw, S);
  }
  support_moments<2, G>(q, ksw, S);
}

template <int G>
__global__ void __launch_bounds__(RTHREADS, 3)
gsc_estep_kernel(Params p) {
  extern __shared__ float smem_raw[];
  const Smem sm = carve(smem_raw, p, G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = p.D, H = p.H, Hp = p.Hp, S = p.S;
  const int HP2 = Hp * Hp, NI = n_items(Hp), NX = Hp + HP2;
  constexpr int NP = moment_rows(G);
  const size_t stride = ws_stride(H);
  float* wss = p.ws + (size_t)blockIdx.x * stride;
  float* wsv = wss + (size_t)H * H;
  float* wmisc = wsv + H;

  // ---- the model's scalars, as _chunk_gsc_estats forms them ---------------
  const float sigma2 = p.scal[0], pi = p.scal[1], mu = p.scal[2];
  const float psi = p.scal[3], beta = p.scal[4], pb = p.scal[5];
  const float inv_s2 = 1.f / sigma2, inv_psi = 1.f / psi;
  const float lo = logf(pi) - log1pf(-pi);
  const float log_psi = logf(psi);
  const float mb = mu * inv_psi;
  const float mm = mu * mu, hip = 0.5f * inv_psi;
  const float log_norm =
      (0.5f * (float)D) * logf((2.f * CUDART_PI_F) * sigma2);
  const float l1p = log1pf(-pi);

  // ---- per-block tables ---------------------------------------------------
  for (int i = tid; i < p.table_ints; i += RTHREADS) sm.tab[i] = p.table[i];
  for (int h = tid; h < H; h += RTHREADS) {
    const float g = p.gram[(size_t)h * H + h];
    const float m1 = inv_psi + g * inv_s2;
    sm.wn[h] = fmaxf(sqrtf(fmaxf(g, 1e-30f)), 1e-12f);
    sm.m1[h] = m1;
    sm.c1[h] = ((-0.5f * log_psi) - 0.5f * logf(m1)) - mm * hip;
    sm.sig1[h] = 1.f / m1;
    sm.accs[h] = 0.f;
    sm.accd[h] = 0.f;
  }
  if (tid < 8) sm.misc[tid] = 0.f;
  for (size_t i = tid; i < stride; i += RTHREADS) wss[i] = 0.f;
  __syncthreads();

  const unsigned* codes = reinterpret_cast<const unsigned*>(sm.tab);
  const int* istart = sm.tab + S;
  const int* ientry = istart + NI + 1;

  // the views the front end takes: rows of P in device memory
  let::Dims d{};
  d.N = p.N;
  d.D = D;
  d.H = H;
  d.Hp = Hp;
  d.S = S;
  d.signed_select = 1;
  let::Tables t{};
  t.gram = p.gram;
  let::Smem sel{};
  sel.work = sm.work;
  sel.wn = sm.wn;
  sel.cand = sm.cand;

  float* work = sm.work + (size_t)warp * H;
  float* ls = sm.ls + (size_t)warp * H;
  float* t2 = sm.t2 + (size_t)warp * H;
  float* L = sm.L + (size_t)warp * S;
  float* ks = sm.ks + (size_t)warp * NP * S;
  float* X = sm.X + (size_t)warp * NX;
  float* mom = sm.mom + (size_t)warp * NI;
  float* rowv = sm.rowv + warp * ROWV;
  const int* cand = sm.cand + warp * Hp;

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int row0 = tile * RWARPS;
    const int nrows = min(RWARPS, p.N - row0);

    if (warp < nrows) {
      const size_t n = (size_t)row0 + warp;
      const float w = p.weight[n];
      sel.Ps = p.P + (size_t)row0 * H;
      let::select_candidates(warp, lane, d, sel);

      // ---- P's row, the candidates' projections and Gram entries, then
      // the natural parameters b and the precisions in place ---------------
      let::gather_candidates(p.P + n * H, cand, work, X, d, t, lane);
      for (int a = lane; a < Hp; a += 32) X[a] = X[a] * inv_s2 + mb;
      for (int i = lane; i < HP2; i += 32) {
        const float gs = X[Hp + i] * inv_s2;
        X[Hp + i] = i / Hp == i % Hp ? gs + inv_psi : gs;
      }
      __syncwarp();

      // ---- the supports' likelihoods, and the maxima --------------------
      float mx = 0.f, mxt = 0.f;             // the zero state's logit is 0
      for (int s = lane; s < S; s += 32) {
        const unsigned code = codes[s];
        const int m = (int)(code & 15u);
        const float lik =
            support_any<G>(m, code, X, Hp, ks + s, S, log_psi, mm, hip);
        const float pr = (float)m * lo;
        L[s] = lik;
        mx = fmaxf(mx, beta * lik + pb * pr);
        mxt = fmaxf(mxt, lik + pr);
      }
      // ---- the singletons in closed form --------------------------------
      for (int h = lane; h < H; h += 32) {
        const float b1 = work[h] * inv_s2 + mb;
        const float k1 = b1 / sm.m1[h];
        const float lik = sm.c1[h] + (0.5f * b1) * k1;
        work[h] = k1;
        ls[h] = lik;
        mx = fmaxf(mx, beta * lik + pb * lo);
        mxt = fmaxf(mxt, lik + lo);
      }
      mx = let::warp_max(mx);
      mxt = let::warp_max(mxt);

      // ---- the masses of both channels ----------------------------------
      float Z = 0.f, Zt = 0.f;
      for (int h = lane; h < H; h += 32) {
        const float lik = ls[h];
        const float e = expf((beta * lik + pb * lo) - mx);
        ls[h] = e;
        Z += e;
        if (p.collect_true) Zt += expf((lik + lo) - mxt);
      }
      for (int s = lane; s < S; s += 32) {
        const float pr = (float)(codes[s] & 15u) * lo;
        const float lik = L[s];
        const float e = expf((beta * lik + pb * pr) - mx);
        L[s] = e;
        Z += e;
        if (p.collect_true) Zt += expf((lik + pr) - mxt);
      }
      Z = let::warp_sum(Z) + expf(-mx);
      Zt = let::warp_sum(Zt) + expf(-mxt);

      // ---- q, and the moments of each support and singleton -------------
      float qa = 0.f, qs = 0.f;
      for (int s = lane; s < S; s += 32) {
        const int m = (int)(codes[s] & 15u);
        const float q = L[s] / Z;
        qa += q * (float)m;
        moments_any<G>(m, q, ks + s, S);
      }
      for (int h = lane; h < H; h += 32) {
        const float q = ls[h] / Z;
        const float k1 = work[h];
        qs += q;
        work[h] = q * k1;
        t2[h] = q * (sm.sig1[h] + k1 * k1);
      }
      qa = let::warp_sum(qa);
      qs = let::warp_sum(qs);
      __syncwarp();

      // ---- the supports' moments gathered into the candidate frame, in
      // the lists' fixed order --------------------------------------------
      for (int k = lane; k < NI; k += 32) {
        float acc = 0.f;
        for (int e = istart[k]; e < istart[k + 1]; ++e) acc += ks[ientry[e]];
        mom[k] = acc;
      }
      __syncwarp();
      // <sz> of the slots goes to the candidates (distinct units)
      if (lane < Hp) work[cand[lane]] += mom[lane];
      __syncwarp();
      for (int h = lane; h < H; h += 32) work[h] *= w;

      float y2 = 0.f;
      const float* yr = p.y + n * D;
      for (int i = lane; i < D; i += 32) y2 = fmaf(yr[i], yr[i], y2);
      y2 = let::warp_sum(y2);
      if (lane == 0) {
        const float Fr = (mx + logf(Z))
            + (((-beta) * ((0.5f * y2) * inv_s2) - beta * log_norm)
               + (pb * (float)H) * l1p);
        const float Ftr = p.collect_true
            ? (mxt + logf(Zt))
                  + ((-((0.5f * y2) * inv_s2) - log_norm) + (float)H * l1p)
            : Fr;
        p.F[n] = Fr;
        rowv[RV_F] = Fr;
        rowv[RV_FT] = Ftr;
        rowv[RV_ABS] = qs + qa;
        rowv[RV_Y2] = y2;
        rowv[RV_W] = w;
      }
    }
    __syncthreads();

    // ---- s, the singleton diagonal of ss, and w <sz> over P's rows -------
    for (int h = tid; h < H; h += RTHREADS) {
      float a = sm.accs[h], b = sm.accd[h];
      for (int r = 0; r < nrows; ++r) {
        const float w = sm.rowv[r * ROWV + RV_W];
        if (w != 0.f) b += sm.t2[(size_t)r * H + h] * w;
        const float sw = sm.work[(size_t)r * H + h];
        a += sw;
        p.P[((size_t)row0 + r) * H + h] = sw;
      }
      sm.accs[h] = a;
      sm.accd[h] = b;
    }
    // ss scatter, one row after another (rows may share entries)
    for (int r = 0; r < nrows; ++r) {
      const float w = sm.rowv[r * ROWV + RV_W];
      if (w != 0.f) {
        const int* cr = sm.cand + r * Hp;
        const float* pairs = sm.mom + (size_t)r * NI + Hp;
        for (int i = tid; i < HP2; i += RTHREADS) {
          const int a = i / Hp, b = i - a * Hp;
          const float v = pairs[a >= b ? tri(a, b) : tri(b, a)];
          wss[(size_t)cr[a] * H + cr[b]] += v * w;
        }
      }
      __syncthreads();
    }
    if (tid == 0) {
      for (int r = 0; r < nrows; ++r) {
        const float* rv = sm.rowv + r * ROWV;
        const float w = rv[RV_W];
        sm.misc[0] += rv[RV_ABS] * w;
        sm.misc[1] += rv[RV_Y2] * w;
        sm.misc[2] += w;
        sm.misc[3] += rv[RV_F] * w;
        sm.misc[4] += rv[RV_FT] * w;
      }
    }
    __syncthreads();
  }

  for (int h = tid; h < H; h += RTHREADS) {
    wsv[h] = sm.accs[h];
    wss[(size_t)h * H + h] += sm.accd[h];
  }
  if (tid < NMISC) wmisc[tid] = sm.misc[tid];
}

template <int G>
cudaError_t prepare() {
  static launch_once::DeviceOnce once;
  return launch_once::prepare_kernel(gsc_estep_kernel<G>, once, true);
}

template <int G>
cudaError_t run(const Params& p, int n_blocks, size_t smem, int* blocks,
                cudaStream_t stream) {
  cudaError_t e = prepare<G>();
  if (e != cudaSuccess) return e;
  if (blocks != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, gsc_estep_kernel<G>, RTHREADS, smem);
  gsc_estep_kernel<G><<<n_blocks, RTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// the kernel at gamma = 2, 3 or 4: its launch, or (blocks given) the
// blocks an SM holds at once
inline cudaError_t dispatch(int gamma, const Params& p, int n_blocks,
                            size_t smem, int* blocks, cudaStream_t stream) {
  switch (gamma) {
    case 2: return run<2>(p, n_blocks, smem, blocks, stream);
    case 3: return run<3>(p, n_blocks, smem, blocks, stream);
    case 4: return run<4>(p, n_blocks, smem, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

inline bool fits(int Hp, int S, int gamma) {
  return Hp >= 2 && Hp <= HPM && gamma >= 2 && gamma <= GMAX && S >= 1;
}

}  // namespace gsc

extern "C" {

// Workspace floats per persistent block; the caller allocates
// n_blocks * this for ws and this for the sums after xs.
size_t gsc_et_ws_stride(int H) { return gsc::ws_stride(H); }

// Shared memory of a block.
size_t gsc_et_smem_bytes(int H, int Hp, int S, int gamma, int table_ints) {
  return gsc::smem_words(H, Hp, S, gamma, table_ints) * sizeof(float);
}

// Blocks of the kernel that one SM holds at once, into *blocks.
int gsc_et_blocks_per_sm(int H, int Hp, int S, int gamma, int table_ints,
                         int* blocks) {
  if (!gsc::fits(Hp, S, gamma))
    return static_cast<int>(cudaErrorInvalidValue);
  gsc::Params p{};
  return static_cast<int>(gsc::dispatch(
      gamma, p, 0, gsc_et_smem_bytes(H, Hp, S, gamma, table_ints), blocks,
      nullptr));
}

// The per-datapoint stage of the E-step.  P (N, H) holds y W and leaves as
// w <sz>.  table: the int32 support table of ops/gsc_cuda.py
// (support_tables), table_ints long.  scal: sigma2, pi, mu, psi, beta,
// prior_beta.  sums = [ss (H*H) | s (H) | abs | y2 | n | F | F_true].
int gsc_et_estep_rows(const float* y, const float* weight, float* P,
                      const float* gram, const int* table, const float* scal,
                      float* F, float* ws, float* sums, int N, int D, int H,
                      int Hp, int S, int gamma, int table_ints,
                      int collect_true, int n_blocks, void* stream) {
  if (!gsc::fits(Hp, S, gamma) || N < 1 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (N + let::RWARPS - 1) / let::RWARPS;
  gsc::Params p{y, weight, P, gram, table, scal, F, ws,
                N, D, H, Hp, S, table_ints, collect_true, n_tiles};
  const size_t smem = gsc_et_smem_bytes(H, Hp, S, gamma, table_ints);
  cudaError_t e = gsc::dispatch(gamma, p, n_blocks, smem, nullptr, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t stride = gsc::ws_stride(H);
  let::reduce_blocks<<<(unsigned)((stride + 255) / 256), 256, 0, s>>>(
      ws, sums, n_blocks, stride, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
