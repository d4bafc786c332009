// Linear-family ET E-step (training) for sm_90a: the per-datapoint part.
//
// With sgemm.cu it replaces
// prosper_tpu/ops/linear_pallas.py::linear_et_estep_pallas (body _kernel,
// front end _frontend / _union_softmax).  The wrapper
// (ops/linear_cuda.py::linear_et_estep_cuda) runs three stages:
//
//   1. sgemm_nn          P = y W                      (N, H), sgemm.cu
//   2. rows_kernel       here: per datapoint the top-H' candidates, the
//      union logits, the annealed softmax and the moments; writes F, turns
//      the row of P into w <s> in place, and sums ss (H, H), s (H) and
//      misc = [vc (K), abs, y2, n, F, F_true] over the datapoints
//   3. sgemm_tn_splitn   xs = y^T (w <s>)             (D, H), sgemm.cu
//
// What bounds this kernel on the H100: neither bytes nor operations.  Per
// datapoint it reads a row of P and of y (H + D floats) and does about
// 2*S*(2 H'^2 + 2 H' + K + 1) flops of logits and moments and some
// 3*(H*K + S) exponentials: at the patches width 50 Kflop and 2 KB, which
// the card could do in 0.1 ms for 131072 rows.  What it waits for is the
// latency of short dependent chains (H' iterated argmaxes, the softmax's
// max, sum and normalisation) and the shared-memory loads of the state
// tables: about 1300 warp-wide loads per datapoint.
//
// What the design does about it:
// * The two D x H products are not here: they run as register-tiled GEMMs
//   over all N rows (sgemm.cu), so the block holds no tile of y, no slice
//   of W and no D x H accumulator.
// * The state tables [states | outer | vcounts | absst | prior] sit in
//   shared memory for the life of the block, state-minor with an odd row
//   stride: the logits walk them with the lanes along the states, the
//   moments with the lanes along the table's rows, and both patterns hit
//   32 distinct banks.  In the logits a lane owns four states at a time,
//   so one load of a Gram entry feeds four FMAs; in the moments a lane
//   owns two table rows, so one load of q_s feeds two.  No moment is a
//   warp reduction any more.
// * The posterior is not stored: the singleton terms are recomputed from
//   P[h] where they are needed (a few flops and an expf each), so a row
//   needs H + S + 2 H'^2 floats of shared memory, not 1 + H*K + S + 2 H.
// * One warp owns one datapoint and a block is 8 warps, three blocks to an
//   SM at the patches width (71 KB each): 24 warps an SM hide each
//   other's latency.
// * Blocks run in parallel and in no order, so a fixed number of
//   persistent blocks each walks its tiles of 8 datapoints in order,
//   accumulating into its own workspace slice (H*H + H + K + 5 floats),
//   and reduce_blocks sums the slices in block order.  No float atomics:
//   the sums are deterministic, and a step with collect_true off gives
//   the same sums, bit for bit, as one with it on.  Rows of one tile can
//   hit the same ss entry, so the scatter runs one row after another (a
//   block barrier between rows); the H'^2 entries of one row are distinct
//   units and go in parallel.  Rows with weight 0 skip the scatter.

#include "linear_et_frontend.cuh"

namespace let {

constexpr int RWARPS = 8;              // datapoints per tile, one warp each
constexpr int RTHREADS = 32 * RWARPS;
constexpr int ROWV = 8 + KMAX;         // per-row scalars kept for the sums
enum { RV_F, RV_FT, RV_ABS, RV_Y2, RV_W, RV_MX, RV_Z, RV_VC = 8 };

struct RowsSmem {
  float* tab;     // (Hp + Hp^2 + K + 2) x SP: states | outer | vcounts |
                  // absst | prior, state-minor, row stride SP = S | 1
  float* gd;      // H        diag(gram)
  float* wn;      // H        column norms, floored
  float* accs;    // H        block sums of w <s>
  float* accd;    // H        block sums of w <s_h^2> from singletons
  float* work;    // RWARPS*H scores, then P's row, then w <s>
  float* L;       // RWARPS*S multi-state likelihood terms, then q
  float* X;       // RWARPS*(Hp + Hp^2)  candidate projections | Gram
  float* mom;     // RWARPS*J multi-state moments, J = Hp + Hp^2 + K + 1
  float* rowv;    // RWARPS*ROWV
  float* misc;    // KMAX + 5
  float* vals;    // KMAX     latent values
  float* lo;      // KMAX     log odds
  int* cand;      // RWARPS*Hp
};

__host__ __device__ inline size_t rows_smem_floats(int H, int Hp, int S,
                                                   int K) {
  const size_t NX = (size_t)Hp + (size_t)Hp * Hp, J = NX + K + 1;
  return (J + 1) * (size_t)(S | 1) + 4 * (size_t)H
         + RWARPS * ((size_t)H + S + NX + J + ROWV + Hp) + 3 * KMAX + 5;
}

__device__ inline RowsSmem carve_rows(float* p, const Dims& d) {
  const size_t NX = (size_t)d.Hp + (size_t)d.Hp * d.Hp, J = NX + d.K + 1;
  RowsSmem s;
  s.tab = p;    p += (J + 1) * (size_t)(d.S | 1);
  s.gd = p;     p += d.H;
  s.wn = p;     p += d.H;
  s.accs = p;   p += d.H;
  s.accd = p;   p += d.H;
  s.work = p;   p += (size_t)RWARPS * d.H;
  s.L = p;      p += (size_t)RWARPS * d.S;
  s.X = p;      p += RWARPS * NX;
  s.mom = p;    p += RWARPS * J;
  s.rowv = p;   p += RWARPS * ROWV;
  s.misc = p;   p += KMAX + 5;
  s.vals = p;   p += KMAX;
  s.lo = p;     p += KMAX;
  s.cand = reinterpret_cast<int*>(p);
  return s;
}

__host__ __device__ inline size_t ws_stride(int H, int K) {
  return (size_t)H * H + H + K + 5;
}

// The singleton (h, k) likelihood term from P[h].
__device__ inline float lik_single(float p, float g, float v, float inv2s2) {
  return ((2.f * p) * v - g * (v * v)) * inv2s2;
}

__global__ void __launch_bounds__(RTHREADS, 3)
rows_kernel(const float* __restrict__ y, const float* __restrict__ weight,
            float* P,               // (N, H): y W on entry, w <s> on exit
            Tables t, Dims d, float* __restrict__ F,
            float* __restrict__ ws, int n_tiles) {
  extern __shared__ float smem_raw[];
  const RowsSmem sm = carve_rows(smem_raw, d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = d.D, H = d.H, K = d.K, Hp = d.Hp, S = d.S;
  const int HP2 = Hp * Hp, NX = Hp + HP2, J = NX + K + 1, SP = S | 1;
  const size_t stride = ws_stride(H, K);
  float* wss = ws + (size_t)blockIdx.x * stride;
  float* wsv = wss + (size_t)H * H;
  float* wmisc = wsv + H;

  // ---- per-block tables ---------------------------------------------------
  for (int i = tid; i < J * S; i += RTHREADS) {
    const int row = i / S, s = i - row * S;
    float v;
    if (row < Hp) v = t.states[(size_t)row * S + s];
    else if (row < NX) v = t.outer[(size_t)(row - Hp) * S + s];
    else if (row < NX + K) v = t.vcounts[(size_t)(row - NX) * S + s];
    else v = t.absst[s];
    sm.tab[(size_t)row * SP + s] = v;
  }
  for (int s = tid; s < S; s += RTHREADS) {
    float p = 0.f;
    for (int k = 0; k < K; ++k)
      p = fmaf(t.vcounts[(size_t)k * S + s], t.log_odds[k], p);
    sm.tab[(size_t)J * SP + s] = p;
  }
  for (int h = tid; h < H; h += RTHREADS) {
    const float g = t.gram[(size_t)h * H + h];
    sm.gd[h] = g;
    sm.wn[h] = fmaxf(sqrtf(fmaxf(g, 1e-30f)), 1e-12f);
    sm.accs[h] = 0.f;
    sm.accd[h] = 0.f;
  }
  for (int i = tid; i < KMAX + 5; i += RTHREADS) sm.misc[i] = 0.f;
  if (tid < K) {
    sm.vals[tid] = t.values[tid];
    sm.lo[tid] = t.log_odds[tid];
  }
  for (size_t i = tid; i < stride; i += RTHREADS) wss[i] = 0.f;
  const Scalars c = load_scalars(d, t);
  const float inv2s2 = c.inv2s2, beta = c.beta, pb = c.pb;
  const float* prior = sm.tab + (size_t)J * SP;
  __syncthreads();

  // the view select_candidates takes: rows of P in device memory
  Smem sel{};
  sel.work = sm.work;
  sel.wn = sm.wn;
  sel.cand = sm.cand;

  float* work = sm.work + (size_t)warp * H;
  float* L = sm.L + (size_t)warp * S;
  float* X = sm.X + (size_t)warp * NX;
  float* mom = sm.mom + (size_t)warp * J;
  float* rowv = sm.rowv + warp * ROWV;
  const int* cand = sm.cand + warp * Hp;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * RWARPS;
    const int nrows = min(RWARPS, d.N - row0);

    if (warp < nrows) {
      const size_t n = (size_t)row0 + warp;
      const float* Prow = P + n * H;
      const float w = weight[n];
      sel.Ps = P + (size_t)row0 * H;
      select_candidates(warp, lane, d, sel);

      // ---- P's row, the candidates' projections and Gram entries ---------
      for (int h = lane; h < H; h += 32) work[h] = Prow[h];
      __syncwarp();
      for (int a = lane; a < Hp; a += 32) X[a] = work[cand[a]];
      for (int i = lane; i < HP2; i += 32)
        X[Hp + i] = t.gram[(size_t)cand[i / Hp] * H + cand[i % Hp]];
      __syncwarp();

      // ---- likelihood terms of the multi states, and the maxima ----------
      float mx = 0.f, mxt = 0.f;             // the zero state's logit is 0
      int sb = 0;
      for (; sb + 128 <= S; sb += 128) {     // four states a lane
        float d1[4] = {0.f, 0.f, 0.f, 0.f}, d2[4] = {0.f, 0.f, 0.f, 0.f};
        const float* tr = sm.tab + sb + lane;
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
        const float* tr = sm.tab + s;
        for (int a = 0; a < Hp; ++a, tr += SP) d1 = fmaf(X[a], *tr, d1);
        for (int i = 0; i < HP2; ++i, tr += SP)
          d2 = fmaf(X[Hp + i], *tr, d2);
        const float lik = (2.f * d1 - d2) * inv2s2;
        L[s] = lik;
        mx = fmaxf(mx, beta * lik + pb * prior[s]);
        mxt = fmaxf(mxt, lik + prior[s]);
      }
      // ---- the singletons' maxima ----------------------------------------
      for (int h = lane; h < H; h += 32) {
        const float p = work[h], g = sm.gd[h];
        for (int k = 0; k < K; ++k) {
          const float lik = lik_single(p, g, sm.vals[k], inv2s2);
          mx = fmaxf(mx, beta * lik + pb * sm.lo[k]);
          mxt = fmaxf(mxt, lik + sm.lo[k]);
        }
      }
      mx = warp_max(mx);
      mxt = warp_max(mxt);

      // ---- union masses ---------------------------------------------------
      float Z = 0.f, Zt = 0.f;
      for (int h = lane; h < H; h += 32) {
        const float p = work[h], g = sm.gd[h];
        for (int k = 0; k < K; ++k) {
          const float lik = lik_single(p, g, sm.vals[k], inv2s2);
          Z += expf((beta * lik + pb * sm.lo[k]) - mx);
          if (d.collect_true) Zt += expf((lik + sm.lo[k]) - mxt);
        }
      }
      for (int s = lane; s < S; s += 32) {
        const float lik = L[s];
        Z += expf((beta * lik + pb * prior[s]) - mx);
        if (d.collect_true) Zt += expf((lik + prior[s]) - mxt);
      }
      Z = warp_sum(Z) + expf(-mx);
      Zt = warp_sum(Zt) + expf(-mxt);

      // ---- q of the multi states in place, then their moments ------------
      for (int s = lane; s < S; s += 32)
        L[s] = expf((beta * L[s] + pb * prior[s]) - mx) / Z;
      __syncwarp();
      int jb = 0;
      for (; jb + 64 <= J; jb += 64) {       // two table rows a lane
        const float* t0 = sm.tab + (size_t)(jb + lane) * SP;
        const float* t1 = t0 + (size_t)32 * SP;
        float a0 = 0.f, a1 = 0.f;
        for (int s = 0; s < S; ++s) {
          const float q = L[s];
          a0 = fmaf(q, t0[s], a0);
          a1 = fmaf(q, t1[s], a1);
        }
        mom[jb + lane] = a0;
        mom[jb + lane + 32] = a1;
      }
      for (int j = jb + lane; j < J; j += 32) {
        const float* t0 = sm.tab + (size_t)j * SP;
        float a0 = 0.f;
        for (int s = 0; s < S; ++s) a0 = fmaf(L[s], t0[s], a0);
        mom[j] = a0;
      }

      // ---- singletons: posterior mean over all H units, value counts -----
      float vcl[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) vcl[k] = 0.f;
      for (int h = lane; h < H; h += 32) {
        const float p = work[h], g = sm.gd[h];
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k < K) {
            const float v = sm.vals[k];
            const float lik = lik_single(p, g, v, inv2s2);
            const float q = expf((beta * lik + pb * sm.lo[k]) - mx) / Z;
            acc = k == 0 ? q * v : fmaf(q, v, acc);
            vcl[k] += q;
          }
        }
        work[h] = acc;
      }
      float y2 = 0.f;
      const float* yr = y + n * D;
      for (int i = lane; i < D; i += 32) y2 = fmaf(yr[i], yr[i], y2);
      y2 = warp_sum(y2);
      float qs_tot = 0.f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
          vcl[k] = warp_sum(vcl[k]);
          qs_tot += vcl[k];
        }
      }
      __syncwarp();                          // work and mom are written

      // the multi states' mean goes to the candidates (distinct units)
      if (lane < Hp) work[cand[lane]] += mom[lane];
      __syncwarp();
      for (int h = lane; h < H; h += 32) work[h] *= w;

      if (lane == 0) {
        const float Fr = (mx + logf(Z))
            + free_energy_const(y2, inv2s2, c.log_norm, c.log_p0, beta, pb,
                                H);
        const float Ftr = d.collect_true
            ? (mxt + logf(Zt))
                  + free_energy_const(y2, inv2s2, c.log_norm, c.log_p0, 1.f,
                                      1.f, H)
            : Fr;
        F[n] = Fr;
        rowv[RV_F] = Fr;
        rowv[RV_FT] = Ftr;
        rowv[RV_ABS] = qs_tot + mom[NX + K];
        rowv[RV_Y2] = y2;
        rowv[RV_W] = w;
        rowv[RV_MX] = mx;
        rowv[RV_Z] = Z;
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          if (k < K) rowv[RV_VC + k] = vcl[k] + mom[NX + k];
      }
    }
    __syncthreads();

    // ---- s, the singleton diagonal of ss, and w <s> over P's rows ---------
    for (int h = tid; h < H; h += RTHREADS) {
      float a = sm.accs[h], b = sm.accd[h];
      const float g = sm.gd[h];
      for (int r = 0; r < nrows; ++r) {
        const float* rv = sm.rowv + r * ROWV;
        float* Pn = P + ((size_t)row0 + r) * H + h;
        if (rv[RV_W] != 0.f) {
          const float p = *Pn;
          float t2 = 0.f;
          for (int k = 0; k < K; ++k) {
            const float v = sm.vals[k];
            const float lik = lik_single(p, g, v, inv2s2);
            const float q =
                expf((beta * lik + pb * sm.lo[k]) - rv[RV_MX]) / rv[RV_Z];
            t2 = k == 0 ? q * (v * v) : fmaf(q, v * v, t2);
          }
          b += t2 * rv[RV_W];
        }
        const float sw = sm.work[(size_t)r * H + h];
        a += sw;
        *Pn = sw;
      }
      sm.accs[h] = a;
      sm.accd[h] = b;
    }
    // ss scatter, one row after another (rows may share entries)
    for (int r = 0; r < nrows; ++r) {
      const float w = sm.rowv[r * ROWV + RV_W];
      if (w != 0.f) {
        const int* cr = sm.cand + r * Hp;
        const float* ssc = sm.mom + (size_t)r * J + Hp;
        for (int i = tid; i < HP2; i += RTHREADS)
          wss[(size_t)cr[i / Hp] * H + cr[i % Hp]] += ssc[i] * w;
      }
      __syncthreads();
    }
    if (tid == 0) {
      for (int r = 0; r < nrows; ++r) {
        const float* rv = sm.rowv + r * ROWV;
        const float w = rv[RV_W];
        for (int k = 0; k < K; ++k) sm.misc[k] += rv[RV_VC + k] * w;
        sm.misc[K] += rv[RV_ABS] * w;
        sm.misc[K + 1] += rv[RV_Y2] * w;
        sm.misc[K + 2] += w;
        sm.misc[K + 3] += rv[RV_F] * w;
        sm.misc[K + 4] += rv[RV_FT] * w;
      }
    }
    __syncthreads();
  }

  for (int h = tid; h < H; h += RTHREADS) {
    wsv[h] = sm.accs[h];
    wss[(size_t)h * H + h] += sm.accd[h];
  }
  for (int i = tid; i < K + 5; i += RTHREADS) wmisc[i] = sm.misc[i];
}

}  // namespace let

extern "C" {

// Workspace floats per persistent block; the caller allocates
// n_blocks * this for ws and this for sums.
size_t linear_et_estep_ws_stride(int H, int K) {
  return let::ws_stride(H, K);
}

// Shared memory of the decode kernel's tile (linear_et_decode.cu).
size_t linear_et_smem_bytes(int D, int H, int Hp, int S, int K) {
  return let::smem_floats(D, H, Hp, S, K) * sizeof(float);
}

// Shared memory of a block of the E-step's rows kernel.
size_t linear_et_rows_smem_bytes(int H, int Hp, int S, int K) {
  return let::rows_smem_floats(H, Hp, S, K) * sizeof(float);
}

const char* linear_et_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The per-datapoint stage of the E-step.  P (N, H) holds y W and leaves
// as w <s>.  sums = [ss (H*H) | s (H) | vc (K) | abs | y2 | n | F | F_true]
int linear_et_estep_rows(const float* y, const float* weight, float* P,
                         const float* gram, const float* states,
                         const float* outer, const float* vcounts,
                         const float* absst, const float* values,
                         const float* log_odds, const float* scal, float* F,
                         float* ws, float* sums, int N, int D, int H, int Hp,
                         int S, int K, int signed_select, int collect_true,
                         int n_blocks, void* stream) {
  let::Tables t{nullptr, gram, states, outer, vcounts, absst, values,
                log_odds, scal};
  let::Dims d{N, D, H, Hp, S, K, 1 + H * K + S, signed_select, collect_true};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = let::rows_smem_floats(H, Hp, S, K) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      let::rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(let::rows_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = (N + let::RWARPS - 1) / let::RWARPS;
  let::rows_kernel<<<n_blocks, let::RTHREADS, smem, s>>>(
      y, weight, P, t, d, F, ws, n_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t stride = let::ws_stride(H, K);
  let::reduce_blocks<<<(unsigned)((stride + 255) / 256), 256, 0, s>>>(
      ws, sums, n_blocks, stride, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
