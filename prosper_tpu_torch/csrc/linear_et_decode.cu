// Linear-family ET posterior decode (serving) for sm_90a: the per-datapoint
// part.
//
// With sgemm.cu it replaces
// prosper_tpu/ops/linear_pallas.py::linear_et_decode_pallas (body
// _decode_kernel, front end _frontend).  The wrapper
// (ops/linear_cuda.py::linear_et_decode_cuda) runs two stages:
//
//   1. sgemm_nn      P = y W                            (N, H), sgemm.cu
//   2. decode_kernel here: per datapoint F, the posterior mean s_mean (H),
//      the top-L posterior probabilities with their canonical union
//      indices (0 = zero state, 1 + h*K + k = singleton, 1 + H*K + s =
//      multi state; descending, ties to the lowest index, a taken entry
//      knocked out to -1), and the H' candidates.
//
// What bounds this kernel on the H100: as the E-step's rows kernel
// (linear_et_estep.cu), neither bytes nor operations: per datapoint it
// reads a row of P and of y and writes H + 2L + H' + 1 values, and does
// some 2*S*(H' + H'^2) flops of logits.  It waits for the latency of
// dependent chains: H' argmaxes over H scores, L argmaxes over the
// 1 + H*K + S posterior entries, the softmax's max and sum.
//
// What the design does about it, after the rows kernel:
// * The projection is not here: it runs as a register-tiled GEMM over all
//   rows, so the block holds no tile of y and streams no slice of W.
// * The state table sits in shared memory for the life of the block,
//   state-minor with an odd stride; in the logits a lane owns four states
//   at a time (multi_lik, shared with the rows kernel).
// * One warp owns one datapoint from its candidates to its last output, so
//   no block barrier follows the set-up; a block is 8 warps, three blocks
//   an SM at the patches width (75 KB each), and a fixed number of blocks
//   walks the rows, so the table is loaded once a block.
// * Unlike the E-step, the decode keeps the row's posterior q over the
//   canonical union (U = 1 + H*K + S floats a warp) for the L warp
//   argmaxes, which run over the buffer's own order.  The (N, U) posterior
//   never reaches device memory.
// * The multi states' mean splits the S states over 32 / H' lanes a
//   candidate and adds the parts in a fixed order.

#include "launch_once.cuh"
#include "linear_et_frontend.cuh"

namespace let {

struct DecodeSmem {
  float* tab;     // the state table (load_state_table)
  float* gd;      // H        diag(gram)
  float* wn;      // H        column norms, floored
  float* work;    // RWARPS*H scores, then P's row, then the posterior mean
  float* q;       // RWARPS*U union logits, then the posterior
  float* X;       // RWARPS*(Hp + Hp^2)  candidate projections | Gram
  float* vals;    // KMAX     latent values
  float* lo;      // KMAX     log odds
  int* cand;      // RWARPS*Hp
};

__host__ __device__ inline size_t decode_smem_floats(int H, int Hp, int S,
                                                     int K) {
  const size_t U = 1 + (size_t)H * K + S, NX = (size_t)Hp + (size_t)Hp * Hp;
  return state_table_floats(Hp, S, K) + 2 * (size_t)H
         + RWARPS * ((size_t)H + U + NX + Hp) + 2 * KMAX;
}

__device__ inline DecodeSmem carve_decode(float* p, const Dims& d) {
  const size_t NX = (size_t)d.Hp + (size_t)d.Hp * d.Hp;
  DecodeSmem s;
  s.tab = p;    p += state_table_floats(d.Hp, d.S, d.K);
  s.gd = p;     p += d.H;
  s.wn = p;     p += d.H;
  s.work = p;   p += (size_t)RWARPS * d.H;
  s.q = p;      p += (size_t)RWARPS * d.U;
  s.X = p;      p += RWARPS * NX;
  s.vals = p;   p += KMAX;
  s.lo = p;     p += KMAX;
  s.cand = reinterpret_cast<int*>(p);
  return s;
}

// s_cand[a] = sum_s qm[s] states[s, a] from the table's first Hp rows: lane
// a + Hp * part sums the states part, part + 32 / Hp, ...; the parts are
// added in order.  Lane a < Hp returns s_cand[a].
__device__ inline float multi_mean(const float* qm, const float* tab, int Hp,
                                   int S, int lane) {
  const int SP = S | 1, parts = 32 / Hp;
  const int a = lane % Hp, part = lane / Hp;
  float acc = 0.f;
  if (part < parts) {
    const float* tr = tab + (size_t)a * SP;
    for (int s = part; s < S; s += parts) acc = fmaf(qm[s], tr[s], acc);
  }
  float total = 0.f;
  for (int p = 0; p < parts; ++p)
    total += __shfl_sync(0xffffffffu, acc, a + Hp * p);
  return total;
}

__global__ void __launch_bounds__(RTHREADS, 3)
decode_kernel(const float* __restrict__ y, const float* __restrict__ P,
              Tables t, Dims d, int L, float* __restrict__ F,
              float* __restrict__ s_mean, float* __restrict__ top_q,
              int* __restrict__ top_u, int* __restrict__ cand_out) {
  extern __shared__ float smem_raw[];
  const DecodeSmem sm = carve_decode(smem_raw, d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = d.D, H = d.H, K = d.K, Hp = d.Hp, S = d.S, U = d.U;
  const int HK = H * K, NX = Hp + Hp * Hp, SP = S | 1;

  // ---- per-block tables ---------------------------------------------------
  load_state_table(sm.tab, d, t);
  for (int h = tid; h < H; h += RTHREADS) {
    const float g = t.gram[(size_t)h * H + h];
    sm.gd[h] = g;
    sm.wn[h] = fmaxf(sqrtf(fmaxf(g, 1e-30f)), 1e-12f);
  }
  if (tid < K) {
    sm.vals[tid] = t.values[tid];
    sm.lo[tid] = t.log_odds[tid];
  }
  const Scalars c = load_scalars(d, t);
  const float inv2s2 = c.inv2s2, beta = c.beta, pb = c.pb;
  const float* prior = sm.tab + (size_t)(NX + K + 1) * SP;
  __syncthreads();

  float* work = sm.work + (size_t)warp * H;
  float* q = sm.q + (size_t)warp * U;
  float* X = sm.X + (size_t)warp * NX;
  int* cand = sm.cand + warp * Hp;
  Smem sel{};                    // the view select_candidates takes
  sel.work = work;
  sel.wn = sm.wn;
  sel.cand = cand;

  for (size_t n = (size_t)blockIdx.x * RWARPS + warp; n < (size_t)d.N;
       n += (size_t)gridDim.x * RWARPS) {
    const float* Prow = P + n * H;
    sel.Ps = Prow;
    select_candidates(0, lane, d, sel);
    gather_candidates(Prow, cand, work, X, d, t, lane);

    // ---- the union's annealed logits [zero | singletons | multi] into q ----
    float mx = 0.f, unused = 0.f;            // the zero state's logit is 0
    float* qm = q + 1 + HK;
    multi_lik(sm.tab, X, qm, d, inv2s2, beta, pb, lane, mx, unused);
    for (int s = lane; s < S; s += 32) qm[s] = beta * qm[s] + pb * prior[s];
    for (int h = lane; h < H; h += 32) {
      const float p = work[h], g = sm.gd[h];
      for (int k = 0; k < K; ++k) {
        const float lg =
            beta * lik_single(p, g, sm.vals[k], inv2s2) + pb * sm.lo[k];
        q[1 + h * K + k] = lg;
        mx = fmaxf(mx, lg);
      }
    }
    if (lane == 0) q[0] = 0.f;
    mx = warp_max(mx);
    __syncwarp();

    // ---- the union mass, then q = exp(logit - m) / Z in place --------------
    float Z = 0.f;
    for (int u = lane; u < U; u += 32) Z += expf(q[u] - mx);
    Z = warp_sum(Z);
    for (int u = lane; u < U; u += 32) q[u] = expf(q[u] - mx) / Z;
    float y2 = 0.f;
    const float* yr = y + n * D;
    for (int i = lane; i < D; i += 32) y2 = fmaf(yr[i], yr[i], y2);
    y2 = warp_sum(y2);
    __syncwarp();

    // ---- posterior mean over all H units, F, the candidates ----------------
    const float scand_mine = multi_mean(qm, sm.tab, Hp, S, lane);
    row_posterior_mean(work, q, cand, scand_mine, d, t, lane);
    for (int h = lane; h < H; h += 32) s_mean[n * H + h] = work[h];
    for (int a = lane; a < Hp; a += 32) cand_out[n * Hp + a] = cand[a];
    if (lane == 0)
      F[n] = (mx + logf(Z)) + free_energy_const(y2, inv2s2, c.log_norm,
                                                c.log_p0, beta, pb, H);

    // ---- top-L over the canonical union ------------------------------------
    for (int l = 0; l < L; ++l) {
      float b;
      const int bi = row_argmax(q, U, lane, &b);
      __syncwarp();
      if (lane == 0) {
        top_q[n * L + l] = b;
        top_u[n * L + l] = bi;
        q[bi] = -1.f;
      }
      __syncwarp();
    }
    __syncwarp();      // work and q are free for the warp's next row
  }
}

}  // namespace let

extern "C" {

// Shared memory of a block of the decode kernel.
size_t linear_et_decode_smem_bytes(int H, int Hp, int S, int K) {
  return let::decode_smem_floats(H, Hp, S, K) * sizeof(float);
}

// The per-datapoint stage of the decode.  P (N, H) holds y W; the state
// tables come state-minor, as for linear_et_estep_rows.
int linear_et_decode_rows(const float* y, const float* P, const float* gram,
                          const float* states, const float* outer,
                          const float* vcounts, const float* absst,
                          const float* values, const float* log_odds,
                          const float* scal, float* F, float* s_mean,
                          float* top_q, int* top_u, int* cand, int N, int D,
                          int H, int Hp, int S, int K, int L,
                          int signed_select, int n_blocks, void* stream) {
  let::Tables t{gram, states, outer, vcounts, absst, values,
                log_odds, scal};
  let::Dims d{N, D, H, Hp, S, K, 1 + H * K + S, signed_select, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = let::decode_smem_floats(H, Hp, S, K) * sizeof(float);
  static launch_once::DeviceOnce once;
  cudaError_t e = launch_once::prepare_kernel(let::decode_kernel, once, true);
  if (e != cudaSuccess) return static_cast<int>(e);
  let::decode_kernel<<<n_blocks, let::RTHREADS, smem, s>>>(
      y, P, t, d, L, F, s_mean, top_q, top_u, cand);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
