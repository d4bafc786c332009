// Max-superposition (MCA / MMCA) ET E-step, hard winner, for sm_90a: the
// per-datapoint part and the multi-state routing.
//
// With sgemm.cu it replaces both TPU kernels of
// prosper_tpu/ops/max_pallas.py: max_et_estep_pallas (the (S, D, Ct) winner
// lattice resident in VMEM) and max_et_estep_pallas_dtiled (the same
// lattice in D blocks, two phases).  Together they compute what
// core/maxstep.py::max_et_estep computes for rho <= 0: per datapoint the
// top-H' candidates by P / ||W_h|| (|P| for MMCA), the winner lattice
// ybar_s[d] over the S multi states by the subset-lattice DP, the union
// softmax over [zero | H singletons | S multi states], F (and the
// un-annealed F_true), and the weight-masked sums numer (H, D) and
// denom (H, D) of the hard-winner responsibilities, s (H) and
// misc = [abs, resid, y2, n, F, F_true].  The wrapper
// (ops/max_cuda.py::max_et_estep_cuda) runs three stages:
//
//   1. sgemm_nn          P = y W                         (N, H), sgemm.cu
//   2. max_estep_kernel  here: everything per datapoint; turns the row of
//      P into w q_single in place, and sums the multi states' part of
//      numer and denom, the singleton part of denom, s and misc
//   3. sgemm_tn_splitn   numer += (w q_single)^T y       (H, D), sgemm.cu
//
// What bounds this kernel on the H100: operations, in the lattice.  Per
// datapoint it reads a row of P and of y (H + D floats) and walks the
// lattice twice (2 passes of S x D compare-selects, plus S x D FMAs for
// y.ybar_s and ||ybar_s||^2 in the first pass): about 10 Gop for 131072
// rows at the patches width, against 0.3 GB of reads.  Each pass is a
// chain of dependent shared-memory lookups per dimension, so it runs well
// below that rate.
//
// What the design does about it:
// * The two D x H products are not here: they run as register-tiled GEMMs
//   over all N rows (sgemm.cu), so the block holds no slice of W and no
//   tile of P, and two blocks fit an SM where one did.
// * The lattice never exists whole.  A state's winner is its parent's
//   winner or its added slot, so only the winning slot is kept per state
//   (one byte), and its value is looked up among the H' candidate values of
//   the dimension.  Phase 0 gives one warp one datapoint and walks D in
//   32-wide strips, one d per lane: it builds the strip's winners and the
//   lanes then reduce y.ybar_s and ||ybar_s||^2 over the strip, one state
//   per lane (row stride 33, so the transposed reads hit distinct banks).
//   After the union softmax, phase 1 gives each thread of the block its
//   own dimensions d, rebuilds the winners there for every datapoint of
//   the tile, and routes w q_s to the winning slot.  Since each (h, d) of
//   the block's numer / denom slice is touched only by the thread that
//   owns d, the datapoints of a tile need no barrier between them.  This
//   is the D-tiled two-phase scheme of the dtiled TPU kernel; the resident
//   case is the same code, with fewer strips.
// * Blocks run in parallel and in no order, so a fixed number of
//   persistent blocks each walk their tiles in order into their own
//   workspace slice, and reduce_blocks sums the slices in block order.
//   No float atomics: the sums are deterministic, and with collect_true off
//   at beta = 1 they are bit-identical to those with it on.
// * The singleton part of denom, sum_n w_n q_nh, does not depend on d: it
//   is summed per block as an H-vector and added to the slice once.
//
// Numerics: as linear_et_frontend.cuh (no fast math, -fmad=false, fmaf
// only in sums of products).  Ties in the winner go to the earlier slot:
// the added slot (the largest of the support) wins only when its key is
// strictly greater, as in core/maxstep.py and the TPU kernels.

#include "linear_et_frontend.cuh"

namespace mxe {

using let::Dims;
using let::Smem;
using let::Tables;
using let::THREADS;
using let::TILE;
using let::WARPS;

constexpr int HPM = 8;     // largest H'
constexpr int SPL = 4;     // multi states per lane: S <= 32 * SPL
constexpr int LS = 33;     // row stride of a warp's strip lattice
constexpr int NMISC = 6;   // abs, resid, y2, n, F, F_true

struct MaxSmem {
  Smem base;            // ys, work, wn, cand of the shared front end
  float* q;             // TILE*U   posterior [zero | H singles | S multi]
  float* gd;            // H        ||W_h||^2
  float* accs;          // H        block sums of w <s>
  float* accd;          // H        block sums of w q_single (singleton denom)
  float* rowF;          // TILE
  float* rowFt;         // TILE
  float* rowAbs;        // TILE
  float* rowRes;        // TILE
  float* rowY2;         // TILE
  float* rowW;          // TILE
  float* misc;          // NMISC
  float* wc0;           // WARPS*Hp*LS   phase 0: candidate values per strip
  float* wc1;           // Hp*THREADS    phase 1: candidate values per thread
  int* par;             // S   parent: slot (< Hp) or Hp + parent state
  int* add;             // S   added slot
  unsigned char* best0; // WARPS*S*LS    phase 0: winning slot per state
  unsigned char* best1; // S*THREADS     phase 1: winning slot per state
};

__host__ __device__ inline size_t smem_bytes(int D, int H, int Hp, int S) {
  const size_t U = 1 + (size_t)H + S;
  const size_t floats = (size_t)TILE * D + (size_t)TILE * H + H
                        + TILE * U + 3 * (size_t)H
                        + 6 * TILE + NMISC + (size_t)WARPS * Hp * LS
                        + (size_t)Hp * THREADS;
  const size_t ints = (size_t)TILE * Hp + 2 * (size_t)S;
  const size_t bytes = (size_t)WARPS * S * LS + (size_t)S * THREADS;
  return 4 * (floats + ints) + bytes;
}

__device__ inline MaxSmem carve_max(float* p, const Dims& d) {
  MaxSmem s{};
  const size_t U = d.U;
  s.base.ys = p;     p += (size_t)TILE * d.D;
  s.base.work = p;   p += (size_t)TILE * d.H;
  s.base.wn = p;     p += d.H;
  s.q = p;           p += TILE * U;
  s.gd = p;          p += d.H;
  s.accs = p;        p += d.H;
  s.accd = p;        p += d.H;
  s.rowF = p;        p += TILE;
  s.rowFt = p;       p += TILE;
  s.rowAbs = p;      p += TILE;
  s.rowRes = p;      p += TILE;
  s.rowY2 = p;       p += TILE;
  s.rowW = p;        p += TILE;
  s.misc = p;        p += NMISC;
  s.wc0 = p;         p += (size_t)WARPS * d.Hp * LS;
  s.wc1 = p;         p += (size_t)d.Hp * THREADS;
  int* ip = reinterpret_cast<int*>(p);
  s.base.cand = ip;  ip += TILE * d.Hp;
  s.par = ip;        ip += d.S;
  s.add = ip;        ip += d.S;
  unsigned char* bp = reinterpret_cast<unsigned char*>(ip);
  s.best0 = bp;      bp += (size_t)WARPS * d.S * LS;
  s.best1 = bp;
  return s;
}

// The subset-lattice DP for one dimension (one column of wc / best, of
// row stride `stride`): wc[a] holds candidate slot a's value W[d, cand_a];
// best[s] becomes the winning slot of multi state s.  States come in
// size order, each its parent plus one added slot.
__device__ inline void dp_column(const float* wc, unsigned char* best,
                                 int stride, int col, int S, int Hp,
                                 const int* par, const int* add,
                                 int magnitude) {
  for (int s = 0; s < S; ++s) {
    const int p = par[s], a = add[s];
    const int bp = p < Hp ? p : best[(size_t)(p - Hp) * stride + col];
    const float vp = wc[(size_t)bp * stride + col];
    const float va = wc[(size_t)a * stride + col];
    const float kp = magnitude ? fabsf(vp) : vp;
    const float ka = magnitude ? fabsf(va) : va;
    best[(size_t)s * stride + col] = (unsigned char)(ka > kp ? a : bp);
  }
}

__host__ __device__ inline size_t ws_stride(int D, int H) {
  return 2 * (size_t)D * H + H + NMISC;
}

__global__ void __launch_bounds__(THREADS, 2)
max_estep_kernel(const float* __restrict__ y,
                 const float* __restrict__ weight,
                 float* P,            // (N, H): y W on entry, w q_single
                                      // on exit
                 const float* __restrict__ WT,     // (H, D)
                 const float* __restrict__ gdiag,  // (H,)
                 const int* __restrict__ plan,     // par (S,) | add (S,)
                 Tables t, Dims d, int magnitude, float* __restrict__ F,
                 float* __restrict__ ws, int n_tiles) {
  extern __shared__ float4 smem4[];
  const MaxSmem sm = carve_max(reinterpret_cast<float*>(smem4), d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = d.D, H = d.H, Hp = d.Hp, S = d.S, U = d.U;
  const size_t HD = (size_t)H * D;
  const size_t stride = ws_stride(D, H);
  float* wnum = ws + (size_t)blockIdx.x * stride;
  float* wden = wnum + HD;
  float* wsv = wden + HD;
  float* wmisc = wsv + H;

  for (int h = tid; h < H; h += THREADS) {
    const float g = gdiag[h];
    sm.gd[h] = g;
    sm.base.wn[h] = fmaxf(sqrtf(fmaxf(g, 1e-30f)), 1e-12f);
    sm.accs[h] = 0.f;
    sm.accd[h] = 0.f;
  }
  for (int s = tid; s < S; s += THREADS) {
    sm.par[s] = plan[s];
    sm.add[s] = plan[S + s];
  }
  if (tid < NMISC) sm.misc[tid] = 0.f;
  for (size_t i = tid; i < stride; i += THREADS) wnum[i] = 0.f;
  const let::Scalars c = let::load_scalars(d, t);
  const float lo = t.log_odds[0];
  __syncthreads();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE;
    const int nrows = min(TILE, d.N - row0);
    for (int i = tid; i < TILE * D; i += THREADS) {
      const int r = i / D;
      sm.base.ys[i] =
          r < nrows ? y[(size_t)(row0 + r) * D + (i - r * D)] : 0.f;
    }
    Smem sel = sm.base;               // candidates from P's rows in device
    sel.Ps = P + (size_t)row0 * H;    // memory
    __syncthreads();

    // ---- one warp per datapoint: selection, phase 0, softmax, row stats
    for (int r = warp; r < nrows; r += WARPS) {
      const float w = weight[row0 + r];
      let::select_candidates(r, lane, d, sel);
      const int* cand = sm.base.cand + r * Hp;
      const float* yr = sm.base.ys + (size_t)r * D;
      float* Prow = P + ((size_t)row0 + r) * H;

      // phase 0: y.ybar_s and ||ybar_s||^2, lane k*32+lane owns state s
      float yd[SPL], yb2[SPL];
#pragma unroll
      for (int k = 0; k < SPL; ++k) { yd[k] = 0.f; yb2[k] = 0.f; }
      float* wc = sm.wc0 + (size_t)warp * Hp * LS;
      unsigned char* bst = sm.best0 + (size_t)warp * S * LS;
      for (int d0 = 0; d0 < D; d0 += 32) {
        const int dd = d0 + lane;
        for (int a = 0; a < Hp; ++a)
          wc[a * LS + lane] = dd < D ? WT[(size_t)cand[a] * D + dd] : 0.f;
        dp_column(wc, bst, LS, lane, S, Hp, sm.par, sm.add, magnitude);
        __syncwarp();
        const int nd = min(32, D - d0);
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          const int s = lane + 32 * k;
          if (s < S) {
            for (int j = 0; j < nd; ++j) {
              const float v = wc[bst[s * LS + j] * LS + j];
              yd[k] = fmaf(yr[d0 + j], v, yd[k]);
              yb2[k] = fmaf(v, v, yb2[k]);
            }
          }
        }
        __syncwarp();
      }

      // union logits [0 | singles | multi] and their maxima
      float* q = sm.q + (size_t)r * U;
      float mx = 0.f, mxt = 0.f;             // the zero state's logit is 0
      for (int h = lane; h < H; h += 32) {
        const float lik = (2.f * Prow[h] - sm.gd[h]) * c.inv2s2;
        q[1 + h] = lik;
        mx = fmaxf(mx, c.beta * lik + c.pb * lo);
        mxt = fmaxf(mxt, lik + lo);
      }
      float lm[SPL];
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const int s = lane + 32 * k;
        lm[k] = (2.f * yd[k] - yb2[k]) * c.inv2s2;
        if (s < S) {
          const float prior = t.absst[s] * lo;
          mx = fmaxf(mx, c.beta * lm[k] + c.pb * prior);
          mxt = fmaxf(mxt, lm[k] + prior);
        }
      }
      mx = let::warp_max(mx);
      mxt = let::warp_max(mxt);
      float Z = 0.f, Zt = 0.f;
      for (int h = lane; h < H; h += 32) {
        const float lik = q[1 + h];
        Z += expf((c.beta * lik + c.pb * lo) - mx);
        if (d.collect_true) Zt += expf((lik + lo) - mxt);
      }
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const int s = lane + 32 * k;
        if (s < S) {
          const float prior = t.absst[s] * lo;
          Z += expf((c.beta * lm[k] + c.pb * prior) - mx);
          if (d.collect_true) Zt += expf((lm[k] + prior) - mxt);
        }
      }
      Z = let::warp_sum(Z) + expf(-mx);
      Zt = let::warp_sum(Zt) + expf(-mxt);

      // q = exp(logit - m) / Z in place
      __syncwarp();
      for (int h = lane; h < H; h += 32)
        q[1 + h] = expf((c.beta * q[1 + h] + c.pb * lo) - mx) / Z;
      float* qm = q + 1 + H;
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const int s = lane + 32 * k;
        if (s < S)
          qm[s] = expf((c.beta * lm[k] + c.pb * (t.absst[s] * lo)) - mx) / Z;
      }
      if (lane == 0) q[0] = expf(-mx) / Z;

      float y2 = 0.f;
      for (int i = lane; i < D; i += 32) y2 = fmaf(yr[i], yr[i], y2);
      y2 = let::warp_sum(y2);
      __syncwarp();

      // activity, residual <||y - ybar||^2>
      float qs = 0.f, res = 0.f;
      for (int h = lane; h < H; h += 32) {
        qs += q[1 + h];
        res = fmaf(q[1 + h], (y2 - 2.f * Prow[h]) + sm.gd[h], res);
        Prow[h] = q[1 + h] * w;          // P's row becomes w q_single
      }
      float am = 0.f;
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const int s = lane + 32 * k;
        if (s < S) {
          am = fmaf(qm[s], t.absst[s], am);
          res = fmaf(qm[s], (y2 - 2.f * yd[k]) + yb2[k], res);
        }
      }
      qs = let::warp_sum(qs);
      am = let::warp_sum(am);
      res = let::warp_sum(res) + q[0] * y2;

      // w <s> over all H units into the work row
      const float scand_mine = let::row_scand(qm, d, t, lane);
      float* sw = sm.base.work + (size_t)r * H;
      let::row_posterior_mean(sw, q, cand, scand_mine, d, t, lane);
      for (int h = lane; h < H; h += 32) sw[h] *= w;

      if (lane == 0) {
        const float Fr = (mx + logf(Z))
            + let::free_energy_const(y2, c.inv2s2, c.log_norm, c.log_p0,
                                     c.beta, c.pb, H);
        const float Ftr = d.collect_true
            ? (mxt + logf(Zt))
                  + let::free_energy_const(y2, c.inv2s2, c.log_norm,
                                           c.log_p0, 1.f, 1.f, H)
            : Fr;
        F[row0 + r] = Fr;
        sm.rowF[r] = Fr;
        sm.rowFt[r] = Ftr;
        sm.rowAbs[r] = qs + am;
        sm.rowRes[r] = res;
        sm.rowY2[r] = y2;
        sm.rowW[r] = w;
      }
    }
    __syncthreads();

    // ---- s and the singleton denom, summed over the rows in order
    for (int h = tid; h < H; h += THREADS) {
      float a = sm.accs[h], b = sm.accd[h];
      for (int r = 0; r < nrows; ++r) {
        a += sm.base.work[(size_t)r * H + h];
        b += sm.q[(size_t)r * U + 1 + h] * sm.rowW[r];
      }
      sm.accs[h] = a;
      sm.accd[h] = b;
    }
    if (tid == 0) {
      for (int r = 0; r < nrows; ++r) {
        const float w = sm.rowW[r];
        sm.misc[0] += sm.rowAbs[r] * w;
        sm.misc[1] += sm.rowRes[r] * w;
        sm.misc[2] += sm.rowY2[r] * w;
        sm.misc[3] += w;
        sm.misc[4] += sm.rowF[r] * w;
        sm.misc[5] += sm.rowFt[r] * w;
      }
    }

    // ---- phase 1: each thread owns its dimensions dd (the singleton part
    // of numer, (w q_single)^T y, is a GEMM over P's rows after the kernel)
    for (int dd = tid; dd < D; dd += THREADS) {
      float ycol[TILE];
#pragma unroll
      for (int r = 0; r < TILE; ++r)
        ycol[r] = r < nrows ? sm.base.ys[(size_t)r * D + dd] : 0.f;
      // multi states: rebuild the winners, route w q_s to the winning slot
      for (int r = 0; r < nrows; ++r) {
        const float w = sm.rowW[r];
        if (w == 0.f) continue;
        const int* cand = sm.base.cand + r * Hp;
        for (int a = 0; a < Hp; ++a)
          sm.wc1[a * THREADS + tid] = WT[(size_t)cand[a] * D + dd];
        dp_column(sm.wc1, sm.best1, THREADS, tid, S, Hp, sm.par, sm.add,
                  magnitude);
        float A[HPM];
#pragma unroll
        for (int a = 0; a < HPM; ++a) A[a] = 0.f;
        const float* qm = sm.q + (size_t)r * U + 1 + H;
        for (int s = 0; s < S; ++s) {
          const float qa = qm[s] * w;
          const int b = sm.best1[(size_t)s * THREADS + tid];
#pragma unroll
          for (int a = 0; a < HPM; ++a)
            if (a == b) A[a] += qa;
        }
#pragma unroll
        for (int a = 0; a < HPM; ++a) {
          if (a < Hp) {
            const size_t i = (size_t)cand[a] * D + dd;
            wnum[i] = fmaf(A[a], ycol[r], wnum[i]);
            wden[i] += A[a];
          }
        }
      }
    }
    __syncthreads();
  }

  for (int h = tid; h < H; h += THREADS) wsv[h] = sm.accs[h];
  for (size_t i = tid; i < HD; i += THREADS) wden[i] += sm.accd[i / D];
  if (tid < NMISC) wmisc[tid] = sm.misc[tid];
}

cudaError_t launch(const float* y, const float* weight, float* P,
                   const float* WT,
                   const float* gdiag, const int* plan, Tables t, Dims d,
                   int magnitude, float* F, float* ws, float* sums, int nb,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(d.D, d.H, d.Hp, d.S);
  cudaError_t e = cudaFuncSetAttribute(
      max_estep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(max_estep_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const int n_tiles = (d.N + TILE - 1) / TILE;
  max_estep_kernel<<<nb, THREADS, smem, stream>>>(
      y, weight, P, WT, gdiag, plan, t, d, magnitude, F, ws, n_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t stride = ws_stride(d.D, d.H);
  let::reduce_blocks<<<(unsigned)((stride + 255) / 256), 256, 0, stream>>>(
      ws, sums, nb, stride, 0);
  return cudaGetLastError();
}

}  // namespace mxe

extern "C" {

// Workspace floats per persistent block; the caller allocates
// n_blocks * this for ws and this for sums.
size_t max_et_estep_ws_stride(int D, int H) { return mxe::ws_stride(D, H); }

size_t max_et_smem_bytes(int D, int H, int Hp, int S) {
  return mxe::smem_bytes(D, H, Hp, S);
}

// P (N, H) holds y W and leaves as w q_single.  sums = [numer (H*D) |
// denom (H*D) | s (H) | abs | resid | y2 | n | F | F_true]; numer lacks
// its singleton part (w q_single)^T y, which the caller adds.  WT is W
// transposed (H, D); states is (Hp, S) state-minor; plan holds the DP's
// parents and added slots (2*S int32); log_odds has one entry and values
// is [1.0].
int max_et_estep(const float* y, const float* weight, float* P,
                 const float* WT, const float* gdiag, const float* states,
                 const float* absst, const int* plan, const float* values,
                 const float* log_odds, const float* scal, float* F,
                 float* ws, float* sums, int N, int D, int H, int Hp, int S,
                 int magnitude, int collect_true, int n_blocks,
                 void* stream) {
  let::Tables t{nullptr, nullptr, states, nullptr, nullptr, absst, values,
                log_odds, scal};
  let::Dims d{N, D, H, Hp, S, 1, 1 + H + S, magnitude, collect_true};
  return static_cast<int>(mxe::launch(
      y, weight, P, WT, gdiag, plan, t, d, magnitude, F, ws, sums, n_blocks,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
