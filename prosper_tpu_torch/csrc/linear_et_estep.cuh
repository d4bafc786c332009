// The linear E-step's rows kernel for sm_90a, a template on the units a
// lane holds (NU) and on K = 1; linear_et_estep.cu holds its note, the
// instantiation for NU = 10 and the C interface, linear_et_estep_nu*.cu
// the other instantiations, compiled apart so that the build compiles them
// in parallel.
#pragma once

#include "launch_once.cuh"
#include "linear_et_frontend.cuh"

namespace let {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NMISC = 5;            // abs, y2, n, F, F_true after vc (K)

struct RowsParams {
  const float* y;        // (N, D)
  const float* weight;   // (N,)
  float* P;              // (N, H): y W on entry, w <s> on exit
  const float* gram;     // (H, H)
  const int* table;      // rows_tables: the state masks, table_ints long
  const float* vcounts;  // (K, S) state-minor
  const float* absst;    // (S,)
  const float* values;   // (K,)
  const float* log_odds; // (K,)
  const float* scal;     // sigma2, beta, prior_beta
  float* F;              // (N,)
  float* ws;             // n_blocks * ws_stride(H, K)
  int N, D, H, Hp, S, K, table_ints, signed_select, collect_true, n_tiles;
};

// slot pairs a >= b in a packed lower triangle
__host__ __device__ inline int tri(int a, int b) { return a * (a + 1) / 2 + b; }

// words a state's value indices take (4 bits a slot; none where K = 1)
__host__ __device__ inline int value_words(int Hp, int K) {
  return K == 1 ? 0 : (Hp + 7) / 8;
}

struct RowsSmem {
  const unsigned* smask;  // S     each state's non-zero slots, bit a
  const unsigned* sval;   // S*KW  each slot's value index, 4 bits a slot
  const unsigned* rbits;  // R*SW  each moment row's states, R = Hp + NT
  const int* rstart;      // R + 1  each row's first piece
  const int* lstart;      // 33     each lane's first entry of lorder
  const int* prow;        // P      the pieces: words [pw0, pw1) of row prow
  const int* pw0;         // P
  const int* pw1;         // P
  const int* lorder;      // P      the pieces lane by lane
  float* vt;          // K + K^2: values, then their products
  float* lo;          // K
  float* wn;          // H      column norms, floored
  float* rwn;         // H      1 / wn
  float* gd;          // H      diag(gram)
  float* prior;       // S      value_counts @ log_odds
  float* vc;          // K*S    value counts, state-minor
  float* absr;        // S
  float* L;           // RWARPS*S  logits, then masses, then q
  float* X;           // RWARPS*(Hp + Hp^2)  candidate projections | Gram,
                      // then the moment pieces' sums
  float* scand;       // RWARPS*Hp  the multi states' mean of each slot
  float* mom2;        // 2*RWARPS*NT  pair moments (a >= b), by tile parity
  float* wr;          // 2*RWARPS     the rows' weights, by tile parity
  float* misc;        // RWARPS*(K + NMISC)  each warp's sums
  float* acc;         // RWARPS*2*H  each warp's sums of w <s>, w <s_h^2>
  unsigned* sel;      // RWARPS*3*32 the keys, units, P values selection
                      // gathers
  int* cand;          // 2*RWARPS*Hp  candidates, by tile parity
  signed char* slot;  // 2*RWARPS*H  per warp and tile parity: each unit's
                      // slot among the row's candidates, or -1
  unsigned char* pa;  // NT  the pairs (a, b) of the triangle, a >= b
  unsigned char* pb;  // NT
};

__host__ __device__ inline size_t rows_smem_words(int H, int Hp, int S, int K,
                                                  int table_ints) {
  const size_t NT = (size_t)Hp * (Hp + 1) / 2, NX = (size_t)Hp + Hp * Hp;
  const size_t per_warp = (size_t)S + NX + Hp + 2 * NT + 2 + K + NMISC
                          + 2 * (size_t)Hp + 2 * (size_t)H + 3 * 32;
  const size_t bytes = 2 * (size_t)RWARPS * H + 2 * NT;
  return (size_t)table_ints + K + (size_t)K * K + K + 3 * (size_t)H
         + (size_t)(K + 2) * S + RWARPS * per_warp + (bytes + 3) / 4;
}

__device__ inline RowsSmem carve_rows(float* p, const RowsParams& q) {
  const int H = q.H, Hp = q.Hp, S = q.S, K = q.K;
  const int NT = Hp * (Hp + 1) / 2, R = Hp + NT;
  RowsSmem s;
  const unsigned* u = reinterpret_cast<const unsigned*>(p);
  s.smask = u;         u += S;
  s.sval = u;          u += (size_t)S * value_words(Hp, K);
  s.rbits = u;         u += (size_t)R * ((S + 31) / 32);
  s.rstart = reinterpret_cast<const int*>(u);
  s.lstart = s.rstart + R + 1;
  // the pieces fill the rest of the table
  const int P = (q.table_ints - (int)(u - reinterpret_cast<const unsigned*>(p))
                 - (R + 1) - 33) / 4;
  s.prow = s.lstart + 33;
  s.pw0 = s.prow + P;
  s.pw1 = s.pw0 + P;
  s.lorder = s.pw1 + P;
  p += q.table_ints;
  s.vt = p;     p += K + K * K;
  s.lo = p;     p += K;
  s.wn = p;     p += H;
  s.rwn = p;    p += H;
  s.gd = p;     p += H;
  s.prior = p;  p += S;
  s.vc = p;     p += (size_t)K * S;
  s.absr = p;   p += S;
  s.L = p;      p += (size_t)RWARPS * S;
  s.X = p;      p += (size_t)RWARPS * (Hp + Hp * Hp);
  s.scand = p;  p += RWARPS * Hp;
  s.mom2 = p;   p += (size_t)2 * RWARPS * NT;
  s.wr = p;     p += 2 * RWARPS;
  s.misc = p;   p += RWARPS * (K + NMISC);
  s.acc = p;    p += (size_t)RWARPS * 2 * H;
  s.sel = reinterpret_cast<unsigned*>(p);
  p += RWARPS * 3 * 32;
  s.cand = reinterpret_cast<int*>(p);
  p += 2 * RWARPS * Hp;
  s.slot = reinterpret_cast<signed char*>(p);
  s.pa = reinterpret_cast<unsigned char*>(s.slot + 2 * RWARPS * H);
  s.pb = s.pa + NT;
  return s;
}

__host__ __device__ inline size_t ws_stride(int H, int K) {
  return (size_t)H * H + H + K + 5;
}

// A score as a key whose unsigned order is the floats' order (-0 taken as
// +0, so that the two tie as they compare).  Every key of a real score
// exceeds 0x7fffff; 0 marks a unit past H or one already taken.
__device__ inline unsigned order_key(float s) {
  const unsigned u = __float_as_uint(s + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// out[j] = sum over blocks b, in order, of ws[b][j], where the rows
// kernel's slices hold ss in their upper triangle alone: an entry above
// the diagonal is written to its mirror too (the rows kernel's ss is
// symmetric, bit for bit, by construction), one below it is not read.
static __global__ void reduce_blocks(const float* __restrict__ ws,
                                     float* __restrict__ out, size_t stride,
                                     int nb, int H) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= stride) return;
  size_t h = 0, k = 1;
  if (j < (size_t)H * H) {
    h = j / H;
    k = j - h * H;
    if (h > k) return;
  }
  float acc = 0.f;
  for (int b = 0; b < nb; ++b) acc += ws[(size_t)b * stride + j];
  out[j] = acc;
  if (h < k && j < (size_t)H * H) out[k * H + h] = acc;
}

// Asks the L2 for the line that holds p.
__device__ inline void prefetch_l2(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#endif
}

// Inside the k-th best of the 32 lanes' largest keys, for k <= 32, lies
// every one of the warp's k largest keys; lane l of the result of a
// descending bitonic sort over the lanes holds the (l+1)-th largest.
__device__ inline unsigned sorted_desc(unsigned v, int lane) {
  for (int k = 2; k <= 32; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned o = __shfl_xor_sync(FULL, v, j);
      v = ((lane & j) == 0) == ((lane & k) == 0) ? max(v, o) : min(v, o);
    }
  return v;
}

// a / b from r = 1 / b: the product and one correction (Markstein), which
// is the IEEE quotient wherever that is a normal number (as in the
// division's own fast path), without a division's slow-path call
__device__ inline float div_by(float a, float b, float r) {
  const float q = a * r;
  return fmaf(fmaf(-q, b, a), r, q);
}

// The top-Hp candidates of a row whose keys and P values a lane holds for
// units lane + 32 i, into cand[a], X[a] (the a-th candidate's P value) and
// slot[unit] = a.  Ties go to the lowest unit.  The keys at or above the
// Hp-th largest of the lanes' own largest keys (every key of the top Hp
// is) are gathered one a lane through the warp's 3 x 32 words of ``sel``,
// and each such lane counts the gathered keys that beat its own: its rank.
// Should more than 32 qualify, Hp rounds take the warp's largest of the
// lanes' own keys, a lane rescanning its keys when it wins.
template <int NU>
__device__ inline void select_top(unsigned (&key)[NU], const float (&pr)[NU],
                                  int Hp, int lane, signed char* slot,
                                  unsigned* sel, int* cand, float* X) {
  unsigned lmax = key[0];
#pragma unroll
  for (int i = 1; i < NU; ++i) lmax = max(lmax, key[i]);
  const unsigned T = __shfl_sync(FULL, sorted_desc(lmax, lane), Hp - 1);
  unsigned c = 0;
#pragma unroll
  for (int i = 0; i < NU; ++i) c += key[i] >= T ? 1u : 0u;
  unsigned incl = c;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  const unsigned total = __shfl_sync(FULL, incl, 31);
  if (total <= 32u) {
    unsigned at = incl - c;
#pragma unroll
    for (int i = 0; i < NU; ++i)
      if (key[i] >= T) {
        sel[at] = key[i];
        sel[32 + at] = (unsigned)(lane + 32 * i);
        sel[64 + at] = __float_as_uint(pr[i]);
        ++at;
      }
    __syncwarp();
    if ((unsigned)lane < total) {
      const unsigned ck = sel[lane], ch = sel[32 + lane];
      int rank = 0;
      for (unsigned j = 0; j < total; ++j) {
        const unsigned kj = sel[j], hj = sel[32 + j];
        rank += (kj > ck || (kj == ck && hj < ch)) ? 1 : 0;
      }
      if (rank < Hp) {
        cand[rank] = (int)ch;
        X[rank] = __uint_as_float(sel[64 + lane]);
        slot[ch] = (signed char)rank;
      }
    }
    __syncwarp();
    return;
  }
  unsigned bk = key[0];
  int bi = 0;
  float bp = pr[0];
#pragma unroll
  for (int i = 1; i < NU; ++i)
    if (key[i] > bk) { bk = key[i]; bi = i; bp = pr[i]; }
  for (int a = 0; a < Hp; ++a) {
    const unsigned mk = __reduce_max_sync(FULL, bk);
    const unsigned hw = __reduce_min_sync(
        FULL, bk == mk ? (unsigned)(lane + 32 * bi) : FULL);
    const int owner = (int)(hw & 31u);
    const float pv = __shfl_sync(FULL, bp, owner);
    if (lane == a) {
      cand[a] = (int)hw;
      X[a] = pv;
      slot[hw] = (signed char)a;
    }
    if (lane == owner) {
#pragma unroll
      for (int i = 0; i < NU; ++i)
        if (i == bi) key[i] = 0u;
      bk = key[0];
      bi = 0;
      bp = pr[0];
#pragma unroll
      for (int i = 1; i < NU; ++i)
        if (key[i] > bk) { bk = key[i]; bi = i; bp = pr[i]; }
    }
  }
  __syncwarp();
}

template <int NU, bool K1>
__global__ void __launch_bounds__(RTHREADS, NU <= 10 ? 4 : (NU <= 16 ? 2 : 1))
rows_kernel(RowsParams p) {
  extern __shared__ float smem_raw[];
  const RowsSmem sm = carve_rows(smem_raw, p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = p.D, H = p.H, K = K1 ? 1 : p.K, Hp = p.Hp, S = p.S;
  const int NT = Hp * (Hp + 1) / 2, MW = K + NMISC;
  const int KW = value_words(Hp, K), SW = (S + 31) / 32;
  const size_t stride = ws_stride(H, K);
  float* wss = p.ws + (size_t)blockIdx.x * stride;
  float* wsv = wss + (size_t)H * H;
  float* wmisc = wsv + H;

  // ---- per-block tables ---------------------------------------------------
  {
    int* t = reinterpret_cast<int*>(smem_raw);
    for (int i = tid; i < p.table_ints; i += RTHREADS) t[i] = p.table[i];
  }
  if (tid < K) {
    sm.vt[tid] = p.values[tid];
    sm.lo[tid] = p.log_odds[tid];
  }
  if (tid < K * K)
    sm.vt[K + tid] = p.values[tid / K] * p.values[tid % K];
  for (int h = tid; h < H; h += RTHREADS) {
    const float g = p.gram[(size_t)h * H + h];
    sm.gd[h] = g;
    sm.wn[h] = fmaxf(sqrtf(fmaxf(g, 1e-30f)), 1e-12f);
    sm.rwn[h] = 1.f / sm.wn[h];
  }
  for (int s = tid; s < S; s += RTHREADS) {
    float pr = 0.f;
    for (int k = 0; k < K; ++k) {
      const float c = p.vcounts[(size_t)k * S + s];
      sm.vc[(size_t)k * S + s] = c;
      pr = fmaf(c, p.log_odds[k], pr);
    }
    sm.prior[s] = pr;
    sm.absr[s] = p.absst[s];
  }
  for (int a = tid; a < Hp; a += RTHREADS)
    for (int b = 0; b <= a; ++b) {
      sm.pa[tri(a, b)] = (unsigned char)a;
      sm.pb[tri(a, b)] = (unsigned char)b;
    }
  for (int i = tid; i < 2 * RWARPS * H; i += RTHREADS) sm.slot[i] = -1;
  for (int i = tid; i < RWARPS * MW; i += RTHREADS) sm.misc[i] = 0.f;
  for (int i = tid; i < RWARPS * 2 * H; i += RTHREADS) sm.acc[i] = 0.f;
  // the slice's upper triangle of ss and its other sums (the lower
  // triangle is neither written nor read)
  for (int h = warp; h < H; h += RWARPS)
    for (int k = h + lane; k < H; k += 32) wss[(size_t)h * H + k] = 0.f;
  for (int i = tid; i < H + K + NMISC; i += RTHREADS) wsv[i] = 0.f;
  Dims dd{};
  dd.D = D;
  dd.K = K;
  Tables tt{};
  tt.log_odds = p.log_odds;
  tt.scal = p.scal;
  const Scalars c = load_scalars(dd, tt);
  const float inv2s2 = c.inv2s2, beta = c.beta, pb = c.pb;
  const bool ct = p.collect_true != 0;
  __syncthreads();

  float* L = sm.L + (size_t)warp * S;
  float* X = sm.X + (size_t)warp * (Hp + Hp * Hp);
  float* scand = sm.scand + warp * Hp;
  float* misc = sm.misc + warp * MW;
  float* accs = sm.acc + (size_t)warp * 2 * H;   // this warp's sums of w <s>
  float* accd = accs + H;                        // and of w <s_h^2>

  int it = 0;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++it) {
    const int row0 = tile * RWARPS;
    const int nrows = min(RWARPS, p.N - row0);
    const int buf = it & 1;
    int* cand = sm.cand + (buf * RWARPS + warp) * Hp;
    signed char* slot = sm.slot + (size_t)(buf * RWARPS + warp) * H;
    float* mom2 = sm.mom2 + (size_t)(buf * RWARPS + warp) * NT;

    if (warp < nrows) {
      const size_t n = (size_t)row0 + warp;
      const float w = p.weight[n];
      float* Prow = p.P + n * H;
      // this parity's slots of the warp's row two tiles back, which the
      // scatters of that tile, all done, were the last to read
      if (it >= 2 && lane < Hp) slot[cand[lane]] = -1;
      // the warp's next row, P's and y's, on its way to the L2
      const size_t nn = n + (size_t)gridDim.x * RWARPS;
      if (nn < (size_t)p.N) {
        if (32 * lane < H + 32) prefetch_l2(p.P + nn * H + 32 * lane);
        if (32 * lane < D + 32) prefetch_l2(p.y + nn * D + 32 * lane);
      }

      // ---- P's row in registers, the selection keys ----------------------
      float pr[NU];
      unsigned key[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        const int h = lane + 32 * i;
        pr[i] = 0.f;
        key[i] = 0u;
        if (h < H) {
          pr[i] = Prow[h];
          const float s = div_by(pr[i], sm.wn[h], sm.rwn[h]);
          key[i] = order_key(p.signed_select ? fabsf(s) : s);
        }
      }
      float y2 = 0.f;
      const float* yr = p.y + n * D;
      for (int i = lane; i < D; i += 32) y2 = fmaf(yr[i], yr[i], y2);

      // ---- selection ------------------------------------------------------
      __syncwarp();                          // the old slots are cleared
      select_top<NU>(key, pr, Hp, lane, slot, sm.sel + warp * 3 * 32, cand,
                     X);
      for (int i = lane; i < Hp * Hp; i += 32)
        X[Hp + i] = p.gram[(size_t)cand[i / Hp] * H + cand[i % Hp]];
      __syncwarp();

      // ---- multi-state logits over each state's slots and slot pairs, and
      // the maxima: the Gram matrix is symmetric, so a state's pairs a < b
      // count twice and each is read once -------------------------------
      float mx = 0.f, mxt = 0.f;             // the zero state's logit is 0
      for (int s = lane; s < S; s += 32) {
        float d1 = 0.f, dd = 0.f, du = 0.f;
        const unsigned msk = sm.smask[s];
        const unsigned* sv = sm.sval + (size_t)s * KW;
        for (unsigned m1 = msk; m1 != 0u; m1 &= m1 - 1u) {
          const int a = __ffs(m1) - 1;
          const int ka = K1 ? 0 : (int)((sv[a >> 3] >> (4 * (a & 7))) & 15u);
          const float* Xa = X + Hp + a * Hp;
          const float* va = sm.vt + K + ka * K;
          d1 = fmaf(X[a], sm.vt[ka], d1);
          dd = fmaf(Xa[a], va[ka], dd);
          // the pairs (a, b > a), two a step, both loads issued before the
          // adds
          for (unsigned m2 = m1 & (m1 - 1u); m2 != 0u;) {
            const int b1 = __ffs(m2) - 1;
            m2 &= m2 - 1u;
            const bool two = m2 != 0u;
            const int b2 = two ? __ffs(m2) - 1 : b1;
            const float x1 = Xa[b1], x2 = Xa[b2];
            const int k1 = K1 ? 0 : (int)((sv[b1 >> 3] >> (4 * (b1 & 7))) & 15u);
            du = fmaf(x1, va[k1], du);
            if (two) {
              const int k2 = K1 ? 0
                                : (int)((sv[b2 >> 3] >> (4 * (b2 & 7))) & 15u);
              du = fmaf(x2, va[k2], du);
              m2 &= m2 - 1u;
            }
          }
        }
        const float lik = (2.f * d1 - (dd + 2.f * du)) * inv2s2;
        L[s] = lik;
        mx = fmaxf(mx, beta * lik + pb * sm.prior[s]);
        mxt = fmaxf(mxt, lik + sm.prior[s]);
      }
      // ---- the singletons' maxima -----------------------------------------
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        const int h = lane + 32 * i;
        if (h < H) {
          const float g = sm.gd[h];
          for (int k = 0; k < K; ++k) {
            const float lik = lik_single(pr[i], g, sm.vt[k], inv2s2);
            mx = fmaxf(mx, beta * lik + pb * sm.lo[k]);
            mxt = fmaxf(mxt, lik + sm.lo[k]);
          }
        }
      }
      mx = warp_max(mx);
      mxt = warp_max(mxt);

      // ---- the masses: one expf a term and channel -----------------------
      float Z = 0.f, Zt = 0.f;
      float e1v[K1 ? NU : 1];                // K = 1: the annealed masses
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        const int h = lane + 32 * i;
        if (K1) e1v[K1 ? i : 0] = 0.f;
        if (h < H) {
          const float g = sm.gd[h];
          for (int k = 0; k < K; ++k) {
            const float lik = lik_single(pr[i], g, sm.vt[k], inv2s2);
            const float e = expf((beta * lik + pb * sm.lo[k]) - mx);
            if (K1) e1v[K1 ? i : 0] = e;
            Z += e;
            if (ct) Zt += expf((lik + sm.lo[k]) - mxt);
          }
        }
      }
      for (int s = lane; s < S; s += 32) {
        const float lik = L[s];
        const float e = expf((beta * lik + pb * sm.prior[s]) - mx);
        L[s] = e;
        Z += e;
        if (ct) Zt += expf((lik + sm.prior[s]) - mxt);
      }
      Z = warp_sum(Z) + expf(-mx);
      Zt = warp_sum(Zt) + expf(-mxt);
      const float rZ = 1.f / Z;

      // ---- q of the multi states in place, their abs (and, K = 1, value
      // counts) --------------------------------------------------------------
      float ab = 0.f, v0 = 0.f;
      for (int s = lane; s < S; s += 32) {
        const float q = div_by(L[s], Z, rZ);
        L[s] = q;
        ab = fmaf(q, sm.absr[s], ab);
        if (K1) v0 = fmaf(q, sm.vc[s], v0);
      }
      __syncwarp();
      // ---- the moments of each slot and slot pair, gathered in state order
      // by pieces of the rows; X, the logits' operands, holds their sums --
      for (int t = sm.lstart[lane]; t < sm.lstart[lane + 1]; ++t) {
        const int id = sm.lorder[t], r = sm.prow[id];
        const int a = r < Hp ? r : sm.pa[r - Hp], b = r < Hp ? -1
                                                             : sm.pb[r - Hp];
        // the value (product) of the row's slot (pair) in state s; K = 1
        // sums the states' q alone
        auto value = [&](int s) {
          const unsigned* sv = sm.sval + (size_t)s * KW;
          const int ka = (int)((sv[a >> 3] >> (4 * (a & 7))) & 15u);
          return sm.vt[b < 0 ? ka
                             : K + ka * K
                                   + (int)((sv[b >> 3] >> (4 * (b & 7)))
                                           & 15u)];
        };
        const unsigned* rb = sm.rbits + (size_t)r * SW;
        float acc = 0.f;
        for (int wd = sm.pw0[id]; wd < sm.pw1[id]; ++wd) {
          // two states a step, both loads issued before the adds
          for (unsigned bits = rb[wd]; bits != 0u;) {
            const int s1 = 32 * wd + __ffs(bits) - 1;
            bits &= bits - 1u;
            const bool two = bits != 0u;
            const int s2 = two ? 32 * wd + __ffs(bits) - 1 : s1;
            const float l1 = L[s1], l2 = L[s2];
            acc = K1 ? acc + l1 : fmaf(l1, value(s1), acc);
            if (two) {
              acc = K1 ? acc + l2 : fmaf(l2, value(s2), acc);
              bits &= bits - 1u;
            }
          }
        }
        X[id] = acc;
      }
      __syncwarp();
      for (int r = lane; r < Hp + NT; r += 32) {
        const int i0 = sm.rstart[r], i1 = sm.rstart[r + 1];
        if (i0 == i1) continue;              // K = 1: a slot's own pair
        float acc = X[i0];
        for (int id = i0 + 1; id < i1; ++id) acc += X[id];
        if (K1) {                            // the slot's, its own pair's
          if (r < Hp) {
            scand[r] = acc * sm.vt[0];
            mom2[tri(r, r)] = acc * sm.vt[1];
          } else {
            mom2[r - Hp] = acc * sm.vt[1];
          }
        } else if (r < Hp) {
          scand[r] = acc;
        } else {
          mom2[r - Hp] = acc;
        }
      }

      // ---- singletons: posterior mean, <s_h^2>, value counts -------------
      if constexpr (K1) {
        const float v = sm.vt[0], vv = v * v;
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          const int h = lane + 32 * i;
          if (h < H) {
            const float q = div_by(e1v[i], Z, rZ);
            pr[i] = q * v;
            if (w != 0.f) accd[h] += (q * vv) * w;
            v0 += q;
            ab += q;
          }
        }
        v0 = warp_sum(v0);
        if (lane == 0) misc[0] += v0 * w;
      } else {
        float m[NU], t2[NU];
#pragma unroll 1
        for (int k = 0; k < K; ++k) {
          const float v = sm.vt[k], vv = v * v, lok = sm.lo[k];
          float vk = 0.f;
          for (int s = lane; s < S; s += 32)
            vk = fmaf(L[s], sm.vc[(size_t)k * S + s], vk);
#pragma unroll
          for (int i = 0; i < NU; ++i) {
            const int h = lane + 32 * i;
            if (h < H) {
              const float lik = lik_single(pr[i], sm.gd[h], v, inv2s2);
              const float q = div_by(expf((beta * lik + pb * lok) - mx), Z, rZ);
              m[i] = k == 0 ? q * v : fmaf(q, v, m[i]);
              t2[i] = k == 0 ? q * vv : fmaf(q, vv, t2[i]);
              vk += q;
              ab += q;
            }
          }
          vk = warp_sum(vk);
          if (lane == 0) misc[k] += vk * w;
        }
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          const int h = lane + 32 * i;
          if (h < H) {
            pr[i] = m[i];
            if (w != 0.f) accd[h] += t2[i] * w;
          }
        }
      }
      __syncwarp();                          // scand and mom2 are written
      // the multi states' mean goes to the candidates (distinct units), then
      // w <s> to P and to this warp's sums
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        const int h = lane + 32 * i;
        if (h < H) {
          const int sl = slot[h];
          if (sl >= 0) pr[i] += scand[sl];
          pr[i] *= w;
          Prow[h] = pr[i];
          accs[h] += pr[i];
        }
      }

      y2 = warp_sum(y2);
      ab = warp_sum(ab);
      if (lane == 0) {
        const float Fr = (mx + logf(Z))
            + free_energy_const(y2, inv2s2, c.log_norm, c.log_p0, beta, pb,
                                H);
        const float Ftr = ct
            ? (mxt + logf(Zt))
                  + free_energy_const(y2, inv2s2, c.log_norm, c.log_p0, 1.f,
                                      1.f, H)
            : Fr;
        p.F[n] = Fr;
        misc[K] += ab * w;
        misc[K + 1] += y2 * w;
        misc[K + 2] += w;
        misc[K + 3] += Fr * w;
        misc[K + 4] += Ftr * w;
        sm.wr[buf * RWARPS + warp] = w;
      }
    } else if (lane == 0) {
      sm.wr[buf * RWARPS + warp] = 0.f;      // no row: it holds no entry
    }
    __syncthreads();

    // ---- the multi states' ss entries, in the upper triangle: each address
    // summed in row order by the tile's first row that holds it ------------
    const float* wrb = sm.wr + buf * RWARPS;
    if (warp < nrows && wrb[warp] != 0.f) {
      const int* cb = sm.cand + buf * RWARPS * Hp;
      const float* m2 = sm.mom2 + (size_t)buf * RWARPS * NT;
      const signed char* sb = sm.slot + (size_t)buf * RWARPS * H;
      const int* mine = cb + warp * Hp;
      // per row of the tile, the slots of this row whose units it holds too
      const int u = lane < Hp ? mine[lane] : 0;
      unsigned held[RWARPS];
#pragma unroll
      for (int r2 = 0; r2 < RWARPS; ++r2)
        held[r2] = __ballot_sync(
            FULL, lane < Hp && r2 != warp && r2 < nrows && wrb[r2] != 0.f
                      && sb[(size_t)r2 * H + u] >= 0);
      for (int t = lane; t < NT; t += 32) {
        const int a = sm.pa[t], b = sm.pb[t];
        const unsigned both = (1u << a) | (1u << b);
        bool first = true;
#pragma unroll
        for (int r2 = 0; r2 < RWARPS; ++r2)
          if (r2 < warp && (held[r2] & both) == both) first = false;
        if (!first) continue;
        const int u1 = mine[a], u2 = mine[b];
        float* dst = wss + (size_t)min(u1, u2) * H + max(u1, u2);
        float acc = *dst;
        acc += m2[warp * NT + t] * wrb[warp];
#pragma unroll
        for (int r2 = 0; r2 < RWARPS; ++r2)
          if (r2 > warp && (held[r2] & both) == both) {
            const int qa = sb[(size_t)r2 * H + u1], qb = sb[(size_t)r2 * H + u2];
            acc += m2[r2 * NT + (qa >= qb ? tri(qa, qb) : tri(qb, qa))]
                   * wrb[r2];
          }
        *dst = acc;
      }
    }
  }

  // ---- the warps' sums into the block's slice, in warp order --------------
  __syncthreads();
  for (int w8 = 0; w8 < RWARPS; ++w8) {
    if (warp == w8) {
      for (int h = lane; h < H; h += 32) {
        wsv[h] += accs[h];
        wss[(size_t)h * H + h] += accd[h];
      }
      if (lane < MW) wmisc[lane] += misc[lane];
    }
    __syncthreads();
  }
}

// The kernel at NU, K1: its launch, or (blocks given) the blocks an SM
// holds at once.
template <int NU, bool K1>
cudaError_t run_nu(const RowsParams& p, int n_blocks, size_t smem,
                   int* blocks, cudaStream_t stream) {
  static launch_once::DeviceOnce once;
  cudaError_t e = launch_once::prepare_kernel(rows_kernel<NU, K1>, once,
                                              true);
  if (e != cudaSuccess) return e;
  if (blocks != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, rows_kernel<NU, K1>, RTHREADS, smem);
  rows_kernel<NU, K1><<<n_blocks, RTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace let
