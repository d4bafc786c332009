// The max-superposition (MCA / MMCA) E-step kernels for sm_90a: their
// templates and launchers.  max_et_estep.cu holds the note on what they
// compute, what bounds them on the H100 and how they are designed, and the
// C interface; it and max_et_estep_hp*.cu each compile the instantiations
// for some H', so that the build compiles them in parallel.

#pragma once

#include <utility>

#include "launch_once.cuh"
#include "linear_et_frontend.cuh"

namespace mxe {

using let::Dims;
using let::Smem;
using let::Tables;
using let::THREADS;
using let::TILE;
using let::WARPS;

constexpr int HPM = 8;        // largest H'
constexpr int SMAX = 128;     // most multi states
constexpr int NMISC = 6;      // abs, resid, y2, n, F, F_true
constexpr int PASS_CAP = 40;  // most states a pass of phase 0 sums
constexpr int DR = 32;        // columns a block of the routing kernel, a lane each

// ---- the state lattice over hp slots, at compile time ----------------------

__host__ __device__ constexpr int binom(int n, int k) {
  if (k < 0 || k > n) return 0;
  int r = 1;
  for (int i = 1; i <= k; ++i) r = r * (n - k + i) / i;
  return r;
}

__host__ __device__ constexpr int popc(unsigned m) {
  int c = 0;
  for (; m != 0u; m &= m - 1u) ++c;
  return c;
}

// multi states of 2..g active slots
__host__ __device__ constexpr int n_states(int hp, int g) {
  int s = 0;
  for (int m = 2; m <= g; ++m) s += binom(hp, m);
  return s;
}

// Position of the state with support `mask` (two slots or more): by size,
// then lexicographically by support, as binary_state_space enumerates.
__host__ __device__ constexpr int state_index(int hp, unsigned mask) {
  const int m = popc(mask);
  int s = n_states(hp, m - 1), i = 0, prev = -1;
  for (int a = 0; a < hp; ++a) {
    if (((mask >> a) & 1u) == 0u) continue;
    for (int b = prev + 1; b < a; ++b) s += binom(hp - b - 1, m - i - 1);
    prev = a;
    ++i;
  }
  return s;
}

// the states the kernel holds over hp slots: whole sizes, at most SMAX
__host__ __device__ constexpr int lattice_states(int hp) {
  int s = 0;
  for (int m = 2; m <= hp && s + binom(hp, m) <= SMAX; ++m) s += binom(hp, m);
  return s;
}

// Phase 0 sums the states in passes of at most PASS_CAP, each with its sums
// in registers: whole sizes while they fit, a size larger than a pass in
// equal runs.  start[p] is pass p's first state, start[n] the end.
struct Passes {
  int n;
  int start[16];
};

__host__ __device__ constexpr Passes make_passes(int hp) {
  Passes ps{};
  const int S = lattice_states(hp);
  int lo = 0, cur = 0;
  for (int m = 2; m <= hp; ++m) {
    const int n = binom(hp, m);
    if (lo + cur + n > S) break;
    if (cur + n <= PASS_CAP) {
      cur += n;
      continue;
    }
    if (cur > 0) {
      ps.start[ps.n++] = lo;
      lo += cur;
      cur = 0;
    }
    if (n <= PASS_CAP) {
      cur = n;
      continue;
    }
    const int k = (n + PASS_CAP - 1) / PASS_CAP;
    for (int i = 0; i < k; ++i) {
      ps.start[ps.n++] = lo;
      lo += n * (i + 1) / k - n * i / k;
    }
  }
  if (cur > 0) {
    ps.start[ps.n++] = lo;
    lo += cur;
  }
  ps.start[ps.n] = lo;
  return ps;
}

// slot a together with the subset B of the other slots, slot b at bit
// b - (b > a) of B
__host__ __device__ constexpr unsigned with_slot(unsigned B, int a) {
  return ((B >> a) << (a + 1)) | (B & ((1u << a) - 1u)) | (1u << a);
}

// entries of a slot's routing table: the subsets of the other slots
__host__ __device__ constexpr int table_width(int hp) {
  return hp > 0 ? 1 << (hp - 1) : 1;
}

static_assert(n_states(6, 3) == 35 && lattice_states(6) == 57 &&
              lattice_states(8) == 84 && lattice_states(7) == 120, "");
static_assert(state_index(6, 0x3u) == 0 && state_index(6, 0x30u) == 14 &&
              state_index(6, 0x7u) == 15 && state_index(6, 0x38u) == 34, "");
static_assert(make_passes(6).n == 2 && make_passes(6).start[1] == 35 &&
              make_passes(7).n == 4 && make_passes(8).start[2] == 56 &&
              make_passes(8).start[3] == 84, "");

// ---- what both kernels take -------------------------------------------------

struct Params {
  const float* y;        // (N, D)
  const float* weight;   // (N,)
  float* P;              // (N, H): y W on entry, w q_single on exit
  const float* WT;       // (H, D)
  const float* gdiag;    // (H,)
  Tables t;
  Dims d;
  float* F;              // (N,)
  float* wsA;            // per rows block: s (H) | misc (NMISC) | accd (H)
  float* wsB;            // per chunk of rows: numer (H*D) | denom (H*D)
  float* T;              // (N, Hp*E) each row's routing tables
  int* cand;             // (N, Hp) each row's candidates, -1 at weight 0
  const float* accd;     // (H,) the singleton denom, summed over the blocks
  int n_tiles;           // tiles of TILE rows
  int chunk_rows;        // rows a chunk of the routing kernel
  int hcols;             // units h a block of the routing kernel sums
};

__host__ __device__ inline size_t ws_a_stride(int H) {
  return 2 * (size_t)H + NMISC;
}

__host__ __device__ inline size_t ws_b_stride(int D, int H) {
  return 2 * (size_t)D * H;
}

// ---- phase 0 and the softmax: one warp a datapoint --------------------------

struct RowsSmem {
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
  short* sidx;          // Hp*E     the state slot a | B, or -1
};

__host__ __device__ inline size_t rows_smem_bytes(int D, int H, int Hp,
                                                  int S) {
  const size_t U = 1 + (size_t)H + S;
  const size_t floats = (size_t)TILE * D + (size_t)TILE * H + H + TILE * U
                        + 3 * (size_t)H + 6 * TILE + NMISC;
  return 4 * (floats + (size_t)TILE * Hp) + 2 * (size_t)Hp * table_width(Hp);
}

__device__ inline RowsSmem carve_rows(float* p, const Dims& d) {
  RowsSmem s{};
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
  int* ip = reinterpret_cast<int*>(p);
  s.base.cand = ip;  ip += TILE * d.Hp;
  s.sidx = reinterpret_cast<short*>(ip);
  return s;
}

// A state's winner value from its parent's and the added slot's: the added
// slot wins only where its key is strictly greater.  For MCA (key = value)
// that is the larger value, which fmaxf gives in one instruction (a tie of
// +0 and -0 may take either sign, which no sum below can tell).
template <bool MAG>
__device__ __forceinline__ float winner(float vp, float va) {
  if constexpr (MAG) return fabsf(va) > fabsf(vp) ? va : vp;
  else return fmaxf(vp, va);
}

template <int HP, bool MAG, int LO, int HI, unsigned M, int C, int NA>
__device__ __forceinline__ void visit(float vp, const float (&v)[HP],
                                      float y2, float (&acc)[NA]);

// the states that extend M (top slot TOP) by one slot after TOP
template <int HP, bool MAG, int LO, int HI, unsigned M, int TOP, int NA,
          int... K>
__device__ __forceinline__ void children(float vm, const float (&v)[HP],
                                         float y2, float (&acc)[NA],
                                         std::integer_sequence<int, K...>) {
  (visit<HP, MAG, LO, HI, M, TOP + 1 + K>(vm, v, y2, acc), ...);
}

// State M | C, whose parent M has winner value vp: its sum of
// ybar (2 y - ybar) where it lies in the pass [LO, HI), then, depth first,
// its children where a state of their size or larger lies in the pass (the
// values no state of the pass needs are dropped by the compiler).
template <int HP, bool MAG, int LO, int HI, unsigned M, int C, int NA>
__device__ __forceinline__ void visit(float vp, const float (&v)[HP],
                                      float y2, float (&acc)[NA]) {
  constexpr unsigned MC = M | (1u << C);
  constexpr int I = state_index(HP, MC), m = popc(MC);
  const float vb = winner<MAG>(vp, v[C]);
  if constexpr (I >= LO && I < HI)
    acc[I - LO] = fmaf(vb, y2 - vb, acc[I - LO]);
  if constexpr (m < HP && n_states(HP, m) < HI)
    children<HP, MAG, LO, HI, MC, C>(
        vb, v, y2, acc, std::make_integer_sequence<int, HP - 1 - C>{});
}

template <int HP, bool MAG, int LO, int HI, int NA, int... A>
__device__ __forceinline__ void lattice(const float (&v)[HP], float y2,
                                        float (&acc)[NA],
                                        std::integer_sequence<int, A...>) {
  (children<HP, MAG, LO, HI, (1u << A), A>(
       v[A], v, y2, acc, std::make_integer_sequence<int, HP - 1 - A>{}),
   ...);
}

// Sums over the warp of 32 values per lane; lane l returns that of v[l].
// Each step halves the values a lane keeps: the lanes whose bit o is set
// keep the upper half and send the lower to their partner.
__device__ __forceinline__ float lane_sums(float (&v)[32], int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = up ? v[i] : v[i + o];
      const float keep = up ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  return v[0];
}

// The warp's sums of the states 32 GR .. 32 GR + 31 that lie in the pass
// [LO, HI) whose lane sums acc hold: state 32 GR + l in lane l, 0 in the
// lanes of states outside the pass.
template <int GR, int LO, int HI, int NA>
__device__ __forceinline__ float group_sum(const float (&acc)[NA], int lane) {
  constexpr int B = 32 * GR < LO ? LO : 32 * GR;
  constexpr int E = 32 * GR + 32 < HI ? 32 * GR + 32 : HI;
  if constexpr (E - B > 8) {
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int s = 32 * GR + i;
      v[i] = (s >= B && s < E) ? acc[(s >= B && s < E) ? s - LO : 0] : 0.f;
    }
    return lane_sums(v, lane);
  } else {
    float mine = 0.f;
#pragma unroll
    for (int s = B; s < E; ++s) {
      const float t = let::warp_sum(acc[s - LO]);
      if (lane == s - 32 * GR) mine = t;
    }
    return mine;
  }
}

template <int LO, int HI, int NA, int SPL, int... J>
__device__ __forceinline__ void pass_sums(const float (&acc)[NA],
                                          float (&L)[SPL], int lane,
                                          std::integer_sequence<int, J...>) {
  ((L[LO / 32 + J] += group_sum<LO / 32 + J, LO, HI>(acc, lane)), ...);
}

// One warp, one datapoint, pass P (if it holds a state below S): each lane
// sums over its dimensions d = lane, lane + 32, ... the pass's
// ybar_s[d] (2 y_d - ybar_s[d]), then the warp adds their sums to L: L[k]
// of state s = lane + 32 k.
template <int HP, bool MAG, int P, int SPL>
__device__ __forceinline__ void lattice_pass(const float* __restrict__ WT,
                                             const int (&off)[HP],
                                             const float* yr, int D, int S,
                                             int lane, float (&L)[SPL]) {
  constexpr int LO = make_passes(HP).start[P];
  constexpr int HI = make_passes(HP).start[P + 1];
  if (LO >= S) return;
  float acc[HI - LO];
#pragma unroll
  for (int s = 0; s < HI - LO; ++s) acc[s] = 0.f;
  for (int dd = lane; dd < D; dd += 32) {
    float v[HP];
#pragma unroll
    for (int a = 0; a < HP; ++a) v[a] = WT[off[a] + dd];
    lattice<HP, MAG, LO, HI>(v, 2.f * yr[dd], acc,
                             std::make_integer_sequence<int, HP>{});
  }
  pass_sums<LO, HI>(acc, L, lane,
                    std::make_integer_sequence<int, (HI - 1) / 32 - LO / 32
                                                        + 1>{});
}

template <int HP, bool MAG, int SPL, int... P>
__device__ __forceinline__ void lattice_sums(const float* __restrict__ WT,
                                             const int* cand, const float* yr,
                                             int D, int S, int lane,
                                             float (&L)[SPL],
                                             std::integer_sequence<int, P...>) {
  int off[HP];
#pragma unroll
  for (int a = 0; a < HP; ++a) off[a] = cand[a] * D;
#pragma unroll
  for (int k = 0; k < SPL; ++k) L[k] = 0.f;
  (lattice_pass<HP, MAG, P>(WT, off, yr, D, S, lane, L), ...);
}

// One warp, one datapoint of weight w: T[a * E + B] = the sum of w q_s
// over the multi states s that contain slot a and lie within a | B.  Lane
// l holds the subsets B = l + 32 j; the subset sums run over bits 0-4
// across lanes and over the higher bits in registers.
template <int HP>
__device__ __forceinline__ void route_table(float* T, const short* sidx,
                                            const float* qm, float w,
                                            int lane) {
  constexpr int E = table_width(HP), EPL = (E + 31) / 32;
  constexpr int LB = HP - 1 < 5 ? HP - 1 : 5;
#pragma unroll
  for (int a = 0; a < HP; ++a) {
    float f[EPL];
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int B = lane + 32 * j;
      const int s = B < E ? sidx[a * E + B] : -1;
      f[j] = s >= 0 ? qm[s] * w : 0.f;
    }
#pragma unroll
    for (int k = 0; k < LB; ++k) {
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const float o = __shfl_xor_sync(0xffffffffu, f[j], 1 << k);
        if ((lane >> k) & 1) f[j] += o;
      }
    }
#pragma unroll
    for (int k = 5; k < HP - 1; ++k) {
#pragma unroll
      for (int j = 0; j < EPL; ++j)
        if ((j >> (k - 5)) & 1) f[j] += f[j ^ (1 << (k - 5))];
    }
#pragma unroll
    for (int j = 0; j < EPL; ++j)
      if (lane + 32 * j < E) T[a * E + lane + 32 * j] = f[j];
  }
}

// The rows kernel: persistent blocks walk tiles of TILE rows; per row the
// candidates, the multi states' likelihoods (phase 0), the union softmax,
// F and the row's statistics, P's row turned into w q_single, and the
// row's candidates and routing tables for the routing kernel.
template <int HP, bool MAG>
__device__ __forceinline__ void rows_phase(const Params& p) {
  constexpr int E = table_width(HP);
  constexpr int SPL = (lattice_states(HP) + 31) / 32;   // states a lane
  extern __shared__ float4 smem4[];
  const Dims& d = p.d;
  const Tables& t = p.t;
  const RowsSmem sm = carve_rows(reinterpret_cast<float*>(smem4), d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = d.D, H = d.H, S = d.S, U = d.U;
  const float* __restrict__ WT = p.WT;
  float* P = p.P;

  for (int h = tid; h < H; h += THREADS) {
    const float g = p.gdiag[h];
    sm.gd[h] = g;
    sm.base.wn[h] = fmaxf(sqrtf(fmaxf(g, 1e-30f)), 1e-12f);
    sm.accs[h] = 0.f;
    sm.accd[h] = 0.f;
  }
  for (int i = tid; i < HP * E; i += THREADS) {
    const unsigned m = with_slot((unsigned)(i % E), i / E);
    const int s = popc(m) >= 2 ? state_index(HP, m) : S;
    sm.sidx[i] = (short)(s < S ? s : -1);
  }
  if (tid < NMISC) sm.misc[tid] = 0.f;
  const let::Scalars c = let::load_scalars(d, t);
  const float lo = t.log_odds[0];
  __syncthreads();

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE;
    const int nrows = min(TILE, d.N - row0);
    for (int i = tid; i < TILE * D; i += THREADS) {
      const int r = i / D;
      sm.base.ys[i] =
          r < nrows ? p.y[(size_t)(row0 + r) * D + (i - r * D)] : 0.f;
    }
    Smem sel = sm.base;               // candidates from P's rows in device
    sel.Ps = P + (size_t)row0 * H;    // memory
    __syncthreads();

    for (int r = warp; r < nrows; r += WARPS) {
      const int n = row0 + r;
      const float w = p.weight[n];
      let::select_candidates(r, lane, d, sel);
      const int* cand = sm.base.cand + r * HP;
      const float* yr = sm.base.ys + (size_t)r * D;
      float* Prow = P + (size_t)n * H;

      // phase 0: L[k] = 2 y.ybar_s - ||ybar_s||^2 of state s = lane + 32k
      float L[SPL];
      lattice_sums<HP, MAG>(
          WT, cand, yr, D, S, lane, L,
          std::make_integer_sequence<int, make_passes(HP).n>{});

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
        lm[k] = L[k] * c.inv2s2;
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
          res = fmaf(qm[s], y2 - L[k], res);
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

      // the row's candidates (-1 at weight 0) and routing tables, for the
      // routing kernel
      if (lane < HP)
        p.cand[(size_t)n * HP + lane] = w != 0.f ? cand[lane] : -1;
      if (w != 0.f)
        route_table<HP>(p.T + (size_t)n * HP * E, sm.sidx, qm, w, lane);

      if (lane == 0) {
        const float Fr = (mx + logf(Z))
            + let::free_energy_const(y2, c.inv2s2, c.log_norm, c.log_p0,
                                     c.beta, c.pb, H);
        const float Ftr = d.collect_true
            ? (mxt + logf(Zt))
                  + let::free_energy_const(y2, c.inv2s2, c.log_norm,
                                           c.log_p0, 1.f, 1.f, H)
            : Fr;
        p.F[n] = Fr;
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
    __syncthreads();
  }

  float* ws = p.wsA + (size_t)blockIdx.x * ws_a_stride(H);
  for (int h = tid; h < H; h += THREADS) {
    ws[h] = sm.accs[h];
    ws[H + NMISC + h] = sm.accd[h];
  }
  if (tid < NMISC) ws[H + tid] = sm.misc[tid];
}

// ---- phase 1: routing by rank -----------------------------------------------

constexpr int RPW = 4;             // rows a warp of the routing kernel ranks
constexpr int RB = WARPS * RPW;    // rows a batch of the routing kernel
static_assert(RB == 32, "a batch's rows are the lanes of a ballot");

__host__ __device__ inline size_t route_smem_bytes(int Hp, int hcols) {
  return 4 * (2 * (size_t)hcols * DR + (size_t)RB * Hp * DR + RB * DR
              + (size_t)RB * Hp)
         + (size_t)RB * WARPS;
}

// The routing kernel: block (x, y, z) sums numer and denom of the columns
// d = 32 x .. 32 x + 31 and the units h = z hcols .. of the rows of chunk y
// in shared memory, in row order, and writes them to the chunk's slice.
// Per batch of RB rows, each warp ranks its RPW rows' H' candidate values
// at each column (lane): for each slot a, the set B of slots that rank
// below it there (by key, ties to the earlier slot) picks the entry
// T[a][B] of the row's routing table, the mass that slot a wins at that
// column, which goes to (cand_a, d).  Then warp c adds the batch's masses
// of the units h = c (mod WARPS), so that each sum has one writer; a mask
// per row and warp names the slots it adds.
template <int HP>
__device__ __forceinline__ void route_phase(const Params& p) {
  constexpr int E = table_width(HP);
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = p.d.D, H = p.d.H, N = p.d.N;
  const int h0 = blockIdx.z * p.hcols, hn = min(p.hcols, H - h0);
  float* accN = reinterpret_cast<float*>(smem4);
  float* accD = accN + (size_t)p.hcols * DR;
  float* Ab = accD + (size_t)p.hcols * DR;            // RB*Hp*DR masses
  float* yb = Ab + RB * HP * DR;                      // RB*DR
  int* cb = reinterpret_cast<int*>(yb + RB * DR);     // RB*Hp
  unsigned char* own = reinterpret_cast<unsigned char*>(cb + RB * HP);
  const int col = blockIdx.x * DR + lane;
  const int colc = col < D ? col : D - 1;
  const int r_begin = blockIdx.y * p.chunk_rows;
  const int r_end = min(N, r_begin + p.chunk_rows);
  const bool mag = p.d.signed_select != 0;

  for (int i = tid; i < hn * DR; i += THREADS) {
    accN[i] = 0.f;
    accD[i] = blockIdx.y == 0 ? p.accd[h0 + i / DR] : 0.f;
  }
  for (int n0 = r_begin; n0 < r_end; n0 += RB) {
    // the warp's rows' candidates (-1: a row of weight 0 or past the chunk)
    const int rw = warp * RPW;
    if (lane < RPW * HP) {
      const int n = n0 + rw + lane / HP;
      cb[rw * HP + lane] =
          n < r_end ? p.cand[(size_t)n * HP + lane % HP] : -1;
    }
    __syncwarp();
    // their values at the lane's column, then ranks and masses
    float k[RPW][HP], yv[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int* cr = cb + (rw + i) * HP;
      const bool live = cr[0] >= 0;
      yv[i] = live ? p.y[(size_t)(n0 + rw + i) * D + colc] : 0.f;
#pragma unroll
      for (int a = 0; a < HP; ++a) {
        const float v = live ? p.WT[(size_t)cr[a] * D + colc] : 0.f;
        k[i][a] = mag ? fabsf(v) : v;
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = rw + i;
      const int* cr = cb + r * HP;
      if (lane < WARPS) {              // the slots each warp adds
        unsigned m = 0u;
#pragma unroll
        for (int a = 0; a < HP; ++a) {
          const int h = cr[a] - h0;
          if (cr[0] >= 0 && h >= 0 && h < hn && (h & (WARPS - 1)) == lane)
            m |= 1u << a;
        }
        own[r * WARPS + lane] = (unsigned char)m;
      }
      if (cr[0] < 0) continue;
      unsigned bl[HP];
#pragma unroll
      for (int a = 0; a < HP; ++a) bl[a] = 0u;
#pragma unroll
      for (int a = 0; a < HP; ++a) {
#pragma unroll
        for (int b = a + 1; b < HP; ++b) {
          const bool first = k[i][a] >= k[i][b];
          bl[a] |= first ? 1u << (b - 1) : 0u;
          bl[b] |= first ? 0u : 1u << a;
        }
      }
      const float* T = p.T + (size_t)(n0 + r) * HP * E;
#pragma unroll
      for (int a = 0; a < HP; ++a)
        Ab[(r * HP + a) * DR + lane] = T[a * E + bl[a]];
      yb[r * DR + lane] = yv[i];
    }
    __syncthreads();
    // sums: warp c, the slots its masks name (distinct units within a row),
    // the rows in order; lane l holds row l's mask, a ballot the rows with
    // any
    const unsigned mine = own[lane * WARPS + warp];
    for (unsigned rows = __ballot_sync(0xffffffffu, mine != 0u); rows != 0u;
         rows &= rows - 1u) {
      const int r = __ffs(rows) - 1;
      const unsigned m = __shfl_sync(0xffffffffu, mine, r);
      const int* cr = cb + r * HP;
      const float y1 = yb[r * DR + lane];
      int at[HP];
      float A[HP], an[HP], ad[HP];
#pragma unroll
      for (int a = 0; a < HP; ++a) {
        if ((m >> a) & 1u) {
          at[a] = (cr[a] - h0) * DR + lane;
          A[a] = Ab[(r * HP + a) * DR + lane];
          an[a] = accN[at[a]];
          ad[a] = accD[at[a]];
        }
      }
#pragma unroll
      for (int a = 0; a < HP; ++a) {
        if ((m >> a) & 1u) {
          accN[at[a]] = fmaf(A[a], y1, an[a]);
          accD[at[a]] = ad[a] + A[a];
        }
      }
    }
    __syncthreads();
  }

  float* wn = p.wsB + (size_t)blockIdx.y * ws_b_stride(D, H);
  float* wd = wn + (size_t)H * D;
  for (int i = tid; i < hn * DR; i += THREADS) {
    const int h = h0 + i / DR, dd = blockIdx.x * DR + i % DR;
    if (dd < D) {
      wn[(size_t)h * D + dd] = accN[i];
      wd[(size_t)h * D + dd] = accD[i];
    }
  }
}

// ---- the kernel and its launch -----------------------------------------------

// Phase 0 of H' (HP) slots: the rows kernel (MCA or MMCA); phase 1: the
// routing kernel (both).
template <int HP, bool MAG, int PHASE>
__global__ void __launch_bounds__(THREADS, PHASE == 0 ? 3 : 2)
max_estep_kernel(const Params p) {
  if constexpr (PHASE == 0) rows_phase<HP, MAG>(p);
  else route_phase<HP>(p);
}

template <int HP, bool MAG, int PHASE>
cudaError_t prepare() {
  static launch_once::DeviceOnce once;
  return launch_once::prepare_kernel(max_estep_kernel<HP, MAG, PHASE>, once,
                                     true);
}

// What run does: launch both kernels (and the sums between them), or ask
// how many blocks of each an SM holds.
struct Launch {
  Params p;
  int nb;              // rows kernel blocks
  int n_chunks, hgroups;
  size_t smem_rows, smem_route;
  cudaStream_t stream;
};

template <int HP, bool MAG>
cudaError_t run_one(const Launch& l, float* sums, int* blocks) {
  cudaError_t e = prepare<HP, MAG, 0>();
  if (e == cudaSuccess) e = prepare<HP, false, 1>();
  if (e != cudaSuccess) return e;
  if (blocks != nullptr) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, max_estep_kernel<HP, MAG, 0>, THREADS, l.smem_rows);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 1, max_estep_kernel<HP, false, 1>, THREADS, l.smem_route);
  }
  const Params& p = l.p;
  const int H = p.d.H, D = p.d.D;
  max_estep_kernel<HP, MAG, 0><<<l.nb, THREADS, l.smem_rows, l.stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // s | misc | the singleton denom, summed over the blocks in order
  const size_t sa = ws_a_stride(H);
  float* tail = sums + ws_b_stride(D, H);
  let::reduce_blocks<<<(unsigned)((sa + 255) / 256), 256, 0, l.stream>>>(
      p.wsA, tail, l.nb, sa, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  Params q = p;
  q.accd = tail + H + NMISC;
  const dim3 grid((D + DR - 1) / DR, l.n_chunks, l.hgroups);
  max_estep_kernel<HP, false, 1><<<grid, THREADS, l.smem_route, l.stream>>>(
      q);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t sb = ws_b_stride(D, H);
  let::reduce_blocks<<<(unsigned)((sb + 255) / 256), 256, 0, l.stream>>>(
      p.wsB, sums, l.n_chunks, sb, 0);
  return cudaGetLastError();
}

// run_one<HP, magnitude>; max_et_estep.cu and max_et_estep_hp*.cu each
// instantiate it for some H'
template <int HP>
cudaError_t run(const Launch& l, int magnitude, float* sums, int* blocks) {
  return magnitude ? run_one<HP, true>(l, sums, blocks)
                   : run_one<HP, false>(l, sums, blocks);
}

}  // namespace mxe
