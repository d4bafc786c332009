// Fused linear-family ET E-step (training) for sm_90a.
//
// Replaces prosper_tpu/ops/linear_pallas.py::linear_et_estep_pallas (body
// _kernel, front end _frontend / _union_softmax).  Per datapoint tile it
// runs the shared front end (linear_et_frontend.cuh) and accumulates the
// weight-masked sufficient statistics xs (D,H), ss (H,H), s (H) and
// misc = [vc (K), abs, y2, n, F, F_true], and writes F per datapoint.
//
// What bounds it on the H100: the two D x H GEMMs per datapoint (P = y W
// and xs += y^T (w <s>)), in float32 on the CUDA cores.  Measured at the
// patches width, the xs update is about half the kernel: it reads and
// writes the block's whole D x H slice in device memory once per tile.
// The H'^2 scatter of <s s^T> into ss costs little.
//
// What the design does about it: the Pallas grid runs in order on one core
// and carries the sums from tile to tile; CUDA blocks run in parallel and
// in no order.  So a fixed number of persistent blocks each walks its tiles
// (tile = blockIdx.x, + gridDim.x, ...) in order, accumulating into its own
// workspace slice, and a second kernel sums the slices in block order.
// There are no float atomics, so the sums are deterministic: a step with
// collect_true off gives the same sums, bit for bit, as one with it on.
// Rows of one tile can hit the same ss entry, so the scatter runs one row
// after another (a block barrier between rows); the H'^2 entries of one row
// are distinct units and go in parallel.  Rows with weight 0 add nothing
// and skip the scatter.  The xs update is a small (D x TILE) x (TILE x H)
// product per tile into the block's slice, each thread owning its entries.

#include "linear_et_frontend.cuh"

namespace let {

__host__ __device__ inline size_t ws_stride(int D, int H, int K) {
  return (size_t)D * H + (size_t)H * H + H + K + 5;
}

template <int HC>
__global__ void __launch_bounds__(THREADS)
estep_kernel(const float* __restrict__ y, const float* __restrict__ weight,
             Tables t, Dims d, float* __restrict__ F,
             float* __restrict__ ws, int n_tiles) {
  extern __shared__ float smem_raw[];
  const Smem sm = carve(smem_raw, d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = d.D, H = d.H, K = d.K, Hp = d.Hp, S = d.S, U = d.U;
  const int HK = H * K;
  const size_t stride = ws_stride(D, H, K);
  float* wxs = ws + (size_t)blockIdx.x * stride;
  float* wss = wxs + (size_t)D * H;
  float* wsv = wss + (size_t)H * H;
  float* wmisc = wsv + H;

  block_setup(d, t, sm);
  for (size_t i = tid; i < stride; i += THREADS) wxs[i] = 0.f;
  const Scalars c = load_scalars(d, t);
  __syncthreads();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE;
    const int nrows = min(TILE, d.N - row0);
    tile_projection<HC>(y, row0, nrows, d, t, sm);

    for (int r = warp; r < nrows; r += WARPS) {
      const float w = weight[row0 + r];
      const RowOut o = frontend_row(r, lane, d, t, sm, c.inv2s2, c.beta,
                                    c.pb);
      const float Fr = o.logZ + free_energy_const(o.y2, c.inv2s2, c.log_norm,
                                                  c.log_p0, c.beta, c.pb, H);
      const float Ftr = d.collect_true
          ? o.logZt + free_energy_const(o.y2, c.inv2s2, c.log_norm,
                                        c.log_p0, 1.f, 1.f, H)
          : Fr;
      const float* q = sm.buf + (size_t)r * U;
      const float* qm = q + 1 + HK;
      const int* cand = sm.cand + r * Hp;

      // multi-state moments over the candidates
      const float scand_mine = row_scand(qm, d, t, lane);
      float* ssc = sm.sscand + (size_t)r * Hp * Hp;
      for (int i = 0; i < Hp * Hp; ++i) {
        float acc = 0.f;
        for (int s = lane; s < S; s += 32)
          acc = fmaf(qm[s], t.outer[(size_t)i * S + s], acc);
        acc = warp_sum(acc);
        if (lane == 0) ssc[i] = acc * w;
      }
      float abs_m = 0.f;
      for (int s = lane; s < S; s += 32) abs_m = fmaf(qm[s], t.absst[s], abs_m);
      abs_m = warp_sum(abs_m);

      // value counts: singletons + multi states
      float vc[KMAX];
      float qs_tot = 0.f;
      for (int k = 0; k < K; ++k) {
        float a = 0.f, m = 0.f;
        for (int h = lane; h < H; h += 32) a += q[1 + (size_t)h * K + k];
        for (int s = lane; s < S; s += 32)
          m = fmaf(qm[s], t.vcounts[(size_t)k * S + s], m);
        a = warp_sum(a);
        m = warp_sum(m);
        qs_tot += a;
        vc[k] = a + m;
      }

      // w * <s> over all H units into the work row
      float* sw = sm.work + (size_t)r * H;
      row_posterior_mean(sw, q, cand, scand_mine, d, t, lane);
      for (int h = lane; h < H; h += 32) sw[h] *= w;

      if (lane == 0) {
        F[row0 + r] = Fr;
        sm.rowF[r] = Fr;
        sm.rowFt[r] = Ftr;
        sm.rowY2[r] = o.y2;
        sm.rowW[r] = w;
        sm.rowAbs[r] = qs_tot + abs_m;
        for (int k = 0; k < K; ++k) sm.rowVc[r * KMAX + k] = vc[k];
      }
    }
    __syncthreads();

    // xs += y_tile^T sw_tile, each thread owning its (d, h) entries
    for (int i = tid; i < D * H; i += THREADS) {
      const int dd = i / H, h = i - dd * H;
      float acc = wxs[i];
      for (int r = 0; r < nrows; ++r)
        acc = fmaf(sm.ys[r * D + dd], sm.work[(size_t)r * H + h], acc);
      wxs[i] = acc;
    }
    // s and the singleton diagonal of ss
    for (int h = tid; h < H; h += THREADS) {
      float a = sm.accs[h], b = sm.accd[h];
      for (int r = 0; r < nrows; ++r) {
        a += sm.work[(size_t)r * H + h];
        const float* qs = sm.buf + (size_t)r * U + 1 + (size_t)h * K;
        float t2 = qs[0] * (t.values[0] * t.values[0]);
        for (int k = 1; k < K; ++k)
          t2 = fmaf(qs[k], t.values[k] * t.values[k], t2);
        b += t2 * sm.rowW[r];
      }
      sm.accs[h] = a;
      sm.accd[h] = b;
    }
    // ss scatter, one row after another (rows may share entries)
    for (int r = 0; r < nrows; ++r) {
      if (sm.rowW[r] != 0.f) {
        const int* cand = sm.cand + r * Hp;
        const float* ssc = sm.sscand + (size_t)r * Hp * Hp;
        for (int i = tid; i < Hp * Hp; i += THREADS)
          wss[(size_t)cand[i / Hp] * H + cand[i % Hp]] += ssc[i];
      }
      __syncthreads();
    }
    if (tid == 0) {
      for (int r = 0; r < nrows; ++r) {
        const float w = sm.rowW[r];
        for (int k = 0; k < K; ++k) sm.misc[k] += sm.rowVc[r * KMAX + k] * w;
        sm.misc[K] += sm.rowAbs[r] * w;
        sm.misc[K + 1] += sm.rowY2[r] * w;
        sm.misc[K + 2] += w;
        sm.misc[K + 3] += sm.rowF[r] * w;
        sm.misc[K + 4] += sm.rowFt[r] * w;
      }
    }
    __syncthreads();
  }

  for (int h = tid; h < H; h += THREADS) {
    wsv[h] = sm.accs[h];
    wss[(size_t)h * H + h] += sm.accd[h];
  }
  for (int i = tid; i < K + 5; i += THREADS) wmisc[i] = sm.misc[i];
}

template <int HC>
cudaError_t launch_estep(const float* y, const float* weight, Tables t,
                         Dims d, float* F, float* ws, float* sums, int nb,
                         cudaStream_t stream) {
  const size_t smem = smem_floats(d.D, d.H, d.Hp, d.S, d.K) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      estep_kernel<HC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int n_tiles = (d.N + TILE - 1) / TILE;
  estep_kernel<HC><<<nb, THREADS, smem, stream>>>(y, weight, t, d, F, ws,
                                                  n_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t stride = ws_stride(d.D, d.H, d.K);
  reduce_blocks<<<(unsigned)((stride + 255) / 256), 256, 0, stream>>>(
      ws, sums, nb, stride);
  return cudaGetLastError();
}

}  // namespace let

extern "C" {

// Workspace floats per persistent block; the caller allocates
// n_blocks * this for ws and this for sums.
size_t linear_et_estep_ws_stride(int D, int H, int K) {
  return let::ws_stride(D, H, K);
}

size_t linear_et_smem_bytes(int D, int H, int Hp, int S, int K) {
  return let::smem_floats(D, H, Hp, S, K) * sizeof(float);
}

const char* linear_et_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// sums = [xs (D*H) | ss (H*H) | s (H) | vc (K) | abs | y2 | n | F | F_true]
int linear_et_estep(const float* y, const float* weight, const float* W,
                    const float* gram, const float* states,
                    const float* outer, const float* vcounts,
                    const float* absst, const float* values,
                    const float* log_odds, const float* scal, float* F,
                    float* ws, float* sums, int N, int D, int H, int Hp,
                    int S, int K, int signed_select, int collect_true,
                    int n_blocks, void* stream) {
  let::Tables t{W, gram, states, outer, vcounts, absst, values, log_odds,
                scal};
  let::Dims d{N, D, H, Hp, S, K, 1 + H * K + S, signed_select, collect_true};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hc = (H + let::THREADS - 1) / let::THREADS;
  cudaError_t e;
  switch (hc) {
    case 1: e = let::launch_estep<1>(y, weight, t, d, F, ws, sums, n_blocks, s); break;
    case 2: e = let::launch_estep<2>(y, weight, t, d, F, ws, sums, n_blocks, s); break;
    case 3: e = let::launch_estep<3>(y, weight, t, d, F, ws, sums, n_blocks, s); break;
    case 4: e = let::launch_estep<4>(y, weight, t, d, F, ws, sums, n_blocks, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
