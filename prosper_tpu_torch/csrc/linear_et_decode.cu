// Fused linear-family ET posterior decode (serving) for sm_90a.
//
// Replaces prosper_tpu/ops/linear_pallas.py::linear_et_decode_pallas (body
// _decode_kernel, front end _frontend).  Per datapoint it writes F, the
// posterior mean s_mean (H), the top-L posterior probabilities with their
// canonical union indices (0 = zero state, 1 + h*K + k = singleton,
// 1 + H*K + s = multi state; descending, ties to the lowest index, a taken
// entry knocked out to -1), and the H' candidates.
//
// What bounds it on the H100: as the E-step, the float32 projection GEMM
// (2*D*H flops per datapoint) and the union logits; the outputs are
// H + 2L + H' + 1 values per datapoint, so the (N, 1+H*K+S) posterior is
// the one thing worth keeping out of device memory.
//
// What the design does about it: the posterior of a tile lives only in
// shared memory (one warp per datapoint), and the top-L search runs there
// as L warp argmaxes over the canonical layout, which is the buffer's own
// order.  Each block owns one tile and writes whole output rows, so blocks
// need no ordering and no reduction.

#include "linear_et_frontend.cuh"

namespace let {

template <int HC>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const float* __restrict__ y, Tables t, Dims d, int L,
              float* __restrict__ F, float* __restrict__ s_mean,
              float* __restrict__ top_q, int* __restrict__ top_u,
              int* __restrict__ cand_out) {
  extern __shared__ float smem_raw[];
  const Smem sm = carve(smem_raw, d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = d.H, Hp = d.Hp, U = d.U;

  block_setup(d, t, sm);
  const Scalars c = load_scalars(d, t);
  __syncthreads();

  const int row0 = blockIdx.x * TILE;
  const int nrows = min(TILE, d.N - row0);
  tile_projection<HC>(y, row0, nrows, d, t, sm);

  for (int r = warp; r < nrows; r += WARPS) {
    const size_t n = (size_t)row0 + r;
    const RowOut o = frontend_row(r, lane, d, t, sm, c.inv2s2, c.beta, c.pb);
    float* q = sm.buf + (size_t)r * U;
    const int* cand = sm.cand + r * Hp;

    const float scand_mine = row_scand(q + 1 + H * d.K, d, t, lane);
    float* sf = sm.work + (size_t)r * H;
    row_posterior_mean(sf, q, cand, scand_mine, d, t, lane);
    for (int h = lane; h < H; h += 32) s_mean[n * H + h] = sf[h];
    for (int a = lane; a < Hp; a += 32) cand_out[n * Hp + a] = cand[a];
    if (lane == 0)
      F[n] = o.logZ + free_energy_const(o.y2, c.inv2s2, c.log_norm,
                                        c.log_p0, c.beta, c.pb, H);

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
  }
}

template <int HC>
cudaError_t launch_decode(const float* y, Tables t, Dims d, int L, float* F,
                          float* s_mean, float* top_q, int* top_u,
                          int* cand, cudaStream_t stream) {
  const size_t smem = smem_floats(d.D, d.H, d.Hp, d.S, d.K) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decode_kernel<HC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int n_tiles = (d.N + TILE - 1) / TILE;
  decode_kernel<HC><<<n_tiles, THREADS, smem, stream>>>(
      y, t, d, L, F, s_mean, top_q, top_u, cand);
  return cudaGetLastError();
}

}  // namespace let

extern "C" int linear_et_decode(const float* y, const float* W,
                                const float* gram, const float* states,
                                const float* outer, const float* vcounts,
                                const float* values, const float* log_odds,
                                const float* scal, float* F, float* s_mean,
                                float* top_q, int* top_u, int* cand, int N,
                                int D, int H, int Hp, int S, int K, int L,
                                int signed_select, void* stream) {
  let::Tables t{W, gram, states, outer, vcounts, nullptr, values, log_odds,
                scal};
  let::Dims d{N, D, H, Hp, S, K, 1 + H * K + S, signed_select, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hc = (H + let::THREADS - 1) / let::THREADS;
  cudaError_t e;
  switch (hc) {
    case 1: e = let::launch_decode<1>(y, t, d, L, F, s_mean, top_q, top_u, cand, s); break;
    case 2: e = let::launch_decode<2>(y, t, d, L, F, s_mean, top_q, top_u, cand, s); break;
    case 3: e = let::launch_decode<3>(y, t, d, L, F, s_mean, top_q, top_u, cand, s); break;
    case 4: e = let::launch_decode<4>(y, t, d, L, F, s_mean, top_q, top_u, cand, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
