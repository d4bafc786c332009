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
// datapoint it reads a row of P and of y (H + D floats, ~2.2 KB at the
// patches width) and writes w <s> back into P; its arithmetic is some
// 20 Kflop.  The card could do either in about 0.1 ms for 131072 rows.
// What it waits for is the latency of the short dependent chains a warp
// walks one after another (selection, the softmax's maxima, masses and
// normalisation, the moments, the scatter's reads of the block's slice)
// and the instructions between them: four blocks of eight warps an SM
// hide that latency, three do not (0.48 ms more at N = 131072), so the
// kernel lives within 64 registers a thread.  In the dense design it
// replaced, each singleton term was computed four times (maxima, masses,
// posterior mean, and a block phase that read P's row again), the logits
// and moments walked the dense 72- and 74-row state tables (at H' = 8,
// gamma = 4 some 80 % of their multiply-adds multiply zeros), selection
// took H' rounds of a block-wide argmax and the ss scatter a block
// barrier a row.
//
// What the design does about it (linear_et_estep.cuh):
// * One warp owns one datapoint, 8 warps to a block.  Each lane holds its
//   NU = ceil(H/32) units of P's row in registers (units lane + 32 i; the
//   kernel is a template on NU and on K = 1), loaded once and coalesced.
//   From them it computes the selection scores, each singleton logit (a
//   few flops, never read back from memory), one expf per channel and
//   (h, k) (for K = 1 the annealed ones stay in registers for the
//   posterior mean), the posterior mean, <s_h^2> for the diagonal of ss
//   and w <s>, which goes back into P.
// * Selection: each lane keeps its units' scores as keys whose unsigned
//   order is the scores' order.  The H'-th largest of the lanes' own
//   largest keys (a bitonic sort over the lanes) bounds the top H' from
//   below; the keys at or above it, seldom more than a dozen, are
//   gathered one a lane, and each counts the gathered keys that beat its
//   own (larger, or equal at a lower unit: ties to the lowest index, as
//   torch.argmax): its rank is its slot.  No chain of H' warp-wide
//   argmaxes; should more than 32 keys qualify, H' rounds of them run.
// * Quotients by a row's Z (and the scores' by a column norm) are one
//   IEEE division for the reciprocal, then a product and one correction
//   (Markstein): the IEEE quotient wherever it is a normal number, without
//   a division's slow-path call, whose register traffic cost 0.15 ms.
// * The multi states follow the state space's sparsity through bit masks
//   built on the host once per state space (ops/linear_cuda.py::
//   rows_tables): a state's logits walk its non-zero slots and slot pairs
//   a <= b (a pair a < b counts twice: the Gram matrix is symmetric),
//   and the moment of each slot and slot pair a >= b walks the states that
//   hold it, in state order, in pieces shared out over the lanes largest
//   first (for K = 1 a slot's own pair is the slot's moment times v^2).
//   At H' = 8, gamma = 4 that is 1,624 and 1,120 multiply-adds a row in
//   place of 11,088 and 11,396, at most 40 states a lane, and the table
//   takes 692 words of shared memory in place of 12,705.
// * Block sums without a barrier a row: s and the singleton diagonal of ss
//   sum in each warp's own slice of shared memory over its rows, and the
//   warps add theirs in warp order at the end of the block.  The multi
//   states' ss entries go to the upper triangle of the block's slice after
//   one barrier a tile of 8 rows: each address summed, in row order, by the
//   tile's first row that holds it, which a ballot a row of the tile finds
//   (the rows' candidate slots stay in shared memory until the tile after
//   next).  The tile's candidates and pair moments are double-buffered, so
//   the next tile's rows start while the scatter runs.  reduce_blocks
//   mirrors the triangle.
// * Blocks run in parallel and in no order, so a fixed number of
//   persistent blocks each walks its tiles in order, accumulating into its
//   own workspace slice (H*H + H + K + 5 floats), and reduce_blocks sums
//   the slices in block order.  No float atomics: repeated calls give the
//   same bits, and a step with collect_true off gives the same sums, bit
//   for bit, as one with it on, but F_true.  Rows with weight 0 skip the
//   scatter.
//
// Numerics: IEEE float32 under -fmad=false, accurate expf/logf, IEEE
// quotients; a logit adds its slots' products, its own pairs' and its
// pairs a < b in slot order; a moment adds its pieces' sums in order.

#include "linear_et_estep.cuh"

namespace let {

// the instantiations of linear_et_estep_nu*.cu
extern template cudaError_t run_nu<1, true>(const RowsParams&, int, size_t,
                                            int*, cudaStream_t);
extern template cudaError_t run_nu<1, false>(const RowsParams&, int, size_t,
                                             int*, cudaStream_t);
extern template cudaError_t run_nu<4, true>(const RowsParams&, int, size_t,
                                            int*, cudaStream_t);
extern template cudaError_t run_nu<4, false>(const RowsParams&, int, size_t,
                                             int*, cudaStream_t);
extern template cudaError_t run_nu<16, true>(const RowsParams&, int, size_t,
                                             int*, cudaStream_t);
extern template cudaError_t run_nu<16, false>(const RowsParams&, int, size_t,
                                              int*, cudaStream_t);
extern template cudaError_t run_nu<32, true>(const RowsParams&, int, size_t,
                                             int*, cudaStream_t);
extern template cudaError_t run_nu<32, false>(const RowsParams&, int, size_t,
                                              int*, cudaStream_t);
template cudaError_t run_nu<10, true>(const RowsParams&, int, size_t, int*,
                                      cudaStream_t);
template cudaError_t run_nu<10, false>(const RowsParams&, int, size_t, int*,
                                       cudaStream_t);

template <int NU>
cudaError_t run_k(const RowsParams& p, int n_blocks, size_t smem, int* blocks,
                  cudaStream_t stream) {
  return p.K == 1 ? run_nu<NU, true>(p, n_blocks, smem, blocks, stream)
                  : run_nu<NU, false>(p, n_blocks, smem, blocks, stream);
}

// the kernel for the smallest NU that holds H and for K: its launch, or
// (blocks given) the blocks an SM holds at once
inline cudaError_t dispatch(const RowsParams& p, int n_blocks, size_t smem,
                            int* blocks, cudaStream_t stream) {
  const int nu = (p.H + 31) / 32;
  if (nu <= 1) return run_k<1>(p, n_blocks, smem, blocks, stream);
  if (nu <= 4) return run_k<4>(p, n_blocks, smem, blocks, stream);
  if (nu <= 10) return run_k<10>(p, n_blocks, smem, blocks, stream);
  if (nu <= 16) return run_k<16>(p, n_blocks, smem, blocks, stream);
  if (nu <= 32) return run_k<32>(p, n_blocks, smem, blocks, stream);
  return cudaErrorInvalidValue;
}

inline bool fits(int H, int Hp, int S, int K) {
  return H >= 1 && H <= 32 * 32 && Hp >= 1 && Hp <= HPMAX && K >= 1
         && K <= KMAX && S >= 0;
}

}  // namespace let

extern "C" {

// Workspace floats per persistent block; the caller allocates
// n_blocks * this for ws and this for sums.
size_t linear_et_estep_ws_stride(int H, int K) {
  return let::ws_stride(H, K);
}

// Shared memory of a block of the E-step's rows kernel, whose state table
// (ops/linear_cuda.py::rows_tables) is table_ints long.
size_t linear_et_rows_smem_bytes(int H, int Hp, int S, int K,
                                 int table_ints) {
  return let::rows_smem_words(H, Hp, S, K, table_ints) * sizeof(float);
}

// Blocks of the rows kernel that one SM holds at once, into *blocks.
int linear_et_rows_blocks_per_sm(int H, int Hp, int S, int K, int table_ints,
                                 int* blocks) {
  if (!let::fits(H, Hp, S, K))
    return static_cast<int>(cudaErrorInvalidValue);
  let::RowsParams p{};
  p.H = H;
  p.K = K;
  return static_cast<int>(let::dispatch(
      p, 0, linear_et_rows_smem_bytes(H, Hp, S, K, table_ints), blocks,
      nullptr));
}

const char* linear_et_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The per-datapoint stage of the E-step.  P (N, H) holds y W and leaves
// as w <s>.  table: the state masks of ops/linear_cuda.py::rows_tables,
// vcounts (K, S) state-minor.
// sums = [ss (H*H) | s (H) | vc (K) | abs | y2 | n | F | F_true]
int linear_et_estep_rows(const float* y, const float* weight, float* P,
                         const float* gram, const int* table,
                         const float* vcounts, const float* absst,
                         const float* values, const float* log_odds,
                         const float* scal, float* F, float* ws, float* sums,
                         int N, int D, int H, int Hp, int S, int K,
                         int table_ints, int signed_select,
                         int collect_true, int n_blocks, void* stream) {
  if (!let::fits(H, Hp, S, K) || N < 1 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (N + let::RWARPS - 1) / let::RWARPS;
  let::RowsParams p{y, weight, P, gram, table, vcounts, absst, values,
                    log_odds, scal, F, ws, N, D, H, Hp, S, K, table_ints,
                    signed_select, collect_true, n_tiles};
  const size_t smem = linear_et_rows_smem_bytes(H, Hp, S, K, table_ints);
  cudaError_t e = let::dispatch(p, n_blocks, smem, nullptr, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t stride = let::ws_stride(H, K);
  let::reduce_blocks<<<(unsigned)((stride + 255) / 256), 256, 0, s>>>(
      ws, sums, stride, n_blocks, H);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
