// Max-superposition (MCA / MMCA) ET E-step, hard winner, for sm_90a: the
// per-datapoint part and the multi-state routing.
//
// With sgemm.cu it replaces both TPU kernels of
// prosper_tpu/ops/max_pallas.py: max_et_estep_pallas (the (S, D, Ct) winner
// lattice resident in VMEM) and max_et_estep_pallas_dtiled (the same
// lattice in D blocks, two phases).  Together they compute what
// core/maxstep.py::max_et_estep computes for rho <= 0: per datapoint the
// top-H' candidates by P / ||W_h|| (|P| for MMCA), the winner lattice
// ybar_s[d] over the S multi states, the union softmax over
// [zero | H singletons | S multi states], F (and the un-annealed F_true),
// and the weight-masked sums numer (H, D) and denom (H, D) of the
// hard-winner responsibilities, s (H) and misc = [abs, resid, y2, n, F,
// F_true].  The wrapper (ops/max_cuda.py::max_et_estep_cuda) runs:
//
//   1. sgemm_nn          P = y W                         (N, H), sgemm.cu
//   2. max_estep_kernel<H', MMCA, 0>, the rows kernel: everything per
//      datapoint but the routing; turns the row of P into w q_single in
//      place, writes each row's candidates and routing tables, and sums s,
//      misc and the singleton part of denom per block
//   3. max_estep_kernel<H', false, 1>, the routing kernel: the multi
//      states' part of numer and denom
//   4. sgemm_tn_splitn   numer += (w q_single)^T y       (H, D), sgemm.cu
//
// with reduce_blocks summing each kernel's per-block slices in order.
// Both kernels carry the name max_estep_kernel (the benchmark's trace
// classes them by it).
//
// What bounds the work on the H100: latency, in both kernels.  The rows
// kernel waits on the front end's candidate selection (H' dependent
// arg-maxes over H scores a row, each a warp reduction) and on its softmax
// and row sums; the lattice itself is a compare-select and two
// floating-point operations per state and dimension, about 7 * 10^10
// lane-instructions for 10^6 rows at the patches width (D=256, H=300,
// H'=6, S=35), a few milliseconds of the card's arithmetic.  The routing
// kernel waits on its loads from the L2 (each datapoint's candidate values,
// routing tables and y, per block of columns) and on its barriers.
//
// What the design does about it:
// * The rows kernel is a template on H' and the MMCA flag, one
//   instantiation for each H' <= 8.  The multi states of
//   binary_state_space(H', gamma) are, in order, the first S states of the
//   whole lattice over the H' slots (by size, then lexicographically), so
//   each state's parent (itself less its largest slot), added slot and
//   position are constants of the compiled code; S stays a run-time cut
//   (the wrapper checks that the state table is that prefix).  No plan is
//   read at run time.  Its 80 registers and 62 KB of shared memory a block
//   at the patches width leave three blocks (24 warps) an SM.
// * Phase 0, one warp a datapoint, each lane its own dimensions d: the H'
//   candidate values W[d, cand_a] sit in registers and the lattice is
//   walked depth first, so that a state's winner value is one
//   compare-select of its parent's value (a register) against the added
//   slot's, ties to the parent: the added slot wins only where its key is
//   strictly greater, as in core/maxstep.py.  The lane sums
//   ybar_s (2 y_d - ybar_s) for every state in a register (the
//   likelihood needs only this combination of y.ybar_s and ||ybar_s||^2),
//   in passes of at most 40 states, so that the sums fit the registers of
//   three blocks an SM (the patches width takes one pass).  A fixed-order
//   butterfly that halves the values at each step (a transposed
//   reduction) then leaves state s's sum in lane s mod 32; a group of at
//   most eight states is reduced by warp_sum each.  No shared memory is
//   touched in the walk.
// * The routing does not walk the lattice.  The states slot a wins at d
//   are those that contain a and whose other slots all rank below a at d
//   (by key, ties to the earlier slot).  So per datapoint the rows kernel
//   builds, after the softmax, the table T[a][B] = sum of w q_s over the
//   states s that contain a and lie within a | B, for every subset B of the
//   other H' - 1 slots (a subset-sum transform in registers and shuffles),
//   and writes it with the row's candidates.  The routing kernel gives a
//   block 32 columns d (a lane each) and a chunk of rows, and keeps its
//   columns of numer and denom, for all H units, in shared memory over the
//   whole chunk.  Per batch of 32 rows each warp ranks four rows' H'
//   candidate values at its columns (H'(H'-1)/2 compares give each slot
//   the set B of slots below it) and picks each slot's mass T[a][B]; then
//   warp c adds the masses, and the masses times y, of the units
//   h = c (mod 8), found by a ballot over the batch's rows, so that each
//   sum has one writer and takes the rows in order.  The sums leave shared
//   memory once a chunk: a single kernel that added every datapoint's H'
//   masses to a workspace slice of H x D per block in device memory moved
//   several GB an iteration at 10^6 rows, more than half of its time.
// * Blocks run in parallel and in no order, so each block (persistent, as
//   many as the card holds at once, in the rows kernel; one per columns,
//   units and chunk in the routing kernel) sums into its own workspace
//   slice, and reduce_blocks sums the slices in block order.  No float
//   atomics: the sums are deterministic, and with collect_true off at beta
//   = 1 they are bit-identical to those with it on.
// * The singleton part of denom, sum_n w_n q_nh, does not depend on d: the
//   rows kernel sums it as an H-vector, and the routing kernel's first
//   chunk starts its denom from it.
//
// Numerics: as linear_et_frontend.cuh (no fast math, -fmad=false, fmaf
// only in sums of products).  The sums over d and over the states are
// taken in another order than core/maxstep.py's, in one fixed order.

#include "max_et_estep.cuh"

namespace mxe {

// the instantiations of max_et_estep_hp*.cu
extern template cudaError_t run<2>(const Launch&, int, float*, int*);
extern template cudaError_t run<3>(const Launch&, int, float*, int*);
extern template cudaError_t run<4>(const Launch&, int, float*, int*);
extern template cudaError_t run<5>(const Launch&, int, float*, int*);
extern template cudaError_t run<7>(const Launch&, int, float*, int*);
extern template cudaError_t run<8>(const Launch&, int, float*, int*);
template cudaError_t run<6>(const Launch&, int, float*, int*);

cudaError_t dispatch(int hp, const Launch& l, int magnitude, float* sums,
                     int* blocks) {
  switch (hp) {
    case 2: return run<2>(l, magnitude, sums, blocks);
    case 3: return run<3>(l, magnitude, sums, blocks);
    case 4: return run<4>(l, magnitude, sums, blocks);
    case 5: return run<5>(l, magnitude, sums, blocks);
    case 6: return run<6>(l, magnitude, sums, blocks);
    case 7: return run<7>(l, magnitude, sums, blocks);
    case 8: return run<8>(l, magnitude, sums, blocks);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mxe

extern "C" {

// Workspace floats: a block of the rows kernel, a chunk of the routing
// kernel.  sums takes the second and then the first (s, misc and the
// singleton denom after numer and denom).
size_t max_et_ws_a_stride(int H) { return mxe::ws_a_stride(H); }
size_t max_et_ws_b_stride(int D, int H) { return mxe::ws_b_stride(D, H); }

// shared memory a block of the rows kernel, of the routing kernel
size_t max_et_smem_bytes(int D, int H, int Hp, int S) {
  return mxe::rows_smem_bytes(D, H, Hp, S);
}
size_t max_et_route_smem_bytes(int Hp, int hcols) {
  return mxe::route_smem_bytes(Hp, hcols);
}

// Blocks of the rows kernel (blocks[0]) and of the routing kernel
// (blocks[1]) that one SM holds at once.
int max_et_blocks_per_sm(int D, int H, int Hp, int S, int hcols,
                         int magnitude, int* blocks) {
  if (Hp < 2 || Hp > mxe::HPM || S > mxe::lattice_states(Hp))
    return static_cast<int>(cudaErrorInvalidValue);
  mxe::Launch l{};
  l.smem_rows = mxe::rows_smem_bytes(D, H, Hp, S);
  l.smem_route = mxe::route_smem_bytes(Hp, hcols);
  return static_cast<int>(mxe::dispatch(Hp, l, magnitude, nullptr, blocks));
}

// P (N, H) holds y W and leaves as w q_single.  sums = [numer (H*D) |
// denom (H*D) | s (H) | abs | resid | y2 | n | F | F_true | the singleton
// denom (H)]; numer lacks its singleton part (w q_single)^T y, which the
// caller adds.  WT is W transposed (H, D); states is (Hp, S) state-minor
// and must be the first S states of binary_state_space(Hp, Hp); log_odds
// has one entry and values is [1.0].  wsA: n_blocks * max_et_ws_a_stride
// floats, wsB: n_chunks * max_et_ws_b_stride, T: N * Hp * 2^(Hp-1) floats,
// cand: N * Hp ints.  The routing kernel takes chunks of chunk_rows rows
// and hcols units a block.
int max_et_estep(const float* y, const float* weight, float* P,
                 const float* WT, const float* gdiag, const float* states,
                 const float* absst, const float* values,
                 const float* log_odds, const float* scal, float* F,
                 float* wsA, float* wsB, float* T, int* cand, float* sums,
                 int N, int D, int H, int Hp, int S, int magnitude,
                 int collect_true, int n_blocks, int chunk_rows, int hcols,
                 void* stream) {
  if (Hp < 2 || Hp > mxe::HPM || S > mxe::lattice_states(Hp) ||
      chunk_rows < 1 || hcols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  mxe::Launch l{};
  l.p.y = y;
  l.p.weight = weight;
  l.p.P = P;
  l.p.WT = WT;
  l.p.gdiag = gdiag;
  l.p.t = let::Tables{nullptr, states, nullptr, nullptr, absst, values,
                      log_odds, scal};
  l.p.d = let::Dims{N, D, H, Hp, S, 1, 1 + H + S, magnitude, collect_true};
  l.p.F = F;
  l.p.wsA = wsA;
  l.p.wsB = wsB;
  l.p.T = T;
  l.p.cand = cand;
  l.p.n_tiles = (N + mxe::TILE - 1) / mxe::TILE;
  l.p.chunk_rows = chunk_rows;
  l.p.hcols = hcols;
  l.nb = n_blocks;
  l.n_chunks = (N + chunk_rows - 1) / chunk_rows;
  l.hgroups = (H + hcols - 1) / hcols;
  l.smem_rows = mxe::rows_smem_bytes(D, H, Hp, S);
  l.smem_route = mxe::route_smem_bytes(Hp, hcols);
  l.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(mxe::dispatch(Hp, l, magnitude, sums, nullptr));
}

}  // extern "C"
