// Node-packed whole-traversal pruning for Hopper (sm_90a).
//
// pllmod_packed_walk replaces the TPU kernel
// pllmod_tpu/ops/pallas_clv.py::_make_packed_kernel (call in
// update_partials_packed). The schedule (ops/packed.py PackedSchedule)
// orders every level of a LevelSchedule by its consumers and pads it to a
// multiple of G = 128 / (C*S) rows with dummy rows (tip 0 on both sides,
// edge 0); row r writes slot r of clvs [n_rows, C*S, Ppad] and scalers
// [n_rows, Ppad]. Row r's columns in idxm [n_rows, 6] are (slot1, is_tip1,
// slot2, is_tip2, tip1, tip2); its matrices are P[e1[r]] and P[e2[r]] of
// P [E, C, S, S].
//
// Design. One CTA owns a tile of T pattern columns and walks every row in
// order; thread (c, p) owns category c of pattern p. For each row it reads
// the S values of both children (a tip from its code through the code ->
// CLV table, an inner child from its padded slot), applies the two S x S
// matrices (staged in shared memory when they fit), multiplies, exchanges
// its category maximum through shared memory, rescales and writes the row
// and its cumulative scaler. A thread only reads slot values that it
// wrote itself (the same rows c*S.., the same pattern p), so no fence
// separates the levels: idxg's fence column has no work to do here, and
// its contiguous-gather columns (4-7), a device of the TPU kernel to cut
// its DMA count, are ignored. The TPU kernel's block-diagonal [G*C*S,
// G*C*S] packs, its kron(I_G, codetab) one-hot expansion dot, its
// semaphores and parity double buffer have no counterpart: they exist to
// fill the TPU's 128-wide matrix unit and to overlap its DMAs.
//
// Exactness: the walks' contract of csrc/common.cuh (products and sums
// rounded separately in state order, the bit-formula rescale clipped to
// [-125, 127], pallas_clv.py:1648-1655), so the kernel equals its plain
// version in ops/packed.py bit for bit on every slot, the dummy rows'
// included.
//
// Bound on the H100 at the flagship (128 taxa x 16384 patterns GTR+G4,
// C*S = 16, G = 8; chip_smoke.py computes the exact figure from the run's
// tables): bytes. Every padded row writes its CLV and scaler rows once
// (~n_rows x 17 x 16384 x 4 B, ~150 MB) and the tip codes are read once
// (8.4 MB): ~45 us at 3.35 TB/s, against ~0.4 GFLOP (~6 us at 67 TFLOP/s).
// As designed each inner child is also read back once by its consumer
// (~65 MB more), and the dummy rows are extra work. One CTA walks all rows
// of its tile one after another, so at 4096 patterns with C = 4 only 64
// CTAs run on 132 SMs; the first speed step is more CTAs a pattern tile.
#include "common.cuh"

namespace {

using common::kMaxThreads;

// idxm columns
constexpr int kSlot1 = 0, kIsTip1 = 1, kSlot2 = 2, kIsTip2 = 3, kTip1 = 4,
              kTip2 = 5;

struct PackedArgs {
  const int* idxm;       // [n_rows, 6]
  const int* e1;         // [n_rows]
  const int* e2;         // [n_rows]
  int n_rows;
  const float* P;        // [E, C, S, S]
  int E;
  const int* codes;      // [n_tips, Ppad]
  int n_tips;
  const float* codetab;  // [n_codes, S]
  int n_codes;
  float* clvs;           // [n_rows, C*S, Ppad]
  int* scalers;          // [n_rows, Ppad]
  int Ppad, C, S, T;
};

// Shared memory beside the category maxima [C][T]: the code table and one
// row's two matrices.
size_t stage_floats(int C, int S, int n_codes) {
  return (size_t)n_codes * S + (size_t)2 * C * S * S;
}

// One child of a row: its S values of category c at pattern p, and its
// scaler (read by category 0 only, which alone writes scalers).
template <int MAXS>
__device__ __forceinline__ void load_child(const PackedArgs& a,
                                           const float* tab, int is_tip,
                                           int tip, int slot, int c, int p,
                                           float (&x)[MAXS], int& sc) {
  if (is_tip != 0) {
    tip = min(max(tip, 0), a.n_tips - 1);
    common::load_tip<MAXS>(tab, a.codes[(size_t)tip * a.Ppad + p], a.n_codes,
                           a.S, x);
    sc = 0;
    return;
  }
  slot = min(max(slot, 0), a.n_rows - 1);
  common::load_column<MAXS>(
      a.clvs + ((size_t)slot * a.C * a.S + c * a.S) * a.Ppad + p, a.Ppad, a.S,
      x);
  sc = (c == 0) ? a.scalers[(size_t)slot * a.Ppad + p] : 0;
}

template <int MAXS, bool STAGE>
__global__ void __launch_bounds__(kMaxThreads)
packed_walk(PackedArgs a) {
  extern __shared__ float smem[];
  const int T = a.T, C = a.C, S = a.S, CS = C * S;
  const size_t msz = (size_t)C * S * S;
  const int tid = threadIdx.x;
  const int c = tid / T;
  const int pl = tid - c * T;
  const int p = blockIdx.x * T + pl;
  const int nthr = blockDim.x;
  float* red = smem;                        // [C][T]
  float* tab_s = red + C * T;               // [n_codes * S]
  float* P_s = tab_s + a.n_codes * S;       // [2][C*S*S]
  if (STAGE)
    for (int i = tid; i < a.n_codes * S; i += nthr) tab_s[i] = a.codetab[i];
  const float* tab = STAGE ? tab_s : a.codetab;

  for (int r = 0; r < a.n_rows; ++r) {
    const int* row = a.idxm + 6 * (size_t)r;
    const float* P1 = a.P + (size_t)min(max(a.e1[r], 0), a.E - 1) * msz;
    const float* P2 = a.P + (size_t)min(max(a.e2[r], 0), a.E - 1) * msz;
    if (STAGE) {
      for (size_t i = tid; i < msz; i += nthr) {
        P_s[i] = P1[i];
        P_s[msz + i] = P2[i];
      }
    }
    __syncthreads();                        // matrices (and table) staged
    const float* Pa = (STAGE ? P_s : P1) + c * S * S;
    const float* Pb = (STAGE ? P_s + msz : P2) + c * S * S;
    float x1[MAXS], x2[MAXS], o[MAXS];
    int sc1, sc2;
    load_child<MAXS>(a, tab, row[kIsTip1], row[kTip1], row[kSlot1], c, p, x1,
                     sc1);
    load_child<MAXS>(a, tab, row[kIsTip2], row[kTip2], row[kSlot2], c, p, x2,
                     sc2);
    const float mx = common::child_product<MAXS>(Pa, Pb, S, x1, x2, o);
    const int e = common::rescale_exponent(red, mx, c, pl, C, T);
    common::store_scaled<MAXS>(a.clvs + ((size_t)r * CS + c * S) * a.Ppad + p,
                               a.Ppad, S, o, e);
    if (c == 0) a.scalers[(size_t)r * a.Ppad + p] = sc1 + sc2 + e;
  }
}

template <int MAXS>
int launch_t(const PackedArgs& a, cudaStream_t stream) {
  const size_t stage = stage_floats(a.C, a.S, a.n_codes);
  const bool staged = common::fits_smem((size_t)a.C * a.T + stage);
  const size_t smem = 4 * ((size_t)a.C * a.T + (staged ? stage : 0));
  return common::launch_kernel(
      staged ? packed_walk<MAXS, true> : packed_walk<MAXS, false>,
      dim3(a.Ppad / a.T), dim3(a.C * a.T), smem, stream, a);
}

}  // namespace

// Returns the CUDA error code of the launch (0 = queued).
extern "C" int pllmod_packed_walk(
    const int* idxm, const int* e1, const int* e2, int n_rows, const float* P,
    int E, const int* codes, int n_tips, const float* codetab, int n_codes,
    float* clvs, int* scalers, int Ppad, int C, int S, int T, void* stream) {
  if (C * T > kMaxThreads || T <= 0 || Ppad % T != 0 || n_rows <= 0 ||
      E <= 0)
    return (int)cudaErrorInvalidConfiguration;
  PackedArgs a{idxm, e1, e2, n_rows, P, E, codes, n_tips, codetab, n_codes,
               clvs, scalers, Ppad, C, S, T};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return common::dispatch_states(
      S, [&](auto m) { return launch_t<decltype(m)::value>(a, st); });
}
