// Grouped whole-traversal pruning for Hopper (sm_90a), with
// consumer-targeted writes.
//
// pllmod_grouped_walk replaces the TPU kernel
// pllmod_tpu/ops/pallas_grouped.py::_make_grouped_kernel. The schedule
// (ops/grouped.py GroupedSchedule) packs the inner nodes into nG groups
// of G members, every child produced in a strictly earlier group. Group g
// owns an input buffer of Q = 2G child positions, bufs[g] [Q, C*S, Ppad]
// with scalers sbufs[g] [Q, Ppad] (child k of member m at q = k*G + m);
// side_meta [nG, Q, 2] says whether a position is a tip (and which), and
// dst_meta [nG, G, 2] where member m writes its result: (dst_group,
// dst_q), the position its single consumer reads. The two root-edge
// endpoints land in buffer nG at q = 0 and 1; dummy members (tip/tip)
// write rotating trash positions of it.
//
// Design. One CTA owns a tile of T pattern columns and walks the groups
// in order, and the members of a group one after another; thread (c, p)
// owns category c of pattern p. For each member it reads the S values of
// both children (a tip from its code through the code -> CLV table, an
// inner child from its position in the group's buffer), applies the two
// per-child S x S matrices (PQ [nG, Q, C, S, S], staged in shared memory
// when they fit), multiplies, exchanges its category maximum through
// shared memory, rescales and writes the result and the cumulative scaler
// to (dst_group, dst_q). A thread only reads buffer values that it wrote
// itself (the same rows c*S.., the same pattern p), so no barrier
// separates the groups; two a member guard the shared maxima and
// matrices. The TPU kernel's DMA semaphores, read lookahead, all-fence
// mode, tile-major buffers and probe knobs have no counterpart: patterns
// are independent, and one CTA never waits on another.
//
// Exactness: the walks' contract of csrc/common.cuh (products and sums
// rounded separately in state order, the bit-formula rescale clipped to
// [-125, 127], pallas_grouped.py:378-385), so the kernel equals its plain
// version in ops/grouped.py bit for bit on every position a member
// writes.
//
// Bound on the H100 at the flagship (128 taxa x 16384 patterns GTR+G4,
// C*S = 16, G = 4, nG = 35; chip_smoke.py computes the exact figure from
// the run's tables): bytes. Each of the 126 real members writes its CLV
// and scaler rows once (126 x 17 x 16384 x 4 B = 140 MB) and the tip
// codes are read once (8.4 MB): ~45 us at 3.35 TB/s, against ~0.4 GFLOP
// (~6 us at 67 TFLOP/s). As designed each inner child is also read back
// once by its consumer (~66 MB more).
#include "common.cuh"

namespace {

using common::kMaxThreads;

struct GroupedArgs {
  const int* side_meta;  // [nG, Q, 2] (is_tip, tip)
  const int* dst_meta;   // [nG, G, 2] (dst_group, dst_q)
  int nG, G;
  const float* PQ;       // [nG, Q, C, S, S]
  const int* codes;      // [n_tips, Ppad]
  int n_tips;
  const float* codetab;  // [n_codes, S]
  int n_codes;
  float* bufs;           // [nG + 1, Q, C*S, Ppad]
  int* sbufs;            // [nG + 1, Q, Ppad]
  int Ppad, C, S, T;
};

// Shared memory beside the category maxima [C][T]: the code table and one
// member's two matrices.
size_t stage_floats(int C, int S, int n_codes) {
  return (size_t)n_codes * S + (size_t)2 * C * S * S;
}

// The child at position q of group g: its S values of category c at
// pattern p, and its scaler (read by category 0 only).
template <int MAXS>
__device__ __forceinline__ void load_child(const GroupedArgs& a,
                                           const float* tab, int g, int q,
                                           int c, int p, float (&x)[MAXS],
                                           int& sc) {
  const int S = a.S, Q = 2 * a.G;
  const int* side = a.side_meta + ((size_t)g * Q + q) * 2;
  if (side[0] != 0) {
    const int tip = min(max(side[1], 0), a.n_tips - 1);
    common::load_tip<MAXS>(tab, a.codes[(size_t)tip * a.Ppad + p], a.n_codes,
                           S, x);
    sc = 0;
    return;
  }
  const size_t pos = (size_t)g * Q + q;
  common::load_column<MAXS>(a.bufs + (pos * a.C * S + c * S) * a.Ppad + p,
                            a.Ppad, S, x);
  sc = (c == 0) ? a.sbufs[pos * a.Ppad + p] : 0;
}

template <int MAXS, bool STAGE>
__global__ void __launch_bounds__(kMaxThreads)
grouped_walk(GroupedArgs a) {
  extern __shared__ float smem[];
  const int T = a.T, C = a.C, S = a.S, CS = C * S, G = a.G, Q = 2 * G;
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

  for (int g = 0; g < a.nG; ++g) {
    for (int m = 0; m < G; ++m) {
      const float* P1 = a.PQ + ((size_t)g * Q + m) * msz;
      const float* P2 = a.PQ + ((size_t)g * Q + G + m) * msz;
      if (STAGE) {
        for (size_t i = tid; i < msz; i += nthr) {
          P_s[i] = P1[i];
          P_s[msz + i] = P2[i];
        }
      }
      __syncthreads();                      // matrices (and table) staged
      const float* Pa = (STAGE ? P_s : P1) + c * S * S;
      const float* Pb = (STAGE ? P_s + msz : P2) + c * S * S;
      float x1[MAXS], x2[MAXS], o[MAXS];
      int sc1, sc2;
      load_child<MAXS>(a, tab, g, m, c, p, x1, sc1);
      load_child<MAXS>(a, tab, g, G + m, c, p, x2, sc2);
      const float mx = common::child_product<MAXS>(Pa, Pb, S, x1, x2, o);
      const int e = common::rescale_exponent(red, mx, c, pl, C, T);
      const int* dst_m = a.dst_meta + ((size_t)g * G + m) * 2;
      const int dg = min(max(dst_m[0], 0), a.nG);
      const int dq = min(max(dst_m[1], 0), Q - 1);
      const size_t pos = (size_t)dg * Q + dq;
      common::store_scaled<MAXS>(a.bufs + (pos * CS + c * S) * a.Ppad + p,
                                 a.Ppad, S, o, e);
      if (c == 0) a.sbufs[pos * a.Ppad + p] = sc1 + sc2 + e;
    }
  }
}

template <int MAXS>
int launch_t(const GroupedArgs& a, cudaStream_t stream) {
  const size_t stage = stage_floats(a.C, a.S, a.n_codes);
  const bool staged = common::fits_smem((size_t)a.C * a.T + stage);
  const size_t smem = 4 * ((size_t)a.C * a.T + (staged ? stage : 0));
  return common::launch_kernel(
      staged ? grouped_walk<MAXS, true> : grouped_walk<MAXS, false>,
      dim3(a.Ppad / a.T), dim3(a.C * a.T), smem, stream, a);
}

}  // namespace

// Returns the CUDA error code of the launch (0 = queued).
extern "C" int pllmod_grouped_walk(
    const int* side_meta, const int* dst_meta, int nG, int G, const float* PQ,
    const int* codes, int n_tips, const float* codetab, int n_codes,
    float* bufs, int* sbufs, int Ppad, int C, int S, int T, void* stream) {
  if (C * T > kMaxThreads || T <= 0 || Ppad % T != 0 || nG <= 0 || G <= 0)
    return (int)cudaErrorInvalidConfiguration;
  GroupedArgs a{side_meta, dst_meta, nG, G, PQ, codes, n_tips, codetab,
                n_codes, bufs, sbufs, Ppad, C, S, T};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return common::dispatch_states(
      S, [&](auto m) { return launch_t<decltype(m)::value>(a, st); });
}
