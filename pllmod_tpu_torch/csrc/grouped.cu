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
// Design: the group-window walk of csrc/group_walk.cuh, whose header
// holds the device code; this file says where a member's children and
// output live (GroupedRows). The schedule's own group order chains nearly
// every group to the one before (it schedules the tallest ready node
// first: 35 windows of one group at the flagship), and a member's result
// does not depend on its group, so the walk visits the members in the
// level order of their dependencies (GroupedSchedule.order: walk row r is
// member order[r] = g * G + m), and a window is a level of that order
// (GroupedSchedule.windows): R members in flight at once, their category
// maxima behind one barrier. The pre-pass builds the table of position (g,
// q) from PQ[g, q] directly, and a tip child is a lookup. Every dummy
// member computes the same values (tip 0 on both sides, edge 0's
// matrices), so two dummies writing one trash position in one window
// write the same bits. The TPU kernel's DMA semaphores, read lookahead,
// all-fence mode, tile-major buffers and probe knobs have no counterpart.
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
// once by its consumer (~66 MB more, much of it from L2).
#include "group_walk.cuh"

namespace {

struct GroupedRows {
  const int* side_meta;  // [nG, Q, 2] (is_tip, tip)
  const int* dst_meta;   // [nG, G, 2] (dst_group, dst_q)
  const int* order;      // [nG * G] the walk's member order
  int nG, G;
  const float* PQ;       // [nG, Q, C, S, S]
  int n_tips;
  long long msz;         // C * S * S

  // walk row r's member id g * G + m
  __device__ int member(int r) const {
    return min(max(order[r], 0), nG * G - 1);
  }
  __device__ group_walk::Child child(int r, int k) const {
    const int s = (int)side(r, k);
    const int* sm = side_meta + 2 * (size_t)s;
    if (sm[0] != 0) return {min(max(sm[1], 0), n_tips - 1), 0};
    return {-1, s};
  }
  __device__ int out(int r) const {
    const int Q = 2 * G;
    const int* dst = dst_meta + 2 * (size_t)member(r);
    return min(max(dst[0], 0), nG) * Q + min(max(dst[1], 0), Q - 1);
  }
  // position (g, k * G + m) of walk row r's child k: its side in mats
  __device__ long long side(int r, int k) const {
    const int mid = member(r), g = mid / G;
    return (long long)g * 2 * G + k * G + (mid - g * G);
  }
  // the pre-pass's view of position s = g * Q + q
  __device__ bool is_tip(int s) const { return side_meta[2 * s] != 0; }
  __device__ const float* matrix(int s) const { return PQ + s * msz; }
};

}  // namespace

// The pre-pass into mats [nG * Q, Q'] and the row table into rowtab
// [nG * G, 8] (scratch of the caller), then the walk of the members in
// order [nG * G] over windows [n_windows + 1] (walk-row offsets) at tile
// T with R lanes. Returns the CUDA error code of the launches (0 =
// queued).
extern "C" int pllmod_grouped_walk(
    const int* side_meta, const int* dst_meta, int nG, int G, const float* PQ,
    const int* codes, int n_tips, const float* codetab, int n_codes,
    float* bufs, int* sbufs, int Ppad, int C, int S, int T, int R,
    const int* order, const int* windows, int n_windows, float* mats,
    int* rowtab, void* stream) {
  if (nG <= 0 || G <= 0 || n_tips <= 0) return (int)cudaErrorInvalidValue;
  const GroupedRows rows{side_meta, dst_meta, order, nG, G, PQ, n_tips,
                         (long long)C * S * S};
  return group_walk::run<7>(rows, nG * 2 * G, nG * G, (nG + 1) * 2 * G,
                            windows, n_windows, codes, codetab, n_codes,
                            bufs, sbufs, Ppad, C, S, T, R, mats, rowtab,
                            static_cast<cudaStream_t>(stream));
}
