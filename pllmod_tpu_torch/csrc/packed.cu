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
// Design: the group-window walk of csrc/group_walk.cuh, whose header
// holds the device code; this file says where a row's children and output
// live (PackedRows). The windows are the schedule's padded levels
// (PackedSchedule.windows: a row reads only slots of earlier levels), so
// R rows of a level are in flight at once, their category maxima behind
// one barrier; the pre-pass builds side s = 2r + k's table from P[e_k[r]]
// directly (no gathered matrices), and a tip child is a lookup. The TPU
// kernel's block-diagonal [G*C*S, G*C*S] packs, its kron(I_G, codetab)
// one-hot expansion dot, its semaphores, parity double buffer and idxg's
// contiguous-gather columns have no counterpart: they exist to fill the
// TPU's 128-wide matrix unit and to overlap its DMAs.
//
// Exactness: the walks' contract of csrc/common.cuh (products and sums
// rounded separately in state order, the bit-formula rescale clipped to
// [-125, 127], pallas_clv.py:1648-1655), so the kernel equals its plain
// version in ops/packed.py bit for bit on every slot, the dummy rows'
// included.
//
// Bound on the H100 at the flagship (128 taxa x 16384 patterns GTR+G4,
// C*S = 16, G = 8; chip_smoke.py computes the exact figure from the run's
// tables): bytes. The 126 real rows write their CLV and scaler rows once
// (~140 MB) and the tip codes are read once (8.4 MB): ~45 us at 3.35
// TB/s, against ~0.4 GFLOP (~6 us at 67 TFLOP/s). As designed each inner
// child is also read back once by its consumer (~65 MB more, much of it
// from L2), and the dummy rows (90 of 216) write too. At protein (512 x
// 4096, C*S = 80, G = 1, no dummies) ~0.21 ms of bytes against ~0.1 ms of
// operations (0.2 ms at the issue rate of separately rounded products
// and sums).
#include "group_walk.cuh"

namespace {

// idxm columns
constexpr int kSlot1 = 0, kIsTip1 = 1, kTip1 = 4;

struct PackedRows {
  const int* idxm;  // [n_rows, 6]
  const int* e1;    // [n_rows]
  const int* e2;    // [n_rows]
  int n_rows;
  const float* P;   // [E, C, S, S]
  int E, n_tips;
  long long msz;    // C * S * S

  __device__ group_walk::Child child(int r, int k) const {
    const int* row = idxm + 6 * (size_t)r;
    if (row[kIsTip1 + 2 * k] != 0)
      return {min(max(row[kTip1 + k], 0), n_tips - 1), 0};
    return {-1, min(max(row[kSlot1 + 2 * k], 0), n_rows - 1)};
  }
  __device__ int out(int r) const { return r; }
  __device__ long long side(int r, int k) const { return 2LL * r + k; }
  // the pre-pass's view of side s = 2r + k
  __device__ bool is_tip(int s) const {
    return idxm[6 * (size_t)(s >> 1) + kIsTip1 + 2 * (s & 1)] != 0;
  }
  __device__ const float* matrix(int s) const {
    const int e = ((s & 1) ? e2 : e1)[s >> 1];
    return P + (size_t)min(max(e, 0), E - 1) * msz;
  }
};

}  // namespace

// The pre-pass into mats [2 * n_rows, Q] and the row table into rowtab
// [n_rows, 8] (scratch of the caller), then the walk over windows
// [n_windows + 1] (row offsets) at tile T with R lanes. Returns the CUDA
// error code of the launches (0 = queued).
extern "C" int pllmod_packed_walk(
    const int* idxm, const int* e1, const int* e2, int n_rows, const float* P,
    int E, const int* codes, int n_tips, const float* codetab, int n_codes,
    float* clvs, int* scalers, int Ppad, int C, int S, int T, int R,
    const int* windows, int n_windows, float* mats, int* rowtab,
    void* stream) {
  if (n_rows <= 0 || E <= 0 || n_tips <= 0)
    return (int)cudaErrorInvalidValue;
  const PackedRows rows{idxm, e1, e2, n_rows, P, E, n_tips,
                        (long long)C * S * S};
  return group_walk::run<6>(rows, 2 * n_rows, n_rows, n_rows, windows,
                            n_windows, codes, codetab, n_codes, clvs,
                            scalers, Ppad, C, S, T, R, mats, rowtab,
                            static_cast<cudaStream_t>(stream));
}
