// The resident pruning kernel for Hopper (sm_90a): a whole post-order
// traversal of CLV (conditional likelihood vector) updates in one launch,
// the live CLVs in shared memory.
//
// pllmod_resident_walk replaces the TPU kernel
// pllmod_tpu/ops/pallas_resident.py::_make_resident_kernel. The live CLV
// slots of a Sethi-Ullman slot-recycled schedule (ops/resident.py
// compile_resident: ~ceil(log2 n_tips)+3 slots) stay in shared memory as
// [NS][C*S][T] floats with their int32 scaler rows; only the last row (the
// root pseudo-node, (f*clv_u) x (P_root clv_v)) writes to device memory:
// prod [C*S, Ppad] and the total scaler [Ppad]. (The fused walk, which
// leaves every CLV in device memory, is csrc/fused.cu.)
//
// Design. One call launches the fused walk's pre-pass (csrc/tables.cuh:
// every row side's matrix transposed, M[c][j][i] = P[c][i][j], or for a
// tip child its table PT[c][code][i] = row_dot(P_c, i, codetab[code]),
// into the caller's scratch mats [nW, 2, Q]) and then the walk. One CTA
// owns a tile of T pattern columns and walks every idx8 row in order;
// pattern columns are independent, so no CTA waits on another. Thread
// (c, pg) owns category c of RP adjacent patterns and all S states of
// them (RP = 2 up to 4 states, else 1): it reads only slot values and
// scaler rows that it wrote itself, so an out slot may alias a child slot
// (slot recycling) and the slots need no barrier. A row's inputs that do
// not depend on the walk come through a ring of NB = 4 entries in shared
// memory, each filled NB - 1 rows ahead by TMA bulk copies that one
// thread issues and an mbarrier counts: the row's two tables and the
// tile's tip codes, and with them the idx8 row 2 (NB - 1) rows ahead (a
// ring of 16 rows). A tip child is then one lookup a pattern, an inner
// child a register-tiled product of its slot column (tile::product), and
// a row costs one barrier, the one its category maximum needs (the maxima
// alternate between two buffers by row parity). Where no ring of tables
// fits beside the slots (64 states +G4), the "global" kind reads the
// tables from mats and the ring holds the codes only, at the widest tile
// alone (wide_tile: every CTA reads every row's tables, so the fewest
// CTAs); it keeps small 64-state trees resident, and is the slower walk
// there (chip_smoke.py's routing sweep), so ops/engine.py's rule routes
// such trees to the fused walk. The pattern tile is chosen per shape
// (ops/_build.py resident_tile over walk_config of csrc/configs.h) so
// that the grid fills the card where the slots allow: at protein (512
// taxa, 4096 patterns, C*S = 80) T = 32, 128 CTAs.
//
// The thread kind (kThread: up to 4 states, at most kThreadMaxC
// categories) takes the barrier off the row chain. A consumer thread owns
// every category and state of its pattern column, so a pattern's maximum
// over categories is taken in its registers, and the CTA has no
// __syncthreads a row: a warp waits only for its row's ring entry. One
// producer warp, which does no arithmetic, fills the ring: for each row,
// once the consumer warps have released the entry (an "empty" mbarrier,
// one arrival a consumer warp), one lane writes the idx8 row into it and
// issues the bulk copies of the row's two tables and its tip codes on the
// entry's "full" mbarrier. In a post-order walk the row before a row with
// an inner child is that child's own row (75 % of the rows of a random
// 10,000-taxon tree), so the producer marks in the entry whether the next
// row takes this row's output, and the consumer then keeps that output in
// registers: it is never stored to its slot nor loaded back. The slot
// layout and the arithmetic are the tile kind's; a thread still reads
// only slot values and scaler rows that it wrote, so slots may alias
// without a barrier. Where the tile's patterns are not 16-byte aligned, a
// consumer loads its own tip codes from device memory. In the tile kind,
// thread 0 issued each row's copies inline and the row's barrier passed
// that delay to every warp (PERF.md §6 has the measurements).
//
// The split kind (kSplit: the ladder's 20-state step, protein, where C * T
// fills whole warps and T is even) is the tile kind with a row's work cut
// finer. At the 1KITE supermatrix's shape (144 taxa x 413,568 patterns,
// C*S = 80, T = 64) the tile kind is bound by the shared-memory data path,
// not by latency: its matrix loads are broadcasts, but the path moves 128
// bytes a cycle whatever the addresses, and five 16-byte loads a step j
// feed only 20 products and 20 sums. A consumer thread owns two patterns
// and 10 of their 20 output states (RI = 10, RP = 2): a step loads five
// 8-byte matrix pairs and one 8-byte slot pair for 20 products and 20
// sums, 11 data-path cycles a warp against 21. Its partner, lane l + 16
// of the same warp, owns the other 10 states: their matrix loads hit two
// addresses in distinct banks and their slot loads one; their maximum
// over states meets by a shuffle, so red keeps C maxima a pattern; and a
// thread reads child states that its partner stored, which a __syncwarp
// orders, where halves in different warps would need a named barrier a
// row. A producer warp after the consumers issues the ring's copies off
// the row chain (the tile kind's thread 0 issues them inline, and the
// row's barrier passes that delay to every warp); it waits on a row's
// entry, whose copy brought the idx8 row it reads next, and passes each
// row's CTA barrier, the one the maxima need, which also frees the entry
// it fills next. Budget: the tile kind's shared memory (141 KB at 4
// slots, one CTA an SM), 256 consumers and the producer, about 110 of
// the 224 registers that 288 threads allow, none spilled. Each output
// still sums j = 0..S-1 in order, rounded separately, so the bits are
// the tile kind's and the plain walk's (PERF.md §6 has the measurements).
//
// Measured on the H100 (chip_smoke.py; PERF.md): building a row's tip
// tables inside the CTA, which saves the pre-pass's launch, put ~1000
// cycles of table arithmetic on every row's chain at DNA; the pre-pass
// costs microseconds once a launch, so every state count takes it.
//
// Exactness. Products and sums are rounded separately (__fmul_rn /
// __fadd_rn, never contracted to FMA) in child-state order j = 0..S-1, a
// lookup is the same row_dot, and the rescale is the bit formula of
// pallas_resident.py:469-477 (csrc/common.cuh): the plain PyTorch version
// (ops/clv.py::walk_rows_plain) does the same operations in the same
// order, so kernel and plain version agree bit for bit.
//
// Bound on the H100 (chip_smoke.py computes the exact figure from the
// run's table): operations. At the flagship (128 taxa x 16384 patterns,
// GTR+G4, C*S = 16) ~0.36 GFLOP = 5.4 us at the 67 TFLOP/s float32
// non-tensor peak, against ~9.5 MB of codes, matrices and prod (2.8 us);
// at protein (512 x 4096, C*S = 80) ~7.2 GFLOP = 0.108 ms, and ~0.22 ms
// at the issue rate of separately rounded products and sums. At DNA the
// walk is a chain of 127 short rows, each bound by its latency.
#include "common.cuh"
#include "tables.cuh"
#include "tile.cuh"

namespace {

using namespace resident;

// [nW, 8] idx8 columns
constexpr int kSlot = 0, kIsTip = 2, kTip = 4, kOut = 6;
// the split kind's __launch_bounds__: at most kThreads consumers, and the
// producer warp
constexpr int kSplitThreads = kThreads + kWarp;

struct WalkArgs {
  const int* idx8;       // [nW, 8]
  int nW;
  const float* mats;     // [nW, 2, Q]: the pre-pass's tables
  const int* codes;      // [n_tips, Ppad]
  int n_codes;
  float* clv_out;        // prod [C*S, Ppad]
  int* sc_out;           // [Ppad]
  int Ppad, C, S, n_slots, T, SP;
  long long Q, ring;
};

// EXACT: S == MAXS, so that the state loops need no guard. The split
// kind (KIND == kSplit) runs kSplitH threads a column, each RI states,
// and a producer warp after them that issues the ring's copies.
template <int MAXS, int RP, int KIND, bool EXACT>
__device__ __forceinline__ void walk_rows(const WalkArgs& a) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool SPLIT = KIND == kSplit;
  constexpr int H = SPLIT ? kSplitH : 1, RI = MAXS / H, HW = kWarp / 2;
  const int T = a.T, C = a.C, S = EXACT ? MAXS : a.S, CS = C * S,
            nW = a.nW, SP = a.SP;
  // entry of row r issued at row r - D; the idx8 row r + F with it
  constexpr int D = kNB - 1, F = 2 * D;
  const int Q = (int)a.Q, R = (int)a.ring, n_codes = a.n_codes;
  const int tid = threadIdx.x, npg = T / RP;
  // thread (h, c, pl): states i0 .. i0 + RI - 1 of category c and
  // patterns pl .. pl + RP - 1; the split kind's two halves of a column
  // are lanes l and l + HW of one warp
  const int h = SPLIT ? (tid & (kWarp - 1)) / HW : 0;
  const int col = SPLIT ? tid / kWarp * HW + (tid & (HW - 1)) : tid;
  const int c = col / npg, pl = (col - c * npg) * RP, i0 = h * RI;
  const bool owner = c == 0 && h == 0;  // keeps the column's scaler
  const int p0 = blockIdx.x * T, p = p0 + pl;
  // who issues the ring's copies (its first thread) and loads unaligned
  // tip codes: the split kind's producer warp, after its H * C * npg
  // consumers, else the whole CTA (thread 0 issues)
  const int lead = SPLIT ? H * C * npg : 0;
  const bool loads = !SPLIT || tid >= lead;
  const int n_load = SPLIT ? kWarp : (int)blockDim.x;
  // the tip codes come by bulk copy where their rows are 16-byte aligned,
  // else by the issuing threads' own loads
  const bool vec = (T % 4 == 0) && (a.Ppad % 4 == 0);
  const int PR = KIND != kGlobal ? 2 * Q : 0;  // codes' offset in an entry
  auto* bars = reinterpret_cast<unsigned long long*>(smem);  // [kNB]
  int* meta = reinterpret_cast<int*>(smem + 2 * kNB);  // [16][8] rows
  float* ring = smem + 2 * kNB + 8 * kMetaRows;        // [kNB][R]
  float* red = ring + kNB * R;                         // [2][C][T]
  float* slots = red + (int)common::round4(2 * C * T);         // [NS][CS][T]
  int* ssc = reinterpret_cast<int*>(slots + (size_t)a.n_slots * CS * T);

  auto row_of = [&](int r) { return meta + 8 * (r & (kMetaRows - 1)); };
  auto slot = [&](int v) { return min(max(v, 0), a.n_slots - 1); };
  auto entry = [&](int r) { return ring + (r & (kNB - 1)) * R; };
  auto codes_of = [&](int r, int k) {
    return reinterpret_cast<int*>(entry(r) + PR) + k * T;
  };
  auto table = [&](int r, int k) -> const float* {
    return KIND != kGlobal ? entry(r) + k * Q
                         : a.mats + ((size_t)2 * r + k) * a.Q;
  };
  // row r's ring entry (its tables, its tip codes) and the idx8 row r + D
  // (= the row issued at r - D, plus F): bulk copies on the entry's
  // mbarrier, issued by thread `lead`; without 16-byte alignment the
  // codes are loaded by the loading threads, visible after the barrier of
  // the row that issues them
  auto issue = [&](int r) {
    if (r >= nW || !loads) return;
    const int* row = row_of(r);
    float* e = entry(r);
    unsigned long long* bar = bars + (r & (kNB - 1));
    const int valid = min(T, a.Ppad - p0);
    if (tid == lead) {
      unsigned bytes = 0;
      const int m = r + D;  // rows before F are loaded up front
      const bool fetch_meta = m >= F && m < nW;
      if (KIND != kGlobal)
        for (int k = 0; k < 2; ++k)
          bytes += 4u * C * (row[kIsTip + k] ? n_codes : S) * SP;
      if (vec)
        for (int k = 0; k < 2; ++k)
          if (row[kIsTip + k]) bytes += 4u * valid;
      if (fetch_meta) bytes += 32;
      tile::mbar_expect(bar, bytes);
      if (KIND != kGlobal)
        for (int k = 0; k < 2; ++k)
          tile::bulk_copy(e + k * Q, a.mats + ((size_t)2 * r + k) * a.Q,
                          4u * C * (row[kIsTip + k] ? n_codes : S) * SP,
                          bar);
      if (vec)
        for (int k = 0; k < 2; ++k)
          if (row[kIsTip + k])
            tile::bulk_copy(codes_of(r, k),
                            a.codes + (size_t)row[kTip + k] * a.Ppad + p0,
                            4u * valid, bar);
      if (fetch_meta) tile::bulk_copy(row_of(m), a.idx8 + 8 * m, 32, bar);
    }
    if (!vec)
      for (int k = 0; k < 2; ++k)
        if (row[kIsTip + k]) {
          const int* src = a.codes + (size_t)row[kTip + k] * a.Ppad + p0;
          for (int x = tid - lead; x < valid; x += n_load)
            codes_of(r, k)[x] = src[x];
        }
  };
  // wait for row r's ring entry (use r / kNB of its mbarrier)
  auto arrive = [&](int r) {
    tile::mbar_wait(bars + (r & (kNB - 1)), (unsigned)(r / kNB) & 1u);
  };

  if (tid == 0) {
    for (int i = 0; i < kNB; ++i) tile::mbar_init(bars + i, 1);
    tile::mbar_fence_init();
  }
  for (int i = tid; i < 8 * min(nW, F); i += blockDim.x) meta[i] = a.idx8[i];
  __syncthreads();
  for (int d = 0; d < D; ++d) issue(d);
  __syncthreads();  // the codes the threads loaded

  if (SPLIT && tid >= lead) {
    // the producer warp: row w's entry carries the idx8 row w + D that
    // issue reads; row w + D's entry is the one row w - 1 read, free
    // since that row's barrier; then this row's barrier
    for (int w = 0; w < nW; ++w) {
      arrive(w);
      issue(w + D);
      __syncthreads();
    }
    return;
  }
  PHASE_INIT
  for (int w = 0; w < nW; ++w) {
    PHASE_MARK(w, 0)
    arrive(w);
    PHASE_MARK(w, 1)
    if (!SPLIT) issue(w + D);
    PHASE_MARK(w, 2)
    const int* row = row_of(w);
    float o[RI][RP], o2[RI][RP];
    int sc[2][RP];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float(&acc)[RI][RP] = k ? o2 : o;
      const float* tb = table(w, k);
      if (row[kIsTip + k]) {
        tile::lookup<RI, RP>(tb + c * n_codes * SP, codes_of(w, k),
                             n_codes, SP, i0, pl, acc);
#pragma unroll
        for (int q = 0; q < RP; ++q) sc[k][q] = 0;
      } else {
        const int s = slot(row[kSlot + k]);
        tile::product<RI, RP, MAXS, EXACT>(tb + c * S * SP,
                                    slots + ((size_t)s * CS + c * S) * T,
                                    S, SP, T, i0, pl, acc);
#pragma unroll
        for (int q = 0; q < RP; ++q)
          sc[k][q] = owner ? ssc[s * T + pl + q] : 0;
      }
    }
    PHASE_MARK(w, 3)
    float m[RP];
#pragma unroll
    for (int q = 0; q < RP; ++q) m[q] = -INFINITY;
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int q = 0; q < RP; ++q) {
        o[i][q] = __fmul_rn(o[i][q], o2[i][q]);
        if (i0 + i < S) m[q] = fmaxf(m[q], o[i][q]);
      }
    // a column's maximum over its two halves' states meets in registers
    float* rd = red + (w & 1) * C * T;
    if constexpr (SPLIT)
#pragma unroll
      for (int q = 0; q < RP; ++q)
        m[q] = fmaxf(m[q], __shfl_xor_sync(~0u, m[q], HW));
    if (h == 0)
#pragma unroll
      for (int q = 0; q < RP; ++q) rd[c * T + pl + q] = m[q];
    PHASE_MARK(w, 4)
    __syncthreads();
    PHASE_MARK(w, 5)
    float mm[RP];
    tile::load_vec<RP>(mm, rd + pl);
#pragma unroll 4
    for (int k = 1; k < C; ++k) {
      float v[RP];
      tile::load_vec<RP>(v, rd + k * T + pl);
#pragma unroll
      for (int q = 0; q < RP; ++q) mm[q] = fmaxf(mm[q], v[q]);
    }
    int st[RP];
    float scale[RP];
#pragma unroll
    for (int q = 0; q < RP; ++q) {
      int e = ((__float_as_int(mm[q]) >> 23) & 0xFF) - 126;
      if (!(mm[q] > 0.f)) e = 0;
      e = min(max(e, -125), 127);
      scale[q] = __int_as_float((127 - e) << 23);
      st[q] = sc[0][q] + sc[1][q] + e;
    }
    if (w == nW - 1) {
      float* dst = a.clv_out + (size_t)(c * S + i0) * a.Ppad + p;
#pragma unroll
      for (int i = 0; i < RI; ++i)
        if (i0 + i < S)
#pragma unroll
          for (int q = 0; q < RP; ++q)
            if (p + q < a.Ppad)
              dst[(size_t)i * a.Ppad + q] = __fmul_rn(o[i][q], scale[q]);
      if (owner)
#pragma unroll
        for (int q = 0; q < RP; ++q)
          if (p + q < a.Ppad) a.sc_out[p + q] = st[q];
    } else {
      const int out = slot(row[kOut]);
      float* dst = slots + ((size_t)out * CS + c * S + i0) * T + pl;
#pragma unroll
      for (int i = 0; i < RI; ++i)
        if (i0 + i < S) {
          if constexpr (RP == 2) {
            *reinterpret_cast<float2*>(dst + i * T) =
                make_float2(__fmul_rn(o[i][0], scale[0]),
                            __fmul_rn(o[i][1], scale[1]));
          } else {
            dst[i * T] = __fmul_rn(o[i][0], scale[0]);
          }
        }
      if (owner)
#pragma unroll
        for (int q = 0; q < RP; ++q) ssc[out * T + pl + q] = st[q];
      // a later row reads every state of a child column, half of them
      // stored by the other half-warp
      if constexpr (SPLIT) __syncwarp();
    }
    PHASE_MARK(w, 6)
  }
  // the ring's last copies (issued past the end: none) have all landed
}

template <int MAXS, int RP, int KIND, bool EXACT>
__global__ void __launch_bounds__(kThreads) resident_kernel(WalkArgs a) {
  walk_rows<MAXS, RP, KIND, EXACT>(a);
}

template <bool EXACT>
__global__ void __launch_bounds__(kSplitThreads, 1) split_kernel(WalkArgs a) {
  walk_rows<kSplitMaxS, kSplitRP, kSplit, EXACT>(a);
}

// The thread kind: C categories (exact), EXACT: S == 4. Consumer thread
// tid < nc owns patterns pl = tid * RP .. pl + RP - 1 of the tile; the
// last warp is the producer. The entry's idx8 row carries, in place of
// its flag column, 1 + the side of the next row that takes this row's
// output (0: none), which the producer computes.
template <int C, bool EXACT>
__global__ void __launch_bounds__(kThreads) thread_kernel(WalkArgs a) {
  constexpr int MAXS = 4, RP = kThreadRP, NB = kThreadNB;
  extern __shared__ __align__(16) float smem[];
  const int T = a.T, S = EXACT ? MAXS : a.S, CS = C * S, nW = a.nW,
            SP = a.SP, Q = (int)a.Q, R = (int)a.ring, n_codes = a.n_codes;
  const int tid = threadIdx.x, nc = T / RP;
  const int p0 = blockIdx.x * T;
  // the tip codes come by bulk copy where their rows are 16-byte aligned
  // (T is a multiple of 32), else each consumer loads its own
  const bool vec = a.Ppad % 4 == 0;
  auto* full = reinterpret_cast<unsigned long long*>(smem);   // [NB]
  auto* empty = full + NB;                                    // [NB]
  // [NB][R]: the idx8 row, the two tables (Q each), two rows of T codes
  float* ring = smem + 4 * NB;
  float* slots = ring + NB * R;                               // [NS][CS][T]
  int* ssc = reinterpret_cast<int*>(slots + (size_t)a.n_slots * CS * T);
  const int codes_at = kRowInts + 2 * Q;   // codes' offset in an entry

  if (tid == 0) {
    for (int i = 0; i < NB; ++i) {
      tile::mbar_init(full + i, 1);
      tile::mbar_init(empty + i, nc / kWarp);
    }
    tile::mbar_fence_init();
  }
  __syncthreads();  // the only CTA barrier: the mbarriers' initialization
  PHASE_INIT_FOR(tid == 0 || tid == nc)
  auto slot = [&](int v) { return min(max(v, 0), a.n_slots - 1); };

  if (tid >= nc) {
    // the producer warp: lane l loads idx8 row r + l of each 32 rows, and
    // lane 0 fills row r's entry once the consumers have released it
    const int lane = tid - nc;
    const int valid = min(T, a.Ppad - p0);
    const int4* rows = reinterpret_cast<const int4*>(a.idx8);
    int4 lo = make_int4(0, 0, 0, 0), hi = lo;
    for (int r = 0; r < nW; ++r) {
      if ((r & (kWarp - 1)) == 0 && r + lane < nW) {
        lo = rows[2 * (r + lane)];
        hi = rows[2 * (r + lane) + 1];
      }
      const int src = r & (kWarp - 1), nxt = (src + 1) & (kWarp - 1);
      int4 m0, m1, n0;  // row r's idx8 row, and row r + 1's sides
      m0.x = __shfl_sync(~0u, lo.x, src);
      m0.y = __shfl_sync(~0u, lo.y, src);
      m0.z = __shfl_sync(~0u, lo.z, src);
      m0.w = __shfl_sync(~0u, lo.w, src);
      m1.x = __shfl_sync(~0u, hi.x, src);
      m1.y = __shfl_sync(~0u, hi.y, src);
      m1.z = __shfl_sync(~0u, hi.z, src);
      n0.x = __shfl_sync(~0u, lo.x, nxt);
      n0.y = __shfl_sync(~0u, lo.y, nxt);
      n0.z = __shfl_sync(~0u, lo.z, nxt);
      n0.w = __shfl_sync(~0u, lo.w, nxt);
      if (lane == 0) {
        PHASE_MARK(r, 5)
        if (nxt == 0 && r + 1 < nW) n0 = rows[2 * (r + 1)];
        // the entry's last int (the idx8 row's flag, unread here): 1 + the
        // side of row r + 1 that takes row r's output, or 0
        const int out = slot(m1.z);
        m1.w = r + 1 >= nW                        ? 0
               : !n0.z && slot(n0.x) == out      ? 1
               : !n0.w && slot(n0.y) == out      ? 2
                                                 : 0;
        const int e = r & (NB - 1);
        if (r >= NB) tile::mbar_wait(empty + e, (unsigned)(r / NB - 1) & 1u);
        PHASE_MARK(r, 6)
        float* en = ring + e * R;
        reinterpret_cast<int4*>(en)[0] = m0;
        reinterpret_cast<int4*>(en)[1] = m1;
        const int is_tip[2] = {m0.z, m0.w}, tip[2] = {m1.x, m1.y};
        unsigned bytes = 0;
        for (int k = 0; k < 2; ++k) {
          bytes += 4u * C * (is_tip[k] ? n_codes : S) * SP;
          if (vec && is_tip[k]) bytes += 4u * valid;
        }
        tile::mbar_expect(full + e, bytes);
        for (int k = 0; k < 2; ++k) {
          tile::bulk_copy(en + kRowInts + k * Q,
                          a.mats + ((size_t)2 * r + k) * a.Q,
                          4u * C * (is_tip[k] ? n_codes : S) * SP, full + e);
          if (vec && is_tip[k])
            tile::bulk_copy(en + codes_at + k * T,
                            a.codes + (size_t)tip[k] * a.Ppad + p0,
                            4u * valid, full + e);
        }
        PHASE_MARK(r, 7)
      }
      __syncwarp();
    }
    return;
  }

  const int pl = tid * RP, p = p0 + pl;
  // the previous row's output, where this row takes it as its side
  // take - 1 (in a post-order walk the row before a row with an inner
  // child is that child's own row): its rescaled values and its scaler
  // stay in registers, never stored to nor loaded from its slot
  float fw[C][MAXS][RP];
  int fwsc[RP], take = 0;
  for (int w = 0; w < nW; ++w) {
    PHASE_MARK(w, 0)
    const int e = w & (NB - 1);
    tile::mbar_wait(full + e, (unsigned)(w / NB) & 1u);
    PHASE_MARK(w, 1)
    const float* en = ring + e * R;
    const int4 m0 = reinterpret_cast<const int4*>(en)[0];
    const int4 m1 = reinterpret_cast<const int4*>(en)[1];
    const int is_tip[2] = {m0.z, m0.w}, tip[2] = {m1.x, m1.y};
    const int sl[2] = {slot(m0.x), slot(m0.y)}, out = slot(m1.z);
    const int give = m1.w;  // 1 + the side of the next row that takes ours
    // the children's scalers (a tip's is 0) and tip codes, clamped to the
    // table as tile::lookup does
    int st[RP], code[2][RP];
#pragma unroll
    for (int q = 0; q < RP; ++q) st[q] = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (is_tip[k]) {
        const int* src =
            vec ? reinterpret_cast<const int*>(en + codes_at) + k * T + pl
                : a.codes + (size_t)tip[k] * a.Ppad + p;
#pragma unroll
        for (int q = 0; q < RP; ++q)
          code[k][q] = min(max(vec || p + q < a.Ppad ? src[q] : 0, 0),
                           n_codes - 1);
      } else if (take == k + 1) {
#pragma unroll
        for (int q = 0; q < RP; ++q) st[q] += fwsc[q];
      } else {
#pragma unroll
        for (int q = 0; q < RP; ++q) st[q] += ssc[sl[k] * T + pl + q];
      }
    }
    // child k's values of every category: a lookup, or the product of its
    // column (from its slot, or forwarded) in j = 0..S-1 order, each
    // product and sum rounded separately (tile::product's arithmetic)
    auto child = [&](int k, float(&acc)[C][MAXS][RP]) {
      const float* tb = en + kRowInts + k * Q;
      if (is_tip[k]) {
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int q = 0; q < RP; ++q) {
            float v[MAXS];
            tile::load_vec<MAXS>(v, tb + (c * n_codes + code[k][q]) * SP);
#pragma unroll
            for (int i = 0; i < MAXS; ++i) acc[c][i][q] = v[i];
          }
      } else if (take == k + 1) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float* Mc = tb + c * S * SP;
          float pv[MAXS];
          tile::load_vec<MAXS>(pv, Mc);
#pragma unroll
          for (int i = 0; i < MAXS; ++i)
#pragma unroll
            for (int q = 0; q < RP; ++q)
              acc[c][i][q] = __fmul_rn(pv[i], fw[c][0][q]);
#pragma unroll
          for (int j = 1; j < MAXS; ++j)
            if (EXACT || j < S) {
              tile::load_vec<MAXS>(pv, Mc + j * SP);
#pragma unroll
              for (int i = 0; i < MAXS; ++i)
#pragma unroll
                for (int q = 0; q < RP; ++q)
                  acc[c][i][q] = __fadd_rn(acc[c][i][q],
                                           __fmul_rn(pv[i], fw[c][j][q]));
            }
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c)
          tile::product<MAXS, RP, MAXS, EXACT>(
              tb + c * S * SP, slots + ((size_t)sl[k] * CS + c * S) * T, S,
              SP, T, 0, pl, acc[c]);
      }
    };
    // o = child 0 x child 1, and the maximum over states, then over
    // categories in order c = 0..C-1 (the tile kind's order)
    float o[C][MAXS][RP], v[C][MAXS][RP], mm[RP];
    child(0, o);
    child(1, v);
    // the entry is read: release it to the producer, a lane a warp
    __syncwarp();
    if ((tid & (kWarp - 1)) == 0) tile::mbar_arrive(empty + e);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float m[RP];
#pragma unroll
      for (int q = 0; q < RP; ++q) m[q] = -INFINITY;
#pragma unroll
      for (int i = 0; i < MAXS; ++i)
#pragma unroll
        for (int q = 0; q < RP; ++q) {
          o[c][i][q] = __fmul_rn(o[c][i][q], v[c][i][q]);
          if (EXACT || i < S) m[q] = fmaxf(m[q], o[c][i][q]);
        }
#pragma unroll
      for (int q = 0; q < RP; ++q) mm[q] = c ? fmaxf(mm[q], m[q]) : m[q];
    }
    PHASE_MARK(w, 2)
    float scale[RP];
#pragma unroll
    for (int q = 0; q < RP; ++q) {
      const int ex = common::max_exponent(mm[q]);
      scale[q] = __int_as_float((127 - ex) << 23);
      st[q] += ex;
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int i = 0; i < MAXS; ++i)
#pragma unroll
        for (int q = 0; q < RP; ++q)
          fw[c][i][q] = __fmul_rn(o[c][i][q], scale[q]);
    PHASE_MARK(w, 3)
    if (w == nW - 1) {
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int i = 0; i < MAXS; ++i)
          if (EXACT || i < S)
#pragma unroll
            for (int q = 0; q < RP; ++q)
              if (p + q < a.Ppad)
                a.clv_out[(size_t)(c * S + i) * a.Ppad + p + q] =
                    fw[c][i][q];
#pragma unroll
      for (int q = 0; q < RP; ++q)
        if (p + q < a.Ppad) a.sc_out[p + q] = st[q];
    } else if (!give) {
      float* dst = slots + (size_t)out * CS * T + pl;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int i = 0; i < MAXS; ++i)
          if (EXACT || i < S)
#pragma unroll
            for (int q = 0; q < RP; ++q) dst[(c * S + i) * T + q] = fw[c][i][q];
#pragma unroll
      for (int q = 0; q < RP; ++q) ssc[out * T + pl + q] = st[q];
    }
#pragma unroll
    for (int q = 0; q < RP; ++q) fwsc[q] = st[q];
    take = give;
    PHASE_MARK(w, 4)
  }
}

template <int C>
int launch_thread_c(const WalkArgs& a, const Config& cf,
                    cudaStream_t stream) {
  const dim3 grid((a.Ppad + a.T - 1) / a.T), block(cf.threads);
  if (a.S == 4)
    return common::launch_kernel(thread_kernel<C, true>, grid, block,
                                 (size_t)cf.smem, stream, a);
  return common::launch_kernel(thread_kernel<C, false>, grid, block,
                               (size_t)cf.smem, stream, a);
}

int launch_thread(const WalkArgs& a, const Config& cf, cudaStream_t stream) {
  static_assert(kThreadMaxC == 8, "one instantiation a category count");
  switch (a.C) {
    case 1: return launch_thread_c<1>(a, cf, stream);
    case 2: return launch_thread_c<2>(a, cf, stream);
    case 3: return launch_thread_c<3>(a, cf, stream);
    case 4: return launch_thread_c<4>(a, cf, stream);
    case 5: return launch_thread_c<5>(a, cf, stream);
    case 6: return launch_thread_c<6>(a, cf, stream);
    case 7: return launch_thread_c<7>(a, cf, stream);
    case 8: return launch_thread_c<8>(a, cf, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int MAXS, bool EXACT>
int launch_x(const WalkArgs& a, const Config& cf, cudaStream_t stream) {
  constexpr int RP = MAXS <= 4 ? 2 : 1;
  const dim3 grid((a.Ppad + a.T - 1) / a.T), block(cf.threads);
  if constexpr (MAXS == kSplitMaxS)
    if (cf.kind == kSplit)
      return common::launch_kernel(split_kernel<EXACT>, grid, block,
                                   (size_t)cf.smem, stream, a);
  if (cf.kind == kTile)
    return common::launch_kernel(resident_kernel<MAXS, RP, kTile, EXACT>,
                                 grid, block, (size_t)cf.smem, stream, a);
  return common::launch_kernel(resident_kernel<MAXS, RP, kGlobal, EXACT>,
                               grid, block, (size_t)cf.smem, stream, a);
}

template <int MAXS>
int launch_t(const WalkArgs& a, const Config& cf, cudaStream_t stream) {
  return a.S == MAXS ? launch_x<MAXS, true>(a, cf, stream)
                     : launch_x<MAXS, false>(a, cf, stream);
}

}  // namespace

// The resident walk at pattern tile T: the pre-pass into mats [nW, 2, Q]
// (scratch of the caller), then the walk. Returns the CUDA error code of
// the launches (0 = queued).
extern "C" int pllmod_resident_walk(
    const int* idx8, int nW, const float* P5, const int* codes,
    const float* codetab, int n_codes, float* prod, int* scaler, int Ppad,
    int C, int S, int n_slots, int T, float* mats, void* stream) {
  Config cf;
  if (nW <= 0 || Ppad <= 0 || mats == nullptr ||
      !walk_config(C, S, n_codes, n_slots, T, &cf))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = tables::launch_tables<1>(idx8, nW, P5, codetab, n_codes,
                                           mats, C, S, cf.sp, cf.q, st);
  if (err) return err;
  WalkArgs a{idx8, nW, mats, codes, n_codes, prod, scaler,
             Ppad, C, S, n_slots, T, cf.sp, cf.q, cf.ring};
  if (cf.kind == kThread) return launch_thread(a, cf, st);
  return common::dispatch_states(
      S, [&](auto m) { return launch_t<decltype(m)::value>(a, cf, st); });
}
