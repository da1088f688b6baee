// Per-level pruning kernels for Hopper (sm_90a): one level of a
// LevelSchedule a launch, in the C*S x P layout clvs [n_slots, C*S, Ppad] /
// scalers [n_slots, Ppad]. A level's rows are [W, 6] int32 (slot1, slot2,
// is_tip1, is_tip2, tip1, tip2), its matrices [W, C, S, S] per child.
//
//  * pllmod_child_pass (kernel 3) replaces the TPU kernel
//    pllmod_tpu/ops/pallas_clv.py::_make_child_kernel (call in
//    _child_pass): out[w] = P[w] x child(w) for one child (side 0 or 1) of
//    every row w, [W, C*S, Ppad], and the child's scaler row (0 for a tip).
//  * pllmod_child2_pass (kernel 4) replaces pallas_clv.py::
//    _make_child2_kernel (call in _child2_pass): the second child times its
//    matrix, times `left` (the side-0 pass's output), the exact
//    power-of-two rescale and the cumulative scaler s1 + s2 + e, written
//    straight into slots [off, off + W) of the buffers. The JAX
//    dynamic_update_slice has no counterpart: a level's children live in
//    earlier levels, so no launch reads a slot it writes.
//  * pllmod_level_combined (kernel 5) replaces pallas_clv.py::
//    _make_combined_kernel (call in level_update_combined): both children,
//    product and rescale in one launch, written in place the same way. The
//    TPU kernel's full-buffer copy (a workaround for Mosaic's alias
//    analysis) has no counterpart.
//
// Bound on the H100: bytes, for all three (chip_smoke.py computes each
// level's figure from the run's tables). Every block is read or written
// once: at the flagship (128 taxa x 16384 patterns GTR+G4, C*S = 16, 126
// rows in 17 levels) the side-0 child pass writes 132 MB an evaluation,
// the second-child pass reads it again beside its own children and writes
// the level blocks, the combined pass reads the children once and writes
// the blocks (~200 MB, ~60 us at 3.35 TB/s). The operations (2 C*S*S
// flops a pattern an inner child, 3 C*S for product, maximum and scale)
// are about half the bytes' time at protein (20 states) when counted at
// the unfused rate the exactness contract below allows (a multiply and an
// add a term: 33.5 TFLOP/s), a tenth at DNA.
//
// Design, kernel 3 (child_kernel). Grid (pattern tile, row, category
// block), sized by the level's width W (ops/_build.py::child_tile): wide
// levels take 128-pattern tiles, narrow ones (W = 1 at the top of the
// tree) smaller tiles, so that every level launches about one CTA an SM or
// more. Thread (c, ig, pg) owns RI states x 4 patterns of category c
// (csrc/tile.cuh's register tile): the child's tile arrives in shared
// memory by 16-byte cp.async while the CTA stages the row's matrix
// transposed; outputs leave as 16-byte streaming stores (st.global.cs: the
// second-child pass or the torch combine reads them once). A tip child is
// a lookup of its table PT[c][code][i] = row_dot(P_c, i, codetab[code]),
// built in shared memory, where the tile has at least as many patterns as
// the table has codes (else the CTA multiplies the expanded codes, as the
// table build would cost more).
//
// Design, kernels 4 and 5 (level_tiled). The rescale needs the maximum
// over all C*S values of a pattern, so a CTA owns every category of its
// row's tile: grid (pattern tile, row), thread (c, ig, pg) owns RI states
// x 4 patterns of category c, up to 512 threads (the tile set by the
// level's width, ops/_build.py::level_tile: 256 patterns at DNA and 64 at
// protein on the wide levels, enough CTAs for the card on a level of one
// row; a ragged last tile). A launch is two kernels:
//  1. the pre-pass of csrc/tables.cuh (LevelSides): each row side's
//     matrix transposed, M[c][j][i] = P[c][i][j], or a tip child's table
//     PT[c][code][i] = row_dot(P_c, i, codetab[code]), once a row side
//     into the scratch mats [W * sides, Q]. (Built by every CTA of a row
//     instead, from the matrices in device memory, the tables and the
//     transposition took 18000 of a protein CTA's 29000 cycles on the
//     widest level, all tips: chip_smoke.py's phase marks.)
//  2. level_tiled, one CTA one tile, no loop (a CTA that walked several
//     tiles of its row, the next tile's inputs landing in a second stage
//     buffer, was slower at nearly every level: the buffers halved the
//     CTAs an SM; chip_smoke.py's sweep), launched as the pre-pass's
//     programmatic dependent (it starts while the pre-pass runs): each
//     side's child tile X [C*S][T] (or a tip's codes) by 16-byte cp.async,
//     kernel 4's `left` block and the scaler rows by 16-byte streaming
//     loads into registers; then, once the pre-pass is done
//     (griddepcontrol.wait), each side's table by cp.async (a few copies
//     a thread: one thread's tensor copies would save little in a CTA
//     that issues them once); one barrier; each side's product
//     (tile::product, or tile::lookup of a tip: every tip is looked up),
//     their product (or left times side 1's), the thread's maximum over
//     its RI states; the C * IG maxima of each pattern meet in shared
//     memory behind one barrier (written once a launch: no later step
//     can overwrite them while a slow thread reads them); the rescale and
//     16-byte streaming stores of the block and the scaler row (the next
//     level reads them once). A side's region of shared memory holds a
//     tip's table or an inner child's matrix and tile, never both, and
//     RI = 4 is held to 64 registers: six 160-thread protein CTAs (T =
//     32) or three 320-thread ones (T = 64) fit an SM.
// Where the tiled kernel fits at no tile (C * IG * T / 4 threads beyond
// 512 at T = 4, or its shared memory beyond a block's: wide category or
// state counts, or a table of many codes), the simple kernel
// (level_simple) runs: thread (c, p), all S states of its column in
// registers, the row's matrices and the code table staged where they fit.
// Both are chosen by level_config (csrc/configs.h).
//
// Phase marks (csrc/common.cuh PHASE_MARK, built with -DPLLMOD_PHASES
// only): level_tiled's tile 0 of each row w records at its start, after
// issuing its copies and loads (the tables' after the pre-pass), after
// the copies' barrier, after the products, after the maxima's barrier
// and after the stores.
//
// Exactness: the walks' contract of csrc/common.cuh, products and sums
// rounded separately (__fmul_rn / __fadd_rn) in child-state order j =
// 0..S-1 and the rescale the bit formula clipped to [-125, 127]
// (pallas_clv.py:224-232), so each kernel equals its plain version in
// ops/levels.py bit for bit.
#include "common.cuh"
#include "tables.cuh"
#include "tile.cuh"

namespace {

using common::kMaxThreads;
using namespace levels;

// [W, 6] row columns: slot1, slot2, is_tip1, is_tip2, tip1, tip2
constexpr int kSlot = 0, kIsTip = 2, kTip = 4;

// ---------------------------------------------------------------------------
// the child pass (kernel 3)
// ---------------------------------------------------------------------------
struct ChildArgs {
  const int* idx;        // [W, 6]
  int side;
  const float* P;        // [W, C, S, S]
  const float* clvs;     // [n_slots, C*S, Ppad]
  const int* scalers;    // [n_slots, Ppad]
  int n_slots;
  const int* codes;      // [n_tips, Ppad]
  int n_tips;
  const float* codetab;  // [n_codes, S]
  int n_codes;
  float* out;            // [W, C*S, Ppad]
  int* out_sc;           // [W, Ppad]
  int Ppad, C, S, T, SP, IG, CB, lookup, mrows;
};

template <int MAXS, int RI>
__global__ void __launch_bounds__(kMaxThreads) child_kernel(ChildArgs a) {
  extern __shared__ __align__(16) float child_smem[];
  constexpr int RP = kChildRP;
  const int T = a.T, C = a.C, S = a.S, CS = C * S, SP = a.SP, IG = a.IG;
  const int CB = a.CB, c0 = blockIdx.z * CB, ncat = min(CB, C - c0);
  const int w = blockIdx.y, tid = threadIdx.x, nthr = blockDim.x;
  const int npg = T / RP;
  const int pg = tid % npg, rest = tid / npg, ig = rest % IG, cl = rest / IG;
  const int i0 = ig * RI, pl0 = pg * RP;
  const int p0 = blockIdx.x * T, p = p0 + pl0;
  const bool vec = a.Ppad % 4 == 0;
  const int* row = a.idx + 6 * w;
  const bool tip = row[kIsTip + a.side] != 0;
  const bool lookup = tip && a.lookup;
  float* M = child_smem;                    // [CB][S][SP], then PT
  float* X = M + CB * a.mrows * SP;         // [CB * S][T]
  int* sc = reinterpret_cast<int*>(X + CB * S * T);
  int* cd = sc + T;

  // the child's tile (or the tip's codes), in flight while the matrix is
  // staged
  if (tip) {
    const int t = min(max(row[kTip + a.side], 0), a.n_tips - 1);
    tile::copy_tile(cd, a.codes + (size_t)t * a.Ppad, 0, 1, T, p0, a.Ppad,
                    vec, tid, nthr);
  } else {
    const int slot = min(max(row[kSlot + a.side], 0), a.n_slots - 1);
    tile::copy_tile(X, a.clvs + ((size_t)slot * CS + c0 * S) * a.Ppad,
                    a.Ppad, ncat * S, T, p0, a.Ppad, vec, tid, nthr);
    tile::copy_tile(sc, a.scalers + (size_t)slot * a.Ppad, 0, 1, T, p0,
                    a.Ppad, vec, tid, nthr);
  }
  tile::cp_commit();
  // the row's matrices transposed, M[c][j][i] = P[c][i][j] (read in P's
  // order), and the padding states zero
  const float* Pw = a.P + ((size_t)w * C + c0) * S * S;
  for (int e = tid; e < ncat * S * S; e += nthr) {
    const int c = e / (S * S), r = e - c * S * S, i = r / S, j = r - i * S;
    M[(c * S + j) * SP + i] = Pw[e];
  }
  const int pad = SP - S;
  for (int e = tid; e < ncat * S * pad; e += nthr)
    M[(e / pad) * SP + S + e % pad] = 0.f;
  float* PT = M + CB * S * SP;              // [CB][n_codes][SP]
  if (lookup) {                             // the tip's table, from M
    __syncthreads();
    const int per_c = a.n_codes * SP;
    for (int e = tid; e < ncat * per_c; e += nthr) {
      const int c = e / per_c, code = (e - c * per_c) / SP, i = e % SP;
      PT[e] = i < S ? tile::tip_entry(M + c * S * SP, SP,
                                      a.codetab + code * S, S, i)
                    : 0.f;
    }
  }
  tile::cp_wait(0);
  __syncthreads();
  if (tip && !lookup) {                     // the codes' rows, [S][T]
    for (int e = tid; e < S * T; e += nthr) {
      const int j = e / T, x = e - j * T;
      const int code = min(max(cd[x], 0), a.n_codes - 1);
      X[e] = a.codetab[code * S + j];
    }
    __syncthreads();
  }
  if (cl >= ncat) return;
  const int c = c0 + cl;
  float acc[RI][RP];
  if (lookup)
    tile::lookup<RI, RP>(PT + (size_t)cl * a.n_codes * SP, cd, a.n_codes, SP,
                         i0, pl0, acc);
  else
    tile::product<RI, RP, MAXS>(M + (size_t)cl * S * SP,
                                tip ? X : X + cl * S * T, S, SP, T, i0, pl0,
                                acc);
#pragma unroll
  for (int i = 0; i < RI; ++i)
    if (i0 + i < S)
      tile::store_run<RP, true>(
          a.out + ((size_t)w * CS + c * S + i0 + i) * a.Ppad + p, acc[i], p,
          a.Ppad, vec);
  if (c == 0 && ig == 0) {
    int v[RP];
#pragma unroll
    for (int x = 0; x < RP; ++x) v[x] = tip ? 0 : sc[pl0 + x];
    tile::store_run<RP, true>(a.out_sc + (size_t)w * a.Ppad + p, v, p,
                              a.Ppad, vec);
  }
}

// ---------------------------------------------------------------------------
// the second-child pass (kernel 4) and the combined level pass (kernel 5)
// ---------------------------------------------------------------------------
// level_tiled's stores of the block and scaler row: streaming (1,
// st.global.cs) or write-back (0); scripts/level_stores_ab.py builds the
// other and times both
#ifndef PLLMOD_LEVEL_STREAM_STORES
#define PLLMOD_LEVEL_STREAM_STORES 1
#endif
constexpr bool kLevelStream = PLLMOD_LEVEL_STREAM_STORES != 0;
static_assert(kLevelRP == 4, "level_tiled's maxima are float4 vectors");

struct LevelArgs {
  const int* idx;        // [W, 6]
  const float* P[2];     // [W, C, S, S] a side: kernel 4 child 1's, kernel
                         // 5 child 0's and child 1's
  float* clvs;           // [n_slots, C*S, Ppad]: the children; the level
                         // writes slots [off, off + W)
  int* scalers;          // [n_slots, Ppad]
  int n_slots;
  const int* codes;      // [n_tips, Ppad]
  int n_tips;
  const float* codetab;  // [n_codes, S]
  int n_codes;
  const float* left;     // kernel 4: [W, C*S, Ppad]
  const int* s1;         // kernel 4: [W, Ppad]
  int off, Ppad, C, S, T;
  const float* mats;     // level_tiled: the pre-pass's tables [W * SIDES, Q]
  int Q, SP, IG;         // level_tiled's configuration
};

// The sides of a level's rows for the pre-pass of csrc/tables.cuh: side s
// is the row's child CHILD0 + s % SIDES of row s / SIDES, with its
// matrices P[s % SIDES] of that row.
template <int MODE>
struct LevelSides {
  const int* idx;
  const float* P0;
  const float* P1;
  long long msz;  // C * S * S
  static constexpr int kSides = MODE + 1, kChild0 = MODE == kChild2 ? 1 : 0;
  __device__ bool is_tip(int s) const {
    return idx[6 * (s / kSides) + kIsTip + kChild0 + s % kSides] != 0;
  }
  __device__ const float* matrix(int s) const {
    return (s % kSides ? P1 : P0) + (s / kSides) * msz;
  }
};

// Registers: RI = 4 (up to 4 and at 20 states) is held to 64 a thread,
// two 512-thread CTAs' worth an SM, so that three 320-thread protein CTAs
// (T = 64) fit an SM; RI = 8 takes up to 128.
template <int MAXS, int RI, int MODE>
__global__ void __launch_bounds__(kLevelThreads, RI == 4 ? 2 : 1)
    level_tiled(LevelArgs a) {
  extern __shared__ __align__(16) float level_smem[];
  constexpr int RP = kLevelRP, SIDES = MODE + 1;
  constexpr int CHILD0 = LevelSides<MODE>::kChild0;
  const int T = a.T, C = a.C, S = a.S, CS = C * S, SP = a.SP, IG = a.IG;
  const int Ppad = a.Ppad, n_codes = a.n_codes;
  const int w = blockIdx.y, tid = threadIdx.x, nthr = blockDim.x;
  const int npg = T / RP;
  const int pg = tid % npg, rest = tid / npg, ig = rest % IG, c = rest / IG;
  const int i0 = ig * RI, pl0 = pg * RP;
  const int p0 = blockIdx.x * T, p = p0 + pl0;
  const bool vec = Ppad % 4 == 0;
  const bool writes_sc = c == 0 && ig == 0;
  const int* row = a.idx + 6 * w;
  // a side's region: its tip table [Q], or its matrix [C*S*SP] and child
  // tile [C*S][T]
  const int region = max(a.Q, CS * (SP + T));
  float* red = level_smem + SIDES * region;            // [C * IG][T]
  int* cd = reinterpret_cast<int*>(red + C * IG * T);  // [SIDES][T]
  PHASE_INIT
  PHASE_MARK(w, 0)

  // each side's child tile (or its tip's codes) by cp.async, kernel 4's
  // left block and the scaler rows straight to registers, while the
  // pre-pass may still run; then each side's table from it
  bool tip[SIDES];
  int src[SIDES];  // the tip's row of codes, else the child's slot
#pragma unroll
  for (int k = 0; k < SIDES; ++k) {
    tip[k] = __ldg(row + kIsTip + CHILD0 + k) != 0;
    src[k] = tip[k]
                 ? min(max(__ldg(row + kTip + CHILD0 + k), 0), a.n_tips - 1)
                 : min(max(__ldg(row + kSlot + CHILD0 + k), 0),
                       a.n_slots - 1);
    if (tip[k])
      tile::copy_tile(cd + k * T, a.codes + (size_t)src[k] * Ppad, 0, 1, T,
                      p0, Ppad, vec, tid, nthr);
    else
      tile::copy_tile(level_smem + k * region + CS * SP,
                      a.clvs + (size_t)src[k] * CS * Ppad, Ppad, CS, T, p0,
                      Ppad, vec, tid, nthr);
  }
  float lv[RI][RP];
  if constexpr (MODE == kChild2) {
#pragma unroll
    for (int r = 0; r < RI; ++r)
      if (i0 + r < S) {
        tile::load_run<RP>(
            lv[r], a.left + ((size_t)w * CS + c * S + i0 + r) * Ppad + p, p,
            Ppad, vec);
      } else {
#pragma unroll
        for (int x = 0; x < RP; ++x) lv[r][x] = 0.f;
      }
  }
  // the scaler rows, summed after the copies' barrier: kernel 4's s1,
  // then each inner side's (0 for a tip)
  int scv[SIDES + 1][RP];
#pragma unroll
  for (int k = 0; k <= SIDES; ++k)
#pragma unroll
    for (int x = 0; x < RP; ++x) scv[k][x] = 0;
  if (writes_sc) {
    if constexpr (MODE == kChild2)
      tile::load_run<RP>(scv[SIDES], a.s1 + (size_t)w * Ppad + p, p, Ppad,
                         vec);
#pragma unroll
    for (int k = 0; k < SIDES; ++k)
      if (!tip[k])
        tile::load_run<RP>(scv[k], a.scalers + (size_t)src[k] * Ppad + p, p,
                           Ppad, vec);
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < SIDES; ++k)
    tile::copy_run(level_smem + k * region,
                   a.mats + ((size_t)w * SIDES + k) * a.Q,
                   C * (tip[k] ? n_codes : S) * SP, tid, nthr);
  tile::cp_commit();
  PHASE_MARK(w, 1)
  tile::cp_wait(0);
  __syncthreads();
  int stot[RP];
#pragma unroll
  for (int x = 0; x < RP; ++x) {
    stot[x] = scv[SIDES][x];
#pragma unroll
    for (int k = 0; k < SIDES; ++k) stot[x] += scv[k][x];
  }
  PHASE_MARK(w, 2)

  // the sides' products (a tip's: its table looked up) and their product
  // (kernel 4: left times side 1's)
  auto side = [&](int k, float (&acc)[RI][RP]) {
    const float* tab = level_smem + k * region;
    if (tip[k])
      tile::lookup<RI, RP>(tab + c * n_codes * SP, cd + k * T, n_codes, SP,
                           i0, pl0, acc);
    else
      tile::product<RI, RP, MAXS>(tab + c * S * SP, tab + CS * SP + c * S * T,
                                  S, SP, T, i0, pl0, acc);
  };
  float o[RI][RP];
  side(SIDES - 1, o);
  if constexpr (MODE == kChild2) {
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int x = 0; x < RP; ++x) o[r][x] = __fmul_rn(lv[r][x], o[r][x]);
  } else {
    float o0[RI][RP];
    side(0, o0);
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int x = 0; x < RP; ++x) o[r][x] = __fmul_rn(o0[r][x], o[r][x]);
  }
  PHASE_MARK(w, 3)

  // the maximum of each pattern's C*S values: the thread's over its RI
  // states, then the C * IG of the CTA behind one barrier (written once a
  // launch: nothing can overwrite them while a slow thread reads them)
  float m[RP];
#pragma unroll
  for (int x = 0; x < RP; ++x) m[x] = -INFINITY;
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    if (i0 + r >= S) continue;
#pragma unroll
    for (int x = 0; x < RP; ++x) m[x] = fmaxf(m[x], o[r][x]);
  }
  *reinterpret_cast<float4*>(red + (c * IG + ig) * T + pl0) =
      make_float4(m[0], m[1], m[2], m[3]);
  __syncthreads();
  float4 mm = *reinterpret_cast<const float4*>(red + pl0);
  for (int q = 1; q < C * IG; ++q) {
    const float4 t = *reinterpret_cast<const float4*>(red + q * T + pl0);
    mm = make_float4(fmaxf(mm.x, t.x), fmaxf(mm.y, t.y), fmaxf(mm.z, t.z),
                     fmaxf(mm.w, t.w));
  }
  PHASE_MARK(w, 4)

  // the rescale, and the block and scaler row as streaming stores
  const int e[RP] = {common::max_exponent(mm.x), common::max_exponent(mm.y),
                     common::max_exponent(mm.z), common::max_exponent(mm.w)};
  const size_t slot = (size_t)a.off + w;
#pragma unroll
  for (int r = 0; r < RI; ++r)
    if (i0 + r < S) {
      float v[RP];
#pragma unroll
      for (int x = 0; x < RP; ++x)
        v[x] = __fmul_rn(o[r][x], __int_as_float((127 - e[x]) << 23));
      tile::store_run<RP, kLevelStream>(
          a.clvs + (slot * CS + c * S + i0 + r) * Ppad + p, v, p, Ppad, vec);
    }
  if (writes_sc) {
    int v[RP];
#pragma unroll
    for (int x = 0; x < RP; ++x) v[x] = stot[x] + e[x];
    tile::store_run<RP, kLevelStream>(a.scalers + slot * Ppad + p, v, p,
                                      Ppad, vec);
  }
  PHASE_MARK(w, 5)
}

// Child `child` of the row: its S values of category c at pattern p, and
// its scaler (read by category 0 only, which alone writes scalers).
template <int MAXS>
__device__ __forceinline__ void load_child(const LevelArgs& a,
                                           const float* tab, const int* row,
                                           int child, int c, int p,
                                           float (&x)[MAXS], int& sc) {
  const int S = a.S;
  if (row[kIsTip + child] != 0) {
    const int tip = min(max(row[kTip + child], 0), a.n_tips - 1);
    common::load_tip<MAXS>(tab, a.codes[(size_t)tip * a.Ppad + p], a.n_codes,
                           S, x);
    sc = 0;
    return;
  }
  const int slot = min(max(row[kSlot + child], 0), a.n_slots - 1);
  common::load_column<MAXS>(
      a.clvs + ((size_t)slot * a.C * S + c * S) * a.Ppad + p, a.Ppad, S, x);
  sc = (c == 0) ? a.scalers[(size_t)slot * a.Ppad + p] : 0;
}

// The simple kernel: thread (c, pl) owns category c of pattern p0 + pl,
// its child columns and products in registers; a ragged last tile's
// threads beyond Ppad read the last pattern and store nothing.
template <int MAXS, int MODE, bool STAGE>
__global__ void __launch_bounds__(kMaxThreads) level_simple(LevelArgs a) {
  extern __shared__ float smem[];
  constexpr int SIDES = MODE + 1;
  const int T = a.T, C = a.C, S = a.S, CS = C * S, Ppad = a.Ppad;
  const int w = blockIdx.y, tid = threadIdx.x;
  const int c = tid / T, pl = tid - c * T;
  const int p = blockIdx.x * T + pl;
  const bool live = p < Ppad;
  const int pc = live ? p : Ppad - 1;
  const size_t msz = (size_t)CS * S;
  float* red = smem;                        // [C][T]
  float* tab_s = red + C * T;               // [n_codes * S]
  float* P_s = tab_s + a.n_codes * S;       // [SIDES][C*S*S]
  if (STAGE) {
    for (int i = tid; i < a.n_codes * S; i += blockDim.x)
      tab_s[i] = a.codetab[i];
#pragma unroll
    for (int k = 0; k < SIDES; ++k)
      for (size_t i = tid; i < msz; i += blockDim.x)
        P_s[k * msz + i] = a.P[k][w * msz + i];
    __syncthreads();
  }
  const float* tab = STAGE ? tab_s : a.codetab;
  auto mat = [&](int k) {
    return (STAGE ? P_s + k * msz : a.P[k] + w * msz) + c * S * S;
  };
  const int* row = a.idx + 6 * w;
  constexpr int kUnrollRows = common::unroll_rows<MAXS>();
  float x[MAXS], o[MAXS];
  int sc, stot;
  // the products first, then their maximum in a loop of its own
  load_child<MAXS>(a, tab, row, 1, c, pc, x, sc);
  const float* Pb = mat(SIDES - 1);
  if (MODE == kChild2) {
    const float* lw = a.left + ((size_t)w * CS + c * S) * Ppad + pc;
#pragma unroll kUnrollRows
    for (int i = 0; i < MAXS; ++i)
      if (i < S)
        o[i] = __fmul_rn(lw[(size_t)i * Ppad],
                         common::row_dot<MAXS>(Pb, i, S, x));
    stot = (c == 0) ? a.s1[(size_t)w * Ppad + pc] + sc : 0;
  } else {
    float x0[MAXS];
    int sc0;
    load_child<MAXS>(a, tab, row, 0, c, pc, x0, sc0);
    const float* Pa = mat(0);
#pragma unroll kUnrollRows
    for (int i = 0; i < MAXS; ++i)
      if (i < S)
        o[i] = __fmul_rn(common::row_dot<MAXS>(Pa, i, S, x0),
                         common::row_dot<MAXS>(Pb, i, S, x));
    stot = sc0 + sc;
  }
  float m = -INFINITY;
#pragma unroll kUnrollRows
  for (int i = 0; i < MAXS; ++i)
    if (i < S) m = fmaxf(m, o[i]);
  const int e = common::rescale_exponent(red, m, c, pl, C, T);
  if (!live) return;
  const size_t slot = (size_t)a.off + w;
  common::store_scaled<MAXS>(a.clvs + (slot * CS + c * S) * Ppad + p, Ppad,
                             S, o, e);
  if (c == 0) a.scalers[slot * Ppad + p] = stot + e;
}

template <int MODE>
int launch_level(LevelArgs a, int W, float* mats, cudaStream_t stream) {
  LevelConfig cf;
  if (a.off < 0 || a.off + W > a.n_slots || a.Ppad <= 0 ||
      !level_config(MODE, a.C, a.S, a.n_codes, a.T, &cf) ||
      (cf.kind == kTiled && mats == nullptr))
    return (int)cudaErrorInvalidValue;
  if (W <= 0 || W > 65535) return (int)cudaErrorInvalidConfiguration;
  a.SP = cf.sp;
  a.IG = cf.ig;
  a.Q = (int)cf.q;
  a.mats = mats;
  const dim3 grid((a.Ppad + a.T - 1) / a.T, W), block(cf.threads);
  if (cf.kind == kTiled) {
    const LevelSides<MODE> sides{a.idx, a.P[0], a.P[1],
                                 (long long)a.C * a.S * a.S};
    const int err = tables::launch_sides<MODE == kChild2 ? 4 : 5>(
        sides, W * (MODE + 1), a.codetab, a.n_codes, mats, a.C, a.S, cf.sp,
        cf.q, stream);
    if (err) return err;
  }
  return common::dispatch_states(a.S, [&](auto m) {
    constexpr int MAXS = decltype(m)::value;
    // level_tiled is the pre-pass's programmatic dependent: its CTAs
    // load their rows and issue their child copies while the pre-pass
    // runs, and wait for its tables at griddepcontrol.wait
    if (cf.kind == kTiled)
      return common::launch_kernel(level_tiled<MAXS, child_ri(MAXS), MODE>,
                                   grid, block, (size_t)cf.smem, stream, a,
                                   true);
    const bool staged = cf.smem > 4LL * a.C * a.T;
    return common::launch_kernel(staged ? level_simple<MAXS, MODE, true>
                                        : level_simple<MAXS, MODE, false>,
                                 grid, block, (size_t)cf.smem, stream, a);
  });
}

}  // namespace

// Every entry point returns the CUDA error code of its launch (0 = queued).
extern "C" int pllmod_child_pass(
    const int* idx, int W, int side, const float* P, const float* clvs,
    const int* scalers, int n_slots, const int* codes, int n_tips,
    const float* codetab, int n_codes, float* out, int* out_sc, int Ppad,
    int C, int S, int T, void* stream) {
  ChildConfig cf;
  if ((side != 0 && side != 1) || Ppad <= 0 ||
      !child_config(C, S, n_codes, T, &cf))
    return (int)cudaErrorInvalidValue;
  const int nb = (C + cf.cb - 1) / cf.cb;
  if (W <= 0 || W > 65535 || nb > 65535)
    return (int)cudaErrorInvalidConfiguration;
  ChildArgs a{idx, side, P, clvs, scalers, n_slots, codes, n_tips, codetab,
              n_codes, out, out_sc, Ppad, C, S, T, cf.sp, cf.ig, cf.cb,
              cf.lookup, cf.mrows};
  const dim3 grid((Ppad + T - 1) / T, W, nb), block(cf.threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return common::dispatch_states(S, [&](auto m) {
    return common::launch_kernel(
        child_kernel<decltype(m)::value, child_ri(decltype(m)::value)>,
        grid, block,
        (size_t)cf.smem, st, a);
  });
}

// Kernels 4 and 5 take the scratch of their pre-pass, mats [W * sides,
// Q] (level_config's Q; unused, and may be null, where the simple kernel
// runs).
extern "C" int pllmod_child2_pass(
    const int* idx, int W, const float* P, float* clvs, int* scalers,
    int n_slots, const int* codes, int n_tips, const float* codetab,
    int n_codes, const float* left, const int* s1, int off, int Ppad, int C,
    int S, int T, float* mats, void* stream) {
  LevelArgs a{idx, {P, nullptr}, clvs, scalers, n_slots, codes, n_tips,
              codetab, n_codes, left, s1, off, Ppad, C, S, T, nullptr, 0,
              0, 0};
  return launch_level<kChild2>(a, W, mats, static_cast<cudaStream_t>(stream));
}

extern "C" int pllmod_level_combined(
    const int* idx, int W, const float* P1, const float* P2, float* clvs,
    int* scalers, int n_slots, const int* codes, int n_tips,
    const float* codetab, int n_codes, int off, int Ppad, int C, int S,
    int T, float* mats, void* stream) {
  LevelArgs a{idx, {P1, P2}, clvs, scalers, n_slots, codes, n_tips,
              codetab, n_codes, nullptr, nullptr, off, Ppad, C, S, T,
              nullptr, 0, 0, 0};
  return launch_level<kCombined>(a, W, mats,
                                 static_cast<cudaStream_t>(stream));
}
