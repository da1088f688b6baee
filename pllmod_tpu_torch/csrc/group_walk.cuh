// The group-window walk for Hopper (sm_90a): the device code of the
// packed walk (packed.cu, kernel 6) and the grouped walk (grouped.cu,
// kernel 7), which differ only in where a row's children and output live
// (their Rows policies).
//
// A walk is a table of rows in an order in which every child is written
// by an earlier row. The host cuts it into windows, runs of consecutive
// rows none of which reads another's output (ops/packed.py: the padded
// levels; ops/grouped.py: the members in the level order of their
// dependencies), given as row offsets windows [n_windows + 1]. One call
// launches the pre-pass of csrc/tables.cuh (every side's matrix
// transposed, or a tip child's table of row_dot lookups, into the
// caller's scratch mats [n_sides, Q]), the row table (into the caller's
// scratch rowtab [n_rows, 8]) and then the walk: one CTA owns a
// tile of T pattern columns and R row lanes, and steps through each
// window R rows at a time, lane l taking row base + l. Rows of one step
// are independent, so their children are all issued before the first
// product and their category maxima meet in shared memory behind one
// barrier; a barrier at each window's start makes the last window's
// stores visible to every lane. What a step needs of its rows (each
// side's tip or position and table, each row's output position) is one
// entry a row of a row table that a small kernel builds from the Rows
// policy at the start of the launch; the entries come through a ring of
// 4 steps in shared memory, loaded two steps ahead by R threads, so no
// step waits on a lookup chain in device memory (reading the policy's
// tables at each step cost ~1500 cycles a step at the flagship and
// protein on the H100, chip_smoke.py's phase marks). Two designs, by the
// state count (walk_config, csrc/configs.h):
//
//  * thread_walk, up to 8 states: thread (l, c, pg) owns category c of
//    RPT adjacent patterns (2 up to 4 states: one vector load or store a
//    CLV row) of its lane's row and keeps all S states in registers: both
//    children (a tip's codes, an inner child's S values and scaler) are
//    loaded at once, then multiplied by the row's tables (read from mats
//    through L1: a few hundred bytes a side). One barrier a step.
//    (Loading the next step's children into registers while a step
//    computes raised the registers from 64-76 to 107-114 and halved the
//    CTAs an SM: 1.6x slower at the flagship on the H100, chip_smoke.py's
//    sweep.)
//  * tile_walk, beyond 8 states: thread (l, c, ig, pg) computes RI states
//    x RP patterns of category c (csrc/tile.cuh's register tile; RI = 8,
//    4 at 20 states, RP = 4), from each side's table (staged where it
//    fits, else read from mats) and its child's tile X [C*S][T] in
//    shared memory. A step's sides go to one of two stage buffers: the
//    next step's are issued before this step computes, where it lies in
//    the same window (no child there is written by a row in flight, so
//    nothing is forwarded); at a window's start the ring drains. One
//    thread issues a step's copies, a tensor copy (TMA) a child tile and
//    bulk copies of tables, scalers and codes, counted on the buffer's
//    mbarrier (every thread issuing 16-byte cp.async copies spent half
//    of a protein step doing so: 1.43 ms against 1.06 on the H100,
//    chip_smoke.py's checks and phase marks); the cp.async copies stay
//    where no tensor copy fits (C*S beyond a box's 256 rows, T or Ppad
//    not multiples of 4). One barrier a step (the category maxima), two
//    with cp.async. Where the register tile's threads do not fit (wide
//    categories), the wide kind: RI = MAXS, RP = 1, cp.async.
//
// Phase marks (csrc/common.cuh PHASE_MARK, built with -DPLLMOD_PHASES
// only): a step of the thread walk at its start, after the products (the
// children's loads landed), after the barrier and after the stores; of
// the tile walk at its start, after issuing copies, after they landed,
// after the products, after the maxima's barrier and after the stores.
//
// Exactness: products and sums rounded separately in child-state order
// (tile::product; a lookup is the same row_dot, tile::tip_entry), the
// rescale the bit formula of csrc/common.cuh clipped to [-125, 127], so
// both walks equal their plain versions (ops/packed.py, ops/grouped.py)
// bit for bit.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>

#include <initializer_list>

#include "common.cuh"
#include "tables.cuh"
#include "tile.cuh"

namespace group_walk {

// a lane's entry in the ring of step tables (configs.h kMeta ints): the
// columns of its row's two children, its output position and the row
constexpr int kTip = 0, kPos = 2, kSide = 4, kOut = 6, kRow = 7;

struct WalkArgs {
  const int* windows;  // [n_windows + 1] row offsets (clamped to n_rows)
  int n_windows, n_rows;
  const int* rowtab;   // [n_rows, kMeta] from row_table
  const float* mats;   // [n_sides, Q] from the pre-pass
  long long Q;
  const int* codes;    // [n_tips, Ppad]
  int n_codes;
  float* clv;          // [n_pos, C*S, Ppad]
  int* sc;             // [n_pos, Ppad]
  int Ppad, C, S, T, R, SP, IG;
  int tma;             // the tile walk's children come by tensor copies
};

// A row's child k: tip >= 0 for a tip child (its row of codes), else
// -1 and the position pos of its CLV and scaler rows.
struct Child {
  int tip, pos;
};

// ---------------------------------------------------------------------------
// the ring of step tables (kRing steps of R lane entries)
// ---------------------------------------------------------------------------
struct Cursor {  // a step: its window, first row and the window's end
  int w, base, end;
};

// row offset w of the windows, clamped to the table
__device__ __forceinline__ int window_row(const WalkArgs& a, int w) {
  return min(max(a.windows[w], 0), a.n_rows);
}

// past the end of cu's window: on to the first row of the next window
// that has one (the steps of the walks' loops over windows and rows)
__device__ __forceinline__ void settle(Cursor& cu, const WalkArgs& a) {
  while (cu.w < a.n_windows && cu.base >= cu.end) {
    if (++cu.w == a.n_windows) break;
    cu.base = window_row(a, cu.w);
    cu.end = window_row(a, cu.w + 1);
  }
}

__device__ __forceinline__ Cursor first_step(const WalkArgs& a) {
  Cursor cu{0, window_row(a, 0), window_row(a, 1)};
  settle(cu, a);
  return cu;
}

// the step after cu
__device__ __forceinline__ void advance(Cursor& cu, const WalkArgs& a) {
  cu.base += a.R;
  settle(cu, a);
}

// Each row's entry of the ring, built once a launch from the Rows policy
// (a thread a row): what a step needs then comes in two 16-byte loads
// that no branch waits on.
template <typename Rows>
__global__ void __launch_bounds__(256)
row_table(Rows rows, int n_rows, int* rowtab) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  int* e = rowtab + (size_t)r * kMeta;
  for (int k = 0; k < 2; ++k) {
    const Child ch = rows.child(r, k);
    e[kTip + k] = ch.tip >= 0 ? ch.tip : -1;
    e[kPos + k] = ch.pos;
    e[kSide + k] = (int)rows.side(r, k);
  }
  e[kOut] = rows.out(r);
  e[kRow] = r;
}

// Thread t < R: lane t's entry of step cu (its row, or -1 past the
// window), held in registers until stored.
__device__ __forceinline__ void load_meta(const WalkArgs& a, Cursor cu,
                                          int t, int4 (&v)[2]) {
  const int r = cu.base + t;
  if (cu.w < a.n_windows && r < cu.end) {
    const int4* e = reinterpret_cast<const int4*>(a.rowtab) + 2 * (size_t)r;
    v[0] = e[0];
    v[1] = e[1];
  } else {
    v[0] = make_int4(0, 0, 0, 0);
    v[1] = make_int4(0, 0, 0, -1);
  }
}

__device__ __forceinline__ void store_meta(int* meta, int slot, int R,
                                           int t, const int4 (&v)[2]) {
  int4* me = reinterpret_cast<int4*>(meta + ((slot % kRing) * R + t) *
                                                kMeta);
  me[0] = v[0];
  me[1] = v[1];
}

// ---------------------------------------------------------------------------
// the thread walk (up to 8 states)
// ---------------------------------------------------------------------------
template <int MAXS>
__host__ __device__ constexpr int thread_rpt() {
  return MAXS <= 4 ? 2 : 1;
}

// v[x] = src[p + x] for x < RPT, one vector load where vec allows; the
// patterns clamped to the last (a ragged tile's spare threads compute on
// copies and store nothing)
template <int RPT, typename V>
__device__ __forceinline__ void load_pats(const V* src, int p, int Ppad,
                                          bool vec, V (&v)[RPT]) {
  if constexpr (RPT == 2) {
    if (vec) {
      using V2 = typename std::conditional<std::is_same<V, float>::value,
                                           float2, int2>::type;
      const V2 t = *reinterpret_cast<const V2*>(src + min(p, Ppad - 2));
      v[0] = t.x;
      v[1] = t.y;
      return;
    }
  }
#pragma unroll
  for (int x = 0; x < RPT; ++x) v[x] = src[min(p + x, Ppad - 1)];
}

template <int MAXS, int RPT>
struct Side {  // one child as a thread holds it
  float x[RPT][MAXS];
  int code[RPT], sc[RPT];
};

// Two CTAs of kThreads an SM: at most 64 registers a thread (ptxas took
// 97-99 for the 4-state walk unbounded, one CTA an SM: 1.35x slower at
// the flagship on the H100, chip_smoke.py's sweep).
template <int MAXS, bool EXACT>
__global__ void __launch_bounds__(kThreads, 2) thread_walk(WalkArgs a) {
  extern __shared__ __align__(16) float walk_smem[];
  constexpr int RPT = thread_rpt<MAXS>(), SP = MAXS;
  const int S = EXACT ? MAXS : a.S;
  const int T = a.T, C = a.C, R = a.R, Ppad = a.Ppad;
  const int npg = T / RPT, lane_thr = C * npg;
  const int tid = threadIdx.x, l = tid / lane_thr;
  const int rest = tid - l * lane_thr, c = rest / npg;
  const int pl = (rest - c * npg) * RPT;
  const int p = blockIdx.x * T + pl;  // this thread's first pattern
  const bool vec = Ppad % RPT == 0;
  float* red = walk_smem;  // [2 steps][R][C][T]
  int* meta = reinterpret_cast<int*>(  // [kRing][R] entries
      red + tile::round_up(2 * R * C * T, 4));

  // child k of the lane's row (its entry me): a tip's codes, or an inner
  // child's S values and (category 0) its scaler
  auto fetch = [&](const int* me, int k, Side<MAXS, RPT>& d) {
    if (me[kTip + k] >= 0) {
      load_pats<RPT>(a.codes + (size_t)me[kTip + k] * Ppad, p, Ppad, vec,
                     d.code);
      return;
    }
    const int pos = me[kPos + k];
    const float* src = a.clv + ((size_t)pos * C * S + c * S) * Ppad;
#pragma unroll
    for (int j = 0; j < MAXS; ++j)
      if (j < S) {
        float v[RPT];
        load_pats<RPT>(src + (size_t)j * Ppad, p, Ppad, vec, v);
#pragma unroll
        for (int x = 0; x < RPT; ++x) d.x[x][j] = v[x];
      }
    if (c == 0)
      load_pats<RPT>(a.sc + (size_t)pos * Ppad, p, Ppad, vec, d.sc);
  };
  // o[x] = (child's matrix) x[x], or its tip table's rows of codes[x]
  auto product = [&](const int* me, int k, const Side<MAXS, RPT>& d,
                     float (&o)[RPT][MAXS]) {
    const float* M = a.mats + (size_t)me[kSide + k] * a.Q;
    if (me[kTip + k] >= 0) {
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        tile::load_vec<MAXS>(
            o[q], M + (c * a.n_codes +
                       min(max(d.code[q], 0), a.n_codes - 1)) * SP);
      return;
    }
    const float* Mc = M + c * S * SP;
    float mv[MAXS];
    tile::load_vec<MAXS>(mv, Mc);
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int i = 0; i < MAXS; ++i) o[q][i] = __fmul_rn(mv[i], d.x[q][0]);
#pragma unroll
    for (int j = 1; j < MAXS; ++j)
      if (j < S) {
        tile::load_vec<MAXS>(mv, Mc + j * SP);
#pragma unroll
        for (int q = 0; q < RPT; ++q)
#pragma unroll
          for (int i = 0; i < MAXS; ++i)
            o[q][i] = __fadd_rn(o[q][i], __fmul_rn(mv[i], d.x[q][j]));
      }
  };

  // the ring's first two steps
  Cursor next2 = first_step(a);
  for (int s = 0; s < 2; ++s) {
    if (tid < R) {
      int4 v[2];
      load_meta(a, next2, tid, v);
      store_meta(meta, s, R, tid, v);
    }
    advance(next2, a);
  }
  __syncthreads();
  PHASE_INIT
  int step = 0;
  for (int w = 0; w < a.n_windows; ++w) {
    const int r0 = window_row(a, w), r1 = window_row(a, w + 1);
    if (w > 0) __syncthreads();  // the last window's stores, for all lanes
    for (int base = r0; base < r1; base += R, ++step) {
      PHASE_MARK(step, 0)
      const int* me = meta + ((step % kRing) * R + l) * kMeta;
      const bool live = me[kRow] >= 0;
      int4 v[2];  // step + 2's entry, stored before the barrier
      if (tid < R) load_meta(a, next2, tid, v);
      advance(next2, a);
      float o[RPT][MAXS];
      float m[RPT];
      int st[RPT];
#pragma unroll
      for (int q = 0; q < RPT; ++q) m[q] = -INFINITY;
      if (live) {
        Side<MAXS, RPT> d0, d1;
        fetch(me, 0, d0);
        fetch(me, 1, d1);
        float o2[RPT][MAXS];
        product(me, 0, d0, o);
        product(me, 1, d1, o2);
        const bool t0 = me[kTip] >= 0, t1 = me[kTip + 1] >= 0;
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          st[q] = c == 0 ? (t0 ? 0 : d0.sc[q]) + (t1 ? 0 : d1.sc[q]) : 0;
#pragma unroll
          for (int i = 0; i < MAXS; ++i)
            if (i < S) {
              o[q][i] = __fmul_rn(o[q][i], o2[q][i]);
              m[q] = fmaxf(m[q], o[q][i]);
            }
        }
      }
      PHASE_MARK(step, 1)
      if (tid < R) store_meta(meta, step + 2, R, tid, v);
      float* rd = red + ((step & 1) * R + l) * C * T;
#pragma unroll
      for (int q = 0; q < RPT; ++q) rd[c * T + pl + q] = m[q];
      __syncthreads();
      PHASE_MARK(step, 2)
      if (live) {
        float mm[RPT];
        tile::load_vec<RPT>(mm, rd + pl);
        for (int k = 1; k < C; ++k) {
          float u[RPT];
          tile::load_vec<RPT>(u, rd + k * T + pl);
#pragma unroll
          for (int q = 0; q < RPT; ++q) mm[q] = fmaxf(mm[q], u[q]);
        }
        const int out = me[kOut];
        float* dst = a.clv + ((size_t)out * C * S + c * S) * Ppad + p;
        float scale[RPT];
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          int e = ((__float_as_int(mm[q]) >> 23) & 0xFF) - 126;
          if (!(mm[q] > 0.f)) e = 0;
          e = min(max(e, -125), 127);
          scale[q] = __int_as_float((127 - e) << 23);
          st[q] += e;
        }
#pragma unroll
        for (int i = 0; i < MAXS; ++i)
          if (i < S) {
            float u[RPT];
#pragma unroll
            for (int q = 0; q < RPT; ++q)
              u[q] = __fmul_rn(o[q][i], scale[q]);
            tile::store_run<RPT, false>(dst + (size_t)i * Ppad, u, p, Ppad,
                                        vec);
          }
        if (c == 0)
          tile::store_run<RPT, false>(a.sc + (size_t)out * Ppad + p, st, p,
                                      Ppad, vec);
      }
      PHASE_MARK(step, 3)
    }
  }
}

// ---------------------------------------------------------------------------
// the tile walk (beyond 8 states)
// ---------------------------------------------------------------------------
// A 2-D tensor copy (global -> shared) of the box at column x, row y of
// `map`, its completion counted in bytes on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(tile::smem_ptr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y),
      "r"(tile::smem_ptr(bar))
      : "memory");
}

// TMA: one thread issues a step's copies, each side's table and scaler
// row or codes a bulk copy and its child tile one tensor copy of
// clv_map (the CLVs as [n_pos * C*S rows, Ppad columns], boxes of C*S x
// T), counted on the stage buffer's mbarrier; else every thread issues
// 16-byte cp.async copies (a C*S beyond a box's 256 rows, or sources not
// 16-byte aligned).
template <int MAXS, int RI, int RP, bool STAGE, bool TMA>
__global__ void __launch_bounds__(kThreads)
tile_walk(WalkArgs a, const __grid_constant__ CUtensorMap clv_map) {
  extern __shared__ __align__(16) float walk_smem[];
  const int T = a.T, C = a.C, S = a.S, CS = C * S, SP = a.SP, IG = a.IG;
  const int R = a.R, Ppad = a.Ppad;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int npg = T / RP, lane_thr = C * IG * npg;
  const int l = tid / lane_thr, rest = tid - l * lane_thr;
  const int pg = rest % npg, ig = (rest / npg) % IG, c = rest / (npg * IG);
  const int i0 = ig * RI, pl0 = pg * RP;
  const int p0 = blockIdx.x * T, p = p0 + pl0;
  const bool vec = (T % 4 == 0) && (Ppad % 4 == 0);
  const int mq = STAGE ? tile::round_up((int)a.Q, 32) : 0;
  const int sb = tile::round_up(mq + CS * T + 2 * T, 32);
  float* base = walk_smem + ((kAlign - (tile::smem_ptr(walk_smem) &
                                        (kAlign - 1))) & (kAlign - 1)) / 4;
  // the maxima of two steps [2][R][C * IG][T]: a step whose sides were
  // issued ahead passes no barrier before its maxima, so a lane's next
  // step writes the other half while a slower thread still reads this one
  float* red = base + 4 * R * sb;
  int* meta = reinterpret_cast<int*>(  // [kRing][R] entries
      red + tile::round_up(2 * R * C * IG * T, 4));
  unsigned long long* bars =  // [2] a stage buffer
      reinterpret_cast<unsigned long long*>(meta + kRing * R * kMeta);
  const bool writes_sc = c == 0 && ig == 0;

  // side k of lane ll's row in stage buffer b: its table [Q] (STAGE), X
  // [C*S][T], then the scaler row [T] and the tip codes [T]
  auto buf = [&](int b, int ll, int k) {
    return base + ((b * R + ll) * 2 + k) * sb;
  };
  auto table_floats = [&](int tip) {
    return C * (tip >= 0 ? a.n_codes : S) * SP;
  };
  // the sides of the rows of the step in ring slot `slot` into buffer b
  auto issue = [&](int slot, int b) {
    if (TMA) {
      if (tid != 0) return;
      const unsigned valid = 4u * min(T, Ppad - p0);
      unsigned bytes = 0;
      for (int ll = 0; ll < R; ++ll) {
        const int* me = meta + ((slot % kRing) * R + ll) * kMeta;
        if (me[kRow] < 0) break;
        for (int k = 0; k < 2; ++k) {
          const int tip = me[kTip + k];
          if (STAGE) bytes += 4u * table_floats(tip);
          bytes += tip >= 0 ? valid : 4u * CS * T + valid;
        }
      }
      unsigned long long* bar = bars + b;
      tile::mbar_expect(bar, bytes);
      for (int ll = 0; ll < R; ++ll) {
        const int* me = meta + ((slot % kRing) * R + ll) * kMeta;
        if (me[kRow] < 0) break;
        for (int k = 0; k < 2; ++k) {
          const int tip = me[kTip + k], pos = me[kPos + k];
          if (STAGE)
            tile::bulk_copy(buf(b, ll, k),
                            a.mats + (size_t)me[kSide + k] * a.Q,
                            4u * table_floats(tip), bar);
          float* X = buf(b, ll, k) + mq;
          int* sc = reinterpret_cast<int*>(X + CS * T);
          if (tip >= 0) {
            tile::bulk_copy(sc + T, a.codes + (size_t)tip * Ppad + p0, valid,
                            bar);
          } else {
            tma_load_2d(X, &clv_map, p0, pos * CS, bar);
            tile::bulk_copy(sc, a.sc + (size_t)pos * Ppad + p0, valid, bar);
          }
        }
      }
      return;
    }
    for (int ll = 0; ll < R; ++ll) {
      const int* me = meta + ((slot % kRing) * R + ll) * kMeta;
      if (me[kRow] < 0) break;
      for (int k = 0; k < 2; ++k) {
        const int tip = me[kTip + k], pos = me[kPos + k];
        if (STAGE)
          tile::copy_run(buf(b, ll, k),
                         a.mats + (size_t)me[kSide + k] * a.Q,
                         table_floats(tip), tid, nthr);
        float* X = buf(b, ll, k) + mq;
        int* sc = reinterpret_cast<int*>(X + CS * T);
        if (tip >= 0) {
          tile::copy_tile(sc + T, a.codes + (size_t)tip * Ppad, 0, 1, T, p0,
                          Ppad, vec, tid, nthr);
        } else {
          tile::copy_tile(X, a.clv + (size_t)pos * CS * Ppad, Ppad, CS, T,
                          p0, Ppad, vec, tid, nthr);
          tile::copy_tile(sc, a.sc + (size_t)pos * Ppad, 0, 1, T, p0, Ppad,
                          vec, tid, nthr);
        }
      }
    }
  };
  // child k of the lane's row (entry me, stage buffer b) times its
  // matrix: acc, and its scaler row scv
  auto side = [&](const int* me, int b, int k, float (&acc)[RI][RP],
                  int (&scv)[RP]) {
    const float* M =
        STAGE ? buf(b, l, k) : a.mats + (size_t)me[kSide + k] * a.Q;
    const float* X = buf(b, l, k) + mq;
    const int* sc = reinterpret_cast<const int*>(X + CS * T);
    if (me[kTip + k] >= 0) {
      tile::lookup<RI, RP>(M + (size_t)c * a.n_codes * SP, sc + T, a.n_codes,
                           SP, i0, pl0, acc);
#pragma unroll
      for (int x = 0; x < RP; ++x) scv[x] = 0;
    } else {
      tile::product<RI, RP, MAXS>(M + (size_t)c * S * SP, X + c * S * T, S,
                                  SP, T, i0, pl0, acc);
#pragma unroll
      for (int x = 0; x < RP; ++x) scv[x] = sc[pl0 + x];
    }
  };

  // the ring's first two steps
  Cursor next2 = first_step(a);
  for (int s = 0; s < 2; ++s) {
    if (tid < R) {
      int4 v[2];
      load_meta(a, next2, tid, v);
      store_meta(meta, s, R, tid, v);
    }
    advance(next2, a);
  }
  if (TMA && tid == 0) {
    for (int i = 0; i < 2; ++i) tile::mbar_init(bars + i, 1);
    tile::mbar_fence_init();
  }
  PHASE_INIT
  int step = 0;
  bool ahead = false;  // whether this step's sides were issued already
  for (int w = 0; w < a.n_windows; ++w) {
    const int r0 = window_row(a, w), r1 = window_row(a, w + 1);
    for (int base = r0; base < r1; base += R, ++step) {
      PHASE_MARK(step, 0)
      const int b = step & 1;
      if (!ahead) {
        // the last window's stores (for the tensor copies' proxy too);
        // the ring; buffer b
        if (TMA) asm volatile("fence.proxy.async.global;\n" ::: "memory");
        __syncthreads();
        issue(step, b);
        if (!TMA) tile::cp_commit();
      }
      ahead = base + R < r1;
      if (ahead) issue(step + 1, b ^ 1);
      if (!TMA) tile::cp_commit();
      int4 v[2];  // step + 2's entry, stored before the maxima's barrier
      if (tid < R) load_meta(a, next2, tid, v);
      advance(next2, a);
      PHASE_MARK(step, 1)
      if (TMA) {
        tile::mbar_wait(bars + b, (unsigned)(step >> 1) & 1u);
      } else {
        tile::cp_wait(1);  // this step's group
        __syncthreads();
      }
      PHASE_MARK(step, 2)
      const int* me = meta + ((step % kRing) * R + l) * kMeta;
      const bool live = me[kRow] >= 0;
      float o[RI][RP], o2[RI][RP];
      int s1[RP], s2[RP];
      float m[RP];
#pragma unroll
      for (int x = 0; x < RP; ++x) m[x] = -INFINITY;
      if (live) {
        side(me, b, 0, o, s1);
        side(me, b, 1, o2, s2);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int x = 0; x < RP; ++x) {
            o[i][x] = __fmul_rn(o[i][x], o2[i][x]);
            if (i0 + i < S) m[x] = fmaxf(m[x], o[i][x]);
          }
      }
      PHASE_MARK(step, 3)
      if (tid < R) store_meta(meta, step + 2, R, tid, v);
      float* rd = red + ((size_t)(step & 1) * R + l) * C * IG * T;
#pragma unroll
      for (int x = 0; x < RP; ++x) rd[(c * IG + ig) * T + pl0 + x] = m[x];
      __syncthreads();
      PHASE_MARK(step, 4)
      if (!live) continue;
      float mm[RP];
      tile::load_vec<RP>(mm, rd + pl0);
#pragma unroll 4
      for (int g = 1; g < C * IG; ++g) {
        float u[RP];
        tile::load_vec<RP>(u, rd + g * T + pl0);
#pragma unroll
        for (int x = 0; x < RP; ++x) mm[x] = fmaxf(mm[x], u[x]);
      }
      int st[RP];
      float scale[RP];
#pragma unroll
      for (int x = 0; x < RP; ++x) {
        int e = ((__float_as_int(mm[x]) >> 23) & 0xFF) - 126;
        if (!(mm[x] > 0.f)) e = 0;
        e = min(max(e, -125), 127);
        scale[x] = __int_as_float((127 - e) << 23);
        st[x] = s1[x] + s2[x] + e;
      }
      const int out = me[kOut];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int x = 0; x < RP; ++x) o[i][x] = __fmul_rn(o[i][x], scale[x]);
        if (i0 + i < S)
          tile::store_run<RP, false>(
              a.clv + ((size_t)out * CS + c * S + i0 + i) * Ppad + p, o[i],
              p, Ppad, vec);
      }
      if (writes_sc)
        tile::store_run<RP, false>(a.sc + (size_t)out * Ppad + p, st, p,
                                   Ppad, vec);
      PHASE_MARK(step, 5)
    }
  }
  if (!TMA) tile::cp_wait(0);
}

// ---------------------------------------------------------------------------
// the launch: pre-pass, then the walk of the configuration
// ---------------------------------------------------------------------------
template <int MAXS>
int launch_walk(const WalkArgs& a, const Config& cf, const CUtensorMap& map,
                cudaStream_t stream) {
  const dim3 grid((a.Ppad + a.T - 1) / a.T), block(cf.threads);
  if constexpr (MAXS <= 8) {
    return common::launch_kernel(a.S == MAXS ? thread_walk<MAXS, true>
                                             : thread_walk<MAXS, false>,
                                 grid, block, (size_t)cf.smem, stream, a);
  } else {
    constexpr int RI = MAXS == 20 ? 4 : 8;
    using Kern = void (*)(WalkArgs, const CUtensorMap);
    Kern kern;
    if (cf.kind == kTile)
      kern = cf.staged ? (a.tma ? tile_walk<MAXS, RI, 4, true, true>
                                : tile_walk<MAXS, RI, 4, true, false>)
                       : (a.tma ? tile_walk<MAXS, RI, 4, false, true>
                                : tile_walk<MAXS, RI, 4, false, false>);
    else
      kern = cf.staged ? tile_walk<MAXS, MAXS, 1, true, false>
                       : tile_walk<MAXS, MAXS, 1, false, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cf.smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, block, cf.smem, stream>>>(a, map);
    return (int)cudaGetLastError();
  }
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry
// point query (no link to libcuda), looked up once; null where missing.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tile walk's tensor map of the CLVs [n_pos * C*S, Ppad], boxes of
// C*S rows x T columns, where the copies allow it (C*S <= 256, T and
// Ppad multiples of 4, sources 16-byte aligned): true, else false (the
// cp.async copies).
inline bool clv_tensor_map(const WalkArgs& a, const Config& cf, int n_pos,
                           CUtensorMap* map) {
  const int CS = a.C * a.S;
  if (cf.kind != kTile || CS > 256 || a.T % 4 || a.Ppad % 4) return false;
  for (const void* ptr : {(const void*)a.clv, (const void*)a.sc,
                          (const void*)a.codes, (const void*)a.mats})
    if (reinterpret_cast<size_t>(ptr) % 16) return false;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)a.Ppad, (cuuint64_t)n_pos * CS};
  const cuuint64_t strides[1] = {(cuuint64_t)a.Ppad * 4};
  const cuuint32_t box[2] = {(cuuint32_t)a.T, (cuuint32_t)CS};
  const cuuint32_t estrides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a.clv, dims,
                strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The pre-pass into mats [n_sides, Q] and the row table into rowtab
// [n_rows, kMeta] (scratch of the caller), then the walk over windows
// [n_windows + 1] at tile T with R lanes. Returns the CUDA error code of
// the launches (0 = queued).
template <int KERNEL, typename Rows>
int run(const Rows& rows, int n_sides, int n_rows, int n_pos,
        const int* windows, int n_windows, const int* codes,
        const float* codetab, int n_codes, float* clv, int* sc, int Ppad,
        int C, int S, int T, int R, float* mats, int* rowtab,
        cudaStream_t stream) {
  Config cf;
  if (n_sides <= 0 || n_rows <= 0 || n_pos <= 0 || n_windows <= 0 ||
      Ppad <= 0 || mats == nullptr || rowtab == nullptr ||
      !walk_config(C, S, n_codes, T, R, &cf))
    return (int)cudaErrorInvalidValue;
  int err = tables::launch_sides<KERNEL>(rows, n_sides, codetab, n_codes,
                                         mats, C, S, cf.sp, cf.q, stream);
  if (err) return err;
  row_table<Rows><<<(n_rows + 255) / 256, 256, 0, stream>>>(rows, n_rows,
                                                            rowtab);
  err = (int)cudaGetLastError();
  if (err) return err;
  WalkArgs a{windows, n_windows, n_rows, rowtab, mats, cf.q, codes,
             n_codes, clv, sc, Ppad, C, S, T, R, cf.sp, cf.ig, 0};
  CUtensorMap map{};
  a.tma = S > 8 && clv_tensor_map(a, cf, n_pos, &map);
  return common::dispatch_states(S, [&](auto m) {
    return launch_walk<decltype(m)::value>(a, cf, map, stream);
  });
}

}  // namespace group_walk
