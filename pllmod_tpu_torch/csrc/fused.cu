// The fused walk for Hopper (sm_90a): a whole table of CLV (conditional
// likelihood vector) updates in one launch, every CLV and cumulative
// scaler row left in device memory.
//
// pllmod_fused_walk replaces the TPU kernel
// pllmod_tpu/ops/pallas_clv.py::_make_fused_kernel (thread_scalers=True,
// split=False): rows idx8 [nW, 8] (slot1, slot2, is_tip1, is_tip2, tip1,
// tip2, out, fence) over clvs [n_slots, C*S, Ppad] / scalers [n_slots,
// Ppad]; the fence column is not read. One call launches two kernels:
//
//  * tables_kernel (the pre-pass, csrc/tables.cuh, shared with the
//    resident walk): for every row side, the matrix
//    transposed and padded, M[c][j][i] = P[c][i][j], or, for a tip child,
//    its table PT[c][code][i] = row_dot(P_c, i, codetab[code]), into the
//    caller's scratch mats [nW, 2, Q] (csrc/tile.cuh has the layouts). A
//    tip child then costs a lookup a pattern instead of C*S*S
//    multiply-adds, and its table is built once a launch, not once a CTA.
//  * the walk: one CTA owns T pattern columns and walks every row in
//    order (pattern columns are independent: no CTA waits on another).
//    Two designs, by the state count (walk_config):
//    - thread_walk, up to 8 states: thread (c, p) owns category c of
//      pattern p and keeps its S states in registers, so it reads only
//      values it wrote itself. Row w + 2's children are loaded into
//      registers, and its tables into shared memory by cp.async, while
//      row w computes: each row's loads were issued two rows earlier, and
//      a row costs one barrier (the category maxima). At DNA shapes the
//      walk is bound by that per-row chain, not by bytes or operations.
//    - walk_kernel, beyond 8 states: the per-thread states no longer fit
//      registers. Thread (c, ig, pg) computes RI = 8 (4 at 20 states)
//      states x RP = 4 patterns of category c, a register tile of both
//      children's products from the children's tiles X [C*S][T] and the
//      staged matrices in shared memory; the category maximum of a
//      pattern meets in shared memory. Each child is a stage: its matrix
//      or tip table and its CLV and scaler tile (or tip codes) go to a
//      ring of NB stage buffers by 16-byte cp.async, NB - 1 stages ahead
//      of the stage that computes; the idx8 rows go to a ring of 4 in
//      shared memory two rows ahead. One barrier a stage and one for the
//      maximum.
//    In both, the one hazard of fetching ahead is a child that a row
//    still computing writes: it cannot be fetched before that row stores
//    it. Such a child (its slot is row w's out slot and its fetch is
//    issued before row w ends: rows w + 1 and w + 2 in the thread walk,
//    the first NB - 1 children of row w + 1 in the tile walk) is not
//    fetched; row w hands its scaled output and scaler row over in
//    registers (thread walk) or in that stage's buffer (tile walk). Every other child is fetched after its producer's stores
//    (program order in the thread walk, a barrier in the tile walk). A
//    CTA reads and writes only its own pattern columns, so out slots may
//    alias child slots (slot recycling) and the directed, serial and
//    incremental tables run as they are.
//
// Exactness: products and sums rounded separately in child-state order
// (csrc/tile.cuh), the rescale the bit formula of csrc/common.cuh, so the
// kernel equals its plain version (ops/clv.py::walk_rows_plain) bit for
// bit; a lookup is the same row_dot as the per-pattern product.
//
// Bound on the H100 (chip_smoke.py computes it from the run's table):
// bytes at DNA (flagship 128 x 16384 GTR+G4: every CLV and scaler row
// written once, ~151 MB, ~45 us at 3.35 TB/s), operations at 64 states
// (128 x 4096, C*S = 256: 126 inner children x 2 C*S*S flops a pattern,
// 17 GFLOP, 0.26 ms at 67 TFLOP/s; without FMA the issue rate halves that
// peak: 0.52 ms). At 64 states one row's matrices take 128 KB, so NB is 2
// and T = 32 (128 CTAs of 256 threads, one an SM); where they do not fit
// at all, a thread owns one category of one pattern and reads them from
// the scratch in device memory (the fallback tile, up to 256 categories).
#include "common.cuh"
#include "tables.cuh"
#include "tile.cuh"

namespace {

using namespace fused;

// [nW, 8] idx8 columns
constexpr int kSlot = 0, kIsTip = 2, kTip = 4, kOut = 6;

// ---------------------------------------------------------------------------
// the walk
// ---------------------------------------------------------------------------
struct WalkArgs {
  const int* idx8;
  int nW;
  const float* mats;     // [nW, 2, Q] from tables_kernel
  long long Q;
  const int* codes;      // [n_tips, Ppad]
  int n_codes;
  float* clvs;           // [n_slots, C*S, Ppad]
  int* scalers;          // [n_slots, Ppad]
  int Ppad, C, S, n_slots, T, SP, IG, NB;
};

// STAGE: the matrices are staged in each stage buffer (else read from
// mats in device memory).
template <int MAXS, int RI, int RP, bool STAGE>
__global__ void __launch_bounds__(kThreads) walk_kernel(WalkArgs a) {
  extern __shared__ __align__(16) float walk_smem[];
  const int T = a.T, C = a.C, S = a.S, CS = C * S, SP = a.SP, IG = a.IG;
  const int NB = a.NB, D = NB - 1, nS = 2 * a.nW;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int npg = T / RP;
  const int pg = tid % npg, rest = tid / npg, ig = rest % IG, c = rest / IG;
  const int i0 = ig * RI, pl0 = pg * RP;
  const int p0 = blockIdx.x * T, p = p0 + pl0;
  const bool vec = (T % 4 == 0) && (a.Ppad % 4 == 0);
  const int mq = STAGE ? (int)a.Q : 0;
  const int sb = tile::round_up(mq + CS * T + 2 * T, 4);
  float* red = walk_smem + NB * sb;  // [C * IG][T]
  int* meta = reinterpret_cast<int*>(  // [4][8] rows
      red + tile::round_up(C * IG * T, 4));
  const bool writes_sc = c == 0 && ig == 0;

  auto buf = [&](int s) { return walk_smem + (s % NB) * sb; };
  auto row_of = [&](int r) { return meta + 8 * (r % kMetaRows); };
  auto is_tip = [&](int r, int k) { return row_of(r)[kIsTip + k] != 0; };
  auto slot_of = [&](int r, int col) {
    return min(max(row_of(r)[col], 0), a.n_slots - 1);
  };
  // row r + 2's idx8 row into the ring (with the stage group in flight)
  auto fetch_row = [&](int r) {
    if (tid == 0 && r + 2 < a.nW) {
      tile::cp16(row_of(r + 2), a.idx8 + 8 * (r + 2), 16);
      tile::cp16(row_of(r + 2) + 4, a.idx8 + 8 * (r + 2) + 4, 16);
    }
  };
  // child k of row r is row r - 1's output and is fetched before row r - 1
  // stores it: row r - 1 forwards it through shared memory
  auto forwarded = [&](int r, int k) {
    return k < D && r > 0 && !is_tip(r, k) &&
           slot_of(r, kSlot + k) == slot_of(r - 1, kOut);
  };
  auto issue = [&](int s) {
    const int r = s >> 1, k = s & 1;
    float* b = buf(s);
    const bool tip = is_tip(r, k);
    if (STAGE)
      tile::copy_run(b, a.mats + (size_t)s * a.Q,
                     C * (tip ? a.n_codes : S) * SP, tid, nthr);
    float* X = b + mq;
    int* sc = reinterpret_cast<int*>(X + CS * T);
    if (tip) {
      tile::copy_tile(sc + T, a.codes + (size_t)row_of(r)[kTip + k] * a.Ppad,
                      0, 1, T, p0, a.Ppad, vec, tid, nthr);
    } else if (!forwarded(r, k)) {
      const int slot = slot_of(r, kSlot + k);
      tile::copy_tile(X, a.clvs + (size_t)slot * CS * a.Ppad, a.Ppad, CS, T,
                      p0, a.Ppad, vec, tid, nthr);
      tile::copy_tile(sc, a.scalers + (size_t)slot * a.Ppad, 0, 1, T, p0,
                      a.Ppad, vec, tid, nthr);
    }
  };
  // wait for stage s, then queue stage s + D into the buffer stage s - 1
  // has left
  auto begin = [&](int s) {
    if (D == 0) {
      __syncthreads();
      issue(s);
      if (!(s & 1)) fetch_row(s >> 1);
      tile::cp_commit();
    }
    tile::cp_wait(D - 1);
    __syncthreads();
    if (D > 0) {
      if (s + D < nS) issue(s + D);
      if (!(s & 1)) fetch_row(s >> 1);
      tile::cp_commit();
    }
  };
  // child (stage s) times its matrix: acc, and its scaler row scv
  auto side = [&](int s, float (&acc)[RI][RP], int (&scv)[RP]) {
    const int r = s >> 1, k = s & 1;
    const float* b = buf(s);
    const float* M = STAGE ? b : a.mats + (size_t)s * a.Q;
    const float* X = b + mq;
    const int* sc = reinterpret_cast<const int*>(X + CS * T);
    if (is_tip(r, k)) {
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

  for (int i = tid; i < 8 * min(a.nW, 2); i += nthr) meta[i] = a.idx8[i];
  __syncthreads();
  for (int d = 0; d < D; ++d) {
    if (d < nS) issue(d);
    tile::cp_commit();
  }
  for (int r = 0; r < a.nW; ++r) {
    float o[RI][RP], o2[RI][RP];
    int s1[RP], s2[RP];
    begin(2 * r);
    side(2 * r, o, s1);
    begin(2 * r + 1);
    side(2 * r + 1, o2, s2);

    float m[RP];
#pragma unroll
    for (int x = 0; x < RP; ++x) m[x] = -INFINITY;
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int x = 0; x < RP; ++x) {
        o[i][x] = __fmul_rn(o[i][x], o2[i][x]);
        if (i0 + i < S) m[x] = fmaxf(m[x], o[i][x]);
      }
#pragma unroll
    for (int x = 0; x < RP; ++x) red[(c * IG + ig) * T + pl0 + x] = m[x];
    __syncthreads();
    int st[RP];
    float scale[RP];
    float mm[RP];
    tile::load_vec<RP>(mm, red + pl0);
    for (int g = 1; g < C * IG; ++g) {
      float v[RP];
      tile::load_vec<RP>(v, red + g * T + pl0);
#pragma unroll
      for (int x = 0; x < RP; ++x) mm[x] = fmaxf(mm[x], v[x]);
    }
#pragma unroll
    for (int x = 0; x < RP; ++x) {
      int e = ((__float_as_int(mm[x]) >> 23) & 0xFF) - 126;
      if (!(mm[x] > 0.f)) e = 0;
      e = min(max(e, -125), 127);
      scale[x] = __int_as_float((127 - e) << 23);
      st[x] = s1[x] + s2[x] + e;
    }
    const int out = slot_of(r, kOut);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int x = 0; x < RP; ++x) o[i][x] = __fmul_rn(o[i][x], scale[x]);
      if (i0 + i < S)
        tile::store_run<RP, false>(
            a.clvs + ((size_t)out * CS + c * S + i0 + i) * a.Ppad + p, o[i],
            p, a.Ppad, vec);
    }
    if (writes_sc)
      tile::store_run<RP, false>(a.scalers + (size_t)out * a.Ppad + p, st, p,
                                 a.Ppad, vec);
    // forward this row's output to the next row's children fetched early
    for (int k = 0; k < 2; ++k) {
      if (r + 1 < a.nW && forwarded(r + 1, k)) {
        float* X = buf(2 * (r + 1) + k) + mq;
        int* sc = reinterpret_cast<int*>(X + CS * T);
#pragma unroll
        for (int i = 0; i < RI; ++i)
          if (i0 + i < S)
#pragma unroll
            for (int x = 0; x < RP; ++x)
              X[(c * S + i0 + i) * T + pl0 + x] = o[i][x];
        if (writes_sc)
#pragma unroll
          for (int x = 0; x < RP; ++x) sc[pl0 + x] = st[x];
      }
    }
  }
  tile::cp_wait(0);
}

// The thread walk (up to 8 states): thread (c, pg) owns category c of RPT
// adjacent patterns (two at up to 4 states: one vector load or store a
// CLV row) and keeps all S of its states in registers, as the resident
// walk does, so a thread reads only CLV and scaler values it wrote itself.
// At DNA shapes a row's work is short and the walk is bound by the
// latency of its loads and by the issue of memory instructions: the
// matrices, tip tables and category maxima are read as vectors, and
// while row w computes, the thread's loads of row w + 2's children are in
// flight into registers and row w + 2's tables into a third row buffer
// (cp.async), two rows ahead. Three register sets hold rows w, w + 1 and
// w + 2 and trade roles from row to row (the loop body is unrolled three
// times), so that no instruction touches a register whose load is in
// flight before its row computes; the idx8 rows come through a ring in
// shared memory, four rows ahead. A child that row w - 1 or w - 2 writes
// was loaded before its writer stored it: row w takes it from the
// writer's output, which the thread keeps in registers for two rows. One
// barrier a row: the category maxima (two buffers by row parity), the
// tables and the idx8 ring.
template <int MAXS>
__host__ __device__ constexpr int thread_rpt() {
  return MAXS <= 4 ? 2 : 1;
}

// v[x] = src[p + x] for x < RPT, one vector load where vec allows; the
// patterns clamped to the last (a ragged tile's spare threads compute on
// copies)
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
struct Child {            // one row's two children, as a thread holds them
  float x1[RPT][MAXS], x2[RPT][MAXS];
  int code1[RPT], code2[RPT], sc1[RPT], sc2[RPT];
};

// EXACT: S == MAXS, so that the state loops need no guards. The tables'
// row stride SP is MAXS (round_up(S, 4) for S up to 8).
template <int MAXS, bool EXACT>
__global__ void __launch_bounds__(kThreads) thread_walk(WalkArgs a) {
  extern __shared__ __align__(16) float walk_smem[];
  constexpr int RPT = thread_rpt<MAXS>(), SP = MAXS;
  const int S = EXACT ? MAXS : a.S;
  const int T = a.T, C = a.C, CS = C * S, nW = a.nW, Ppad = a.Ppad;
  const int tid = threadIdx.x, nthr = blockDim.x, npg = T / RPT;
  const int c = tid / npg, pl = (tid - c * npg) * RPT;
  const int p = blockIdx.x * T + pl;        // this thread's first pattern
  const bool vec = Ppad % RPT == 0;
  const bool stage = a.NB > 0;
  const int Q = stage ? (int)a.Q : 0;
  float* tabs = walk_smem;                  // [3 rows][2 sides][Q]
  float* red = walk_smem + 6 * Q;           // [2 rows][C][T]
  int* meta = reinterpret_cast<int*>(  // [8][8] idx8 rows
      red + tile::round_up(2 * C * T, 4));

  auto row_of = [&](int r) { return meta + 8 * (r % kThreadMeta); };
  auto slot = [&](int v) { return min(max(v, 0), a.n_slots - 1); };
  auto out_of = [&](int r) { return slot(row_of(r)[6]); };
  // row r + 4's idx8 row into the ring (with row r + 2's tables)
  auto fetch_meta = [&](int r) {
    if (tid == 0 && r + 4 < nW) {
      tile::cp16(row_of(r + 4), a.idx8 + 8 * (r + 4), 16);
      tile::cp16(row_of(r + 4) + 4, a.idx8 + 8 * (r + 4) + 4, 16);
    }
  };
  // row r's side-k table (transposed matrix or tip table)
  auto table = [&](int r, int k) -> const float* {
    return stage ? tabs + ((r % 3) * 2 + k) * Q
                 : a.mats + (size_t)(2 * r + k) * a.Q;
  };
  auto stage_tables = [&](int r) {
    if (stage && r < nW)
      for (int k = 0; k < 2; ++k)
        tile::copy_run(tabs + ((r % 3) * 2 + k) * Q,
                       a.mats + (size_t)(2 * r + k) * a.Q,
                       C * (row_of(r)[2 + k] ? a.n_codes : S) * SP, tid,
                       nthr);
  };
  // row r's children into ch (a child that row r - 1 or r - 2 writes is
  // loaded too, stale, and not used)
  auto fetch_row = [&](int r, Child<MAXS, RPT>& ch) {
    if (r >= nW) return;
    const int* row = row_of(r);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (row[2 + k]) {
        load_pats<RPT>(a.codes + (size_t)row[4 + k] * Ppad, p, Ppad, vec,
                       k ? ch.code2 : ch.code1);
        continue;
      }
      const int s = slot(row[k]);
      const float* src = a.clvs + ((size_t)s * CS + c * S) * Ppad;
#pragma unroll
      for (int j = 0; j < MAXS; ++j)
        if (j < S) {
          float v[RPT];
          load_pats<RPT>(src + (size_t)j * Ppad, p, Ppad, vec, v);
#pragma unroll
          for (int x = 0; x < RPT; ++x) (k ? ch.x2 : ch.x1)[x][j] = v[x];
        }
      if (c == 0)
        load_pats<RPT>(a.scalers + (size_t)s * Ppad, p, Ppad, vec,
                       k ? ch.sc2 : ch.sc1);
    }
  };
  // o[x] = (child's matrix) x[x], or the tip's table rows of codes[x]
  auto side = [&](const float* M, bool tip, const int (&code)[RPT],
                  const float (&x)[RPT][MAXS], float (&o)[RPT][MAXS]) {
    if (tip) {
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        tile::load_vec<MAXS>(
            o[q], M + (c * a.n_codes + min(max(code[q], 0), a.n_codes - 1)) *
                          SP);
      return;
    }
    const float* Mc = M + c * S * SP;
    float mv[MAXS];
    tile::load_vec<MAXS>(mv, Mc);
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int i = 0; i < MAXS; ++i) o[q][i] = __fmul_rn(mv[i], x[q][0]);
#pragma unroll
    for (int j = 1; j < MAXS; ++j)
      if (j < S) {
        tile::load_vec<MAXS>(mv, Mc + j * SP);
#pragma unroll
        for (int q = 0; q < RPT; ++q)
#pragma unroll
          for (int i = 0; i < MAXS; ++i)
            o[q][i] = __fadd_rn(o[q][i], __fmul_rn(mv[i], x[q][j]));
      }
  };
  // the outputs of the last two rows (a: row r - 1, b: row r - 2), kept
  // for the children that read them
  float oa[RPT][MAXS] = {}, ob[RPT][MAXS] = {};
  int sta[RPT] = {}, stb[RPT] = {};
  // row r with its children in cur; row r + 2's fetched into fut
  auto step = [&](int r, const Child<MAXS, RPT>& cur, Child<MAXS, RPT>& fut) {
    fetch_row(r + 2, fut);
    stage_tables(r + 2);
    fetch_meta(r);
    tile::cp_commit();

    const int* row = row_of(r);
    const int outa = r >= 1 ? out_of(r - 1) : -1;
    const int outb = r >= 2 ? out_of(r - 2) : -1;
    float o[RPT][MAXS], o2[RPT][MAXS];
    int sc[2][RPT];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = row[2 + k] ? -2 : slot(row[k]);
      const bool fa = s == outa, fb = !fa && s == outb;
      float x[RPT][MAXS];
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
#pragma unroll
        for (int i = 0; i < MAXS; ++i)
          x[q][i] = fa ? oa[q][i]
                       : fb ? ob[q][i] : (k ? cur.x2 : cur.x1)[q][i];
        sc[k][q] = row[2 + k] ? 0
                              : fa ? sta[q] : fb ? stb[q]
                                             : (k ? cur.sc2 : cur.sc1)[q];
      }
      side(table(r, k), row[2 + k] != 0, k ? cur.code2 : cur.code1, x,
           k ? o2 : o);
    }
    float m[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      m[q] = -INFINITY;
#pragma unroll
      for (int i = 0; i < MAXS; ++i)
        if (i < S) {
          o[q][i] = __fmul_rn(o[q][i], o2[q][i]);
          m[q] = fmaxf(m[q], o[q][i]);
        }
    }
    float* rd = red + (r & 1) * C * T;
#pragma unroll
    for (int q = 0; q < RPT; ++q) rd[c * T + pl + q] = m[q];
    tile::cp_wait(1);                       // row r + 1's tables
    __syncthreads();
    float mm[RPT];
    tile::load_vec<RPT>(mm, rd + pl);
    for (int k = 1; k < C; ++k) {
      float v[RPT];
      tile::load_vec<RPT>(v, rd + k * T + pl);
#pragma unroll
      for (int q = 0; q < RPT; ++q) mm[q] = fmaxf(mm[q], v[q]);
    }
    int st[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      int e = ((__float_as_int(mm[q]) >> 23) & 0xFF) - 126;
      if (!(mm[q] > 0.f)) e = 0;
      e = min(max(e, -125), 127);
      const float scale = __int_as_float((127 - e) << 23);
      st[q] = c == 0 ? sc[0][q] + sc[1][q] + e : 0;
#pragma unroll
      for (int i = 0; i < MAXS; ++i) {
        ob[q][i] = oa[q][i];
        oa[q][i] = i < S ? __fmul_rn(o[q][i], scale) : 0.f;
      }
      stb[q] = sta[q];
      sta[q] = st[q];
    }
    const int out0 = out_of(r);
    float* dst = a.clvs + ((size_t)out0 * CS + c * S) * Ppad + p;
#pragma unroll
    for (int i = 0; i < MAXS; ++i)
      if (i < S) {
        float v[RPT];
#pragma unroll
        for (int q = 0; q < RPT; ++q) v[q] = oa[q][i];
        tile::store_run<RPT, false>(dst + (size_t)i * Ppad, v, p, Ppad, vec);
      }
    if (c == 0)
      tile::store_run<RPT, false>(a.scalers + (size_t)out0 * Ppad + p, st, p,
                                  Ppad, vec);
  };

  for (int i = tid; i < 8 * min(nW, 4); i += nthr) meta[i] = a.idx8[i];
  __syncthreads();
  Child<MAXS, RPT> ch0 = {}, ch1 = {}, ch2 = {};
  fetch_row(0, ch0);
  fetch_row(1, ch1);
  stage_tables(0);
  stage_tables(1);
  tile::cp_commit();
  tile::cp_wait(0);
  __syncthreads();
  for (int r = 0; r < nW; r += 3) {
    step(r, ch0, ch2);
    if (r + 1 < nW) step(r + 1, ch1, ch0);
    if (r + 2 < nW) step(r + 2, ch2, ch1);
  }
  tile::cp_wait(0);
}

template <int MAXS>
int launch_walk(const WalkArgs& a, const Config& cf, cudaStream_t stream) {
  const dim3 grid((a.Ppad + a.T - 1) / a.T), block(cf.threads);
  if constexpr (MAXS <= 8) {
    return common::launch_kernel(a.S == MAXS ? thread_walk<MAXS, true>
                                             : thread_walk<MAXS, false>,
                                 grid, block, (size_t)cf.smem, stream, a);
  } else {
    if (cf.kind == kTile)
      return common::launch_kernel(
          walk_kernel<MAXS, tile_ri(MAXS), kTileRP, true>, grid, block,
          (size_t)cf.smem, stream, a);
    return common::launch_kernel(walk_kernel<MAXS, MAXS, 1, false>, grid,
                                 block, (size_t)cf.smem, stream, a);
  }
}

int launch_tables(const int* idx8, int nW, const float* P5,
                  const float* codetab, int n_codes, float* mats, int C,
                  int S, const Config& cf, cudaStream_t stream) {
  return tables::launch_tables<2>(idx8, nW, P5, codetab, n_codes, mats, C,
                                  S, cf.sp, cf.q, stream);
}

}  // namespace

// The pre-pass alone (the walk launches it itself): mats [nW, 2, Q].
extern "C" int pllmod_fused_tables(const int* idx8, int nW, const float* P5,
                                   const float* codetab, int n_codes,
                                   float* mats, int C, int S, int T,
                                   void* stream) {
  Config cf;
  if (nW <= 0 || !walk_config(C, S, n_codes, T, &cf))
    return (int)cudaErrorInvalidValue;
  return launch_tables(idx8, nW, P5, codetab, n_codes, mats, C, S, cf,
                       static_cast<cudaStream_t>(stream));
}

// The fused walk: the pre-pass into mats [nW, 2, Q] (scratch of the
// caller), then the walk. Returns the CUDA error code of the launches (0 =
// queued).
extern "C" int pllmod_fused_walk(
    const int* idx8, int nW, const float* P5, const int* codes,
    const float* codetab, int n_codes, float* clvs, int* scalers, int Ppad,
    int C, int S, int n_slots, int T, float* mats, void* stream) {
  Config cf;
  if (nW <= 0 || Ppad <= 0 || n_slots <= 0 ||
      !walk_config(C, S, n_codes, T, &cf))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_tables(idx8, nW, P5, codetab, n_codes, mats, C, S, cf, st);
  if (err) return err;
  WalkArgs a{idx8, nW, mats, cf.q, codes, n_codes, clvs, scalers, Ppad, C,
             S, n_slots, T, cf.sp, cf.ig, cf.nb};
  return common::dispatch_states(
      S, [&](auto m) { return launch_walk<decltype(m)::value>(a, cf, st); });
}
