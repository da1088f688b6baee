// Per-level pruning kernels for Hopper (sm_90a): one level of a
// LevelSchedule a launch, in the C*S x P layout clvs [n_slots, C*S, Ppad] /
// scalers [n_slots, Ppad]. A level's rows are [W, 6] int32 (slot1, slot2,
// is_tip1, is_tip2, tip1, tip2), its matrices [W, C, S, S] per child.
//
//  * pllmod_child_pass replaces the TPU kernel
//    pllmod_tpu/ops/pallas_clv.py::_make_child_kernel (call in
//    _child_pass): out[w] = P[w] x child(w) for one child (side 0 or 1) of
//    every row w, [W, C*S, Ppad], and the child's scaler row (0 for a tip).
//    Its own kernel, child_kernel below.
//  * pllmod_child2_pass replaces pallas_clv.py::_make_child2_kernel: the
//    second child times its matrix, times `left` (the side-0 pass's
//    output), the exact power-of-two rescale and the cumulative scaler
//    s1 + s2 + e, written straight into slots [off, off + W) of the
//    buffers. The JAX dynamic_update_slice has no counterpart: a level's
//    children live in earlier levels, so no launch reads a slot it writes.
//  * pllmod_level_combined replaces pallas_clv.py::_make_combined_kernel:
//    both children, product and rescale in one launch, written in place
//    the same way. The TPU kernel's full-buffer copy (a workaround for
//    Mosaic's alias analysis) has no counterpart.
//
// Design of the two combining kernels (level_kernel). Grid (pattern tile,
// row): a CTA owns row w of the level and T pattern columns; thread (c, p)
// owns category c of pattern p. It reads
// the S values of its child(ren) into registers (coalesced across p),
// applies the category's S x S matrix row by row and, in the two
// combining kernels, multiplies, exchanges its category maximum through
// shared memory and rescales. Tip children are expanded from int32 tip
// codes through the code -> CLV table, never from expanded tip planes.
// The row's matrices and the code table are staged in shared memory when
// they fit (a template flag), else read from device memory, where they
// stay in L1/L2.
//
// Design of the child pass (child_kernel). Grid (pattern tile, row,
// category block), sized by the level's width W (ops/_build.py::
// child_tile): wide levels take 128-pattern tiles, narrow ones (W = 1 at
// the top of the tree) smaller tiles, so that every level launches about
// one CTA an SM or more. Thread (c, ig, pg) owns RI states x 4 patterns of
// category c (csrc/tile.cuh's register tile): the child's tile arrives in
// shared memory by 16-byte cp.async while the CTA stages the row's matrix
// transposed; outputs leave as 16-byte streaming stores (st.global.cs:
// the second-child pass or the torch combine reads them once). A tip
// child is a lookup of its table PT[c][code][i] = row_dot(P_c, i,
// codetab[code]), built in shared memory, where the tile has at least as
// many patterns as the table has codes (else the CTA multiplies the
// expanded codes, as the table build would cost more).
//
// Exactness: the walks' contract of csrc/common.cuh, products and sums
// rounded separately (__fmul_rn / __fadd_rn) in child-state order j =
// 0..S-1 and the rescale the bit formula clipped to [-125, 127]
// (pallas_clv.py:224-232), so each kernel equals its plain version in
// ops/levels.py bit for bit.
//
// Bound on the H100 at the flagship (128 taxa x 16384 patterns GTR+G4,
// C*S = 16, 126 rows in 17 levels; chip_smoke.py computes the exact
// figure from the run's tables): bytes, for all three. Over one
// evaluation the side-0 child pass writes 126 blocks of 16 x 16384 floats
// (132 MB) and reads the inner children's (~65 MB): ~60 us at 3.35 TB/s,
// ~3.5 us a launch. The second-child pass reads that again beside its own
// children and writes the level blocks (~330 MB, ~6 us a launch); the
// combined kernel reads the children once and writes the blocks (~200
// MB). The operations (2 C*S*S flops a pattern for an inner child, the
// rescale's 3 C*S) come to ~0.4 GFLOP an evaluation, ~6 us at 67 TFLOP/s.
#include "common.cuh"
#include "tile.cuh"

namespace {

using common::kMaxThreads;

// [W, 6] row columns: slot1, slot2, is_tip1, is_tip2, tip1, tip2
constexpr int kSlot = 0, kIsTip = 2, kTip = 4;

enum Mode { kChild = 0, kChild2 = 1, kCombined = 2 };

struct LevelArgs {
  const int* idx;        // [W, 6]
  int W, side;           // side: the child pass's child (kChild)
  const float* P1;       // [W, C, S, S]: kChild the pass's, kChild2 side
                         // 1's, kCombined side 0's matrices
  const float* P2;       // kCombined: [W, C, S, S] side 1's
  float* clvs;           // [n_slots, C*S, Ppad]: the children; kChild2 and
                         // kCombined write slots [off, off + W)
  int* scalers;          // [n_slots, Ppad]
  int n_slots;
  const int* codes;      // [n_tips, Ppad]
  int n_tips;
  const float* codetab;  // [n_codes, S]
  int n_codes;
  const float* left;     // kChild2: [W, C*S, Ppad]
  const int* s1;         // kChild2: [W, Ppad]
  float* out;            // kChild: [W, C*S, Ppad]
  int* out_sc;           // kChild: [W, Ppad]
  int off, Ppad, C, S, T;
};

int n_mats(int mode) { return mode == kCombined ? 2 : 1; }

// ---------------------------------------------------------------------------
// the child pass (kernel 3)
// ---------------------------------------------------------------------------
constexpr int kChildRP = 4;  // patterns a thread (one 16-byte vector)

// states a thread for the state ladder's MAXS
template <int MAXS>
constexpr int child_ri() { return (MAXS == 4 || MAXS == 20) ? 4 : 8; }

// A launch configuration of the child pass; ops/_build.py::child_config
// mirrors it.
struct ChildConfig {
  int ri, ig, sp, cb, lookup, threads, mrows;
  long long smem;
};

// The configuration at pattern tile T (a multiple of 4), or false: CB
// categories a CTA (as many as the 256 threads and shared memory allow),
// tip children as lookups where n_codes <= T. Shared memory a category:
// mrows = S (+ n_codes with the lookup) rows of SP floats (the transposed
// matrix, then the tip table) and the child's S x T tile.
bool child_config(int C, int S, int n_codes, int T, ChildConfig* cf) {
  if (C < 1 || S < 1 || S > 64 || n_codes < 1 || T < 4 || T % kChildRP)
    return false;
  int ri = 0;
  common::dispatch_states(S, [&](auto m) {
    ri = child_ri<decltype(m)::value>();
    return 0;
  });
  const int ig = (S + ri - 1) / ri, sp = ig * ri;
  const int per_c = ig * (T / kChildRP);
  if (per_c > kMaxThreads) return false;
  for (int lookup = n_codes <= T ? 1 : 0; lookup >= 0; --lookup) {
    const int mrows = S + (lookup ? n_codes : 0);
    const long long unit = (long long)mrows * sp + (long long)S * T;
    const long long room = (long long)common::kSmemOptin / 4 - 2LL * T;
    long long cb = kMaxThreads / per_c;
    if (cb > C) cb = C;
    if (cb > room / unit) cb = room / unit;
    if (cb >= 1) {
      *cf = ChildConfig{ri, ig, sp, (int)cb, lookup, (int)cb * per_c, mrows,
                        4 * (cb * unit + 2LL * T)};
      return true;
    }
  }
  return false;
}

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


// Shared memory beside the category maxima [C][T]: the code table and the
// row's matrices.
size_t stage_floats(int mode, int C, int S, int n_codes) {
  return (size_t)n_codes * S + (size_t)n_mats(mode) * C * S * S;
}

// Child k of the row: its S values of category c at pattern p, and its
// scaler (read by category 0 only, which alone writes scalers).
template <int MAXS>
__device__ __forceinline__ void load_child(const LevelArgs& a,
                                           const float* tab, const int* row,
                                           int k, int c, int p,
                                           float (&x)[MAXS], int& sc) {
  const int S = a.S;
  if (row[kIsTip + k] != 0) {
    const int tip = min(max(row[kTip + k], 0), a.n_tips - 1);
    common::load_tip<MAXS>(tab, a.codes[(size_t)tip * a.Ppad + p], a.n_codes,
                           S, x);
    sc = 0;
    return;
  }
  const int slot = min(max(row[kSlot + k], 0), a.n_slots - 1);
  common::load_column<MAXS>(
      a.clvs + ((size_t)slot * a.C * S + c * S) * a.Ppad + p, a.Ppad, S, x);
  sc = (c == 0) ? a.scalers[(size_t)slot * a.Ppad + p] : 0;
}

template <int MAXS, int MODE, bool STAGE>
__global__ void __launch_bounds__(kMaxThreads)
level_kernel(LevelArgs a) {
  extern __shared__ float smem[];
  const int T = a.T, C = a.C, S = a.S, CS = C * S;
  const int w = blockIdx.y;
  const int tid = threadIdx.x;
  const int c = tid / T;
  const int pl = tid - c * T;
  const int p = blockIdx.x * T + pl;
  const size_t msz = (size_t)C * S * S;
  float* red = smem;                        // [C][T]
  float* tab_s = red + C * T;               // [n_codes * S]
  float* P_s = tab_s + a.n_codes * S;       // [n_mats][C*S*S]
  const float* Pw1 = a.P1 + w * msz;
  const float* Pw2 = MODE == kCombined ? a.P2 + w * msz : Pw1;
  if (STAGE) {
    for (int i = tid; i < a.n_codes * S; i += blockDim.x)
      tab_s[i] = a.codetab[i];
    for (size_t i = tid; i < msz; i += blockDim.x) {
      P_s[i] = Pw1[i];
      if (MODE == kCombined) P_s[msz + i] = Pw2[i];
    }
    __syncthreads();
  }
  const float* tab = STAGE ? tab_s : a.codetab;
  const float* Pa = (STAGE ? P_s : Pw1) + c * S * S;
  const float* Pb = (STAGE ? P_s + msz : Pw2) + c * S * S;
  const int* row = a.idx + 6 * w;
  constexpr int kUnrollRows = common::unroll_rows<MAXS>();
  float x[MAXS];
  int sc;

  // level_kernel is instantiated for kChild2 and kCombined only (the child
  // pass has child_kernel). This branch and LevelArgs' child-pass fields
  // stay as they were before, which keeps the two kernels' code: without
  // them the 20-state second-child pass ran 28 % slower on the H100.
  if (MODE == kChild) {
    load_child<MAXS>(a, tab, row, a.side, c, p, x, sc);
    float* dst = a.out + ((size_t)w * CS + c * S) * a.Ppad + p;
#pragma unroll kUnrollRows
    for (int i = 0; i < MAXS; ++i)
      if (i < S) dst[(size_t)i * a.Ppad] = common::row_dot<MAXS>(Pa, i, S, x);
    if (c == 0) a.out_sc[(size_t)w * a.Ppad + p] = sc;
    return;
  }

  // the products first, then their maximum in a loop of its own: one
  // loop of both makes the 20-state second-child pass ~30 % slower
  float o[MAXS];
  int stot;
  if (MODE == kChild2) {
    load_child<MAXS>(a, tab, row, 1, c, p, x, sc);
    const float* lw = a.left + ((size_t)w * CS + c * S) * a.Ppad + p;
#pragma unroll kUnrollRows
    for (int i = 0; i < MAXS; ++i)
      if (i < S)
        o[i] = __fmul_rn(lw[(size_t)i * a.Ppad],
                         common::row_dot<MAXS>(Pa, i, S, x));
    stot = (c == 0) ? a.s1[(size_t)w * a.Ppad + p] + sc : 0;
  } else {
    float x2[MAXS];
    int sc2;
    load_child<MAXS>(a, tab, row, 0, c, p, x, sc);
    load_child<MAXS>(a, tab, row, 1, c, p, x2, sc2);
#pragma unroll kUnrollRows
    for (int i = 0; i < MAXS; ++i)
      if (i < S)
        o[i] = __fmul_rn(common::row_dot<MAXS>(Pa, i, S, x),
                         common::row_dot<MAXS>(Pb, i, S, x2));
    stot = sc + sc2;
  }
  float m = -INFINITY;
#pragma unroll kUnrollRows
  for (int i = 0; i < MAXS; ++i)
    if (i < S) m = fmaxf(m, o[i]);
  const int e = common::rescale_exponent(red, m, c, pl, C, T);
  const size_t slot = (size_t)a.off + w;
  common::store_scaled<MAXS>(a.clvs + (slot * CS + c * S) * a.Ppad + p,
                             a.Ppad, S, o, e);
  if (c == 0) a.scalers[slot * a.Ppad + p] = stot + e;
}

template <int MAXS, int MODE>
int launch_t(const LevelArgs& a, cudaStream_t stream) {
  const size_t stage = stage_floats(MODE, a.C, a.S, a.n_codes);
  const bool staged = common::fits_smem((size_t)a.C * a.T + stage);
  const size_t smem = 4 * ((size_t)a.C * a.T + (staged ? stage : 0));
  return common::launch_kernel(staged ? level_kernel<MAXS, MODE, true>
                                      : level_kernel<MAXS, MODE, false>,
                               dim3(a.Ppad / a.T, a.W), dim3(a.C * a.T), smem,
                               stream, a);
}

template <int MODE>
int launch(const LevelArgs& a, cudaStream_t stream) {
  if (a.C * a.T > kMaxThreads || a.T <= 0 || a.Ppad % a.T != 0 ||
      a.W <= 0 || a.W > 65535)
    return (int)cudaErrorInvalidConfiguration;
  return common::dispatch_states(a.S, [&](auto m) {
    return launch_t<decltype(m)::value, MODE>(a, stream);
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
        child_kernel<decltype(m)::value, child_ri<decltype(m)::value>()>,
        grid, block,
        (size_t)cf.smem, st, a);
  });
}

// The child pass's configuration at pattern tile T: out[0..7] = RI, IG,
// SP, CB, lookup, threads, matrix rows a category, shared memory bytes;
// returns 1, or 0 where none fits. ops/_build.py computes the same
// without the library.
extern "C" int pllmod_child_config(int C, int S, int n_codes, int T,
                                   long long* out) {
  ChildConfig cf;
  if (!child_config(C, S, n_codes, T, &cf)) return 0;
  const long long v[8] = {cf.ri, cf.ig, cf.sp, cf.cb, cf.lookup, cf.threads,
                          cf.mrows, cf.smem};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 1;
}

extern "C" int pllmod_child2_pass(
    const int* idx, int W, const float* P, float* clvs, int* scalers,
    int n_slots, const int* codes, int n_tips, const float* codetab,
    int n_codes, const float* left, const int* s1, int off, int Ppad, int C,
    int S, int T, void* stream) {
  if (off < 0 || off + W > n_slots) return (int)cudaErrorInvalidValue;
  LevelArgs a{idx, W, 1, P, nullptr, clvs, scalers, n_slots, codes, n_tips,
              codetab, n_codes, left, s1, nullptr, nullptr, off, Ppad, C, S,
              T};
  return launch<kChild2>(a, static_cast<cudaStream_t>(stream));
}

extern "C" int pllmod_level_combined(
    const int* idx, int W, const float* P1, const float* P2, float* clvs,
    int* scalers, int n_slots, const int* codes, int n_tips,
    const float* codetab, int n_codes, int off, int Ppad, int C, int S,
    int T, void* stream) {
  if (off < 0 || off + W > n_slots) return (int)cudaErrorInvalidValue;
  LevelArgs a{idx, W, 0, P1, P2, clvs, scalers, n_slots, codes, n_tips,
              codetab, n_codes, nullptr, nullptr, nullptr, nullptr, off,
              Ppad, C, S, T};
  return launch<kCombined>(a, static_cast<cudaStream_t>(stream));
}
