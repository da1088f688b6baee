// The launch configurations of the port's kernels, in one place: each
// kernel's kind, threads, shared memory, ring and table strides at a
// shape, and the rules that choose them. The CUDA sources include this
// header and launch what it computes; configs.cpp, built from the same
// header by g++ for the host, exports it to ops/_build.py and
// ops/deriv.py, whose tile rules and routing read it through ctypes. The
// header holds no CUDA: PLLMOD_HD marks the pieces that device code calls
// too (host and device under nvcc, plain C++ under g++).
#pragma once
#include <stddef.h>

#ifdef __CUDACC__
#define PLLMOD_HD __host__ __device__
#else
#define PLLMOD_HD
#endif

// ---------------------------------------------------------------------------
// the card's limits and the state ladder
// ---------------------------------------------------------------------------
namespace common {

constexpr int kMaxThreads = 256;       // __launch_bounds__ of the walks
constexpr size_t kSmemOptin = 232448;  // H100: shared memory a block may opt into
constexpr int kSms = 132;              // H100 SXM: streaming multiprocessors

// Whether `floats` 4-byte words fit one block's shared memory.
inline bool fits_smem(size_t floats) { return 4 * floats <= kSmemOptin; }

// The narrowest register tile MAXS in {4, 8, 16, 20, 32, 64} that holds S
// (at most 64) states: the step of the state ladder that
// common::dispatch_states instantiates.
inline int ladder(int S) {
  return S <= 4 ? 4 : S <= 8 ? 8 : S <= 16 ? 16 : S <= 20 ? 20
       : S <= 32 ? 32 : 64;
}

PLLMOD_HD constexpr long long round4(long long n) { return (n + 3) / 4 * 4; }
constexpr long long round32(long long n) { return (n + 31) / 32 * 32; }

}  // namespace common

namespace tile {

PLLMOD_HD constexpr int round_up(int n, int k) { return (n + k - 1) / k * k; }

}  // namespace tile

// ---------------------------------------------------------------------------
// kernel 1, the resident walk (pruning.cu)
// ---------------------------------------------------------------------------
namespace resident {

constexpr int kThreads = 256;      // __launch_bounds__ of the walk
constexpr int kMetaRows = 16;      // the ring of idx8 rows
constexpr int kNB = 4;             // ring entries (a power of two)
// the thread kind: the most categories a thread holds (C x 4 floats of a
// child in registers, three such a thread: 100 registers at C = 4, 139 at
// C = 8), its patterns a thread (2 measured slower, PERF.md), its ring
// entries (a power of two) and the ints of an entry's idx8 row
constexpr int kThreadMaxC = 8;
constexpr int kThreadRP = 1;
constexpr int kThreadNB = 4;
constexpr int kRowInts = 8;
constexpr int kWarp = 32;
// the split kind: the ladder step it takes, its threads a (category,
// pattern) column and its patterns a thread
constexpr int kSplitMaxS = 20;
constexpr int kSplitH = 2;
constexpr int kSplitRP = 2;

enum Kind { kTile = 0, kGlobal = 1, kThread = 2, kSplit = 3 };
struct Config {
  int kind, rp, sp, threads;
  long long q;      // floats of one row side's table
  long long ring;   // floats of one ring entry
  long long smem;   // dynamic shared memory (bytes)
};

// The widest pattern tile of C categories: C * T <= kThreads.
inline int wide_tile(int C) {
  int T = 64;
  while (T > 1 && C * T > kThreads) T /= 2;
  return T;
}

// The thread kind's configuration at pattern tile T (whole consumer
// warps of kThreadRP patterns a thread, and the producer warp), or false
// where its ring of kThreadNB entries (an idx8 row, the row's two tables,
// two rows of tip codes) and the slots do not fit a block.
inline bool thread_config(int C, int S, int n_codes, int n_slots, int T,
                          Config* cf) {
  constexpr int rp = kThreadRP, sp = 4;
  if (T % (kWarp * rp)) return false;
  const long long threads = T / rp + kWarp;
  if (threads > kThreads) return false;
  const long long q = (long long)C * (S > n_codes ? S : n_codes) * sp;
  const long long ring = kRowInts + 2 * q + 2LL * T;
  const long long smem =
      4 * (4LL * kThreadNB + kThreadNB * ring +
           (long long)n_slots * C * S * T + (long long)n_slots * T);
  if (smem > (long long)common::kSmemOptin) return false;
  *cf = Config{kThread, rp, sp, (int)threads, q, ring, smem};
  return true;
}

// The configuration at pattern tile T, or false where none fits: the
// thread kind up to 4 states and kThreadMaxC categories; else the tile
// kind where a ring of 4 entries of tables fits beside the slots (at the
// 20-state step the split kind in its place, where C * T fills whole
// warps and T is even: the same ring, slots and shared memory, C * T
// consumers and a producer warp), else, at the widest tile, the global
// kind (tables read from mats, a ring of codes), which keeps small
// 64-state trees resident.
inline bool walk_config(int C, int S, int n_codes, int n_slots, int T,
                        Config* cf) {
  if (C < 1 || S < 1 || S > 64 || n_codes < 1 || n_slots < 1 || T < 1)
    return false;
  const int maxs = common::ladder(S), rp = maxs <= 4 ? 2 : 1, sp = maxs;
  if (maxs == 4 && C <= kThreadMaxC)
    return thread_config(C, S, n_codes, n_slots, T, cf);
  if (T % rp) return false;
  const long long threads = (long long)C * (T / rp);
  if (threads > kThreads) return false;
  const long long q = (long long)C * (S > n_codes ? S : n_codes) * sp;
  const long long fixed = 2 * kNB + 8 * kMetaRows +
                          common::round4(2LL * C * T) +
                          (long long)n_slots * C * S * T +
                          (long long)n_slots * T;
  const long long codes = common::round4(2LL * T);
  long long smem = 4 * (fixed + kNB * (2 * q + codes));
  if (smem <= (long long)common::kSmemOptin) {
    if (maxs == kSplitMaxS && T % kSplitRP == 0 && C * T % kWarp == 0)
      *cf = Config{kSplit, kSplitRP, sp,
                   (int)(kSplitH * C * (T / kSplitRP) + kWarp), q,
                   2 * q + codes, smem};
    else
      *cf = Config{kTile, rp, sp, (int)threads, q, 2 * q + codes, smem};
    return true;
  }
  smem = 4 * (fixed + kNB * codes);
  if (T != wide_tile(C) || smem > (long long)common::kSmemOptin)
    return false;
  *cf = Config{kGlobal, rp, sp, (int)threads, q, codes, smem};
  return true;
}

}  // namespace resident

// ---------------------------------------------------------------------------
// kernel 2, the fused walk (fused.cu)
// ---------------------------------------------------------------------------
namespace fused {

constexpr int kThreads = 256;  // __launch_bounds__ of both kernels
// the walk keeps the idx8 rows it is about to use in a ring of 4 rows in
// shared memory, each fetched by cp.async two rows ahead
constexpr int kMetaRows = 4, kMetaBytes = kMetaRows * 8 * 4;
constexpr int kThreadMeta = 8;  // the thread walk's ring of idx8 rows

// The staged tile walk's register tile (beyond 8 states): RI states x RP
// patterns a thread for the state ladder's MAXS; the fallback tile is
// (MAXS, 1).
constexpr int tile_ri(int maxs) { return maxs == 20 ? 4 : 8; }
constexpr int kTileRP = 4;

enum Kind { kThread = 0, kTile = 1, kFallback = 2 };
struct Config {
  int kind, ri, rp, ig, sp, nb, threads;
  long long q;       // floats of one row side's matrix or tip table
  long long smem;    // dynamic shared memory (bytes)
  int depth;         // children fetched before the row before ends: the
                     // sides of a row that may be forwarded
  int lookback;      // how many rows back the writer of a forwarded child
                     // may be (the thread walk fetches two rows ahead)
};

// The configuration of a walk at pattern tile T, or false where none
// fits. Up to 8 states the thread walk (one thread a category and
// pattern; its tables staged in three row buffers where they fit, nb = 3,
// else read from device memory, nb = 0). Beyond, the staged tile walk
// where its threads and at least one stage buffer with the matrices fit
// (the deepest ring of 3, 2 or 1 buffers that fits), else the fallback
// tile with the matrices in device memory.
inline bool walk_config(int C, int S, int n_codes, int T, Config* cf) {
  if (C < 1 || S < 1 || S > 64 || n_codes < 1 || T < 1) return false;
  const long long rows = S > n_codes ? S : n_codes;
  const int maxs = common::ladder(S);
  if (maxs <= 8) {
    const int rpt = maxs <= 4 ? 2 : 1;  // thread_rpt
    const long long threads = (long long)C * (T / rpt);
    if (T % rpt || threads > kThreads) return false;
    const int sp = tile::round_up(S, 4);
    const long long q = C * rows * sp,
                    red = tile::round_up(2 * C * T, 4) + 8 * kThreadMeta;
    const int nb = 4 * (6 * q + red) <= (long long)common::kSmemOptin ? 3 : 0;
    *cf = Config{kThread, maxs, rpt, 1, sp, nb, (int)threads, q,
                 4 * (nb ? 6 * q + red : red), 2, 2};
    return true;
  }
  int ri = tile_ri(maxs), rp = kTileRP;
  for (int stage = 1; stage >= 0; --stage) {
    if (!stage) {
      ri = maxs;
      rp = 1;
    }
    const int ig = (S + ri - 1) / ri, sp = ig * ri;
    if (T % rp) continue;
    const long long threads = (long long)C * ig * (T / rp);
    if (threads > kThreads) continue;
    const long long q = C * rows * sp;
    const long long sb = tile::round_up(
        (int)((stage ? q : 0) + (long long)C * S * T + 2LL * T), 4);
    for (int nb = 3; nb >= 1; --nb) {
      const long long smem =
          4 * (nb * sb + tile::round_up(C * ig * T, 4)) + kMetaBytes;
      if (smem <= (long long)common::kSmemOptin) {
        *cf = Config{stage ? kTile : kFallback, ri, rp, ig, sp, nb,
                     (int)threads, q, smem, nb - 1, 1};
        return true;
      }
    }
  }
  return false;
}

}  // namespace fused

// ---------------------------------------------------------------------------
// kernels 3, 4 and 5, the per-level kernels (levels.cu)
// ---------------------------------------------------------------------------
namespace levels {

constexpr int kChildRP = 4;  // patterns a thread of the child pass (one
                             // 16-byte vector)

// states a thread of the child pass and of level_tiled for the state
// ladder's MAXS
PLLMOD_HD constexpr int child_ri(int maxs) {
  return (maxs == 4 || maxs == 20) ? 4 : 8;
}

// A launch configuration of the child pass.
struct ChildConfig {
  int ri, ig, sp, cb, lookup, threads, mrows;
  long long smem;
};

// The configuration at pattern tile T (a multiple of 4), or false: CB
// categories a CTA (as many as the 256 threads and shared memory allow),
// tip children as lookups where n_codes <= T. Shared memory a category:
// mrows = S (+ n_codes with the lookup) rows of SP floats (the transposed
// matrix, then the tip table) and the child's S x T tile.
inline bool child_config(int C, int S, int n_codes, int T, ChildConfig* cf) {
  if (C < 1 || S < 1 || S > 64 || n_codes < 1 || T < 4 || T % kChildRP)
    return false;
  const int ri = child_ri(common::ladder(S));
  const int ig = (S + ri - 1) / ri, sp = ig * ri;
  const int per_c = ig * (T / kChildRP);
  if (per_c > common::kMaxThreads) return false;
  for (int lookup = n_codes <= T ? 1 : 0; lookup >= 0; --lookup) {
    const int mrows = S + (lookup ? n_codes : 0);
    const long long unit = (long long)mrows * sp + (long long)S * T;
    const long long room = (long long)common::kSmemOptin / 4 - 2LL * T;
    long long cb = common::kMaxThreads / per_c;
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

// Kernel 4 takes one side of each row (the row's child 1), kernel 5 two
// (children 0 and 1): SIDES = mode + 1.
enum Mode { kChild2 = 0, kCombined = 1 };
enum LevelKind { kSimple = 0, kTiled = 1 };
constexpr int kLevelThreads = 512;  // __launch_bounds__ of level_tiled
constexpr int kLevelRP = 4;         // patterns a thread of level_tiled

// A launch configuration of kernels 4 and 5.
struct LevelConfig {
  int kind, ri, ig, sp;
  long long q;  // floats of a side's table (level_tiled; 0 for level_simple)
  int threads;
  long long smem;
};

// Shared memory of level_simple beside its category maxima [C][T]: the
// code table and the row's matrices.
inline size_t stage_floats(int mode, int C, int S, int n_codes) {
  return (size_t)n_codes * S + (size_t)(mode + 1) * C * S * S;
}

// The configuration at pattern tile T, or false where none fits:
// level_tiled where T is a multiple of 4 and its C * IG * T / 4 threads
// and shared memory fit (a side's region, a tip's table [Q], Q = C *
// max(S, n_codes) * SP, or an inner child's matrix [C*S*SP] and tile
// [C*S][T]; the maxima [C * IG][T]; the tip codes [sides][T]); else
// level_simple where its C * T threads fit (RI = the register tile MAXS,
// its matrices and code table staged where they fit a block).
inline bool level_config(int mode, int C, int S, int n_codes, int T,
                         LevelConfig* cf) {
  if ((mode != kChild2 && mode != kCombined) || C < 1 || S < 1 || S > 64 ||
      n_codes < 1 || T < 1)
    return false;
  const long long sides = mode + 1;
  const int maxs = common::ladder(S), ri = child_ri(maxs);
  const int ig = (S + ri - 1) / ri, sp = ig * ri;
  if (T % kLevelRP == 0) {
    const long long threads = (long long)C * ig * (T / kLevelRP);
    const long long q = (long long)C * (S > n_codes ? S : n_codes) * sp;
    const long long inner = (long long)C * S * (sp + T);
    const long long smem = 4 * (sides * (q > inner ? q : inner) +
                                (long long)C * ig * T + sides * T);
    if (threads <= kLevelThreads && smem <= (long long)common::kSmemOptin) {
      *cf = LevelConfig{kTiled, ri, ig, sp, q, (int)threads, smem};
      return true;
    }
  }
  if ((long long)C * T <= common::kMaxThreads) {
    const size_t stage = stage_floats(mode, C, S, n_codes);
    const size_t red = (size_t)C * T;
    const bool staged = common::fits_smem(red + stage);
    *cf = LevelConfig{kSimple, maxs, 1, S, 0, C * T,
                      (long long)(4 * (red + (staged ? stage : 0)))};
    return true;
  }
  return false;
}

}  // namespace levels

// ---------------------------------------------------------------------------
// kernels 6 and 7, the group-window walk (group_walk.cuh)
// ---------------------------------------------------------------------------
namespace group_walk {

constexpr int kThreads = 512;  // __launch_bounds__ of the walks

// the tile walk's stage buffers start 128-byte aligned (tensor copies'
// destinations) in a block of kAlign bytes of slack, followed by its
// maxima, its ring and kBarBytes of mbarriers (one a stage buffer)
constexpr int kAlign = 128, kBarBytes = 16;

// The ring of step tables: a lane's entry is kMeta ints, (tip, pos, side)
// of its row's two children (tip -1 for an inner child), its output
// position and the row (-1 where the lane has no row in the step).
constexpr int kMaxLanes = 8;
constexpr int kRing = 4;
constexpr int kMeta = 8;

inline long long ring_ints(int R) { return (long long)kRing * R * kMeta; }

enum Kind { kThread = 0, kTile = 1, kWide = 2 };
struct Config {
  int kind, ri, rp, ig, sp, threads;
  long long q;     // floats of one side's matrix or tip table in mats
  long long smem;  // dynamic shared memory (bytes)
  int staged;      // the tile walk stages each side's table beside its
                   // child (else reads it from mats)
};

// The configuration at pattern tile T and R row lanes (at most
// kMaxLanes), or false where none fits:
// up to 8 states the thread walk (category maxima [2][R][C][T] and the
// ring of step tables in shared memory); beyond, the tile walk (two stage
// buffers of R rows x 2 sides, each the side's table [Q] where staged and
// X [C*S][T], both 128-byte aligned, scalers [T] and codes [T], the
// maxima of two steps [2][R][C*IG][T], the ring and the mbarriers) where
// its threads fit, else the wide kind; each staged where that fits a
// block.
inline bool walk_config(int C, int S, int n_codes, int T, int R,
                        Config* cf) {
  if (C < 1 || S < 1 || S > 64 || n_codes < 1 || T < 1 || R < 1 ||
      R > kMaxLanes)
    return false;
  const int maxs = common::ladder(S);
  const long long rows = S > n_codes ? S : n_codes;
  if (maxs <= 8) {
    const int rpt = maxs <= 4 ? 2 : 1;
    if (T % rpt) return false;
    const long long threads = (long long)R * C * (T / rpt);
    const long long smem =
        4 * (common::round4(2LL * R * C * T) + ring_ints(R));
    if (threads > kThreads || smem > (long long)common::kSmemOptin)
      return false;
    *cf = Config{kThread, maxs, rpt, 1, maxs, (int)threads,
                 (long long)C * rows * maxs, smem, 0};
    return true;
  }
  for (int wide = 0; wide < 2; ++wide) {
    const int ri = wide ? maxs : (maxs == 20 ? 4 : 8), rp = wide ? 1 : 4;
    if (T % rp) continue;
    const int ig = (S + ri - 1) / ri, sp = ig * ri;
    const long long threads = (long long)R * C * ig * (T / rp);
    if (threads > kThreads) continue;
    const long long q = (long long)C * rows * sp;
    for (int staged = 1; staged >= 0; --staged) {
      const long long sb =
          common::round32(common::round32(staged ? q : 0) +
                          (long long)C * S * T + 2LL * T);
      const long long smem =
          4 * (4LL * R * sb + common::round4(2LL * R * C * ig * T) +
               ring_ints(R)) +
          kBarBytes + kAlign;
      if (smem <= (long long)common::kSmemOptin) {
        *cf = Config{wide ? kWide : kTile, ri, rp, ig, sp, (int)threads, q,
                     smem, staged};
        return true;
      }
    }
  }
  return false;
}

}  // namespace group_walk

// ---------------------------------------------------------------------------
// kernels 8 and 10, the derivative kernels (deriv.cu)
// ---------------------------------------------------------------------------
namespace deriv {

// Kernel 8's tiled kernel: pattern tile T, states a thread RI (4 where
// the register tile is 4 or 20 states, else 8), i-groups IG = ceil(S /
// RI), padded states SP = IG * RI and threads C * IG * T / 4. Shared
// memory, in floats from a 128-byte aligned base (128 bytes of slack
// align it): the ring's two mbarriers in the first 32, the two bases M
// [2][C][S][SP] and tables PT [2][C][n_codes][SP], then from a multiple
// of 32 two stages of 2 xs + 4 T floats, rounded up to 32: the CLV tiles X
// [C*S][T] at 0 and xs = C*S*T rounded up to 32 (128-byte aligned, as a
// tensor copy's destination must be), codes [2][T], scalers [2][T].
constexpr int kSumRP = 4;                          // patterns a thread
constexpr int kSumNB = 2;                          // ring stages
constexpr int kSumTiles[7] = {256, 128, 64, 32, 16, 8, 4};
constexpr int kSumBoxRows = 256;    // a tensor copy's box: C*S at most
constexpr int kSumMinThreads = 128; // the rule's least CTA (4 warps)
constexpr int kSumMinItems = common::kSms;  // the rule's least grid

struct SumConfig {
  int T, ri, ig, sp, threads;
  long long smem;
};

PLLMOD_HD constexpr int sum_ri(int maxs) {
  return (maxs == 4 || maxs == 20) ? 4 : 8;
}

// floats before the ring; floats of one side's CLV tile; of a stage
PLLMOD_HD inline int sum_ring_offset(int C, int S, int n_codes, int SP) {
  return tile::round_up(32 + 2 * C * S * SP + 2 * C * n_codes * SP, 32);
}
PLLMOD_HD inline int sum_side_floats(int C, int S, int T) {
  return tile::round_up(C * S * T, 32);
}
PLLMOD_HD inline int sum_stage_floats(int C, int S, int T) {
  return tile::round_up(2 * sum_side_floats(C, S, T) + 4 * T, 32);
}

// The configuration for nE edges, or false where the tiled kernel takes
// none (the simple kernel then runs). T: 0 for the rule, else forced.
// The rule (chip_smoke.py's kernel-8 sweep measured it): where C*S fits
// one tensor copy's box (256 rows), the widest tile T that divides Ppad
// with at most 256 threads and whose two stages fit a block's shared
// memory; the simple kernel instead where that CTA has fewer than 4
// warps or the launch fewer items than the card has SMs, as there the
// persistent CTAs' staging and first copies are not paid back.
inline bool sumtable_config(int C, int S, int n_codes, int Ppad, int nE,
                            int T_force, SumConfig* cf) {
  if (C < 1 || S < 1 || S > 64 || n_codes < 1 || Ppad < 1 ||
      C * S > kSumBoxRows)
    return false;
  const int ri = sum_ri(common::ladder(S));
  const int ig = (S + ri - 1) / ri, sp = ig * ri;
  const long long fixed = sum_ring_offset(C, S, n_codes, sp);
  for (int T : kSumTiles) {
    if ((T_force && T != T_force) || Ppad % T) continue;
    const long long threads = (long long)C * ig * (T / kSumRP);
    const long long smem =
        4 * (fixed + kSumNB * (long long)sum_stage_floats(C, S, T)) + 128;
    if (threads > common::kMaxThreads ||
        smem > (long long)common::kSmemOptin)
      continue;
    if (!T_force && (threads < kSumMinThreads ||
                     (long long)nE * (Ppad / T) < kSumMinItems))
      return false;
    *cf = SumConfig{T, ri, ig, sp, (int)threads, smem};
    return true;
  }
  return false;
}

// Shared memory of kernel 9 and of kernel 10's streaming kernel: three
// coefficient rows of CS floats and the block reduction's 96 doubles.
inline size_t deriv_smem_bytes(int CS) {
  return (size_t)3 * CS * sizeof(float) + 3 * 32 * sizeof(double);
}

// Kernel 10 as a thread-block cluster of N CTAs an edge: CTA rank r holds
// pattern slice r (slice_len patterns, a multiple of 4) of every
// partition in shared memory, beside the block reduction's scratch and
// every CTA's partials.
constexpr int kClusterMax = 16;
constexpr int kClusterSizes[4] = {2, 4, 8, 16};
constexpr int kRedDoubles = 96;                    // block_sum3's scratch
// every CTA's partials: [2 parities][16 ranks][3]
constexpr int kPartDoubles = 2 * kClusterMax * 3;

PLLMOD_HD inline long long slice_len(long long Ppad, int N) {
  return ((Ppad + N - 1) / N + 3) / 4 * 4;
}

// A kernel-10 launch: kind 0 the streaming kernel (one CTA an edge, rows
// re-read every iteration), 1 a cluster of n CTAs an edge.
struct NewtonConfig {
  int kind, n;
  long long smem;
};

// dims: (C*S, Ppad) of each of the K partitions. force: 0 the rule (the
// smallest cluster whose slices fit, else streaming), 1 streaming, or a
// cluster size. False where nothing fits.
inline bool newton_config(int K, const long long* dims, int force,
                          NewtonConfig* cf) {
  if (K < 1) return false;
  long long total_cs = 0;
  for (int k = 0; k < K; ++k) total_cs += dims[2 * k];
  const long long fixed = 8LL * (kRedDoubles + kPartDoubles) +
                          16 * total_cs + 4 * common::round4(2 * total_cs);
  for (int n : kClusterSizes) {
    if (force != 0 && force != n) continue;
    long long smem = fixed;
    for (int k = 0; k < K; ++k)
      smem += 4 * (dims[2 * k] + 3) * slice_len(dims[2 * k + 1], n);
    if (smem <= (long long)common::kSmemOptin) {
      *cf = NewtonConfig{1, n, smem};
      return true;
    }
  }
  const long long smem = (long long)deriv_smem_bytes((int)total_cs);
  if ((force == 0 || force == 1) && smem <= (long long)common::kSmemOptin) {
    *cf = NewtonConfig{0, 1, smem};
    return true;
  }
  return false;
}

}  // namespace deriv
