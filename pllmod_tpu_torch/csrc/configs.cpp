// The kernels' launch configurations (configs.h) for the host: g++ builds
// this file into its own small library, and ops/_build.py and
// ops/deriv.py read it through ctypes. Each entry point fills out[] and
// returns 1, or returns 0 where no configuration fits.
#include "configs.h"

namespace {

template <int N>
void put(long long* out, const long long (&v)[N]) {
  for (int i = 0; i < N; ++i) out[i] = v[i];
}

}  // namespace

// Kernel 1 at pattern tile T: out[0..6] = kind (0 tile, 1 global, 2
// thread, 3 split), RP, SP, threads, Q, ring, shared memory bytes.
extern "C" int pllmod_resident_config(int C, int S, int n_codes,
                                      int n_slots, int T, long long* out) {
  resident::Config cf;
  if (!resident::walk_config(C, S, n_codes, n_slots, T, &cf)) return 0;
  put(out, {cf.kind, cf.rp, cf.sp, cf.threads, cf.q, cf.ring, cf.smem});
  return 1;
}

// Kernel 2 at pattern tile T: out[0..10] = kind (0 thread, 1 tile, 2
// fallback), RI, RP, IG, SP, NB, threads, Q (floats of one row side in
// mats), shared memory bytes, depth, lookback.
extern "C" int pllmod_fused_config(int C, int S, int n_codes, int T,
                                   long long* out) {
  fused::Config cf;
  if (!fused::walk_config(C, S, n_codes, T, &cf)) return 0;
  put(out, {cf.kind, cf.ri, cf.rp, cf.ig, cf.sp, cf.nb, cf.threads, cf.q,
            cf.smem, cf.depth, cf.lookback});
  return 1;
}

// Kernel 3 at pattern tile T: out[0..7] = RI, IG, SP, CB, lookup,
// threads, matrix rows a category, shared memory bytes.
extern "C" int pllmod_child_config(int C, int S, int n_codes, int T,
                                   long long* out) {
  levels::ChildConfig cf;
  if (!levels::child_config(C, S, n_codes, T, &cf)) return 0;
  put(out, {cf.ri, cf.ig, cf.sp, cf.cb, cf.lookup, cf.threads, cf.mrows,
            cf.smem});
  return 1;
}

// Kernel 4's (mode 0) or 5's (mode 1) at pattern tile T: out[0..6] = kind
// (0 simple, 1 tiled), RI, IG, SP, Q, threads, shared memory bytes.
extern "C" int pllmod_level_config(int mode, int C, int S, int n_codes,
                                   int T, long long* out) {
  levels::LevelConfig cf;
  if (!levels::level_config(mode, C, S, n_codes, T, &cf)) return 0;
  put(out, {cf.kind, cf.ri, cf.ig, cf.sp, cf.q, cf.threads, cf.smem});
  return 1;
}

// Kernels 6 and 7 at pattern tile T and R row lanes: out[0..8] = kind (0
// thread, 1 tile, 2 wide), RI, RP, IG, SP, threads, Q, shared memory
// bytes, staged.
extern "C" int pllmod_group_walk_config(int C, int S, int n_codes, int T,
                                        int R, long long* out) {
  group_walk::Config cf;
  if (!group_walk::walk_config(C, S, n_codes, T, R, &cf)) return 0;
  put(out, {cf.kind, cf.ri, cf.rp, cf.ig, cf.sp, cf.threads, cf.q, cf.smem,
            cf.staged});
  return 1;
}

// Kernel 8's tiled kernel for nE edges (T: 0 for the rule, else forced):
// out[0..5] = T, RI, IG, SP, threads, shared memory bytes; 0 where the
// simple kernel runs.
extern "C" int pllmod_sumtable_config(int C, int S, int n_codes, int Ppad,
                                      int nE, int T, long long* out) {
  deriv::SumConfig cf;
  if (!deriv::sumtable_config(C, S, n_codes, Ppad, nE, T, &cf)) return 0;
  put(out, {cf.T, cf.ri, cf.ig, cf.sp, cf.threads, cf.smem});
  return 1;
}

// Kernel 10 for K partitions of dims (C*S, Ppad) [2K] and force (0 the
// rule, 1 streaming, else a cluster size): out[0..2] = kind (0
// streaming, 1 cluster), CTAs an edge, shared memory bytes.
extern "C" int pllmod_newton_config(int K, const long long* dims, int force,
                                    long long* out) {
  deriv::NewtonConfig nc;
  if (!deriv::newton_config(K, dims, force, &nc)) return 0;
  put(out, {nc.kind, nc.n, nc.smem});
  return 1;
}
