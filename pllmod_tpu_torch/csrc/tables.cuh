// The pre-pass of the walks that read tip children as lookups: every row
// side's matrix transposed and padded, or a tip child's table, into a
// scratch array in device memory. Shared by the fused walk (fused.cu,
// kernel 2) and the resident walk beyond 8 states (pruning.cu, kernel 1);
// csrc/tile.cuh has the layouts.
//
// For row side s (row s / 2, side s % 2) of idx8 [nW, 8] (is_tip in
// columns 2 and 3): M[c][j][i] = P[c][i][j] (zero for S <= i < SP), or
// for a tip child PT[c][code][i] = row_dot(P_c, i, codetab[code]) (zero
// for i >= S), at mats + s * Q. A lookup of PT returns the bits of the
// per-pattern product on the expanded tip (tile::tip_entry).
#pragma once
#include <cuda_runtime.h>

#include "tile.cuh"

namespace tables {
namespace {

constexpr int kThreads = 256;  // __launch_bounds__ of the pre-pass
constexpr int kIsTip = 2;      // idx8 column of side 0's tip flag

struct TableArgs {
  const int* idx8;
  const float* P5;       // [nW, 2, C, S, S]
  const float* codetab;  // [n_codes, S]
  float* mats;           // [nW, 2, Q]
  int n_codes, C, S, SP;
  long long Q;
};

// One block a row side and category: the category's matrix staged
// transposed (row stride S + 1: conflict-free both ways), then written
// out padded to SP, or its tip table computed from it. KERNEL is the
// walk that launches it (1 the resident walk, 2 the fused walk), so that
// a profile tells the two libraries' pre-passes apart.
template <int KERNEL>
__global__ void __launch_bounds__(kThreads) tables_kernel(TableArgs a) {
  __shared__ float Pt[64 * 65];
  const int s = blockIdx.x, c = blockIdx.y;  // row s / 2, side s % 2
  const int S = a.S, SP = a.SP, ld = S + 1;
  const float* P = a.P5 + ((size_t)s * a.C + c) * S * S;
  for (int e = threadIdx.x; e < S * S; e += blockDim.x)
    Pt[(e % S) * ld + e / S] = P[e];
  __syncthreads();
  if (a.idx8[8 * (s >> 1) + kIsTip + (s & 1)] != 0) {
    float* PT = a.mats + (size_t)s * a.Q + (size_t)c * a.n_codes * SP;
    for (int e = threadIdx.x; e < a.n_codes * SP; e += blockDim.x) {
      const int code = e / SP, i = e - code * SP;
      PT[e] = i < S ? tile::tip_entry(Pt, ld, a.codetab + code * S, S, i)
                    : 0.f;
    }
  } else {
    float* M = a.mats + (size_t)s * a.Q + (size_t)c * S * SP;
    for (int e = threadIdx.x; e < S * SP; e += blockDim.x) {
      const int j = e / SP, i = e - j * SP;
      M[e] = i < S ? Pt[j * ld + i] : 0.f;
    }
  }
}

// Queue the pre-pass of nW rows on `stream`; returns the CUDA error code.
template <int KERNEL>
int launch_tables(const int* idx8, int nW, const float* P5,
                  const float* codetab, int n_codes, float* mats, int C,
                  int S, int SP, long long Q, cudaStream_t stream) {
  TableArgs t{idx8, P5, codetab, mats, n_codes, C, S, SP, Q};
  tables_kernel<KERNEL><<<dim3(2 * nW, C), kThreads, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tables
