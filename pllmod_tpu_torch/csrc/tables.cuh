// The pre-pass of the walks that read tip children as lookups: every row
// side's matrix transposed and padded, or a tip child's table, into a
// scratch array in device memory. Shared by the fused walk (fused.cu,
// kernel 2), the resident walk beyond 8 states (pruning.cu, kernel 1),
// the group-window walks (csrc/group_walk.cuh: packed.cu, kernel 6, and
// grouped.cu, kernel 7) and the second-child and combined level passes
// (levels.cu, kernels 4 and 5); csrc/tile.cuh has the layouts.
//
// A side is named by an index s into the caller's table of sides: a
// Sides policy says whether side s is a tip child (is_tip(s)) and which
// S x S matrices of C categories it takes (matrix(s)). The walks of
// kernels 1 and 2 number the sides of idx8 [nW, 8] rows (RowSides: row
// s / 2, side s % 2, is_tip in columns 2 and 3, matrices P5 [nW, 2, C, S,
// S]); kernels 6 and 7 name a matrix by index into P [E, ...] or PQ [nG,
// Q, ...] (their own policies), so no matrix is gathered first. For side
// s: M[c][j][i] = P[c][i][j] (zero for S <= i < SP), or for a tip child
// PT[c][code][i] = row_dot(P_c, i, codetab[code]) (zero for i >= S), at
// mats + s * Q. A lookup of PT returns the bits of the per-pattern
// product on the expanded tip (tile::tip_entry).
#pragma once
#include <cuda_runtime.h>

#include "tile.cuh"

namespace tables {
namespace {

constexpr int kThreads = 256;  // __launch_bounds__ of the pre-pass
constexpr int kIsTip = 2;      // idx8 column of side 0's tip flag

struct TableArgs {
  const float* codetab;  // [n_codes, S]
  float* mats;           // [n_sides, Q]
  int n_codes, C, S, SP;
  long long Q;
};

// The sides of idx8 rows with their matrices P5 [nW, 2, C, S, S]
// (kernels 1 and 2).
struct RowSides {
  const int* idx8;
  const float* P5;
  long long msz;  // C * S * S
  __device__ bool is_tip(int s) const {
    return idx8[8 * (s >> 1) + kIsTip + (s & 1)] != 0;
  }
  __device__ const float* matrix(int s) const { return P5 + s * msz; }
};

// One block a side and category: the category's matrix staged transposed
// (row stride S + 1: conflict-free both ways), then written out padded to
// SP, or its tip table computed from it. KERNEL is the kernel that
// launches it (1 the resident walk, 2 the fused walk, 4 the second-child
// pass, 5 the combined level pass, 6 the packed walk, 7 the grouped walk),
// so that a profile tells the libraries' pre-passes apart.
template <int KERNEL, typename Sides>
__global__ void __launch_bounds__(kThreads)
tables_kernel(Sides sides, TableArgs a) {
  // a kernel launched after this one as its programmatic dependent (the
  // level passes of levels.cu) may start now; it waits for these tables
  // at griddepcontrol.wait. No effect on a kernel launched without it.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ float Pt[64 * 65];
  const int s = blockIdx.x, c = blockIdx.y;
  const int S = a.S, SP = a.SP, ld = S + 1;
  const float* P = sides.matrix(s) + (size_t)c * S * S;
  for (int e = threadIdx.x; e < S * S; e += blockDim.x)
    Pt[(e % S) * ld + e / S] = P[e];
  __syncthreads();
  if (sides.is_tip(s)) {
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

// Queue the pre-pass of n_sides sides on `stream`; returns the CUDA error
// code.
template <int KERNEL, typename Sides>
int launch_sides(const Sides& sides, int n_sides, const float* codetab,
                 int n_codes, float* mats, int C, int S, int SP, long long Q,
                 cudaStream_t stream) {
  TableArgs t{codetab, mats, n_codes, C, S, SP, Q};
  tables_kernel<KERNEL, Sides>
      <<<dim3(n_sides, C), kThreads, 0, stream>>>(sides, t);
  return (int)cudaGetLastError();
}

// The pre-pass of nW idx8 rows (kernels 1 and 2).
template <int KERNEL>
int launch_tables(const int* idx8, int nW, const float* P5,
                  const float* codetab, int n_codes, float* mats, int C,
                  int S, int SP, long long Q, cudaStream_t stream) {
  return launch_sides<KERNEL>(RowSides{idx8, P5, (long long)C * S * S},
                              2 * nW, codetab, n_codes, mats, C, S, SP, Q,
                              stream);
}

}  // namespace
}  // namespace tables
