// Register-tiled pieces of the fused walk (fused.cu, kernel 2), the
// per-level kernels (levels.cu, kernels 3, 4 and 5) and the walks that
// include this header: asynchronous copies of pattern tiles into shared
// memory, the micro-tile product of one child and the vector loads and
// stores of a thread's patterns.
//
// Layouts. A child's tile in shared memory is X [lines][T]: line q holds
// its values of CLV row q for the T pattern columns of the tile. A row's
// matrix is staged transposed and padded, M [C][S][SP] with M[c][j][i] =
// P[c][i][j] (zero for i >= S), so that the RI states a thread owns are
// one 16-byte load; a tip child's table is PT [C][n_codes][SP] with
// PT[c][code][i] = row_dot(P_c, i, codetab[code]). SP = IG * RI, the
// states rounded up to whole i-groups.
//
// Exactness: a thread owns RI output states x RP patterns of one category
// and sums each output over j = 0..S-1 in order, every product and sum
// rounded separately (__fmul_rn / __fadd_rn), as common::row_dot does; a
// PT entry is the same row_dot of the code's row, so a lookup returns the
// bits the per-pattern product would. No tensor cores: TF32 would round
// the inputs.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "configs.h"

namespace tile {

__device__ __forceinline__ unsigned smem_ptr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared (L2 only); src_bytes = 0 fills zeros
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_ptr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; src_bytes = 0 fills a zero
__device__ __forceinline__ void cp4(void* dst, const void* src,
                                    int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_ptr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0 or 1) of this thread's groups are pending
__device__ __forceinline__ void cp_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// mbarriers and TMA bulk copies (global -> shared, completion counted in
// bytes on an mbarrier in shared memory)
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_ptr(bar)),
               "r"(n)
               : "memory");
}

// make initialized mbarriers visible to the async proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive on bar, expecting `bytes` more of bulk copies in this phase
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_ptr(bar)),
      "r"(bytes)
      : "memory");
}

// arrive on bar (one of its expected arrivals, no transaction bytes)
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_ptr(bar))
               : "memory");
}

// wait until the phase of bar with this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_ptr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) global -> shared
// by one bulk copy, its completion counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_ptr(dst)),
      "l"(src), "r"(bytes), "r"(smem_ptr(bar))
      : "memory");
}

// n contiguous 4-byte words (n a multiple of 4, both ends 16-byte aligned)
__device__ __forceinline__ void copy_run(void* dst, const void* src, int n,
                                         int tid, int nthr) {
  float* d = static_cast<float*>(dst);
  const float* s = static_cast<const float*>(src);
  for (int i = 4 * tid; i < n; i += 4 * nthr) cp16(d + i, s + i, 16);
}

// lines x T words of a pattern tile: dst[l * T + x] = src[l * stride + p0 +
// x], zero where p0 + x >= Ppad. vec: 16-byte copies (T, Ppad and stride
// multiples of 4), else 4-byte copies. With vec and nthr a multiple of T /
// 4 (the walks' thread counts are) a thread keeps one column.
__device__ __forceinline__ void copy_tile(void* dst, const void* src,
                                          size_t stride, int lines, int T,
                                          int p0, int Ppad, bool vec,
                                          int tid, int nthr) {
  float* d = static_cast<float*>(dst);
  const float* s = static_cast<const float*>(src);
  if (vec) {
    const int q = T >> 2;
    if (nthr % q == 0) {
      const int x = 4 * (tid % q), p = p0 + x, step = nthr / q;
      const bool in = p < Ppad;
      const float* sp = s + (in ? p : 0);
      for (int l = tid / q; l < lines; l += step)
        cp16(d + l * T + x, sp + l * stride, in ? 16 : 0);
      return;
    }
    const int n = lines * q;
    for (int i = tid; i < n; i += nthr) {
      const int l = i / q, x = 4 * (i - l * q), p = p0 + x;
      const bool in = p < Ppad;
      cp16(d + l * T + x, s + l * stride + (in ? p : 0), in ? 16 : 0);
    }
  } else {
    const int n = lines * T;
    for (int i = tid; i < n; i += nthr) {
      const int l = i / T, x = i - l * T, p = p0 + x;
      const bool in = p < Ppad;
      cp4(d + l * T + x, s + l * stride + (in ? p : 0), in ? 4 : 0);
    }
  }
}

// N consecutive floats from p (16-, 8- or 4-byte aligned as N allows)
template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + k);
      v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + k);
      v[k] = t.x; v[k + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = p[k];
  }
}

// acc[r][x] = sum_j M[j][i0 + r] * X[j][pl0 + x], j = 0..S-1 in order,
// for one category: Mc = M + c * S * SP (row stride SP), Xc = its first
// line (row stride T). S <= MAXS; the j loop is unrolled fully up to 20
// states. EXACT: S == MAXS, so that the steps need no guard and their
// loads can be issued ahead.
template <int RI, int RP, int MAXS, bool EXACT = false>
__device__ __forceinline__ void product(const float* Mc, const float* Xc,
                                        int S, int SP, int T, int i0,
                                        int pl0, float (&acc)[RI][RP]) {
  constexpr int kUnroll = MAXS <= 20 ? MAXS : 4;
  float pv[RI], xv[RP];
  load_vec<RI>(pv, Mc + i0);
  load_vec<RP>(xv, Xc + pl0);
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int x = 0; x < RP; ++x) acc[r][x] = __fmul_rn(pv[r], xv[x]);
#pragma unroll kUnroll
  for (int j = 1; j < MAXS; ++j) {
    if (EXACT || j < S) {
      load_vec<RI>(pv, Mc + j * SP + i0);
      load_vec<RP>(xv, Xc + j * T + pl0);
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int x = 0; x < RP; ++x)
          acc[r][x] = __fadd_rn(acc[r][x], __fmul_rn(pv[r], xv[x]));
    }
  }
}

// acc[r][x] = PTc[code_x][i0 + r]: a tip child from its table (PTc = PT + c
// * n_codes * SP), codes clamped to the table as common::load_tip does.
template <int RI, int RP>
__device__ __forceinline__ void lookup(const float* PTc, const int* codes,
                                       int n_codes, int SP, int i0, int pl0,
                                       float (&acc)[RI][RP]) {
#pragma unroll
  for (int x = 0; x < RP; ++x) {
    const int code = min(max(codes[pl0 + x], 0), n_codes - 1);
    float v[RI];
    load_vec<RI>(v, PTc + code * SP + i0);
#pragma unroll
    for (int r = 0; r < RI; ++r) acc[r][x] = v[r];
  }
}

// One entry of a tip table: row_dot(P_c, i, x) for x = codetab[code] [S],
// from the category's matrix transposed, Ptc[j * ld + i] = P_c[i][j], in
// j order with separate rounding (common::row_dot's arithmetic).
__device__ __forceinline__ float tip_entry(const float* Ptc, int ld,
                                           const float* x, int S, int i) {
  float acc = __fmul_rn(Ptc[i], x[0]);
  for (int j = 1; j < S; ++j)
    acc = __fadd_rn(acc, __fmul_rn(Ptc[j * ld + i], x[j]));
  return acc;
}

// Load RP consecutive values (patterns p .. p + RP - 1) of one line read
// once (ld.global.cs), as one vector where vec allows; 0 at patterns at or
// beyond Ppad.
template <int RP, typename V>
__device__ __forceinline__ void load_run(V (&v)[RP], const V* src, int p,
                                         int Ppad, bool vec) {
  if constexpr (RP == 4) {
    if (vec && p + 3 < Ppad) {
      using V4 = typename std::conditional<std::is_same<V, float>::value,
                                           float4, int4>::type;
      const V4 t = __ldcs(reinterpret_cast<const V4*>(src));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
      return;
    }
  }
#pragma unroll
  for (int x = 0; x < RP; ++x) v[x] = p + x < Ppad ? __ldcs(src + x) : V(0);
}

// Store RP consecutive values (patterns p .. p + RP - 1) of one line, as
// one vector where vec allows, masking patterns at or beyond Ppad;
// STREAM: streaming stores (st.global.cs) for data read once.
template <int RP, bool STREAM, typename V>
__device__ __forceinline__ void store_run(V* dst, const V (&v)[RP], int p,
                                          int Ppad, bool vec) {
  if constexpr (RP == 4) {
    if (vec && p + 3 < Ppad) {
      using V4 = typename std::conditional<std::is_same<V, float>::value,
                                           float4, int4>::type;
      V4 t;
      t.x = v[0]; t.y = v[1]; t.z = v[2]; t.w = v[3];
      if constexpr (STREAM)
        __stcs(reinterpret_cast<V4*>(dst), t);
      else
        *reinterpret_cast<V4*>(dst) = t;
      return;
    }
  } else if constexpr (RP == 2) {
    if (vec && p + 1 < Ppad) {
      using V2 = typename std::conditional<std::is_same<V, float>::value,
                                           float2, int2>::type;
      V2 t;
      t.x = v[0]; t.y = v[1];
      if constexpr (STREAM)
        __stcs(reinterpret_cast<V2*>(dst), t);
      else
        *reinterpret_cast<V2*>(dst) = t;
      return;
    }
  }
#pragma unroll
  for (int x = 0; x < RP; ++x)
    if (p + x < Ppad) {
      if constexpr (STREAM)
        __stcs(dst + x, v[x]);
      else
        dst[x] = v[x];
    }
}

}  // namespace tile
