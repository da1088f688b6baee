// Device and launch pieces shared by the CUDA sources of the port
// (pruning.cu, fused.cu, levels.cu, deriv.cu, and packed.cu and
// grouped.cu through group_walk.cuh).
//
// The row walks (kernels 1-7) carry one exactness contract, which the
// plain torch versions in ops/ follow bit for bit and which lives here
// only: every product and sum of a child's S x S matrix row is rounded
// separately in state order (row_dot), and a node's column is rescaled
// by the power of two 2^-e, e taken from the bits of its maximum over all
// categories and clipped to [-125, 127] (rescale_exponent;
// pllmod_tpu/ops/pallas_clv.py:1648-1655). A change here changes every
// walk and must be made in ops/clv.py's plain rescale as well.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "configs.h"

namespace common {

// Call f(std::integral_constant<int, MAXS>{}) with the narrowest register
// tile MAXS in {4, 8, 16, 20, 32, 64} that holds S states; returns f's
// result, or cudaErrorInvalidValue for more than 64 states.
template <typename F>
int dispatch_states(int S, F&& f) {
  if (S <= 4) return f(std::integral_constant<int, 4>{});
  if (S <= 8) return f(std::integral_constant<int, 8>{});
  if (S <= 16) return f(std::integral_constant<int, 16>{});
  if (S <= 20) return f(std::integral_constant<int, 20>{});
  if (S <= 32) return f(std::integral_constant<int, 32>{});
  if (S <= 64) return f(std::integral_constant<int, 64>{});
  return (int)cudaErrorInvalidValue;
}

// Opt `kern` into `smem` bytes of dynamic shared memory and queue it on
// `stream`; with `dependent`, as a programmatic dependent of the kernel
// before it on the stream (PDL: it may start once that kernel triggers
// its dependents, and waits for that kernel's results at
// griddepcontrol.wait). Returns the CUDA error code (0 = queued).
template <typename Args>
int launch_kernel(void (*kern)(Args), dim3 grid, dim3 block, size_t smem,
                  cudaStream_t stream, const Args& a,
                  bool dependent = false) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (!dependent) {
    kern<<<grid, block, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, a);
}

// Output rows of a walk's per-thread tile that are unrolled: up to 32
// states all of them, so that o[] stays in registers; the 64-state tile
// keeps o[] in local memory (fully unrolled it spills anyway and takes
// nvcc minutes).
template <int MAXS>
__host__ __device__ constexpr int unroll_rows() {
  return MAXS <= 32 ? MAXS : 1;
}

// Row i of Pk [S, S] times x, summed in order j = 0..S-1, rounding each
// product and sum separately.
template <int MAXS>
__device__ __forceinline__ float row_dot(const float* Pk, int i, int S,
                                         const float (&x)[MAXS]) {
  float acc = __fmul_rn(Pk[i * S], x[0]);
#pragma unroll
  for (int j = 1; j < MAXS; ++j)
    if (j < S) acc = __fadd_rn(acc, __fmul_rn(Pk[i * S + j], x[j]));
  return acc;
}

// A tip child's S values: the row of its code (clamped to the table) in
// the code -> CLV table tab [n_codes, S].
template <int MAXS>
__device__ __forceinline__ void load_tip(const float* tab, int code,
                                         int n_codes, int S,
                                         float (&x)[MAXS]) {
  code = min(max(code, 0), n_codes - 1);
#pragma unroll
  for (int j = 0; j < MAXS; ++j)
    if (j < S) x[j] = tab[code * S + j];
}

// An inner child's S values: src[j * stride] for j = 0..S-1 (one
// category's rows of a pattern column).
template <int MAXS>
__device__ __forceinline__ void load_column(const float* src, size_t stride,
                                            int S, float (&x)[MAXS]) {
#pragma unroll
  for (int j = 0; j < MAXS; ++j)
    if (j < S) x[j] = src[j * stride];
}

// The rescale exponent of a pattern whose maximum over all categories is
// mm: the exponent field of mm less 126 (0 where mm is not positive),
// clipped to [-125, 127].
__device__ __forceinline__ int max_exponent(float mm) {
  int e = ((__float_as_int(mm) >> 23) & 0xFF) - 126;
  if (!(mm > 0.f)) e = 0;
  return min(max(e, -125), 127);
}

// The rescale exponent e of pattern column pl: thread (c, pl) brings the
// maximum m of its category's values, the C maxima meet in red [C][T],
// and e is taken from the bits of their maximum (0 where it is not
// positive), clipped to [-125, 127]. Holds a __syncthreads: every thread
// of the block calls it, and red is written again only after the block's
// next barrier.
__device__ __forceinline__ int rescale_exponent(float* red, float m, int c,
                                                int pl, int C, int T) {
  red[c * T + pl] = m;
  __syncthreads();
  float mm = red[pl];
  for (int k = 1; k < C; ++k) mm = fmaxf(mm, red[k * T + pl]);
  return max_exponent(mm);
}

// dst[i * stride] = o[i] * 2^-e for i = 0..S-1 (exact: a power of two),
// UNROLL rows at a time (pruning.cu unrolls all of them: at 64 states that
// keeps its fused walk ~2.5 % faster than unroll_rows' one row).
template <int MAXS, int UNROLL = unroll_rows<MAXS>()>
__device__ __forceinline__ void store_scaled(float* dst, size_t stride,
                                             int S, const float (&o)[MAXS],
                                             int e) {
  const float scale = __int_as_float((127 - e) << 23);
#pragma unroll UNROLL
  for (int i = 0; i < MAXS; ++i)
    if (i < S) dst[i * stride] = __fmul_rn(o[i], scale);
}

}  // namespace common

// Phase marks of a kernel's main loop. Built with -DPLLMOD_PHASES
// (chip_smoke.py --profile builds pruning.cu and deriv.cu so, beside the
// libraries the port loads), PHASE_INIT reads the buffer that
// pllmod_phase_buffer set once, for CTA 0's thread 0 (a null pointer for
// every other thread; PHASE_INIT_FOR(cond): for CTA 0's threads where
// cond holds, which then mark disjoint marks of an iteration), and
// PHASE_MARK(w, i) stores that thread's clock64() as mark i (< 8) of
// iteration w (< 128) there. Without the define all three are empty and
// the kernels are those the port runs.
#ifdef PLLMOD_PHASES
__device__ long long* g_phase_clk;
extern "C" int pllmod_phase_buffer(long long* clk) {
  return (int)cudaMemcpyToSymbol(g_phase_clk, &clk, sizeof(clk));
}
#define PHASE_INIT_FOR(cond)                    \
  long long* const phase_clk_ =                 \
      blockIdx.x == 0 && (cond) ? g_phase_clk : nullptr;
#define PHASE_INIT PHASE_INIT_FOR(threadIdx.x == 0)
#define PHASE_MARK(w, i) \
  if (phase_clk_ && (w) < 128) phase_clk_[8 * (w) + (i)] = clock64();
#else
#define PHASE_INIT_FOR(cond)
#define PHASE_INIT
#define PHASE_MARK(w, i)
#endif
