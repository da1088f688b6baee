// Branch-length derivative kernels for Hopper (sm_90a): the per-edge
// sumtables, the per-edge (logL, d/dt, d²/dt²) and a whole bracketed
// Newton optimization per edge, all from the fused walk's directed-CLV
// buffers clvs [n_slots, C*S, Ppad] / scalers [n_slots, Ppad].
//
//  * pllmod_edge_sumtables replaces the TPU kernel
//    pllmod_tpu/ops/pallas_deriv.py::_make_sumtable_kernel. For edge e
//    and pattern p: left = A_c x1, right = Vinv_c x2 with
//    A_c[k, i] = pi_c[i] V_c[i, k], st = left * right [E, C*S, Ppad] and
//    sc = s1 + s2 [E, Ppad]. Bound: bytes. It reads each inner side's
//    CLV column once and writes st once; at the flagship (128 x 16384
//    GTR+G4, all 253 edges) ~378 MB of CLVs + ~265 MB of st + codes and
//    scalers, ~0.2 ms at 3.35 TB/s, against ~60 MFLOP of products.
//    Design: grid (edge, pattern tile); thread (c, p) as in pruning.cu
//    reads its S values of an inner side into registers (coalesced
//    across p) and applies its category's S x S matrix row by row; a
//    tip side is one lookup in a code table of A_c codetab / Vinv_c
//    codetab ([2, n_codes, C, S], made once per call by the wrapper),
//    never an expanded tip plane. The matrices and tables are staged in
//    shared memory when they fit (a template flag), else read from
//    device memory, where they stay in L1/L2. Exactness: every product
//    and sum is rounded separately in state order (__fmul_rn /
//    __fadd_rn), as the plain version (ops/deriv.py) does, so st and sc
//    equal it bit for bit.
//  * pllmod_edge_derivs replaces pallas_deriv.py::_make_deriv_kernel.
//    Bound: bytes, one read of st and sc (~0.085 ms at the flagship for
//    all edges). Design: one CTA per edge forms the rows
//    (w e^{lr t}, . lr, . lr^2) in shared memory from (lr, w) and t[e]
//    (in double, rounded once to float),
//    loops its threads over the patterns (coalesced st reads), applies
//    the site math of pallas_deriv.py:303-316 (tiny floor, LN2 * sc
//    shift, log1p mixture with lnB, frac / r1 / ddf), and reduces the
//    pattern-weighted sums in double, in a fixed order (warp shuffles,
//    then shared memory): deterministic, no atomics.
//  * pllmod_newton_edges replaces pallas_deriv.py::_make_newton_kernel
//    for any number K of partitions (the n_parts > 1 form is the
//    multi-partition BLO's, pallas_deriv.py:415-420). One CTA per edge
//    runs the bracketed Newton of optimize/newton.py::
//    minimize_newton_multi: each iteration forms every partition's
//    coefficient rows in shared memory, then runs the derivative pass
//    above over each partition in turn, partition by partition through
//    the same fixed-order block reduction, and adds the K (logL, d/dt,
//    d2/dt2) sums in double in that order; thread 0 applies the bracket,
//    step clamp, Newton-or-bisect and freeze rule in float32 and
//    broadcasts x and the stop flag through shared memory; the edge stops
//    on its own convergence. The partitions come as a device array of
//    descriptors (pointers to st, sc, lw, lnB, pw; C*S; Ppad); a SCALED
//    linkage's branch-length scaler s is folded into lw's lr row by the
//    caller (lr' = s lr, sumtables built at b s), so the sums are the
//    derivatives in the shared length b (pallas_deriv.py:512-520). With
//    K = 1 every operation is the single-partition kernel's. Bound: one
//    read of every st and sc (the inputs' bytes); each iteration streams
//    the edge's rows again from L2 / device memory, since a flagship row
//    (1 MB) does not fit in shared memory (227 KB).
#include "common.cuh"

namespace {

using common::kMaxThreads;
using common::kSmemOptin;
constexpr int kDerivThreads = 512;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kTiny = 1e-37f;

// ---------------------------------------------------------------------------
// kernel 8: per-edge sumtables
// ---------------------------------------------------------------------------
// [nE, 6] eref6 columns: slot1, slot2, is_tip1, is_tip2, tip1, tip2
constexpr int kSlot1 = 0, kIsTip1 = 2, kTip1 = 4;

struct SumtableArgs {
  const int* eref6;      // [nE, 6]
  int nE;
  const float* clvs;     // [n_slots, C*S, Ppad]
  const int* scalers;    // [n_slots, Ppad]
  int n_slots;
  const int* codes;      // [n_tips, Ppad]
  int n_tips;
  const float* basis;    // [2, C, S, S]: A_c, Vinv_c
  const float* tiptab;   // [2, n_codes, C, S]
  int n_codes;
  float* st;             // [nE, C*S, Ppad]
  int* sc;               // [nE, Ppad]
  int Ppad, C, S, T;
};

size_t sumtable_stage_floats(int C, int S, int n_codes) {
  return (size_t)2 * C * S * S + (size_t)2 * n_codes * C * S;
}

bool sumtable_stages(int C, int S, int n_codes) {
  return common::fits_smem(sumtable_stage_floats(C, S, n_codes));
}

// Side k (0: A applied, 1: Vinv applied) of edge row `row`, category c,
// pattern p: its S transformed values and its scaler.
template <int MAXS>
__device__ __forceinline__ void sumtable_side(
    const SumtableArgs& a, const float* basis, const float* tab,
    const int* row, int k, int c, int p, float (&out)[MAXS], int& s) {
  const int S = a.S, C = a.C, CS = C * S;
  constexpr int kUnrollRows = common::unroll_rows<MAXS>();
  if (row[kIsTip1 + k] != 0) {
    const int tip = min(max(row[kTip1 + k], 0), a.n_tips - 1);
    int code = a.codes[(size_t)tip * a.Ppad + p];
    code = min(max(code, 0), a.n_codes - 1);
    const float* src = tab + (((size_t)k * a.n_codes + code) * C + c) * S;
#pragma unroll
    for (int i = 0; i < MAXS; ++i)
      if (i < S) out[i] = src[i];
    s = 0;
    return;
  }
  const int slot = min(max(row[kSlot1 + k], 0), a.n_slots - 1);
  const float* src = a.clvs + ((size_t)slot * CS + c * S) * a.Ppad + p;
  float x[MAXS];
  common::load_column<MAXS>(src, a.Ppad, S, x);
  const float* Bk = basis + ((size_t)k * C + c) * S * S;
#pragma unroll kUnrollRows
  for (int i = 0; i < MAXS; ++i)
    if (i < S) out[i] = common::row_dot<MAXS>(Bk, i, S, x);
  s = a.scalers[(size_t)slot * a.Ppad + p];
}

template <int MAXS, bool STAGE>
__global__ void __launch_bounds__(kMaxThreads)
edge_sumtable_kernel(SumtableArgs a) {
  extern __shared__ float smem[];
  const int e = blockIdx.x;
  const int T = a.T, S = a.S, CS = a.C * a.S;
  const int tid = threadIdx.x;
  const int c = tid / T;
  const int pl = tid - c * T;
  const int p = blockIdx.y * T + pl;
  const float* basis = a.basis;
  const float* tab = a.tiptab;
  if (STAGE) {
    const int nb = 2 * CS * S, nt = 2 * a.n_codes * CS;
    for (int i = tid; i < nb; i += blockDim.x) smem[i] = a.basis[i];
    for (int i = tid; i < nt; i += blockDim.x) smem[nb + i] = a.tiptab[i];
    __syncthreads();
    basis = smem;
    tab = smem + nb;
  }
  const int* row = a.eref6 + 6 * e;
  float left[MAXS], right[MAXS];
  int s1, s2;
  sumtable_side<MAXS>(a, basis, tab, row, 0, c, p, left, s1);
  sumtable_side<MAXS>(a, basis, tab, row, 1, c, p, right, s2);
  float* dst = a.st + ((size_t)e * CS + c * S) * a.Ppad + p;
#pragma unroll
  for (int i = 0; i < MAXS; ++i)
    if (i < S) dst[(size_t)i * a.Ppad] = __fmul_rn(left[i], right[i]);
  if (c == 0) a.sc[(size_t)e * a.Ppad + p] = s1 + s2;
}

template <int MAXS>
int launch_sumtable_t(const SumtableArgs& a, cudaStream_t stream) {
  const bool stage = sumtable_stages(a.C, a.S, a.n_codes);
  const size_t smem = stage ? 4 * sumtable_stage_floats(a.C, a.S, a.n_codes)
                            : 0;
  return common::launch_kernel(stage ? edge_sumtable_kernel<MAXS, true>
                                     : edge_sumtable_kernel<MAXS, false>,
                               dim3(a.nE, a.Ppad / a.T), dim3(a.C * a.T),
                               smem, stream, a);
}

// ---------------------------------------------------------------------------
// kernels 9 and 10: per-edge derivatives and per-edge Newton
// ---------------------------------------------------------------------------
struct DerivArgs {
  const float* st;       // [nE, CS, Ppad]
  const int* sc;         // [nE, Ppad]
  const float* lw;       // [2, CS]: lr (lambda * r_c), w (weight * (1 - p_c))
  const float* lnB;      // [Ppad] log of the p-inv term (-1e30 where 0)
  const float* pw;       // [Ppad] pattern weights
  int nE, CS, Ppad;
};

// The rows (w e^{lr t}, . * lr, . * lr * lr) of one edge at t into
// coef[3 * CS] (shared memory), evaluated in double and rounded once:
// dL and ddL sum terms of both signs, so float rounding of the
// exponentials alone would move d/dt by ~1e-4 of its value near an
// optimum (ops/deriv.py::_coeff_rows does the same).
__device__ __forceinline__ void edge_coeffs(const DerivArgs& a, float t,
                                            float* coef) {
  for (int k = threadIdx.x; k < a.CS; k += blockDim.x) {
    const double lr = a.lw[k];
    const double r0 = (double)a.lw[a.CS + k] * exp((double)t * lr);
    const double r1 = r0 * lr;
    coef[k] = (float)r0;
    coef[a.CS + k] = (float)r1;
    coef[2 * a.CS + k] = (float)(r1 * lr);
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum three values over the block in a fixed order; thread 0 gets them.
__device__ __forceinline__ void block_sum3(double& x, double& y, double& z,
                                           double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  x = warp_sum(x);
  y = warp_sum(y);
  z = warp_sum(z);
  if (lane == 0) {
    red[3 * warp] = x;
    red[3 * warp + 1] = y;
    red[3 * warp + 2] = z;
  }
  __syncthreads();
  if (warp == 0) {
    x = lane < nwarps ? red[3 * lane] : 0.0;
    y = lane < nwarps ? red[3 * lane + 1] : 0.0;
    z = lane < nwarps ? red[3 * lane + 2] : 0.0;
    x = warp_sum(x);
    y = warp_sum(y);
    z = warp_sum(z);
  }
  __syncthreads();
}

// Pattern-weighted (logL, d/dt, d2/dt2) of edge e from its rows coef
// (shared memory); the block's sums end in thread 0.
__device__ __forceinline__ void edge_sums(const DerivArgs& a, int e,
                                          const float* coef, double* red,
                                          double& s_l, double& s_d,
                                          double& s_dd) {
  const float* st = a.st + (size_t)e * a.CS * a.Ppad;
  const int* sc = a.sc + (size_t)e * a.Ppad;
  s_l = s_d = s_dd = 0.0;
  for (int p = threadIdx.x; p < a.Ppad; p += blockDim.x) {
    float L = 0.f, dL = 0.f, ddL = 0.f;
    for (int k = 0; k < a.CS; ++k) {
      const float v = st[(size_t)k * a.Ppad + p];
      L = fmaf(coef[k], v, L);
      dL = fmaf(coef[a.CS + k], v, dL);
      ddL = fmaf(coef[2 * a.CS + k], v, ddL);
    }
    const float Lsafe = fmaxf(L, kTiny);
    const float ln_a = logf(Lsafe) + (float)sc[p] * kLn2;
    const float ln_b = a.lnB[p];
    const float mx = fmaxf(ln_a, ln_b);
    const float site = mx + log1pf(expf(-fabsf(ln_a - ln_b)));
    const float frac = expf(ln_a - site);
    const float r1 = frac * dL / Lsafe;
    const float ddf = frac * ddL / Lsafe - r1 * r1;
    const float w = a.pw[p];
    s_l += (double)(site * w);
    s_d += (double)(r1 * w);
    s_dd += (double)(ddf * w);
  }
  block_sum3(s_l, s_d, s_dd, red);
}

size_t deriv_smem_bytes(int CS) {
  return (size_t)3 * CS * sizeof(float) + 3 * 32 * sizeof(double);
}

__global__ void __launch_bounds__(kDerivThreads)
edge_deriv_kernel(DerivArgs a, const float* t, float* out) {
  extern __shared__ double dsmem[];
  double* red = dsmem;                             // [3 * 32]
  float* coef = reinterpret_cast<float*>(dsmem + 96);   // [3 * CS]
  const int e = blockIdx.x;
  edge_coeffs(a, t[e], coef);
  __syncthreads();
  double s_l, s_d, s_dd;
  edge_sums(a, e, coef, red, s_l, s_d, s_dd);
  if (threadIdx.x == 0) {
    out[3 * e] = (float)s_l;
    out[3 * e + 1] = (float)s_d;
    out[3 * e + 2] = (float)s_dd;
  }
}

// One partition of the Newton kernel: 64-bit fields, the layout of the
// rows that ops/deriv.py::newton_edges_multi uploads.
struct PartDesc {
  long long st, sc, lw, lnB, pw, CS, Ppad;
};

__device__ __forceinline__ DerivArgs part_args(const PartDesc& d, int nE) {
  return DerivArgs{reinterpret_cast<const float*>(d.st),
                   reinterpret_cast<const int*>(d.sc),
                   reinterpret_cast<const float*>(d.lw),
                   reinterpret_cast<const float*>(d.lnB),
                   reinterpret_cast<const float*>(d.pw), nE, (int)d.CS,
                   (int)d.Ppad};
}

__global__ void __launch_bounds__(kDerivThreads)
newton_edge_kernel(const PartDesc* parts, int K, int nE, const float* t0,
                   float xmin, float xmax, float tol, int max_iters,
                   float* t_out, float* lnl0_out, int* iters_out) {
  extern __shared__ double dsmem[];
  double* red = dsmem;
  float* coef = reinterpret_cast<float*>(dsmem + 96);   // [3 * sum CS_k]
  __shared__ float s_x;
  __shared__ int s_stop;
  const int e = blockIdx.x;
  const float max_step = (xmax - xmin) / (float)max_iters;
  // thread 0's Newton state
  float x = t0[e], xl = xmin, xh = xmax, lnl0 = 0.f;
  int iters = 0;
  if (threadIdx.x == 0) {
    s_x = x;
    s_stop = 0;
  }
  __syncthreads();
  for (int it = 0; it < max_iters; ++it) {
    int off = 0;
    for (int k = 0; k < K; ++k) {
      const DerivArgs a = part_args(parts[k], nE);
      edge_coeffs(a, s_x, coef + off);
      off += 3 * a.CS;
    }
    __syncthreads();
    double t_l = 0.0, t_d = 0.0, t_dd = 0.0;
    off = 0;
    for (int k = 0; k < K; ++k) {
      const DerivArgs a = part_args(parts[k], nE);
      double s_l, s_d, s_dd;
      edge_sums(a, e, coef + off, red, s_l, s_d, s_dd);
      t_l += s_l;
      t_d += s_d;
      t_dd += s_dd;
      off += 3 * a.CS;
    }
    if (threadIdx.x == 0) {
      const float lnl = (float)t_l, df = (float)t_d, ddf = (float)t_dd;
      if (it == 0) lnl0 = lnl;
      if (df > 0.f) xl = x;
      if (df < 0.f) xh = x;
      float ndx = ddf < 0.f ? -df / ddf : 0.f;
      ndx = fminf(fmaxf(ndx, -max_step), max_step);
      const float xn = x + ndx;
      const float xb = df > 0.f ? 0.5f * (x + xh) : 0.5f * (x + xl);
      // a step that rounds to nothing stays (optimize/newton.py)
      const bool use_newton =
          (ddf < 0.f) && (((xn > xl) && (xn < xh)) || (xn == x));
      const float xnew = fminf(fmaxf(use_newton ? xn : xb, xmin), xmax);
      const bool conv = (fabsf(xnew - x) < tol) || (df == 0.f);
      x = xnew;
      iters = it + 1;
      s_x = x;
      s_stop = conv ? 1 : 0;
    }
    __syncthreads();
    if (s_stop) break;
  }
  if (threadIdx.x == 0) {
    t_out[e] = x;
    lnl0_out[e] = lnl0;
    iters_out[e] = iters;
  }
}

int prepare_deriv(const void* kern, int CS, size_t& smem) {
  smem = deriv_smem_bytes(CS);
  if (smem > kSmemOptin) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Every entry point returns the CUDA error code of its launch (0 = queued).
extern "C" int pllmod_edge_sumtables(
    const int* eref6, int nE, const float* clvs, const int* scalers,
    int n_slots, const int* codes, int n_tips, const float* basis,
    const float* tiptab, int n_codes, float* st, int* sc, int Ppad, int C,
    int S, int T, void* stream) {
  SumtableArgs a{eref6, nE, clvs, scalers, n_slots, codes, n_tips, basis,
                 tiptab, n_codes, st, sc, Ppad, C, S, T};
  if (C * T > kMaxThreads || Ppad % T != 0 || Ppad / T > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return common::dispatch_states(
      S, [&](auto m) { return launch_sumtable_t<decltype(m)::value>(a, s); });
}

extern "C" int pllmod_edge_derivs(
    const float* st, const int* sc, const float* lw, const float* lnB,
    const float* pw, const float* t, float* out, int nE, int CS, int Ppad,
    void* stream) {
  DerivArgs a{st, sc, lw, lnB, pw, nE, CS, Ppad};
  size_t smem;
  int err = prepare_deriv((const void*)edge_deriv_kernel, CS, smem);
  if (err != 0) return err;
  edge_deriv_kernel<<<nE, kDerivThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a, t, out);
  return (int)cudaGetLastError();
}

// parts: a device array of K descriptors (PartDesc); total_cs = the sum
// of their C*S, which sets the shared memory of the coefficient rows.
extern "C" int pllmod_newton_edges(
    const void* parts, int K, int total_cs, const float* t0, float xmin,
    float xmax, float tol, int max_iters, float* t_out, float* lnl0_out,
    int* iters_out, int nE, void* stream) {
  if (max_iters < 1 || K < 1) return (int)cudaErrorInvalidValue;
  size_t smem;
  int err = prepare_deriv((const void*)newton_edge_kernel, total_cs, smem);
  if (err != 0) return err;
  newton_edge_kernel<<<nE, kDerivThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const PartDesc*>(parts), K, nE, t0, xmin, xmax, tol,
      max_iters, t_out, lnl0_out, iters_out);
  return (int)cudaGetLastError();
}
