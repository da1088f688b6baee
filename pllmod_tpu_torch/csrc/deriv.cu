// Branch-length derivative kernels for Hopper (sm_90a): the per-edge
// sumtables, the per-edge (logL, d/dt, d²/dt²) and a whole bracketed
// Newton optimization per edge, all from the fused walk's directed-CLV
// buffers clvs [n_slots, C*S, Ppad] / scalers [n_slots, Ppad].
//
//  * pllmod_edge_sumtables replaces the TPU kernel
//    pllmod_tpu/ops/pallas_deriv.py::_make_sumtable_kernel. For edge e
//    and pattern p: left = A_c x1, right = Vinv_c x2 with
//    A_c[k, i] = pi_c[i] V_c[i, k], st = left * right [E, C*S, Ppad] and
//    sc = s1 + s2 [E, Ppad]. Bound on the H100: bytes. It reads each
//    inner side's CLV column and scaler once and writes st and sc once:
//    all 1021 edges of the protein cell (512 taxa x 4096 patterns,
//    C*S = 80) move ~3.4 GB, 1.0131 ms at 3.35 TB/s; the flagship's 253
//    edges (128 x 16384, C*S = 16) 0.2124 ms. The operations have a
//    ceiling of their own below it: every product and sum is rounded
//    separately, so a product costs two instructions where an FMA would
//    cost one, and the protein cell's ~1.0e10 products (~1530 inner
//    sides x 4096 x 4 x 20 x 20) take ~0.6 ms at half the 67 TFLOP/s
//    float32 peak; at DNA ~0.03 ms.
//    Design (sumtable_tile_kernel). Persistent CTAs, as many as the card
//    holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each
//    stage the two bases transposed and padded, M[k][c][j][i] =
//    basis[k][c][i][j], and the tip tables re-laid as PT[k][c][code][i]
//    (the wrapper's sumtable_tip_tables, the same bits) once, then loop
//    over work items (edge, tile of T patterns). A ring of two stages in
//    shared memory holds the items' inputs: one thread issues the next
//    item's while this one computes, on the stage's mbarrier: one 2-D
//    TMA tensor copy an inner side (its CLV tile X[C*S][T]) and 1-D bulk
//    copies of its scaler row or a tip side's codes; one barrier an
//    item. Thread (c, ig, pg) owns RI states x RP = 4 patterns of
//    category c on both sides (csrc/tile.cuh's register tiles, as
//    kernel 3's child pass): tile::product for an inner side, each
//    16-byte load of M serving 4 patterns, tile::lookup for a tip side;
//    the sides meet in registers (one __fmul_rn an output) and leave as
//    16-byte streaming stores. The tile is a rule of the shapes
//    (sumtable_config in csrc/configs.h; the rule is chip_smoke.py's
//    kernel-8 sweep). Where the rule takes no
//    tile (C*S beyond one copy's 256 rows, tables beyond a block's
//    shared memory as at 64 states x 4 categories, CTAs of under 4
//    warps, fewer items than SMs), the simple kernel runs
//    (edge_sumtable_kernel: grid (edge, pattern tile), thread (c, p),
//    its S values in registers, the matrices row by row), chosen by
//    that rule alone.
//    Measured on the H100 (chip_smoke.py, PERF.md): issuing the items'
//    CLV tiles as 16-byte cp.async by every thread took 43 % of a
//    protein item's cycles (the copies queue behind the products'
//    shared-memory loads); one tensor copy a side took that away. The
//    widest tile with two stages was the fastest tiled configuration at
//    every swept shape or within 2.1 % of it; more resident threads
//    (narrower tiles) or a third stage did not pay.
//    Exactness: every output is summed over j = 0..S-1 in order, every
//    product and sum rounded separately (__fmul_rn / __fadd_rn, no FMA
//    contraction, no tensor cores), as the plain version (ops/deriv.py)
//    does, so st and sc equal it bit for bit in both kernels.
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
//    read of every st and sc (the inputs' bytes). One CTA streams the
//    edge's rows again from L2 / device memory every iteration (6-9 an
//    edge), since a flagship edge (1.2 MB) does not fit one CTA's shared
//    memory (227 KB), so that design moves 6-9x its bytes. Where a
//    thread-block cluster of 2-16 CTAs holds the edge's inputs in shared
//    memory (newton_config: the smallest such cluster; 8 at the flagship
//    and protein cells, 16 for both partitions at once),
//    newton_cluster_kernel loads them once and iterates on chip; the
//    streaming kernel stays for edges that not even 16 CTAs hold. The
//    choice is a rule of the shapes, never a reaction to a failed launch.
#include <cooperative_groups.h>
#include <cuda.h>

#include "common.cuh"
#include "tile.cuh"

namespace {

using common::kMaxThreads;
using common::kSmemOptin;
using namespace deriv;
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
  int SP, IG;            // the tiled kernel's (sumtable_config)
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

// EXACT: S == MAXS, so that the state loops need no guard. clv_map: the
// CLVs as a 2-D tensor [n_slots * C*S rows, Ppad columns] of floats,
// boxes of C*S rows x T columns.
template <int MAXS, bool EXACT>
__global__ void __launch_bounds__(kMaxThreads)
sumtable_tile_kernel(SumtableArgs a, const __grid_constant__ CUtensorMap
                                         clv_map) {
  extern __shared__ __align__(128) float sum_smem[];
  constexpr int RI = sum_ri(MAXS), RP = kSumRP;
  const int T = a.T, C = a.C, S = EXACT ? MAXS : a.S, CS = C * S;
  const int SP = a.SP, IG = a.IG, Ppad = a.Ppad;
  const int n_codes = a.n_codes, tid = threadIdx.x, nthr = blockDim.x;
  const int npg = T / RP;
  const int pg = tid % npg, rest = tid / npg, ig = rest % IG, c = rest / IG;
  const int i0 = ig * RI, pl0 = pg * RP;
  const int ntiles = Ppad / T;
  const long long n_items = (long long)a.nE * ntiles;
  const int xs = sum_side_floats(C, S, T);
  const int stage = sum_stage_floats(C, S, T);
  // 128-byte alignment by pointer arithmetic on the shared array, so that
  // the compiler keeps every access a shared-memory one (a cast through
  // an integer turns them into generic loads)
  float* base =
      sum_smem + ((128 - (tile::smem_ptr(sum_smem) & 127)) & 127) / 4;
  auto* bars = reinterpret_cast<unsigned long long*>(base);  // [2]
  float* M = base + 32;                       // [2][C][S][SP]
  float* PT = M + 2 * CS * SP;                // [2][C][n_codes][SP]
  float* ring = base + sum_ring_offset(C, S, n_codes, SP);  // [2][stage]

  // thread 0: item `it`'s inputs into ring stage `slot` on the stage's
  // mbarrier: an inner side's CLV tile (one tensor copy) and scaler row, a
  // tip side's codes (bulk copies)
  auto issue = [&](long long it, int slot) {
    if (it >= n_items) return;
    const int e = (int)(it / ntiles);
    const int p0 = (int)(it - (long long)e * ntiles) * T;
    const int* row = a.eref6 + 6 * e;
    float* X = ring + (size_t)slot * stage;
    int* cd = reinterpret_cast<int*>(X + 2 * xs);
    int* scl = cd + 2 * T;
    unsigned long long* bar = bars + slot;
    unsigned bytes = 0;
    for (int k = 0; k < 2; ++k)
      bytes += row[kIsTip1 + k] != 0 ? 4u * T : 4u * (CS + 1) * T;
    tile::mbar_expect(bar, bytes);
    for (int k = 0; k < 2; ++k) {
      if (row[kIsTip1 + k] != 0) {
        const int tip = min(max(row[kTip1 + k], 0), a.n_tips - 1);
        tile::bulk_copy(cd + k * T, a.codes + (size_t)tip * Ppad + p0,
                        4u * T, bar);
      } else {
        const int s = min(max(row[kSlot1 + k], 0), a.n_slots - 1);
        tma_load_2d(X + k * xs, &clv_map, p0, s * CS, bar);
        tile::bulk_copy(scl + k * T, a.scalers + (size_t)s * Ppad + p0,
                        4u * T, bar);
      }
    }
  };

  PHASE_INIT
  PHASE_MARK(127, 0)
  // the first item's copies fly while the CTA stages its tables
  if (tid == 0) {
    for (int i = 0; i < kSumNB; ++i) tile::mbar_init(bars + i, 1);
    tile::mbar_fence_init();
    issue(blockIdx.x, 0);
  }
  // the bases transposed, M[k][c][j][i] = basis[k][c][i][j] (read in the
  // basis' order), the padding states zero; the tables re-laid
  for (int e = tid; e < 2 * CS * S; e += nthr) {
    const int kc = e / (S * S), r = e - kc * S * S, i = r / S, j = r - i * S;
    M[(kc * S + j) * SP + i] = a.basis[e];
  }
  const int pad = SP - S;
  for (int e = tid; e < 2 * CS * pad; e += nthr)
    M[(e / pad) * SP + S + e % pad] = 0.f;
  for (int e = tid; e < 2 * C * n_codes * SP; e += nthr) {
    const int i = e % SP, r = e / SP, code = r % n_codes, kc = r / n_codes;
    const int k = kc / C, cc = kc - k * C;
    PT[e] = i < S ? a.tiptab[(((size_t)k * n_codes + code) * C + cc) * S + i]
                  : 0.f;
  }
  __syncthreads();  // the mbarriers and the staged tables
  PHASE_MARK(127, 1)

  int n = 0;
  for (long long it = blockIdx.x; it < n_items; it += gridDim.x, ++n) {
    [[maybe_unused]] const int w = n < 127 ? n : 128;  // phase rows 0..126
    PHASE_MARK(w, 0)
    // every thread is done with the stage the next item's copies refill
    // (the previous item's); they fly while this item computes
    __syncthreads();
    PHASE_MARK(w, 1)
    if (tid == 0) issue(it + gridDim.x, (n + 1) % kSumNB);
    tile::mbar_wait(bars + n % kSumNB, (unsigned)(n / kSumNB) & 1u);
    PHASE_MARK(w, 2)
    const int e = (int)(it / ntiles);
    const int p = (int)(it - (long long)e * ntiles) * T + pl0;
    const int* row = a.eref6 + 6 * e;
    const float* X = ring + (size_t)(n % kSumNB) * stage;
    const int* cd = reinterpret_cast<const int*>(X + 2 * xs);
    float acc[2][RI][RP];
    bool tip[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      tip[k] = row[kIsTip1 + k] != 0;
      if (tip[k])
        tile::lookup<RI, RP>(PT + (size_t)(k * C + c) * n_codes * SP,
                             cd + k * T, n_codes, SP, i0, pl0, acc[k]);
      else
        tile::product<RI, RP, MAXS, EXACT>(
            M + (size_t)(k * C + c) * S * SP,
            X + (size_t)k * xs + (size_t)c * S * T, S, SP, T, i0, pl0,
            acc[k]);
    }
    PHASE_MARK(w, 3)
    float* dst = a.st + ((size_t)e * CS + c * S + i0) * Ppad + p;
#pragma unroll
    for (int r = 0; r < RI; ++r)
      if (EXACT || i0 + r < S) {
        float v[RP];
#pragma unroll
        for (int x = 0; x < RP; ++x)
          v[x] = __fmul_rn(acc[0][r][x], acc[1][r][x]);
        tile::store_run<RP, true>(dst + (size_t)r * Ppad, v, p, Ppad, true);
      }
    if (c == 0 && ig == 0) {
      const int* scl = cd + 2 * T;
      int v[RP];
#pragma unroll
      for (int x = 0; x < RP; ++x)
        v[x] = (tip[0] ? 0 : scl[pl0 + x]) + (tip[1] ? 0 : scl[T + pl0 + x]);
      tile::store_run<RP, true>(a.sc + (size_t)e * Ppad + p, v, p, Ppad,
                                true);
    }
    PHASE_MARK(w, 4)
  }
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry
// point query (no link to libcuda), looked up once; null where missing.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

// The persistent grid: as many CTAs as the card holds at once, at most
// one an item.
template <int MAXS, bool EXACT>
int launch_sum_tile(const SumtableArgs& a, const SumConfig& cf,
                    cudaStream_t stream) {
  auto kern = sumtable_tile_kernel<MAXS, EXACT>;
  const size_t smem = (size_t)cf.smem;
  const int CS = a.C * a.S;
  // the copies' sources must be 16-byte aligned
  for (const void* ptr : {(const void*)a.clvs, (const void*)a.scalers,
                          (const void*)a.codes})
    if (reinterpret_cast<size_t>(ptr) % 16)
      return (int)cudaErrorMisalignedAddress;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)a.Ppad,
                              (cuuint64_t)a.n_slots * CS};
  const cuuint64_t strides[1] = {(cuuint64_t)a.Ppad * 4};
  const cuuint32_t box[2] = {(cuuint32_t)a.T, (cuuint32_t)CS};
  const cuuint32_t estrides[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(a.clvs), dims, strides, box, estrides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, n_sm = 0, occ = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern,
                                                        cf.threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)a.nE * (a.Ppad / a.T);
  const long long grid = items < (long long)n_sm * occ
                             ? items : (long long)n_sm * occ;
  kern<<<(unsigned)grid, cf.threads, smem, stream>>>(a, map);
  return (int)cudaGetLastError();
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

// One pattern's site math (pallas_deriv.py:303-316: tiny floor, LN2 * sc
// shift, log1p mixture with lnB, frac / r1 / ddf) from its products with
// the rows, L, dL and ddL, added to the thread's sums weighted by w.
__device__ __forceinline__ void site_math(float L, float dL, float ddL,
                                          int sc, float ln_b, float w,
                                          double& s_l, double& s_d,
                                          double& s_dd) {
  const float Lsafe = fmaxf(L, kTiny);
  const float ln_a = logf(Lsafe) + (float)sc * kLn2;
  const float mx = fmaxf(ln_a, ln_b);
  const float site = mx + log1pf(expf(-fabsf(ln_a - ln_b)));
  const float frac = expf(ln_a - site);
  const float r1 = frac * dL / Lsafe;
  const float ddf = frac * ddL / Lsafe - r1 * r1;
  s_l += (double)(site * w);
  s_d += (double)(r1 * w);
  s_dd += (double)(ddf * w);
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
    site_math(L, dL, ddL, sc[p], a.lnB[p], a.pw[p], s_l, s_d, s_dd);
  }
  block_sum3(s_l, s_d, s_dd, red);
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

// One step of the bracketed Newton of optimize/newton.py::
// minimize_newton_multi from the summed (logL, d/dt, d2/dt2) of
// iteration it, in float32: bracket, step clamp, Newton or bisection,
// freeze. Updates x, the bracket, lnl0 (the logL of iteration 0) and the
// iteration count; returns whether the edge has converged.
__device__ __forceinline__ bool newton_update(double t_l, double t_d,
                                              double t_dd, int it,
                                              float xmin, float xmax,
                                              float tol, float max_step,
                                              float& x, float& xl,
                                              float& xh, float& lnl0,
                                              int& iters) {
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
  return conv;
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
      const bool conv = newton_update(t_l, t_d, t_dd, it, xmin, xmax, tol,
                                      max_step, x, xl, xh, lnl0, iters);
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

// ---------------------------------------------------------------------------
// kernel 10, one thread-block cluster an edge
// ---------------------------------------------------------------------------
// Where a cluster of N CTAs holds an edge's inputs in shared memory, CTA
// rank r of edge e's cluster loads pattern slice r (slice_len patterns,
// a multiple of 4) of every partition's st, sc, lnB and pw, and the lw
// rows, once, by cp.async, and the Newton iterations run on chip: each
// thread sums its patterns of every partition in order (slice_sums: the
// products and site math of edge_sums), the CTA reduces its threads'
// sums in a fixed order (block_sum3) and writes them into slot r of
// every CTA's partials over DSMEM (lanes 0..N-1 of warp 0, one CTA each;
// two buffers by iteration parity, so no CTA reads another's shared
// memory and none waits for a remote load); after one cluster.sync() an
// iteration, thread 0 of every CTA adds the N partials in rank order and
// applies the same Newton step, so that every CTA holds the same x and
// stop flag without a broadcast. The cluster's size and shared memory are
// configs.h's (deriv::newton_config).

// A thread's sums over its patterns of one CTA's slice of one partition:
// st [CS][sl], the first n patterns valid, coef4[k] = (w e^{lr t}, . lr,
// . lr^2, 0) (edge_coeffs' arithmetic); RPAT adjacent patterns a thread
// at once (one 16-byte load of each row for RPAT = 4), each pattern's
// products in k order (fmaf, as edge_sums) and its site math, the
// pattern terms added to the thread's sums in pattern order.
template <int RPAT>
__device__ __forceinline__ void slice_sums(const float4* coef4, int CS,
                                           const float* st, int sl,
                                           const int* sc, const float* lnB,
                                           const float* pw, int n,
                                           double& s_l, double& s_d,
                                           double& s_dd) {
  for (int p0 = RPAT * threadIdx.x; p0 < n; p0 += RPAT * blockDim.x) {
    float L[RPAT], dL[RPAT], ddL[RPAT];
#pragma unroll
    for (int q = 0; q < RPAT; ++q) L[q] = dL[q] = ddL[q] = 0.f;
#pragma unroll 4
    for (int k = 0; k < CS; ++k) {
      const float4 c = coef4[k];
      float v[RPAT];
      tile::load_vec<RPAT>(v, st + (size_t)k * sl + p0);
#pragma unroll
      for (int q = 0; q < RPAT; ++q) {
        L[q] = fmaf(c.x, v[q], L[q]);
        dL[q] = fmaf(c.y, v[q], dL[q]);
        ddL[q] = fmaf(c.z, v[q], ddL[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < RPAT; ++q)
      if (p0 + q < n)
        site_math(L[q], dL[q], ddL[q], sc[p0 + q], lnB[p0 + q], pw[p0 + q],
                  s_l, s_d, s_dd);
  }
}

__global__ void __launch_bounds__(kDerivThreads)
newton_cluster_kernel(const PartDesc* parts, int K, int total_cs, int nE,
                      const float* t0, float xmin, float xmax, float tol,
                      int max_iters, float* t_out, float* lnl0_out,
                      int* iters_out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int N = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int e = blockIdx.x / N, tid = threadIdx.x, nthr = blockDim.x;
  extern __shared__ double dsmem[];
  double* red = dsmem;                            // [96]
  double* part = dsmem + kRedDoubles;             // [2][16][3]
  float4* coef = reinterpret_cast<float4*>(part + kPartDoubles);  // [sum CS]
  float* lws = reinterpret_cast<float*>(coef + total_cs);  // lw rows
  float* data = lws + common::round4(2 * total_cs);   // per partition: st [CS]
                                                // [slice], sc, lnB, pw
  __shared__ float s_x;
  __shared__ int s_stop;

  float* d = data;
  float* lwk = lws;
  for (int k = 0; k < K; ++k) {
    const PartDesc pd = parts[k];
    for (int i = tid; i < 2 * (int)pd.CS; i += nthr)
      tile::cp4(lwk + i, reinterpret_cast<const float*>(pd.lw) + i, 4);
    lwk += 2 * pd.CS;
    const int CS = (int)pd.CS, Ppad = (int)pd.Ppad;
    const int sl = (int)slice_len(Ppad, N), p0 = rank * sl;
    const bool vec = Ppad % 4 == 0;
    tile::copy_tile(d, reinterpret_cast<const float*>(pd.st) +
                           (size_t)e * CS * Ppad,
                    Ppad, CS, sl, p0, Ppad, vec, tid, nthr);
    tile::copy_tile(d + (size_t)CS * sl,
                    reinterpret_cast<const int*>(pd.sc) + (size_t)e * Ppad,
                    0, 1, sl, p0, Ppad, vec, tid, nthr);
    tile::copy_tile(d + (size_t)(CS + 1) * sl,
                    reinterpret_cast<const float*>(pd.lnB), 0, 1, sl, p0,
                    Ppad, vec, tid, nthr);
    tile::copy_tile(d + (size_t)(CS + 2) * sl,
                    reinterpret_cast<const float*>(pd.pw), 0, 1, sl, p0,
                    Ppad, vec, tid, nthr);
    d += (size_t)(CS + 3) * sl;
  }
  tile::cp_commit();
  tile::cp_wait(0);

  const float max_step = (xmax - xmin) / (float)max_iters;
  // thread 0's Newton state (the same in every CTA of the cluster)
  float x = t0[e], xl = xmin, xh = xmax, lnl0 = 0.f;
  int iters = 0;
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  PHASE_INIT
  for (int it = 0; it < max_iters; ++it) {
    PHASE_MARK(it, 0)
    // every partition's rows at x, one flat pass over the sum of C*S
    for (int f = tid; f < total_cs; f += nthr) {
      int k = 0, base = 0;
      while (f >= base + (int)parts[k].CS) base += (int)parts[k++].CS;
      const int CS = (int)parts[k].CS, i = f - base;
      const double lr = lws[2 * base + i];
      const double r0 = (double)lws[2 * base + CS + i] * exp((double)x * lr);
      const double r1 = r0 * lr;
      coef[f] = make_float4((float)r0, (float)r1, (float)(r1 * lr), 0.f);
    }
    __syncthreads();
    PHASE_MARK(it, 1)
    // the thread's sums over its patterns of each partition, added in
    // partition order
    double t_l = 0.0, t_d = 0.0, t_dd = 0.0;
    int off = 0;
    d = data;
    for (int k = 0; k < K; ++k) {
      const int CS = (int)parts[k].CS, Ppad = (int)parts[k].Ppad;
      const int sl = (int)slice_len(Ppad, N);
      const int n = min(sl, Ppad - rank * sl);
      const int* sc = reinterpret_cast<const int*>(d + (size_t)CS * sl);
      const float* lnB = d + (size_t)(CS + 1) * sl;
      const float* pw = d + (size_t)(CS + 2) * sl;
      double s_l = 0.0, s_d = 0.0, s_dd = 0.0;
      if (sl >= 4 * nthr)
        slice_sums<4>(coef + off, CS, d, sl, sc, lnB, pw, n, s_l, s_d, s_dd);
      else if (sl >= 2 * nthr)
        slice_sums<2>(coef + off, CS, d, sl, sc, lnB, pw, n, s_l, s_d, s_dd);
      else
        slice_sums<1>(coef + off, CS, d, sl, sc, lnB, pw, n, s_l, s_d, s_dd);
      t_l += s_l;  // partition by partition, as edge_sums' callers add
      t_d += s_d;
      t_dd += s_dd;
      off += CS;
      d += (size_t)(CS + 3) * sl;
    }
    PHASE_MARK(it, 2)
    // the CTA's sums (a fixed-order block reduction) to slot `rank` of
    // every CTA of the cluster, lane j of warp 0 to rank j
    block_sum3(t_l, t_d, t_dd, red);
    double* buf = part + (it & 1) * kClusterMax * 3;
    if (warp == 0) {
      t_l = __shfl_sync(0xffffffffu, t_l, 0);
      t_d = __shfl_sync(0xffffffffu, t_d, 0);
      t_dd = __shfl_sync(0xffffffffu, t_dd, 0);
      if (lane < N) {
        double* dst = cluster.map_shared_rank(buf, lane) + 3 * rank;
        dst[0] = t_l;
        dst[1] = t_d;
        dst[2] = t_dd;
      }
    }
    PHASE_MARK(it, 3)
    cluster.sync();
    PHASE_MARK(it, 4)
    if (tid == 0) {  // the N partials, added in rank order
      double a_l = 0.0, a_d = 0.0, a_dd = 0.0;
#pragma unroll
      for (int r = 0; r < kClusterMax; ++r)
        if (r < N) {
          a_l += buf[3 * r];
          a_d += buf[3 * r + 1];
          a_dd += buf[3 * r + 2];
        }
      const bool conv = newton_update(a_l, a_d, a_dd, it, xmin, xmax, tol,
                                      max_step, x, xl, xh, lnl0, iters);
      s_x = x;
      s_stop = conv ? 1 : 0;
    }
    __syncthreads();
    PHASE_MARK(it, 5)
    x = s_x;
    if (s_stop) break;
  }
  // no CTA touches another's shared memory after the last cluster.sync()
  if (rank == 0 && tid == 0) {
    t_out[e] = x;
    lnl0_out[e] = lnl0;
    iters_out[e] = iters;
  }
}

// Prepare and describe a cluster launch of n CTAs an edge (cfg and attr
// filled for cudaLaunchKernelEx and the occupancy query).
int prepare_cluster(int nE, const NewtonConfig& nc, cudaStream_t stream,
                    cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const void* kern = (const void*)newton_cluster_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)nc.smem);
  if (err == cudaSuccess && nc.n > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(nE * nc.n);
  cfg->blockDim = dim3(kDerivThreads);
  cfg->dynamicSmemBytes = (size_t)nc.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = nc.n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

int prepare_deriv(const void* kern, int CS, size_t& smem) {
  smem = deriv_smem_bytes(CS);
  if (smem > kSmemOptin) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Every entry point returns the CUDA error code of its launch (0 = queued).

// Kernel 8's tiled kernel for nE edges (T: 0 for the rule, else forced):
// the CTAs an SM the card holds of it at its configuration
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, the count that sizes its
// persistent grid), or -1 where the tiled kernel takes no configuration
// or the query failed.
extern "C" int pllmod_sumtable_occupancy(int C, int S, int n_codes, int Ppad,
                                         int nE, int T) {
  SumConfig cf;
  if (!sumtable_config(C, S, n_codes, Ppad, nE, T, &cf)) return -1;
  int occ = -1;
  common::dispatch_states(S, [&](auto m) {
    constexpr int MAXS = decltype(m)::value;
    auto kern = S == MAXS ? sumtable_tile_kernel<MAXS, true>
                          : sumtable_tile_kernel<MAXS, false>;
    int n = 0;
    if (cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)cf.smem) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kern, cf.threads, (size_t)cf.smem) == cudaSuccess)
      occ = n;
    return 0;
  });
  cudaGetLastError();
  return occ;
}

// tile: 0 for the rule (sumtable_config, else the simple kernel), else
// the tiled kernel at that tile, or cudaErrorInvalidConfiguration where it
// takes none; simple: 1 forces the simple kernel (at the widest pattern
// tile, C * T <= 256).
extern "C" int pllmod_edge_sumtables(
    const int* eref6, int nE, const float* clvs, const int* scalers,
    int n_slots, const int* codes, int n_tips, const float* basis,
    const float* tiptab, int n_codes, float* st, int* sc, int Ppad, int C,
    int S, int tile, int simple, void* stream) {
  SumtableArgs a{eref6, nE, clvs, scalers, n_slots, codes, n_tips, basis,
                 tiptab, n_codes, st, sc, Ppad, C, S, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SumConfig cf;
  if (!simple && sumtable_config(C, S, n_codes, Ppad, nE, tile, &cf)) {
    a.T = cf.T;
    a.SP = cf.sp;
    a.IG = cf.ig;
    return common::dispatch_states(S, [&](auto m) {
      constexpr int MAXS = decltype(m)::value;
      return S == MAXS ? launch_sum_tile<MAXS, true>(a, cf, s)
                       : launch_sum_tile<MAXS, false>(a, cf, s);
    });
  }
  if (!simple && tile != 0) return (int)cudaErrorInvalidConfiguration;
  a.T = 64;
  while (a.T > 1 && C * a.T > kMaxThreads) a.T /= 2;
  if (Ppad % a.T != 0 || Ppad / a.T > 65535)
    return (int)cudaErrorInvalidConfiguration;
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

// parts: a device array of K descriptors (PartDesc); dims: their (C*S,
// Ppad) on the host, which set the launch (newton_config; force as
// there).
extern "C" int pllmod_newton_edges(
    const void* parts, int K, const long long* dims, const float* t0,
    float xmin, float xmax, float tol, int max_iters, float* t_out,
    float* lnl0_out, int* iters_out, int nE, int force, void* stream) {
  NewtonConfig nc;
  if (max_iters < 1 || nE < 1 || !newton_config(K, dims, force, &nc))
    return (int)cudaErrorInvalidValue;
  int total_cs = 0;
  for (int k = 0; k < K; ++k) total_cs += (int)dims[2 * k];
  const PartDesc* pd = static_cast<const PartDesc*>(parts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nc.kind == 1) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    const int err = prepare_cluster(nE, nc, st, &cfg, &attr);
    if (err) return err;
    return (int)cudaLaunchKernelEx(&cfg, newton_cluster_kernel, pd, K,
                                   total_cs, nE, t0, xmin, xmax, tol,
                                   max_iters, t_out, lnl0_out, iters_out);
  }
  size_t smem;
  const int err =
      prepare_deriv((const void*)newton_edge_kernel, total_cs, smem);
  if (err != 0) return err;
  newton_edge_kernel<<<nE, kDerivThreads, smem, st>>>(
      pd, K, nE, t0, xmin, xmax, tol, max_iters, t_out, lnl0_out,
      iters_out);
  return (int)cudaGetLastError();
}
