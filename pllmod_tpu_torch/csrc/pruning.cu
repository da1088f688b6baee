// The resident pruning kernel for Hopper (sm_90a): a whole post-order
// traversal of CLV (conditional likelihood vector) updates in one launch,
// the live CLVs in shared memory.
//
// pllmod_resident_walk replaces the TPU kernel
// pllmod_tpu/ops/pallas_resident.py::_make_resident_kernel. The live CLV
// slots of a Sethi-Ullman slot-recycled schedule (ops/resident.py
// compile_resident: ~ceil(log2 n_tips)+3 slots) stay in shared memory as
// [NS][C*S][T] floats with their int32 scaler rows; only the last row (the
// root pseudo-node, (f*clv_u) x (P_root clv_v)) writes to device memory:
// prod [C*S, Ppad] and the total scaler [Ppad]. (The fused walk, which
// leaves every CLV in device memory, is csrc/fused.cu.)
//
// Design. One CTA owns a tile of T pattern columns and walks every idx8
// row in order; pattern columns are independent, so no CTA waits on
// another (the TPU kernel's level fences and DMA lookahead have no
// counterpart). Thread (c, p) owns category c of pattern p: it reads its
// S child values of each child into registers, applies the category's
// S x S matrices, multiplies the two results and rescales by an exact
// power of two. The only exchange between threads is the per-pattern
// maximum over categories (shared memory) and the row's matrices, which
// the CTA stages into shared memory when they fit beside the rest (else
// every thread reads them from device memory, where they stay in L1/L2).
// A thread only ever reads CLV and scaler values that it wrote itself, so
// an out slot may alias a child slot (slot recycling) without hazard. Two
// barriers a row suffice: the next row's matrices are staged only after
// every thread has passed the barrier that follows its last read of this
// row's. Tip children are expanded from int32 tip codes through the
// code->CLV table held in shared memory (no expanded tip planes).
//
// Exactness. Products and sums are rounded separately (__fmul_rn /
// __fadd_rn, never contracted to FMA) in child-state order j = 0..S-1, and
// the rescale is the bit formula of pallas_resident.py:469-477, both in
// csrc/common.cuh: the plain PyTorch version (ops/clv.py::
// walk_rows_plain) does the same operations in the same order, so kernel
// and plain version agree bit for bit.
//
// Bound on the H100 at the flagship shape (128 taxa x 16384 patterns,
// GTR+G4, C*S = 16; 127 rows incl. the root row; chip_smoke.py computes
// the exact figure from the run's table): per pattern, C*S*S
// multiply-adds (2 flops each) = 128 flops for each child that is not a
// tip (~125 of the 254 children; a tip child's P x is a lookup of P x
// codetab, pattern-independent), C*S = 16 multiplies for the root row's
// diag(freqs) child, and the product, max and scale (3 C*S = 48 flops) of
// every row: ~22 kflop a pattern, 0.36 GFLOP = 5.4 us at the 67 TFLOP/s
// float32 non-tensor peak (which counts an FMA as 2 flops; without FMA the
// issue rate halves that peak). Bytes: tip codes 8.4 MB + matrices 65 KB
// + prod 1 MB = 9.5 MB = 2.8 us at 3.35 TB/s: bound by operations.
#include "common.cuh"

namespace {

using common::kMaxThreads;

// [nW,8] idx8 columns
constexpr int kSlot1 = 0, kSlot2 = 1, kIsTip1 = 2, kIsTip2 = 3,
              kTip1 = 4, kTip2 = 5, kOut = 6;

struct WalkArgs {
  const int* idx8;       // [nW, 8]
  int nW;
  const float* P5;       // [nW, 2, C, S, S]
  const int* codes;      // [n_tips, Ppad]
  const float* codetab;  // [n_codes, S]
  int n_codes;
  float* clv_out;        // prod [C*S, Ppad]
  int* sc_out;           // [Ppad]
  int Ppad, C, S, n_slots, T;
};

// Shared memory of one CTA, in floats, without the staged matrices: the
// code table, the category maxima and the live slots with their scaler
// rows.
size_t base_floats(int C, int S, int n_codes, int n_slots, int T) {
  return (size_t)n_codes * S + (size_t)C * T +
         (size_t)n_slots * C * S * T + (size_t)n_slots * T;
}

// The matrices of one row are staged when they fit beside the rest.
bool stages_p(int C, int S, int n_codes, int n_slots, int T) {
  return common::fits_smem(base_floats(C, S, n_codes, n_slots, T) +
                           (size_t)2 * C * S * S);
}

size_t smem_bytes(int C, int S, int n_codes, int n_slots, int T) {
  size_t f = base_floats(C, S, n_codes, n_slots, T);
  if (stages_p(C, S, n_codes, n_slots, T)) f += (size_t)2 * C * S * S;
  return 4 * f;
}

// Child of the row: its S values of category c at (global) pattern p, and
// its cumulative scaler (only category 0 tracks scalers).
template <int MAXS>
__device__ __forceinline__ void load_child(
    const WalkArgs& a, const float* tab, const float* slots, const int* ssc,
    bool is_tip, int tip, int slot, int c, int pl, int p, float (&x)[MAXS],
    int& sc) {
  const int S = a.S, CS = a.C * a.S;
  if (is_tip) {
    common::load_tip<MAXS>(tab, a.codes[(size_t)tip * a.Ppad + p], a.n_codes,
                           S, x);
    sc = 0;
  } else {
    common::load_column<MAXS>(slots + ((size_t)slot * CS + c * S) * a.T + pl,
                              a.T, S, x);
    sc = (c == 0) ? ssc[slot * a.T + pl] : 0;
  }
}

// STAGE: the row's matrices are staged in shared memory (a template
// argument, so that their reads compile to shared-memory loads).
template <int MAXS, bool STAGE>
__global__ void __launch_bounds__(kMaxThreads)
pruning_walk(WalkArgs a) {
  extern __shared__ float smem[];
  const int T = a.T, C = a.C, S = a.S, CS = C * S;
  const int psz = 2 * C * S * S;            // one row's two child matrices
  float* tab = smem;                        // [n_codes * S]
  float* red = tab + a.n_codes * S;         // [C][T]
  float* slots = red + C * T;               // [NS][CS][T]
  int* ssc = reinterpret_cast<int*>(slots + a.n_slots * CS * T);
  float* Pbuf = reinterpret_cast<float*>(ssc + a.n_slots * T);

  const int tid = threadIdx.x;
  const int c = tid / T;
  const int pl = tid - c * T;
  const int p = blockIdx.x * T + pl;
  const int nthr = blockDim.x;

  for (int i = tid; i < a.n_codes * S; i += nthr) tab[i] = a.codetab[i];

  for (int w = 0; w < a.nW; ++w) {
    const float* Pw = a.P5 + (size_t)w * psz;
    if (STAGE) {
      for (int i = tid; i < psz; i += nthr) Pbuf[i] = Pw[i];
      Pw = Pbuf;
    }
    const int* row = a.idx8 + 8 * w;
    const int s1 = min(max(row[kSlot1], 0), a.n_slots - 1);
    const int s2 = min(max(row[kSlot2], 0), a.n_slots - 1);
    const int out = min(max(row[kOut], 0), a.n_slots - 1);
    const bool root = w == a.nW - 1;
    __syncthreads();                        // matrices (and tab) staged

    float x1[MAXS], x2[MAXS], o[MAXS];
    int sc1, sc2;
    load_child<MAXS>(a, tab, slots, ssc, row[kIsTip1] != 0, row[kTip1], s1,
                     c, pl, p, x1, sc1);
    load_child<MAXS>(a, tab, slots, ssc, row[kIsTip2] != 0, row[kTip2], s2,
                     c, pl, p, x2, sc2);
    const float* Pa = Pw + c * S * S;
    const float* Pb = Pw + C * S * S + c * S * S;
    const float m = common::child_product<MAXS>(Pa, Pb, S, x1, x2, o);
    const int e = common::rescale_exponent(red, m, c, pl, C, T);
    const int stot = sc1 + sc2 + e;

    if (root) {
      common::store_scaled<MAXS, MAXS>(
          a.clv_out + (size_t)(c * S) * a.Ppad + p, a.Ppad, S, o, e);
      if (c == 0) a.sc_out[p] = stot;
    } else {
      common::store_scaled<MAXS, MAXS>(
          slots + ((size_t)out * CS + c * S) * T + pl, T, S, o, e);
      if (c == 0) ssc[out * T + pl] = stot;
    }
  }
}

template <int MAXS>
int launch_t(const WalkArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.C, a.S, a.n_codes, a.n_slots, a.T);
  if (smem > common::kSmemOptin) return (int)cudaErrorInvalidValue;
  return common::launch_kernel(
      stages_p(a.C, a.S, a.n_codes, a.n_slots, a.T)
          ? pruning_walk<MAXS, true>
          : pruning_walk<MAXS, false>,
      dim3(a.Ppad / a.T), dim3(a.C * a.T), smem, stream, a);
}

int launch(const WalkArgs& a, cudaStream_t stream) {
  if (a.C * a.T > kMaxThreads || a.Ppad % a.T != 0)
    return (int)cudaErrorInvalidConfiguration;
  return common::dispatch_states(a.S, [&](auto m) {
    return launch_t<decltype(m)::value>(a, stream);
  });
}

}  // namespace

// Returns the CUDA error code of the launch (0 = queued).
extern "C" int pllmod_resident_walk(
    const int* idx8, int nW, const float* P5, const int* codes,
    const float* codetab, int n_codes, float* prod, int* scaler, int Ppad,
    int C, int S, int n_slots, int T, void* stream) {
  WalkArgs a{idx8, nW, P5, codes, codetab, n_codes, prod, scaler,
             Ppad, C, S, n_slots, T};
  return launch(a, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory a resident launch requests (bytes);
// ops/_build.py computes the same without the library.
extern "C" long long pllmod_resident_smem_bytes(int C, int S, int n_codes,
                                                int n_slots, int T) {
  return (long long)smem_bytes(C, S, n_codes, n_slots, T);
}
