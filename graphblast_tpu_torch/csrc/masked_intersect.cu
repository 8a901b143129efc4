// Masked intersection of sorted rows: the device walk of the masked SpGEMM
// and of triangle counting. For each mask edge e = (i, j), la is A's row i
// (A's CSR) and lb is B's list j (B's row j when B is taken transposed,
// else B's column j, from its CSC). Two entries share one walk:
//   T1 gb_masked_intersect_count: the sum over the mask of |la ∩ lb|, one
//      64-bit total (triangle counting: tc(L) over L, L, mask L, Lᵀ);
//   T2 gb_masked_intersect_fold:  c[e] = (+)_{k in la ∩ lb} A[i,k] (x) B[k,j]
//      for the catalogue's semirings whose (+) is plus, min, max or logical
//      or, in float32 or int32 (the masked mxm, and the trace over the
//      diagonal pairs (i, i)).
//
// Replaces no Pallas kernel: graphblast_tpu/ops/spgemm.py:159
// _masked_count_chunk and :70 _masked_join_chunk are plain jnp. There the
// mask is cut into host-planned chunks whose expansion (one lane per walked
// entry) fits the TPU's memory, and every chunk sorts its query keys
// together with B's keys and carries run heads with cummax. The GPU design
// they re-derive is GraphBLAST's warp-per-mask-row kernel, which binary-
// searches each row entry (kernels/spgemm.hpp:17-79). Here one warp takes
// one mask edge: its lanes stride the SHORTER of la and lb (min side, as
// the JAX package's plan chooses: B's list when it is strictly shorter)
// and find each key with a lower_bound in the longer one. A lane's keys
// ascend, so each search starts where the lane's last one ended. No
// expansion is stored: nothing here needs workspace.
//
// Both lists must be sorted with no duplicate ids (the JAX precondition,
// spgemm.py:381-382; ops/spgemm.py checks it once per Matrix).
//
// T1 sums each edge's matches (int32) across the warp, each block sums its
// warps' totals in 64 bits and adds them to the total with one atomicAdd
// on an unsigned long long: integer sums do not depend on the order, so the
// total is exact and the same on every run.
//
// T2's fold order is fixed: each lane folds its own matches in the order
// it walks them, starting at (+)'s neutral element (-inf or INT_MIN for
// max, +inf or INT_MAX for min, 0 for plus and or), then a butterfly of
// shuffles (offsets 16, 8, 4, 2, 1) combines the lanes. So a launch is
// bitwise equal to any other on the same inputs. (x) always takes A's
// value first, whichever list is walked (the JAX package's swap_mul).
// The semiring's identity joins the fold where the JAX package's join
// brings it in: there each walked id with no partner adds one identity
// (spgemm.py:145-154), so for the masked mxm it joins where the lists
// share fewer ids than the shorter holds, or none; for the trace, which
// tests every id of A's row (spgemm.py:705-723), where A's row holds an id
// B's lacks. This matters for min and max only, where the identity is not
// neutral: MaximumMonoid's is 0 (the reference's quirk), so a max of
// negative products is 0 exactly where a walked id missed.
// Float products and sums round once (__fmul_rn, __fadd_rn, __fdiv_rn: no
// fused multiply-add); int32 arithmetic wraps, formed in uint32_t; min and
// max propagate NaN, as torch.minimum and torch.maximum do; logical ops
// give 1 or 0 in the value type.
//
// Bound on an H100 SXM: memory, and the probes of the searched lists are
// scattered. Each call must read the mask (8 B an edge), A's and B's
// pointers at the edge's ends (16 B), the walked entries once (4 B each,
// 8 B for T2's values) and, for each walked entry, the 32-byte sectors its
// binary search touches in the longer list (about log2 of its length);
// T2 writes 4 B an edge. chip_smoke.py reckons the bytes from the run's
// data. The first design's open question is balance: a warp per edge
// leaves hub x hub edges on a few warps (PERF.md, open questions).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (graphblast_tpu_torch/ops/kernels/_build.py)
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kCountEdgesPerBlock = 64;    // T1: edges a block, one atomic
constexpr unsigned kFull = 0xffffffffu;

// (+) and (x) codes; the wrapper passes the same numbers
constexpr int kAddPlus = 0, kAddMin = 1, kAddMax = 2, kAddLor = 3;
constexpr int kMulPlus = 0, kMulMinus = 1, kMulTimes = 2, kMulDiv = 3,
              kMulGreater = 4, kMulLess = 5, kMulNotEqual = 6,
              kMulSecond = 7, kMulLand = 8;

struct Operands {
  const int32_t* mi;      // mask row ids, one an edge
  const int32_t* mj;      // mask column ids
  long long m;            // mask edges
  const int32_t* a_ptr;   // A's CSR
  const int32_t* a_ind;
  const int32_t* b_ptr;   // B's rows (transposed) or columns (its CSC)
  const int32_t* b_ind;
};

// first position in s[lo, hi) whose id is not below key
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ s,
                                           int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(s + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The walk of mask edge e by one lane of its warp: visit(a_pos, b_pos) for
// every id the two lists share that lies in this lane's share of the walked
// list (its entries lane, lane + 32, ...), in the order walked. Returns the
// lengths of la (x) and lb (y).
template <class Visit>
__device__ __forceinline__ int2 walk_edge(const Operands& o, long long e,
                                          int lane, Visit&& visit) {
  const int i = __ldg(o.mi + e), j = __ldg(o.mj + e);
  const int a0 = __ldg(o.a_ptr + i), a1 = __ldg(o.a_ptr + i + 1);
  const int b0 = __ldg(o.b_ptr + j), b1 = __ldg(o.b_ptr + j + 1);
  const bool walk_a = !(b1 - b0 < a1 - a0);   // B only when strictly shorter
  const int32_t* w = walk_a ? o.a_ind : o.b_ind;
  const int32_t* s = walk_a ? o.b_ind : o.a_ind;
  const int w0 = walk_a ? a0 : b0, w1 = walk_a ? a1 : b1;
  const int s1 = walk_a ? b1 : a1;
  int lo = walk_a ? b0 : a0;
  for (int t = w0 + lane; t < w1; t += 32) {
    const int key = __ldg(w + t);
    lo = lower_bound(s, lo, s1, key);
    if (lo == s1) break;                     // every later key is larger
    if (__ldg(s + lo) == key) {
      if (walk_a)
        visit(t, lo);
      else
        visit(lo, t);
    }
  }
  return make_int2(a1 - a0, b1 - b0);
}

// ---- T1: the count ------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
count_kernel(Operands o, unsigned long long* __restrict__ total) {
  __shared__ unsigned long long warp_sums[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned long long mine = 0;
  const long long base = (long long)blockIdx.x * kCountEdgesPerBlock;
  for (int r = warp; r < kCountEdgesPerBlock; r += kWarps) {
    const long long e = base + r;
    if (e >= o.m) break;
    int c = 0;
    walk_edge(o, e, lane, [&](int, int) { ++c; });
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
    mine += (unsigned)c;
  }
  if (lane == 0) warp_sums[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
    if (s) atomicAdd(total, s);
  }
}

// ---- T2: the semiring fold ----------------------------------------------

template <class T>
struct Arith;

template <>
struct Arith<int32_t> {
  static __device__ __forceinline__ int32_t plus(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
  static __device__ __forceinline__ int32_t minus(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
  }
  static __device__ __forceinline__ int32_t times(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
  }
  static __device__ __forceinline__ int32_t div(int32_t, int32_t) {
    return 0;   // never instantiated: true division leaves int32
  }
  static __device__ __forceinline__ int32_t min(int32_t a, int32_t b) {
    return a < b ? a : b;
  }
  static __device__ __forceinline__ int32_t max(int32_t a, int32_t b) {
    return a > b ? a : b;
  }
  static __device__ __forceinline__ int32_t top() { return INT32_MAX; }
  static __device__ __forceinline__ int32_t bottom() { return INT32_MIN; }
};

template <>
struct Arith<float> {
  static __device__ __forceinline__ float plus(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float minus(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float times(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  // NaN in either operand gives NaN
  static __device__ __forceinline__ float min(float a, float b) {
    return (a != a || a < b) ? a : b;
  }
  static __device__ __forceinline__ float max(float a, float b) {
    return (a != a || a > b) ? a : b;
  }
  static __device__ __forceinline__ float top() { return INFINITY; }
  static __device__ __forceinline__ float bottom() { return -INFINITY; }
};

template <class T, int kMul>
__device__ __forceinline__ T mul_op(T a, T b) {
  if (kMul == kMulPlus) return Arith<T>::plus(a, b);
  if (kMul == kMulMinus) return Arith<T>::minus(a, b);
  if (kMul == kMulTimes) return Arith<T>::times(a, b);
  if (kMul == kMulDiv) return Arith<T>::div(a, b);
  if (kMul == kMulGreater) return a > b ? T(1) : T(0);
  if (kMul == kMulLess) return a < b ? T(1) : T(0);
  if (kMul == kMulNotEqual) return a != b ? T(1) : T(0);
  if (kMul == kMulSecond) return b;
  return (a != T(0) && b != T(0)) ? T(1) : T(0);   // logical and
}

template <class T, int kAdd>
__device__ __forceinline__ T add_op(T a, T b) {
  if (kAdd == kAddPlus) return Arith<T>::plus(a, b);
  if (kAdd == kAddMin) return Arith<T>::min(a, b);
  if (kAdd == kAddMax) return Arith<T>::max(a, b);
  return (a != T(0) || b != T(0)) ? T(1) : T(0);   // logical or
}

// (+)'s neutral element, where each lane's fold starts
template <class T, int kAdd>
__device__ __forceinline__ T neutral() {
  if (kAdd == kAddMin) return Arith<T>::top();
  if (kAdd == kAddMax) return Arith<T>::bottom();
  return T(0);
}

// when the semiring's identity joins an edge's fold (header)
constexpr int kRuleMask = 0, kRuleTrace = 1;

template <class T, int kAdd, int kMul>
__global__ void __launch_bounds__(kThreads)
fold_kernel(Operands o, const T* __restrict__ a_val,
            const T* __restrict__ b_val, T* __restrict__ c, T identity,
            int rule) {
  constexpr bool kMinMax = kAdd == kAddMin || kAdd == kAddMax;
  const long long e = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= o.m) return;   // the whole warp leaves together
  T acc = neutral<T, kAdd>();
  int hits = 0;
  const int2 len = walk_edge(o, e, lane, [&](int a_pos, int b_pos) {
    ++hits;
    acc = add_op<T, kAdd>(
        acc, mul_op<T, kMul>(__ldg(a_val + a_pos), __ldg(b_val + b_pos)));
  });
  for (int off = 16; off > 0; off >>= 1) {
    acc = add_op<T, kAdd>(acc, __shfl_xor_sync(kFull, acc, off));
    if (kMinMax) hits += __shfl_xor_sync(kFull, hits, off);
  }
  if (lane != 0) return;
  if (kMinMax) {   // plus and or start at their identity, 0
    const bool miss = rule == kRuleTrace
                          ? hits < len.x
                          : hits < min(len.x, len.y) || hits == 0;
    if (miss) acc = add_op<T, kAdd>(acc, identity);
  }
  c[e] = acc;
}

template <class T, int kAdd, int kMul>
cudaError_t launch_fold(const Operands& o, const void* a_val,
                        const void* b_val, void* c, uint32_t identity_bits,
                        int rule, cudaStream_t stream) {
  T identity;
  std::memcpy(&identity, &identity_bits, sizeof(T));
  const long long blocks = (o.m + kWarps - 1) / kWarps;
  fold_kernel<T, kAdd, kMul><<<(unsigned)blocks, kThreads, 0, stream>>>(
      o, (const T*)a_val, (const T*)b_val, (T*)c, identity, rule);
  return cudaGetLastError();
}

// the catalogue's semirings whose (+) is plus, min, max or logical or
template <class T>
cudaError_t launch_pair(int add, int mul, const Operands& o,
                        const void* a_val, const void* b_val, void* c,
                        uint32_t bits, int rule, cudaStream_t st) {
#define GB_PAIR(A, M)                                                  \
  if (add == A && mul == M)                                            \
    return launch_fold<T, A, M>(o, a_val, b_val, c, bits, rule, st);
  GB_PAIR(kAddLor, kMulLand)       // LogicalOrAnd
  GB_PAIR(kAddPlus, kMulTimes)     // PlusMultiplies
  GB_PAIR(kAddMin, kMulPlus)       // MinimumPlus
  GB_PAIR(kAddMax, kMulTimes)      // MaximumMultiplies
  GB_PAIR(kAddPlus, kMulGreater)   // PlusGreater
  GB_PAIR(kAddPlus, kMulMinus)     // PlusMinus
  GB_PAIR(kAddPlus, kMulLess)      // PlusLess
  GB_PAIR(kAddMin, kMulTimes)      // MinimumMultiplies
  GB_PAIR(kAddMin, kMulSecond)     // MinimumSelectSecond
  GB_PAIR(kAddPlus, kMulNotEqual)  // PlusNotEqualTo
  GB_PAIR(kAddMin, kMulNotEqual)   // MinimumNotEqualTo
#undef GB_PAIR
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// T1. Zeroes *total (one unsigned 64-bit word) on `stream`, then adds
// sum over the m mask edges of |la ∩ lb| to it. Returns the first error
// (0 on success). The caller passes m >= 1 and ids within the pointers.
int gb_masked_intersect_count(const void* mi, const void* mj, long long m,
                              const void* a_ptr, const void* a_ind,
                              const void* b_ptr, const void* b_ind,
                              void* total, void* stream) {
  const Operands o{(const int32_t*)mi, (const int32_t*)mj, m,
                   (const int32_t*)a_ptr, (const int32_t*)a_ind,
                   (const int32_t*)b_ptr, (const int32_t*)b_ind};
  cudaError_t err = cudaMemsetAsync(total, 0, sizeof(unsigned long long),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (m + kCountEdgesPerBlock - 1) / kCountEdgesPerBlock;
  count_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      o, (unsigned long long*)total);
  return (int)cudaGetLastError();
}

// T2. Writes c[e] for the m mask edges. add: 0 plus, 1 min, 2 max, 3
// logical or; mul: 0 plus, 1 minus, 2 multiplies, 3 divides, 4 greater, 5
// less, 6 not-equal-to, 7 select-second, 8 logical and; is_float: a_val,
// b_val and c are float32, else int32. identity_bits is the semiring's
// identity as the 32 bits of the value type. Returns the launch's error (0
// on success), or cudaErrorInvalidValue for a pair with no instantiation.
// rule: 0 the masked mxm's (the identity joins where the lists share fewer
// ids than the shorter holds, or none), 1 the trace's (where la holds an
// id lb lacks).
int gb_masked_intersect_fold(const void* mi, const void* mj, long long m,
                             const void* a_ptr, const void* a_ind,
                             const void* a_val, const void* b_ptr,
                             const void* b_ind, const void* b_val, void* c,
                             int add, int mul, int is_float,
                             unsigned int identity_bits, int rule,
                             void* stream) {
  const Operands o{(const int32_t*)mi, (const int32_t*)mj, m,
                   (const int32_t*)a_ptr, (const int32_t*)a_ind,
                   (const int32_t*)b_ptr, (const int32_t*)b_ind};
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_float) {
    if (add == kAddPlus && mul == kMulDiv)   // PlusDivides, float32 only
      return (int)launch_fold<float, kAddPlus, kMulDiv>(
          o, a_val, b_val, c, identity_bits, rule, st);
    return (int)launch_pair<float>(add, mul, o, a_val, b_val, c,
                                   identity_bits, rule, st);
  }
  return (int)launch_pair<int32_t>(add, mul, o, a_val, b_val, c,
                                   identity_bits, rule, st);
}

const char* gb_masked_intersect_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
