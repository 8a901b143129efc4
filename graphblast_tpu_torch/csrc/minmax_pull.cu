// Min/max row fold of the plan-less pull (S): y[i] = (+) over the edges e of
// row i of val[e] (x) x[clamp(ind[e], 0, n_in - 1)], and the semiring's
// identity for a row with no edges, where (+) is min or max and (x) is plus,
// multiplies, select-second or not-equal-to, all in x's type (int32 or
// float32). It is the pull of ops/spmv.py spmv_pull for the catalogue's five
// semirings with a min/max (+): MaximumMultiplies (MIS and graph colouring
// over the int32 CSC), MinimumSelectSecond (CC at n >= 2^24 over the CSR),
// MinimumPlus, MinimumMultiplies and MinimumNotEqualTo.
//
// Replaces no Pallas kernel: graphblast_tpu/ops/segops.py:35 segmented_scan
// is plain jnp, reached through segment_reduce_csr (:64) after the gather of
// x at the column ids. There the edge products go through a Hillis-Steele
// flag scan (log2 nnz steps over the whole edge array) and the row results
// are gathered at the segment tails. Here one launch reads each edge once,
// gathers x, applies (x) and folds (+) per row through the row schedule
// (row_schedule.cuh, the orientation's cached RowSchedule): short rows 4-32
// lanes each, medium rows a warp each, rows of more than 8192 edges an
// 8-block cluster each. min and max on integers, and on floats up to the
// sign of zero, do not depend on the order, so the result equals the plain
// PyTorch version and two launches agree bitwise.
//
// What the reference's function asks of the fold, and how this policy
// differs from K4's (monoid_pull.cu):
//   - the scan folds only a row's own products, and an empty row gets the
//     identity. MaximumMonoid's identity is 0 (the reference's quirk), so a
//     fold started there would turn a row of negative products into 0: the
//     fold starts at the true neutral (INT_MIN / INT_MAX, -inf / +inf) and
//     the identity is written only for empty rows (the walk's empty_row());
//   - no clamp: inf stays inf, and inf + (-inf) is NaN, as in torch;
//   - min and max propagate NaN, as torch.minimum / torch.maximum do (fminf
//     and fmaxf would drop it);
//   - int32 products wrap, as torch's do: they are formed in uint32_t, since
//     a signed overflow is undefined in C++;
//   - float products round once (__fadd_rn / __fmul_rn, no fused
//     multiply-add); not-equal-to gives 1 or 0 in x's type;
//   - select-second reads no value array.
//
// Bound on an H100 SXM: memory. Each call must read ind (4 B an edge), val
// (4 B an edge, none for select-second), ptr (n_out + 1), x (n_in) and
// write y (n_out): at RMAT scale 18, 64,028,004 B for MaximumMultiplies over
// the CSC (19.1 us at 3.35 TB/s) and 33,586,868 B for MinimumSelectSecond
// over the CSR (10.0 us), K4's footprint.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (graphblast_tpu_torch/ops/kernels/_build.py)
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "row_schedule.cuh"

namespace {

// (+) and (x) codes; the wrapper passes the same numbers
constexpr int kMin = 0, kMax = 1;
constexpr int kPlus = 0, kMul = 1, kSecond = 2, kNotEqual = 3;

// x's type: the neutral of min and max, and the operations in it
template <class T>
struct Arith;

template <>
struct Arith<int32_t> {
  static __device__ __forceinline__ int32_t lowest() { return INT32_MIN; }
  static __device__ __forceinline__ int32_t highest() { return INT32_MAX; }
  static __device__ __forceinline__ int32_t plus(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
  static __device__ __forceinline__ int32_t mul(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
  }
  static __device__ __forceinline__ int32_t min(int32_t a, int32_t b) {
    return a < b ? a : b;
  }
  static __device__ __forceinline__ int32_t max(int32_t a, int32_t b) {
    return a > b ? a : b;
  }
};

template <>
struct Arith<float> {
  static __device__ __forceinline__ float lowest() { return -highest(); }
  static __device__ __forceinline__ float highest() {
    return __int_as_float(0x7f800000);   // +inf
  }
  static __device__ __forceinline__ float plus(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  // NaN in either operand gives NaN: a when a is NaN, else b when the
  // comparison fails on a NaN b
  static __device__ __forceinline__ float min(float a, float b) {
    return (a != a || a < b) ? a : b;
  }
  static __device__ __forceinline__ float max(float a, float b) {
    return (a != a || a > b) ? a : b;
  }
};

// the schedule's policy: each edge's product, folded with (+) from its
// neutral; an empty row gets the semiring's identity
template <class T, int kAdd, int kTimes>
struct MinMaxFold {
  using Acc = T;
  using Item = T;   // the edge's product
  const T* __restrict__ val;   // not read for select-second
  const T* __restrict__ x;
  int last;    // n_in - 1: column ids are clamped into x, as `take` does
  T empty;     // the semiring's identity

  __device__ __forceinline__ T identity() const {
    return kAdd == kMin ? Arith<T>::highest() : Arith<T>::lowest();
  }
  __device__ __forceinline__ T empty_row() const { return empty; }
  __device__ __forceinline__ T fetch(int j, long long e) const {
    const T xv = __ldg(x + (j < 0 ? 0 : (j > last ? last : j)));
    if (kTimes == kSecond) return xv;
    const T a = __ldg(val + e);
    if (kTimes == kPlus) return Arith<T>::plus(a, xv);
    if (kTimes == kMul) return Arith<T>::mul(a, xv);
    return a != xv ? T(1) : T(0);
  }
  __device__ __forceinline__ T add(T acc, T p) const {
    return combine(acc, p);
  }
  static __device__ __forceinline__ T combine(T a, T b) {
    return kAdd == kMin ? Arith<T>::min(a, b) : Arith<T>::max(a, b);
  }
};

struct Args {
  const int32_t* ptr;
  const int32_t* ind;
  const void* val;
  const void* x;
  void* y;
  const int32_t* perm;
  const int32_t* chunk_beg;
  row_schedule::Sched s;
  int last;
  uint32_t empty_bits;
  cudaStream_t stream;
};

template <class T, int kAdd, int kTimes>
cudaError_t launch(const Args& a) {
  T empty;
  std::memcpy(&empty, &a.empty_bits, sizeof(T));
  const MinMaxFold<T, kAdd, kTimes> p{(const T*)a.val, (const T*)a.x, a.last,
                                      empty};
  return row_schedule::launch(p, a.ptr, a.ind, (T*)a.y, a.perm, a.chunk_beg,
                              a.s, a.stream);
}

// the five (+, x) pairs of the catalogue
template <class T>
cudaError_t launch_pair(const Args& a, int add, int times) {
  if (add == kMax && times == kMul) return launch<T, kMax, kMul>(a);
  if (add != kMin) return cudaErrorInvalidValue;
  switch (times) {
    case kPlus:
      return launch<T, kMin, kPlus>(a);
    case kMul:
      return launch<T, kMin, kMul>(a);
    case kSecond:
      return launch<T, kMin, kSecond>(a);
    case kNotEqual:
      return launch<T, kMin, kNotEqual>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's error (0 on success), or
// cudaErrorInvalidValue for an (add, times) pair with no instantiation.
// add: 0 min, 1 max; times: 0 plus, 1 multiplies, 2 select-second, 3
// not-equal-to; is_float: x, val and y are float32, else int32. `val` may be
// null for select-second. `empty_bits` is the semiring's identity as the
// 32 bits of x's type. perm, chunk_beg and `meta` (a host array of 2 * 7
// ints) are the row schedule's, as gb_value_pull takes them. The caller
// allocates y, passes a ptr that indexes into ind, n_in >= 1 when there is
// an edge, and never a schedule with no block.
int gb_minmax_pull(const void* ptr, const void* ind, const void* val,
                   const void* x, void* y, const void* perm,
                   const void* chunk_beg, const int* meta, long long n_in,
                   int add, int times, int is_float, unsigned int empty_bits,
                   void* stream) {
  const Args a{(const int32_t*)ptr, (const int32_t*)ind, val, x, y,
               (const int32_t*)perm, (const int32_t*)chunk_beg,
               row_schedule::sched_of(meta), (int)(n_in - 1),
               (uint32_t)empty_bits, (cudaStream_t)stream};
  const cudaError_t err = is_float ? launch_pair<float>(a, add, times)
                                   : launch_pair<int32_t>(a, add, times);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

const char* gb_minmax_pull_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
