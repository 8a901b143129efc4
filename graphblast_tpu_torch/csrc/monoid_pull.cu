// Monoid pull (K4): y[i] = ident (+) ((+) over the edges e of row i of the
// pull orientation of clamp(val[e] (x) x[ind[e]], -FLT_MAX, FLT_MAX)), where
// (+) is min or max and (x) is plus, multiplies or select-second, all in
// fp32. A row with no edges gives the identity, not 0. SSSP runs MinimumPlus
// over the CSC (vxm) each iteration, CC MinimumSelectSecond over the CSR
// (mxv) on the float image of its grandparent ids.
//
// Replaces graphblast_tpu/ops/pallas/monopull.py:172 _mono_kernel (launched
// by _spmv_monoid, monopull.py:399). That kernel lexsorts the edges into
// 4096-square tiles, sweeps 128-lane windows of x, reduces each row with a
// Hillis-Steele run-scan and selects the run totals into y through a one-hot
// matrix-unit product with presence rows and a hi/lo bf16 split: all of it
// because the TPU has no scatter and its matrix unit wants dense tiles. Here
// the plan is the pull orientation's CSR read through the row schedule that
// the value pull uses (row_schedule.cuh, the orientation's cached
// RowSchedule): short rows 4-32 lanes each, medium rows a warp each, rows
// of more than 8192 edges an 8-block cluster each whose chunk results are
// folded through distributed shared memory. Every fold (a lane's edges,
// the shuffles, a block's warps, a long row's chunks) starts at the
// identity, so empty rows, which sit in the 4-lane bin, keep it. min and
// max do not depend on order, so the result equals the plain PyTorch
// version's (gather, product, clamp, scatter_reduce) and two launches agree
// bitwise. Products use __fadd_rn / __fmul_rn, never a fused multiply-add,
// so they round exactly as the plain version's. The clamp turns an
// overflow such as FLT_MAX + w (SSSP's unreached sentinel plus a weight)
// into FLT_MAX, as the TPU kernel's saturation does; with select-second the
// value array is not read at all.
//
// Bound on an H100 SXM: memory. Each call must read ind (4 B per edge), val
// (4 B per edge, none for select-second), ptr (n_out + 1), x (n_in) and
// write y (n_out): at RMAT scale 18, 64,028,004 B for MinimumPlus over the
// CSC (19.1 us at 3.35 TB/s) and 33,586,868 B for MinimumSelectSecond over
// the CSR (10.0 us). The first design, one warp a row, took 10.6x the
// bound for MinimumPlus: lanes idle on short rows and the hub row (25,077
// edges) as 784 strided steps on one warp (PERF.md).
//
// The masked entry (gb_monoid_pull_masked, MinimumPlus only) serves SSSP's
// pull, whose caller keeps y[i] only where y[i] < bound[i] (the distances
// v) and writes the identity FLT_MAX elsewhere. It skips two kinds of work
// that filter would discard, and is exact against the unmasked entry
// followed by it:
//   - columns off the frontier: x[j] = FLT_MAX there, and clamp(w +
//     FLT_MAX) = FLT_MAX, the identity, for every weight w of the plan
//     (the wrapper takes this entry only where fl(FLT_MAX + w_min) rounds
//     to FLT_MAX or above, w_min the plan's least weight). Each edge tests
//     bit j of a packed frontier bitmap (x[j] != FLT_MAX, packed by the
//     wrapper as bitmap_pull's pack_bitmap packs K1's frontier) first,
//     and reads neither x[j] nor val[e] where it is clear;
//   - settled rows: t = fl(min x + w_min), a float32 device scalar. fl is
//     monotone, so every fl(w + x[j]) of any row is at least t, and a row
//     with bound[i] <= t can give no candidate under its bound (with t =
//     +inf every candidate clamps to FLT_MAX, the identity). Such a row is
//     closed (row_schedule.cuh's row_open hook) and written FLT_MAX with
//     no read of its ptr or ind.
// Its bytes: 4 B of bound and perm and of y for every row, ptr and the
// ids of the open rows, the bitmap (n_in / 8 B, in L2 at 4 MB for 2^25
// columns), and x and val only at the open rows' frontier columns.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (graphblast_tpu_torch/ops/kernels/_build.py)
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "row_schedule.cuh"

namespace {

// (+) and (x) codes; the wrapper passes the same numbers
constexpr int kMin = 0, kMax = 1;
constexpr int kPlus = 0, kMul = 1, kSecond = 2;

// the schedule's policy: each edge's clamped product, folded with (+)
template <int kAdd, int kTimes>
struct MonoidFold {
  using Acc = float;
  using Item = float;   // the clamped product
  const float* __restrict__ val;   // null: every value 1
  const float* __restrict__ x;
  float ident;

  __device__ __forceinline__ float identity() const { return ident; }
  __device__ __forceinline__ float fetch(int j, long long e) const {
    const float xv = __ldg(x + j);
    float p = xv;
    if (kTimes != kSecond) {
      const float a = val == nullptr ? 1.0f : __ldg(val + e);
      p = kTimes == kPlus ? __fadd_rn(a, xv) : __fmul_rn(a, xv);
    }
    return fminf(fmaxf(p, -FLT_MAX), FLT_MAX);
  }
  __device__ __forceinline__ float add(float acc, float p) const {
    return combine(acc, p);
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return kAdd == kMin ? fminf(a, b) : fmaxf(a, b);
  }
};

// the masked entry's policy: MonoidFold's MinimumPlus (its identity
// FLT_MAX) over the frontier's columns (bit j of `words` set), in the rows
// that `bound` leaves open
struct MonoidFoldMasked : MonoidFold<kMin, kPlus> {
  const uint32_t* __restrict__ words;
  const float* __restrict__ bound;
  const float* __restrict__ t;

  __device__ __forceinline__ float fetch(int j, long long e) const {
    const uint32_t c = (uint32_t)j;
    if (!((__ldg(words + (c >> 5)) >> (c & 31u)) & 1u)) return FLT_MAX;
    return MonoidFold<kMin, kPlus>::fetch(j, e);
  }
  // closed where bound[row] <= t; a NaN on either side leaves it open
  __device__ __forceinline__ bool row_open(int row) const {
    return !(__ldg(bound + row) <= __ldg(t));
  }
};

template <int kAdd, int kTimes>
cudaError_t launch(const int32_t* ptr, const int32_t* ind, const float* val,
                   const float* x, float* y, const int32_t* perm,
                   const int32_t* chunk_beg, const row_schedule::Sched& s,
                   float ident, cudaStream_t stream) {
  return row_schedule::launch(MonoidFold<kAdd, kTimes>{val, x, ident}, ptr,
                              ind, y, perm, chunk_beg, s, stream);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's error (0 on success), or
// cudaErrorInvalidValue for an (add, times) pair with no instantiation.
// add: 0 min, 1 max; times: 0 plus, 1 multiplies, 2 select-second. `val`
// may be null: every edge then has the value 1. perm, chunk_beg and `meta`
// (a host array of 2 * 7 ints) are the row schedule's, as gb_value_pull
// takes them. The caller allocates y and never passes a schedule with no
// block.
int gb_monoid_pull(const void* ptr, const void* ind, const void* val,
                   const void* x, void* y, const void* perm,
                   const void* chunk_beg, const int* meta, int add,
                   int times, float ident, void* stream) {
  const row_schedule::Sched s = row_schedule::sched_of(meta);
  const auto* p = (const int32_t*)ptr;
  const auto* i = (const int32_t*)ind;
  const auto* v = (const float*)val;
  const auto* xs = (const float*)x;
  auto* ys = (float*)y;
  const auto* pm = (const int32_t*)perm;
  const auto* cb = (const int32_t*)chunk_beg;
  const auto st = (cudaStream_t)stream;
  cudaError_t err;
  if (add == kMin && times == kPlus)
    err = launch<kMin, kPlus>(p, i, v, xs, ys, pm, cb, s, ident, st);
  else if (add == kMin && times == kMul)
    err = launch<kMin, kMul>(p, i, v, xs, ys, pm, cb, s, ident, st);
  else if (add == kMin && times == kSecond)
    err = launch<kMin, kSecond>(p, i, v, xs, ys, pm, cb, s, ident, st);
  else if (add == kMax && times == kMul)
    err = launch<kMax, kMul>(p, i, v, xs, ys, pm, cb, s, ident, st);
  else
    return (int)cudaErrorInvalidValue;
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The masked entry: y = the MinimumPlus pull, with y[i] = FLT_MAX at every
// row whose bound[i] <= *t (t a device scalar) and the edges whose bit is
// clear in `words` (ceil(n_in / 32) words) taken as FLT_MAX. bound has
// n_out entries. Other arguments as gb_monoid_pull's.
int gb_monoid_pull_masked(const void* ptr, const void* ind, const void* val,
                          const void* x, const void* words,
                          const void* bound, const void* t, void* y,
                          const void* perm, const void* chunk_beg,
                          const int* meta, void* stream) {
  const cudaError_t err = row_schedule::launch(
      MonoidFoldMasked{{(const float*)val, (const float*)x, FLT_MAX},
                       (const uint32_t*)words, (const float*)bound,
                       (const float*)t},
      (const int32_t*)ptr, (const int32_t*)ind, (float*)y,
      (const int32_t*)perm, (const int32_t*)chunk_beg,
      row_schedule::sched_of(meta), (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

const char* gb_monoid_pull_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
