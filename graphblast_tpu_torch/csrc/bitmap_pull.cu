// Bitmap pull (K1): y[i] = number of edges (i, j) of the pull orientation
// whose bit j is set in a 32x-packed frontier bitmap. (y > 0) is the
// structure-only LogicalOrAnd pull that BFS runs each iteration. Its
// masked entry gives that pull under a float32 mask directly: y[i] = 1
// where the mask passes at i and some edge (i, j) has bit j set, else 0.
//
// Replaces graphblast_tpu/ops/pallas/bilinear.py:_bitmap_chunk_body (run by
// _kernel_bitmap_prefetch / _kernel_bitmap_dma through spmv_bilinear_bitmap).
// That kernel tiles the edges into 4096-row panels and 131072-column
// windows and scatters the counts with an int8 one-hot matmul, all to fit
// the TPU's VMEM and matrix unit. Here the plan is the pull orientation's
// CSR read through the row schedule that the value pull uses
// (row_schedule.cuh, the orientation's cached RowSchedule, which BFS,
// PageRank and SSSP share over the CSC): short rows 4-32 lanes each,
// medium rows a warp each, rows of more than 8192 edges an 8-block cluster
// each. Each edge tests bit j with a read of the bitmap through the
// read-only cache; integer counts are exact in any order. Every row is
// written, rows with no edges (0) included.
//
// Bound on an H100 SXM: the work is memory-bound. Each call must read
// ptr (n_out+1) and ind (nnz) once, the bitmap (ceil(n_in/32) words) and
// write y (n_out): 4*(nnz + 2*n_out + ceil(n_in/32)) bytes, 32.6 MB at RMAT
// scale 18 (nnz 7,610,284, n 262,144), i.e. 9.7 us at 3.35 TB/s. The
// bitmap is 32 KB there and stays in L1, so its random reads cost less
// than the value pull's reads of x; the edge stream is read once with
// neighbouring lanes on neighbouring addresses. The first design, one warp
// a row, took 6.5x the bound (PERF.md).
//
// The masked entry (gb_bitmap_pull_masked) is the reference GPU's
// spmvDenseMaskedOrKernel<scmp, earlyexit> (graphblas/backend/cuda/kernels/
// spmv.hpp:10-59, a thread a row scanning to its first hit) on the walk:
// every row reads its mask entry first, and a row the mask closes (BFS's
// visited rows, under the complemented visited mask) costs that 4 B, its
// 4 B of perm and its 4 B of y, with no read of ptr, ind or the bitmap: a
// warp reads up to 32 rows' entries at once and folds only the open ones
// (row_schedule.cuh open_rows). An open row stops at its first frontier
// id, to the grain of the walk: a medium row's warp after the 32-edge step
// that finds one, a row of 9 to 32 edges after its 8-id sub-step, a long
// row's block after its 256-edge step; a row of at most 8 edges reads them
// at once. Its bound is the least bytes of a masked or-pull
// (gbench/roofline.py orpull_least_bytes): 4 B an id of each open row up
// to its first frontier id, 4 B a bounding row pointer, and n/8 B for each
// of the frontier's, the mask's and y's bitmaps; a BFS pull at Kronecker
// scale 25 reads a few per cent of the 1.05 G ids that the count reads.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (graphblast_tpu_torch/ops/kernels/_build.py)
#include <cstdint>
#include <cuda_runtime.h>

#include "row_schedule.cuh"

namespace {

// bit j of the packed frontier, 0 or 1, read through the read-only cache
__device__ __forceinline__ int32_t frontier_bit(
    const uint32_t* __restrict__ words, int j) {
  const uint32_t c = (uint32_t)j;
  return (int32_t)((__ldg(words + (c >> 5)) >> (c & 31u)) & 1u);
}

// the schedule's policy: an int32 count of the edges whose bit is set
struct BitCount {
  using Acc = int32_t;
  using Item = int32_t;   // edge e's bit, 0 or 1
  const uint32_t* __restrict__ words;

  __device__ __forceinline__ int32_t identity() const { return 0; }
  __device__ __forceinline__ int32_t fetch(int j, long long) const {
    return frontier_bit(words, j);
  }
  __device__ __forceinline__ int32_t add(int32_t acc, int32_t bit) const {
    return acc + bit;
  }
  static __device__ __forceinline__ int32_t combine(int32_t a, int32_t b) {
    return a + b;
  }
};

// the masked entry's policy: 1 where the mask passes at the row and some
// edge's bit is set, else 0, stopping a row once that is known
struct BitCountMasked {
  using Acc = int32_t;
  using Item = int32_t;   // edge e's bit, 0 or 1
  const uint32_t* __restrict__ words;
  const float* __restrict__ mask;
  bool scmp;   // the mask passes where it is 0 (complemented), else not 0

  __device__ __forceinline__ int32_t identity() const { return 0; }
  __device__ __forceinline__ int32_t fetch(int j, long long) const {
    return frontier_bit(words, j);
  }
  __device__ __forceinline__ int32_t add(int32_t acc, int32_t bit) const {
    return acc | bit;
  }
  static __device__ __forceinline__ int32_t combine(int32_t a, int32_t b) {
    return a | b;
  }
  __device__ __forceinline__ bool row_open(int row) const {
    return (__ldg(mask + row) != 0.0f) != scmp;
  }
  __device__ __forceinline__ bool saturated(int32_t acc) const {
    return acc != 0;
  }
};

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's error (0 on success). perm,
// chunk_beg and `meta` (a host array of 2 * 7 ints) are the row schedule's,
// as gb_value_pull takes them. The caller allocates y and never passes a
// schedule with no block.
int gb_bitmap_pull(const void* ptr, const void* ind, const void* words,
                   void* y, const void* perm, const void* chunk_beg,
                   const int* meta, void* stream) {
  const cudaError_t err = row_schedule::launch(
      BitCount{(const uint32_t*)words}, (const int32_t*)ptr,
      (const int32_t*)ind, (int32_t*)y, (const int32_t*)perm,
      (const int32_t*)chunk_beg, row_schedule::sched_of(meta),
      (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The masked entry: as gb_bitmap_pull, with `mask` a float32 array of
// n_out entries that passes where it is not 0, or, with scmp, where it is
// 0; y is 0 or 1.
int gb_bitmap_pull_masked(const void* ptr, const void* ind, const void* words,
                          const void* mask, int scmp, void* y,
                          const void* perm, const void* chunk_beg,
                          const int* meta, void* stream) {
  const cudaError_t err = row_schedule::launch(
      BitCountMasked{(const uint32_t*)words, (const float*)mask, scmp != 0},
      (const int32_t*)ptr, (const int32_t*)ind, (int32_t*)y,
      (const int32_t*)perm, (const int32_t*)chunk_beg,
      row_schedule::sched_of(meta), (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

const char* gb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
