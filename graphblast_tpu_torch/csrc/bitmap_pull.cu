// Bitmap pull (K1): y[i] = number of edges (i, j) of the pull orientation
// whose bit j is set in a 32x-packed frontier bitmap. (y > 0) is the
// structure-only LogicalOrAnd pull that BFS runs each iteration.
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
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (graphblast_tpu_torch/ops/kernels/_build.py)
#include <cstdint>
#include <cuda_runtime.h>

#include "row_schedule.cuh"

namespace {

// the schedule's policy: an int32 count of the edges whose bit is set
struct BitCount {
  using Acc = int32_t;
  using Item = int32_t;   // edge e's bit, 0 or 1
  const uint32_t* __restrict__ words;

  __device__ __forceinline__ int32_t identity() const { return 0; }
  __device__ __forceinline__ int32_t fetch(int j, long long) const {
    const uint32_t c = (uint32_t)j;
    return (int32_t)((__ldg(words + (c >> 5)) >> (c & 31u)) & 1u);
  }
  __device__ __forceinline__ int32_t add(int32_t acc, int32_t bit) const {
    return acc + bit;
  }
  static __device__ __forceinline__ int32_t combine(int32_t a, int32_t b) {
    return a + b;
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

const char* gb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
