// Masked intersection of sorted rows: the device walk of the masked SpGEMM
// and of triangle counting. For each mask edge e = (i, j), la is A's row i
// (A's CSR) and lb is B's list j (B's row j when B is taken transposed,
// else B's column j, from its CSC). Two entries share one walk:
//   T1 gb_masked_intersect_count: the sum over the mask of |la ∩ lb|, one
//      64-bit total (triangle counting: tc(L) over L, L, mask L, Lᵀ);
//   T2 gb_masked_intersect_fold:  c[e] = (+)_{k in la ∩ lb} A[i,k] (x) B[k,j]
//      for the catalogue's semirings whose (+) is plus, min, max or logical
//      or, in float32 or int32 (the masked mxm, and the trace over the
//      diagonal pairs (i, i));
//   T2 gb_masked_intersect_fold_ordered: the same c[e] for the semirings
//      whose (+) is multiplies, greater, less (CustomLess) or not-equal-to
//      (the masked mxm only), folded in the JAX join's exact order (below).
//
// Replaces no Pallas kernel: graphblast_tpu/ops/spgemm.py:159
// _masked_count_chunk and :70 _masked_join_chunk are plain jnp. There the
// mask is cut into host-planned chunks whose expansion (one lane per walked
// entry) fits the TPU's memory, and every chunk sorts its query keys
// together with B's keys and carries run heads with cummax. The GPU design
// they re-derive is GraphBLAST's warp-per-mask-row kernel, which binary-
// searches each row entry (kernels/spgemm.hpp:17-79).
//
// What bounds it on an H100: not the bytes (the inputs read once take
// microseconds) but the L1: a binary search makes dependent, divergent
// loads, and a walk by search alone ran at up to 5.4 probed 32-byte sectors
// a clock on every SM (PERF.md), while its hub edges, thousands of ids on
// one warp each, held a tail. So the design removes probes. Each launch
// reads an intersection schedule (ops/kernels/intersect_schedule.py),
// built once from the lengths alone, which gives every edge one of two
// routes and cuts the mask into work units, one block each:
//   - the bitmap route: all edges of a mask row share la, so the block
//     writes la once into a bitmap of n_ids bits in shared memory
//     (atomicOr, la read coalesced, 4 loads in flight a thread), and a
//     warp takes each of the row's bitmap edges: its lanes stream lb,
//     16-byte loads of 4 ids a lane where the list is aligned, two loads
//     in flight a lane, and test one bit an id; then the block clears the
//     words from la's first id to its last (stores, no loads). A lookup is
//     one shared-memory word in place of a search's ~log2(l) - 3 sectors,
//     and a hub edge streams 128 ids a round.
//   - the search route: one warp walks the SHORTER of la and lb (B's list
//     only when strictly shorter) and finds each key with a lower_bound in
//     the longer one, each lane's search starting where its last ended.
// The schedule takes, edge by edge, the route its cost formula calls
// cheaper, and every edge takes the search route where the bitmap (and T2's
// prefix counts) would exceed kSmemBudget, the shared memory a block may
// hold while two blocks fit an SM. A unit is a run of consecutive mask
// rows, or the piece of one row whose cost alone passes the unit target;
// each piece of a row stages la itself. Within a block, warps take the
// unit's search edges, then each bitmap piece's edges, from a counter in
// shared memory, up to 32 at a time, whose ends the lanes load together.
// T2's blocks have twice T1's warps, since its prefix counts double the
// shared memory a block holds. No expansion is stored and no workspace is
// needed.
//
// Both lists must be sorted with no duplicate ids (the JAX precondition,
// spgemm.py:381-382; ops/spgemm.py checks it once per Matrix).
//
// T1 counts each edge's matches in int32 lanes, adds them into 64-bit lane
// totals, and each block adds its sum to the total with one atomicAdd on an
// unsigned long long: integer sums do not depend on the order, so the total
// is exact and the same on every run.
//
// T2's fold order is fixed by the schedule, which a launch only reads:
// each lane folds its own matches in the order it walks them, starting at
// (+)'s neutral element (-inf or INT_MIN for max, +inf or INT_MAX for min,
// 0 for plus and or), then a butterfly of shuffles (offsets 16, 8, 4, 2, 1)
// combines the lanes. On the bitmap route lane l walks lb's ids before the
// first index of lb that is a multiple of 4 (lane l takes the l-th of
// them), then the ids at that index + 4l + 128r + q, r = 0, 1, ... and q =
// 0..3; A's position of a hit k is a0 + prefix[k >> 5] + popc(bits of
// word k >> 5 below k), prefix[w] being the count of la's ids in the
// words before w, written in the staging pass. So a launch is bitwise
// equal to any other on the same inputs and schedule. (x) always takes
// A's value first, whichever list is walked (the JAX package's swap_mul).
// The semiring's identity joins the fold where the JAX package's join
// brings it in: there each walked id with no partner adds one identity
// (spgemm.py:145-154), so for the masked mxm it joins where the lists
// share fewer ids than the shorter holds, or none; for the trace, which
// tests every id of A's row (spgemm.py:705-723), where A's row holds an id
// B's lacks. The rule reads the hit count and the two lengths only, so both
// routes keep it. This matters for min and max only, where the identity is
// not neutral: MaximumMonoid's is 0 (the reference's quirk), so a max of
// negative products is 0 exactly where a walked id missed.
// The ordered fold. Greater, less and not-equal-to are not associative,
// and float32 products round, so for these (+) the order of the JAX join
// is the result: its lanes of a mask edge are the ids of the list it
// expands (the shorter; B's only when strictly shorter), ascending, each
// the product where the other list holds the id, else (+)'s identity; a
// segmented Hillis-Steele scan (graphblast_tpu/ops/segops.py:35-62) folds
// them. Its bracketing depends only on a lane's offset from its edge's
// first lane: with M = L - 1 lanes after the first, the result is x_0
// (+) T_1 (+) T_2 ..., left to right, where T_1, T_2, ... are balanced
// trees (left (+) right) over consecutive runs of the lanes 1..L-1 whose
// sizes are the set bits of M, smallest first. Counted from the last lane
// back, those runs are aligned binary-counter blocks. So one warp a mask
// edge takes 32 lanes at a time from the end, folds each full 32 by a
// shuffle tree (a lane at the larger offset on the left), and lane 0
// keeps the finished trees on a stack, merging two of one size (the later
// one on the left) as a binary counter does; the lanes left over (M mod
// 32) go onto the stack one by one, and last x_0 folds the stack from its
// top. No schedule is read: the warps stride the mask. Every float32 value
// read and every result of (x) and (+) is flushed to a zero of its sign
// where it is subnormal, as the JAX package's XLA does on the CPU and the
// TPU (a long product of small values ends there at zero).
// Float products and sums round once (__fmul_rn, __fadd_rn, __fdiv_rn: no
// fused multiply-add); int32 arithmetic wraps, formed in uint32_t; min and
// max propagate NaN, as torch.minimum and torch.maximum do; logical ops
// give 1 or 0 in the value type.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (graphblast_tpu_torch/ops/kernels/_build.py)
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

// warps a block: T1's blocks hold the bitmap (32 KB at 2^18 ids), T2's
// the bitmap and the prefix counts (64 KB), so T2's are larger to keep as
// many warps on an SM
constexpr int kCountWarps = 8, kFoldWarps = 16;
constexpr unsigned kFull = 0xffffffffu;
// the bitmap (and T2's prefix counts) a block may hold in shared memory:
// two such blocks fit an SM's 227 KB (ops/kernels/intersect_schedule.py
// SMEM_BUDGET mirrors it)
constexpr int kSmemBudget = 112 * 1024;
// the kernels' own __shared__ arrays take less than this
constexpr size_t kStaticSmem = 1024;

// (+) and (x) codes; the wrapper passes the same numbers
constexpr int kAddPlus = 0, kAddMin = 1, kAddMax = 2, kAddLor = 3,
              kAddTimes = 4, kAddGreater = 5, kAddLess = 6,
              kAddNotEqual = 7;
// warps a block of the ordered fold
constexpr int kOrderedWarps = 8;
constexpr int kMulPlus = 0, kMulMinus = 1, kMulTimes = 2, kMulDiv = 3,
              kMulGreater = 4, kMulLess = 5, kMulNotEqual = 6,
              kMulSecond = 7, kMulLand = 8;

struct Operands {
  const int32_t* mi;      // mask row ids, one an edge
  const int32_t* mj;      // mask column ids
  const int32_t* a_ptr;   // A's CSR
  const int32_t* a_ind;
  const int32_t* b_ptr;   // B's rows (transposed) or columns (its CSC)
  const int32_t* b_ind;
};

// The intersection schedule, as ops/kernels/intersect_schedule.py lays it
// out: unit u (block u) takes the search edges search_edges[unit_search[u]
// .. unit_search[u + 1]) and the pieces unit_piece[u] .. unit_piece[u + 1]
// - 1; piece p is the bitmap edges bitmap_edges[piece_begin[p] ..
// piece_begin[p + 1]), all of one mask row.
struct Schedule {
  const int32_t* search_edges;
  const int32_t* unit_search;
  const int32_t* bitmap_edges;
  const int32_t* piece_begin;
  const int32_t* unit_piece;
  long long units;
  int words;              // bitmap words, n_ids / 32 rounded up; 0: no piece
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

// The search route of a mask edge by one lane of its warp, la =
// a_ind[a0, a1) and lb = b_ind[b0, b1): visit(a_pos, b_pos) for every id
// the two lists share that lies in this lane's share of the walked list
// (its entries lane, lane + 32, ...), in the order walked.
template <class Visit>
__device__ __forceinline__ void walk_edge(const Operands& o, int a0, int a1,
                                          int b0, int b1, int lane,
                                          Visit&& visit) {
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
}

// The bitmap route of lb = b_ind[b0, b1) by one lane of its warp, against
// the staged bitmap bm of la: hit(t, k, word) for every id k = b_ind[t]
// whose bit is set, in the lane's walk order (file header).
template <class Hit>
__device__ __forceinline__ void stream_list(const int32_t* __restrict__ b_ind,
                                            int b0, int b1, int lane,
                                            const unsigned* bm, Hit&& hit) {
  const auto test = [&](int t, int k) {
    const unsigned word = bm[k >> 5];
    if ((word >> (k & 31)) & 1u) hit(t, k, word);
  };
  const int body = min((b0 + 3) & ~3, b1);    // lb's first index 4 | t
  if (b0 + lane < body) test(b0 + lane, __ldg(b_ind + b0 + lane));
  const bool vec = (reinterpret_cast<uintptr_t>(b_ind) & 15) == 0;
  int t = body + 4 * lane;
  if (vec) {
    for (; t + 128 + 3 < b1; t += 256) {   // two loads in flight a lane
      const int4 k = __ldg(reinterpret_cast<const int4*>(b_ind + t));
      const int4 g = __ldg(reinterpret_cast<const int4*>(b_ind + t + 128));
      test(t, k.x);
      test(t + 1, k.y);
      test(t + 2, k.z);
      test(t + 3, k.w);
      test(t + 128, g.x);
      test(t + 129, g.y);
      test(t + 130, g.z);
      test(t + 131, g.w);
    }
  }
  for (; t < b1; t += 128) {
    if (vec && t + 3 < b1) {
      const int4 k = __ldg(reinterpret_cast<const int4*>(b_ind + t));
      test(t, k.x);
      test(t + 1, k.y);
      test(t + 2, k.z);
      test(t + 3, k.w);
    } else {
      for (int q = 0; q < 4 && t + q < b1; ++q)
        test(t + q, __ldg(b_ind + t + q));
    }
  }
}

// A warp's share of the edges list[k0, k1): it takes up to `chunk`
// consecutive entries at a time from the shared counter *next, its lanes
// load their edges' ends and lists' bounds together, then the warp works
// them one by one: work(e, a0, a1, b0, b1), la = a_ind[a0, a1) and lb =
// b_ind[b0, b1). la is the mask row `row`'s when it is not negative (a
// bitmap piece's), else the edge's own.
template <class Work>
__device__ __forceinline__ void deal_edges(const Operands& o,
                                           const int32_t* list, int k0,
                                           int k1, int chunk, int* next,
                                           int row, int lane, Work&& work) {
  for (;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(next, chunk);
    k = k0 + __shfl_sync(kFull, k, 0);
    if (k >= k1) break;
    const int n = min(chunk, k1 - k);
    int e = 0, i = row, a0 = 0, a1 = 0, b0 = 0, b1 = 0;
    if (lane < n) {
      e = __ldg(list + k + lane);
      const int j = __ldg(o.mj + e);
      if (row < 0) i = __ldg(o.mi + e);
      b0 = __ldg(o.b_ptr + j);
      b1 = __ldg(o.b_ptr + j + 1);
      a0 = __ldg(o.a_ptr + i);
      a1 = __ldg(o.a_ptr + i + 1);
    }
    for (int x = 0; x < n; ++x)
      work(__shfl_sync(kFull, e, x), __shfl_sync(kFull, a0, x),
           __shfl_sync(kFull, a1, x), __shfl_sync(kFull, b0, x),
           __shfl_sync(kFull, b1, x));
  }
}

// entries a warp takes at a time: up to a warp's lanes, fewer where the
// list would leave warps of the block idle
template <int kWarps>
__device__ __forceinline__ int chunk_of(int n) {
  return max(1, min(32, n / (2 * kWarps)));
}

// Block u's walk of its unit, kWarps warps. search(e, a0, a1, b0, b1) and
// bitmap(e, a0, a1, b0, b1) are a warp's work on one edge; bm is the
// dynamic shared memory (the bitmap, then T2's prefix counts when prefix is
// not null).
template <int kWarps, class Search, class Bitmap>
__device__ __forceinline__ void walk_unit(const Operands& o,
                                          const Schedule& s, unsigned* bm,
                                          int* prefix, Search&& search,
                                          Bitmap&& bitmap) {
  constexpr int kThreads = 32 * kWarps;
  constexpr int kUnroll = 4;   // ids of la a thread loads at once
  __shared__ int next[2];      // the warps' counters: search edges, a piece's
  __shared__ int span[2];      // the first and last word la set
  const int u = blockIdx.x, lane = threadIdx.x & 31;
  const int p0 = __ldg(s.unit_piece + u), p1 = __ldg(s.unit_piece + u + 1);
  const int s0 = __ldg(s.unit_search + u), s1 = __ldg(s.unit_search + u + 1);
  if (threadIdx.x == 0) next[0] = next[1] = 0;
  if (p0 < p1)
    for (int w = threadIdx.x; w < s.words; w += kThreads) bm[w] = 0u;
  __syncthreads();
  deal_edges(o, s.search_edges, s0, s1, chunk_of<kWarps>(s1 - s0), &next[0],
             -1, lane, search);
  for (int p = p0; p < p1; ++p) {
    const int q0 = __ldg(s.piece_begin + p), q1 = __ldg(s.piece_begin + p + 1);
    const int i = __ldg(o.mi + __ldg(s.bitmap_edges + q0));
    const int a0 = __ldg(o.a_ptr + i), a1 = __ldg(o.a_ptr + i + 1);
    // stage la: kUnroll loads in flight a thread, then their bits
    for (int t = a0 + threadIdx.x; t < a1; t += kUnroll * kThreads) {
      int k[kUnroll], before[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int tq = t + q * kThreads;
        k[q] = tq < a1 ? __ldg(o.a_ind + tq) : -1;
        before[q] = prefix && tq > a0 && tq < a1 ? __ldg(o.a_ind + tq - 1)
                                                 : -1;
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int tq = t + q * kThreads;
        if (k[q] < 0) break;
        atomicOr(bm + (k[q] >> 5), 1u << (k[q] & 31));
        if (tq == a0) span[0] = k[q] >> 5;
        if (tq == a1 - 1) span[1] = k[q] >> 5;
        // la's first id in its word: the ids of la before it
        if (prefix && (tq == a0 || (before[q] >> 5) != (k[q] >> 5)))
          prefix[k[q] >> 5] = tq - a0;
      }
    }
    __syncthreads();
    deal_edges(o, s.bitmap_edges, q0, q1, chunk_of<kWarps>(q1 - q0),
               &next[1], i, lane, bitmap);
    __syncthreads();
    // clear the words from la's first to its last: stores, no loads
    if (a0 < a1)
      for (int w = span[0] + threadIdx.x; w <= span[1]; w += kThreads)
        bm[w] = 0u;
    if (threadIdx.x == 0) next[1] = 0;
    __syncthreads();
  }
}

// ---- T1: the count ------------------------------------------------------

__global__ void __launch_bounds__(32 * kCountWarps)
count_kernel(Operands o, Schedule s, unsigned long long* __restrict__ total) {
  extern __shared__ unsigned bm[];
  __shared__ unsigned long long warp_sums[kCountWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned long long mine = 0;   // this lane's matches
  walk_unit<kCountWarps>(
      o, s, bm, nullptr,
      [&](int, int a0, int a1, int b0, int b1) {
        int c = 0;
        walk_edge(o, a0, a1, b0, b1, lane, [&](int, int) { ++c; });
        mine += (unsigned)c;
      },
      [&](int, int, int, int b0, int b1) {
        int c = 0;
        stream_list(o.b_ind, b0, b1, lane, bm,
                    [&](int, int, unsigned) { ++c; });
        mine += (unsigned)c;
      });
  for (int off = 16; off > 0; off >>= 1)
    mine += __shfl_xor_sync(kFull, mine, off);
  if (lane == 0) warp_sums[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < kCountWarps; ++w) sum += warp_sums[w];
    if (sum) atomicAdd(total, sum);
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
  if (kAdd == kAddTimes) return Arith<T>::times(a, b);
  if (kAdd == kAddGreater) return a > b ? T(1) : T(0);
  if (kAdd == kAddLess) return a < b ? T(1) : T(0);
  if (kAdd == kAddNotEqual) return a != b ? T(1) : T(0);
  return (a != T(0) || b != T(0)) ? T(1) : T(0);   // logical or
}

// (+)'s neutral element, where each lane's fold starts
template <class T, int kAdd>
__device__ __forceinline__ T neutral() {
  if (kAdd == kAddMin) return Arith<T>::top();
  if (kAdd == kAddMax) return Arith<T>::bottom();
  return T(0);
}

// when the semiring's identity joins an edge's fold (header): rule 0 the
// masked mxm's, 1 the trace's
constexpr int kRuleTrace = 1;

template <class T, int kAdd, int kMul>
__global__ void __launch_bounds__(32 * kFoldWarps)
fold_kernel(Operands o, Schedule s, const T* __restrict__ a_val,
            const T* __restrict__ b_val, T* __restrict__ c, T identity,
            int rule) {
  constexpr bool kMinMax = kAdd == kAddMin || kAdd == kAddMax;
  extern __shared__ unsigned bm[];
  int* prefix = reinterpret_cast<int*>(bm + s.words);
  const int lane = threadIdx.x & 31;
  // the lanes' folds of edge e, combined by the butterfly; lane 0 writes
  const auto finish = [&](int e, T acc, int hits, int la, int lb) {
    for (int off = 16; off > 0; off >>= 1) {
      acc = add_op<T, kAdd>(acc, __shfl_xor_sync(kFull, acc, off));
      if (kMinMax) hits += __shfl_xor_sync(kFull, hits, off);
    }
    if (lane != 0) return;
    if (kMinMax) {   // plus and or start at their identity, 0
      const bool miss = rule == kRuleTrace ? hits < la
                                           : hits < min(la, lb) || hits == 0;
      if (miss) acc = add_op<T, kAdd>(acc, identity);
    }
    c[e] = acc;
  };
  walk_unit<kFoldWarps>(
      o, s, bm, prefix,
      [&](int e, int a0, int a1, int b0, int b1) {
        T acc = neutral<T, kAdd>();
        int hits = 0;
        walk_edge(o, a0, a1, b0, b1, lane, [&](int a_pos, int b_pos) {
          ++hits;
          acc = add_op<T, kAdd>(acc, mul_op<T, kMul>(__ldg(a_val + a_pos),
                                                     __ldg(b_val + b_pos)));
        });
        finish(e, acc, hits, a1 - a0, b1 - b0);
      },
      [&](int e, int a0, int a1, int b0, int b1) {
        T acc = neutral<T, kAdd>();
        int hits = 0;
        stream_list(o.b_ind, b0, b1, lane, bm,
                    [&](int t, int k, unsigned word) {
                      const int a_pos = a0 + prefix[k >> 5] +
                                        __popc(word & ((1u << (k & 31)) - 1u));
                      ++hits;
                      acc = add_op<T, kAdd>(
                          acc, mul_op<T, kMul>(__ldg(a_val + a_pos),
                                               __ldg(b_val + t)));
                    });
        finish(e, acc, hits, a1 - a0, b1 - b0);
      });
}

// a subnormal float32 to a zero of its sign (the ordered fold's rule)
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < 1.17549435e-38f ? copysignf(0.0f, x) : x;
}
__device__ __forceinline__ int32_t flush(int32_t x) { return x; }

// The ordered fold (file header): one warp a mask edge, the warps striding
// the mask. Lane l of a round takes the lane L - 1 - (32 r + l) of the
// edge, counted from its last, so each lane's keys descend and its
// lower_bound can end where its last one began.
template <class T, int kAdd, int kMul>
__global__ void __launch_bounds__(32 * kOrderedWarps)
ordered_fold_kernel(Operands o, long long m, const T* __restrict__ a_val,
                    const T* __restrict__ b_val, T* __restrict__ c,
                    T identity) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kOrderedWarps;
  for (long long e = (long long)blockIdx.x * kOrderedWarps +
                     (threadIdx.x >> 5);
       e < m; e += warps) {
    const int i = __ldg(o.mi + e), j = __ldg(o.mj + e);
    const int a0 = __ldg(o.a_ptr + i), a1 = __ldg(o.a_ptr + i + 1);
    const int b0 = __ldg(o.b_ptr + j), b1 = __ldg(o.b_ptr + j + 1);
    const bool walk_a = !(b1 - b0 < a1 - a0);   // B only when strictly shorter
    const int32_t* w = walk_a ? o.a_ind : o.b_ind;
    const int32_t* s = walk_a ? o.b_ind : o.a_ind;
    const int w0 = walk_a ? a0 : b0, len = walk_a ? a1 - a0 : b1 - b0;
    const int s0 = walk_a ? b0 : a0;
    int hi = walk_a ? b1 : a1;   // this lane's keys descend
    // the value of the edge's lane t: the product where the other list
    // holds the walked id, else the identity
    const auto lane_value = [&](int t) {
      const int key = __ldg(w + w0 + t);
      const int p = lower_bound(s, s0, hi, key);
      hi = p + (p < hi && __ldg(s + p) == key);
      if (p >= hi || __ldg(s + p) != key) return identity;
      const int wp = w0 + t;
      const int ap = walk_a ? wp : p, bp = walk_a ? p : wp;
      return flush(mul_op<T, kMul>(flush(__ldg(a_val + ap)),
                                   flush(__ldg(b_val + bp))));
    };
    const auto add = [](T x, T y) { return flush(add_op<T, kAdd>(x, y)); };
    if (len == 0) {   // no lane: the identity, as an empty segment gives
      if (lane == 0) c[e] = identity;
      continue;
    }
    T stack[32];   // lane 0's finished trees, the latest on top
    int size[32], depth = 0;
    const auto push = [&](T v, int n) {
      stack[depth] = v;
      size[depth++] = n;
      while (depth > 1 && size[depth - 1] == size[depth - 2]) {
        stack[depth - 2] = add(stack[depth - 1], stack[depth - 2]);
        size[depth - 2] *= 2;
        --depth;
      }
    };
    const int rest = len - 1, full = rest >> 5;
    for (int r = 0; r < full; ++r) {
      T v = lane_value(len - 1 - (32 * r + lane));
      for (int d = 1; d < 32; d <<= 1) {
        const T other = __shfl_down_sync(kFull, v, d);
        if ((lane & (2 * d - 1)) == 0) v = add(other, v);
      }
      if (lane == 0) push(v, 32);
    }
    const int left = rest & 31;
    T v = identity;
    if (lane < left) v = lane_value(len - 1 - (32 * full + lane));
    for (int t = 0; t < left; ++t) {
      const T x = __shfl_sync(kFull, v, t);
      if (lane == 0) push(x, 1);
    }
    if (lane == 0) {
      T acc = lane_value(0);
      while (depth > 0) acc = add(acc, stack[--depth]);
      c[e] = acc;
    }
  }
}

template <class T, int kAdd, int kMul>
cudaError_t launch_ordered(const Operands& o, long long m, const void* a_val,
                           const void* b_val, void* c,
                           uint32_t identity_bits, cudaStream_t stream) {
  T identity;
  std::memcpy(&identity, &identity_bits, sizeof(T));
  const long long blocks = (m + kOrderedWarps - 1) / kOrderedWarps;
  const unsigned grid = (unsigned)(blocks < 132 * 64 ? blocks : 132 * 64);
  ordered_fold_kernel<T, kAdd, kMul><<<grid, 32 * kOrderedWarps, 0, stream>>>(
      o, m, (const T*)a_val, (const T*)b_val, (T*)c, identity);
  return cudaGetLastError();
}

// the catalogue's semirings whose (+) is multiplies, greater, less or
// not-equal-to
template <class T>
cudaError_t launch_ordered_pair(int add, int mul, const Operands& o,
                                long long m, const void* a_val,
                                const void* b_val, void* c, uint32_t bits,
                                cudaStream_t st) {
#define GB_PAIR(A, M)                                                     \
  if (add == A && mul == M)                                               \
    return launch_ordered<T, A, M>(o, m, a_val, b_val, c, bits, st);
  GB_PAIR(kAddGreater, kMulPlus)    // GreaterPlus
  GB_PAIR(kAddLess, kMulPlus)       // CustomLessPlus
  GB_PAIR(kAddLess, kMulLess)       // CustomLessLess
  GB_PAIR(kAddNotEqual, kMulPlus)   // NotEqualToPlus
  GB_PAIR(kAddTimes, kMulTimes)     // MultipliesMultiplies
#undef GB_PAIR
  return cudaErrorInvalidValue;
}

// The dynamic shared memory of a launch: the bitmap, and T2's prefix
// counts; none when the schedule has no bitmap piece. Opts in above 48 KB.
template <class Kernel>
cudaError_t shared_bytes(Kernel kernel, const Schedule& s, int per_word,
                         size_t* bytes) {
  *bytes = (size_t)s.words * per_word;
  if (*bytes > (size_t)kSmemBudget) return cudaErrorInvalidValue;
  if (*bytes + kStaticSmem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
  return cudaSuccess;
}

template <class T, int kAdd, int kMul>
cudaError_t launch_fold(const Operands& o, const Schedule& s,
                        const void* a_val, const void* b_val, void* c,
                        uint32_t identity_bits, int rule,
                        cudaStream_t stream) {
  T identity;
  std::memcpy(&identity, &identity_bits, sizeof(T));
  const auto kernel = fold_kernel<T, kAdd, kMul>;
  size_t bytes = 0;
  const cudaError_t err = shared_bytes(kernel, s, 8, &bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)s.units, 32 * kFoldWarps, bytes, stream>>>(
      o, s, (const T*)a_val, (const T*)b_val, (T*)c, identity, rule);
  return cudaGetLastError();
}

// the catalogue's semirings whose (+) is plus, min, max or logical or
template <class T>
cudaError_t launch_pair(int add, int mul, const Operands& o,
                        const Schedule& s, const void* a_val,
                        const void* b_val, void* c, uint32_t bits, int rule,
                        cudaStream_t st) {
#define GB_PAIR(A, M)                                                     \
  if (add == A && mul == M)                                               \
    return launch_fold<T, A, M>(o, s, a_val, b_val, c, bits, rule, st);
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
// sum over the mask edges of |la ∩ lb| to it, walking the schedule *s (a
// host struct, copied into the launch). Returns the first error (0 on
// success). The caller passes a schedule of at least one unit, built for
// these operands, and ids within the pointers and below 32 * s->words.
int gb_masked_intersect_count(const void* mi, const void* mj,
                              const void* a_ptr, const void* a_ind,
                              const void* b_ptr, const void* b_ind,
                              const void* sched, void* total, void* stream) {
  const Operands o{(const int32_t*)mi, (const int32_t*)mj,
                   (const int32_t*)a_ptr, (const int32_t*)a_ind,
                   (const int32_t*)b_ptr, (const int32_t*)b_ind};
  const Schedule s = *(const Schedule*)sched;
  const cudaStream_t st = (cudaStream_t)stream;
  size_t bytes = 0;
  cudaError_t err = shared_bytes(count_kernel, s, 4, &bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(total, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  count_kernel<<<(unsigned)s.units, 32 * kCountWarps, bytes, st>>>(
      o, s, (unsigned long long*)total);
  return (int)cudaGetLastError();
}

// T2. Writes c[e] for the mask edges, walking the schedule *s (as T1).
// add: 0 plus, 1 min, 2 max, 3 logical or; mul: 0 plus, 1 minus, 2
// multiplies, 3 divides, 4 greater, 5 less, 6 not-equal-to, 7
// select-second, 8 logical and; is_float: a_val, b_val and c are float32,
// else int32. identity_bits is the semiring's identity as the 32 bits of
// the value type. Returns the launch's error (0 on success), or
// cudaErrorInvalidValue for a pair with no instantiation. rule: 0 the
// masked mxm's (the identity joins where the lists share fewer ids than
// the shorter holds, or none), 1 the trace's (where la holds an id lb
// lacks).
int gb_masked_intersect_fold(const void* mi, const void* mj,
                             const void* a_ptr, const void* a_ind,
                             const void* a_val, const void* b_ptr,
                             const void* b_ind, const void* b_val,
                             const void* sched, void* c, int add, int mul,
                             int is_float, unsigned int identity_bits,
                             int rule, void* stream) {
  const Operands o{(const int32_t*)mi, (const int32_t*)mj,
                   (const int32_t*)a_ptr, (const int32_t*)a_ind,
                   (const int32_t*)b_ptr, (const int32_t*)b_ind};
  const Schedule s = *(const Schedule*)sched;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_float) {
    if (add == kAddPlus && mul == kMulDiv)   // PlusDivides, float32 only
      return (int)launch_fold<float, kAddPlus, kMulDiv>(
          o, s, a_val, b_val, c, identity_bits, rule, st);
    return (int)launch_pair<float>(add, mul, o, s, a_val, b_val, c,
                                   identity_bits, rule, st);
  }
  return (int)launch_pair<int32_t>(add, mul, o, s, a_val, b_val, c,
                                   identity_bits, rule, st);
}

// T2's ordered fold. Writes c[e] for the m mask edges. add: 4 multiplies,
// 5 greater, 6 less, 7 not-equal-to; mul and is_float as above. Returns
// the launch's error (0 on success), or cudaErrorInvalidValue for a pair
// with no instantiation. The caller passes m > 0.
int gb_masked_intersect_fold_ordered(const void* mi, const void* mj,
                                     const void* a_ptr, const void* a_ind,
                                     const void* a_val, const void* b_ptr,
                                     const void* b_ind, const void* b_val,
                                     long long m, void* c, int add, int mul,
                                     int is_float, unsigned int identity_bits,
                                     void* stream) {
  const Operands o{(const int32_t*)mi, (const int32_t*)mj,
                   (const int32_t*)a_ptr, (const int32_t*)a_ind,
                   (const int32_t*)b_ptr, (const int32_t*)b_ind};
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_float)
    return (int)launch_ordered_pair<float>(add, mul, o, m, a_val, b_val, c,
                                           identity_bits, st);
  return (int)launch_ordered_pair<int32_t>(add, mul, o, m, a_val, b_val, c,
                                           identity_bits, st);
}

const char* gb_masked_intersect_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
