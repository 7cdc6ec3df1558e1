// Segment sums in a fixed order, for Hopper (sm_90a): out[s, c] = the sum
// of x[m, c] over the rows m with idx[m] == s, added in ascending m.
//
// Not a port of a TPU kernel. The JAX package forms these sums as one-hot
// matrix products (putslam_tpu/backend/optimize.py: Pf, Qf and P_full
// built once per solve, and Pb / Qb in schur_subtrahend_mm), whose order
// XLA fixes, so a JAX run repeats itself bit for bit. torch's index_add_
// on the card sums with atomics, in an order that changes from run to run;
// this kernel takes its place on every floating-point segment sum of the
// port's solvers (putslam_tpu_torch/ops/segment.py).
//
// The plan (ops/segment.py::SegmentPlan) is built once per solve: `perm`,
// the stable sort of idx, `keys`, the sorted idx, and `offsets`, where
// segment s holds the sorted positions [offsets[s], offsets[s + 1]). The
// stable sort keeps the rows of a segment in ascending m, which is the
// order of index_add_ on the CPU: the kernel equals that plain version bit
// for bit (plain float32 adds, round to nearest, one chain a (segment,
// column) starting from 0.0f as the plain version's zeroed buffer does).
//
// The design. A block of 256 threads takes `per_block` consecutive
// segments, a number fixed by n alone (about kBlocks blocks a launch), so
// the grid depends on static shapes only and the launch can be recorded
// into a CUDA graph, inside a conditional node's body too. The rows of
// those segments are one contiguous run of sorted positions. The block
//  1. copies its segments' offsets to shared memory (cp.async);
//  2. in its second half (warps of their own), writes zeros for its
//     empty segments, 16 bytes a store where four floats in a row are all
//     empty; no sum is written twice, so no barrier orders them. Apart,
//     because a warp issues in order: zeros stored ahead of the loads would
//     hold those back until the SM had drained them, and G's zeros are
//     most of the bytes;
//  3. in its first half, stages a chunk of the run's perm and keys (128
//     to 512 rows) with cp.async, every copy in flight at once;
//  4. gathers all the chunk's rows into shared memory with cp.async, all
//     in flight at once,
//  5. and meanwhile lists the segments that start in the chunk (first
//     row, end, key, and whether the chunk before holds its first rows);
//  6. adds with a thread a (segment, column): the segment's rows in
//     ascending order, eight at a time with no test a row (its end comes
//     from the offsets), from 0.0f or from the sum carried over from the
//     previous chunk; at the segment's end the sum is written, before it
//     is carried into the next chunk.
// So the loads are off the chain of dependent adds: a block waits for
// three round trips to memory (offsets, plan, rows) and two more a chunk
// of 512 rows; each perm and offsets entry is read once, not once a
// column; and the short segments of a block are added side by side. The
// chunk is as large as lets the blocks of one wave share the SMs' shared
// memory.
//
// What bounds it on the card: the bytes of the zeros of the coupling G
// (K x L blocks of 6x3, 37.7 MB at fr1, nearly all empty); the longest
// segment's chain (a keyframe's observations, ~330 rows on a
// keyframe-dense map: three round trips, then its adds); for the many
// short sums, the launch and the three round trips.
//
// Thread 0 of each launch adds one to the launch counter on the card
// (launch_counter.cuh).
//
// Plain C entry points, bound with ctypes; each returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_counter.cuh"

namespace {

constexpr int kSumThreads = 128;         // the warps that add
constexpr int kZeroThreads = 128;        // the warps that write zeros
constexpr int kThreads = kSumThreads + kZeroThreads;   // a block
constexpr int kColsMax = kSumThreads;    // columns at most
constexpr int kChunkMax = 512;           // rows a chunk at most
constexpr int kBlocks = 512;             // blocks a launch, about
constexpr int kPerBlockMax = 4096;       // segments a block at most
constexpr int kSmemMax = 227 * 1024;     // dynamic shared memory a block
constexpr int kSmemSm = 228 * 1024;      // shared memory of an SM

// an asynchronous copy of kBytes (4, 8 or 16) from global to shared memory
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(kBytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// a barrier of the warps that add alone (named barrier 1)
__device__ __forceinline__ void sync_adders() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kSumThreads) : "memory");
}

// Shared memory of a block: the offsets of its segments (per_block + 1,
// int) and a count, then a chunk's perm (chunk, long long), keys (chunk,
// int), the segments that start in it (chunk, int4), the two carried sums
// (2 x cols, float) and the chunk's rows (chunk x cols, float).
__host__ __device__ __forceinline__ int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}
struct Layout {
  int perm, keys, starts, carry, rows, bytes;
  __host__ __device__ Layout(int per_block, int chunk, int cols) {
    perm = align16(4 * (per_block + 2));
    keys = perm + 8 * chunk;
    starts = align16(keys + 4 * chunk);
    carry = starts + 16 * chunk;
    rows = align16(carry + 4 * 2 * cols);
    bytes = rows + 4 * chunk * cols;
  }
};

// kVec: floats a copy (rows are gathered kVec floats at a time)
template <int kVec>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ x,
                   const long long* __restrict__ perm,
                   const int* __restrict__ keys,
                   const int* __restrict__ offsets, float* __restrict__ out,
                   int n, int cols, int per_block, int chunk,
                   unsigned long long* counter) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(per_block, chunk, cols);
  int* soff = reinterpret_cast<int*>(smem);
  long long* sperm = reinterpret_cast<long long*>(smem + lay.perm);
  int* skey = reinterpret_cast<int*>(smem + lay.keys);
  float* sx = reinterpret_cast<float*>(smem + lay.rows);
  const int t = threadIdx.x;
  if (blockIdx.x == 0 && t == 0) atomicAdd(counter, 1ULL);
  const int s0 = blockIdx.x * per_block;
  const int ns = min(n, s0 + per_block) - s0;   // the block's segments

  // 1. the offsets of the block's segments
  for (int i = t; i <= ns; i += kThreads)
    cp_async<4>(soff + i, offsets + s0 + i);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // 2. the second half of the block: zeros for the empty segments, 16
  // bytes a store where four floats in a row are all of empty segments
  // (offsets do not decrease); the other sums are written by the adds.
  // Warps of their own, so that the adds' loads never wait behind them
  // (a warp issues in order; G's zeros are most of the bytes)
  if (t >= kSumThreads) {
    const int z = t - kSumThreads;
    float* o = out + (long long)s0 * cols;
    const int len = ns * cols;
    auto empty = [&](int first, int last) {    // elements first..last
      return soff[last / cols + 1] == soff[first / cols];
    };
    const int head = min(len, (int)(((16 - (reinterpret_cast<uintptr_t>(o)
                                             & 15)) & 15) / 4));
    const int quads = (len - head) / 4;
    for (int i = z; i < head; i += kZeroThreads)
      if (empty(i, i)) o[i] = 0.0f;
    for (int q = z; q < quads; q += kZeroThreads) {
      const int e = head + 4 * q;
      if (empty(e, e + 3)) {
        *reinterpret_cast<float4*>(o + e) = make_float4(0.0f, 0.0f, 0.0f,
                                                        0.0f);
      } else {
        for (int i = e; i < e + 4; ++i)
          if (empty(i, i)) o[i] = 0.0f;
      }
    }
    for (int i = head + 4 * quads + z; i < len; i += kZeroThreads)
      if (empty(i, i)) o[i] = 0.0f;
    return;
  }

  const int j0 = soff[0], j1 = soff[ns];

  // 3. the first half: a chunk's perm and keys, all copies in flight
  auto stage = [&](int c0) {
    const int cnt = min(chunk, j1 - c0);
    for (int i = t; i < cnt; i += kSumThreads) {
      cp_async<8>(sperm + i, perm + c0 + i);
      cp_async<4>(skey + i, keys + c0 + i);
    }
    cp_async_commit();
  };
  if (j0 < j1) stage(j0);

  const int vecs = cols / kVec;          // copies a row
  const int row_step = kSumThreads / vecs;   // rows gathered at once
  const int seg_step = kSumThreads / cols;   // segments added at once
  int* nstarts = soff + per_block + 1;
  int4* starts = reinterpret_cast<int4*>(smem + lay.starts);
  float* carry = reinterpret_cast<float*>(smem + lay.carry);
  for (int c0 = j0, pass = 0; c0 < j1; c0 += chunk, pass ^= 1) {
    const int cnt = min(chunk, j1 - c0);
    if (c0 != j0) stage(c0);
    if (t == 0) *nstarts = 0;
    cp_async_wait_all();
    sync_adders();
    // 4. the chunk's rows, every copy in flight at once: a thread a
    // piece of a row (kVec floats), rows in steps of kSumThreads / vecs
    if (t < row_step * vecs)
      for (int r = t / vecs; r < cnt; r += row_step)
        cp_async<4 * kVec>(sx + r * cols + t % vecs * kVec,
                           x + sperm[r] * cols + t % vecs * kVec);
    cp_async_commit();
    // 5. meanwhile the segments that start in the chunk, in any order
    // (each is added by one thread a column): the first row, the end in
    // the chunk's rows, the key, and whether it goes on from the chunk
    // before
    for (int r = t; r < cnt; r += kSumThreads)
      if (r == 0 || skey[r] != skey[r - 1]) {
        const int key = skey[r];
        starts[atomicAdd(nstarts, 1)] = make_int4(
            r, soff[key - s0 + 1] - c0, key,
            r == 0 && soff[key - s0] < c0);
      }
    cp_async_wait_all();
    sync_adders();
    // 6. a thread a (segment, column): its rows in ascending order, eight
    // at a time with no test a row, from 0.0f or from the sum carried over
    // from the previous chunk; at the segment's end the sum is written,
    // before it is carried into the next chunk. Threads t and t + cols
    // take the same column of other segments.
    const float* carry_in = carry + pass * cols;
    float* carry_out = carry + (pass ^ 1) * cols;
    if (t < seg_step * cols) {
      const int c = t % cols;
      for (int si = t / cols; si < *nstarts; si += seg_step) {
        const int4 seg = starts[si];             // first row, end, key, on
        const int stop = min(seg.y, cnt);
        float a = seg.w ? carry_in[c] : 0.0f;
        const float* q = sx + seg.x * cols + c;
        int r = seg.x;
#pragma unroll 2
        for (; r + 8 <= stop; r += 8, q += 8 * cols) {
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = q[i * cols];
#pragma unroll
          for (int i = 0; i < 8; ++i) a = __fadd_rn(a, v[i]);
        }
        const int m = stop - r;                  // fewer than 8
        float v[7];
#pragma unroll
        for (int i = 0; i < 7; ++i) v[i] = i < m ? q[i * cols] : 0.0f;
#pragma unroll
        for (int i = 0; i < 7; ++i)
          if (i < m) a = __fadd_rn(a, v[i]);
        if (stop == seg.y)
          out[(long long)seg.z * cols + c] = a;
        else
          carry_out[c] = a;
      }
    }
    sync_adders();                       // the chunk's buffers are free
  }
}

template <int kVec>
cudaError_t load_kernel() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, segment_sum_kernel<kVec>);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(segment_sum_kernel<kVec>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemMax);
}

int sm_count = 0;

}  // namespace

extern "C" {

// Loads the kernels, lets them use the shared memory a block can have and
// finds the counters on the current device (lazy module loading would load
// them at their first launch, which may lie inside a capture, where loading
// is not permitted).
int segment_sum_load() {
  cudaError_t err = load_kernel<1>();
  if (err == cudaSuccess) err = load_kernel<2>();
  if (err == cudaSuccess) err = load_kernel<4>();
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err != cudaSuccess) return err;
  return find_launch_counters();
}

// x (rows, cols) float32, perm (rows,) int64, keys (rows,) int32 sorted,
// offsets (n + 1 or more,) int32, out (n, cols) float32, all contiguous on
// the current device; 0 < cols <= segment_sum_max_cols(). The grid and the
// shared memory follow from n and cols alone: about kBlocks blocks, and a
// chunk of 128 to 512 rows, as large as lets the blocks of one wave share
// the SMs.
int segment_sum_launch(const float* x, const long long* perm, const int* keys,
                       const int* offsets, float* out, int n, int cols,
                       int counted, cudaStream_t stream) {
  if (n <= 0 || cols <= 0) return cudaSuccess;
  if (cols > kColsMax) return cudaErrorInvalidValue;
  if (!launch_counters_found()) return cudaErrorInitializationError;
  int per_block = (n + kBlocks - 1) / kBlocks;
  if (per_block > kPerBlockMax) per_block = kPerBlockMax;
  const int blocks = (n + per_block - 1) / per_block;
  const int per_sm = (blocks + sm_count - 1) / sm_count;
  int chunk = kChunkMax;
  while (chunk > kThreads &&
         (Layout(per_block, chunk, cols).bytes > kSmemMax ||
          per_sm * (Layout(per_block, chunk, cols).bytes + 1024) > kSmemSm))
    chunk -= kThreads;
  const Layout lay(per_block, chunk, cols);
  if (lay.bytes > kSmemMax) return cudaErrorInvalidValue;
  const uintptr_t at = reinterpret_cast<uintptr_t>(x);
  unsigned long long* counter = launch_counter(counted);
  if (cols % 4 == 0 && at % 16 == 0)
    segment_sum_kernel<4><<<blocks, kThreads, lay.bytes, stream>>>(
        x, perm, keys, offsets, out, n, cols, per_block, chunk, counter);
  else if (cols % 2 == 0 && at % 8 == 0)
    segment_sum_kernel<2><<<blocks, kThreads, lay.bytes, stream>>>(
        x, perm, keys, offsets, out, n, cols, per_block, chunk, counter);
  else
    segment_sum_kernel<1><<<blocks, kThreads, lay.bytes, stream>>>(
        x, perm, keys, offsets, out, n, cols, per_block, chunk, counter);
  return cudaGetLastError();
}

int segment_sum_max_cols() { return kColsMax; }

}  // extern "C"

LAUNCH_COUNTER_ENTRY_POINTS(segment_sum)
