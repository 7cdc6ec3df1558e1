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
// the stable sort of idx, and `offsets`, where segment s holds the sorted
// positions [offsets[s], offsets[s + 1]). The stable sort keeps the rows of
// a segment in ascending m, which is the order of index_add_ on the CPU: the
// kernel equals that plain version bit for bit (plain float32 adds, round to
// nearest, starting from 0.0f as the plain version's zeroed buffer does).
//
// One thread a (segment, column), the column fastest, so that a warp reads
// whole rows of x (a row of a 6x6 block is 144 contiguous bytes). Each
// thread issues the loads of eight rows together, then adds them in order,
// which keeps loads in flight while the adds stay sequential. What bounds
// it on the card: the bytes of the many short and empty segments (the
// landmark sums; the coupling G, whose 256 x 2048 blocks at fr1 make most
// of the output), the chain of dependent loads and adds of the long
// keyframe segments (~128 rows at fr1). Rows of zero weight (empty store
// slots, stale edges) are sent to the dropped segment by the solvers, so
// no segment is longer than the live observations of one keyframe.
//
// Thread 0 of each launch adds one to a device counter: a launch recorded
// into a CUDA graph, inside a conditional node's body, runs only where the
// card takes the branch, and only the card can count it. A launch counts
// into launches_counted, or, with counted == 0 (the warm-up before a
// capture), into a second counter that nothing reads.
//
// Plain C entry points, bound with ctypes; each returns a cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;     // rows whose loads are in flight together

__device__ unsigned long long launches_counted;
__device__ unsigned long long launches_uncounted;

__global__ void segment_sum_kernel(const float* __restrict__ x,
                                   const long long* __restrict__ perm,
                                   const long long* __restrict__ offsets,
                                   float* __restrict__ out, long long n_out,
                                   int cols, unsigned long long* counter) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t == 0) atomicAdd(counter, 1ULL);
  if (t >= n_out) return;
  const long long s = t / cols;
  const int c = (int)(t - s * cols);
  const long long end = offsets[s + 1];
  float acc = 0.0f;
  for (long long j = offsets[s]; j < end; j += kAhead) {
    const int n = end - j < kAhead ? (int)(end - j) : kAhead;
    float v[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      v[k] = k < n ? x[perm[j + k] * cols + c] : 0.0f;
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (k < n) acc = __fadd_rn(acc, v[k]);
  }
  out[t] = acc;
}

unsigned long long* counters[2] = {nullptr, nullptr};

}  // namespace

extern "C" {

// Loads the kernel and finds the counters on the current device (lazy
// module loading would load it at its first launch, which may lie inside
// a capture, where loading is not permitted).
int segment_sum_load() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, segment_sum_kernel);
  if (err != cudaSuccess) return err;
  err = cudaGetSymbolAddress((void**)&counters[0], launches_uncounted);
  if (err != cudaSuccess) return err;
  return cudaGetSymbolAddress((void**)&counters[1], launches_counted);
}

// x (rows, cols) float32, perm (rows,) int64, offsets (n + 1 or more,)
// int64, out (n, cols) float32, all contiguous on the current device;
// n_out = n * cols.
int segment_sum_launch(const float* x, const long long* perm,
                       const long long* offsets, float* out, long long n_out,
                       int cols, int counted, cudaStream_t stream) {
  if (n_out <= 0) return cudaSuccess;
  if (counters[0] == nullptr) return cudaErrorInitializationError;
  const long long blocks = (n_out + kThreads - 1) / kThreads;
  segment_sum_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, perm, offsets, out, n_out, cols, counters[counted ? 1 : 0]);
  return cudaGetLastError();
}

// The counted launches since the last reset (synchronises the device).
int segment_sum_read_launches(unsigned long long* value) {
  return cudaMemcpyFromSymbol(value, launches_counted, sizeof(*value));
}

int segment_sum_reset_launches() {
  const unsigned long long zero = 0;
  return cudaMemcpyToSymbol(launches_counted, &zero, sizeof(zero));
}

const char* segment_sum_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
