// RANSAC's weighted refit for Hopper (sm_90a): the closed-form Horn /
// Kabsch solve of putslam_tpu_torch/ops/kabsch.py::weighted_kabsch in ONE
// launch a call, from the point sets to the (..., 7) poses [tx, ty, tz, qw,
// qx, qy, qz].
//
// Not a port of a TPU kernel: there is no Pallas kernel here. The JAX
// package writes the solve structure-of-arrays (putslam_tpu/ops/kabsch.py:
// kabsch_soa, weighted_kabsch, _horn_quat_soa) so that XLA fuses it, and
// "thousands of hypotheses solve in a single fused pass". Run op by op in
// PyTorch it was ~500 elementwise launches a solve (5 symmetric squarings
// of 10 entries, the set-up and the tail), 3 solves a RANSAC call, ~3,000
// launches of a replayed SLAM frame: this kernel is the counterpart of
// that fusion for the refit; the sampled fit of the hypotheses runs inside
// csrc/ransac_score.cu (horn_fit.cuh::sampled_fit), on samples that kernel
// gathers itself.
//
// p, q (B, N, 3), w (B, N): one block of nine warps a batch row (staged in
// shared memory up to kStaged points), a warp a sum, in three passes:
// sum(w) (warp 0); the six weighted means (warps 0-5); the nine sums of
// S = sum wn (p - p_bar) (q - q_bar)^T (warps 0-8). A warp runs its sum's
// independent chains of ATen's order on its lanes (warp_row_sum,
// warp_inner_sum). Then thread 0 runs Horn and the tail.
//
// The arithmetic (Horn, the sums, the helpers) is in horn_fit.cuh. Bit for
// bit equal to the plain version (ops/kabsch.py::plain_weighted_kabsch),
// which writes out the arithmetic the port did on the CPU before this
// kernel: the sums in the order of ATen's CPU float sums (row_sum: four
// accumulators over rows of four elements through a cascade of partial
// sums; inner_sum: vectors of kLanes through row_sum, then the leftover
// elements and the lanes in turn), every norm as the squares added in turn
// and a correctly rounded square root, the cross products as the CPU's FMA
// (fma_cpu: the exact product in double, the sum, then float). Every other
// operation is a round-to-nearest intrinsic in the plain version's order,
// compiled with -fmad=false, so no multiply and add are contracted into an
// FMA. The plain version's scalar constants are Python floats that PyTorch
// casts to float, as the (float) casts of double literals in horn_fit.cuh
// do; its torch.maximum and clamp propagate a NaN, as maximum and clamp_min
// do.
//
// What bounds it: not bytes (~14 KB a refit at N = 512: tens of
// nanoseconds at 3.35 TB/s) and not operations (~700 a row, ~10 ns of the
// card's float32 rate), but chains of dependent operations and the launch
// itself. A warp a sum cuts a sum's chain of dependent adds from N terms to
// N / 32 and the merges (at N = 512: 16 adds, then 4 + 3 + 8), so what is
// left is the staging load, three block barriers and Horn's chain of ~600
// dependent operations on one thread.
//
// Thread 0 of each launch adds one to the launch counter on the card
// (launch_counter.cuh).
//
// Plain C entry points, bound with ctypes; each returns a cudaError_t.

#include <cuda_runtime.h>

#include "horn_fit.cuh"
#include "launch_counter.cuh"

namespace {

constexpr int kThreads = 9 * 32;     // a refit block: a warp a sum
constexpr int kStaged = 1024;        // a refit row of up to this many
                                     // points is staged in shared memory

__global__ void __launch_bounds__(kThreads)
kabsch_weighted_kernel(const float* __restrict__ p, const float* __restrict__ q,
                       const float* __restrict__ w, int n, int n_sq,
                       float* __restrict__ out, unsigned long long* counter) {
  // a row that fits is copied to shared memory first, and the weights
  // w / sum(w) taken once a point: the sums then read no global memory
  // (the same values, so the same bits)
  __shared__ float sp[3 * kStaged], sq[3 * kStaged], swn[kStaged];
  __shared__ float wsum, bar[6], S[9];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  if (blockIdx.x == 0 && t == 0) atomicAdd(counter, 1ULL);
  const long long row = blockIdx.x;
  p += row * n * 3;
  q += row * n * 3;
  w += row * n;
  const bool staged = n <= kStaged;
  if (staged) {
    for (int i = t; i < 3 * n; i += kThreads) {
      sp[i] = p[i];
      sq[i] = q[i];
    }
    for (int i = t; i < n; i += kThreads) swn[i] = w[i];
    __syncthreads();
  }
  const float* P = staged ? sp : p;
  const float* Q = staged ? sq : q;

  // sum(w), clamped: warp 0
  if (warp == 0) {
    const float v = warp_inner_sum(n, [&](int i) {
      return staged ? swn[i] : w[i];
    });
    if (lane == 0) wsum = clamp_min(v, (float)1e-9);
  }
  __syncthreads();
  const float ws = wsum;
  if (staged) {
    for (int i = t; i < n; i += kThreads) swn[i] = dv(swn[i], ws);
    __syncthreads();
  }
  auto wn = [&](int i) { return staged ? swn[i] : dv(w[i], ws); };

  // the weighted means: sum over rows of (w / wsum) p, (w / wsum) q; warps
  // 0-5, a column each
  if (warp < 6) {
    const float* x = warp < 3 ? P : Q;
    const int c = warp % 3;
    const float v = warp_row_sum<1>(n, [&](int i, int) {
      return mul(wn(i), x[3 * i + c]);
    });
    if (lane == 0) bar[warp] = v;
  }
  __syncthreads();

  // S_ab = sum (wn (p_a - p_bar_a)) (q_b - q_bar_b); warps 0-8, a sum each
  {
    const int a = warp / 3, b = warp % 3;
    const float pa = bar[a], qb = bar[3 + b];
    const float v = warp_inner_sum(n, [&](int i) {
      return mul(mul(wn(i), sub(P[3 * i + a], pa)), sub(Q[3 * i + b], qb));
    });
    if (lane == 0) S[warp] = v;
  }
  __syncthreads();
  if (t == 0) fit_pose(S, bar, bar + 3, n_sq, out + 7 * row);
}

}  // namespace

extern "C" {

// Loads the kernels and finds the counters on the current device (lazy
// module loading would load them at their first launch, which may lie
// inside a capture, where loading is not permitted).
int kabsch_fit_load() {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kabsch_weighted_kernel);
  if (err != cudaSuccess) return err;
  return find_launch_counters();
}

// p, q (batch, n, 3), w (batch, n), out (batch, 7), float32, contiguous on
// the current device.
int kabsch_fit_weighted_launch(const float* p, const float* q, const float* w,
                               long long batch, int n, int n_sq, float* out,
                               int counted, cudaStream_t stream) {
  if (batch <= 0) return cudaSuccess;
  if (n < 0) return cudaErrorInvalidValue;
  if (!launch_counters_found()) return cudaErrorInitializationError;
  kabsch_weighted_kernel<<<(unsigned)batch, kThreads, 0, stream>>>(
      p, q, w, n, n_sq, out, launch_counter(counted));
  return cudaGetLastError();
}

int kabsch_fit_lanes() { return kLanes; }

}  // extern "C"

LAUNCH_COUNTER_ENTRY_POINTS(kabsch_fit)
