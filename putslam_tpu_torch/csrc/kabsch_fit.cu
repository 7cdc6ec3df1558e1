// RANSAC's rigid fit for Hopper (sm_90a): the closed-form Horn / Kabsch
// solve of putslam_tpu_torch/ops/kabsch.py in ONE launch a call, from the
// point sets to the (..., 7) poses [tx, ty, tz, qw, qx, qy, qz].
//
// Not a port of a TPU kernel: there is no Pallas kernel here. The JAX
// package writes the solve structure-of-arrays (putslam_tpu/ops/kabsch.py:
// kabsch_soa, weighted_kabsch, _horn_quat_soa) so that XLA fuses it, and
// "thousands of hypotheses solve in a single fused pass". Run op by op in
// PyTorch it was ~500 elementwise launches a solve (5 symmetric squarings
// of 10 entries, the set-up and the tail), 3 solves a RANSAC call, ~3,000
// launches of a replayed SLAM frame: this kernel is the counterpart of
// that fusion.
//
// Two modes:
// * the sampled fit (kabsch_soa): the components px ... qz, each (n, H),
//   n points of H hypotheses; one thread a hypothesis, the means, the nine
//   cross-covariance sums, Horn's squarings and the tail in registers.
// * the weighted refit (weighted_kabsch): p, q (B, N, 3), w (B, N); one
//   block of nine warps a batch row (staged in shared memory up to kStaged
//   points), a warp a sum, in three passes: sum(w) (warp 0); the six
//   weighted means (warps 0-5); the nine sums of S = sum wn (p - p_bar)
//   (q - q_bar)^T (warps 0-8). A warp runs its sum's independent chains
//   of ATen's order on its lanes (warp_row_sum, warp_inner_sum). Then
//   thread 0 runs Horn and the tail.
//
// Bit for bit equal to the plain version (ops/kabsch.py: plain_kabsch_soa,
// plain_weighted_kabsch), which writes out the arithmetic the port did on
// the CPU before this kernel: the refit's sums in the order of ATen's CPU
// float sums (row_sum: four accumulators over rows of four elements
// through a cascade of partial sums; inner_sum: vectors of kLanes through
// row_sum, then the leftover elements and the lanes in turn), the sampled
// fit's over its few points in turn from +0.0f, a mean as the sum divided
// by n, every norm as the squares added in turn and a correctly rounded
// square root, the cross products as the CPU's FMA (fma_cpu: the exact
// product in double, the sum, then float). Every other operation is a
// round-to-nearest intrinsic in the plain version's order, compiled with
// -fmad=false, so no multiply and add are contracted into an FMA. The
// plain version's scalar constants are Python floats that PyTorch casts to
// float, as the (float) casts of double literals below do; its
// torch.maximum and clamp propagate a NaN, as maximum and clamp_min do.
//
// What bounds it: not bytes (~100 KB a sampled fit at H = 1024, ~14 KB a
// refit at N = 512: tens of nanoseconds at 3.35 TB/s) and not operations
// (~700 a hypothesis, ~10 ns of the card's float32 rate), but chains of
// dependent operations and the launch itself. The sampled fit's is one
// thread's ~600 (twenty of them divisions and square roots), kept in
// registers. In the refit a warp a sum cuts a sum's chain of dependent
// adds from N terms to N / 32 and the merges (at N = 512: 16 adds, then
// 4 + 3 + 8), so what is left is the staging load, three block barriers
// and Horn's chain on one thread, as in the sampled fit.
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

constexpr int kLanes = 8;            // lanes of ATen's CPU float sums
constexpr int kThreads = 9 * 32;     // a refit block: a warp a sum
constexpr int kStaged = 1024;        // a refit row of up to this many
                                     // points is staged in shared memory
constexpr int kSampledThreads = 64;  // threads of a sampled-fit block

__device__ unsigned long long launches_counted;
__device__ unsigned long long launches_uncounted;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float dv(float a, float b) {
  return __fdiv_rn(a, b);
}
// torch.maximum: a NaN in either operand is the result
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.clamp(v, min=lo): a NaN stays
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
// a0 * b0 + a1 * b1 + a2 * b2 + a3 * b3, left to right
__device__ __forceinline__ float dot4(float a0, float b0, float a1, float b1,
                                      float a2, float b2, float a3, float b3) {
  return add(add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2)), mul(a3, b3));
}
// a * b + c as the CPU's cross product computes it (ops/kabsch.py::_fma):
// the exact product in double, the sum rounded to double, then to float
__device__ __forceinline__ float fma_cpu(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), (double)c));
}
// sum of f(k), k < n, in turn from +0.0f (ops/kabsch.py::_seq_sum)
template <class F>
__device__ __forceinline__ float seq_sum(int n, F f) {
  float total = 0.0f;
  for (int k = 0; k < n; ++k) total = add(total, f(k));
  return total;
}
__device__ __forceinline__ int ceil_log2(int x) {
  return x <= 2 ? 1 : 32 - __clz(x - 1);
}
// The refit's sums run a warp each, in the order of ATen's CPU float sums
// (ops/kabsch.py::row_sum, inner_sum), which is a forest of independent
// chains: accumulator k (< 4) of a column takes the rows 4i + k, and within
// a chain the cascade's first level restarts from 0 every `step` rows, so
// those blocks are independent too; only short merges in a fixed order
// join them. tests/test_torch_kabsch.py::test_refit_split_is_the_sum_order
// writes this split out in Python and holds it against the CPU's sums.
//
// Column totals of row_sum over n rows of kCols columns, e(row, col): a
// chain (column, accumulator) has kGroup lanes; lane g of a chain sums the
// blocks g, g + kGroup, ... from 0.0f, and the chain's first lane merges
// them through the cascade in block order (shuffles), adds the rows after
// the last full block, then levels 1-3. A column's total (accumulator 0,
// the rows after the last full row of four, accumulators 1-3 in turn) is
// valid in the column's first lane, col * 4 * kGroup. Every lane of the
// warp calls it.
template <int kCols, class E>
__device__ float warp_row_sum(int n, E e) {
  constexpr int kGroup = 32 / (4 * kCols);     // lanes a chain
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int g = lane % kGroup, chain = lane / kGroup;
  const int col = chain / 4, k = chain % 4;
  const int size = n / 4;
  const int power = ceil_log2(size) / 4 > 4 ? ceil_log2(size) / 4 : 4;
  const int step = 1 << power, mask = step - 1, nb = size >> power;
  float acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
  for (int b0 = 0; b0 < nb; b0 += kGroup) {
    float part = 0.0f;
    if (b0 + g < nb) {
      const int r0 = (b0 + g) << power;
#pragma unroll 16
      for (int r = 0; r < step; ++r)
        part = add(part, e(4 * (r0 + r) + k, col));
    }
#pragma unroll
    for (int h = 0; h < kGroup; ++h) {
      const float v =
          kGroup == 1 ? part : __shfl_sync(all, part, lane - g + h);
      if (g == 0 && b0 + h < nb) {
        acc1 = add(acc1, v);
        const int i = (b0 + h + 1) << power;          // rows done
        if ((i & (mask << power)) == 0) {
          acc2 = add(acc2, acc1);
          acc1 = 0.0f;
          if ((i & (mask << (2 * power))) == 0) {
            acc3 = add(acc3, acc2);
            acc2 = 0.0f;
          }
        }
      }
    }
  }
  float acc0 = 0.0f;
  if (g == 0)
    for (int i = nb << power; i < size; ++i)
      acc0 = add(acc0, e(4 * i + k, col));
  acc0 = add(add(add(acc0, acc1), acc2), acc3);
  float total = acc0;
  const bool first = g == 0 && k == 0;
  if (first)
    for (int m = 4 * size; m < n; ++m) total = add(total, e(m, col));
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    const float v = __shfl_sync(all, acc0, lane + j * kGroup);
    if (first) total = add(total, v);
  }
  return total;
}
// sum of f(m), m < n, in the order of ATen's CPU sum of a contiguous row
// (ops/kabsch.py::inner_sum): the 8 lanes x 4 accumulators are the warp's
// 32 chains; valid in lane 0. Every lane of the warp calls it.
template <class F>
__device__ float warp_inner_sum(int n, F f) {
  if (n < kLanes) return warp_row_sum<1>(n, [&](int i, int) { return f(i); });
  const int nv = n / kLanes;
  const float lane_total = warp_row_sum<kLanes>(
      nv, [&](int i, int c) { return f(i * kLanes + c); });
  float total = 0.0f;
  const bool first = (threadIdx.x & 31) == 0;
  if (first)
    for (int m = nv * kLanes; m < n; ++m) total = add(total, f(m));
#pragma unroll
  for (int c = 0; c < kLanes; ++c) {
    const float v = __shfl_sync(0xffffffffu, lane_total, 4 * c);
    if (first) total = add(total, v);
  }
  return total;
}
// sqrt of the sum of squares, clamped below: the explicit norms of the
// plain version
__device__ __forceinline__ float norm4(float a, float b, float c, float d,
                                       float lo) {
  return clamp_min(__fsqrt_rn(dot4(a, a, b, b, c, c, d, d)), lo);
}

// Horn's quaternion from the nine sums S = (Sxx, Sxy, ..., Szz) and the
// pose from it and the means: ops/kabsch.py::_horn_quat_soa and _pose,
// operation for operation. Writes out[0..6].
__device__ void fit_pose(const float* S, const float* pb, const float* qb,
                         int n_sq, float* out) {
  const float Sxx = S[0], Sxy = S[1], Sxz = S[2];
  const float Syx = S[3], Syy = S[4], Syz = S[5];
  const float Szx = S[6], Szy = S[7], Szz = S[8];
  const float k00 = add(add(Sxx, Syy), Szz);
  const float k01 = sub(Syz, Szy);
  const float k02 = sub(Szx, Sxz);
  const float k03 = sub(Sxy, Syx);
  const float k11 = sub(sub(Sxx, Syy), Szz);
  const float k12 = add(Sxy, Syx);
  const float k13 = add(Szx, Sxz);
  const float k22 = sub(add(-Sxx, Syy), Szz);
  const float k23 = add(Syz, Szy);
  const float k33 = add(sub(-Sxx, Syy), Szz);
  const float diag = add(add(add(fabsf(k00), fabsf(k11)), fabsf(k22)),
                         fabsf(k33));
  const float off = add(add(add(add(add(fabsf(k01), fabsf(k02)), fabsf(k03)),
                                fabsf(k12)), fabsf(k13)), fabsf(k23));
  const float c = add(mul(add(diag, mul(off, 2.0f)), 0.25f), (float)1e-6);
  float b00 = add(k00, c), b11 = add(k11, c), b22 = add(k22, c),
        b33 = add(k33, c);
  float b01 = k01, b02 = k02, b03 = k03, b12 = k12, b13 = k13, b23 = k23;

  for (int s = 0; s < n_sq; ++s) {
    const float n00 = dot4(b00, b00, b01, b01, b02, b02, b03, b03);
    const float n01 = dot4(b00, b01, b01, b11, b02, b12, b03, b13);
    const float n02 = dot4(b00, b02, b01, b12, b02, b22, b03, b23);
    const float n03 = dot4(b00, b03, b01, b13, b02, b23, b03, b33);
    const float n11 = dot4(b01, b01, b11, b11, b12, b12, b13, b13);
    const float n12 = dot4(b01, b02, b11, b12, b12, b22, b13, b23);
    const float n13 = dot4(b01, b03, b11, b13, b12, b23, b13, b33);
    const float n22 = dot4(b02, b02, b12, b12, b22, b22, b23, b23);
    const float n23 = dot4(b02, b03, b12, b13, b22, b23, b23, b33);
    const float n33 = dot4(b03, b03, b13, b13, b23, b23, b33, b33);
    const float scale = clamp_min(maximum(maximum(n00, n11),
                                          maximum(n22, n33)), (float)1e-30);
    const float inv = dv(1.0f, scale);
    b00 = mul(n00, inv); b11 = mul(n11, inv);
    b22 = mul(n22, inv); b33 = mul(n33, inv);
    b01 = mul(n01, inv); b02 = mul(n02, inv); b03 = mul(n03, inv);
    b12 = mul(n12, inv); b13 = mul(n13, inv); b23 = mul(n23, inv);
  }

  const float c0 = 1.0f, c1 = (float)0.31, c2 = (float)0.17,
              c3 = (float)0.083;
  float v0 = dot4(b00, c0, b01, c1, b02, c2, b03, c3);
  float v1 = dot4(b01, c0, b11, c1, b12, c2, b13, c3);
  float v2 = dot4(b02, c0, b12, c1, b22, c2, b23, c3);
  float v3 = dot4(b03, c0, b13, c1, b23, c2, b33, c3);
  float nrm = norm4(v0, v1, v2, v3, (float)1e-20);
  v0 = dv(v0, nrm); v1 = dv(v1, nrm); v2 = dv(v2, nrm); v3 = dv(v3, nrm);
  const float u0 = dot4(b00, v0, b01, v1, b02, v2, b03, v3);
  const float u1 = dot4(b01, v0, b11, v1, b12, v2, b13, v3);
  const float u2 = dot4(b02, v0, b12, v1, b22, v2, b23, v3);
  const float u3 = dot4(b03, v0, b13, v1, b23, v2, b33, v3);
  nrm = norm4(u0, u1, u2, u3, (float)1e-20);
  float qw = dv(u0, nrm), qx = dv(u1, nrm), qy = dv(u2, nrm),
        qz = dv(u3, nrm);
  if (qw < 0.0f) {                       // the canonical sign, w >= 0
    qw = -qw; qx = -qx; qy = -qy; qz = -qz;
  }
  nrm = norm4(qw, qx, qy, qz, (float)1e-12);   // se3.quat_normalize
  qw = dv(qw, nrm); qx = dv(qx, nrm); qy = dv(qy, nrm); qz = dv(qz, nrm);

  // t = q_bar - R p_bar (se3.quat_rotate: t' = 2 qv x v; v + qw t' + qv x t';
  // component i of a x b is fma_cpu(a_j, b_k, -(a_k b_j)))
  const float vx = pb[0], vy = pb[1], vz = pb[2];
  const float tx = mul(fma_cpu(qy, vz, -mul(qz, vy)), 2.0f);
  const float ty = mul(fma_cpu(qz, vx, -mul(qx, vz)), 2.0f);
  const float tz = mul(fma_cpu(qx, vy, -mul(qy, vx)), 2.0f);
  out[0] = sub(qb[0], add(add(vx, mul(qw, tx)),
                          fma_cpu(qy, tz, -mul(qz, ty))));
  out[1] = sub(qb[1], add(add(vy, mul(qw, ty)),
                          fma_cpu(qz, tx, -mul(qx, tz))));
  out[2] = sub(qb[2], add(add(vz, mul(qw, tz)),
                          fma_cpu(qx, ty, -mul(qy, tx))));
  nrm = norm4(qw, qx, qy, qz, (float)1e-12);   // se3.make_pose normalises
  out[3] = dv(qw, nrm); out[4] = dv(qx, nrm);
  out[5] = dv(qy, nrm); out[6] = dv(qz, nrm);
}

struct Components {
  const float* c[6];                   // px, py, pz, qx, qy, qz
};

__global__ void kabsch_sampled_kernel(Components comp, int n, long long h_count,
                                      int n_sq,
                                      float* __restrict__ out,
                                      unsigned long long* counter) {
  const long long h = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (h == 0) atomicAdd(counter, 1ULL);
  if (h >= h_count) return;
  float bar[6];
  for (int k = 0; k < 6; ++k) {
    const float* x = comp.c[k];
    bar[k] = dv(seq_sum(n, [&](int j) { return x[j * h_count + h]; }),
                (float)n);
  }
  float S[9];
  for (int i = 0; i < 3; ++i) {
    const float* p = comp.c[i];
    for (int j = 0; j < 3; ++j) {
      const float* q = comp.c[3 + j];
      S[3 * i + j] = seq_sum(n, [&](int k) {
        const long long at = k * h_count + h;
        return mul(sub(p[at], bar[i]), sub(q[at], bar[3 + j]));
      });
    }
  }
  fit_pose(S, bar, bar + 3, n_sq, out + 7 * h);
}

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

unsigned long long* counters[2] = {nullptr, nullptr};

}  // namespace

extern "C" {

// Loads the kernels and finds the counters on the current device (lazy
// module loading would load them at their first launch, which may lie
// inside a capture, where loading is not permitted).
int kabsch_fit_load() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kabsch_sampled_kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&attr, kabsch_weighted_kernel);
  if (err != cudaSuccess) return err;
  err = cudaGetSymbolAddress((void**)&counters[0], launches_uncounted);
  if (err != cudaSuccess) return err;
  return cudaGetSymbolAddress((void**)&counters[1], launches_counted);
}

// comps: six pointers to (n, h_count) float32 arrays px, py, pz, qx, qy, qz;
// out (h_count, 7) float32; all contiguous on the current device.
int kabsch_fit_sampled_launch(const float* const* comps, int n,
                              long long h_count, int n_sq, float* out,
                              int counted, cudaStream_t stream) {
  if (h_count <= 0) return cudaSuccess;
  if (n < 1) return cudaErrorInvalidValue;
  if (counters[0] == nullptr) return cudaErrorInitializationError;
  Components comp;
  for (int k = 0; k < 6; ++k) comp.c[k] = comps[k];
  const long long blocks = (h_count + kSampledThreads - 1) / kSampledThreads;
  kabsch_sampled_kernel<<<(unsigned)blocks, kSampledThreads, 0, stream>>>(
      comp, n, h_count, n_sq, out, counters[counted ? 1 : 0]);
  return cudaGetLastError();
}

// p, q (batch, n, 3), w (batch, n), out (batch, 7), float32, contiguous on
// the current device.
int kabsch_fit_weighted_launch(const float* p, const float* q, const float* w,
                               long long batch, int n, int n_sq, float* out,
                               int counted, cudaStream_t stream) {
  if (batch <= 0) return cudaSuccess;
  if (n < 0) return cudaErrorInvalidValue;
  if (counters[0] == nullptr) return cudaErrorInitializationError;
  kabsch_weighted_kernel<<<(unsigned)batch, kThreads, 0, stream>>>(
      p, q, w, n, n_sq, out, counters[counted ? 1 : 0]);
  return cudaGetLastError();
}

int kabsch_fit_lanes() { return kLanes; }

// The counted launches since the last reset (synchronises the device).
int kabsch_fit_read_launches(unsigned long long* value) {
  return cudaMemcpyFromSymbol(value, launches_counted, sizeof(*value));
}

int kabsch_fit_reset_launches() {
  const unsigned long long zero = 0;
  return cudaMemcpyToSymbol(launches_counted, &zero, sizeof(zero));
}

const char* kabsch_fit_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
