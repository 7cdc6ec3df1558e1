// Horn's closed-form rigid fit and the sums it is built from, in the
// arithmetic of the port's plain PyTorch versions (ops/kabsch.py), for the
// kernels of csrc/kabsch_fit.cu and csrc/ransac_score.cu.
//
// Every operation is a round-to-nearest intrinsic in the plain version's
// order; a library that includes this header is compiled with -fmad=false
// (ops/cuda_lib.py), so no multiply and add are contracted into an FMA.
// The plain version's scalar constants are Python floats that PyTorch
// casts to float, as the (float) casts of double literals below do; its
// torch.maximum and clamp propagate a NaN, as maximum and clamp_min do.
// The cross products of the rotation are the CPU's FMA (fma_cpu). The sums
// run in the orders of ops/kabsch.py: seq_sum (in turn from +0.0f),
// warp_row_sum / warp_inner_sum (ATen's CPU float sums, on a warp's
// lanes).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;            // lanes of ATen's CPU float sums

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

// The sampled fit of one hypothesis (ops/kabsch.py::plain_kabsch_soa): n
// points, component c (0-5: px, py, pz, qx, qy, qz) of point j is
// load(c, j). The six means over the points in turn, divided by n; the
// nine cross-covariance sums in turn; then Horn (fit_pose). Writes
// out[0..6].
template <class L>
__device__ __forceinline__ void sampled_fit(int n, int n_sq, L load,
                                            float* out) {
  float bar[6];
#pragma unroll
  for (int c = 0; c < 6; ++c)
    bar[c] = dv(seq_sum(n, [&](int j) { return load(c, j); }), (float)n);
  float S[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      S[3 * i + j] = seq_sum(n, [&](int k) {
        return mul(sub(load(i, k), bar[i]), sub(load(3 + j, k), bar[3 + j]));
      });
  }
  fit_pose(S, bar, bar + 3, n_sq, out);
}

}  // namespace
