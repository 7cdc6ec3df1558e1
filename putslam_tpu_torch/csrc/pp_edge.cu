// The bundle adjustment's pose-pose edge terms for Hopper (sm_90a): each
// edge's residual, its exact Jacobians, its gate and its robust weight in
// one launch (ops/pp_edge.py::terms, called by backend/optimize.py::
// _pp_terms in every Gauss-Newton iteration of every solver).
//
// Not a port of a TPU kernel: it replaces the XLA fusion of
// putslam_tpu/backend/factors.py's pose-pose factor, which the port ran as
// an ATen chain (ops/pp_edge.py::plain_terms): two pose gathers, the
// residual log(Z⁻¹ ∘ T_i⁻¹ ∘ T_j) twice (once inside the Jacobians), the
// inverse left Jacobian blocks of SE(3) at −r with their Taylor windows,
// the adjoint of B⁻¹ = T_j⁻¹ ∘ T_i, the gate and the robust weight: ~554
// ATen launches a call, each over at most max_pose_pose_edges rows.
//
// What bounds it: one thread's dependent chain and the launch, not bytes.
// An edge reads 113 bytes and writes 320 (0.44 MB a call at fr1's 1024
// edges, 0.13 us at the card's bandwidth); its ~1,550 operations run in
// one thread, through square roots, divisions, sin, cos and atan2.
//
// One launch; a thread an edge slot (every slot, valid or not, as the
// chain computes them), blocks of kThreads. A thread gathers both poses,
// computes the gate, the residual once (the chain's second evaluation
// gives the same bits), the two 6×6 Jacobians, the weight and the squared
// error; r6, Ji and Jj are staged in shared memory and the block writes
// them out coalesced.
//
// Bit-exactness with the ATen chain on the card: every operation of the
// chain is one here, in the chain's order, rounded as its ATen kernel
// rounds it (the library is built with -fmad=false; the _rn intrinsics
// say so at each site):
// * an elementwise op is one correctly rounded op; a Python number is
//   float32, and a division by one is a product with its float32
//   reciprocal (ATen's CUDA division by a CPU scalar); `1.0 / x` and
//   `2.0 / x` are the reciprocal, then the product (Tensor.__rtruediv__);
// * torch.linalg.cross contracts its first product into an FMA:
//   fma(a1, b2, −(a2·b1)) (ATen's kernel is built with contraction);
// * a 3×3 batched product (cuBLAS) sums its three products as an FMA
//   chain from +0 in ascending k; the log map's matrix-vector einsum (a
//   cuBLAS product with one column) as two such chains, k = 0, 1 and
//   k = 2, added;
// * the reductions sum as ATen's reduce kernel splits a short innermost
//   dim over 2 (3 elements: (x0 + x2) + x1) or 4 threads (4 elements:
//   (x0 + x2) + (x1 + x3); 6: ((x0 + x4) + x2) + ((x1 + x5) + x3)), each
//   square rounded;
// * sqrtf, sinf, cosf and atan2f are the functions ATen's float kernels
//   call; both branches of each Taylor window are the chain's, and only
//   the one it selects is computed.
//
// The launch adds one to the launch counter on the card
// (launch_counter.cuh).
//
// Plain C entry points, bound with ctypes; each returns a cudaError_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_counter.cuh"

namespace {

constexpr int kThreads = 64;      // edge slots a block
constexpr int kPad = 37;          // shared row of a 6×6 Jacobian, padded
constexpr int kRobustModes = 3;   // none, cauchy, huber

struct Params {
  const float* kf_pose;     // (K, 7) [t, q(w, x, y, z)]
  const int* kf_gen;        // (K,) or null
  const int* pp_i;          // (E,)
  const int* pp_j;          // (E,)
  const float* pp_rel;      // (E, 7)
  const float* pp_w;        // (E,)
  const bool* pp_valid;     // (E,)
  const int* pp_gen_i;      // (E,)
  const int* pp_gen_j;      // (E,)
  int K, E;
  int robust;               // 0 none, 1 cauchy, 2 huber
  float delta;              // the robust delta, float32
  float inv_delta2;         // 1 / float32(delta²), float32
  float* r6;                // (E, 6) out
  float* Ji;                // (E, 6, 6) out
  float* Jj;                // (E, 6, 6) out
  float* wpp;               // (E,) out
  float* sq_pp;             // (E,) out
  unsigned long long* counter;
};

struct Pose {
  float t[3];
  float q[4];               // w, x, y, z
};

struct M3 {
  float a[3][3];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// One entry of a cuBLAS 3×3 product: an FMA chain from +0 in ascending k.
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmaf_rn(a0, b0, 0.0f)));
}

// One entry of the einsum's matrix-vector product (cuBLAS, one column):
// the chain over k = 0, 1 and the product of k = 2, each from +0, added.
__device__ __forceinline__ float dot3_mv(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
  return add(__fmaf_rn(a1, b1, __fmaf_rn(a0, b0, 0.0f)),
             __fmaf_rn(a2, b2, 0.0f));
}

__device__ __forceinline__ M3 matmul(const M3& x, const M3& y) {
  M3 o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o.a[i][j] = dot3(x.a[i][0], x.a[i][1], x.a[i][2], y.a[0][j], y.a[1][j],
                       y.a[2][j]);
  return o;
}

__device__ __forceinline__ M3 madd(const M3& x, const M3& y) {
  M3 o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o.a[i][j] = add(x.a[i][j], y.a[i][j]);
  return o;
}

__device__ __forceinline__ M3 msub(const M3& x, const M3& y) {
  M3 o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o.a[i][j] = sub(x.a[i][j], y.a[i][j]);
  return o;
}

// s · X, s a scalar (a broadcast product).
__device__ __forceinline__ M3 mscale(float s, const M3& x) {
  M3 o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o.a[i][j] = mul(s, x.a[i][j]);
  return o;
}

__device__ __forceinline__ M3 mneg(const M3& x) {
  M3 o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o.a[i][j] = -x.a[i][j];
  return o;
}

// se3.skew: [[0, −z, y], [z, 0, −x], [−y, x, 0]], the zeros +0.
__device__ __forceinline__ M3 skew(const float v[3]) {
  M3 o;
  o.a[0][0] = 0.0f;  o.a[0][1] = -v[2]; o.a[0][2] = v[1];
  o.a[1][0] = v[2];  o.a[1][1] = 0.0f;  o.a[1][2] = -v[0];
  o.a[2][0] = -v[1]; o.a[2][1] = v[0];  o.a[2][2] = 0.0f;
  return o;
}

// torch.linalg.cross: each component's first product contracted.
__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float o[3]) {
  o[0] = __fmaf_rn(a[1], b[2], -mul(a[2], b[1]));
  o[1] = __fmaf_rn(a[2], b[0], -mul(a[0], b[2]));
  o[2] = __fmaf_rn(a[0], b[1], -mul(a[1], b[0]));
}

// torch.sum(v * v, dim=-1) over 3: (v0² + v2²) + v1².
__device__ __forceinline__ float sumsq3(const float v[3]) {
  return add(add(mul(v[0], v[0]), mul(v[2], v[2])), mul(v[1], v[1]));
}

// torch.linalg.norm(q, dim=-1) over 4: √((q0² + q2²) + (q1² + q3²)).
__device__ __forceinline__ float norm4(const float q[4]) {
  return __fsqrt_rn(add(add(mul(q[0], q[0]), mul(q[2], q[2])),
                        add(mul(q[1], q[1]), mul(q[3], q[3]))));
}

// se3.quat_rotate: t = 2·(qv × v); v + qw·t + qv × t.
__device__ __forceinline__ void quat_rotate(const float q[4], const float v[3],
                                            float o[3]) {
  const float qv[3] = {q[1], q[2], q[3]};
  float c[3], t[3], c2[3];
  cross(qv, v, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = mul(2.0f, c[k]);
  cross(qv, t, c2);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = add(add(v[k], mul(q[0], t[k])), c2[k]);
}

// se3.make_pose's quat_normalize: q / max(‖q‖, 1e-12).
__device__ __forceinline__ void normalize(float q[4]) {
  const float n = clamp_min(norm4(q), 1e-12f);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = dvd(q[k], n);
}

// se3.inverse.
__device__ __forceinline__ Pose inverse(const Pose& p) {
  Pose o;
  o.q[0] = p.q[0];
  o.q[1] = -p.q[1];
  o.q[2] = -p.q[2];
  o.q[3] = -p.q[3];
  float r[3];
  quat_rotate(o.q, p.t, r);
#pragma unroll
  for (int k = 0; k < 3; ++k) o.t[k] = -r[k];
  normalize(o.q);
  return o;
}

// se3.compose(a, b) = a ∘ b: the Hamilton product term by term in the
// chain's order, t_a + q_a(t_b), the product normalised.
__device__ __forceinline__ Pose compose(const Pose& a, const Pose& b) {
  const float aw = a.q[0], ax = a.q[1], ay = a.q[2], az = a.q[3];
  const float bw = b.q[0], bx = b.q[1], by = b.q[2], bz = b.q[3];
  Pose o;
  o.q[0] = sub(sub(sub(mul(aw, bw), mul(ax, bx)), mul(ay, by)), mul(az, bz));
  o.q[1] = sub(add(add(mul(aw, bx), mul(ax, bw)), mul(ay, bz)), mul(az, by));
  o.q[2] = add(add(sub(mul(aw, by), mul(ax, bz)), mul(ay, bw)), mul(az, bx));
  o.q[3] = add(sub(add(mul(aw, bz), mul(ax, by)), mul(ay, bx)), mul(az, bw));
  float r[3];
  quat_rotate(a.q, b.t, r);
#pragma unroll
  for (int k = 0; k < 3; ++k) o.t[k] = add(a.t[k], r[k]);
  normalize(o.q);
  return o;
}

// se3.so3_log: the quaternion to w ≥ 0, θ = 2·atan2(‖v‖, w), the scale
// θ/‖v‖ or, where ‖v‖² ≤ 1e-8, 2/max(w, 1e-12).
__device__ __forceinline__ void so3_log(const float q_in[4], float phi[3]) {
  const bool flip = q_in[0] < 0.0f;
  float q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = flip ? -q_in[k] : q_in[k];
  const float w = isnan(q[0]) ? q[0] : fminf(fmaxf(q[0], -1.0f), 1.0f);
  const float v[3] = {q[1], q[2], q[3]};
  const float vn2 = sumsq3(v);
  const float vn = __fsqrt_rn(clamp_min(vn2, 1e-24f));
  float scale;
  if (vn2 > 1e-8f) {
    const float theta = mul(2.0f, atan2f(vn, w));
    scale = dvd(theta, vn);
  } else {
    scale = mul(__frcp_rn(clamp_min(w, 1e-12f)), 2.0f);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) phi[k] = mul(scale, v[k]);
}

// se3._so3_left_jacobian_inv: I − ½K + c·K², K = skew(φ), the Taylor
// window θ² ≤ 0.25.
__device__ __forceinline__ M3 jl_inv(const float phi[3]) {
  const float theta2 = sumsq3(phi);
  const float theta = __fsqrt_rn(clamp_min(theta2, 1e-24f));
  const M3 K = skew(phi);
  const M3 K2 = matmul(K, K);
  float c;
  if (theta2 > 0.25f) {
    float den = mul(mul(2.0f, theta), sinf(theta));
    if (fabsf(den) < 1e-12f) den = 1e-12f;
    c = sub(mul(__frcp_rn(clamp_min(theta2, 1e-24f)), 1.0f),
            dvd(add(cosf(theta), 1.0f), den));
  } else {
    c = add(add((float)(1.0 / 12.0), mul(theta2, 1.0f / 720.0f)),
            mul(mul(theta2, theta2), 1.0f / 30240.0f));
  }
  M3 o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o.a[i][j] = add(sub(i == j ? 1.0f : 0.0f, mul(0.5f, K.a[i][j])),
                      mul(c, K2.a[i][j]));
  return o;
}

// se3.log: φ = so3_log(q), ρ = J_l⁻¹(φ)·t; r = [ρ, φ].
__device__ __forceinline__ void se3_log(const Pose& p, float r[6]) {
  float phi[3];
  so3_log(p.q, phi);
  const M3 J = jl_inv(phi);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    r[i] = dot3_mv(J.a[i][0], J.a[i][1], J.a[i][2], p.t[0], p.t[1], p.t[2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) r[3 + k] = phi[k];
}

// se3._se3_Q at ξ = [ρ, φ] (Barfoot eq. 7.86), the Taylor window θ² ≤ 0.25.
__device__ __forceinline__ M3 se3_Q(const float xi[6]) {
  const float rho[3] = {xi[0], xi[1], xi[2]};
  const float phi[3] = {xi[3], xi[4], xi[5]};
  const float theta2 = sumsq3(phi);
  const float theta = __fsqrt_rn(clamp_min(theta2, 1e-24f));
  const M3 Cr = skew(rho);
  const M3 Cp = skew(phi);
  const M3 Cp2 = matmul(Cp, Cp);
  const float t4 = mul(theta2, theta2);
  float m2, m3, m5;
  if (theta2 > 0.25f) {
    const float sin_t = sinf(theta), cos_t = cosf(theta);
    const float t3 = mul(theta2, theta);
    m2 = dvd(sub(theta, sin_t), t3);
    m3 = dvd(sub(sub(1.0f, mul(0.5f, theta2)), cos_t), t4);
    m5 = dvd(sub(sub(theta, sin_t), mul(t3, 1.0f / 6.0f)), mul(t4, theta));
  } else {
    m2 = add(sub((float)(1.0 / 6.0), mul(theta2, 1.0f / 120.0f)),
             mul(t4, 1.0f / 5040.0f));
    m3 = sub(add((float)(-1.0 / 24.0), mul(theta2, 1.0f / 720.0f)),
             mul(t4, 1.0f / 40320.0f));
    m5 = sub(add((float)(-1.0 / 120.0), mul(theta2, 1.0f / 5040.0f)),
             mul(t4, 1.0f / 362880.0f));
  }
  const float m4 = mul(0.5f, sub(m3, mul(3.0f, m5)));
  const M3 CpCr = matmul(Cp, Cr);
  const M3 CrCp = matmul(Cr, Cp);
  const M3 P = matmul(Cp, CrCp);
  const M3 t_m2 = mscale(m2, madd(madd(CpCr, CrCp), P));
  const M3 t_m3 = mscale(m3, msub(madd(matmul(Cp2, Cr), matmul(Cr, Cp2)),
                                  mscale(3.0f, P)));
  const M3 t_m4 = mscale(m4, madd(matmul(CpCr, Cp2), matmul(Cp2, CrCp)));
  return msub(msub(madd(mscale(0.5f, Cr), t_m2), t_m3), t_m4);
}

// se3.quat_to_matrix.
__device__ __forceinline__ M3 quat_to_matrix(const float q[4]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
  const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, z);
  M3 m;
  m.a[0][0] = sub(1.0f, mul(2.0f, add(yy, zz)));
  m.a[0][1] = mul(2.0f, sub(xy, wz));
  m.a[0][2] = mul(2.0f, add(xz, wy));
  m.a[1][0] = mul(2.0f, add(xy, wz));
  m.a[1][1] = sub(1.0f, mul(2.0f, add(xx, zz)));
  m.a[1][2] = mul(2.0f, sub(yz, wx));
  m.a[2][0] = mul(2.0f, sub(xz, wy));
  m.a[2][1] = mul(2.0f, add(yz, wx));
  m.a[2][2] = sub(1.0f, mul(2.0f, add(xx, yy)));
  return m;
}

__device__ __forceinline__ Pose load_pose(const float* p) {
  Pose o;
#pragma unroll
  for (int k = 0; k < 3; ++k) o.t[k] = p[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) o.q[k] = p[3 + k];
  return o;
}

// A keyframe row: negative indices wrap as the chain's gather does; one
// out of range reads row 0 (the chain would raise).
__device__ __forceinline__ int row_of(int i, int K) {
  if (i < 0) i += K;
  return (i >= 0 && i < K) ? i : 0;
}

__global__ void __launch_bounds__(kThreads)
    pp_edge_kernel(const Params p) {
  __shared__ float s_r6[kThreads * 6];
  __shared__ float s_Ji[kThreads * kPad];
  __shared__ float s_Jj[kThreads * kPad];
  const int tid = threadIdx.x;
  const int base = blockIdx.x * kThreads;
  const int e = base + tid;
  if (blockIdx.x == 0 && tid == 0) atomicAdd(p.counter, 1ull);
  if (e < p.E) {
    const int ri = row_of(p.pp_i[e], p.K);
    const int rj = row_of(p.pp_j[e], p.K);
    const Pose Ti = load_pose(p.kf_pose + 7 * ri);
    const Pose Tj = load_pose(p.kf_pose + 7 * rj);
    const Pose Z = load_pose(p.pp_rel + 7 * e);
    bool gate = p.pp_valid[e];
    if (p.kf_gen != nullptr)
      gate = gate && p.pp_gen_i[e] == p.kf_gen[ri] &&
             p.pp_gen_j[e] == p.kf_gen[rj];

    // r = log(Z⁻¹ ∘ (T_i⁻¹ ∘ T_j))
    float r[6];
    se3_log(compose(inverse(Z), compose(inverse(Ti), Tj)), r);

    // X, Y = the blocks of J_l⁻¹(−r): X = J_l⁻¹(−φ), Y = −(X·Q(−r))·X
    float xi[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) xi[k] = -r[k];
    const float mphi[3] = {xi[3], xi[4], xi[5]};
    const M3 X = jl_inv(mphi);
    const M3 Y = mneg(matmul(matmul(X, se3_Q(xi)), X));

    // B⁻¹ = T_j⁻¹ ∘ T_i; R, S = skew(t)·R
    const Pose Bi = compose(inverse(Tj), Ti);
    const M3 R = quat_to_matrix(Bi.q);
    const M3 S = matmul(skew(Bi.t), R);
    const M3 XR = matmul(X, R);
    const M3 U = madd(matmul(X, S), matmul(Y, R));

    float* ji = s_Ji + tid * kPad;
    float* jj = s_Jj + tid * kPad;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        jj[6 * a + b] = X.a[a][b];
        jj[6 * a + b + 3] = Y.a[a][b];
        jj[6 * (a + 3) + b] = 0.0f;
        jj[6 * (a + 3) + b + 3] = X.a[a][b];
        ji[6 * a + b] = -XR.a[a][b];
        ji[6 * a + b + 3] = -U.a[a][b];
        ji[6 * (a + 3) + b] = -0.0f;
        ji[6 * (a + 3) + b + 3] = -XR.a[a][b];
      }
#pragma unroll
    for (int k = 0; k < 6; ++k) s_r6[6 * tid + k] = r[k];

    // the weight: pp_w·gate, the squared error, the robust kernel
    const float w_info = mul(p.pp_w[e], gate ? 1.0f : 0.0f);
    float sq[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) sq[k] = mul(r[k], r[k]);
    const float s6 = add(add(add(sq[0], sq[4]), sq[2]),
                         add(add(sq[1], sq[5]), sq[3]));
    const float sq_pp = mul(w_info, s6);
    float rw = 1.0f;
    if (p.robust == 1) {
      rw = mul(__frcp_rn(add(mul(sq_pp, p.inv_delta2), 1.0f)), 1.0f);
    } else if (p.robust == 2) {
      const float err = __fsqrt_rn(clamp_min(sq_pp, 1e-20f));
      rw = err <= p.delta ? 1.0f : mul(__frcp_rn(err), p.delta);
    }
    p.sq_pp[e] = sq_pp;
    p.wpp[e] = mul(w_info, rw);
  }
  __syncthreads();

  // the block's rows, coalesced
  const int n = min(kThreads, p.E - base);
  for (int k = tid; k < 6 * n; k += kThreads) p.r6[6 * base + k] = s_r6[k];
  for (int k = tid; k < 36 * n; k += kThreads) {
    const int row = k / 36, col = k - 36 * row;
    p.Ji[36 * base + k] = s_Ji[row * kPad + col];
    p.Jj[36 * base + k] = s_Jj[row * kPad + col];
  }
}

}  // namespace

extern "C" {

// Loads the kernel and finds the counters on the current device (lazy
// module loading would load it at its first launch, which may lie inside
// a capture, where loading is not permitted).
int pp_edge_load() {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, pp_edge_kernel);
  if (err != cudaSuccess) return err;
  return find_launch_counters();
}

// kf_pose (K, 7) float32, kf_gen (K,) int32 or null; pp_i, pp_j (E,)
// int32, pp_rel (E, 7) float32, pp_w (E,) float32, pp_valid (E,) bool,
// pp_gen_i, pp_gen_j (E,) int32; robust 0 none, 1 cauchy, 2 huber with
// delta and inv_delta2 = 1 / float32(delta²), both float32. Out: r6 (E, 6),
// Ji, Jj (E, 6, 6), wpp, sq_pp (E,), float32. All contiguous on the
// current device.
int pp_edge_launch(const float* kf_pose, const int* kf_gen, const int* pp_i,
                   const int* pp_j, const float* pp_rel, const float* pp_w,
                   const bool* pp_valid, const int* pp_gen_i,
                   const int* pp_gen_j, int K, int E, int robust, float delta,
                   float inv_delta2, float* r6, float* Ji, float* Jj,
                   float* wpp, float* sq_pp, int counted,
                   cudaStream_t stream) {
  if (K < 1 || E < 1 || robust < 0 || robust >= kRobustModes)
    return cudaErrorInvalidValue;
  if (!launch_counters_found()) return cudaErrorInitializationError;
  const Params p{kf_pose, kf_gen, pp_i,  pp_j,       pp_rel, pp_w,
                 pp_valid, pp_gen_i, pp_gen_j, K,     E,      robust,
                 delta,   inv_delta2, r6,   Ji,       Jj,     wpp,
                 sq_pp,   launch_counter(counted)};
  const int blocks = (E + kThreads - 1) / kThreads;
  pp_edge_kernel<<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

int pp_edge_threads() { return kThreads; }
int pp_edge_robust_modes() { return kRobustModes; }

}  // extern "C"

LAUNCH_COUNTER_ENTRY_POINTS(pp_edge)
