// The detector's keypoint chain for Hopper (sm_90a): from the FAST maps of
// every pyramid level to the detector's outputs and the descriptor
// product's bfloat16 input, in one call a frame (ops/keypoints.py::chain).
//
// Not a port of a TPU kernel: it replaces the ATen chain of
// frontend/detector.py::detect_and_describe between the FAST launch and
// the descriptor product (ops/keypoints.py::plain_chain), ~660 small
// launches a frame at the fr1 widths: per level the subtile grid cap
// (ops/fast.py::grid_topk: each subtile's first maximum of the NMS map,
// the level's budget of the strongest by a stable descending sort), the
// 3x3 parabola refine on the raw map, the border
// test, the scaling to level 0, and its 32x32 windows; then over all
// slots the nearest depth sample, the 8 fixed-point undistortion
// iterations, the unprojection and the depth gate.
//
// Two launches, no grid-wide synchronisation:
// * tiles: a warp a subtile of any level (a flat grid over the levels'
//   subtiles). The lanes walk the subtile in row-major order, each
//   keeping its first maximum; a shuffle reduction keeps the larger value,
//   the lower index on a tie (torch.amax / torch.argmax). Outside the
//   level's map a subtile reads 0, F.pad's zeros. Writes the candidate's
//   score and index within its subtile.
// * select: a warp a candidate of one level, a block's warps all of one
//   level, which stages its level's candidate scores in shared memory. A
//   warp counts the candidates that come before its own in
//   torch.sort(descending=True, stable=True)'s order (a larger score, or an
//   equal one at a lower index): that count is its slot, and a candidate
//   whose slot lies outside the budget stops. (A level has at least twice
//   its budget of subtiles, so _global_cap never pads; the host checks it.)
//   Lane 0 then runs the slot's chain of scalar
//   operations (refine, border, scale, depth, undistortion, unprojection,
//   gate) and writes its outputs, and the whole warp copies the slot's
//   window, a row of 32 floats a load, to its bfloat16 row (RNE).
//
// What bounds it: neither bytes (the maps, ~2.3 MB at fr1, read once; 1 MB
// of patches written) nor operations, but the two launches and the chains
// of dependent operations of a slot's lane 0 (~150 with two divisions an
// undistortion iteration). The ATen chain it replaces spent ~1.2 us of
// launch a node on ~660 nodes.
//
// Bit-exactness with the ATen chain on the card: every operation is a
// round-to-nearest intrinsic in the chain's order (the library is built
// with -fmad=false), divisions are IEEE (__fdiv_rn), and a division of a
// tensor by a Python float is, as ATen's CUDA kernel computes it, a
// product with the float32 reciprocal that the host computes
// (ops/keypoints.py::camera_floats). torch.round is rintf (to nearest,
// ties to even); the conversion to bfloat16 is __float2bfloat16_rn.
//
// Thread 0 of the select launch adds one to the launch counter on the card
// (launch_counter.cuh): one a call, which a CUDA graph's replay repeats.
//
// Plain C entry points, bound with ctypes; each returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "launch_counter.cuh"

namespace {

constexpr int kWarps = 8;               // warps a block, both kernels
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLevels = 8;
constexpr int kMaxCandidates = 12288;   // a level's, in shared memory
constexpr int kPatch = 32;
constexpr int kHalf = kPatch / 2;
constexpr int kLevelInts = 10;
constexpr int kLevelFloats = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Level {
  const float* img;   // the level's image (H, W)
  const float* raw;   // its FAST scores (H, W)
  const float* nms;   // their non-maximum suppression (H, W)
  int H, W;
  int budget;         // slots of the level
  int slot0;          // its first slot
  int nsh, nsw;       // subtile rows and columns
  int sub_h, sub_w;   // a subtile's height and width
  int cand0;          // its first candidate (= subtile) in the flat arrays
  int block0;         // its first block of the select launch
  float lo, u_hi, v_hi;   // the border test's bounds
  float scale;            // to level 0
};

struct Camera {
  float cu, cv, fu, fv, inv_fu, inv_fv, k1, k2, k3, p1, p2, min_depth,
      max_depth;
};

struct Params {
  Level lv[kMaxLevels];
  int n_levels;
  Camera cam;
  const float* depth;
  int depth_h, depth_w;
  float* uv;
  float* uv_undist;
  float* xyz;
  float* response;
  int* octave;
  bool* valid;
  bool* has_depth;
  __nv_bfloat16* patches;
  float* cand_score;
  int* cand_arg;
  unsigned long long* counter;
};

// The level whose range of `first` (cand0 or block0) holds `i`.
template <typename First>
__device__ __forceinline__ int level_of(const Params& p, int i, First first) {
  int l = 0;
#pragma unroll
  for (int k = 1; k < kMaxLevels; ++k)
    if (k < p.n_levels && i >= first(p.lv[k])) l = k;
  return l;
}

__global__ void __launch_bounds__(kThreads)
tiles_kernel(const Params p, int total) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= total) return;
  const Level& L =
      p.lv[level_of(p, c, [](const Level& v) { return v.cand0; })];
  const int s = c - L.cand0;
  const int ty = s / L.nsw;
  const int y0 = ty * L.sub_h;
  const int x0 = (s - ty * L.nsw) * L.sub_w;
  const int n = L.sub_h * L.sub_w;
  float best = -CUDART_INF_F;
  int arg = n;
  for (int f = lane; f < n; f += 32) {
    const int dy = f / L.sub_w;
    const int y = y0 + dy;
    const int x = x0 + (f - dy * L.sub_w);
    const float v = (y < L.H && x < L.W) ? __ldg(L.nms + (size_t)y * L.W + x)
                                         : 0.0f;
    if (v > best) {   // a lane's indices rise: its first maximum stays
      best = v;
      arg = f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(kFull, best, off);
    const int oa = __shfl_down_sync(kFull, arg, off);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  if (lane == 0) {
    p.cand_score[c] = best;
    p.cand_arg[c] = arg;
  }
}

// ATen's clamp of a float: NaN passes, else min(max(v, lo), hi).
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// fast.subpixel_refine's offset along one axis from the samples before
// (a), at (c) and after (b) the keypoint.
__device__ __forceinline__ float parabola(float a, float c, float b) {
  const float d = __fmul_rn(__fsub_rn(b, a), 0.5f);
  const float dd = __fadd_rn(__fsub_rn(b, __fmul_rn(c, 2.0f)), a);
  const float o = fabsf(dd) > 1e-6f ? __fdiv_rn(-d, dd) : 0.0f;
  return clampf(o, -0.5f, 0.5f);
}

// camera.py's radial factor and tangential terms of normalised (x, y).
struct Distortion {
  float radial, dx, dy;
};

__device__ __forceinline__ Distortion distortion(const Camera& c, float x,
                                                 float y) {
  const float r2 = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
  float t = __fmul_rn(r2, c.k3);
  t = __fmul_rn(r2, __fadd_rn(t, c.k2));
  t = __fmul_rn(r2, __fadd_rn(t, c.k1));
  Distortion d;
  d.radial = __fadd_rn(t, 1.0f);
  const float xy2 = __fmul_rn(__fmul_rn(x, 2.0f), y);
  d.dx = __fadd_rn(__fmul_rn(xy2, c.p1),
                   __fmul_rn(__fadd_rn(r2, __fmul_rn(__fmul_rn(x, 2.0f), x)),
                             c.p2));
  d.dy = __fadd_rn(__fmul_rn(xy2, c.p2),
                   __fmul_rn(__fadd_rn(r2, __fmul_rn(__fmul_rn(y, 2.0f), y)),
                             c.p1));
  return d;
}

__global__ void __launch_bounds__(kThreads) select_kernel(const Params p) {
  extern __shared__ float scores[];
  const int l =
      level_of(p, blockIdx.x, [](const Level& v) { return v.block0; });
  const Level& L = p.lv[l];
  const int n_cand = L.nsh * L.nsw;
  for (int i = threadIdx.x; i < n_cand; i += kThreads)
    scores[i] = p.cand_score[L.cand0 + i];
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(p.counter, 1ULL);

  const int w = (blockIdx.x - L.block0) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= n_cand) return;
  const float score = scores[w];
  int before = 0;
  for (int j = lane; j < n_cand; j += 32) {
    const float o = scores[j];
    before += (o > score || (o == score && j < w)) ? 1 : 0;
  }
  const int slot = __reduce_add_sync(kFull, before);
  if (slot >= L.budget) return;
  const int o = L.slot0 + slot;
  int u0 = 0, v0 = 0;       // the window's corner, lane 0's
  if (lane == 0) {
    const int arg = p.cand_arg[L.cand0 + w];
    const int ty = w / L.nsw;
    const int cy = ty * L.sub_h + arg / L.sub_w;
    const int cx = (w - ty * L.nsw) * L.sub_w + arg % L.sub_w;
    const bool top = score > 0.0f;
    float u = -1.0f, v = -1.0f;
    if (top) {   // fast.subpixel_refine on the raw map
      const int iu = clampi(cx, 1, L.W - 2);
      const int iv = clampi(cy, 1, L.H - 2);
      const float* r = L.raw + (size_t)iv * L.W + iu;
      const float s_c = r[0];
      const float ou = parabola(r[-1], s_c, r[1]);
      const float ov = parabola(r[-L.W], s_c, r[L.W]);
      u = __fadd_rn((float)cx, ou);
      v = __fadd_rn((float)cy, ov);
    }
    const bool valid =
        top && u >= L.lo && u <= L.u_hi && v >= L.lo && v <= L.v_hi;
    u0 = clampi((int)rintf(u) - kHalf, 0, L.W - kPatch);
    v0 = clampi((int)rintf(v) - kHalf, 0, L.H - kPatch);

    const Camera& c = p.cam;
    const float pu = __fmul_rn(u, L.scale);   // level-0 pixels
    const float pv = __fmul_rn(v, L.scale);
    const float z =
        p.depth[(size_t)clampi((int)rintf(pv), 0, p.depth_h - 1) *
                    p.depth_w +
                clampi((int)rintf(pu), 0, p.depth_w - 1)];
    // camera.undistort_pixels: normalise, 8 fixed-point steps, back
    const float xd = __fmul_rn(__fsub_rn(pu, c.cu), c.inv_fu);
    const float yd = __fmul_rn(__fsub_rn(pv, c.cv), c.inv_fv);
    float x = xd, y = yd;
#pragma unroll 1
    for (int it = 0; it < 8; ++it) {
      const Distortion d = distortion(c, x, y);
      x = __fdiv_rn(__fsub_rn(xd, d.dx), d.radial);
      y = __fdiv_rn(__fsub_rn(yd, d.dy), d.radial);
    }
    const float uu = __fadd_rn(__fmul_rn(x, c.fu), c.cu);
    const float vu = __fadd_rn(__fmul_rn(y, c.fv), c.cv);
    // camera.unproject of the undistorted pixels, the depth gate
    const float xn = __fmul_rn(__fsub_rn(uu, c.cu), c.inv_fu);
    const float yn = __fmul_rn(__fsub_rn(vu, c.cv), c.inv_fv);
    const bool has_depth = valid && z > c.min_depth && z < c.max_depth;

    p.uv[2 * o] = valid ? pu : -1.0f;
    p.uv[2 * o + 1] = valid ? pv : -1.0f;
    p.uv_undist[2 * o] = valid ? uu : -1.0f;
    p.uv_undist[2 * o + 1] = valid ? vu : -1.0f;
    p.xyz[3 * o] = has_depth ? __fmul_rn(xn, z) : 0.0f;
    p.xyz[3 * o + 1] = has_depth ? __fmul_rn(yn, z) : 0.0f;
    p.xyz[3 * o + 2] = has_depth ? z : 0.0f;
    p.response[o] = valid ? score : 0.0f;
    p.octave[o] = l;
    p.valid[o] = valid;
    p.has_depth[o] = has_depth;
  }
  // brief.extract_patches + brief.patch_matrix: a row of the window a load
  u0 = __shfl_sync(kFull, u0, 0);
  v0 = __shfl_sync(kFull, v0, 0);
  const float* src = L.img + (size_t)v0 * L.W + u0 + lane;
  __nv_bfloat16* dst = p.patches + (size_t)o * (kPatch * kPatch) + lane;
#pragma unroll 8
  for (int r = 0; r < kPatch; ++r)
    dst[r * kPatch] = __float2bfloat16_rn(__ldg(src + (size_t)r * L.W));
}

}  // namespace

extern "C" {

// Loads the kernels and finds the counters on the current device (lazy
// module loading would load them at their first launch, which may lie
// inside a capture, where loading is not permitted).
int keypoints_load() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, tiles_kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&attr, select_kernel);
  if (err != cudaSuccess) return err;
  return find_launch_counters();
}

// n_levels levels; ptrs: per level its image, raw map and NMS map (H, W)
// float32; ints: per level H, W, budget, slot0, nsh, nsw, sub_h, sub_w,
// cand0, block0; floats: per level the border test's low, u-high and
// v-high bounds and the scale to level 0; camera: cu, cv, fu, fv, 1/fu,
// 1/fv, k1, k2, k3, p1, p2, min_depth, max_depth. candidates: the levels'
// subtiles in all, blocks: the select launch's, max_candidates: the
// largest level's subtiles. depth (depth_h, depth_w) float32. Out, over
// the levels' slots n: uv, uv_undist (n, 2), xyz (n, 3), response (n,)
// float32, octave (n,) int32, valid, has_depth (n,) bool, patches (n,
// 1024) bfloat16; cand_score (candidates,) float32 and cand_arg
// (candidates,) int32 are scratch. All contiguous on the current device.
int keypoints_launch(int n_levels, const void* const* ptrs, const int* ints,
                     const float* floats, const float* camera,
                     int candidates, int blocks, int max_candidates,
                     const float* depth, int depth_h, int depth_w, float* uv,
                     float* uv_undist, float* xyz, float* response,
                     int* octave, bool* valid, bool* has_depth,
                     __nv_bfloat16* patches, float* cand_score,
                     int* cand_arg, int counted, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || candidates < 1 ||
      blocks < 1 || max_candidates < 1 || max_candidates > kMaxCandidates ||
      depth_h < 1 || depth_w < 1)
    return cudaErrorInvalidValue;
  if (!launch_counters_found()) return cudaErrorInitializationError;
  Params p;
  for (int i = 0; i < kMaxLevels; ++i) {
    const int j = i < n_levels ? i : 0;
    const int* n = ints + kLevelInts * j;
    const float* f = floats + kLevelFloats * j;
    Level& L = p.lv[i];
    L.img = static_cast<const float*>(ptrs[3 * j]);
    L.raw = static_cast<const float*>(ptrs[3 * j + 1]);
    L.nms = static_cast<const float*>(ptrs[3 * j + 2]);
    L.H = n[0];
    L.W = n[1];
    L.budget = n[2];
    L.slot0 = n[3];
    L.nsh = n[4];
    L.nsw = n[5];
    L.sub_h = n[6];
    L.sub_w = n[7];
    L.cand0 = n[8];
    L.block0 = n[9];
    L.lo = f[0];
    L.u_hi = f[1];
    L.v_hi = f[2];
    L.scale = f[3];
    if (L.H < kPatch || L.W < kPatch || L.budget < 1 || L.nsh < 1 ||
        L.nsw < 1 || L.sub_h < 1 || L.sub_w < 1 ||
        L.nsh * L.nsw < L.budget || L.nsh * L.nsw > max_candidates)
      return cudaErrorInvalidValue;
  }
  p.n_levels = n_levels;
  p.cam = Camera{camera[0], camera[1], camera[2],  camera[3], camera[4],
                 camera[5], camera[6], camera[7],  camera[8], camera[9],
                 camera[10], camera[11], camera[12]};
  p.depth = depth;
  p.depth_h = depth_h;
  p.depth_w = depth_w;
  p.uv = uv;
  p.uv_undist = uv_undist;
  p.xyz = xyz;
  p.response = response;
  p.octave = octave;
  p.valid = valid;
  p.has_depth = has_depth;
  p.patches = patches;
  p.cand_score = cand_score;
  p.cand_arg = cand_arg;
  p.counter = launch_counter(counted);
  tiles_kernel<<<(candidates + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      p, candidates);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  select_kernel<<<blocks, kThreads, sizeof(float) * max_candidates, stream>>>(
      p);
  return cudaGetLastError();
}

int keypoints_warps() { return kWarps; }

}  // extern "C"

LAUNCH_COUNTER_ENTRY_POINTS(keypoints)
