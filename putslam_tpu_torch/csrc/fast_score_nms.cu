// FAST-9 score map + non-maximum suppression, fused, for Hopper (sm_90a):
// the whole scale pyramid of a frame in one launch.
//
// Replaces putslam_tpu/ops/fast_pallas.py::fast_score_nms (the Pallas TPU
// kernel, body `_kernel`), which holds one whole level in VMEM. Contract, per
// level: for a (H, W) float32 image in [0, 1], write `raw` = FAST-9 score map
// and `nms` = raw kept where it is the (2r+1)^2 window maximum and positive,
// both bit-exact with the plain PyTorch version in
// putslam_tpu_torch/ops/fast.py (fast_score_map, nms).
//
// What bounds it on the card: memory. Each pixel reads 4 bytes and writes 8
// (raw + nms). The four fr1 levels (480x640, 339x453, 240x320, 170x226 =
// 575,987 pixels) move 6.91 MB per frame: 2.06 us at the H100's 3.35 TB/s,
// 1.10 us for level 0 alone (the fp32 work, ~200 operations a pixel, is
// 1.7 us at 67 TFLOP/s: bytes bound it). That is less than one launch's
// latency, so the design is about launches, balance and the amount of
// arithmetic; measured, the segment test's arithmetic and one block's
// load -> barrier -> store chain are what is left (PERF.md):
//
//  - One launch for all levels. A flat 1-D grid walks the tiles of every
//    level; a by-value parameter struct (<= 8 levels) maps a block to its
//    level, so nothing is allocated or copied for it. The small levels fill
//    the tail of the large one.
//  - 32 x 24 output tiles, 128 threads a block: at r = 3 a block evaluates
//    FAST on 38 x 30 pixels for 768 outputs (1.48x; a 64 x 32 tile: 1.30x,
//    but its 302 blocks balance worse over 132 SMs than these 789 and it
//    measured slower). Loop divisors are compile-time constants on the
//    r = 3 instantiation; the generic one takes any r in [0, 16].
//  - The gray window is staged in 16-, 8- or 4-byte pieces, chosen per level
//    from the row pitch and the pointers' alignment (640 and 320 columns take
//    16 bytes, 226 takes 8, 453 takes 4; never a misaligned vector access).
//    The window starts a multiple of 4 pixels left of the tile so that every
//    piece is wholly inside or wholly outside the image; outside is zero, as
//    the reference pads. x255 once per staged element, with __fmul_rn.
//    (cp.async staging measured no faster: with one tile a block there is
//    nothing to overlap inside a block.)
//  - The segment test with little arithmetic: each mask bit is a sign bit moved
//    in by one funnel shift (see fast9_score), the run of 9 is found with
//    shifts on the doubled 16-bit mask, and an excess sum is accumulated
//    only for a mask that has an arc. A pixel without an arc scores +0
//    either way, and adding the +0 terms of the other pixels changes no
//    bit, so the result is the reference's. (Both sums for every pixel, and
//    a pre-test on the four compass pixels, measured slower.)
//  - Separable window maximum: row maxima of the raw tile into shared memory
//    (over the dead gray window), then column maxima: 2(2r+1) reads per
//    output instead of (2r+1)^2. -inf outside the image, the max-pool padding.
//  - Outputs leave as 16-byte stores where the level allows it.
//
// Bit-exactness: the excess sums accumulate in offset order k = 0..15 with
// round-to-nearest intrinsics, so nvcc cannot contract or reorder them (the
// library is also built with -fmad=false); a maximum is exact in any order.
//
// One thread of block 0 adds one to the launch counter on the card
// (launch_counter.cuh).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "launch_counter.cuh"

namespace {

constexpr int kCircle = 3;        // Bresenham circle radius of FAST
constexpr int kThreads = 128;
constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 16;
constexpr int TW = 32;            // output tile
constexpr int TH = 24;

static_assert(TW % 4 == 0 && TW >= 16, "tile width");
static_assert(TH >= 4, "tile height");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "block size");

// The 16 circle pixels F(k, dx, dy), clockwise from 12 o'clock: the order of
// putslam_tpu_torch/ops/fast.py FAST_OFFSETS; k is the bit of each test.
#define FAST_COMPASS(F) F(0, 0, -3) F(4, 3, 0) F(8, 0, 3) F(12, -3, 0)
#define FAST_OTHERS(F)                                               \
  F(1, 1, -3) F(2, 2, -2) F(3, 3, -1) F(5, 3, 1) F(6, 2, 2) F(7, 1, 3) \
  F(9, -1, 3) F(10, -2, 2) F(11, -3, 1) F(13, -3, -1) F(14, -2, -2)    \
  F(15, -1, -3)

struct Level {
  const float* gray;
  float* raw;
  float* nms;
  int H, W;
  int tiles_x;      // tiles per row of tiles
  int first_tile;   // index of this level's first tile in the flat grid
  int vec;          // floats per access: 4, 2 or 1
};

struct Params {
  Level lv[kMaxLevels];
  int n_levels;
  int r;
  float t;
  unsigned long long* counter;
};

// some cyclic run of 9 consecutive set bits among the low 16
__device__ __forceinline__ bool has_arc(unsigned m) {
  const unsigned x = m | (m << 16);
  const unsigned a = x & (x >> 1);   // runs of 2
  const unsigned b = a & (a >> 2);   // runs of 4
  const unsigned c = b & (b >> 4);   // runs of 8
  return ((c & (x >> 8)) & 0xFFFFu) != 0u;
}

// Gray window x255 into g (gh rows of gw floats), zero outside the image.
// (gy0, gx0) is the window's origin in the image; gx0, gw and W are
// multiples of VEC, so a piece never straddles the image's edge.
template <int VEC>
__device__ __forceinline__ void stage_gray(float* g, const float* gray, int H,
                                           int W, int gy0, int gx0, int gh,
                                           int gw, int tid) {
  const int pieces = gw / VEC;
  for (int i = tid; i < gh * pieces; i += kThreads) {
    const int row = i / pieces;
    const int col = (i - row * pieces) * VEC;
    const int y = gy0 + row;
    const int x = gx0 + col;
    const bool inside = y >= 0 && y < H && x >= 0 && x < W;
    float* dst = g + row * gw + col;
    const float* src = inside ? gray + (size_t)y * W + x : gray;
    if (VEC == 4) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (inside) v = __ldg(reinterpret_cast<const float4*>(src));
      v.x = __fmul_rn(v.x, 255.0f);
      v.y = __fmul_rn(v.y, 255.0f);
      v.z = __fmul_rn(v.z, 255.0f);
      v.w = __fmul_rn(v.w, 255.0f);
      *reinterpret_cast<float4*>(dst) = v;
    } else if (VEC == 2) {
      float2 v = make_float2(0.0f, 0.0f);
      if (inside) v = __ldg(reinterpret_cast<const float2*>(src));
      v.x = __fmul_rn(v.x, 255.0f);
      v.y = __fmul_rn(v.y, 255.0f);
      *reinterpret_cast<float2*>(dst) = v;
    } else {
      dst[0] = inside ? __fmul_rn(__ldg(src), 255.0f) : 0.0f;
    }
  }
}

// FAST-9 score of the pixel whose x255 intensity is gc[0]; gw is g's pitch.
// With d = neighbour - centre, u = t - d is negative exactly where d > t and
// v = d + t exactly where d < -t (a float difference never rounds to zero),
// so each mask bit is the sign bit of u or v, shifted in with one funnel
// shift; and the excess terms max(d - t, 0), max(-d - t, 0) are max(-u, 0),
// max(-v, 0), since rounding to nearest is symmetric.
__device__ __forceinline__ float fast9_score(const float* gc, int gw,
                                             float t) {
  const float c = gc[0];
  float u[16], v[16];
#define FAST_DIFF(k, dx, dy)                              \
  {                                                       \
    const float d = __fsub_rn(gc[(dy) * gw + (dx)], c);   \
    u[k] = __fsub_rn(t, d);                               \
    v[k] = __fadd_rn(d, t);                               \
  }
  FAST_COMPASS(FAST_DIFF)
  FAST_OTHERS(FAST_DIFF)
#undef FAST_DIFF
  unsigned mb = 0u, md = 0u;
#pragma unroll
  for (int k = 15; k >= 0; --k) {   // bit k of a mask: the test of pixel k
    mb = __funnelshift_l(__float_as_uint(u[k]), mb, 1);
    md = __funnelshift_l(__float_as_uint(v[k]), md, 1);
  }
  const bool arc_b = has_arc(mb);
  const bool arc_d = has_arc(md);
  float eb = 0.0f, ed = 0.0f;
  if (arc_b) {
#pragma unroll
    for (int k = 0; k < 16; ++k) eb = __fadd_rn(eb, fmaxf(-u[k], 0.0f));
  }
  if (arc_d) {
#pragma unroll
    for (int k = 0; k < 16; ++k) ed = __fadd_rn(ed, fmaxf(-v[k], 0.0f));
  }
  return __fadd_rn(arc_b ? eb : 0.0f, arc_d ? ed : 0.0f);
}

__device__ __forceinline__ float keep_max(float c, float pooled) {
  return (c >= pooled && c > 0.0f) ? c : 0.0f;
}

// R >= 0: the radius as a compile-time constant; R < 0: read from p.r.
template <int R>
__global__ void __launch_bounds__(kThreads)
fast_score_nms_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int r = R >= 0 ? R : p.r;
  const int halo = kCircle + r;
  const int hl = (halo + 3) & ~3;    // left margin of the gray window, 4 | hl
  const int gw = TW + 2 * hl;        // gray window: pitch, rows
  const int gh = TH + 2 * halo;
  const int rw = TW + 2 * r;         // raw window: pitch, rows
  const int rh = TH + 2 * r;
  float* g = smem;                   // gh * gw, later the row maxima
  float* s = smem + gh * gw;         // rh * rw
  float* m = smem;                   // rh * TW, over the dead gray window

  // this block's level and tile
  const int bid = blockIdx.x;
  Level lv = p.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i < p.n_levels && bid >= p.lv[i].first_tile) lv = p.lv[i];
  const int tile = bid - lv.first_tile;
  const int tile_y = tile / lv.tiles_x;
  const int tx0 = (tile - tile_y * lv.tiles_x) * TW;
  const int ty0 = tile_y * TH;
  const int H = lv.H, W = lv.W;
  const int tid = threadIdx.x;
  if (bid == 0 && tid == 0) atomicAdd(p.counter, 1ULL);

  // 1. gray window, x255, zero outside the image
  if (lv.vec == 4)
    stage_gray<4>(g, lv.gray, H, W, ty0 - halo, tx0 - hl, gh, gw, tid);
  else if (lv.vec == 2)
    stage_gray<2>(g, lv.gray, H, W, ty0 - halo, tx0 - hl, gh, gw, tid);
  else
    stage_gray<1>(g, lv.gray, H, W, ty0 - halo, tx0 - hl, gh, gw, tid);
  __syncthreads();

  // 2. raw FAST-9 scores over the tile and its r-pixel halo
  for (int i = tid; i < rh * rw; i += kThreads) {
    const int ry = i / rw;
    const int rx = i - ry * rw;
    const int y = ty0 - r + ry;
    const int x = tx0 - r + rx;
    float score;
    if (y < 0 || y >= H || x < 0 || x >= W)
      score = -CUDART_INF_F;   // max-pool padding
    else if (y < kCircle || y >= H - kCircle || x < kCircle ||
             x >= W - kCircle)
      score = 0.0f;            // the circle leaves the image
    else
      score = fast9_score(g + (ry + kCircle) * gw + (rx + hl - r), gw, p.t);
    s[i] = score;
  }
  __syncthreads();

  // 3. row maxima of the raw window, for the tile's columns
  const int reach = 2 * r;
  for (int i = tid; i < rh * TW; i += kThreads) {
    const int ry = i / TW;
    const float* row = s + ry * rw + (i - ry * TW);
    float v = row[0];
    for (int dx = 1; dx <= reach; ++dx) v = fmaxf(v, row[dx]);
    m[i] = v;
  }
  __syncthreads();

  // 4. column maxima, the keep test and the stores, 4 pixels a thread
  constexpr int kGroups = TW / 4;
  for (int i = tid; i < TH * kGroups; i += kThreads) {
    const int oy = i / kGroups;
    const int ox = (i - oy * kGroups) * 4;
    const int y = ty0 + oy;
    const int x = tx0 + ox;
    if (y >= H || x >= W) continue;
    float4 pooled = *reinterpret_cast<const float4*>(m + oy * TW + ox);
    for (int dy = 1; dy <= reach; ++dy) {
      const float4 v =
          *reinterpret_cast<const float4*>(m + (oy + dy) * TW + ox);
      pooled.x = fmaxf(pooled.x, v.x);
      pooled.y = fmaxf(pooled.y, v.y);
      pooled.z = fmaxf(pooled.z, v.z);
      pooled.w = fmaxf(pooled.w, v.w);
    }
    const float* c = s + (oy + r) * rw + (ox + r);
    const float4 raw4 = make_float4(c[0], c[1], c[2], c[3]);
    const float4 nms4 =
        make_float4(keep_max(raw4.x, pooled.x), keep_max(raw4.y, pooled.y),
                    keep_max(raw4.z, pooled.z), keep_max(raw4.w, pooled.w));
    const size_t o = (size_t)y * W + x;
    if (lv.vec == 4) {          // 4 | W and 4 | x: the group is inside
      *reinterpret_cast<float4*>(lv.raw + o) = raw4;
      *reinterpret_cast<float4*>(lv.nms + o) = nms4;
    } else if (lv.vec == 2) {   // 2 | W and 2 | x: pairs are in or out
      *reinterpret_cast<float2*>(lv.raw + o) = make_float2(raw4.x, raw4.y);
      *reinterpret_cast<float2*>(lv.nms + o) = make_float2(nms4.x, nms4.y);
      if (x + 2 < W) {
        *reinterpret_cast<float2*>(lv.raw + o + 2) =
            make_float2(raw4.z, raw4.w);
        *reinterpret_cast<float2*>(lv.nms + o + 2) =
            make_float2(nms4.z, nms4.w);
      }
    } else {
      const float rv[4] = {raw4.x, raw4.y, raw4.z, raw4.w};
      const float nv[4] = {nms4.x, nms4.y, nms4.z, nms4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (x + j < W) {
          lv.raw[o + j] = rv[j];
          lv.nms[o + j] = nv[j];
        }
      }
    }
  }
}

size_t smem_bytes(int r) {
  const int halo = kCircle + r;
  const int hl = (halo + 3) & ~3;
  return sizeof(float) * (size_t)((TH + 2 * halo) * (TW + 2 * hl) +
                                  (TH + 2 * r) * (TW + 2 * r));
}

}  // namespace

extern "C" {

int fast_score_nms_tile_w() { return TW; }
int fast_score_nms_tile_h() { return TH; }

// Loads the kernels and finds the counters on the current device (lazy
// module loading would load them at their first launch, which may lie
// inside a capture, where loading is not permitted).
int fast_score_nms_load() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fast_score_nms_kernel<3>);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&attr, fast_score_nms_kernel<-1>);
  if (err != cudaSuccess) return err;
  return find_launch_counters();
}

// One launch over the tiles of n_levels images. The arrays are host arrays of
// n_levels entries; tiles_x / first_tile / total_tiles lay the tiles of all
// levels out on one flat grid (level 0 first), vec is 4, 2 or 1 floats per
// access as the level's pitch and pointers allow. Returns the CUDA error.
int fast_score_nms_levels_launch(
    int n_levels, const void* const* gray, void* const* raw, void* const* nms,
    const int* H, const int* W, const int* tiles_x, const int* first_tile,
    const int* vec, int total_tiles, float threshold, int nms_radius,
    int counted, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || nms_radius < 0 ||
      nms_radius > kMaxRadius || total_tiles < 1)
    return (int)cudaErrorInvalidValue;
  if (!launch_counters_found()) return (int)cudaErrorInitializationError;
  Params p;
  for (int i = 0; i < kMaxLevels; ++i) {
    const int j = i < n_levels ? i : 0;
    p.lv[i].gray = static_cast<const float*>(gray[j]);
    p.lv[i].raw = static_cast<float*>(raw[j]);
    p.lv[i].nms = static_cast<float*>(nms[j]);
    p.lv[i].H = H[j];
    p.lv[i].W = W[j];
    p.lv[i].tiles_x = tiles_x[j];
    p.lv[i].first_tile = first_tile[j];
    p.lv[i].vec = vec[j];
  }
  p.n_levels = n_levels;
  p.r = nms_radius;
  p.t = threshold;
  p.counter = launch_counter(counted);
  const size_t smem = smem_bytes(nms_radius);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nms_radius == 3) {
    static_assert(sizeof(float) * ((TH + 12) * (TW + 16) +
                                   (TH + 6) * (TW + 6)) <=
                      48 * 1024,
                  "the r = 3 tile must fit the default shared memory");
    fast_score_nms_kernel<3><<<total_tiles, kThreads, smem, st>>>(p);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          fast_score_nms_kernel<-1>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    fast_score_nms_kernel<-1><<<total_tiles, kThreads, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

LAUNCH_COUNTER_ENTRY_POINTS(fast_score_nms)
