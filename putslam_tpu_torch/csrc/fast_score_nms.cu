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
//  - FAST_TILE_W x FAST_TILE_H output tiles, FAST_THREADS threads a block
//    (32 x 24, 128 by default): at r = 3 a block evaluates FAST on 38 x 30
//    pixels for 768 outputs (1.48x; a 64 x 32 tile: 1.30x, but its 302
//    blocks balance worse over 132 SMs than these 789 and it measured
//    slower). Loop divisors are compile-time constants on the r = 3
//    instantiation; the generic one takes any r in [0, 16].
//  - The gray window is staged in 16-, 8- or 4-byte pieces, chosen per level
//    from the row pitch and the pointers' alignment (640 and 320 columns take
//    16 bytes, 226 takes 8, 453 takes 4; never a misaligned vector access).
//    The window starts a multiple of 4 pixels left of the tile so that every
//    piece is wholly inside or wholly outside the image; outside is zero, as
//    the reference pads. x255 once per staged element, with __fmul_rn.
//    With FAST_STAGE_CP_ASYNC=1 the pieces go through cp.async (its zero-fill
//    form gives the padding) and are scaled in shared memory afterwards; with
//    one tile a block there is nothing to overlap inside a block (the blocks
//    resident on an SM overlap each other), and it measured no faster.
//  - The segment test with little arithmetic: each mask bit is a sign bit moved
//    in by one funnel shift (see fast9_score), the run of 9 is found with
//    shifts on the doubled 16-bit mask, and with FAST_EARLY_OUT >= 1 an
//    excess sum is accumulated only for a mask that has an arc. A pixel
//    without an arc scores +0 either way, and adding the +0 terms of the
//    other pixels changes no bit, so the result is the reference's.
//    FAST_EARLY_OUT = 2 adds a pre-test on the four compass pixels (any arc
//    of 9 holds at least two of them) before the other 12 are read.
//  - Separable window maximum: row maxima of the raw tile into shared memory
//    (over the dead gray window), then column maxima: 2(2r+1) reads per
//    output instead of (2r+1)^2. -inf outside the image, the max-pool padding.
//  - Outputs leave as 16-byte stores where the level allows it.
//
// Bit-exactness: the excess sums accumulate in offset order k = 0..15 with
// round-to-nearest intrinsics, so nvcc cannot contract or reorder them (the
// library is also built with -fmad=false); a maximum is exact in any order.
//
// The macros below are build-time variants for measurement (chip_smoke.py
// times them in turns in one call); their defaults are what the main path
// runs. The 32 x 32-tile kernel of the first port is kept at the end of the
// file under its own entry point as the in-call yardstick; nothing on the
// main path calls it.

#include <cuda_runtime.h>
#include <math_constants.h>

#ifndef FAST_TILE_W
#define FAST_TILE_W 32
#endif
#ifndef FAST_TILE_H
#define FAST_TILE_H 24
#endif
#ifndef FAST_THREADS
#define FAST_THREADS 128
#endif
// 0: plain vector loads, scaled on the way into shared memory; 1: cp.async
#ifndef FAST_STAGE_CP_ASYNC
#define FAST_STAGE_CP_ASYNC 0
#endif
// 0: both excess sums for every pixel; 1: sums only for a mask with an arc;
// 2: also the compass pre-test before the other 12 circle pixels are read
#ifndef FAST_EARLY_OUT
#define FAST_EARLY_OUT 1
#endif
// For timing only, the results are then wrong: leave out 1 the segment test
// (the score is the gray value), 2 the window maxima, 4 the stores; a sum of
// these leaves out each. What is left at 7 is the launch and the staging.
#ifndef FAST_ABLATE
#define FAST_ABLATE 0
#endif

static_assert(FAST_TILE_W % 4 == 0 && FAST_TILE_W >= 16, "tile width");
static_assert(FAST_TILE_H >= 4, "tile height");
static_assert(FAST_THREADS % 32 == 0 && FAST_THREADS <= 1024, "block size");

namespace {

constexpr int kCircle = 3;        // Bresenham circle radius of FAST
constexpr int kThreads = FAST_THREADS;
constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 16;
constexpr int TW = FAST_TILE_W;
constexpr int TH = FAST_TILE_H;

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
};

// some cyclic run of 9 consecutive set bits among the low 16
__device__ __forceinline__ bool has_arc(unsigned m) {
  const unsigned x = m | (m << 16);
  const unsigned a = x & (x >> 1);   // runs of 2
  const unsigned b = a & (a >> 2);   // runs of 4
  const unsigned c = b & (b >> 4);   // runs of 8
  return ((c & (x >> 8)) & 0xFFFFu) != 0u;
}

#if FAST_STAGE_CP_ASYNC
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(float* dst, const float* src,
                                               bool inside) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = inside ? BYTES : 0;   // the rest of the piece is zero-filled
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else if (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void scale255(float* p, int n) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) p[j] = __fmul_rn(p[j], 255.0f);
}
#endif

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
#if FAST_STAGE_CP_ASYNC
    cp_async_zfill<4 * VEC>(dst, src, inside);
#else
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
#endif
  }
#if FAST_STAGE_CP_ASYNC
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // each thread scales the pieces it copied itself: no barrier needed yet
  for (int i = tid; i < gh * pieces; i += kThreads) {
    const int row = i / pieces;
    scale255(g + row * gw + (i - row * pieces) * VEC, VEC);
  }
#endif
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
#if FAST_EARLY_OUT >= 2
  // an arc of 9 of the 16 holds at least two of the four compass pixels
  if ((u[0] < 0.0f) + (u[4] < 0.0f) + (u[8] < 0.0f) + (u[12] < 0.0f) < 2 &&
      (v[0] < 0.0f) + (v[4] < 0.0f) + (v[8] < 0.0f) + (v[12] < 0.0f) < 2)
    return 0.0f;
#endif
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
#if FAST_EARLY_OUT >= 1
  if (arc_b) {
#pragma unroll
    for (int k = 0; k < 16; ++k) eb = __fadd_rn(eb, fmaxf(-u[k], 0.0f));
  }
  if (arc_d) {
#pragma unroll
    for (int k = 0; k < 16; ++k) ed = __fadd_rn(ed, fmaxf(-v[k], 0.0f));
  }
#else
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    eb = __fadd_rn(eb, fmaxf(-u[k], 0.0f));
    ed = __fadd_rn(ed, fmaxf(-v[k], 0.0f));
  }
#endif
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
    else if (FAST_ABLATE & 1)
      score = g[(ry + kCircle) * gw + (rx + hl - r)];
    else
      score = fast9_score(g + (ry + kCircle) * gw + (rx + hl - r), gw, p.t);
    s[i] = score;
  }
  __syncthreads();

  // 3. row maxima of the raw window, for the tile's columns
  const int reach = (FAST_ABLATE & 2) ? 0 : 2 * r;
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
    if ((FAST_ABLATE & 4) && raw4.x != -1.0f) continue;   // never -1: no store
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

extern "C" int fast_score_nms_tile_w() { return TW; }
extern "C" int fast_score_nms_tile_h() { return TH; }

// One launch over the tiles of n_levels images. The arrays are host arrays of
// n_levels entries; tiles_x / first_tile / total_tiles lay the tiles of all
// levels out on one flat grid (level 0 first), vec is 4, 2 or 1 floats per
// access as the level's pitch and pointers allow. Returns the CUDA error.
extern "C" int fast_score_nms_levels_launch(
    int n_levels, const void* const* gray, void* const* raw, void* const* nms,
    const int* H, const int* W, const int* tiles_x, const int* first_tile,
    const int* vec, int total_tiles, float threshold, int nms_radius,
    void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || nms_radius < 0 ||
      nms_radius > kMaxRadius || total_tiles < 1)
    return (int)cudaErrorInvalidValue;
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
  const size_t smem = smem_bytes(nms_radius);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nms_radius == 3) {
    static_assert(sizeof(float) * ((FAST_TILE_H + 12) * (FAST_TILE_W + 16) +
                                   (FAST_TILE_H + 6) * (FAST_TILE_W + 6)) <=
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

// ---------------------------------------------------------------------------
// The kernel of the first port: one launch per level, 32 x 32 tiles, scalar
// loads, the arc test as 16 mask compares, a (2r+1)^2 window maximum. Kept
// only as the yardstick that chip_smoke.py and the card-only test time and
// compare against in the same call; nothing on the main path calls it.

namespace tile32 {

constexpr int kTile = 32;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

__constant__ int kOffX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kOffY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ bool has_arc(int mask) {
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const int arc = ((0x1FF << s) | (0x1FF >> (16 - s))) & 0xFFFF;
    if ((mask & arc) == arc) return true;
  }
  return false;
}

__global__ void kernel(const float* __restrict__ gray,
                       float* __restrict__ raw_out,
                       float* __restrict__ nms_out, int H, int W, float t,
                       int r) {
  extern __shared__ float smem[];
  const int gw = kTile + 2 * (kCircle + r);  // gray window side
  const int rw = kTile + 2 * r;              // raw window side
  float* g = smem;                           // gw * gw
  float* s = smem + gw * gw;                 // rw * rw

  const int tx0 = blockIdx.x * kTile;
  const int ty0 = blockIdx.y * kTile;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int nthreads = kThreadsX * kThreadsY;

  const int gy0 = ty0 - kCircle - r;
  const int gx0 = tx0 - kCircle - r;
  for (int i = tid; i < gw * gw; i += nthreads) {
    const int y = gy0 + i / gw;
    const int x = gx0 + i % gw;
    float v = 0.0f;
    if (y >= 0 && y < H && x >= 0 && x < W) v = __fmul_rn(gray[y * W + x], 255.0f);
    g[i] = v;
  }
  __syncthreads();

  for (int i = tid; i < rw * rw; i += nthreads) {
    const int ry = i / rw;
    const int rx = i % rw;
    const int y = ty0 - r + ry;
    const int x = tx0 - r + rx;
    float score;
    if (y < 0 || y >= H || x < 0 || x >= W) {
      score = -CUDART_INF_F;
    } else if (y < kCircle || y >= H - kCircle || x < kCircle || x >= W - kCircle) {
      score = 0.0f;
    } else {
      const int cy = ry + kCircle;
      const int cx = rx + kCircle;
      const float c = g[cy * gw + cx];
      int mask_b = 0, mask_d = 0;
      float excess_b = 0.0f, excess_d = 0.0f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float nb = g[(cy + kOffY[k]) * gw + (cx + kOffX[k])];
        const float diff = __fsub_rn(nb, c);
        mask_b |= (diff > t) << k;
        mask_d |= (diff < -t) << k;
        excess_b = __fadd_rn(excess_b, fmaxf(__fsub_rn(diff, t), 0.0f));
        excess_d = __fadd_rn(excess_d, fmaxf(__fsub_rn(-diff, t), 0.0f));
      }
      const float sb = has_arc(mask_b) ? excess_b : 0.0f;
      const float sd = has_arc(mask_d) ? excess_d : 0.0f;
      score = __fadd_rn(sb, sd);
    }
    s[i] = score;
  }
  __syncthreads();

  for (int i = tid; i < kTile * kTile; i += nthreads) {
    const int oy = i / kTile;
    const int ox = i % kTile;
    const int y = ty0 + oy;
    const int x = tx0 + ox;
    if (y >= H || x >= W) continue;
    const float center = s[(oy + r) * rw + (ox + r)];
    float pooled = -CUDART_INF_F;
    for (int dy = 0; dy <= 2 * r; ++dy) {
      const float* row = s + (oy + dy) * rw + ox;
      for (int dx = 0; dx <= 2 * r; ++dx) pooled = fmaxf(pooled, row[dx]);
    }
    raw_out[y * W + x] = center;
    nms_out[y * W + x] = (center >= pooled && center > 0.0f) ? center : 0.0f;
  }
}

}  // namespace tile32

extern "C" int fast_score_nms_tile32_launch(const float* gray, float* raw,
                                            float* nms, int H, int W,
                                            float threshold, int nms_radius,
                                            void* stream) {
  const int gw = tile32::kTile + 2 * (kCircle + nms_radius);
  const int rw = tile32::kTile + 2 * nms_radius;
  const size_t smem = sizeof(float) * (size_t)(gw * gw + rw * rw);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tile32::kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(tile32::kThreadsX, tile32::kThreadsY);
  const dim3 grid((W + tile32::kTile - 1) / tile32::kTile,
                  (H + tile32::kTile - 1) / tile32::kTile);
  tile32::kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      gray, raw, nms, H, W, threshold, nms_radius);
  return (int)cudaGetLastError();
}
