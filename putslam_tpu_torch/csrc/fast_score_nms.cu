// FAST-9 score map + non-maximum suppression, fused, for Hopper (sm_90a).
//
// Replaces putslam_tpu/ops/fast_pallas.py::fast_score_nms (the Pallas TPU
// kernel, body `_kernel`). Contract: for a (H, W) float32 image in [0, 1],
// write `raw` = FAST-9 score map and `nms` = raw kept where it is the
// (2r+1)^2 window maximum and positive, both bit-exact with the plain
// PyTorch version in putslam_tpu_torch/ops/fast.py (fast_score_map, nms).
//
// What bounds it on the card: memory and launch latency. Each pixel reads
// 4 bytes and writes 8 (raw + nms); the four fr1 pyramid levels together
// move ~0.5 MB per frame, which the H100's HBM moves in well under a
// microsecond, so one launch costs more than its traffic. The design keeps
// every intermediate out of device memory: one 32x32 output tile per block,
// the gray window with its (3 + r)-pixel halo staged in shared memory
// (scaled by 255, zero outside the image, as the reference pads), the raw
// scores of the tile plus an r-pixel halo computed once into shared memory
// (-inf outside the image, the max-pool padding), then the window max.
//
// Bit-exactness: the SAD excess sums accumulate in offset order k = 0..15
// with round-to-nearest intrinsics, so nvcc cannot contract or reorder them
// (the library is also built with -fmad=false).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 32;     // output tile side
constexpr int kCircle = 3;    // Bresenham circle radius of FAST
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

// The 16 circle offsets (dx, dy), clockwise from 12 o'clock — the order of
// putslam_tpu/ops/fast.py FAST_OFFSETS; the bit index of each test.
__constant__ int kOffX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kOffY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ bool has_arc(int mask) {
  // some cyclic run of 9 consecutive set bits among the 16
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const int arc = ((0x1FF << s) | (0x1FF >> (16 - s))) & 0xFFFF;
    if ((mask & arc) == arc) return true;
  }
  return false;
}

__global__ void fast_score_nms_kernel(const float* __restrict__ gray,
                                      float* __restrict__ raw_out,
                                      float* __restrict__ nms_out,
                                      int H, int W, float t, int r) {
  extern __shared__ float smem[];
  const int gw = kTile + 2 * (kCircle + r);  // gray window side
  const int rw = kTile + 2 * r;              // raw window side
  float* g = smem;                           // gw * gw
  float* s = smem + gw * gw;                 // rw * rw

  const int tx0 = blockIdx.x * kTile;
  const int ty0 = blockIdx.y * kTile;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int nthreads = kThreadsX * kThreadsY;

  // 1. gray window, x255, zero outside the image
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

  // 2. raw FAST-9 scores over the tile and its r-pixel halo
  for (int i = tid; i < rw * rw; i += nthreads) {
    const int ry = i / rw;
    const int rx = i % rw;
    const int y = ty0 - r + ry;
    const int x = tx0 - r + rx;
    float score;
    if (y < 0 || y >= H || x < 0 || x >= W) {
      score = -CUDART_INF_F;  // max-pool padding
    } else if (y < kCircle || y >= H - kCircle || x < kCircle || x >= W - kCircle) {
      score = 0.0f;           // the circle leaves the image
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

  // 3. (2r+1)^2 window max and the NMS keep test, tile pixels only
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

}  // namespace

extern "C" int fast_score_nms_launch(const float* gray, float* raw, float* nms,
                                     int H, int W, float threshold,
                                     int nms_radius, void* stream) {
  const int gw = kTile + 2 * (kCircle + nms_radius);
  const int rw = kTile + 2 * nms_radius;
  const size_t smem = sizeof(float) * (size_t)(gw * gw + rw * rw);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fast_score_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  fast_score_nms_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      gray, raw, nms, H, W, threshold, nms_radius);
  return (int)cudaGetLastError();
}
