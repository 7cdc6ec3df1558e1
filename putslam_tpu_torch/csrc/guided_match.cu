// Guided map matching for Hopper (sm_90a): each landmark's gates, its
// Hamming distances by popcount and its best frame feature in one launch
// (ops/guided_match.py::match, called by slam_map/features_map.py::
// guided_match).
//
// Not a port of a TPU kernel: it replaces the XLA fusion of
// putslam_tpu/slam_map/features_map.py's guided distances, which the port
// ran as an ATen chain (ops/guided_match.py::plain_match): the (L, N, 3)
// difference and its norm, the (N, L·D) float32 product of the ±1
// descriptors, 0.5·(256 − dot), the slot mask, the minimum over the slots,
// the gates, argmin / amin / topk over the features and the count, 55 ATen
// ops and ~1.3 GB of device memory traffic a call at the fr1 widths
// (L 8192 landmarks, D 4 slots, N 512 features).
//
// What bounds it: bytes. Its inputs are the map's descriptors (L·D·256
// int8, 8 MiB at fr1) and under half a megabyte else; nothing of size L × N
// reaches device memory. The operations (a sphere gate a pair, 4.2 M pairs;
// popcounts only on the pairs that pass it) are a fraction of a microsecond
// at the card's rates.
//
// One launch; a block of 32 warps, one block a multiprocessor:
// * the block packs the frame's descriptors into shared memory as two bit
//   planes a feature (its elements > 0 and < 0, 8 words each; a lane makes
//   one word from 32 bytes by shifts, masks and a gathering multiply, no
//   cross-lane step), with the features' points, octaves and depth flags;
// * a warp takes a landmark; every load of it (its D slots, 32 bytes a lane,
//   lane 8·(s mod 4) + k making word k of slot s; its slot flags, point,
//   octave and validity) starts a landmark ahead, the first one's before
//   the block packs. Lanes walk the features, a feature a lane, through the
//   depth, octave and sphere gates, four rounds of 32 at once; ballots give
//   the candidates, which the warp then takes in ascending feature order,
//   all 32 lanes on one: a lane a (slot, word), the dot product of the two
//   ternary planes by AND and popcount, summed over a slot's 8 lanes and
//   turned into 0.5·(256 − dot), the minimum over the used slots by
//   shuffles. A running first minimum (strict <, so the lowest index wins a
//   tie) and second value (duplicates counted, as topk gives them) follow.
//   Lane 0 writes the landmark's result; the count of landmarks with a
//   candidate is summed a block in shared memory, then one atomic a block.
//
// Bit-exactness with the ATen chain on the card: the difference lm_cam −
// xyz is __fsub_rn; the distance's square sums the three squares in the
// order of the card's torch.linalg.vector_norm over an innermost dim of 3
// (its reduce kernel gives that dim two threads: thread 0 sums elements 0
// and 2 in separate accumulators and combines them, the shuffle then adds
// thread 1's element 1), each square rounded, no FMA (the library is built
// with -fmad=false); the root is __fsqrt_rn. The radius, the Hamming gate
// and the acceptance ratio are float32, as ATen casts a Python scalar
// against a float32 tensor. Descriptors hold ±1 and 0 (the detector's and
// the map's): their dot is an exact integer either way, so 0.5·(256 − dot)
// is the chain's number.
//
// The launch adds one to the launch counter on the card
// (launch_counter.cuh).
//
// Plain C entry points, bound with ctypes; each returns a cudaError_t.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "launch_counter.cuh"

namespace {

constexpr int kWarps = 32;               // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kBits = 256;               // descriptor bits
constexpr int kWords = kBits / 32;       // words a bit plane
constexpr int kMaxViews = 8;             // descriptor slots a landmark
constexpr int kBatch = 8;                // feature rows a warp packs a round
constexpr int kChunk = 4;                // rounds of 32 gates at once
constexpr int kMaxFeatures = 2048;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFeatureBytes = 2 * kWords * 4 + 3 * 4 + 4 + 1;

struct Params {
  const float* lm_cam;         // (L, 3) landmarks in the camera frame
  const int8_t* lm_desc;       // (L, D, 256) ±1 / 0
  const bool* lm_slot_used;    // (L, D)
  const bool* lm_valid;        // (L,)
  const int* lm_octave;        // (L,)
  const float* xyz;            // (N, 3)
  const bool* has_depth;       // (N,)
  const int* octave;           // (N,)
  const int8_t* desc;          // (N, 256) ±1 / 0
  int L, D, N;
  float radius;                // the sphere gate, float32
  int octave_window;
  float max_dist;              // the Hamming gate, float32
  int ratio;                   // acceptance: 0 "hamming", 1 "ratio"
  float accept_ratio;          // matching_xyz_acceptance_ratio, float32
  int* feat_idx;               // (L,) out
  float* dist;                 // (L,) out
  bool* valid;                 // (L,) out
  int* n_candidates;           // () out, zeroed by the caller
  unsigned long long* counter;
};

// The square of the distance as the card's vector_norm sums it, then the
// correctly rounded root.
__device__ __forceinline__ float norm3(float x, float y, float z) {
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(z, z)),
                            __fmul_rn(y, y));
  return __fsqrt_rn(s);
}

// Word k of a row's two bit planes from its bytes 32k .. 32k + 31 (two
// 16-byte loads): bit j is element 32k + j, set in `neg` where the element
// is negative (its sign bit) and in `pos` where it is positive (for ±1 and
// 0: its low bit without the sign bit). A multiply gathers four bytes' bits
// (bits 0, 8, 16, 24 times 0x01020408 land on bits 24 .. 27).
__device__ __forceinline__ void planes_word(uint4 a, uint4 b, unsigned& pos,
                                            unsigned& neg) {
  const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  pos = neg = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned sign = (w[i] >> 7) & 0x01010101u;
    const unsigned one = w[i] & 0x01010101u & ~sign;
    neg |= ((sign * 0x01020408u) >> 24) << (4 * i);
    pos |= ((one * 0x01020408u) >> 24) << (4 * i);
  }
}

// One landmark's loads: lane 8·(s mod 4) + k of group s / 4 reads bytes
// 32k .. 32k + 31 of slot s; lane s < D its slot flag; every lane the
// point, octave and validity.
template <int G>
struct Landmark {
  uint4 lo[G], hi[G];
  bool used;
  bool valid;
  int octave;
  float x, y, z;
};

template <int G>
__device__ __forceinline__ void load_landmark(const Params& p, int l, int lane,
                                              Landmark<G>& t) {
  if (l >= p.L) return;
  const int8_t* row = p.lm_desc + (size_t)l * p.D * kBits;
#pragma unroll
  for (int g = 0; g < G; ++g)
    if (4 * g + (lane >> 3) < p.D) {
      const uint4* q = reinterpret_cast<const uint4*>(
          row + (4 * g + (lane >> 3)) * kBits + 32 * (lane & 7));
      t.lo[g] = __ldg(q);
      t.hi[g] = __ldg(q + 1);
    }
  t.used = lane < p.D && p.lm_slot_used[(size_t)l * p.D + lane];
  t.valid = p.lm_valid[l];
  t.octave = __ldg(p.lm_octave + l);
  t.x = __ldg(p.lm_cam + 3 * l);
  t.y = __ldg(p.lm_cam + 3 * l + 1);
  t.z = __ldg(p.lm_cam + 3 * l + 2);
}

// The distance of the landmark (lane 8·(s mod 4) + k holding word k of
// its slot s's planes, group s / 4) to feature f: the dot of the planes
// over a slot's 8 lanes, 0.5·(256 − dot), the minimum over the used slots.
template <int G>
__device__ __forceinline__ float distance(const unsigned* planes, int f,
                                          int lane, const unsigned* lpos,
                                          const unsigned* lneg,
                                          unsigned used, int D) {
  const unsigned* fw = planes + 2 * kWords * f;
  const unsigned fp = fw[lane & 7], fn = fw[kWords + (lane & 7)];
  float d = CUDART_INF_F;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    int dot = __popc(lpos[g] & fp) + __popc(lneg[g] & fn) -
              __popc(lpos[g] & fn) - __popc(lneg[g] & fp);
    dot += __shfl_xor_sync(kFull, dot, 1);
    dot += __shfl_xor_sync(kFull, dot, 2);
    dot += __shfl_xor_sync(kFull, dot, 4);
    const int s = 4 * g + (lane >> 3);
    float ham = s < D && (used >> s & 1u)
                    ? __fmul_rn(0.5f, __fsub_rn(256.0f, __int2float_rn(dot)))
                    : CUDART_INF_F;
    ham = fminf(ham, __shfl_xor_sync(kFull, ham, 8));
    ham = fminf(ham, __shfl_xor_sync(kFull, ham, 16));
    d = fminf(d, ham);
  }
  return d;
}

// G groups of four slots: D <= 4 G.
template <int G>
__global__ void __launch_bounds__(kThreads, 1)
    guided_match_kernel(const Params p) {
  extern __shared__ unsigned smem[];
  __shared__ int block_candidates;
  const int N = p.N, D = p.D;
  unsigned* planes = smem;                      // (N, 16): 8 pos, 8 neg
  float* fx = reinterpret_cast<float*>(planes + 2 * kWords * N);
  float* fy = fx + N;
  float* fz = fy + N;
  int* foct = reinterpret_cast<int*>(fz + N);
  unsigned char* fdep = reinterpret_cast<unsigned char*>(foct + N);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kWarps;

  // the first landmark's loads, in flight while the block packs
  int l = blockIdx.x * kWarps + warp;
  Landmark<G> cur;
  load_landmark(p, l, lane, cur);

  if (threadIdx.x == 0) {
    block_candidates = 0;
    if (blockIdx.x == 0) atomicAdd(p.counter, 1ULL);
  }
  for (int n = threadIdx.x; n < N; n += kThreads) {
    fx[n] = __ldg(p.xyz + 3 * n);
    fy[n] = __ldg(p.xyz + 3 * n + 1);
    fz[n] = __ldg(p.xyz + 3 * n + 2);
    foct[n] = __ldg(p.octave + n);
    fdep[n] = p.has_depth[n];
  }
  // the frame's planes: a lane a word (32 bytes), a warp kBatch rows a
  // round, their loads in flight together
  for (int r0 = warp * kBatch; r0 < N; r0 += kWarps * kBatch) {
    const uint4* q = reinterpret_cast<const uint4*>(p.desc);
    uint4 a[kBatch / 4], b[kBatch / 4];
#pragma unroll
    for (int i = 0; i < kBatch / 4; ++i) {
      const int e = 8 * r0 + 32 * i + lane;       // word e % 8 of row e / 8
      if (e < 8 * N) {
        a[i] = __ldg(q + 2 * e);
        b[i] = __ldg(q + 2 * e + 1);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch / 4; ++i) {
      const int e = 8 * r0 + 32 * i + lane;
      if (e < 8 * N) {
        unsigned pos, neg;
        planes_word(a[i], b[i], pos, neg);
        planes[2 * kWords * (e >> 3) + (e & 7)] = pos;
        planes[2 * kWords * (e >> 3) + kWords + (e & 7)] = neg;
      }
    }
  }
  __syncthreads();

  int found = 0;                     // landmarks with a candidate, lane 0
  const float inf = CUDART_INF_F;
  for (; l < p.L; l += stride) {
    unsigned lpos[G], lneg[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      lpos[g] = lneg[g] = 0u;
      if (4 * g + (lane >> 3) < D)
        planes_word(cur.lo[g], cur.hi[g], lpos[g], lneg[g]);
    }
    const unsigned used = __ballot_sync(kFull, cur.used);
    const bool valid = cur.valid;
    const int loct = cur.octave;
    const float cx = cur.x, cy = cur.y, cz = cur.z;
    load_landmark(p, l + stride, lane, cur);

    float m1 = inf, m2 = inf;        // the smallest two distances
    int i1 = 0;                      // the first feature at m1
    if (valid && used) {
      // kChunk rounds of 32 features: their gates at once, then their
      // candidates in ascending order
      for (int base = 0; base < N; base += 32 * kChunk) {
        unsigned cand[kChunk];
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const int n = min(base + 32 * i + lane, N - 1);
          const bool gate =
              (base + 32 * i + lane < N) & (fdep[n] != 0) &
              (abs(loct - foct[n]) <= p.octave_window) &
              (norm3(__fsub_rn(cx, fx[n]), __fsub_rn(cy, fy[n]),
                     __fsub_rn(cz, fz[n])) < p.radius);
          cand[i] = __ballot_sync(kFull, gate);
        }
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          unsigned c = cand[i];
          while (c) {
            const int f = base + 32 * i + __ffs(c) - 1;
            c &= c - 1;
            const float d =
                distance<G>(planes, f, lane, lpos, lneg, used, D);
            if (d < m1) {
              m2 = m1;
              m1 = d;
              i1 = f;
            } else if (d < m2) {
              m2 = d;
            }
          }
        }
      }
    }
    if (lane == 0) {
      const bool any = m1 < inf;
      bool ok;
      float best;
      if (p.ratio) {
        // topk of the two smallest with inf read as 1e9
        best = any ? m1 : 1e9f;
        const float second = m2 < inf ? m2 : 1e9f;
        const bool distinct =
            best <= __fmul_rn(p.accept_ratio, second) || second >= 1e9f;
        ok = best < 1e9f && best <= p.max_dist && distinct;
      } else {
        best = m1;
        ok = any && best <= p.max_dist;
      }
      p.feat_idx[l] = i1;
      p.dist[l] = ok ? best : inf;
      p.valid[l] = ok;
      found += any;
    }
  }
  if (lane == 0 && found) atomicAdd(&block_candidates, found);
  __syncthreads();
  if (threadIdx.x == 0 && block_candidates)
    atomicAdd(p.n_candidates, block_candidates);
}

// out[i] = the kernel's distance of the triple xyz[3i:3i+3] (its gate's
// norm, for the tests against torch.linalg.vector_norm).
__global__ void norm3_kernel(const float* xyz, float* out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = norm3(xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2]);
}

int n_sms = 0;

size_t shared_bytes(int n) { return (size_t)kFeatureBytes * n; }

}  // namespace

extern "C" {

// Loads the kernels, allows the largest shared memory and finds the
// counters and the number of multiprocessors on the current device (lazy
// module loading would load them at their first launch, which may lie
// inside a capture, where loading is not permitted).
int guided_match_load() {
  cudaError_t err = cudaFuncSetAttribute(
      guided_match_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shared_bytes(kMaxFeatures));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(guided_match_kernel<2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shared_bytes(kMaxFeatures));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, norm3_kernel);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return find_launch_counters();
}

// lm_cam (L, 3) float32, lm_desc (L, D, 256) int8, lm_slot_used (L, D),
// lm_valid (L,) bool, lm_octave (L,) int32; xyz (N, 3) float32, has_depth
// (N,) bool, octave (N,) int32, desc (N, 256) int8; the gates (radius,
// octave_window, max_dist) and the acceptance (ratio 0: "hamming", 1:
// "ratio" with accept_ratio). Out: feat_idx (L,) int32, dist (L,) float32,
// valid (L,) bool, n_candidates () int32, which must hold 0. All contiguous
// on the current device, the int8 tensors 16-byte aligned (read as uint4).
int guided_match_launch(const float* lm_cam, const int8_t* lm_desc,
                        const bool* lm_slot_used, const bool* lm_valid,
                        const int* lm_octave, const float* xyz,
                        const bool* has_depth, const int* octave,
                        const int8_t* desc, int L, int D, int N, float radius,
                        int octave_window, float max_dist, int ratio,
                        float accept_ratio, int* feat_idx, float* dist,
                        bool* valid, int* n_candidates, int counted,
                        cudaStream_t stream) {
  if (L < 1 || D < 1 || D > kMaxViews || N < 1 || N > kMaxFeatures)
    return cudaErrorInvalidValue;
  if (!launch_counters_found() || n_sms < 1)
    return cudaErrorInitializationError;
  const Params p{lm_cam,   lm_desc,   lm_slot_used, lm_valid,
                 lm_octave, xyz,      has_depth,    octave,
                 desc,     L,         D,            N,
                 radius,   octave_window, max_dist, ratio,
                 accept_ratio, feat_idx, dist,      valid,
                 n_candidates, launch_counter(counted)};
  int blocks = (L + kWarps - 1) / kWarps;
  if (blocks > n_sms) blocks = n_sms;
  if (D <= 4)
    guided_match_kernel<1><<<blocks, kThreads, shared_bytes(N), stream>>>(p);
  else
    guided_match_kernel<2><<<blocks, kThreads, shared_bytes(N), stream>>>(p);
  return cudaGetLastError();
}

// out (n,) float32 = the kernel's distance of each row of xyz (n, 3).
int guided_match_norm3(const float* xyz, float* out, long long n,
                       cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long blocks = (n + 255) / 256;
  norm3_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      xyz, out, n);
  return cudaGetLastError();
}

int guided_match_warps() { return kWarps; }
int guided_match_max_features() { return kMaxFeatures; }
int guided_match_max_views() { return kMaxViews; }

}  // extern "C"

LAUNCH_COUNTER_ENTRY_POINTS(guided_match)
