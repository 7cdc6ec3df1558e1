// RANSAC's hypotheses for Hopper (sm_90a): the sampled fit of every
// hypothesis and its score against all matches in ONE launch a RANSAC
// call (ops/ransac_score.py::hypotheses), and the same score for given
// poses (ops/ransac_score.py::score, the refit passes).
//
// Not a port of a TPU kernel: there is no Pallas kernel here. It replaces
// what XLA fuses of putslam_tpu/frontend/ransac.py:135-149 (the (H, N)
// error pass of _pair_errors, the inlier mask, the count and the masked
// error sum of each hypothesis; the same for each refit's pose), which
// the port ran op by op (~180 ATen launches a RANSAC call at the fr1
// widths), and, in the hypotheses mode, the sampled fit of
// csrc/kabsch_fit.cu and the six index launches that gathered its samples.
//
// Two modes, one kernel:
// * hypotheses: p, q (N, 3), valid (N,), the sampler's idx (k, H) int64
//   and, for error_version 3, optional info (N, 3, 3) (the upper triangle
//   is read). Each hypothesis is fitted by one lane, which gathers its k
//   samples itself and runs horn_fit.cuh::sampled_fit (the operations of
//   ops/kabsch.py::plain_kabsch_soa), writes the pose to T (H, 7) and to
//   shared memory; then the pose is scored.
// * score: the same scoring for given poses T (B, 7).
// Scoring a pose (ops/ransac_score.py::plain_score): its warps walk the N
// matches 32 at a time, write the inlier row (err < thr and valid), count
// it with ballots (added across the warps in shared memory: integers, in
// any order the same) and stash the masked errors in shared memory; after
// a barrier one warp sums the stash in the order of ATen's CPU sum of a
// contiguous row (warp_inner_sum, ops/kabsch.py::inner_sum). All five
// error models (error_version 0-4), each operation a round-to-nearest
// intrinsic in the plain version's order.
//
// A block is kTile warps (16) and takes kPoses poses (8; 128 blocks at
// H 1024, one wave on 132 SMs), `group` warps a pose (2). In the
// hypotheses mode the block's 8 fits run on 8 lanes of warp 0, one
// instruction stream, while the other warps stage p, q, valid (and info's
// six entries) of up to kStaged matches in shared memory. With fewer
// poses the warps split further: a refit's single pose is scored by all
// 16 warps, each reading its 32 matches from device memory (no stage),
// the one pass over the matches the sum waits for. A row longer than
// kStaged is read from device memory, and its masked errors go to a
// scratch buffer in device memory instead of the stash.
//
// What bounds it: not bytes (~0.6 MB at H 1024, N 512, most of it the
// inlier rows) and not operations (~25 M float operations of the plain
// version: ~0.4 us at the card's float32 rate), but chains of dependent
// operations and instruction issue: a fit is Horn's ~600 dependent
// operations, a match's error ~30 with a square root, the sum a fixed
// order of N / 32 adds a lane and the merges. The design removes what lay
// around them: the launch and the gathers before the fit, the round trip
// of T, and the ~180 launches of the scoring pass. Three things it does
// for the H100: the 1,024 fits are 128 instruction streams of 8 lanes,
// not 1,024 warps each repeating one fit, which cost issue slots the
// scoring needs; two warps a pose and sixteen a block hide the latency of
// a match's chain; and the error is computed once a match (the stash), so
// the five models' code is inlined once: a copy in each of the sum's
// unrolled loads overflowed the instruction cache.
//
// Thread 0 of each launch adds one to the launch counter of its mode on
// the card (launch_counter.cuh): hypotheses, score.
//
// Plain C entry points, bound with ctypes; each returns a cudaError_t.

#include <cuda_runtime.h>

#include "horn_fit.cuh"

#define LAUNCH_MODES 2
#include "launch_counter.cuh"

namespace {

constexpr int kTile = 16;            // warps of a block
constexpr int kPoses = 8;            // poses a block (fewer: more warps each)
static_assert(kTile % kPoses == 0 && kTile <= 32, "warps of a block");
constexpr int kStaged = 1024;        // matches staged in shared memory
constexpr int kHypotheses = 0, kScore = 1;   // the modes, their counters
// the most shared memory a block uses: p, q, info's six entries and valid
// of kStaged matches, their masked errors under kPoses poses, the poses
// and their counts
constexpr int kMaxShared =
    (3 + 3 + 6 + kPoses) * kStaged * 4 + kStaged + kPoses * (7 + 1) * 4;

// ops/ransac_score.py::ScoreModel, the Python floats cast to float
struct Model {
  int version;
  float thr_euclidean, thr_reprojection, thr_mahalanobis, fu, fv;
};

// The matches as a block reads them: p, q (3 floats a match), valid (a
// byte) and info's upper triangle (00, 01, 02, 11, 12, 22), six floats a
// match where staged, the nine of (3, 3) where read from global memory.
struct Matches {
  const float* p;
  const float* q;
  const unsigned char* valid;
  const float* info;           // nullptr: none
  bool six;

  __device__ __forceinline__ float upper(int m, int e) const {
    return six ? info[6 * m + e]
               : info[9 * m + (e < 3 ? e : (e == 5 ? 8 : e + 1))];
  }
};

// the reprojection error (ops/ransac_score.py::plain_errors::reproj_err)
__device__ __forceinline__ float reprojection(const Model& M, float x,
                                              float y, float z, float ox,
                                              float oy, float oz) {
  const float tiny = (float)1e-9;
  const float zp = fabsf(z) < tiny ? tiny : z;
  const float zo = fabsf(oz) < tiny ? tiny : oz;
  const float du = mul(M.fu, sub(dv(x, zp), dv(ox, zo)));
  const float dw = mul(M.fv, sub(dv(y, zp), dv(oy, zo)));
  return __fsqrt_rn(add(mul(du, du), mul(dw, dw)));
}

// The error of match m under the pose T (ops/ransac_score.py::
// plain_errors: se3.apply_soa, then the model); *in: err < thr and valid.
__device__ __forceinline__ float pair_error(const Model& M, const float* T,
                                            const Matches& s, int m,
                                            bool* in) {
  const float px = s.p[3 * m], py = s.p[3 * m + 1], pz = s.p[3 * m + 2];
  const float rw = T[3], rx = T[4], ry = T[5], rz = T[6];
  const float tx = mul(sub(mul(ry, pz), mul(rz, py)), 2.0f);
  const float ty = mul(sub(mul(rz, px), mul(rx, pz)), 2.0f);
  const float tz = mul(sub(mul(rx, py), mul(ry, px)), 2.0f);
  const float x = add(add(add(px, mul(rw, tx)), sub(mul(ry, tz), mul(rz, ty))),
                      T[0]);
  const float y = add(add(add(py, mul(rw, ty)), sub(mul(rz, tx), mul(rx, tz))),
                      T[1]);
  const float z = add(add(add(pz, mul(rw, tz)), sub(mul(rx, ty), mul(ry, tx))),
                      T[2]);
  const float ox = s.q[3 * m], oy = s.q[3 * m + 1], oz = s.q[3 * m + 2];
  const float dx = sub(x, ox), dy = sub(y, oy), dz = sub(z, oz);
  const float sq = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
  float err, thr;
  switch (M.version) {
    case 0:
      err = __fsqrt_rn(sq);
      thr = M.thr_euclidean;
      break;
    case 4:                            // the threshold grows with depth
      err = __fsqrt_rn(sq);
      thr = mul(M.thr_euclidean, clamp_min(oz, 1.0f));
      break;
    case 1:
      err = reprojection(M, x, y, z, ox, oy, oz);
      thr = M.thr_reprojection;
      break;
    case 2:                            // inlier iff both pass
      err = maximum(dv(__fsqrt_rn(sq), M.thr_euclidean),
                    dv(reprojection(M, x, y, z, ox, oy, oz),
                       M.thr_reprojection));
      thr = 1.0f;
      break;
    default:                           // 3, Mahalanobis
      if (s.info == nullptr) {
        err = sq;
      } else {
        const float diag = add(add(mul(mul(s.upper(m, 0), dx), dx),
                                   mul(mul(s.upper(m, 3), dy), dy)),
                               mul(mul(s.upper(m, 5), dz), dz));
        const float off = add(add(mul(mul(s.upper(m, 1), dx), dy),
                                  mul(mul(s.upper(m, 2), dx), dz)),
                              mul(mul(s.upper(m, 4), dy), dz));
        err = add(diag, mul(off, 2.0f));
      }
      thr = M.thr_mahalanobis;
  }
  *in = err < thr && s.valid[m] != 0;
  return err;
}

// How a launch lays out its blocks: `group` warps score a pose, kTile /
// group poses a block (kPoses; fewer, each with more warps, where there
// are fewer poses); whether the block stages the matches (more than one
// pose a block, at most kStaged matches) and stashes the masked errors in
// shared memory (at most kStaged matches; a longer row's go to the
// caller's scratch in device memory); its shared bytes.
struct Layout {
  int group;
  bool staged, stash;
  size_t shared;
};

Layout layout(int n, long long count, bool has_info) {
  Layout L;
  L.group = kTile / kPoses;
  while (L.group < kTile && (long long)L.group * 2 * count <= kTile)
    L.group *= 2;
  const int poses = kTile / L.group;
  L.staged = n <= kStaged && poses > 1;
  L.stash = n <= kStaged;
  L.shared = (L.staged ? (size_t)(3 + 3 + (has_info ? 6 : 0)) * n * 4 + n
                       : 0) +
             (L.stash ? (size_t)poses * n * 4 : 0) + (size_t)poses * 8 * 4;
  return L;
}

// kFit: the hypotheses mode (kN > 0: k samples a hypothesis, known when
// compiled; 0: k at run time); else the score mode.
template <bool kFit, int kN>
__global__ void __launch_bounds__(kTile * 32)
ransac_score_kernel(const float* __restrict__ p, const float* __restrict__ q,
                    const unsigned char* __restrict__ valid,
                    const float* __restrict__ info,
                    const long long* __restrict__ idx, int k,
                    const float* __restrict__ poses, int n, long long count,
                    int n_sq, Model model, Layout L,
                    float* __restrict__ scratch,
                    float* __restrict__ T_out, unsigned char* __restrict__ inl,
                    long long* __restrict__ counts,
                    float* __restrict__ err_sum,
                    unsigned long long* counter) {
  // shared: [p, q, info (staged)] [the stashed errors of each pose] [the
  // poses] [their inlier counts] [valid (staged)]
  extern __shared__ float shared[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_block = kTile / L.group;
  const int slot = warp / L.group, sub = warp % L.group;
  const long long first = (long long)blockIdx.x * per_block;
  const long long h = first + slot;
  const bool live = h < count;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(counter, 1ULL);

  float* sp = shared;
  float* sq = sp + 3 * n;
  float* si = sq + 3 * n;
  float* stash = L.staged ? si + (info ? 6 * n : 0) : shared;
  float* sT = stash + (L.stash ? per_block * n : 0);
  int* inliers = reinterpret_cast<int*>(sT + 7 * per_block);
  unsigned char* sv = reinterpret_cast<unsigned char*>(inliers + per_block);
  if (threadIdx.x < per_block) inliers[threadIdx.x] = 0;

  // the block's poses: in the hypotheses mode lane j of warp 0 fits
  // hypothesis first + j from its samples in device memory, one
  // instruction stream for the block's fits (horn_fit.cuh::sampled_fit, a
  // long chain of dependent operations), while the other warps stage the
  // matches; in the score mode they are read
  int stager = threadIdx.x, stagers = blockDim.x;
  if (kFit) {
    stager -= 32;
    stagers -= 32;
    const long long hl = first + lane;
    if (warp == 0 && lane < per_block && hl < count) {
      float T[7];
      sampled_fit(kN > 0 ? kN : k, n_sq, [&](int c, int j) {
        const long long i = idx[j * count + hl];
        return c < 3 ? p[3 * i + c] : q[3 * i + c - 3];
      }, T);
      for (int c = 0; c < 7; ++c) {
        sT[7 * lane + c] = T[c];
        T_out[7 * hl + c] = T[c];
      }
    }
  } else {
    for (int i = threadIdx.x; i < 7 * per_block; i += blockDim.x)
      if (first + i / 7 < count) sT[i] = poses[7 * first + i];
  }
  Matches s{p, q, valid, info, false};
  if (L.staged && stager >= 0) {
    for (int i = stager; i < 3 * n; i += stagers) {
      sp[i] = p[i];
      sq[i] = q[i];
    }
    for (int i = stager; i < n; i += stagers) sv[i] = valid[i];
    if (info)
      for (int i = stager; i < 6 * n; i += stagers)
        si[i] = s.upper(i / 6, i % 6);
  }
  if (L.staged) s = Matches{sp, sq, sv, info ? si : nullptr, true};
  __syncthreads();

  if (live) {
    float T[7];
    for (int c = 0; c < 7; ++c) T[c] = sT[7 * slot + c];
    // the inlier row, its count, and the masked errors: the pose's warps
    // take the matches 32 at a time in turn
    const long long row = h * n;
    float* row_stash = L.stash ? stash + slot * n : scratch + row;
    int found = 0;
    for (int m0 = 32 * sub; m0 < n; m0 += 32 * L.group) {
      const int m = m0 + lane;
      bool in = false;
      if (m < n) {
        const float err = pair_error(model, T, s, m, &in);
        inl[row + m] = in;
        row_stash[m] = in ? err : 0.0f;
      }
      found += __popc(__ballot_sync(0xffffffffu, in));
    }
    if (lane == 0) atomicAdd(&inliers[slot], found);
  }
  __syncthreads();
  if (!live || sub != 0) return;
  // the masked error sum, in the order of ATen's CPU row sum, read from
  // the stash (the error is computed once: one inlined copy of the five
  // models, where a copy in each of the sum's unrolled loads would
  // overflow the instruction cache)
  const float* row_stash = L.stash ? stash + slot * n : scratch + h * n;
  const float total = warp_inner_sum(n, [&](int m) { return row_stash[m]; });
  if (lane == 0) {
    counts[h] = inliers[slot];
    err_sum[h] = total;
  }
}

template <bool kFit, int kN>
int launch(const float* p, const float* q, const unsigned char* valid,
           const float* info, const long long* idx, int k,
           const float* poses, int n, long long count, int n_sq,
           Model model, float* scratch, float* T, unsigned char* inl,
           long long* counts, float* err_sum, unsigned long long* counter,
           cudaStream_t stream) {
  const Layout L = layout(n, count, info != nullptr);
  if (!L.stash && scratch == nullptr) return cudaErrorInvalidValue;
  const int per_block = kTile / L.group;
  const long long blocks = (count + per_block - 1) / per_block;
  ransac_score_kernel<kFit, kN><<<(unsigned)blocks, kTile * 32, L.shared,
                                  stream>>>(
      p, q, valid, info, idx, k, poses, n, count, n_sq, model, L, scratch,
      T, inl, counts, err_sum, counter);
  return cudaGetLastError();
}

template <bool kFit, int kN>
cudaError_t prepare() {
  auto kernel = ransac_score_kernel<kFit, kN>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
}

Model make_model(int version, const float* thr) {
  return Model{version, thr[0], thr[1], thr[2], thr[3], thr[4]};
}

}  // namespace

extern "C" {

// Loads the kernels, lets them stage up to kMaxShared bytes, and finds
// the counters on the current device (lazy module loading would load them
// at their first launch, which may lie inside a capture, where loading is
// not permitted).
int ransac_score_load() {
  cudaError_t err = prepare<true, 3>();
  if (err == cudaSuccess) err = prepare<true, 0>();
  if (err == cudaSuccess) err = prepare<false, 0>();
  if (err != cudaSuccess) return err;
  return find_launch_counters();
}

// p, q (n, 3) float32; valid (n,) bool; info (n, 3, 3) float32 or null;
// idx (k, h_count) int64, each in [0, n); thr: the model's five floats
// (the three thresholds, fu, fv); scratch: (h_count, n) float32 where n >
// kStaged, else null. Out: T (h_count, 7) float32, inl (h_count, n) bool,
// counts (h_count,) int64, err_sum (h_count,) float32. All contiguous on
// the current device.
int ransac_score_hypotheses_launch(const float* p, const float* q,
                                   const unsigned char* valid,
                                   const float* info, const long long* idx,
                                   int k, int n, long long h_count, int n_sq,
                                   int version, const float* thr,
                                   float* scratch, float* T,
                                   unsigned char* inl, long long* counts,
                                   float* err_sum, int counted,
                                   cudaStream_t stream) {
  if (h_count <= 0) return cudaSuccess;
  if (n < 1 || k < 1 || version < 0 || version > 4)
    return cudaErrorInvalidValue;
  if (!launch_counters_found()) return cudaErrorInitializationError;
  unsigned long long* counter = launch_counter(counted, kHypotheses);
  const Model model = make_model(version, thr);
  if (k == 3)
    return launch<true, 3>(p, q, valid, info, idx, k, nullptr, n, h_count,
                           n_sq, model, scratch, T, inl, counts, err_sum,
                           counter, stream);
  return launch<true, 0>(p, q, valid, info, idx, k, nullptr, n, h_count,
                         n_sq, model, scratch, T, inl, counts, err_sum,
                         counter, stream);
}

// The same scoring for given poses (b, 7) float32; scratch (b, n) where
// n > kStaged.
int ransac_score_score_launch(const float* p, const float* q,
                              const unsigned char* valid, const float* info,
                              const float* poses, int n, long long b,
                              int version, const float* thr, float* scratch,
                              unsigned char* inl, long long* counts,
                              float* err_sum, int counted,
                              cudaStream_t stream) {
  if (b <= 0) return cudaSuccess;
  if (n < 0 || version < 0 || version > 4) return cudaErrorInvalidValue;
  if (!launch_counters_found()) return cudaErrorInitializationError;
  unsigned long long* counter = launch_counter(counted, kScore);
  return launch<false, 0>(p, q, valid, info, nullptr, 0, poses, n, b, 0,
                          make_model(version, thr), scratch, nullptr, inl,
                          counts, err_sum, counter, stream);
}

int ransac_score_staged() { return kStaged; }

}  // extern "C"

LAUNCH_COUNTER_ENTRY_POINTS(ransac_score)
