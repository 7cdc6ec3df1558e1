// Stamps of the port's flight recorder (putslam_tpu_torch/utils/timing.py):
// a one-thread kernel launched at a stage's boundaries inside a CUDA graph,
// which reads the card's nanosecond clock (%globaltimer) and writes it into
// a ring of rows on the card, one row a replay of a graph that opens one.
//
// Not a port of a TPU kernel: the JAX package's frame is one XLA program
// that nothing times from inside. A host span cannot see into a graph
// replay, and an event-record node is not allowed inside a conditional
// node's body; a kernel node is, and sits on the graph's serial chain, so
// a stage inside an IF body is stamped only where the card takes the
// branch. Its cost is one small launch a stamp (about 1-2 us a node).
//
// The ring (int64): a header of kHead words, [0] the rows opened, [1] the
// open row's slot, [2 ...] clock reads; then `capacity` rows of
// 1 + 4 * n_stages words: the row's sequence number, then per stage its
// last begin, last end, summed duration and count (ns on the card's clock).
// Operations:
//   kOpen   opens the next row (sequence number [0], slot [0] % capacity),
//           zeroes it and begins `stage` in it;
//   kBegin  begins `stage` in the open row;
//   kEnd    ends it: its end, duration added, count + 1 (a stage that runs
//           several times in a replay, a Gauss-Newton iteration, adds up);
//   kClock  writes the clock into header word `stage` (the recorder's
//           clock offset).
// Launches on one stream (a graph's chain) run in order and see each
// other's writes. Plain C entry points, bound with ctypes; each returns a
// cudaError_t (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kHead = 8;
constexpr int kFields = 4;
enum Op { kOpen = 0, kBegin = 1, kEnd = 2, kClock = 3 };

__device__ __forceinline__ long long clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void stamp(long long* ring, long long capacity, int n_stages,
                      int stage, int op) {
  const long long t = clock_ns();
  if (op == kClock) {
    ring[stage] = t;
    return;
  }
  const long long width = 1 + kFields * n_stages;
  if (op == kOpen) {
    const long long seq = ring[0];
    ring[0] = seq + 1;
    ring[1] = seq % capacity;
    long long* row = ring + kHead + ring[1] * width;
    row[0] = seq;
    for (long long i = 1; i < width; ++i) row[i] = 0;
  }
  long long* s = ring + kHead + ring[1] * width + 1 + kFields * stage;
  if (op == kEnd) {
    s[1] = t;
    s[2] += t - s[0];
    s[3] += 1;
  } else {
    s[0] = t;
  }
}

}  // namespace

extern "C" {

// Loads the kernel before any capture (lazy module loading would load it
// at its first launch, inside a capture, where loading is not permitted).
int stamp_load() {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, stamp);
}

int stamp_launch(void* ring, long long capacity, int n_stages, int stage,
                 int op, cudaStream_t stream) {
  stamp<<<1, 1, 0, stream>>>(static_cast<long long*>(ring), capacity,
                             n_stages, stage, op);
  return cudaGetLastError();
}

const char* stamp_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
