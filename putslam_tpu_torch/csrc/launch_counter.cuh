// The launch counter of a hand-written kernel library, written once for all
// of them (read by putslam_tpu_torch/utils/cuda_lib.py).
//
// A launch recorded into a CUDA graph, inside a conditional node's body,
// runs at a replay only where the card takes the branch, which the host
// does not see: so one thread of each launch adds one to a counter on the
// card, launches_counted[mode], or, with counted == 0 (the warm-up before a
// capture), launches_uncounted[mode], which nothing reads.
//
// A source sets LAUNCH_MODES (its counters; 1 if it does not) before it
// includes this header, calls find_launch_counters() from <name>_load,
// hands launch_counter(counted, mode) to its kernels, and ends with
// LAUNCH_COUNTER_ENTRY_POINTS(<name>), which emits the plain C entry points
// <name>_launch_modes, <name>_read_launches (the counted launches of each
// mode since the last reset; synchronises the device), <name>_reset_launches
// and <name>_error.

#pragma once

#include <cuda_runtime.h>

#ifndef LAUNCH_MODES
#define LAUNCH_MODES 1
#endif

namespace {

constexpr int kLaunchModes = LAUNCH_MODES;

__device__ unsigned long long launches_counted[kLaunchModes];
__device__ unsigned long long launches_uncounted[kLaunchModes];

unsigned long long* launch_counters[2] = {nullptr, nullptr};

// Finds both counters on the current device.
cudaError_t find_launch_counters() {
  const cudaError_t err = cudaGetSymbolAddress(
      reinterpret_cast<void**>(&launch_counters[0]), launches_uncounted);
  if (err != cudaSuccess) return err;
  return cudaGetSymbolAddress(reinterpret_cast<void**>(&launch_counters[1]),
                              launches_counted);
}

bool launch_counters_found() { return launch_counters[0] != nullptr; }

// The counter of a launch of this mode.
unsigned long long* launch_counter(int counted, int mode = 0) {
  return launch_counters[counted ? 1 : 0] + mode;
}

}  // namespace

#define LAUNCH_COUNTER_ENTRY_POINTS(name)                                    \
  extern "C" int name##_launch_modes() { return kLaunchModes; }              \
  extern "C" int name##_read_launches(unsigned long long* value) {           \
    return cudaMemcpyFromSymbol(value, launches_counted,                     \
                                sizeof(launches_counted));                   \
  }                                                                          \
  extern "C" int name##_reset_launches() {                                   \
    const unsigned long long zero[kLaunchModes] = {};                        \
    return cudaMemcpyToSymbol(launches_counted, zero, sizeof(zero));         \
  }                                                                          \
  extern "C" const char* name##_error(int err) {                             \
    return cudaGetErrorString(static_cast<cudaError_t>(err));                \
  }
