// Conditional IF nodes in a CUDA graph under stream capture: the plumbing
// behind utils/control.py::cond in capture mode (the port's lax.cond).
//
// graph_cond_begin(parent, body, pred), with `parent` capturing a graph:
//   1. creates a conditional handle on the graph `parent` captures into;
//   2. captures a one-thread kernel on `parent` that sets the handle from
//      the device bool *pred when the graph runs;
//   3. adds an IF node after it, makes the node the dependency of whatever
//      `parent` captures next;
//   4. starts capturing `body` (a stream that captures nothing) into the
//      node's body graph.
// graph_cond_end(body) ends that capture; graph_cond_load() loads the
// kernel before any capture. The node runs its body graph in
// a replay only where *pred is true. Plain C entry points, bound with
// ctypes; each returns a cudaError_t (0 on success).

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

int graph_cond_begin(cudaStream_t parent, cudaStream_t body,
                     const bool* pred) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr,
                                             &graph, nullptr, nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, parent>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(parent, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  // relaxed: the parent's capture already refuses what a capture may not
  // do on this thread
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeRelaxed);
}

// Loads the set-condition kernel (lazy module loading would load it at
// its first launch, inside a capture, where loading is not permitted).
int graph_cond_load() {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, set_condition);
}

int graph_cond_end(cudaStream_t body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(body, &graph);
}

const char* graph_cond_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
