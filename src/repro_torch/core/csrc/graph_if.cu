// Conditional ("if") nodes for a CUDA-graph capture that PyTorch is making.
//
// The chunked round driver (core/engine.py) captures a chunk of rounds as
// one CUDA graph. Once the eq. (35) stop holds, the rounds after it must do
// nothing, as in the reference's `lax.cond(done, frozen, live)`: each round
// is the body of an IF node whose condition a one-thread kernel sets from a
// flag in device memory when the graph reaches it. PyTorch 2.11 has no
// public form of this, so the node is added here, as PyTorch's own later
// `CUDAGraph.begin_capture_to_if_node` adds it: read the capturing stream's
// graph and dependencies, create the handle, capture the kernel that sets
// it, add the node after it, make the node the stream's only dependency,
// and begin capturing a second stream into the node's body graph.
// CUDA 12.4 or later (conditional IF nodes, cudaStreamBeginCaptureToGraph).
#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const unsigned char* flag, int invert) {
  const bool on = (*flag != 0) != (invert != 0);
  cudaGraphSetConditional(handle, on ? 1u : 0u);
}

}  // namespace

// `stream` is capturing (PyTorch's graph capture). Adds to its graph a
// node whose body runs at replay when the bool at `flag` is true (false
// with `invert`), and starts capturing `body_stream` into that body with
// capture mode `mode`. Returns a cudaError_t (0 on success).
extern "C" int graph_if_begin(void* stream, const unsigned char* flag,
                              int invert, void* body_stream, int mode) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) {
    return (int)cudaErrorStreamCaptureImplicit;
  }
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_condition<<<1, 1, 0, s>>>(handle, flag, invert);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the dependencies now end at the kernel just captured
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, static_cast<cudaStreamCaptureMode>(mode));
}

// Ends the body capture that graph_if_begin started on `body_stream`.
extern "C" int graph_if_end(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream),
                                   &body);
}
