// Conditional (IF) nodes in a CUDA graph under stream capture: the early
// exit of a block of decode steps (runner/graphs.py, ``IfNode``).
//
// One C entry point, by ``op``:
//   0  under capture on ``capture``: add a node that sets a fresh
//      conditional handle from the device flag ``*flag`` (a bool), then an
//      IF node on that handle after it, make the IF node the capture's
//      frontier, and start capturing ``body`` into the IF node's body
//      graph (thread-local mode). Work put on ``body`` until op 1 runs
//      inside the IF node: at replay only when the flag was true.
//   1  end the capture of ``body`` (its graph is the IF node's body).
//   2  create a non-blocking stream for the bodies into ``*body``.
// Returns a cudaError_t (-1: ``capture`` is not capturing).

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

int begin_if(cudaStream_t capture, const bool* flag, cudaStream_t body) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(capture, &status, nullptr,
                                           &graph, &deps, &ndeps);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  set_conditional_kernel<<<1, 1, 0, capture>>>(handle, flag);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the frontier now ends in the kernel that sets the handle
  e = cudaStreamGetCaptureInfo(capture, &status, nullptr, &graph, &deps,
                               &ndeps);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(capture, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return e;
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

}  // namespace

extern "C" int gllm_graph_conditional(int op, void* capture, const void* flag,
                                      void* body) {
  if (op == 0) {
    return begin_if(static_cast<cudaStream_t>(capture),
                    static_cast<const bool*>(flag),
                    static_cast<cudaStream_t>(body));
  }
  if (op == 2) {
    return cudaStreamCreateWithFlags(static_cast<cudaStream_t*>(body),
                                     cudaStreamNonBlocking);
  }
  cudaGraph_t graph;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}
