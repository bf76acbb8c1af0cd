// Conditional (IF) nodes of a CUDA graph under stream capture: the device
// form of the saturation guard's repair rounds (ops/capture.py).
//
// Counterpart of the zero-trip lax.while_loop of the JAX package's "while"
// guard (tf_seq2seq_losses_tpu/ops/topology.py, w_cond and w_body): a
// round's gathers and kernels are captured into the body graph of an IF
// node whose condition a one-thread kernel sets from a device predicate at
// each replay, so a replay of a clean batch runs none of them and the host
// reads no device value.
//
// ctc_cond_begin, on a stream that is capturing (the main capture):
//   1. creates a conditional handle in the graph being captured (default
//      0, reset at each launch);
//   2. captures set_cond_kernel into the main stream: it sets the handle
//      from pred[0] (a bool, 1 byte) when the graph runs;
//   3. adds the IF node after the main stream's current dependencies and
//      makes it the main stream's only dependency, so that what the main
//      stream captures next runs after the body;
//   4. begins capturing the body stream into the node's body graph.
// Work launched on the body stream until ctc_cond_end forms the body.
// ctc_cond_end gives the body's node count.  The body stream must not be
// capturing on entry.  Conditional nodes need CUDA
// 12.4 or later (toolkit and libcuda).

#include <cuda_runtime.h>

namespace ctc {

__global__ void set_cond_kernel(cudaGraphConditionalHandle handle,
                                const unsigned char* pred) {
  cudaGraphSetConditional(handle, pred[0] ? 1u : 0u);
}

cudaError_t capture_deps(cudaStream_t st, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* num_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, nullptr, graph, deps,
                                             nullptr, num_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, nullptr, graph, deps,
                                             num_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorStreamCaptureInvalidated;
}

}  // namespace ctc

extern "C" {

// Load this library's kernel and its runtime on the current device: a
// capture may not load them.
int ctc_cond_load() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, ctc::set_cond_kernel);
}

int ctc_cond_begin(void* main_stream, void* body_stream, const void* pred) {
  using namespace ctc;
  cudaStream_t st = static_cast<cudaStream_t>(main_stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t num_deps;
  cudaError_t err = capture_deps(st, &graph, &deps, &num_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return (int)err;
  set_cond_kernel<<<1, 1, 0, st>>>(handle,
                                   static_cast<const unsigned char*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = capture_deps(st, &graph, &deps, &num_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, num_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(st, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(st, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

// End the body's capture; *nodes: the body graph's node count.
int ctc_cond_end(void* body_stream, size_t* nodes) {
  cudaGraph_t body;
  cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGraphGetNodes(body, nullptr, nodes);
}

}  // extern "C"
