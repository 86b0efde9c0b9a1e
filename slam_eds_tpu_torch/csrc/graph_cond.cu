// IF nodes of a CUDA graph under stream capture: the port's counterpart of
// the branches that JAX keeps on the device (lax.while_loop's early exit,
// lax.cond), for graphs captured with torch.cuda.CUDAGraph.
//
// graph_if_begin, called while `parent` is capturing a graph:
//   1. creates a conditional handle in the graph that `parent` captures into;
//   2. launches set_condition on `parent`: one thread reads the predicate, a
//      device bool, sets the handle to it (cudaGraphSetConditional) and,
//      where it holds, adds one to the node's counter `taken` (how many
//      times the body ran: the launches that ran under the node are its
//      captured launches times that count);
//   3. adds an IF node after that kernel (cudaGraphAddNode), makes it the
//      only dependency of what `parent` captures next
//      (cudaStreamUpdateCaptureDependencies), and
//   4. starts capturing `body` into the node's body graph
//      (cudaStreamBeginCaptureToGraph).
// The caller then issues the body's work on `body` and calls graph_if_end,
// which ends that capture. On every launch of the instantiated graph, the
// body runs only where the predicate held when set_condition ran.
//
// A body may hold kernel, memset and device-to-device memcpy nodes and
// further conditional nodes (nesting: begin on a body's stream); it may not
// record or wait on events or fork to other streams. This is the form
// torch's own conditional capture takes (CUDAGraph::begin_capture_to_if_node
// in torch 2.5 and later), which the torch on the card does not expose. It
// needs CUDA 12.4 or later (cudaStreamBeginCaptureToGraph).
//
// The device work is one single-thread kernel per node: no bound to speak
// of (1 B read, 8 B read and written where taken); its cost is a launch
// inside the graph.
#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred,
                              unsigned long long* taken) {
  const bool p = *pred;
  cudaGraphSetConditional(handle, p ? 1u : 0u);
  if (p) *taken += 1ull;
}

}  // namespace

// Returns 0, or the failing CUDA call's error code plus 1000 times its step
// (1 capture info, 2 handle, 3 condition kernel, 4 capture info, 5 node,
// 6 dependencies, 7 body capture).
extern "C" int graph_if_begin(void* parent_stream, void* body_stream,
                              const bool* pred, unsigned long long* taken) {
  cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph,
                                             &deps, &n_deps);
  if (err != cudaSuccess) return 1000 + (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return 1000 + (int)cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return 2000 + (int)err;
  set_condition<<<1, 1, 0, parent>>>(handle, pred, taken);
  err = cudaGetLastError();
  if (err != cudaSuccess) return 3000 + (int)err;
  // the dependencies now end in the set_condition kernel
  err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return 4000 + (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return 5000 + (int)err;
  err = cudaStreamUpdateCaptureDependencies(parent, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return 6000 + (int)err;
  err = cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
  return err == cudaSuccess ? 0 : 7000 + (int)err;
}

extern "C" int graph_if_end(void* body_stream) {
  cudaGraph_t body;
  // the body graph belongs to its node: nothing to free
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream),
                                   &body);
}

// A stream of its own for a body's capture (torch's stream pool hands out
// its 32 streams round robin, so a deep nest of bodies would meet a stream
// that is capturing already). Never destroyed: the process keeps one per
// nesting depth.
extern "C" int graph_stream_create(void** out) {
  cudaStream_t stream;
  cudaError_t err = cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking);
  *out = stream;
  return (int)err;
}

extern "C" const char* graph_cond_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
