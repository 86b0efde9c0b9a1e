// Conditional nodes of a CUDA graph under stream capture: the port's
// counterpart of the branches and loops that JAX keeps on the device
// (lax.cond as an IF node, lax.while_loop as a WHILE node), for graphs
// captured with torch.cuda.CUDAGraph.
//
// graph_node_begin, called while `parent` is capturing a graph:
//   1. creates a conditional handle in the graph that `parent` captures into;
//   2. launches set_condition on `parent`: one thread reads the predicate, a
//      device bool (negated for a loop, whose predicate is its `done` flag),
//      and sets the handle to it (cudaGraphSetConditional). For an IF node
//      it adds one to the node's counter `taken` where the predicate holds
//      (how many times the body ran); for a WHILE node it sets the loop's
//      pass counter to 0, the start of every launch;
//   3. adds an IF or a WHILE node after that kernel (cudaGraphAddNode),
//      makes it the only dependency of what `parent` captures next
//      (cudaStreamUpdateCaptureDependencies), and
//   4. starts capturing `body` into the node's body graph
//      (cudaStreamBeginCaptureToGraph).
// The caller then issues the body's work on `body` and calls graph_node_end,
// which ends that capture. On every launch of the instantiated graph, an IF
// body runs where the predicate held when set_condition ran; a WHILE body
// runs while its handle is 1 when a pass ends.
//
// A WHILE body is one pass of the loop, captured once. Its last kernel is
// pass_tail (graph_pass_tail), which ends the pass in one launch:
//   * copies every carry leaf from where the pass wrote it to the carry's
//     buffer (allocated before the node, so the next pass and the code
//     after the loop read it there): a device array of (dst, src, bytes)
//     records, made outside any capture (a block of the graph's own pool
//     may be a temporary that its kernels write on every replay) and
//     written once after it;
//   * adds one to the pass counter, which the body reads as the pass index;
//   * sets the handle to !done && counter < cap, `done` read where the pass
//     wrote it (no record's copy touches it);
//   * adds one to the node's `taken` counter: the passes run, so the
//     launches run under the node are its captured launches times `taken`.
// The kernel trusts its records (the wrapper in graphs.py checks every leaf
// on the host: contiguous, of its buffer's type and shape, not overlapping
// another buffer) and checks nothing on the device.
//
// A body may hold kernel, memset and device-to-device memcpy nodes and
// further conditional nodes (nesting: begin on a body's stream); it may not
// record or wait on events or fork to other streams. This is the form
// torch's own conditional capture takes (CUDAGraph::begin_capture_to_if_node
// in torch 2.5 and later, IF only), which the torch on the card does not
// expose. It needs CUDA 12.4 or later (cudaStreamBeginCaptureToGraph,
// cudaGraphCondTypeWhile).
//
// What bounds the work: set_condition moves 9 bytes (1 B read, 8 B read and
// written) and pass_tail the carry's bytes twice (a few hundred bytes for
// the LM loops, 2 x 4 P bytes more for the BA's point depths): under a
// microsecond of memory time either way. Their cost is a launch inside the
// graph each, and for the loop the node's relaunch of its body per pass;
// pass_tail replaces, per pass, the flat IF form's predicate kernel,
// condition kernel, node and one multi-tensor copy kernel per type.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct LeafCopy {
  unsigned long long dst;
  unsigned long long src;
  unsigned long long bytes;
};

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred, bool negate,
                              unsigned long long* taken, int* counter) {
  const bool p = *pred != negate;
  cudaGraphSetConditional(handle, p ? 1u : 0u);
  if (taken != nullptr && p) *taken += 1ull;
  if (counter != nullptr) *counter = 0;
}

__global__ void pass_tail(cudaGraphConditionalHandle handle,
                          const LeafCopy* __restrict__ leaves, int n_leaves,
                          int* counter, int cap, const bool* done,
                          unsigned long long* taken) {
  const unsigned long long tid =
      (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned long long stride =
      (unsigned long long)gridDim.x * blockDim.x;
  for (int l = 0; l < n_leaves; ++l) {
    const LeafCopy r = leaves[l];
    if (((r.dst | r.src | r.bytes) & 15ull) == 0) {
      uint4* d = reinterpret_cast<uint4*>(r.dst);
      const uint4* s = reinterpret_cast<const uint4*>(r.src);
      for (unsigned long long i = tid; i < r.bytes / 16; i += stride)
        d[i] = s[i];
    } else if (((r.dst | r.src | r.bytes) & 3ull) == 0) {
      uint32_t* d = reinterpret_cast<uint32_t*>(r.dst);
      const uint32_t* s = reinterpret_cast<const uint32_t*>(r.src);
      for (unsigned long long i = tid; i < r.bytes / 4; i += stride)
        d[i] = s[i];
    } else {
      unsigned char* d = reinterpret_cast<unsigned char*>(r.dst);
      const unsigned char* s = reinterpret_cast<const unsigned char*>(r.src);
      for (unsigned long long i = tid; i < r.bytes; i += stride) d[i] = s[i];
    }
  }
  if (tid == 0) {
    const int it = *counter + 1;
    *counter = it;
    cudaGraphSetConditional(handle, (!*done && it < cap) ? 1u : 0u);
    *taken += 1ull;
  }
}

}  // namespace

// kind: 0 an IF node, 1 a WHILE node. Returns 0, or the failing CUDA call's
// error code plus 1000 times its step (1 capture info, 2 handle, 3
// condition kernel, 4 capture info, 5 node, 6 dependencies, 7 body
// capture). The handle is written to *handle_out.
extern "C" int graph_node_begin(void* parent_stream, void* body_stream,
                                int kind, const bool* pred, int negate,
                                unsigned long long* taken, int* counter,
                                unsigned long long* handle_out) {
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
  set_condition<<<1, 1, 0, parent>>>(handle, pred, negate != 0, taken,
                                     counter);
  err = cudaGetLastError();
  if (err != cudaSuccess) return 3000 + (int)err;
  // the dependencies now end in the set_condition kernel
  err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return 4000 + (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
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
  if (err != cudaSuccess) return 7000 + (int)err;
  *handle_out = (unsigned long long)handle;
  return 0;
}

// The last kernel of a WHILE body, on `stream` (the body's). `leaves` is a
// device array of n_leaves records, `blocks` the grid (256 threads a
// block). Returns 0 or the launch's error code.
extern "C" int graph_pass_tail(void* stream, unsigned long long handle,
                               const void* leaves, int n_leaves, int* counter,
                               int cap, const bool* done,
                               unsigned long long* taken, int blocks) {
  pass_tail<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      (cudaGraphConditionalHandle)handle,
      static_cast<const LeafCopy*>(leaves), n_leaves, counter, cap, done,
      taken);
  return (int)cudaGetLastError();
}

// The nodes of the graph `stream` is capturing now (its own level, not
// the bodies of its conditional nodes); 0 or the error code.
extern "C" int graph_capture_nodes(void* stream, unsigned long long* out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, nullptr, &graph, nullptr,
      nullptr);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorIllegalState;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  *out = n;
  return (int)err;
}

extern "C" int graph_node_end(void* body_stream) {
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
