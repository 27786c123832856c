// Conditional nodes for stream-captured CUDA graphs: the device engine's
// captured loop (src/repro_torch/core/capture.py) builds its lax.cond /
// lax.switch counterparts from them.
//
// It replaces no TPU kernel: JAX compiles lax.cond and lax.switch into
// its while-loop, and a CUDA graph takes a device-side branch only
// through a conditional node.  PyTorch 2.13 binds IF nodes
// (CUDAGraph.begin_capture_to_if_node); the PyTorch on the H100 host
// (2.11) does not, so this file does what that binding does, and binds
// SWITCH nodes too (CUDA 12.8), with a plain C interface loaded by
// ctypes:
//
//   graph_cond_begin(parent, value, n, bodies)
//     on a stream that is capturing a graph G: create a conditional
//     handle in G; capture one launch of a setter kernel, which sets the
//     handle from the device value each time G runs; add a conditional
//     node after it with the stream's current dependencies; make the
//     node the stream's only dependency; write the node's body graphs
//     to bodies[0..].  n == 0: an IF node on the 0-d bool at `value`
//     (one body).  n >= 1: a SWITCH node on the int32 at `value` with n
//     bodies; a value outside [0, n) runs none.
//   graph_body_begin(body_stream, body, mode) / graph_body_end(...)
//     capture the stream `body_stream` into one body graph, in the
//     cudaStreamCaptureMode `mode` of the graph's own capture; nodes
//     captured there run only when the node selects that body.
//   graph_stream_create / graph_stream_destroy
//     the body streams, one a nesting level.
//
// The setters are one thread reading one value: each is bound by its
// launch, about a microsecond of the graph's time per conditional node.
// Each call returns a cudaError_t (0 on success); -1 means `parent` was
// not capturing, -2 that this toolkit has no SWITCH node (CUDA < 12.8).

#include <cuda_runtime.h>

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

__global__ void set_switch_kernel(cudaGraphConditionalHandle handle,
                                  const int* index, int n) {
  const int i = *index;
  cudaGraphSetConditional(handle, (i >= 0 && i < n) ? (unsigned)i
                                                    : (unsigned)n);
}

// A stream of the caller's own for capturing bodies: PyTorch's streams
// come from a small round-robin pool, which also serves the stream a
// graph is captured on, and a body cannot be captured on that one.
extern "C" int graph_stream_create(void** stream) {
  return (int)cudaStreamCreateWithFlags((cudaStream_t*)stream,
                                        cudaStreamNonBlocking);
}

extern "C" int graph_stream_destroy(void* stream) {
  return (int)cudaStreamDestroy((cudaStream_t)stream);
}

extern "C" int graph_cond_init(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFree(nullptr);
}

extern "C" int graph_cond_begin(void* parent_stream, const void* value,
                                int n, void** bodies) {
#if CUDART_VERSION < 12080
  if (n > 0) return -2;
#endif
  cudaStream_t parent = (cudaStream_t)parent_stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t num_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph,
                                             &deps, &num_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  if (n == 0)
    set_if_kernel<<<1, 1, 0, parent>>>(handle,
                                       static_cast<const bool*>(value));
  else
    set_switch_kernel<<<1, 1, 0, parent>>>(
        handle, static_cast<const int*>(value), n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps,
                                 &num_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
#if CUDART_VERSION >= 12080
  params.conditional.type = n == 0 ? cudaGraphCondTypeIf
                                   : cudaGraphCondTypeSwitch;
#else
  params.conditional.type = cudaGraphCondTypeIf;
#endif
  params.conditional.size = n == 0 ? 1 : (unsigned)n;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < (n == 0 ? 1 : n); ++i)
    bodies[i] = (void*)params.conditional.phGraph_out[i];
  return (int)cudaStreamUpdateCaptureDependencies(
      parent, &node, 1, cudaStreamSetCaptureDependencies);
}

extern "C" int graph_body_begin(void* body_stream, void* body, int mode) {
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body_stream, (cudaGraph_t)body, nullptr, nullptr, 0,
      (cudaStreamCaptureMode)mode);
}

extern "C" int graph_body_end(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}
