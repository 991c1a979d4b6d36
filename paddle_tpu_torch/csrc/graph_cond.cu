// Conditional nodes of a CUDA graph under stream capture: the IF and WHILE
// nodes behind `static.nn.cond` and `static.nn.while_loop` inside a
// captured `jit.to_static` step (paddle_tpu_torch/inference/graphs.py,
// `conditional_body`).
//
// They replace no Pallas kernel.  The reference lowers cond to XLA's
// `conditional` (jax.lax.cond) and while_loop to XLA's `while`
// (paddle_tpu/static/__init__.py:289, :343): one compiled program in which
// only the taken branch, or only the live iterations, execute.  A CUDA
// graph is fixed at capture, so the port puts each branch and each loop
// body into the child graph of a conditional node that the graph decides
// at every replay from a device flag, with no host read.
//
// `ptt_cond_begin` adds, at the capture position of `stream`: a one-thread
// kernel that reads the flag (`pred`, one byte, nonzero is true; `negate`
// flips it) into a conditional handle, then the IF node (`loop` 0: its body
// runs once when the handle is nonzero) or WHILE node (`loop` 1: its body
// runs while the handle is nonzero, the handle read again after each pass),
// and moves the stream's capture past the node.  It then starts capturing
// `child` (a stream of its own; the caller makes it current) into the
// node's body graph, and returns the handle.  A WHILE body ends with
// `ptt_cond_set` on `child`, which writes the loop's next flag into the
// handle; `ptt_cond_end` closes the body.  Nested bodies nest: a child
// stream that is capturing can begin a node of its own on a deeper child.
//
// Bound: neither; one thread, one byte read, per node and replay.
//
// CUDA 12.4 or later (conditional handles, `cudaGraphAddNode` with
// conditional parameters, `cudaStreamBeginCaptureToGraph`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const unsigned char* pred, int negate) {
  cudaGraphSetConditional(handle, ((pred[0] != 0) != (negate != 0)) ? 1u : 0u);
}

cudaGraphConditionalHandle as_handle(const void* handle) {
  return static_cast<cudaGraphConditionalHandle>(reinterpret_cast<uintptr_t>(handle));
}

}  // namespace

extern "C" int ptt_cond_set(const void* handle, const void* pred, int negate,
                            void* stream) {
  set_conditional_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      as_handle(handle), static_cast<const unsigned char*>(pred), negate);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_cond_begin(void* stream, void* child, const void* pred,
                              int negate, int loop, void* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorIllegalState);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_conditional_kernel<<<1, 1, 0, s>>>(handle, static_cast<const unsigned char*>(pred),
                                         negate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the node goes after the flag's kernel: the capture's dependencies now
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = loop ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(child),
                                      params.conditional.phGraph_out[0], nullptr,
                                      nullptr, 0, cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return static_cast<int>(err);
  *static_cast<unsigned long long*>(handle_out) = handle;
  return 0;
}

extern "C" int ptt_cond_end(void* child) {
  cudaGraph_t body;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body));
}
