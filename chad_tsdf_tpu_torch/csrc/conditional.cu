// The fused and tile inserts' fallback as a CUDA conditional IF node.
//
// The JAX package ends a fused or tile insert with a lax.cond on the count
// of samples that no tile's block list could hold
// (chad_tsdf_tpu/core/integrate.py:652-675): the fallback (the sample
// grids, K4 and the sort-based update_pool through K5) runs only when that
// count is positive, decided on the device inside the insert's one
// executable.  Captured into a CUDA graph, the same branch is an IF node
// whose handle a one-thread kernel sets from the count, so a replayed
// insert decides on the device and the host reads nothing.
//
// chad_set_conditional runs on a stream that is being captured.  It
// creates a conditional handle in the graph under capture, launches the
// one-thread kernel that sets the handle from *flag > 0, adds an IF node
// behind that kernel, makes the IF node the capture's only dependency (so
// what is captured next waits for the branch), and begins capturing the
// node's body graph on body_stream.  The caller captures the body there
// and ends it with chad_end_conditional.
//
// Bound on the H100: one launch.  The kernel reads one 4-byte word and
// writes the handle; its time is the latency of a kernel node in the graph.
#include <cuda_runtime.h>

namespace chad {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const int* __restrict__ flag) {
  cudaGraphSetConditional(handle, *flag > 0 ? 1u : 0u);
}

}  // namespace chad

extern "C" int chad_set_conditional(const int* flag, void* body_stream,
                                    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             nullptr, nullptr);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return (int)err;
  chad::set_conditional_kernel<<<1, 1, 0, s>>>(handle, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body_stream, params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, cudaStreamCaptureModeGlobal);
}

extern "C" int chad_end_conditional(void* body_stream, void* stream) {
  (void)stream;
  cudaGraph_t body = nullptr;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}
