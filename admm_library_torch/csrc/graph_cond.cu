// CUDA-graph conditional nodes built into a stream capture under way,
// for Hopper (sm_90a): the device-side loop test of core/graph.py's
// `while_blocks`, the counterpart of the reference's `lax.while_loop`
// (admm_library_tpu/ops/kkt.py cg_solve). This is no port of a TPU
// kernel: it holds two one-thread kernels that set a node's condition
// and the host calls that add the node to the graph a stream is
// capturing into and capture its body, and the one-thread stamp kernel
// of utils/trace.py's spans.
//
// One node, as core/graph.py drives it:
//
//   admm_cond_open(stream, side, limit, flag, count, ...)
//     on `stream` (capturing into graph G): a conditional handle of G,
//     cond_arm (condition = *flag and limit > 0; *count = 0), then a
//     node of type WHILE (limit > 1) or IF (limit == 1) after it; the
//     stream's dependencies become the node; `side` starts capturing
//     into the node's body graph (in the capture mode torch's own
//     capture uses, global).
//   the body's work, on `side`
//   admm_cond_close(side, ...)
//     a WHILE node's body ends with cond_rearm (*count += 1; condition
//     = *flag and *count < limit); the body's capture ends and its node
//     count is returned.
//
// So a WHILE node runs its body while the flag holds, at most `limit`
// times, and an IF node once if it holds. Every call returns a CUDA
// error code; core/graph.py raises on any that is not 0, and there is
// no fallback.

#include <cuda_runtime.h>

namespace {

// The condition before a node: the flag, and for a WHILE node a block
// budget left (limit > 0); the node's block count reset.
__global__ void cond_arm(cudaGraphConditionalHandle handle,
                         const bool* flag, int* count, int limit) {
  if (count != nullptr) *count = 0;
  cudaGraphSetConditional(handle, (*flag && limit > 0) ? 1u : 0u);
}

// The condition after one pass of a WHILE node's body: the flag the
// body left, and fewer than `limit` passes so far.
__global__ void cond_rearm(cudaGraphConditionalHandle handle,
                           const bool* flag, int* count, int limit) {
  const int passes = *count + 1;
  *count = passes;
  cudaGraphSetConditional(handle, (*flag && passes < limit) ? 1u : 0u);
}

// A span's stamp (utils/trace.py): reads %globaltimer (ns). `slots`
// holds n_slots open stamps, then n_slots totals, then n_slots counts,
// the ring's head, the calibration stamp and `ring` rows of (sequence
// number, slot, start, end). Modes: 0 begin (open[id] = now), 1 end
// (total[id] += now - open[id], count[id] += 1), 2 end and a ring row,
// 3 calibration (the stamp alone).
__global__ void trace_stamp(long long* slots, int n_slots, int ring, int id,
                            int mode) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long t = static_cast<long long>(now);
  long long* head = slots + 3 * n_slots;
  if (mode == 0) {
    slots[id] = t;
    return;
  }
  if (mode == 3) {
    head[1] = t;
    return;
  }
  const long long t0 = slots[id];
  slots[n_slots + id] += t - t0;
  slots[2 * n_slots + id] += 1;
  if (mode == 2) {
    const long long seq = head[0];
    long long* row = head + 2 + 4 * (seq % ring);
    row[0] = seq;
    row[1] = id;
    row[2] = t0;
    row[3] = t;
    head[0] = seq + 1;
  }
}

inline int result(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

#define COND_TRY(call)                          \
  do {                                          \
    cudaError_t err_ = (call);                  \
    if (err_ != cudaSuccess) return result(err_); \
  } while (0)

}  // namespace

// Loads the kernels (outside any capture: a lazy module load inside a
// global-mode capture is not allowed).
extern "C" int admm_cond_init() {
  cudaFuncAttributes attr;
  COND_TRY(cudaFuncGetAttributes(&attr, cond_arm));
  COND_TRY(cudaFuncGetAttributes(&attr, cond_rearm));
  COND_TRY(cudaFuncGetAttributes(&attr, trace_stamp));
  return 0;
}

// Adds a conditional node after the current work of `stream`, which
// must be capturing, and starts capturing `side` into its body. `limit`
// 1 makes an IF node, more a WHILE node of at most `limit` passes;
// `count` is device memory for a WHILE node's pass count (null for an
// IF node). Writes the node's handle.
extern "C" int admm_cond_open(void* stream, void* side, int limit,
                              const bool* flag, int* count,
                              unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (limit < 1 || (limit > 1 && count == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  COND_TRY(cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps,
                                    &ndeps));
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  cudaGraphConditionalHandle handle;
  COND_TRY(cudaGraphConditionalHandleCreate(&handle, graph, 0, 0));
  cond_arm<<<1, 1, 0, s>>>(handle, flag, limit > 1 ? count : nullptr,
                           limit);
  COND_TRY(cudaGetLastError());
  COND_TRY(cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps,
                                    &ndeps));
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      limit > 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  COND_TRY(cudaGraphAddNode(&node, graph, deps, ndeps, &params));
  cudaGraph_t body = params.conditional.phGraph_out[0];
  COND_TRY(cudaStreamUpdateCaptureDependencies(
      s, &node, 1, cudaStreamSetCaptureDependencies));
  COND_TRY(cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(side),
                                         body, nullptr, nullptr, 0,
                                         cudaStreamCaptureModeGlobal));
  *handle_out = static_cast<unsigned long long>(handle);
  return 0;
}

// Ends the body that admm_cond_open began on `side`: a WHILE node's
// body (limit > 1) first re-arms its condition. Writes the body's node
// count.
extern "C" int admm_cond_close(void* side, int limit,
                               unsigned long long handle, const bool* flag,
                               int* count, size_t* nodes_out) {
  cudaStream_t s = static_cast<cudaStream_t>(side);
  cudaError_t launch = cudaSuccess;
  if (limit > 1) {
    cond_rearm<<<1, 1, 0, s>>>(
        static_cast<cudaGraphConditionalHandle>(handle), flag, count,
        limit);
    launch = cudaGetLastError();
  }
  cudaGraph_t body = nullptr;
  cudaError_t end = cudaStreamEndCapture(s, &body);
  COND_TRY(launch);
  COND_TRY(end);
  *nodes_out = 0;
  COND_TRY(cudaGraphGetNodes(body, nullptr, nodes_out));
  return 0;
}

// Ends a body capture that failed part way, leaving `side` idle; the
// capture it belonged to is invalid and raises where it ends.
extern "C" int admm_cond_abort(void* side) {
  cudaStream_t s = static_cast<cudaStream_t>(side);
  cudaStreamCaptureStatus status;
  cudaError_t err = cudaStreamIsCapturing(s, &status);
  if (err == cudaSuccess && status != cudaStreamCaptureStatusNone) {
    cudaGraph_t body = nullptr;
    err = cudaStreamEndCapture(s, &body);
  }
  return result(err);
}

// One stamp on `stream` (captured where the stream captures): see
// trace_stamp.
extern "C" int admm_trace_stamp(void* stream, long long* slots, int n_slots,
                                int ring, int id, int mode) {
  if (id < 0 || id >= n_slots || mode < 0 || mode > 3 || ring < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  trace_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      slots, n_slots, ring, id, mode);
  return result(cudaGetLastError());
}

extern "C" const char* admm_cond_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
