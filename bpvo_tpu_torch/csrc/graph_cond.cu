// CUDA graph IF and WHILE nodes for bpvo_tpu_torch/utils/graphs.py: the
// port's own counterparts of jax.lax.cond and jax.lax.while_loop inside a
// compiled step.
//
// Replaces no TPU kernel.  JAX's DeviceVO step runs its keyframe branch as a
// lax.cond (bpvo_tpu/vo/device_vo.py:284-357) and each level solve as a
// lax.while_loop (bpvo_tpu/solver/gauss_newton.py:444-492,
// levenberg_marquardt.py:40-135) inside one compiled program.  The port
// captures the code around a branch or a loop into CUDA graphs with PyTorch
// (a segment before it, its body, a segment after it) and joins them here
// into one graph: each segment a child-graph node; for each branch a
// one-thread kernel that copies the branch's predicate (a bool in device
// memory, written by the segment before) into a conditional handle,
// followed by an IF node whose body is the branch's segments; for each loop
// the same kernel and a WHILE node whose body is the loop body's segments
// and, last, the same kernel again on the bool the body rewrote, so that
// each iteration re-arms (or ends) the loop.  Bodies nest either way; each
// handle is created on the graph that holds its node.  The graph then runs
// on the device with no host read of a predicate.
//
// A conditional body holds only kernel, memcpy, memset, empty, child-graph
// and conditional nodes.  bpvo_graph_node_types counts a graph's nodes by
// type, through its child graphs, so that utils/graphs.py can refuse a
// segment a body cannot hold (a host node, an event record or wait node: a
// collective may add them) and name its types before CUDA refuses it.
//
// A loop's clock (utils/graphs.py Timer): torch.profiler records a WHILE
// body's kernels once a replay, not once an iteration, so a loop times
// itself.  bpvo_clock_start and bpvo_clock_stop launch a one-thread kernel
// each on a stream (captured, a kernel node at the start and one at the end
// of the body): the first stores %globaltimer in clock[0], the second adds
// %globaltimer - clock[0] to clock[1], one iteration to clock[2] and, given
// `runs`, one run to a body's counter.  clock is a zeroed int64[3] in device
// memory; the nanoseconds are the device's wall time from the start node to
// the end node, the gaps between the body's nodes included.
//
// Plain C entry points bound by ctypes (ops/_build.py); each returns the
// cudaError_t of the calls it made.  The graphs are created and joined
// outside any stream capture.
#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

__device__ __forceinline__ long long global_timer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void clock_start_kernel(long long* clock) {
  clock[0] = global_timer_ns();
}

__global__ void clock_stop_kernel(long long* clock, long long* runs) {
  clock[1] += global_timer_ns() - clock[0];
  clock[2] += 1;
  if (runs != nullptr) *runs += 1;
}

}  // namespace

extern "C" int bpvo_clock_start(void* clock, void* stream) {
  clock_start_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(clock));
  return cudaGetLastError();
}

extern "C" int bpvo_clock_stop(void* clock, void* runs, void* stream) {
  clock_stop_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(clock), static_cast<long long*>(runs));
  return cudaGetLastError();
}

extern "C" int bpvo_graph_create(void** graph) {
  return cudaGraphCreate(reinterpret_cast<cudaGraph_t*>(graph), 0);
}

extern "C" int bpvo_graph_destroy(void* graph) {
  return cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
}

extern "C" int bpvo_graph_num_nodes(void* graph, long long* count) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr,
                                    &n);
  *count = static_cast<long long>(n);
  return e;
}

// Add to counts[t] (t < n_types) the nodes of `graph` of type t, counting
// the nodes of each child graph too (a child-graph node counts as one of
// type cudaGraphNodeTypeGraph besides).  Conditional nodes count as one;
// their bodies are not entered.
extern "C" int bpvo_graph_node_types(void* graph, long long* counts,
                                     int n_types) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess || n == 0) return e;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  e = cudaGraphGetNodes(g, nodes, &n);
  for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    e = cudaGraphNodeGetType(nodes[i], &type);
    if (e != cudaSuccess) break;
    int t = static_cast<int>(type);
    if (t >= 0 && t < n_types) counts[t] += 1;
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (e == cudaSuccess)
        e = static_cast<cudaError_t>(bpvo_graph_node_types(child, counts,
                                                           n_types));
    }
  }
  delete[] nodes;
  return e;
}

// Append a copy of `child` to `graph` as a child-graph node that depends on
// *tail (a root when *tail is null); *tail becomes the new node.
extern "C" int bpvo_graph_append_child(void* graph, void** tail,
                                       void* child) {
  cudaGraphNode_t dep = static_cast<cudaGraphNode_t>(*tail);
  cudaGraphNode_t node;
  cudaError_t e = cudaGraphAddChildGraphNode(
      &node, static_cast<cudaGraph_t>(graph), dep ? &dep : nullptr,
      dep ? 1 : 0, static_cast<cudaGraph_t>(child));
  if (e == cudaSuccess) *tail = node;
  return e;
}

// Append to `graph`, after *tail, a kernel node that sets `handle` (a
// conditional handle created on the graph that holds the handle's node)
// from the bool at device address `pred`; *tail becomes the new node.
extern "C" int bpvo_graph_append_set(void* graph, void** tail,
                                     unsigned long long handle,
                                     const void* pred) {
  cudaGraphConditionalHandle h = handle;
  cudaGraphNode_t dep = static_cast<cudaGraphNode_t>(*tail);
  const bool* p = static_cast<const bool*>(pred);
  void* args[] = {&h, &p};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(set_condition_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  cudaGraphNode_t node;
  cudaError_t e = cudaGraphAddKernelNode(
      &node, static_cast<cudaGraph_t>(graph), dep ? &dep : nullptr,
      dep ? 1 : 0, &kp);
  if (e == cudaSuccess) *tail = node;
  return e;
}

namespace {

// After *tail: a set-condition kernel node on a new handle of `graph` from
// `pred`, then a conditional node of `type` on that handle.  *body receives
// the node's body graph, *handle the handle; *tail becomes the node.
cudaError_t append_conditional(void* graph, void** tail, const void* pred,
                               cudaGraphConditionalNodeType type,
                               void** body, unsigned long long* handle) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphConditionalHandle h;
  cudaError_t e = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (e != cudaSuccess) return e;
  void* set_node = *tail;
  e = static_cast<cudaError_t>(bpvo_graph_append_set(graph, &set_node, h,
                                                     pred));
  if (e != cudaSuccess) return e;
  cudaGraphNode_t dep = static_cast<cudaGraphNode_t>(set_node);
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = h;
  cp.conditional.type = type;
  cp.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, g, &dep, 1, &cp);
  if (e != cudaSuccess) return e;
  *body = cp.conditional.phGraph_out[0];
  *handle = h;
  *tail = node;
  return cudaSuccess;
}

}  // namespace

// Append to `graph`, after *tail: a kernel node that sets a new conditional
// handle of `graph` from the bool at device address `pred`, then an IF node
// on that handle.  *body receives the IF node's body graph (owned by the
// node; fill it with bpvo_graph_append_*); *tail becomes the IF node.
extern "C" int bpvo_graph_append_if(void* graph, void** tail,
                                    const void* pred, void** body) {
  unsigned long long handle;
  return append_conditional(graph, tail, pred, cudaGraphCondTypeIf, body,
                            &handle);
}

// Append to `graph`, after *tail: a kernel node that sets a new conditional
// handle of `graph` from the bool at device address `pred`, then a WHILE
// node on that handle.  *body receives the WHILE node's body graph (owned
// by the node; fill it with bpvo_graph_append_*, and end it with
// bpvo_graph_append_set on *handle and the bool the body rewrote, so that
// each iteration re-arms or ends the loop); *handle receives the handle;
// *tail becomes the WHILE node.
extern "C" int bpvo_graph_append_while(void* graph, void** tail,
                                       const void* pred, void** body,
                                       unsigned long long* handle) {
  return append_conditional(graph, tail, pred, cudaGraphCondTypeWhile, body,
                            handle);
}

extern "C" int bpvo_graph_instantiate(void** exec, void* graph) {
  return cudaGraphInstantiate(reinterpret_cast<cudaGraphExec_t*>(exec),
                              static_cast<cudaGraph_t>(graph), 0);
}

extern "C" int bpvo_graph_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

extern "C" int bpvo_graph_exec_destroy(void* exec) {
  return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}
