// All-reduce over NVLink peer memory for bpvo_tpu_torch/parallel/peer.py:
// the port's counterpart of the psum and pmax that XLA emits inside JAX's
// jit(shard_map(...)) programs of the distributed layer.
//
// Replaces no TPU kernel: JAX's sharded GN (bpvo_tpu/parallel/sharded.py:91
// pmax, :94 and :108 psum), the sharded VO step's count psum
// (sharded_vo.py:127) and BA's block sums (bundle_adjustment.py:139-335)
// are collectives XLA compiles into the one program, inside lax.while_loop
// and lax.cond.  The port captures those programs as CUDA graphs whose IF
// and WHILE bodies hold only kernel, memcpy and memset nodes; a captured
// NCCL all-reduce across cards brings event wait and record nodes, which
// the bodies refuse.  This kernel is a plain kernel node.
//
// Each rank owns one buffer (cudaMalloc, exported with cudaIpcGetMemHandle
// and opened by every peer with cudaIpcOpenMemHandle): two lines of
// "ready" flags that the peers write (by epoch parity; flag q holds the
// last epoch of that parity rank q published and that call's tag), its
// epoch counter, and two slots (epoch parity) of kSlotBytes.  One launch
// is one all-reduce, one CTA of kThreads:
//   1. the epoch e = counter + 1, read from device memory (a CUDA graph
//      bakes its arguments, so a host epoch would repeat on every replay);
//   2. the input is copied into this rank's slot e & 1;
//   3. one thread per peer q stores (tag, e) into q's flag line e & 1 at
//      this rank's index (st.release.sys), then spins on this rank's flag
//      of q in line e & 1 until it holds e (ld.acquire.sys), bounded by
//      %globaltimer: a peer that never arrives ends in __trap(), a loud
//      error and never a hang;
//   4. every element is folded over the W slots in rank order 0..W-1 (sum,
//      or max that keeps a NaN), the same sequence of operations on every
//      rank, so every rank gets the same bits;
//   5. the counter is set to e.
// The slots alternate with the epoch's parity, which guards them without a
// second flag round: a rank starts call e + 1 only after its call e saw
// every peer's flag e, which each peer set after it finished reading the
// slots of call e - 1, the parity that call e + 1 overwrites.  For the same
// reason a peer is at most one call ahead, so while a rank waits in call e
// its flag of q in line e & 1 holds e - 2 or e, never more: the wait is for
// e exactly.  The tag is the call's (elements, op, dtype): a peer whose call
// e has another tag, or a flag past e, means the ranks' sequences of
// all-reduces differ, and the kernel traps.  Ranks whose sequences differ
// only in the order of calls of one tag, or in their values, are not told
// apart: lockstep is the callers' part.
//
// The loopback launch runs the same device code as W CTAs of one launch,
// CTA r playing rank r over W buffers in one allocation, so a single card
// holds the kernel against its plain version (W CTAs are co-resident).
//
// Bound: per rank, (W - 1) n elements cross NVLink (450 GB/s each way on
// an H100 SXM) at the sizes the layer reduces (43 to ~19k elements), far
// below a microsecond of bytes; the time is the flag round trip over
// NVLink (~1-3 us) and the launch.  One CTA is enough at these sizes.
//
// Plain C entry points bound by ctypes (ops/_build.py); each returns the
// cudaError_t of the calls it made.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace {

constexpr int kMaxRanks = 8;
constexpr int kThreads = 1024;
constexpr long long kReadyOffset = 0;       // u64 ready[2][kMaxRanks]
constexpr long long kEpochOffset = 128;     // unsigned epoch, its own line
constexpr long long kSlotOffset = 256;
constexpr long long kSlotBytes = 1 << 20;   // one parity's slot
constexpr long long kBufferBytes = kSlotOffset + 2 * kSlotBytes;

enum Op { kSum = 0, kMax = 1 };
enum Dtype { kF32 = 0, kI32 = 1, kI64 = 2 };

struct Peers {
  char* buf[kMaxRanks];
};

__device__ __forceinline__ void store_release_sys(unsigned long long* p,
                                                  unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// rank `buf`'s flag line of parity `parity`
__device__ __forceinline__ unsigned long long* ready_line(char* buf,
                                                          unsigned parity) {
  return reinterpret_cast<unsigned long long*>(buf + kReadyOffset) +
         parity * kMaxRanks;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int OP, typename T>
__device__ __forceinline__ T fold(T acc, T v) {
  if (OP == kSum) return acc + v;
  // torch.where(isnan(acc) | (acc > v), acc, v): a NaN on either side wins
  return (acc != acc || acc > v) ? acc : v;
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    peer_reduce_kernel(Peers peers, int rank_arg, int world, int loopback,
                       const T* in, T* out, long long n, unsigned tag,
                       unsigned long long timeout_ns) {
  const int rank = loopback ? static_cast<int>(blockIdx.x) : rank_arg;
  if (loopback) {
    in += rank * n;
    out += rank * n;
  }
  char* self = peers.buf[rank];
  unsigned* epoch_at = reinterpret_cast<unsigned*>(self + kEpochOffset);
  __shared__ unsigned s_epoch;
  if (threadIdx.x == 0) s_epoch = *reinterpret_cast<volatile unsigned*>(
                                      epoch_at) + 1u;
  __syncthreads();
  const unsigned e = s_epoch;
  const long long slot = kSlotOffset + (e & 1u) * kSlotBytes;

  T* mine = reinterpret_cast<T*>(self + slot);
  for (long long i = threadIdx.x; i < n; i += kThreads) mine[i] = in[i];
  __threadfence_system();
  __syncthreads();

  if (threadIdx.x < world) {
    const int q = threadIdx.x;
    store_release_sys(ready_line(peers.buf[q], e & 1u) + rank,
                      (static_cast<unsigned long long>(tag) << 32) | e);
    const unsigned long long* flag = ready_line(self, e & 1u) + q;
    const unsigned long long t0 = global_ns();
    for (;;) {
      const unsigned long long v = load_acquire_sys(flag);
      const unsigned got = static_cast<unsigned>(v);
      if (got == e && static_cast<unsigned>(v >> 32) == tag) break;
      if (got == e || static_cast<int>(got - e) > 0) {
        printf("peer_reduce: rank %d at epoch %u (tag %u) found rank %d at "
               "epoch %u (tag %u): the ranks' all-reduces differ; "
               "trapping\n", rank, e, tag, q, got,
               static_cast<unsigned>(v >> 32));
        __trap();
      }
      if (global_ns() - t0 > timeout_ns) {
        printf("peer_reduce: rank %d waited %llu ns for rank %d at epoch "
               "%u; trapping\n", rank, timeout_ns, q, e);
        __trap();
      }
    }
  }
  __syncthreads();

  for (long long i = threadIdx.x; i < n; i += kThreads) {
    T acc = reinterpret_cast<volatile const T*>(peers.buf[0] + slot)[i];
    for (int q = 1; q < world; ++q)
      acc = fold<OP>(acc,
                     reinterpret_cast<volatile const T*>(peers.buf[q] + slot)[i]);
    out[i] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) *epoch_at = e;
}

template <typename T, int OP>
cudaError_t launch(const Peers& peers, int rank, int world, int loopback,
                   const void* in, void* out, long long n, unsigned tag,
                   unsigned long long timeout_ns, cudaStream_t stream) {
  peer_reduce_kernel<T, OP><<<loopback ? world : 1, kThreads, 0, stream>>>(
      peers, rank, world, loopback, static_cast<const T*>(in),
      static_cast<T*>(out), n, tag, timeout_ns);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long bpvo_peer_buffer_bytes() { return kBufferBytes; }

extern "C" long long bpvo_peer_slot_bytes() { return kSlotBytes; }

extern "C" int bpvo_peer_max_ranks() { return kMaxRanks; }

// A zeroed buffer of bpvo_peer_buffer_bytes() on `device` and its IPC
// handle (cudaIpcMemHandle_t, 64 bytes, into `handle`).
extern "C" int bpvo_peer_alloc(int device, void** ptr, unsigned char* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(ptr, kBufferBytes);
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, kBufferBytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(&h, *ptr);
  if (e == cudaSuccess)
    for (int i = 0; i < static_cast<int>(sizeof(h)); ++i)
      handle[i] = reinterpret_cast<const unsigned char*>(&h)[i];
  return e;
}

extern "C" int bpvo_peer_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

// Map a peer's buffer (its 64-byte handle) into `device`'s address space.
extern "C" int bpvo_peer_open(int device, const unsigned char* handle,
                              void** ptr) {
  cudaIpcMemHandle_t h;
  for (int i = 0; i < static_cast<int>(sizeof(h)); ++i)
    reinterpret_cast<unsigned char*>(&h)[i] = handle[i];
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  return e;
}

extern "C" int bpvo_peer_close(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  return e == cudaSuccess ? cudaIpcCloseMemHandle(ptr) : e;
}

extern "C" int bpvo_peer_free(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  return e == cudaSuccess ? cudaFree(ptr) : e;
}

// One all-reduce of `n` elements of `dtype` (Dtype) with `op` (Op): `bufs`
// the W buffers by rank (this rank's own and the peers' mappings), `in`
// and `out` this rank's (they may be one tensor).  `loopback`: W CTAs, CTA
// r rank r, `in` and `out` (W, n) rows by rank, `bufs` W buffers of one
// device.  Returns cudaErrorInvalidValue for a world, size, op or dtype the
// kernel does not take.
extern "C" int bpvo_peer_reduce(void* const* bufs, int world, int rank,
                                int loopback, const void* in, void* out,
                                long long n, int op, int dtype,
                                unsigned long long timeout_ns, void* stream) {
  const long long elem = dtype == kI64 ? 8 : 4;
  if (world < 1 || world > kMaxRanks || rank < 0 || rank >= world || n < 0 ||
      n * elem > kSlotBytes || (op == kMax && dtype != kF32))
    return cudaErrorInvalidValue;
  Peers peers = {};
  for (int q = 0; q < world; ++q) peers.buf[q] = static_cast<char*>(bufs[q]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the call's tag: n < 2^18 (kSlotBytes / 4), op and dtype in 4 bits
  const unsigned tag = static_cast<unsigned>(n) << 4 | op << 2 | dtype;
  if (dtype == kF32 && op == kSum)
    return launch<float, kSum>(peers, rank, world, loopback, in, out, n,
                               tag, timeout_ns, s);
  if (dtype == kF32 && op == kMax)
    return launch<float, kMax>(peers, rank, world, loopback, in, out, n,
                               tag, timeout_ns, s);
  if (dtype == kI32 && op == kSum)
    return launch<int, kSum>(peers, rank, world, loopback, in, out, n,
                             tag, timeout_ns, s);
  if (dtype == kI64 && op == kSum)
    return launch<long long, kSum>(peers, rank, world, loopback, in, out, n,
                                   tag, timeout_ns, s);
  return cudaErrorInvalidValue;
}
