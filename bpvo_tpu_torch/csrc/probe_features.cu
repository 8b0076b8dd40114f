// probe_features.cu - the in-kernel loop, scalar-chain and matmul-chain
// probes, for NVIDIA Hopper (sm_90a).  Wrappers and plain PyTorch versions:
// bpvo_tpu_torch/probes/kernel_features.py.
//
// Replaces: scripts/probe_kernel_features.py, whose three kernels asked
// whether Mosaic compiles what the in-kernel Gauss-Newton loop needs:
//   k_while (:37, pallas_call :76): a 7-step while_loop carrying a scalar
//     and an (8,128) array, v <- 1.5 v + 1, out = v + i;
//   k_scalar_chain (:52, pallas_call :82): l0 = sqrt(max(a, 1e-20)),
//     l1 = b / l0, l2 = sqrt(max(c - l1^2, 1e-20)), the 6x6 Cholesky's chain;
//   k_matmul_chain (:63, pallas_call :89): 5 dependent (8,128)@(128,128)
//     products, each scaled by 1e-2.
// On the card the question is no longer whether they compile but what they
// cost, and the answer is what level_gn's multi-SM redesign needs: what one
// loop iteration costs when every iteration ends in a barrier over one CTA,
// a thread-block cluster or the whole grid.
//
// What bounds them: latency.  8 KB in and out and 1-2 flops per element per
// iteration are nothing to the card; each iteration costs its barrier and
// the broadcast of the loop counter.
//
// Design: the while loop's scalar carry (the counter) lives where the
// barrier's scope can see it - the CTA's shared memory, CTA 0's shared
// memory read by the others through DSMEM, or device memory - and only one
// thread advances it, so each iteration needs its barrier as level_gn's
// converged flag does.  Two counter slots alternate, so one barrier per
// iteration suffices.  Every step rounds with __fmul_rn/__fadd_rn, so no
// FMA contraction separates the result from the plain version's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxPerThread = 4;   // elements each thread carries
constexpr int kCtaThreads = 1024;  // the CTA variant; the cluster's total
constexpr int kGridThreads = 128;  // per CTA of the cooperative grid

__device__ __forceinline__ float while_step(float v) {
  return __fadd_rn(__fmul_rn(v, 1.5f), 1.0f);
}

// The loop shared by the three variants.  ``Sync`` is the barrier,
// ``publish(slot, value)`` the leader's store of the counter and
// ``fetch(slot)`` every thread's read of it after the barrier.
template <typename Sync, typename Publish, typename Fetch>
__device__ __forceinline__ void while_body(const float* __restrict__ x,
                                           float* __restrict__ out, int n,
                                           int iters, int tid, int nthreads,
                                           bool leader, Sync sync,
                                           Publish publish, Fetch fetch) {
  float v[kMaxPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int e = tid + k * nthreads;
    v[k] = e < n ? x[e] : 0.0f;
  }
  int i = 0;
  while (i < iters) {
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) v[k] = while_step(v[k]);
    if (leader) publish((i + 1) & 1, i + 1);
    sync();
    i = fetch((i + 1) & 1);
  }
  const float fi = static_cast<float>(i);
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int e = tid + k * nthreads;
    if (e < n) out[e] = __fadd_rn(v[k], fi);
  }
}

__global__ void __launch_bounds__(kCtaThreads)
while_cta_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                 int iters) {
  __shared__ int counter[2];
  while_body(
      x, out, n, iters, threadIdx.x, blockDim.x, threadIdx.x == 0,
      [] { __syncthreads(); },
      [&](int slot, int value) { counter[slot] = value; },
      [&](int slot) { return counter[slot]; });
}

__global__ void __launch_bounds__(kCtaThreads)
while_cluster_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int n, int iters) {
  __shared__ int counter[2];
  cg::cluster_group cluster = cg::this_cluster();
  // the counter is CTA 0's; the others read it through DSMEM
  volatile int* shared0 = cluster.map_shared_rank(&counter[0], 0);
  const bool leader = cluster.block_rank() == 0 && threadIdx.x == 0;
  while_body(
      x, out, n, iters, blockIdx.x * blockDim.x + threadIdx.x,
      gridDim.x * blockDim.x, leader, [&] { cluster.sync(); },
      [&](int slot, int value) { shared0[slot] = value; },
      [&](int slot) { return shared0[slot]; });
  cluster.sync();   // CTA 0's shared memory outlives every remote read
}

__global__ void __launch_bounds__(kGridThreads)
while_grid_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                  int iters, int* __restrict__ counter) {
  cg::grid_group grid = cg::this_grid();
  volatile int* c = counter;
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;
  while_body(
      x, out, n, iters, blockIdx.x * blockDim.x + threadIdx.x,
      gridDim.x * blockDim.x, leader, [&] { grid.sync(); },
      [&](int slot, int value) { c[slot] = value; },
      [&](int slot) { return c[slot]; });
}

__global__ void scalar_chain_kernel(const float* __restrict__ h,
                                    float* __restrict__ o) {
  if (threadIdx.x != 0) return;
  const float l0 = __fsqrt_rn(fmaxf(h[0], 1e-20f));
  const float l1 = __fdiv_rn(h[1], l0);
  const float l2 = __fsqrt_rn(fmaxf(__fsub_rn(h[2], __fmul_rn(l1, l1)),
                                    1e-20f));
  o[0] = l0;
  o[1] = l1;
  o[2] = l2;
}

constexpr int kMmRows = 8, kMmK = 128, kMmN = 128;
constexpr int kMmOut = kMmRows * kMmN;   // one output per thread
constexpr size_t kMmSmem = (kMmK * kMmN + 2 * kMmRows * kMmK) * sizeof(float);

// x <- scale * (x @ B), n times: B (64 KB) and two copies of x in shared
// memory; thread t owns out[t / 128][t % 128], 128 FMAs per product.  The
// row of x is one broadcast address per warp, B's row is read by
// neighbouring threads from neighbouring banks.
__global__ void __launch_bounds__(kMmOut)
matmul_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int n, float scale) {
  extern __shared__ float smem[];
  float* sb = smem;
  float* sx = smem + kMmK * kMmN;
  const int t = threadIdx.x;
  for (int q = t; q < kMmK * kMmN; q += kMmOut) sb[q] = b[q];
  sx[t] = a[t];
  __syncthreads();
  const int r = t / kMmN, c = t % kMmN;
  int cur = 0;
  for (int s = 0; s < n; ++s) {
    const float* x = sx + cur * kMmOut + r * kMmK;
    float acc = 0.0f;
#pragma unroll 16
    for (int k = 0; k < kMmK; ++k) acc = fmaf(x[k], sb[k * kMmN + c], acc);
    sx[(cur ^ 1) * kMmOut + t] = __fmul_rn(acc, scale);
    __syncthreads();
    cur ^= 1;
  }
  out[t] = sx[cur * kMmOut + t];
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

extern "C" int bpvo_probe_while_cta(const float* x, float* out, int n,
                                    int iters, void* stream) {
  if (n < 0 || n > kCtaThreads * kMaxPerThread)
    return static_cast<int>(cudaErrorInvalidValue);
  while_cta_kernel<<<1, kCtaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, iters);
  return static_cast<int>(cudaGetLastError());
}

// One cluster of ``cluster`` CTAs (2..16; above 8 is a non-portable size)
// sharing the 1024 threads.
extern "C" int bpvo_probe_while_cluster(const float* x, float* out, int n,
                                        int iters, int cluster, void* stream) {
  if (n < 0 || n > kCtaThreads * kMaxPerThread || cluster < 1 ||
      cluster > 16 || kCtaThreads % cluster != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        while_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kCtaThreads / cluster);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, while_cluster_kernel, x, out,
                                           n, iters);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the cooperative grid: one per SM.
extern "C" int bpvo_probe_while_grid_ctas() { return sm_count(); }

// A cooperative grid of one 128-thread CTA per SM; ``counter`` is 2 ints of
// device scratch.
extern "C" int bpvo_probe_while_grid(const float* x, float* out, int n,
                                     int iters, int* counter, void* stream) {
  const int ctas = sm_count();
  if (n < 0 || n > ctas * kGridThreads * kMaxPerThread)
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {const_cast<float**>(&x), &out, &n, &iters, &counter};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(while_grid_kernel), dim3(ctas),
      dim3(kGridThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bpvo_probe_scalar_chain(const float* h, float* out,
                                       void* stream) {
  scalar_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(h,
                                                                       out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bpvo_probe_matmul_chain(const float* a, const float* b,
                                       float* out, int n, float scale,
                                       void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      matmul_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMmSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  matmul_chain_kernel<<<1, kMmOut, kMmSmem,
                        static_cast<cudaStream_t>(stream)>>>(a, b, out, n,
                                                             scale);
  return static_cast<int>(cudaGetLastError());
}
