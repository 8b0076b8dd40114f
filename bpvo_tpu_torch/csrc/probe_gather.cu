// probe_gather.cu - take_along_axis on lanes, out[r, j] = data[r, idx[r, j]],
// in three placements of the data, for NVIDIA Hopper (sm_90a).  Wrapper and
// plain PyTorch version: bpvo_tpu_torch/probes/gather.py.
//
// Replaces: scripts/probe_gather_variants.py _taa_kernel (:99, pallas_call
// :110 in pallas_taa :103; rows 8, lanes 1024 / 16384 / 384*1280, N = 16384)
// and scripts/tpu_kernel_probe.py _gather_kernel (:76, pallas_call :88;
// data (8, 376*1241)), the same function.  On the TPU they asked whether
// Mosaic's lane gather works from a VMEM-resident array; on the card they
// ask where a gather should read from, which decides where level_gn's image
// lives in a multi-SM design:
//   (a) global: the data stays in device memory and, at these sizes
//       (32 KB - 15.7 MB), in the 50 MB L2; each thread reads one value
//       (ld.global.cg: L2, not L1);
//   (b) smem: one CTA per row stages the row in shared memory (lanes <=
//       58112, the 227 KB a CTA can hold) and gathers from there;
//   (c) dsmem: a cluster of 16 CTAs per row splits the row over their
//       shared memory (376*1241 lanes: 117 KB per CTA) and each gather
//       reads the owner's slice through DSMEM (map_shared_rank).
// An index outside [0, lanes) gives NaN, as JAX's fill mode does.
//
// What bounds it: latency.  16384 outputs move 64 KB of indices, 64 KB of
// results and at most 16384 distinct 4-byte values: ~0.06 us at 3.35 TB/s.
// (b) and (c) also copy whole rows into shared memory, which at (8, 1024)
// or (8, 16384) is a few hundred KB but at the L0 image 15 MB: there the
// staging, not the gather, is their cost, and it pays only when many
// gathers (GN iterations) reuse one staging.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;         // (a)
constexpr int kSmemThreads = 1024;    // (b)
constexpr int kDsmemThreads = 512;    // (c), per CTA
constexpr int kCluster = 16;          // (c), CTAs per row (non-portable size)
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ float nan_fill() { return __int_as_float(0x7fffffff); }

__global__ void __launch_bounds__(kThreads)
take_global_kernel(const int* __restrict__ idx, const float* __restrict__ data,
                   float* __restrict__ out, int lanes, int n) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int r = blockIdx.y;
  if (j >= n) return;
  const size_t o = (size_t)r * n + j;
  const int i = idx[o];
  out[o] = (i >= 0 && i < lanes) ? __ldcg(data + (size_t)r * lanes + i)
                                 : nan_fill();
}

// Copy ``count`` floats to shared memory, 16 bytes a thread where the
// source is aligned.
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src,
                                      int count, int tid, int nthreads) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = count / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int q = tid; q < n4; q += nthreads) d4[q] = __ldcs(s4 + q);
    for (int q = 4 * n4 + tid; q < count; q += nthreads) dst[q] = src[q];
  } else {
    for (int q = tid; q < count; q += nthreads) dst[q] = src[q];
  }
}

__global__ void __launch_bounds__(kSmemThreads)
take_smem_kernel(const int* __restrict__ idx, const float* __restrict__ data,
                 float* __restrict__ out, int lanes, int n) {
  extern __shared__ float row[];
  const int r = blockIdx.x;
  stage(row, data + (size_t)r * lanes, lanes, threadIdx.x, kSmemThreads);
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kSmemThreads) {
    const size_t o = (size_t)r * n + j;
    const int i = idx[o];
    out[o] = (i >= 0 && i < lanes) ? row[i] : nan_fill();
  }
}

// grid (kCluster, rows), one cluster per row: CTA q holds lanes
// [q * slice, (q + 1) * slice) and answers outputs [q * chunk, (q + 1) *
// chunk) of the row.
__global__ void __launch_bounds__(kDsmemThreads)
take_dsmem_kernel(const int* __restrict__ idx, const float* __restrict__ data,
                  float* __restrict__ out, int lanes, int n, int slice) {
  extern __shared__ float part[];
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int r = blockIdx.y;
  const int lo = q * slice;
  const int count = lanes - lo < slice ? lanes - lo : slice;
  if (count > 0)
    stage(part, data + (size_t)r * lanes + lo, count, threadIdx.x,
          kDsmemThreads);
  cluster.sync();   // every slice staged before any remote read
  const int chunk = (n + kCluster - 1) / kCluster;
  const int end = (q + 1) * chunk < n ? (q + 1) * chunk : n;
  for (int j = q * chunk + threadIdx.x; j < end; j += kDsmemThreads) {
    const size_t o = (size_t)r * n + j;
    const int i = idx[o];
    float val = nan_fill();
    if (i >= 0 && i < lanes) {
      const int owner = i / slice;
      const float* src = cluster.map_shared_rank(&part[0], owner);
      val = src[i - owner * slice];
    }
    out[o] = val;
  }
  cluster.sync();   // no CTA leaves while another still reads its slice
}

cudaLaunchConfig_t dsmem_config(int rows, size_t smem, cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, rows);
  cfg.blockDim = dim3(kDsmemThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The slice's shared memory and a cluster of 16 (above the portable 8).
cudaError_t dsmem_attributes(size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      take_dsmem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(take_dsmem_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

}  // namespace

extern "C" int bpvo_probe_take_global(const int* idx, const float* data,
                                      float* out, int rows, int lanes, int n,
                                      void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, rows);
  take_global_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, data, out, lanes, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bpvo_probe_take_smem(const int* idx, const float* data,
                                    float* out, int rows, int lanes, int n,
                                    void* stream) {
  const size_t smem = (size_t)lanes * sizeof(float);
  if (lanes < 1 || smem > (size_t)kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      take_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  take_smem_kernel<<<rows, kSmemThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(idx, data, out,
                                                          lanes, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bpvo_probe_take_dsmem(const int* idx, const float* data,
                                     float* out, int rows, int lanes, int n,
                                     void* stream) {
  if (lanes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int slice = (lanes + kCluster - 1) / kCluster;
  const size_t smem = (size_t)slice * sizeof(float);
  if (smem > (size_t)kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = dsmem_attributes(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = dsmem_config(
      rows, smem, static_cast<cudaStream_t>(stream), attr);
  e = cudaLaunchKernelEx(&cfg, take_dsmem_kernel, idx, data, out, lanes, n,
                         slice);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of (c) at ``lanes`` can be resident on the card at once
// (cudaOccupancyMaxActiveClusters); a cluster needs 16 SMs of one GPC with
// the slice's shared memory free.
extern "C" int bpvo_probe_take_dsmem_clusters(int lanes, int* out) {
  const int slice = (lanes + kCluster - 1) / kCluster;
  const size_t smem = (size_t)slice * sizeof(float);
  cudaError_t e = dsmem_attributes(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = dsmem_config(1, smem, 0, attr);
  e = cudaOccupancyMaxActiveClusters(out, take_dsmem_kernel, &cfg);
  return static_cast<int>(e);
}
