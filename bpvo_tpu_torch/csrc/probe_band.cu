// probe_band.cu - banded bilinear sampling and the five parts of it that the
// TPU probes compiled one by one, for NVIDIA Hopper (sm_90a).  Wrappers and
// plain PyTorch versions: bpvo_tpu_torch/probes/band.py.
//
// Replaces: scripts/probe_gather_variants.py _band_kernel (:133,
// pallas_call :171 in pallas_band_onehot :167): per block of 1024 points,
// the 32-row band of the 384x1280 image starting at min(min(floor v),
// H - 32), then bilinear sampling with the rows clipped into the band; and
// scripts/probe_band_bisect.py's five kernels (one pallas_call :30 in
// run_one :28): k_static_slice :50 (v1, band sum), k_dyn_slice :56 (v2, band
// sum at the dynamic base), k_onehot :64 (v3, a slice of the 2-hot x
// matrix), k_onehot_matmul :75 (v4, band @ 2-hot), k_rowweight :88 (v5,
// 2-hot row-weight reduce).  The TPU built (1280, 1024) one-hot matrices and
// ran them through the MXU because Mosaic had no per-lane gather; here a
// thread reads its two columns directly, so v3 and v4 write out[i, j] as the
// 2-hot weight and (1 - xf) band[i, xi] + xf band[i, xi + 1].
//
// What bounds it: band_bilinear at N = 16384 must read u, v (128 KB), write
// 64 KB and touch at most 4 pixels per point, ~0.1 us at 3.35 TB/s, against
// a launch of a few us; the staged variant also copies 16 bands of 160 KB
// (2.6 MB) into shared memory, which costs more than the 4 taps a point it
// serves.  v1-v5 are single-CTA kernels of a few hundred KB at most:
// launch-bound.
//
// Design: one CTA per block of 1024 points.  A block reduction finds
// min(floor v); the CTA then copies the band (contiguous in the image) into
// dynamic shared memory with cp.async, 16 bytes a thread where aligned, and
// samples from there.  band_bilinear_global keeps the same base and clipping
// but reads the taps straight from device memory: the comparison that says
// whether staging pays.  Products and sums are rounded one at a time in the
// plain version's order (__fmul_rn/__fadd_rn).  v1 and v2 sum the band in a
// fixed order (per-thread strided sums, then a fixed shuffle tree).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;           // one point per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

// Minimum of ``x`` over the CTA, returned to every thread.
__device__ int block_min(int x, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int m = lane < kWarps ? scratch[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) scratch[kWarps] = m;
  }
  __syncthreads();
  return scratch[kWarps];
}

// Sum of ``x`` over the CTA in a fixed order, returned to every thread.
__device__ float block_sum(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float m = lane < kWarps ? scratch[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = __fadd_rn(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) scratch[kWarps] = m;
  }
  __syncthreads();
  return scratch[kWarps];
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// The block's taps: xi, yi clipped into the image, the band base, and the
// row of the band that the point samples.
struct Taps {
  float xf, yf;
  int xi, rel;
};

__device__ __forceinline__ Taps block_taps(const float* __restrict__ u,
                                           const float* __restrict__ v,
                                           int p, int H, int W, int band,
                                           int* base_out, int* scratch) {
  const float uu = u[p], vv = v[p];
  const int xi = clampi(static_cast<int>(floorf(uu)), 0, W - 2);
  const int yi = clampi(static_cast<int>(floorf(vv)), 0, H - 2);
  const int base = min(block_min(yi, scratch), H - band);
  *base_out = base;
  return Taps{__fsub_rn(uu, static_cast<float>(xi)),
              __fsub_rn(vv, static_cast<float>(yi)), xi,
              clampi(yi - base, 0, band - 2)};
}

__device__ __forceinline__ float sample(const float* __restrict__ row0,
                                        int W, const Taps& t) {
  const float c0 = lerp_rn(row0[t.xi], row0[t.xi + 1], t.xf);
  const float c1 = lerp_rn(row0[W + t.xi], row0[W + t.xi + 1], t.xf);
  return lerp_rn(c0, c1, t.yf);
}

__global__ void __launch_bounds__(kThreads)
band_smem_kernel(const float* __restrict__ u, const float* __restrict__ v,
                 const float* __restrict__ img, float* __restrict__ out,
                 int H, int W, int band) {
  extern __shared__ float sband[];
  __shared__ int scratch[kWarps + 1];
  const int p = blockIdx.x * kThreads + threadIdx.x;
  int base;
  const Taps t = block_taps(u, v, p, H, W, band, &base, scratch);
  const float* src = img + (size_t)base * W;
  const int count = band * W;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (count & 3) == 0) {
    for (int q = threadIdx.x; q < count / 4; q += kThreads)
      cp_async16(sband + 4 * q, src + 4 * q);
  } else {
    for (int q = threadIdx.x; q < count; q += kThreads)
      cp_async4(sband + q, src + q);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  out[p] = sample(sband + t.rel * W, W, t);
}

__global__ void __launch_bounds__(kThreads)
band_global_kernel(const float* __restrict__ u, const float* __restrict__ v,
                   const float* __restrict__ img, float* __restrict__ out,
                   int H, int W, int band) {
  __shared__ int scratch[kWarps + 1];
  const int p = blockIdx.x * kThreads + threadIdx.x;
  int base;
  const Taps t = block_taps(u, v, p, H, W, band, &base, scratch);
  out[p] = sample(img + (size_t)(base + t.rel) * W, W, t);
}

// v1 and v2: the sum of rows [base, base + band), broadcast to (8, 128).
__device__ void band_sum_out(const float* __restrict__ img, int base, int W,
                             int band, float* __restrict__ out,
                             float* scratch) {
  const float* src = img + (size_t)base * W;
  float acc = 0.0f;
  for (int q = threadIdx.x; q < band * W; q += kThreads)
    acc = __fadd_rn(acc, src[q]);
  out[threadIdx.x] = block_sum(acc, scratch);
}

__global__ void __launch_bounds__(kThreads)
static_slice_kernel(const float* __restrict__ img, int W, int band,
                    float* __restrict__ out) {
  __shared__ float scratch[kWarps + 1];
  band_sum_out(img, 0, W, band, out, scratch);
}

// base = min(min(floor v), H - band), then clamped to [0, H - band] as
// dynamic_slice clamps its start.
__global__ void __launch_bounds__(kThreads)
dyn_slice_kernel(const float* __restrict__ v, int n, const float* __restrict__ img,
                 int H, int W, int band, float* __restrict__ out) {
  __shared__ int iscratch[kWarps + 1];
  __shared__ float scratch[kWarps + 1];
  int m = INT_MAX;
  for (int q = threadIdx.x; q < n; q += kThreads)
    m = min(m, static_cast<int>(floorf(v[q])));
  const int base = clampi(min(block_min(m, iscratch), H - band), 0, H - band);
  band_sum_out(img, base, W, band, out, scratch);
}

// out (8, 128): rows are columns c = 0..7 of the 2-hot matrix, columns are
// points j = 0..127.  Thread t computes out[t / 128][t % 128].
__global__ void __launch_bounds__(kThreads)
onehot_kernel(const float* __restrict__ u, int W, float* __restrict__ out) {
  const int c = threadIdx.x / 128, j = threadIdx.x % 128;
  const float uu = u[j];
  const int xi = clampi(static_cast<int>(floorf(uu)), 0, W - 2);
  const float xf = __fsub_rn(uu, static_cast<float>(xi));
  out[threadIdx.x] = c == xi ? __fsub_rn(1.0f, xf) : (c == xi + 1 ? xf : 0.0f);
}

// out[i, j] = (1 - xf_j) img[i, xi_j] + xf_j img[i, xi_j + 1]
__global__ void __launch_bounds__(kThreads)
onehot_matmul_kernel(const float* __restrict__ u,
                     const float* __restrict__ img, int W,
                     float* __restrict__ out) {
  const int i = threadIdx.x / 128, j = threadIdx.x % 128;
  const float uu = u[j];
  const int xi = clampi(static_cast<int>(floorf(uu)), 0, W - 2);
  const float xf = __fsub_rn(uu, static_cast<float>(xi));
  const float* row = img + (size_t)i * W;
  out[threadIdx.x] = lerp_rn(row[xi], row[xi + 1], xf);
}

// out[i, j] = (1 - yf_j) img[rel_j, 0] + yf_j img[rel_j + 1, 0], rel_j =
// clip(floor v_j, 0, band - 2), for every row i.
__global__ void __launch_bounds__(kThreads)
rowweight_kernel(const float* __restrict__ v, const float* __restrict__ img,
                 int W, int band, float* __restrict__ out) {
  const int j = threadIdx.x % 128;
  const float vv = v[j];
  const int yi = static_cast<int>(floorf(vv));
  const float yf = __fsub_rn(vv, static_cast<float>(yi));
  const int rel = clampi(yi, 0, band - 2);
  out[threadIdx.x] = lerp_rn(img[(size_t)rel * W], img[(size_t)(rel + 1) * W],
                             yf);
}

int ret(cudaError_t e) { return static_cast<int>(e); }

}  // namespace

// u, v (N,), N a multiple of 1024; img (H, W) with H >= band and the band
// (band * W floats) within the 227 KB a CTA can hold when ``staged``.
extern "C" int bpvo_probe_band_bilinear(const float* u, const float* v,
                                        const float* img, float* out, int N,
                                        int H, int W, int band, int staged,
                                        void* stream) {
  if (N % kThreads != 0 || band < 2 || H < band || W < 2)
    return ret(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = N / kThreads;
  if (blocks == 0) return ret(cudaSuccess);
  if (staged) {
    const size_t smem = (size_t)band * W * sizeof(float);
    if (smem > (size_t)kMaxSmemBytes) return ret(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        band_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return ret(e);
    band_smem_kernel<<<blocks, kThreads, smem, s>>>(u, v, img, out, H, W,
                                                    band);
  } else {
    band_global_kernel<<<blocks, kThreads, 0, s>>>(u, v, img, out, H, W, band);
  }
  return ret(cudaGetLastError());
}

extern "C" int bpvo_probe_band_static_slice(const float* img, int H, int W,
                                            int band, float* out,
                                            void* stream) {
  if (H < band) return ret(cudaErrorInvalidValue);
  static_slice_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, W, band, out);
  return ret(cudaGetLastError());
}

extern "C" int bpvo_probe_band_dyn_slice(const float* v, int n,
                                         const float* img, int H, int W,
                                         int band, float* out, void* stream) {
  if (H < band) return ret(cudaErrorInvalidValue);
  dyn_slice_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, n, img, H, W, band, out);
  return ret(cudaGetLastError());
}

extern "C" int bpvo_probe_band_onehot(const float* u, int W, float* out,
                                      void* stream) {
  onehot_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(u, W,
                                                                      out);
  return ret(cudaGetLastError());
}

extern "C" int bpvo_probe_band_onehot_matmul(const float* u, const float* img,
                                             int W, float* out, void* stream) {
  onehot_matmul_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, img, W, out);
  return ret(cudaGetLastError());
}

extern "C" int bpvo_probe_band_rowweight(const float* v, const float* img,
                                         int W, int band, float* out,
                                         void* stream) {
  rowweight_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, img, W, band, out);
  return ret(cudaGetLastError());
}
