// gn_reduce.cuh - what the per-iteration Gauss-Newton kernels share
// (fused_linearize.cu, irls_reduce.cu): the M-estimator weight, the 28
// products of one term of the normal equations, and a deterministic
// two-pass reduction of them over the whole grid.
//
// The 28 sums are the 21 upper-triangle entries of H = J^T W J (row-major),
// the 6 of g = J^T W r and sum w r^2.  Pass 1: each block folds its threads'
// sums by warp shuffles and then warp 0 over the per-warp partials, in a
// fixed order, and stores one partial per block.  Pass 2 (one block, one warp
// per sum) adds the block partials in a fixed order and writes H (6x6, both
// triangles), g and sum w r^2 as 43 floats.  No atomics: a run is bitwise
// repeatable.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gn {
namespace {  // internal linkage: each source gets its own copy

constexpr int kSys = 28;
constexpr int kThreads = 256;   // threads of a pass-1 block
constexpr float kTukeyT = 4.685f;
constexpr float kHuberK = 1.345f;

enum Loss { kTukey = 0, kHuber = 1, kL2 = 2 };

// IRLS weight of u = r / sigma, rounded like the plain version
// (mestimator.compute_weights): every product on its own.
__device__ __forceinline__ float robust_weight(float u, int loss) {
  if (loss == kTukey) {
    const float x = u / kTukeyT;
    const float w = __fsub_rn(1.0f, __fmul_rn(x, x));
    return fabsf(u) < kTukeyT ? __fmul_rn(w, w) : 0.0f;
  }
  if (loss == kHuber) {
    const float au = fabsf(u);
    return au < kHuberK ? 1.0f : kHuberK / fmaxf(au, 1e-20f);
  }
  return 1.0f;
}

// Adds one term's products, in linear_system.build's order: (J_i w) J_j,
// (J_i w) r and (r w) r.
__device__ __forceinline__ void accumulate(float (&acc)[kSys],
                                           const float* __restrict__ J,
                                           float r, float w) {
  float j[6], lj[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    j[i] = __ldg(J + i);
    lj[i] = j[i] * w;
  }
  int idx = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int k = i; k < 6; ++k) acc[idx++] += lj[i] * j[k];
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += lj[i] * r;
  acc[27] += (r * w) * r;
}

// Pass 1: the block's sums of acc, stored at partials[blockIdx.x * kSys].
// Called by every thread of a kThreads block.
__device__ __forceinline__ void store_block_partial(
    float (&acc)[kSys], float* __restrict__ partials) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float red[kWarps][kSys];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kSys; ++i) {
    float x = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp][i] = x;
  }
  __syncthreads();
  if (warp == 0 && lane < kSys) {
    float x = red[0][lane];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) x += red[k][lane];
    partials[(size_t)blockIdx.x * kSys + lane] = x;
  }
}

// Pass 2: one block of kSys warps; warp i adds sum i over the blocks (lane
// l takes blocks l, l+32, ... in order, then a shuffle tree).
__global__ void __launch_bounds__(kSys * 32)
reduce_partials_kernel(const float* __restrict__ partials, int n_blocks,
                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int i = threadIdx.x >> 5;
  float x = 0.0f;
  for (int b = lane; b < n_blocks; b += 32)
    x += partials[(size_t)b * kSys + i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  if (lane != 0) return;
  if (i < 21) {
    // upper-triangle index i -> (row, col)
    int row = 0, rem = i;
    while (rem >= 6 - row) {
      rem -= 6 - row;
      ++row;
    }
    const int col = row + rem;
    out[6 * row + col] = x;
    out[6 * col + row] = x;
  } else {
    out[36 + (i - 21)] = x;   // g, then sum w r^2 at out[42]
  }
}

inline int reduce_partials(const float* partials, int n_blocks, float* out,
                           cudaStream_t stream) {
  reduce_partials_kernel<<<1, kSys * 32, 0, stream>>>(partials, n_blocks, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gn
