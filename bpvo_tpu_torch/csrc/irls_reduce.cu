// irls_reduce.cu - IRLS weights and the Gauss-Newton normal equations from
// given residuals, for NVIDIA Hopper (sm_90a).
//
// Replaces: bpvo_tpu/ops/pallas/irls_kernel.py, irls_reduce_w (kernel
// _irls_kernel_w, pallas_call at :135) and irls_reduce (kernel _irls_kernel,
// pallas_call at :185): w = valid * rho'(r / sigma) / (r / sigma), then
// H = J^T W J, g = J^T W r and sum w r^2.  Wrapper and plain PyTorch version:
// bpvo_tpu_torch/ops/irls.py.  gauss_newton.run calls it to rebuild a C = 1
// system at the sigma just re-estimated from the fused pass's residuals.
//
// What bounds it: per term it reads J (24 B), r and the validity (5 B) and
// may write w (4 B): 4-35 MB for M = 131072 to 1048576 terms, a few to ~10 us
// at 3.35 TB/s; ~60 flops per term are far below the card's rate.
//
// Design: a grid-stride loop with a fixed grid for a given M, so each thread
// sums its terms in a fixed order; the block and grid sums are gn_reduce.cuh's
// two fixed-order passes (no atomics, bitwise repeatable).  J stays in the
// template's own (M, 6) layout: the TPU kernel's (6, M) transpose and 8-row
// slabs were there for its lanes and MXU.  A null w pointer skips the weight
// store (irls_reduce).  Sigma is read from device memory.

#include <stdint.h>

#include "gn_reduce.cuh"

namespace {

// enough blocks to fill the 132 SMs several times over at any M
constexpr int kMaxBlocks = 132 * 8;

__global__ void __launch_bounds__(gn::kThreads)
irls_reduce_kernel(const float* __restrict__ J, const float* __restrict__ r,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ sigma_ptr, int M, int loss,
                   float* __restrict__ w, float* __restrict__ partials) {
  float acc[gn::kSys];
#pragma unroll
  for (int i = 0; i < gn::kSys; ++i) acc[i] = 0.0f;
  const float sigma = *sigma_ptr;
  const int stride = gridDim.x * gn::kThreads;
  for (int m = blockIdx.x * gn::kThreads + threadIdx.x; m < M; m += stride) {
    const float rm = r[m];
    const float wv = valid[m] ? gn::robust_weight(rm / sigma, loss) : 0.0f;
    if (w != nullptr) w[m] = wv;
    if (wv != 0.0f) gn::accumulate(acc, J + (size_t)m * 6, rm, wv);
  }
  gn::store_block_partial(acc, partials);
}

}  // namespace

// Blocks of the first pass for M terms: the size of the partials scratch is
// this times 28 floats.
extern "C" int bpvo_irls_reduce_blocks(int M) {
  const int blocks = (M + gn::kThreads - 1) / gn::kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

extern "C" int bpvo_irls_reduce(const float* J, const float* r,
                                const uint8_t* valid, const float* sigma,
                                int M, int loss, float* w, float* partials,
                                float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = bpvo_irls_reduce_blocks(M);
  irls_reduce_kernel<<<blocks, gn::kThreads, 0, s>>>(J, r, valid, sigma, M,
                                                       loss, w, partials);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return gn::reduce_partials(partials, blocks, out, s);
}
