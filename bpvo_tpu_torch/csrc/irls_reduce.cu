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
// at 3.35 TB/s; ~64 flops per term (FMAs in registers, no tensor cores) are
// far below the card's rate.
//
// Design: one launch per call (gn_reduce.cuh: warp reduce-scatter, block
// fold, completion ticket; bitwise repeatable).  A block owns threads x
// unroll x tiles consecutive terms; launch_for picks the shape from M.  Per
// tile each thread issues the loads of its `unroll` terms together: the
// validity, the residual and the J row as three 8-byte loads, then sums
// them in a fixed order.  Bringing a tile's residuals and J rows into shared
// memory by bulk copies (cp.async.bulk on an mbarrier) was built and timed
// by the launch-shape sweep and was never faster (PERF.md §6), so
// the kernel reads straight from global memory.  J stays in the template's
// own (M, 6) layout: the TPU kernel's (6, M) transpose and 8-row slabs were
// there for its lanes and MXU.  A null w pointer skips the weight store
// (irls_reduce); the sums are the same bit for bit.  Sigma is read from
// device memory.

#include <stdint.h>

#include "gn_reduce.cuh"

namespace {

// Threads, terms per thread per tile and tiles per block for M terms (from
// scripts/gn_kernel_bench.py --sweep).
gn::Launch launch_for(int M) {
  return gn::launch_for_points(M, 4);
}

template <int U>
__global__ void __launch_bounds__(gn::kMaxThreads)
irls_reduce_kernel(const float* __restrict__ J, const float* __restrict__ r,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ sigma_ptr, int M, int tiles,
                   int loss, float* __restrict__ w,
                   float* __restrict__ partials, unsigned int* ticket,
                   float* __restrict__ out) {
  const int B = blockDim.x, tid = threadIdx.x;
  const float sigma = __ldg(sigma_ptr);
  float acc[gn::kSys];
#pragma unroll
  for (int i = 0; i < gn::kSys; ++i) acc[i] = 0.0f;

  for (int t = 0; t < tiles; ++t) {
    const int m0 = (blockIdx.x * tiles + t) * B * U;
    const int n = max(0, min(B * U, M - m0));   // terms of this tile
    const float* r0 = r + m0;
    const float* J0 = J + (size_t)m0 * 6;
    bool ok[U];
#pragma unroll
    for (int p = 0; p < U; ++p) {
      const int i = p * B + tid;
      ok[p] = i < n && valid[m0 + i];
    }
    float rm[U], j[U][6];
#pragma unroll
    for (int p = 0; p < U; ++p) {
      const int i = p * B + tid;
      if (i < n) {
        rm[p] = __ldg(r0 + i);
        gn::load_row(J0 + (size_t)i * 6, j[p]);
      }
    }
#pragma unroll
    for (int p = 0; p < U; ++p) {
      const int i = p * B + tid;
      if (i >= n) continue;
      const float wv = ok[p] ? gn::robust_weight(rm[p] / sigma, loss) : 0.0f;
      if (w != nullptr) w[m0 + i] = wv;
      if (wv != 0.0f) gn::accumulate(acc, j[p], rm[p], wv);
    }
  }
  gn::reduce_to(acc, partials, ticket, out);
}

template <int U>
int launch(const gn::Launch& l, int blocks, cudaStream_t s, const float* J,
           const float* r, const uint8_t* valid, const float* sigma, int M,
           int loss, float* w, float* partials, unsigned int* ticket,
           float* out) {
  irls_reduce_kernel<U><<<blocks, l.threads, 0, s>>>(
      J, r, valid, sigma, M, l.tiles, loss, w, partials, ticket, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks for M terms: the size of the partials scratch is this times 28
// floats.
extern "C" int bpvo_irls_reduce_blocks(int M) {
  return gn::blocks_for(launch_for(M), M);
}

extern "C" int bpvo_irls_reduce(const float* J, const float* r,
                                const uint8_t* valid, const float* sigma,
                                int M, int loss, float* w, float* partials,
                                unsigned int* ticket, float* out,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const gn::Launch l = launch_for(M);
  const int blocks = gn::blocks_for(l, M);
  switch (l.unroll) {
    case 1:
      return launch<1>(l, blocks, s, J, r, valid, sigma, M, loss, w, partials,
                       ticket, out);
    case 2:
      return launch<2>(l, blocks, s, J, r, valid, sigma, M, loss, w, partials,
                       ticket, out);
    default:
      return launch<4>(l, blocks, s, J, r, valid, sigma, M, loss, w, partials,
                       ticket, out);
  }
}
