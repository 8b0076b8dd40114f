// fused_linearize.cu - one Gauss-Newton linearization at a fixed pose and
// sigma, for NVIDIA Hopper (sm_90a): sample C channels at the warped points,
// form residuals, weight them and reduce the normal equations.
//
// Replaces: bpvo_tpu/ops/pallas/gn_kernel.py, make_fused_linearize (kernel
// _kernel, C = 1, pallas_call at :211) and make_fused_linearize_stacked
// (kernel _stacked_kernel, C > 1, pallas_call at :468).  Wrapper and plain
// PyTorch version: bpvo_tpu_torch/ops/fused_linearize.py.
//
// What bounds it: a dense KITTI L0 has K = 131072 points.  Per point it reads
// u, v, the validity and C x (4 taps, 1 pixel, 6 Jacobian floats) and writes C
// weights: ~45 B at C = 1 and ~390 B at C = 8, so 6-51 MB per call against
// 3.35 TB/s, with the taps gathered from a 1.9-15 MB image stack.  The
// arithmetic (~60 flops per point and channel) is small: FMAs in registers,
// no tensor cores.  At these sizes the kernel is bound by its launch and by
// chains of dependent memory latencies.
//
// Design: one launch per call (gn_reduce.cuh: warp reduce-scatter, block
// fold, completion ticket; bitwise repeatable).  A block owns threads x
// unroll x tiles consecutive points (launch_for picks the shape from K and
// C).  Per tile each thread loads the validity and coordinates of its
// `unroll` points at once and computes their tap cells and weights once for
// every channel (the TPU stacked kernel's "2-hot built once per block"
// saving, without the MXU).  Then, for each group of G channels, it issues
// every load of the group (pixel, Jacobian row as three 8-byte loads, 4
// taps per point and channel) before it uses any: a point's chain is
// 1 + C / G latencies.  The template's pixels and Jacobians are read by
// these per-thread loads, not staged in shared memory (bulk copies were
// timed only in irls_reduce, where they were never faster; PERF.md §6).  The
// channels of a point share its cell, so a point's taps in all channels are
// read close together in time (a layout with one thread per point and
// channel lost that locality at C = 8 and took twice as long; PERF.md §6).
// The taps come straight from global memory through L2 (faster than
// staging them in SMEM or DSMEM: PERF.md rows 11-12), so the TPU's row
// bands and their invalidation (band_ok) are gone.  Sigma is read from
// device memory, so the host never waits for it.
//
// Sampling and residuals round every product and sum on its own (__fmul_rn /
// __fadd_rn are never contracted into FMAs) in the order of the plain
// version's tensor ops, so channel 0's residuals equal the plain version's
// bit for bit and the histogram median of gauss_newton.run gets the same
// sigma.

#include <stdint.h>

#include "gn_reduce.cuh"

namespace {

constexpr float kPi = 3.14159265358979f;
constexpr int kGroup = 4;   // channels whose loads a thread issues together

// Threads, points per thread per tile and tiles per block for K points of C
// channels (from scripts/gn_kernel_bench.py --sweep).
gn::Launch launch_for(int K, int C) {
  return gn::launch_for_points(K, C > 1 ? 1 : 4);
}

// launch_for's shape as launched: above one channel a thread's loads in
// flight come from its channel group, so it takes one point per tile.
gn::Launch shape_for(int K, int C) {
  const gn::Launch l = launch_for(K, C);
  return C > 1 ? gn::Launch{l.threads, 1, l.unroll * l.tiles} : l;
}

// G channels per group (1 when C = 1); kCosine is a template argument, as
// cosf's full-range reduction would hold registers in the LINEAR kernel too.
template <int U, int G, bool kCosine>
__global__ void __launch_bounds__(gn::kMaxThreads)
fused_linearize_kernel(const float* __restrict__ u,
                       const float* __restrict__ v,
                       const uint8_t* __restrict__ ok,
                       const float* __restrict__ img,
                       const float* __restrict__ pix,
                       const float* __restrict__ jac,
                       const float* __restrict__ sigma_ptr, int C, int H,
                       int W, int K, int tiles, int loss,
                       float* __restrict__ r0, float* __restrict__ w,
                       float* __restrict__ partials, unsigned int* ticket,
                       float* __restrict__ out) {
  const int B = blockDim.x, tid = threadIdx.x;
  const size_t HW = (size_t)H * W;
  const float sigma = __ldg(sigma_ptr);
  float acc[gn::kSys];
#pragma unroll
  for (int i = 0; i < gn::kSys; ++i) acc[i] = 0.0f;

  for (int t = 0; t < tiles; ++t) {
    const int k0 = (blockIdx.x * tiles + t) * B * U;
    int kk[U], cell[U];
    bool in[U], valid[U];
    float xf[U], yf[U];
#pragma unroll
    for (int p = 0; p < U; ++p) {
      kk[p] = k0 + p * B + tid;
      in[p] = kk[p] < K;
      valid[p] = in[p] && ok[kk[p]];
      const float uk = in[p] ? u[kk[p]] : 0.0f;
      const float vk = in[p] ? v[kk[p]] : 0.0f;
      const float xi = floorf(uk), yi = floorf(vk);
      xf[p] = uk - xi;
      yf[p] = vk - yi;
      if (kCosine) {
        xf[p] = __fmul_rn(__fsub_rn(1.0f, cosf(__fmul_rn(xf[p], kPi))), 0.5f);
        yf[p] = __fmul_rn(__fsub_rn(1.0f, cosf(__fmul_rn(yf[p], kPi))), 0.5f);
      }
      // the cell is in bounds for every valid point; the clamp (in float,
      // so NaN goes to 0) only keeps a wrong mask from reading outside
      const int xc = (int)fminf(fmaxf(xi, 0.0f), (float)(W - 2));
      const int yc = (int)fminf(fmaxf(yi, 0.0f), (float)(H - 2));
      cell[p] = yc * W + xc;
    }
    for (int c0 = 0; c0 < C; c0 += G) {
      float px[U][G], j[U][G][6], tap[U][G][4];
      // every load of the group first
#pragma unroll
      for (int p = 0; p < U; ++p) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int c = c0 + g;
          if (!in[p] || c >= C) continue;
          const size_t m = (size_t)c * K + kk[p];
          px[p][g] = __ldg(pix + m);
          gn::load_row(jac + m * 6, j[p][g]);
          if (valid[p]) {
            const float* q = img + c * HW + cell[p];
            tap[p][g][0] = __ldg(q);
            tap[p][g][1] = __ldg(q + 1);
            tap[p][g][2] = __ldg(q + W);
            tap[p][g][3] = __ldg(q + W + 1);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < U; ++p) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int c = c0 + g;
          if (!in[p] || c >= C) continue;
          const size_t m = (size_t)c * K + kk[p];
          if (!valid[p]) {
            // the plain version's (0 - pixel) * 0 and weight 0
            if (c == 0) r0[kk[p]] = __fmul_rn(__fsub_rn(0.0f, px[p][g]), 0.0f);
            w[m] = 0.0f;
            continue;
          }
          const float ox = 1.0f - xf[p], oy = 1.0f - yf[p];
          const float* i = tap[p][g];
          const float top =
              __fadd_rn(__fmul_rn(ox, i[0]), __fmul_rn(xf[p], i[1]));
          const float bot =
              __fadd_rn(__fmul_rn(ox, i[2]), __fmul_rn(xf[p], i[3]));
          const float I1 = __fadd_rn(__fmul_rn(oy, top), __fmul_rn(yf[p], bot));
          const float r = __fsub_rn(I1, px[p][g]);
          const float wv = gn::robust_weight(r / sigma, loss);
          w[m] = wv;
          if (c == 0) r0[kk[p]] = r;
          if (wv != 0.0f) gn::accumulate(acc, j[p][g], r, wv);
        }
      }
    }
  }
  gn::reduce_to(acc, partials, ticket, out);
}

template <int U, int G>
int launch(const gn::Launch& l, int blocks, cudaStream_t s, const float* u,
           const float* v, const uint8_t* ok, const float* channels,
           const float* pixels, const float* jacobians, const float* sigma,
           int C, int H, int W, int K, int loss, int cosine, float* r0,
           float* w, float* partials, unsigned int* ticket, float* out) {
  const auto kernel = cosine ? fused_linearize_kernel<U, G, true>
                             : fused_linearize_kernel<U, G, false>;
  kernel<<<blocks, l.threads, 0, s>>>(u, v, ok, channels, pixels, jacobians,
                                      sigma, C, H, W, K, l.tiles, loss, r0, w,
                                      partials, ticket, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks for K points of C channels: the size of the partials scratch is
// this times 28 floats.
extern "C" int bpvo_fused_linearize_blocks(int K, int C) {
  return gn::blocks_for(shape_for(K, C), K);
}

extern "C" int bpvo_fused_linearize(
    const float* u, const float* v, const uint8_t* ok, const float* channels,
    const float* pixels, const float* jacobians, const float* sigma, int C,
    int H, int W, int K, int loss, int cosine, float* r0, float* w,
    float* partials, unsigned int* ticket, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const gn::Launch l = shape_for(K, C);
  const int blocks = gn::blocks_for(l, K);
  if (C > 1)
    return launch<1, kGroup>(l, blocks, s, u, v, ok, channels, pixels,
                             jacobians, sigma, C, H, W, K, loss, cosine, r0,
                             w, partials, ticket, out);
  switch (l.unroll) {
    case 1:
      return launch<1, 1>(l, blocks, s, u, v, ok, channels, pixels, jacobians,
                          sigma, C, H, W, K, loss, cosine, r0, w, partials,
                          ticket, out);
    case 2:
      return launch<2, 1>(l, blocks, s, u, v, ok, channels, pixels, jacobians,
                          sigma, C, H, W, K, loss, cosine, r0, w, partials,
                          ticket, out);
    default:
      return launch<4, 1>(l, blocks, s, u, v, ok, channels, pixels, jacobians,
                          sigma, C, H, W, K, loss, cosine, r0, w, partials,
                          ticket, out);
  }
}
