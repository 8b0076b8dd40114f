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
// 3.35 TB/s, with the taps gathered from a 1.9-15 MB image stack that stays in
// the 50 MB L2.  The arithmetic (~60 flops per point and channel) is small:
// the kernel is bound by memory traffic and, at these sizes, by its launch.
//
// Design: one thread per point, looping over the channels; the tap
// coordinates and interpolation weights are computed once per point (the
// TPU stacked kernel's "2-hot built once per block" saving, without the
// MXU).  Each point gathers its 4 taps directly, so the TPU's row bands and
// their invalidation (band_ok) are gone.  The 28 products of each term are
// summed per thread, per block (gn_reduce.cuh) and then over the blocks by a
// second one-block pass, in a fixed order: no atomics, bitwise repeatable.
// Sigma is read from device memory, so the host never waits for it.
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

__global__ void __launch_bounds__(gn::kThreads)
fused_linearize_kernel(const float* __restrict__ u,
                       const float* __restrict__ v,
                       const uint8_t* __restrict__ ok,
                       const float* __restrict__ img,
                       const float* __restrict__ pix,
                       const float* __restrict__ jac,
                       const float* __restrict__ sigma_ptr, int C, int H,
                       int W, int K, int loss, int cosine,
                       float* __restrict__ r0, float* __restrict__ w,
                       float* __restrict__ partials) {
  float acc[gn::kSys];
#pragma unroll
  for (int i = 0; i < gn::kSys; ++i) acc[i] = 0.0f;
  const int k = blockIdx.x * gn::kThreads + threadIdx.x;
  if (k < K) {
    if (ok[k]) {
      const float sigma = *sigma_ptr;
      const float uk = u[k], vk = v[k];
      const float xi = floorf(uk), yi = floorf(vk);
      float xf = uk - xi, yf = vk - yi;
      if (cosine) {
        xf = __fmul_rn(__fsub_rn(1.0f, cosf(__fmul_rn(xf, kPi))), 0.5f);
        yf = __fmul_rn(__fsub_rn(1.0f, cosf(__fmul_rn(yf, kPi))), 0.5f);
      }
      const float ox = 1.0f - xf, oy = 1.0f - yf;
      const size_t HW = (size_t)H * W;
      // the cell is in bounds for every valid point; the clamp (in float,
      // so NaN goes to 0) only keeps a wrong mask from reading outside
      const int xc = (int)fminf(fmaxf(xi, 0.0f), (float)(W - 2));
      const int yc = (int)fminf(fmaxf(yi, 0.0f), (float)(H - 2));
      const float* I = img + (size_t)yc * W + xc;
      for (int c = 0; c < C; ++c, I += HW) {
        const float i00 = __ldg(I), i01 = __ldg(I + 1);
        const float i10 = __ldg(I + W), i11 = __ldg(I + W + 1);
        const float top = __fadd_rn(__fmul_rn(ox, i00), __fmul_rn(xf, i01));
        const float bot = __fadd_rn(__fmul_rn(ox, i10), __fmul_rn(xf, i11));
        const float I1 = __fadd_rn(__fmul_rn(oy, top), __fmul_rn(yf, bot));
        const size_t ck = (size_t)c * K + k;
        const float r = __fsub_rn(I1, __ldg(pix + ck));
        const float wv = gn::robust_weight(r / sigma, loss);
        w[ck] = wv;
        if (c == 0) r0[k] = r;
        if (wv != 0.0f) gn::accumulate(acc, jac + ck * 6, r, wv);
      }
    } else {
      // the plain version's (0 - pixel) * 0 and weight 0
      r0[k] = __fmul_rn(__fsub_rn(0.0f, __ldg(pix + k)), 0.0f);
      for (int c = 0; c < C; ++c) w[(size_t)c * K + k] = 0.0f;
    }
  }
  gn::store_block_partial(acc, partials);
}

}  // namespace

// Blocks of the first pass for K points: the size of the partials scratch
// is this times 28 floats.
extern "C" int bpvo_fused_linearize_blocks(int K) {
  return (K + gn::kThreads - 1) / gn::kThreads;
}

extern "C" int bpvo_fused_linearize(
    const float* u, const float* v, const uint8_t* ok, const float* channels,
    const float* pixels, const float* jacobians, const float* sigma, int C,
    int H, int W, int K, int loss, int cosine, float* r0, float* w,
    float* partials, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = bpvo_fused_linearize_blocks(K);
  fused_linearize_kernel<<<blocks, gn::kThreads, 0, s>>>(
      u, v, ok, channels, pixels, jacobians, sigma, C, H, W, K, loss, cosine,
      r0, w, partials);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return gn::reduce_partials(partials, blocks, out, s);
}
