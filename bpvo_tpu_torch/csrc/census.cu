// census.cu - 3x3 census transform to 8 {0,1} float planes in one pass, for
// NVIDIA Hopper (sm_90a).
//
// Replaces: bpvo_tpu/ops/pallas/census_kernel.py, census_planes_pallas
// (kernel body _census_kernel, pallas_call at :50).  Wrapper and plain
// PyTorch version: bpvo_tpu_torch/ops/census.py.  Bit b of pixel (y, x) is
// I(y+dy_b, x+dx_b) >= I(y, x) for the 8-neighborhood in row-major order
// (bpvo_tpu/ops/census.py NEIGHBOR_OFFSETS); the one-pixel border is 0.
//
// What bounds it: memory.  A 376x1241 f32 image is 1.9 MB in and the planes
// are 15 MB out, against 9 compares per pixel.
//
// Design: one thread per pixel, rows of 256 threads.  The 3x3 neighborhood
// comes through the read-only cache (neighbouring threads share it), and
// each plane's write is one coalesced row.  All 8 planes are written by the
// same pass: the TPU kernel's one-plane-per-grid-step split existed only
// because the (8, H, W) block overflowed VMEM.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
census_kernel(const float* __restrict__ img, float* __restrict__ out, int H,
              int W) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const size_t HW = (size_t)H * W;
  const size_t p = (size_t)y * W + x;
  const bool inside = y > 0 && y < H - 1 && x > 0 && x < W - 1;
  float bits[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (inside) {
    const float c = __ldg(img + p);
    const float* up = img + p - W;
    const float* dn = img + p + W;
    bits[0] = __ldg(up - 1) >= c ? 1.0f : 0.0f;
    bits[1] = __ldg(up) >= c ? 1.0f : 0.0f;
    bits[2] = __ldg(up + 1) >= c ? 1.0f : 0.0f;
    bits[3] = __ldg(img + p - 1) >= c ? 1.0f : 0.0f;
    bits[4] = __ldg(img + p + 1) >= c ? 1.0f : 0.0f;
    bits[5] = __ldg(dn - 1) >= c ? 1.0f : 0.0f;
    bits[6] = __ldg(dn) >= c ? 1.0f : 0.0f;
    bits[7] = __ldg(dn + 1) >= c ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int b = 0; b < 8; ++b) out[b * HW + p] = bits[b];
}

}  // namespace

extern "C" int bpvo_census_planes(const float* img, float* out, int H, int W,
                                  void* stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H);
  census_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
