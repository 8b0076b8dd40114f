// census_cost.cu - the census Hamming cost volume of a stereo pair in one
// pass, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package XLA fuses the cost volume
// (bpvo_tpu/data/stereo.py:212-218, the rolled census planes).  Wrapper and
// plain PyTorch version: bpvo_tpu_torch/ops/census_cost.py.  For the packed
// census codes cL, cR (H, W) uint8 it writes the (H, W, D) float32 volume
//   out[y, x, d] = popcount(cR[y, x - d] ^ cL[y, x])  for x >= d,
//   out[y, x, d] = 8                                   for x < d,
// the integer 0..8 as a float, so it equals the plain version bit for bit.
//
// What bounds it: the bytes it writes.  At 376x1241x128 the volume is
// 238.9 MB out against 0.93 MB of codes in (71.6 us at 3.35 TB/s), with a
// handful of integer operations an output.  The plain version's chain of
// tensor ops (gather, XOR, mask, widening copy, table lookup) moves the
// volume through memory five times, about 1.1 GB.
//
// Design: the volume is written once, 16 bytes a store, and read never.
// One block of kThreads threads per (row, kTileX columns).  A pixel's D
// costs are contiguous, so the block's output is one contiguous run of
// nx * D floats, which the threads cover as consecutive float4 slots:
// neighbouring threads store neighbouring 16 bytes, a warp 512 contiguous
// bytes.  The block first stages the codes it needs in shared memory,
// cL[y, x0 : x0 + nx] and cR[y, x0 - D + 1 : x0 + nx] (a few hundred
// bytes), so every cost is two shared-memory reads, an XOR and a popcount.
// A slot's position (pixel, disparity) advances by a fixed step from one
// slot of a thread to its next, so the loop divides nothing.  Where the run
// does not start on a 16-byte boundary (D not a multiple of 4) a scalar
// head and tail take the ends.  The stores stream (__stcs, evict first):
// the volume (239 MB) is larger than the 50 MB L2, so the SGM carry pass
// that reads it next finds little of it there either way.  Measured against
// plain stores at 376x1241x128, the kernel followed by the SGM passes took
// 0.782 against 0.799 ms (median of 4 each, H100 SXM at 700 W; PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileX = 32;      // columns of a block

__device__ __forceinline__ float cost_of(const uint8_t* sl, const uint8_t* sr,
                                         int x0, int xl, int d, int D) {
  // sr[i] holds cR[y, x0 - (D - 1) + i]
  if (x0 + xl < d) return 8.0f;
  return (float)__popc((unsigned)(sl[xl] ^ sr[xl - d + D - 1]));
}

__global__ void __launch_bounds__(kThreads)
census_cost_kernel(const uint8_t* __restrict__ cL,
                   const uint8_t* __restrict__ cR, float* __restrict__ out,
                   int H, int W, int D) {
  extern __shared__ uint8_t smem[];
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kTileX;
  const int nx = min(kTileX, W - x0);
  const int nr = nx + D - 1;            // staged right-image columns
  uint8_t* sl = smem;
  uint8_t* sr = smem + kTileX;
  const uint8_t* rowL = cL + (size_t)y * W;
  const uint8_t* rowR = cR + (size_t)y * W;
  for (int i = threadIdx.x; i < nx; i += kThreads) sl[i] = rowL[x0 + i];
  for (int i = threadIdx.x; i < nr; i += kThreads) {
    const int c = x0 - (D - 1) + i;
    sr[i] = c >= 0 ? rowR[c] : 0;       // c < 0 never read (x < d)
  }
  __syncthreads();

  const long long base = ((long long)y * W + x0) * D;
  float* dst = out + base;
  const int n = nx * D;
  // elements before the first 16-byte boundary, then float4 slots, then
  // the tail
  const int head = min(n, (int)((4 - (base & 3)) & 3));
  const int n4 = (n - head) >> 2;
  const int tail0 = head + 4 * n4;
  const int t = threadIdx.x;
  if (t < head) __stcs(dst + t, cost_of(sl, sr, x0, t / D, t % D, D));
  if (t < n - tail0) {
    const int e = tail0 + t;
    __stcs(dst + e, cost_of(sl, sr, x0, e / D, e % D, D));
  }
  if (t >= n4) return;
  // slot k covers elements head + 4k .. head + 4k + 3; a thread's slots
  // are t, t + kThreads, ..., each 4 * kThreads elements further on
  const int e0 = head + 4 * t;
  int xl = e0 / D, d = e0 - xl * D;
  const int step_x = (4 * kThreads) / D, step_d = (4 * kThreads) % D;
  float4* dst4 = reinterpret_cast<float4*>(dst + head);
  for (int k = t; k < n4; k += kThreads) {
    float v[4];
    int xx = xl, dd = d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = cost_of(sl, sr, x0, xx, dd, D);
      if (++dd == D) { dd = 0; ++xx; }
    }
    __stcs(dst4 + k, make_float4(v[0], v[1], v[2], v[3]));
    xl += step_x;
    d += step_d;
    if (d >= D) { d -= D; ++xl; }
  }
}

}  // namespace

extern "C" int bpvo_census_cost(const uint8_t* cL, const uint8_t* cR,
                                float* out, int H, int W, int D,
                                void* stream) {
  const dim3 grid((W + kTileX - 1) / kTileX, H);
  const int smem = 2 * kTileX + D - 1;   // the staged codes
  census_cost_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(cL, cR, out, H,
                                                            W, D);
  return static_cast<int>(cudaGetLastError());
}
