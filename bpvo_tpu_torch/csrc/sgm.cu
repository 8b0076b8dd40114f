// sgm.cu - SGM scan-line cost aggregation along 4 directions, summed, for
// NVIDIA Hopper (sm_90a).
//
// Replaces: bpvo_tpu/ops/pallas/sgm_kernel.py, aggregate_direction (kernel
// body _aggregate_kernel, pallas_call at :55) and aggregate_4dir (:69).
// Wrapper and plain PyTorch version: bpvo_tpu_torch/ops/sgm.py.  Along each
// scan line
//   L(p, d) = C(p, d) + min(L(p-1, d), L(p-1, d-1) + P1, L(p-1, d+1) + P1,
//                           min_d' L(p-1, d') + P2) - min_d' L(p-1, d')
// with L = C at the first position and the edge disparities taking their own
// value + P1 for the missing neighbour, exactly as stereo.py:237-245.
//
// What bounds it: memory, then the serial chain along a line.  The (H, W, D)
// f32 volume is 239 MB at 376x1241x128; each direction reads the cost and
// reads and writes the sum, ~0.7 GB per direction.  A line of W (or H) steps
// is a chain of dependent warp shuffles, so the cost of the next step is
// loaded before the current one is computed.
//
// Design: one warp per scan line, lane l holding the D/32 contiguous
// disparities [l*NPER, (l+1)*NPER) in registers; the carry never leaves
// registers.  min over d is a butterfly of warp shuffles, the d-1 and d+1
// neighbours across lanes are one __shfl_up and one __shfl_down.  With D
// innermost every direction reads and writes D contiguous floats per step
// (coalesced, 16 bytes a lane when NPER is 4), so the TPU's transposes and
// reversed copies are not needed: a direction is a start offset and a
// signed stride.  The four directions run as four launches in a fixed order
// (left->right writes the output, right->left, top->bottom and
// bottom->top add to it), the order of stereo.py's scan, so the sum is
// deterministic and equal to it bit for bit.  No atomics.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxPer = 8;  // D <= 256

template <int NPER>
__device__ __forceinline__ void load_d(const float* __restrict__ src, int d0,
                                       int D, float (&v)[NPER]) {
  if constexpr (NPER % 4 == 0) {
    if (NPER * 32 == D) {  // every lane's run is 16-byte aligned
#pragma unroll
      for (int j = 0; j < NPER; j += 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(src + d0 + j));
        v[j] = q.x;
        v[j + 1] = q.y;
        v[j + 2] = q.z;
        v[j + 3] = q.w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < NPER; ++j)
    v[j] = d0 + j < D ? __ldg(src + d0 + j) : INFINITY;
}

template <int NPER>
__device__ __forceinline__ void store_d(float* dst, int d0, int D,
                                        const float (&v)[NPER],
                                        bool accumulate) {
  if constexpr (NPER % 4 == 0) {
    if (NPER * 32 == D) {
#pragma unroll
      for (int j = 0; j < NPER; j += 4) {
        float4* q = reinterpret_cast<float4*>(dst + d0 + j);
        float4 w = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
        if (accumulate) {
          const float4 a = *q;
          w = make_float4(a.x + w.x, a.y + w.y, a.z + w.z, a.w + w.w);
        }
        *q = w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < NPER; ++j)
    if (d0 + j < D) dst[d0 + j] = accumulate ? dst[d0 + j] + v[j] : v[j];
}

// dir: 0 left->right, 1 right->left, 2 top->bottom, 3 bottom->top.
template <int NPER>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sgm_dir_kernel(const float* __restrict__ cost, float* __restrict__ out, int H,
               int W, int D, float p1, float p2, int dir, int accumulate) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const bool horizontal = dir < 2;
  const int n_lines = horizontal ? H : W;
  const int len = horizontal ? W : H;
  if (line >= n_lines) return;  // whole warps only: shuffles stay full
  long long start = horizontal ? (long long)line * W * D : (long long)line * D;
  long long step = horizontal ? (long long)D : (long long)W * D;
  if (dir & 1) {
    start += (long long)(len - 1) * step;
    step = -step;
  }
  const int d0 = lane * NPER;

  float prev[NPER], cur[NPER], nxt[NPER];
  load_d<NPER>(cost + start, d0, D, cur);
  for (int t = 0; t < len; ++t) {
    const long long off = start + (long long)t * step;
    if (t + 1 < len) load_d<NPER>(cost + off + step, d0, D, nxt);
    float L[NPER];
    if (t == 0) {
#pragma unroll
      for (int j = 0; j < NPER; ++j) L[j] = cur[j];
    } else {
      float m = prev[0];
#pragma unroll
      for (int j = 1; j < NPER; ++j) m = fminf(m, prev[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float left = __shfl_up_sync(0xffffffffu, prev[NPER - 1], 1);
      const float right = __shfl_down_sync(0xffffffffu, prev[0], 1);
      const float mp2 = m + p2;
#pragma unroll
      for (int j = 0; j < NPER; ++j) {
        const int d = d0 + j;
        const float lo = d == 0 ? prev[0] : (j > 0 ? prev[j - 1] : left);
        const float hi =
            d == D - 1 ? prev[j] : (j < NPER - 1 ? prev[j + 1] : right);
        const float up = lo + p1;
        const float dn = hi + p1;
        const float best = fminf(fminf(prev[j], up), fminf(dn, mp2));
        L[j] = cur[j] + best - m;
      }
    }
    store_d<NPER>(out + off, d0, D, L, accumulate != 0);
#pragma unroll
    for (int j = 0; j < NPER; ++j) {
      prev[j] = L[j];
      cur[j] = nxt[j];
    }
  }
}

template <int NPER>
cudaError_t launch_dirs(const float* cost, float* out, int H, int W, int D,
                        float p1, float p2, int n_dirs, cudaStream_t stream) {
  for (int dir = 0; dir < n_dirs; ++dir) {
    const int n_lines = dir < 2 ? H : W;
    const int blocks = (n_lines + kWarpsPerBlock - 1) / kWarpsPerBlock;
    sgm_dir_kernel<NPER><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        cost, out, H, W, D, p1, p2, dir, dir > 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Aggregates the (H, W, D) cost along the first n_dirs directions of
// (left->right, right->left, top->bottom, bottom->top) into out (H, W, D):
// n_dirs = 1 is aggregate_direction, 4 is aggregate_4dir.
extern "C" int bpvo_sgm_aggregate(const float* cost, float* out, int H, int W,
                                  int D, float p1, float p2, int n_dirs,
                                  void* stream) {
  if (D < 1 || D > 32 * kMaxPer || n_dirs < 1 || n_dirs > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((D + 31) / 32) {
    case 1: err = launch_dirs<1>(cost, out, H, W, D, p1, p2, n_dirs, s); break;
    case 2: err = launch_dirs<2>(cost, out, H, W, D, p1, p2, n_dirs, s); break;
    case 3: err = launch_dirs<3>(cost, out, H, W, D, p1, p2, n_dirs, s); break;
    case 4: err = launch_dirs<4>(cost, out, H, W, D, p1, p2, n_dirs, s); break;
    case 5: err = launch_dirs<5>(cost, out, H, W, D, p1, p2, n_dirs, s); break;
    case 6: err = launch_dirs<6>(cost, out, H, W, D, p1, p2, n_dirs, s); break;
    case 7: err = launch_dirs<7>(cost, out, H, W, D, p1, p2, n_dirs, s); break;
    default: err = launch_dirs<8>(cost, out, H, W, D, p1, p2, n_dirs, s); break;
  }
  return static_cast<int>(err);
}
