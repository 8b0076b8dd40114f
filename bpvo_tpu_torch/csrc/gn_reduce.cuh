// gn_reduce.cuh - what the per-iteration Gauss-Newton kernels share
// (fused_linearize.cu, irls_reduce.cu): the M-estimator weight, the 28
// products of one term of the normal equations, a term's Jacobian row as
// 8-byte loads, the launch shape, and a one-launch deterministic reduction
// of the 28 sums over the whole grid.
//
// The 28 sums are the 21 upper-triangle entries of H = J^T W J (row-major),
// the 6 of g = J^T W r and sum w r^2.  Each thread adds its terms' products
// in registers (FMA: ~64 flops per term against 28+ bytes is far below the
// card's f32 rate, so the TPU kernel's MXU product has no tensor-core
// counterpart here).  Then, in one launch:
// - a warp reduce-scatter: the 28 sums padded to 32, at each of 5 steps
//   every lane sends half of what it holds and keeps the other half, 31
//   shuffles in all, and lane i ends with the warp's sum i;
// - the warps fold through shared memory in warp order, and the block
//   stores one partial per sum;
// - a completion ticket: one thread of each block draws a ticket with an
//   acquire-release atomic increment on a counter in device memory; the
//   block that draws the last one adds every block's partial in block order
//   and writes H (6x6, both triangles), g and sum w r^2 as 43 floats.  The
//   increment (PTX atom.inc) wraps the counter back to 0 at that draw, so
//   the next launch finds it at 0.
// Every sum runs in a fixed order (the atomic only picks which block folds),
// so a call is bitwise repeatable.  The counter is a kernel argument: the
// wrappers keep one zeroed int per stream (ops/_build.py ticket_counter),
// allocated before any capture, so a call stays one launch, launches on two
// streams never share a counter, and a captured CUDA graph keeps the counter
// of the stream it was captured on.  Two launches that share a counter must
// not overlap, which launches on one stream never do.  A grid barrier
// (cooperative launch) would also do, but needs every block resident at
// once and makes all of them wait (1.24 us per barrier on this card,
// PERF.md row 8); with the ticket the other blocks exit at once.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gn {
namespace {  // internal linkage: each source gets its own copy

constexpr int kSys = 28;
constexpr int kMaxThreads = 256;   // threads of a block, at most
constexpr float kTukeyT = 4.685f;
constexpr float kHuberK = 1.345f;

enum Loss { kTukey = 0, kHuber = 1, kL2 = 2 };

// A launch's shape: threads per block, points per thread per tile (the
// unrolled loads) and tiles per block.  A block owns threads * unroll *
// tiles consecutive points; thread t takes point p * threads + t of each
// tile, p < unroll.
struct Launch {
  int threads, unroll, tiles;
};

inline int blocks_for(const Launch& l, int n) {
  const int per_block = l.threads * l.unroll * l.tiles;
  return (n + per_block - 1) / per_block;
}

// The shape for n points (scripts/gn_kernel_bench.py --sweep): blocks of
// 256 threads, each thread with enough points that the grid is about 256
// blocks (two per SM); a thread with two or more loads max_unroll of them
// per tile, in as many tiles as that needs.
inline Launch launch_for_points(int n, int max_unroll) {
  constexpr int kThreads = 256, kBlocks = 256;
  const int per_thread = (n + kThreads * kBlocks - 1) / (kThreads * kBlocks);
  const int unroll = per_thread >= 2 ? max_unroll : 1;
  return {kThreads, unroll, (per_thread + unroll - 1) / unroll};
}

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
                                           const float (&j)[6], float r,
                                           float w) {
  float lj[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) lj[i] = j[i] * w;
  int idx = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int k = i; k < 6; ++k) acc[idx++] += lj[i] * j[k];
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += lj[i] * r;
  acc[27] += (r * w) * r;
}

// One term's 6 Jacobian floats: three 8-byte loads where the row is 8-byte
// aligned (always, for a tensor that starts at its allocation).
__device__ __forceinline__ void load_row(const float* p, float (&j)[6]) {
  if ((reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    const float2* q = reinterpret_cast<const float2*>(p);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float2 x = q[i];
      j[2 * i] = x.x;
      j[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i) j[i] = p[i];
  }
}

// One step of the reduce-scatter below: a lane keeps the half of v[0..2 *
// kHalf) whose index has its lane bit kHalf, sends the other half to the
// partner lane across that bit and adds what comes back into v[0..kHalf).
template <int kHalf>
__device__ __forceinline__ void scatter_step(float (&v)[32]) {
  const bool upper = (threadIdx.x & kHalf) != 0;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float send = upper ? v[j] : v[j + kHalf];
    const float keep = upper ? v[j + kHalf] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

// Sums v[0..31] over the warp: lane l returns the sum of v[l], after
// 16 + 8 + 4 + 2 + 1 = 31 shuffles.
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32]) {
  scatter_step<16>(v);
  scatter_step<8>(v);
  scatter_step<4>(v);
  scatter_step<2>(v);
  scatter_step<1>(v);
  return v[0];
}

// Every thread of the block: adds acc over the grid and, in the block that
// finishes last, writes H (6x6), g (6) and sum w r^2 to out[43].  partials
// holds gridDim.x x kSys floats (block-major); ticket is the launch's
// completion counter, 0 on entry and 0 again when the launch ends.
__device__ __forceinline__ void reduce_to(float (&acc)[kSys],
                                          float* __restrict__ partials,
                                          unsigned int* ticket,
                                          float* __restrict__ out) {
  constexpr int kBatch = 32;   // partial loads a lane has in flight at once
  __shared__ float red[kMaxThreads / 32][32];
  __shared__ unsigned int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned int nb = gridDim.x;
  float v[32];
#pragma unroll
  for (int i = 0; i < kSys; ++i) v[i] = acc[i];
#pragma unroll
  for (int i = kSys; i < 32; ++i) v[i] = 0.0f;
  red[warp][lane] = warp_reduce_scatter(v);
  __syncthreads();
  if (warp == 0) {
    float x = red[0][lane];
    for (int k = 1; k < n_warps; ++k) x += red[k][lane];
    if (lane < kSys) partials[blockIdx.x * kSys + lane] = x;
    __syncwarp();   // the warp's partial stores before lane 0's release
    if (lane == 0) {
      // atomicInc with release (this block's partial before the ticket)
      // and acquire (every partial after the last ticket) in one
      // instruction: faster than separate fences (PERF.md §6)
      unsigned int drawn;
      asm volatile("atom.acq_rel.gpu.inc.u32 %0, [%1], %2;\n"
                   : "=r"(drawn)
                   : "l"(ticket), "r"(nb - 1)
                   : "memory");
      last = drawn == nb - 1;
    }
  }
  __syncthreads();
  if (!last) return;
  // the last block: warp w adds blocks w, w + n_warps, ... in order (lane i
  // sum i, kBatch loads in flight), then the warps fold in warp order
  float x = 0.0f;
  for (unsigned int b0 = warp; b0 < nb; b0 += kBatch * n_warps) {
    float y[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const unsigned int b = b0 + q * n_warps;
      y[q] = (b < nb && lane < kSys) ? __ldcg(partials + b * kSys + lane)
                                     : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) x += y[q];
  }
  red[warp][lane] = x;
  __syncthreads();
  if (warp != 0) return;
  for (int k = 1; k < n_warps; ++k) x += red[k][lane];
  if (lane < 21) {
    // upper-triangle index lane -> (row, col)
    int row = 0, rem = lane;
    while (rem >= 6 - row) {
      rem -= 6 - row;
      ++row;
    }
    const int col = row + rem;
    out[6 * row + col] = x;
    out[6 * col + row] = x;
  } else if (lane < kSys) {
    out[36 + (lane - 21)] = x;   // g, then sum w r^2 at out[42]
  }
}

}  // namespace
}  // namespace gn
