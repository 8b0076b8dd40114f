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
// value + P1 for the missing neighbour, exactly as stereo.py:237-245.  The
// 4-direction sum is ((lr + rl) + tb) + bt at every element, the order of
// stereo.py's scan.
//
// What bounds it: memory, and the serial chain along a line.  The (H, W, D)
// f32 volume is 239 MB at 376x1241x128; the function reads it once and
// writes the sum once (478 MB, 142.6 us at 3.35 TB/s).  Each scan line is a
// chain of dependent steps (a warp-wide min, two neighbour shuffles), 1241
// long for a row.  Scanning the four directions one after another, each
// adding into the output, moves the output through memory four times
// (2.63 GB) and leaves each step waiting on the read of the sum it adds to;
// with one launch per direction only the H = 376 rows of a horizontal
// direction are in flight.
//
// Design: two passes, and the output written once.
// 1. Carry pass, one launch for all four directions: 2H + 2W lines, one
//    warp each, the rows first (their chains are the longest).  Lane l holds
//    the D/32 contiguous disparities [l*NPER, (l+1)*NPER) of the carry in
//    registers; min over d is one integer redux.sync on order-preserving
//    keys, the d-1 and d+1 neighbours one __shfl_up and one __shfl_down.
//    The cost of the next kPrefetch steps is in flight as cp.async copies
//    into a ring in shared memory, so a step waits on no load (a ring in
//    registers cost the occupancy it was meant to buy).  A line stores only
//    the carry that enters each tile of pass 2 (L just before the tile's
//    first column or row in its own scan order) and stops at the last one;
//    no step reads the output.  With n_dirs = 1 (aggregate_direction) the
//    same kernel runs the left->right rows and stores every position: one
//    kernel, one write.
// 2. Tile pass: one block per kTileY x kTileX tile, warp w owning row w and
//    column w.  It loads the tile's cost into shared memory and the four
//    entering carries into registers, then re-runs each direction across
//    the tile (L = C at an image edge): left->right into a shared sum
//    interleaved with right->left into registers, sum = lr + rl; then
//    top->bottom added to the sum interleaved with bottom->top into
//    registers, and the output written once as (sum + tb) + bt.  The chains
//    are kTileX or kTileY long, two per warp, and many run at once.
// The re-run from a saved carry is the same f32 operations in the same
// order as the single scan, and the sum keeps its order, so the result
// equals the plain version bit for bit.  No atomics.  Bytes at
// 376x1241x128 with 8x8 tiles: 4 reads of the cost, 120 MB of carries
// written and read, one more read of the cost and one write of the output,
// 1.67 GB (0.50 ms at 3.35 TB/s).  The tile shape 8x8 was measured against
// 8x12 and 12x8 (scripts/sgm_bench.py --tiles; PERF.md); two tile buffers
// of 64 positions hold D = 256 in 128 KB of shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxPer = 8;        // D <= 256
constexpr int kScanWarps = 4;     // carry pass: scan lines (warps) per block
constexpr int kPrefetch = 8;      // carry pass: steps of cost in flight
constexpr int kTileY = 8;         // tile pass: rows of a tile
constexpr int kTileX = 8;         // tile pass: columns of a tile
constexpr int kTileWarps = kTileY > kTileX ? kTileY : kTileX;

__host__ __device__ inline int n_tiles(int n, int t) { return (n + t - 1) / t; }

// Start of a direction's carries in the scratch buffer.  Direction dir
// (0 left->right, 1 right->left, 2 top->bottom, 3 bottom->top) keeps one
// D-vector per (tile index k, line): slot k of line i at
// carry_base + (k * lines + i) * D, the carry entering tile k.
__host__ __device__ inline long long carry_base(int dir, int H, int W, int D) {
  const long long h = (long long)n_tiles(W, kTileX) * H * D;
  const long long v = (long long)n_tiles(H, kTileY) * W * D;
  return dir == 0 ? 0 : dir == 1 ? h : dir == 2 ? 2 * h : 2 * h + v;
}

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
                                        const float (&v)[NPER]) {
  if constexpr (NPER % 4 == 0) {
    if (NPER * 32 == D) {
#pragma unroll
      for (int j = 0; j < NPER; j += 4)
        *reinterpret_cast<float4*>(dst + d0 + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < NPER; ++j)
    if (d0 + j < D) dst[d0 + j] = v[j];
}

// A lane's NPER values at ``p`` in shared memory (rows padded to 32*NPER).
template <int NPER>
__device__ __forceinline__ void smem_load(const float* p, float (&v)[NPER]) {
  if constexpr (NPER % 4 == 0) {
#pragma unroll
    for (int j = 0; j < NPER; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NPER; ++j) v[j] = p[j];
  }
}

template <int NPER>
__device__ __forceinline__ void smem_store(float* p, const float (&v)[NPER]) {
  if constexpr (NPER % 4 == 0) {
#pragma unroll
    for (int j = 0; j < NPER; j += 4)
      *reinterpret_cast<float4*>(p + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < NPER; ++j) p[j] = v[j];
  }
}

// Asynchronous copies (cp.async) of a lane's NPER values of one position
// from device memory into its run of a shared ring slot: 16 bytes at a time
// when every lane's run is aligned, else the D values one by one (the
// padding lanes copy nothing).  A lane reads back only what it copied.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int NPER>
__device__ __forceinline__ void fetch_d(float* slot, const float* src, int d0,
                                        int D) {
  if constexpr (NPER % 4 == 0) {
    if (NPER * 32 == D) {
#pragma unroll
      for (int j = 0; j < NPER; j += 4) cp_async16(slot + j, src + d0 + j);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < NPER; ++j)
    if (d0 + j < D) cp_async4(slot + j, src + d0 + j);
}

// An int whose order is the order of the floats (no NaN), for the warp's
// integer min reduction (one redux.sync where a butterfly takes 5
// dependent shuffles); from_key inverts it.  The min is the exact value,
// as fminf's.
__device__ __forceinline__ int to_key(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// One step of the recurrence: L from the previous position's L (prev) and
// this position's cost (cur).  Called by all 32 lanes of a warp.
template <int NPER>
__device__ __forceinline__ void sgm_step(const float (&prev)[NPER],
                                         const float (&cur)[NPER],
                                         float (&L)[NPER], int d0, int D,
                                         float p1, float p2) {
  float m = prev[0];
#pragma unroll
  for (int j = 1; j < NPER; ++j) m = fminf(m, prev[j]);
  m = from_key(__reduce_min_sync(0xffffffffu, to_key(m)));
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

// Pass 1.  n_dirs = 4: the 2H + 2W lines of the four directions (rows
// left->right, rows right->left, columns top->bottom, columns
// bottom->top), each storing its tile-entering carries into dst (the
// scratch buffer).  n_dirs = 1: the H rows left->right, storing L at every
// position into dst (the output).
template <int NPER>
__global__ void __launch_bounds__(kScanWarps * 32)
sgm_carry_kernel(const float* __restrict__ cost, float* __restrict__ dst,
                 int H, int W, int D, float p1, float p2, int n_dirs) {
  constexpr int DP = NPER * 32;
  extern __shared__ float4 ring4[];  // [kScanWarps][kPrefetch][DP]
  const int lane = threadIdx.x & 31;
  float* ring = reinterpret_cast<float*>(ring4) +
                (threadIdx.x >> 5) * kPrefetch * DP + lane * NPER;
  int line = blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  int dir = 0;
  for (; dir < n_dirs; ++dir) {
    const int n = dir < 2 ? H : W;
    if (line < n) break;
    line -= n;
  }
  if (dir == n_dirs) return;  // whole warps only: shuffles stay full
  const bool horizontal = dir < 2, backward = dir & 1;
  const bool every = n_dirs == 1;
  const int full = horizontal ? W : H;
  const int T = horizontal ? kTileX : kTileY;
  // the last carry is the one entering the last tile in scan order
  const int len = every ? full
                        : (backward ? full - T : (n_tiles(full, T) - 1) * T);
  if (len <= 0) return;
  long long start = horizontal ? (long long)line * W * D : (long long)line * D;
  long long step = horizontal ? (long long)D : (long long)W * D;
  if (backward) {
    start += (long long)(full - 1) * step;
    step = -step;
  }
  const long long slot_stride = (long long)(horizontal ? H : W) * D;
  float* carry = dst + carry_base(dir, H, W, D) + (long long)line * D;
  float* put = dst + start;  // every position (n_dirs = 1)
  // step of the next carry store, and its slot: forward, L at position
  // kT - 1 enters tile k; backward, L at position (k + 1)T enters tile k
  int next = backward ? (full - 1) % T : T - 1;
  int slot = backward ? (full - 1) / T - 1 : 1;
  const int d0 = lane * NPER;

  // the ring: step t's cost in slot t % kPrefetch, one copy group per step
  const float* src = cost + start;
#pragma unroll
  for (int s = 0; s < kPrefetch; ++s) {
    if (s < len) fetch_d<NPER>(ring + s * DP, src, d0, D);
    cp_async_commit();
    src += step;
  }
  float prev[NPER];
  for (int t0 = 0; t0 < len; t0 += kPrefetch) {
#pragma unroll
    for (int s = 0; s < kPrefetch; ++s) {
      const int t = t0 + s;
      if (t >= len) break;
      float cur[NPER], L[NPER];
      cp_async_wait<kPrefetch - 1>();  // step t's group has landed
      smem_load<NPER>(ring + s * DP, cur);
#pragma unroll
      for (int j = 0; j < NPER; ++j)
        if (d0 + j >= D) cur[j] = INFINITY;
      if (t + kPrefetch < len) fetch_d<NPER>(ring + s * DP, src, d0, D);
      cp_async_commit();
      src += step;
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < NPER; ++j) L[j] = cur[j];
      } else {
        sgm_step<NPER>(prev, cur, L, d0, D, p1, p2);
      }
      if (every) {
        store_d<NPER>(put, d0, D, L);
        put += step;
      } else if (t == next) {
        store_d<NPER>(carry + slot * slot_stride, d0, D, L);
        next += T;
        slot += backward ? -1 : 1;
      }
#pragma unroll
      for (int j = 0; j < NPER; ++j) prev[j] = L[j];
    }
  }
  cp_async_wait<0>();
}

// L of a chain's step: from the previous L, or the cost itself at the
// chain's first position (an image edge).
template <int NPER>
__device__ __forceinline__ void chain_step(bool first,
                                           const float (&prev)[NPER],
                                           const float (&cur)[NPER],
                                           float (&L)[NPER], int d0, int D,
                                           float p1, float p2) {
  if (first) {
#pragma unroll
    for (int j = 0; j < NPER; ++j) L[j] = cur[j];
  } else {
    sgm_step<NPER>(prev, cur, L, d0, D, p1, p2);
  }
}

// Pass 2: one block per tile, warp w running row w and then column w; the
// output written once.
template <int NPER>
__global__ void __launch_bounds__(kTileWarps * 32)
sgm_tile_kernel(const float* __restrict__ cost,
                const float* __restrict__ carry, float* __restrict__ out,
                int H, int W, int D, float p1, float p2) {
  constexpr int DP = NPER * 32;
  extern __shared__ float4 smem4[];
  float* sc = reinterpret_cast<float*>(smem4);  // cost [kTileY][kTileX][DP]
  float* sa = sc + kTileY * kTileX * DP;        // sum  [kTileY][kTileX][DP]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const int nx = min(kTileX, W - x0), ny = min(kTileY, H - y0);
  const int d0 = lane * NPER;
  const bool row = w < ny, col = w < nx;
  const bool left = blockIdx.x == 0, right = blockIdx.x + 1 == gridDim.x;
  const bool top = blockIdx.y == 0, bottom = blockIdx.y + 1 == gridDim.y;

  // the four entering carries of row w and column w, loaded with the tile
  float lr[NPER], rl[NPER], tb[NPER], bt[NPER];
  if (row) {
    const long long slot = (long long)blockIdx.x * H + y0 + w;
    if (!left)
      load_d<NPER>(carry + carry_base(0, H, W, D) + slot * D, d0, D, lr);
    if (!right)
      load_d<NPER>(carry + carry_base(1, H, W, D) + slot * D, d0, D, rl);
  }
  if (col) {
    const long long slot = (long long)blockIdx.y * W + x0 + w;
    if (!top)
      load_d<NPER>(carry + carry_base(2, H, W, D) + slot * D, d0, D, tb);
    if (!bottom)
      load_d<NPER>(carry + carry_base(3, H, W, D) + slot * D, d0, D, bt);
  }
  constexpr int kStage = (kTileY * kTileX + kTileWarps - 1) / kTileWarps;
#pragma unroll
  for (int i = 0; i < kStage; ++i) {  // all of a warp's loads in flight
    const int p = w + i * kTileWarps;
    const int y = p / kTileX, x = p % kTileX;
    if (y < ny && x < nx) {
      float v[NPER];
      load_d<NPER>(cost + ((long long)(y0 + y) * W + x0 + x) * D, d0, D, v);
      smem_store<NPER>(sc + p * DP + d0, v);
    }
  }
  __syncthreads();

  if (row) {  // left->right into the sum, right->left into registers,
              // the two chains interleaved; then sum = lr + rl
    float* s = sa + w * kTileX * DP + d0;
    const float* c = sc + w * kTileX * DP + d0;
    float back[kTileX][NPER];
#pragma unroll
    for (int i = 0; i < kTileX; ++i) {
      if (i >= nx) break;
      float cf[NPER], cb[NPER], L[NPER];
      smem_load<NPER>(c + i * DP, cf);
      smem_load<NPER>(c + (nx - 1 - i) * DP, cb);
      chain_step<NPER>(i == 0 && left, lr, cf, L, d0, D, p1, p2);
      chain_step<NPER>(i == 0 && right, rl, cb, back[i], d0, D, p1, p2);
      smem_store<NPER>(s + i * DP, L);
#pragma unroll
      for (int j = 0; j < NPER; ++j) {
        lr[j] = L[j];
        rl[j] = back[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < kTileX; ++i) {
      if (i >= nx) break;
      float a[NPER];
      smem_load<NPER>(s + (nx - 1 - i) * DP, a);
#pragma unroll
      for (int j = 0; j < NPER; ++j) a[j] = a[j] + back[i][j];  // lr + rl
      smem_store<NPER>(s + (nx - 1 - i) * DP, a);
    }
  }
  __syncthreads();

  if (col) {  // top->bottom added to the sum, bottom->top into registers,
              // interleaved; then out = (sum + tb) + bt
    float* s = sa + w * DP + d0;
    const float* c = sc + w * DP + d0;
    constexpr int kRow = kTileX * DP;
    float back[kTileY][NPER];
#pragma unroll
    for (int i = 0; i < kTileY; ++i) {
      if (i >= ny) break;
      float cf[NPER], cb[NPER], L[NPER], a[NPER];
      smem_load<NPER>(c + i * kRow, cf);
      smem_load<NPER>(c + (ny - 1 - i) * kRow, cb);
      chain_step<NPER>(i == 0 && top, tb, cf, L, d0, D, p1, p2);
      chain_step<NPER>(i == 0 && bottom, bt, cb, back[i], d0, D, p1, p2);
      smem_load<NPER>(s + i * kRow, a);
#pragma unroll
      for (int j = 0; j < NPER; ++j) a[j] = a[j] + L[j];  // + tb
      smem_store<NPER>(s + i * kRow, a);
#pragma unroll
      for (int j = 0; j < NPER; ++j) {
        tb[j] = L[j];
        bt[j] = back[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < kTileY; ++i) {
      if (i >= ny) break;
      const int y = ny - 1 - i;
      float a[NPER];
      smem_load<NPER>(s + y * kRow, a);
#pragma unroll
      for (int j = 0; j < NPER; ++j) a[j] = a[j] + back[i][j];  // + bt
      store_d<NPER>(out + ((long long)(y0 + y) * W + x0 + w) * D, d0, D, a);
    }
  }
}

template <int NPER>
cudaError_t carry_pass(const float* cost, float* dst, int H, int W, int D,
                       float p1, float p2, int n_dirs, cudaStream_t stream) {
  const long long lines = n_dirs == 1 ? H : 2LL * H + 2LL * W;
  const long long blocks = (lines + kScanWarps - 1) / kScanWarps;
  const int smem = kScanWarps * kPrefetch * NPER * 32 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sgm_carry_kernel<NPER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  sgm_carry_kernel<NPER><<<(unsigned)blocks, kScanWarps * 32, smem, stream>>>(
      cost, dst, H, W, D, p1, p2, n_dirs);
  return cudaGetLastError();
}

template <int NPER>
cudaError_t tile_pass(const float* cost, const float* carry, float* out,
                      int H, int W, int D, float p1, float p2,
                      cudaStream_t stream) {
  const int smem = 2 * kTileY * kTileX * NPER * 32 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sgm_tile_kernel<NPER>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles(W, kTileX), n_tiles(H, kTileY));
  sgm_tile_kernel<NPER><<<grid, kTileWarps * 32, smem, stream>>>(
      cost, carry, out, H, W, D, p1, p2);
  return cudaGetLastError();
}

bool shape_ok(int H, int W, int D) {
  return H >= 1 && W >= 1 && D >= 1 && D <= 32 * kMaxPer &&
         n_tiles(H, kTileY) <= 65535;
}

#define BPVO_SGM_DISPATCH(D, CALL)                 \
  switch (((D) + 31) / 32) {                       \
    case 1: return static_cast<int>(CALL(1));      \
    case 2: return static_cast<int>(CALL(2));      \
    case 3: return static_cast<int>(CALL(3));      \
    case 4: return static_cast<int>(CALL(4));      \
    case 5: return static_cast<int>(CALL(5));      \
    case 6: return static_cast<int>(CALL(6));      \
    case 7: return static_cast<int>(CALL(7));      \
    default: return static_cast<int>(CALL(8));     \
  }

}  // namespace

// Floats of scratch for the carries that enter the tiles, all four
// directions: pass 1 (n_dirs = 4) writes them, pass 2 reads them.
extern "C" long long bpvo_sgm_scratch_floats(int H, int W, int D) {
  return 2 * carry_base(1, H, W, D) +
         2LL * n_tiles(H, kTileY) * W * D;
}

// Pass 1 (see above): n_dirs = 4 stores the carries into dst, the scratch
// buffer; n_dirs = 1 stores the left->right aggregate (aggregate_direction)
// into dst, the output.
extern "C" int bpvo_sgm_carry_pass(const float* cost, float* dst, int H,
                                   int W, int D, float p1, float p2,
                                   int n_dirs, void* stream) {
  if (!shape_ok(H, W, D) || (n_dirs != 1 && n_dirs != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BPVO_SGM_CARRY(N) carry_pass<N>(cost, dst, H, W, D, p1, p2, n_dirs, s)
  BPVO_SGM_DISPATCH(D, BPVO_SGM_CARRY)
#undef BPVO_SGM_CARRY
}

// Pass 2: the 4-direction sum (aggregate_4dir) from the cost and pass 1's
// carries.
extern "C" int bpvo_sgm_tile_pass(const float* cost, const float* scratch,
                                  float* out, int H, int W, int D, float p1,
                                  float p2, void* stream) {
  if (!shape_ok(H, W, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BPVO_SGM_TILE(N) tile_pass<N>(cost, scratch, out, H, W, D, p1, p2, s)
  BPVO_SGM_DISPATCH(D, BPVO_SGM_TILE)
#undef BPVO_SGM_TILE
}
