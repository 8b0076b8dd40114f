// level_gn.cu - one pyramid level's whole IRLS Gauss-Newton solve in one
// launch of a thread-block cluster, for NVIDIA Hopper (sm_90a).
//
// Replaces: bpvo_tpu/ops/pallas/level_gn_kernel.py, make_level_gn (kernel
// body _kernel, pallas_call at :692).  Wrapper and plain PyTorch version:
// bpvo_tpu_torch/ops/level_gn.py.  Per iteration: project the K template
// points by the current pose, sample C channels (bilinear or cosine), form
// residuals, estimate the robust sigma from channel 0 by a 16-step count
// bisection of the median (skipped once stable), weight (Tukey / Huber / L2),
// reduce H = J^T W J, g = J^T W r and sum w r^2, run the convergence tests,
// solve the jittered 6x6 Cholesky and compose T <- T Tn^-1 exp(-dp) Tn; at the
// end fall back to the best evaluated pose when the loop did not converge.
//
// What bounds it: latency.  The finest bench level samples K = 16384 points
// for ~8 (C=1) to ~22 (C=8) iterations against a 376x1241 image stack that
// stays in the 50 MB L2; an iteration moves a few MB at most and does ~10
// MFLOP, microseconds of the card's rates.  What an iteration waits for is
// the chain of dependent reductions over all K points (each ends in a
// barrier) and the serial 6x6 solve; at C=8 also the gathers of 4 taps x 8
// channels per point, which each SM issues at its own L2 rate.  One
// 512-thread block takes ~77 us per iteration at C=1 and ~279 us at C=8,
// with ~18 dependent block reductions while sigma is re-estimated.
//
// Design: one cluster of n_ctas CTAs (bpvo_level_gn_ctas: one CTA up to 512
// points, else one per 256 points, at most 16; from a sweep over 1-16 CTAs
// at the 12 level shapes of the VO paths, scripts/level_gn_sweep.py) runs
// the whole loop.  The points are split into one contiguous chunk per CTA,
// so reads of points, pixels and Jacobians coalesce and the gathers spread
// over n_ctas SMs.
// Where a thread holds at most 2 points and C <= 8 (every level the router
// sends here), its residuals and ok flags stay in registers across the
// iteration; otherwise they go to a (C, K) scratch.  Gathers read the image
// straight from global memory: the probes (bpvo_tpu_torch/probes) found an
// L2 gather faster than one from shared or distributed shared memory, and
// the C=8 stack does not fit a cluster's shared memory anyway.
//
// Reductions: each CTA folds its threads' values by warp shuffles (floats)
// or one redux instruction per warp (integer counts, which any order sums
// exactly), then by a fixed tree over its warps into a slot in its own
// shared memory; after one cluster barrier EVERY CTA reads the n_ctas slots
// through DSMEM in rank order and adds them in that order, so every CTA
// holds the same bits.  Slots alternate between two buffers, so one barrier
// per reduction suffices.
// Thread 0 of every CTA then runs the convergence tests, the solve and the
// pose update on identical inputs: the loop state needs no broadcast and no
// second barrier.  No atomics: runs are bitwise repeatable.
//
// The median search takes 4 bisection depths per cluster reduction: a round
// counts each point against all 15 midpoints of the next 4 depths (the
// sequential bisection's own (lo + hi) * 0.5 on its own endpoints), reduces
// the 15 integer counts, and every thread walks the 4 decisions down the
// tree, landing on the sequential search's (lo, hi) bit for bit.  So an
// iteration that re-estimates sigma has 6 cluster barriers (n and max|r|, 4
// rounds, the system) instead of 18; one past the stable-skip has 1.  Counts,
// n and the max do not depend on the order of reduction, and the residuals
// equal the plain version's (below), so sigma equals the plain version's bit
// for bit at any n_ctas.
//
// Not built: a cooperative grid of 132 CTAs, one per SM.  Its barrier costs
// 1.24 us against a cluster barrier's ~0.6 us (the probes) and it would
// hold the whole card for one level solve; at C=8 its extra SMs would cut the
// ~17 us of per-iteration work on 16 SMs to ~2 us, while 6 barriers cost ~7
// us on the grid against ~4 us on the cluster.  It is an open question in
// PERF.md whether that wins at the C=8 finest level.
//
// Projection, sampling, residuals and weights round every product and sum
// on its own (__fmul_rn / __fadd_rn are never contracted into FMAs), in the
// plain version's order of tensor ops, so a residual equals the plain
// version's bit for bit.  The median bisection needs that: on Bit-Planes
// channels (smoothed census bits) many residuals tie, and with contracted
// FMAs a 1-ulp difference moved a count across a bisection boundary and the
// first linearization's sigma by 1e-3 at C=8.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCtas = 16;        // the largest (non-portable) cluster
constexpr int kPointsPerCta = 256;  // the cluster-size rule (ctas_for),
constexpr int kOneCtaPoints = 512;  // from the sweep
constexpr int kRegPoints = 2;       // points a thread keeps in registers
constexpr int kRegChannels = 8;     // channels it keeps of each
constexpr int kSys = 28;  // 21 upper-triangle H entries, 6 of g, sum w r^2
constexpr int kDepths = 4;                    // bisection depths per round
constexpr int kRounds = 16 / kDepths;         // of the 16-step bisection
constexpr int kNodes = (1 << kDepths) - 1;    // midpoints per round
constexpr float kSqrtEps = 3.452669831e-4f;
constexpr float kTukeyT = 4.685f;
constexpr float kHuberK = 1.345f;
constexpr float kPi = 3.14159265358979f;

static_assert(kNodes <= kSys, "a round's counts share the reduction slots");

enum Loss { kTukey = 0, kHuber = 1, kL2 = 2 };
enum Status {
  kMaxIterations = 0,
  kParameterTol = 1,
  kFunctionTol = 2,
  kGradientTol = 3,
  kSolverError = 4
};

struct Params {
  int C, H, W, K;
  float fx, fy, cx, cy, sigma0, dscale0;
  int loss, cosine, max_iterations;
  float function_tol, parameter_tol, gradient_tol, scale_tol, scale_tol_rel;
};

// Loop state: each CTA's own copy, written by its thread 0 only, read by all
// its threads after a barrier.  Every CTA computes the same values.
struct State {
  float T[12];      // current pose: R row-major (9), t (3)
  float Tb[12];     // best evaluated pose
  float sys[kSys];  // last reduced system
  int it, conv, sok, status;
  float f_prev, dpn_last, dpn_prev2, g_tol, sigma, dscale, f_best, g_norm;
};

// A CTA's shared memory.  Reductions move 32-bit words (float sums, integer
// counts, a float max as its bits).
struct Shared {
  State st;
  uint32_t red[kWarps][kSys];   // per-warp partials
  uint32_t slot[2][kSys];       // this CTA's partial, read by every CTA
  uint32_t total[kSys];         // the cluster's result
};

__device__ __forceinline__ uint32_t to_word(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ uint32_t to_word(uint32_t x) { return x; }
template <typename T>
__device__ __forceinline__ T from_word(uint32_t w);
template <>
__device__ __forceinline__ float from_word<float>(uint32_t w) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ uint32_t from_word<uint32_t>(uint32_t w) {
  return w;
}

__device__ __forceinline__ float robust_weight(float u, int loss) {
  if (loss == kTukey) {
    const float x = u / kTukeyT;
    const float w = __fsub_rn(1.0f, __fmul_rn(x, x));
    return fabsf(u) < kTukeyT ? w * w : 0.0f;
  }
  if (loss == kHuber) {
    const float au = fabsf(u);
    return au < kHuberK ? 1.0f : kHuberK / fmaxf(au, 1e-20f);
  }
  return 1.0f;
}

// T[0..2] . (X, Y, Z) + t with the plain version's rounding.
__device__ __forceinline__ float row_dot(const float* T, float X, float Y,
                                         float Z, float t) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[0], X), __fmul_rn(T[1], Y)),
                             __fmul_rn(T[2], Z)),
                   t);
}

// The bisection's midpoint, (lo + hi) * 0.5 rounded as the plain version.
__device__ __forceinline__ float midpoint(float lo, float hi) {
  return __fmul_rn(__fadd_rn(lo, hi), 0.5f);
}

// A barrier over the cluster (a CTA barrier when the cluster is one CTA).
__device__ __forceinline__ void cluster_barrier(const cg::cluster_group& cl,
                                                int n_ctas) {
  if (n_ctas > 1)
    cl.sync();
  else
    __syncthreads();
}

// Float sums: a fixed shuffle tree in each warp (lane 0 gets the sum).
struct FloatSum {
  __device__ float operator()(int, float a, float b) const { return a + b; }
  __device__ float warp(int, float x) const {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    return x;
  }
};

// Integer sums, or maxima where bit i of max_mask is set: exact in any
// order, so each warp takes one redux instruction per value.
struct IntReduce {
  uint32_t max_mask;
  __device__ uint32_t operator()(int i, uint32_t a, uint32_t b) const {
    return (max_mask >> i & 1) ? max(a, b) : a + b;
  }
  __device__ uint32_t warp(int i, uint32_t x) const {
    return (max_mask >> i & 1) ? __reduce_max_sync(0xffffffffu, x)
                               : __reduce_add_sync(0xffffffffu, x);
  }
};

// Combines N values per thread over the whole cluster with op; the result
// lands in sh.total, the same bits in every CTA, and stays there until the
// next reduction.  Each warp folds its lanes (op.warp), then a fixed shuffle
// tree over the kWarps per-warp partials (one group of kWarps lanes per
// value, all values at once) gives this CTA's slot; after the cluster
// barrier thread i < N of every CTA combines the slots of ranks 0, 1, ...,
// n_ctas - 1 in that order.  ``parity`` picks the slot buffer and flips: the
// next reduction writes the other one, which every CTA finished reading
// before this reduction's barrier.
template <typename T, int N, typename Op>
__device__ void cluster_reduce(const T (&v)[N], Op op, Shared& sh,
                               int& parity, const cg::cluster_group& cl,
                               int n_ctas) {
  static_assert(N * kWarps <= kThreads, "one lane per partial");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const T x = op.warp(i, v[i]);
    if (lane == 0) sh.red[warp][i] = to_word(x);
  }
  __syncthreads();
  // whole warps only, so every shuffle has its full mask; lanes past the
  // last value fold a copy of it and store nothing
  if (threadIdx.x < (N * kWarps + 31) / 32 * 32) {
    const int i = min((int)threadIdx.x / kWarps, N - 1);
    const int part = threadIdx.x % kWarps;
    T x = from_word<T>(sh.red[part][i]);
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
      x = op(i, x, from_word<T>(__shfl_down_sync(0xffffffffu, to_word(x), off,
                                                 kWarps)));
    if (part == 0 && (int)threadIdx.x < N * kWarps)
      sh.slot[parity][i] = to_word(x);
  }
  cluster_barrier(cl, n_ctas);
  if (threadIdx.x < N) {
    // all remote loads in flight at once, then the fold in rank order
    const int i = threadIdx.x;
    uint32_t w[kMaxCtas];
#pragma unroll
    for (int r = 0; r < kMaxCtas; ++r)
      if (r < n_ctas) w[r] = *cl.map_shared_rank(&sh.slot[parity][i], r);
    T x = from_word<T>(w[0]);
#pragma unroll
    for (int r = 1; r < kMaxCtas; ++r)
      if (r < n_ctas) x = op(i, x, from_word<T>(w[r]));
    sh.total[i] = to_word(x);
  }
  __syncthreads();
  parity ^= 1;
}

// R, t of Tn^-1 exp(d) Tn for the twist d, with Tn = [sI | -sc; 0 1].
__device__ void exp_normalized(const float d[6], float s, const float c[3],
                               float R[3][3], float t[3]) {
  const float w0 = d[0], w1 = d[1], w2 = d[2];
  const float t2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float theta = sqrtf(fmaxf(t2, 1e-30f));
  const bool small = t2 < 1e-8f;
  const float A = small ? 1.0f - t2 / 6.0f + t2 * t2 / 120.0f
                        : sinf(theta) / theta;
  const float B = small ? 0.5f - t2 / 24.0f + t2 * t2 / 720.0f
                        : (1.0f - cosf(theta)) / fmaxf(t2, 1e-30f);
  const float Cc = small ? 1.0f / 6.0f - t2 / 120.0f + t2 * t2 / 5040.0f
                         : (1.0f - A) / fmaxf(t2, 1e-30f);
  const float ww00 = -(w1 * w1 + w2 * w2), ww11 = -(w0 * w0 + w2 * w2);
  const float ww22 = -(w0 * w0 + w1 * w1);
  const float ww01 = w0 * w1, ww02 = w0 * w2, ww12 = w1 * w2;
  R[0][0] = 1.0f + B * ww00;
  R[0][1] = -A * w2 + B * ww01;
  R[0][2] = A * w1 + B * ww02;
  R[1][0] = A * w2 + B * ww01;
  R[1][1] = 1.0f + B * ww11;
  R[1][2] = -A * w0 + B * ww12;
  R[2][0] = -A * w1 + B * ww02;
  R[2][1] = A * w0 + B * ww12;
  R[2][2] = 1.0f + B * ww22;
  const float V[3][3] = {
      {1.0f + Cc * ww00, -B * w2 + Cc * ww01, B * w1 + Cc * ww02},
      {B * w2 + Cc * ww01, 1.0f + Cc * ww11, -B * w0 + Cc * ww12},
      {-B * w1 + Cc * ww02, B * w0 + Cc * ww12, 1.0f + Cc * ww22}};
  const float inv_s = 1.0f / s;
  for (int i = 0; i < 3; ++i) {
    const float te = V[i][0] * d[3] + V[i][1] * d[4] + V[i][2] * d[5];
    t[i] = te * inv_s + c[i] - (R[i][0] * c[0] + R[i][1] * c[1] + R[i][2] * c[2]);
  }
}

// Thread 0 of each CTA: convergence tests, jittered Cholesky solve, pose
// update and best-iterate bookkeeping for the system `acc` reduced at pose
// st.T.
__device__ void solve_and_update(State& st, const Params& p, const float* sc,
                                 const float acc[kSys], float sigma_new,
                                 float dscale_new) {
  float h[6][6], g[6];
  int idx = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) h[i][j] = h[j][i] = acc[idx++];
  for (int i = 0; i < 6; ++i) g[i] = acc[21 + i];
  const float f_new = sqrtf(fmaxf(acc[27], 0.0f));
  float gn = fabsf(g[0]);
  for (int i = 1; i < 6; ++i) gn = fmaxf(gn, fabsf(g[i]));

  const bool first = st.it == 0;
  const float g_tol = first ? p.gradient_tol * fmaxf(gn, kSqrtEps) : st.g_tol;
  const float dl = st.dpn_last, fp = st.f_prev;
  const bool p_tol = dl < p.parameter_tol ||
                     dl < p.parameter_tol * (kSqrtEps + st.dpn_prev2);
  const float df = fabsf(f_new - fp);
  const bool f_tol = f_new < p.function_tol ||
                     f_new < p.function_tol * (kSqrtEps + fp) ||
                     df < p.function_tol ||
                     df < p.function_tol * fmaxf(fp, 1.0f);
  const bool g_ok = gn < g_tol;
  bool conv;
  int status;
  if (first) {
    conv = g_ok;
    status = g_ok ? kGradientTol : kMaxIterations;
  } else {
    conv = p_tol || f_tol || g_ok;
    status = p_tol ? kParameterTol
                   : (f_tol ? kFunctionTol
                            : (g_ok ? kGradientTol : kMaxIterations));
  }

  // Cholesky of H + (1e-6 max(diag) + 1e-12) I
  float maxdiag = h[0][0];
  for (int i = 1; i < 6; ++i) maxdiag = fmaxf(maxdiag, h[i][i]);
  const float jit = 1e-6f * maxdiag + 1e-12f;
  float L[6][6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = h[i][j] + (i == j ? jit : 0.0f);
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(fmaxf(s, 1e-20f)) : s / L[j][j];
    }
  }
  float y[6], dp[6];
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * dp[k];
    dp[i] = s / L[i][i];
  }
  bool finite = true;
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(dp[i]);
  if (!finite)
    for (int i = 0; i < 6; ++i) dp[i] = 0.0f;
  // residual check |H dp - g|_inf <= 1e-3 (1 + |g|_inf); NaN fails it
  float resid = 0.0f;
  for (int i = 0; i < 6; ++i) {
    float ri = -g[i];
    for (int j = 0; j < 6; ++j) ri += h[i][j] * dp[j];
    const float a = fabsf(ri);
    resid = (a > resid || isnan(a)) ? a : resid;
  }
  const bool ok_solve = finite && resid <= 1e-3f * (1.0f + gn);
  float dpn = 0.0f;
  for (int i = 0; i < 6; ++i) dpn += dp[i] * dp[i];
  dpn = sqrtf(dpn);
  const bool do_update = !conv && ok_solve;

  if (f_new < st.f_best) {  // the best evaluated pose is the entering one
    for (int i = 0; i < 12; ++i) st.Tb[i] = st.T[i];
    st.f_best = f_new;
  }
  if (do_update) {
    float nd[6], Re[3][3], te[3];
    for (int i = 0; i < 6; ++i) nd[i] = -dp[i];
    exp_normalized(nd, sc[0], sc + 1, Re, te);
    float Tn[12];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j)
        Tn[3 * i + j] = st.T[3 * i] * Re[0][j] + st.T[3 * i + 1] * Re[1][j] +
                        st.T[3 * i + 2] * Re[2][j];
      Tn[9 + i] = st.T[3 * i] * te[0] + st.T[3 * i + 1] * te[1] +
                  st.T[3 * i + 2] * te[2] + st.T[9 + i];
    }
    for (int i = 0; i < 12; ++i) st.T[i] = Tn[i];
  }
  st.dpn_prev2 = st.dpn_last;
  if (do_update) st.dpn_last = dpn;
  st.status = ok_solve ? status : kSolverError;
  st.f_prev = f_new;
  st.g_tol = g_tol;
  st.g_norm = gn;
  st.sigma = sigma_new;
  st.dscale = dscale_new;
  st.conv = conv;
  st.sok = ok_solve;
  st.it += 1;
  for (int i = 0; i < kSys; ++i) st.sys[i] = acc[i];
}

// kRegs: each thread holds at most kRegPoints points of at most
// kRegChannels channels, whose residuals and ok flags stay in registers;
// otherwise they go to rbuf (C, K) and okbuf (K).
template <bool kRegs>
__global__ void __launch_bounds__(kThreads, 1)
level_gn_kernel(Params p, const float* __restrict__ pts,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ pix, const float* __restrict__ jac,
                const float* __restrict__ img, const float* __restrict__ T0,
                const float* __restrict__ sc, float* __restrict__ out_T,
                float* __restrict__ stats, float* __restrict__ out_H,
                float* __restrict__ out_g, float* __restrict__ w,
                float* __restrict__ rbuf, uint8_t* __restrict__ okbuf) {
  __shared__ Shared sh;
  const cg::cluster_group cl = cg::this_cluster();
  const int n_ctas = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x;
  const int C = p.C, H = p.H, W = p.W, K = p.K;
  const size_t HW = (size_t)H * W;
  // this CTA's contiguous chunk of points
  const int chunk = (K + n_ctas - 1) / n_ctas;
  const int begin = min(K, rank * chunk), end = min(K, begin + chunk);
  int parity = 0;
  State& st = sh.st;

  float rreg[kRegs ? kRegPoints * kRegChannels : 1];
  bool okreg[kRegs ? kRegPoints : 1] = {};
  // the residual of channel c at this thread's j-th point k, and its flag
  auto res = [&](int j, int c, int k) -> float& {
    if constexpr (kRegs)
      return rreg[j * kRegChannels + c];
    else
      return rbuf[(size_t)c * K + k];
  };
  auto point_ok = [&](int j, int k) -> bool {
    if constexpr (kRegs)
      return okreg[j];
    else
      return okbuf[k] != 0;
  };
  // f(j, k) for this thread's points k of the chunk, the j-th of them
  auto each_point = [&](auto&& f) {
#pragma unroll
    for (int j = 0; !kRegs || j < kRegPoints; ++j) {
      const int k = begin + tid + j * kThreads;
      if (k >= end) break;
      f(j, k);
    }
  };
  // channels 0..C-1, unrolled over kRegChannels when they are registers
  auto each_channel = [&](auto&& f) {
#pragma unroll
    for (int c = 0; c < (kRegs ? kRegChannels : C); ++c) {
      if (kRegs && c >= C) break;
      f(c);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) st.T[3 * i + j] = T0[4 * i + j];
      st.T[9 + i] = T0[4 * i + 3];
    }
    for (int i = 0; i < 12; ++i) st.Tb[i] = st.T[i];
    for (int i = 0; i < kSys; ++i) st.sys[i] = 0.0f;
    st.it = 0;
    st.conv = 0;
    st.sok = 1;
    st.status = kMaxIterations;
    st.f_prev = st.dpn_last = st.dpn_prev2 = st.g_tol = st.g_norm = 0.0f;
    st.sigma = p.sigma0;
    st.dscale = p.dscale0;
    st.f_best = INFINITY;
  }
  __syncthreads();

  while (!st.conv && st.sok && st.it < p.max_iterations) {
    float T[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) T[i] = st.T[i];
    const float sigma = st.sigma, dscale = st.dscale;

    // 1. project, bounds-test, sample, residual
    uint32_t n_loc = 0;
    float amax = 0.0f;
    each_point([&](int j, int k) {
      const float X = pts[3 * k], Y = pts[3 * k + 1], Z = pts[3 * k + 2];
      const float Xc = row_dot(T, X, Y, Z, T[9]);
      const float Yc = row_dot(T + 3, X, Y, Z, T[10]);
      const float Zc = row_dot(T + 6, X, Y, Z, T[11]);
      const float zi = 1.0f / (fabsf(Zc) > 1e-12f ? Zc : 1e-12f);
      const float u = __fadd_rn(__fmul_rn(__fmul_rn(p.fx, Xc), zi), p.cx);
      const float v = __fadd_rn(__fmul_rn(__fmul_rn(p.fy, Yc), zi), p.cy);
      const float xi = floorf(u), yi = floorf(v);
      const bool ok = valid[k] && Zc > 1e-6f && xi >= 0.0f &&
                      xi < (float)(W - 1) && yi >= 0.0f && yi < (float)(H - 1);
      if constexpr (kRegs)
        okreg[j] = ok;
      else
        okbuf[k] = ok;
      if (!ok) return;   // its residuals are never read
      float xf = u - xi, yf = v - yi;
      if (p.cosine) {
        xf = (1.0f - cosf(xf * kPi)) * 0.5f;
        yf = (1.0f - cosf(yf * kPi)) * 0.5f;
      }
      const float ox = 1.0f - xf, oy = 1.0f - yf;
      const size_t base = (size_t)(int)yi * W + (int)xi;
      each_channel([&](int c) {
        const float* I = img + c * HW + base;
        const float i00 = __ldg(I), i01 = __ldg(I + 1);
        const float i10 = __ldg(I + W), i11 = __ldg(I + W + 1);
        const float top = __fadd_rn(__fmul_rn(ox, i00), __fmul_rn(xf, i01));
        const float bot = __fadd_rn(__fmul_rn(ox, i10), __fmul_rn(xf, i11));
        const float I1 = __fadd_rn(__fmul_rn(oy, top), __fmul_rn(yf, bot));
        const float r = I1 - __ldg(pix + (size_t)c * K + k);
        res(j, c, k) = r;
        if (c == 0) amax = fmaxf(amax, fabsf(r));
      });
      n_loc += 1;
    });

    // 2. robust sigma from channel 0, skipped once stable
    float sigma_new = sigma, dscale_new = dscale;
    if (dscale > fmaxf(p.scale_tol, p.scale_tol_rel * sigma)) {
      // n (a count) and max|r| (a non-negative float: its bits order as it)
      const uint32_t na[2] = {n_loc, to_word(amax)};
      cluster_reduce(na, IntReduce{2u}, sh, parity, cl, n_ctas);
      const float n = (float)sh.total[0], target = floorf((n + 1.0f) * 0.5f);
      float lo = 0.0f, hi = from_word<float>(sh.total[1]);
      for (int round = 0; round < kRounds; ++round) {
        // the midpoints of the next kDepths depths in heap order: node i
        // spans (l_i, h_i] and splits at t_i; its children span (l_i, t_i]
        // and (t_i, h_i]
        float t[kNodes];
        {
          float l[kNodes], h[kNodes];
          l[0] = lo;
          h[0] = hi;
#pragma unroll
          for (int i = 0; i < kNodes; ++i) {
            t[i] = midpoint(l[i], h[i]);
            if (2 * i + 2 < kNodes) {
              l[2 * i + 1] = l[i];
              h[2 * i + 1] = t[i];
              l[2 * i + 2] = t[i];
              h[2 * i + 2] = h[i];
            }
          }
        }
        uint32_t cnt[kNodes];
#pragma unroll
        for (int i = 0; i < kNodes; ++i) cnt[i] = 0;
        each_point([&](int j, int k) {
          if (!point_ok(j, k)) return;
          const float a = fabsf(res(j, 0, k));
#pragma unroll
          for (int i = 0; i < kNodes; ++i) cnt[i] += a <= t[i];
        });
        cluster_reduce(cnt, IntReduce{0u}, sh, parity, cl, n_ctas);
        // the kDepths decisions of the sequential bisection; its midpoint
        // at node i is t[i], recomputed from the same endpoints
        int node = 0;
        for (int d = 0; d < kDepths; ++d) {
          const float mid = midpoint(lo, hi);
          const bool pred = (float)sh.total[node] >= target;
          lo = pred ? lo : mid;
          hi = pred ? mid : hi;
          node = 2 * node + (pred ? 1 : 2);
        }
      }
      const float med = n > 0.0f ? hi : 0.0f;
      float est = 1.4826f * (1.0f + 5.0f / fmaxf(n - 6.0f, 1.0f)) * med;
      est = est < 1e-6f ? 1.0f : est;
      dscale_new = fabsf(est - sigma);
      sigma_new = est;
    }

    // 3. weights and the normal equations
    float acc[kSys];
#pragma unroll
    for (int i = 0; i < kSys; ++i) acc[i] = 0.0f;
    each_point([&](int j, int k) {
      if (!point_ok(j, k)) return;
      each_channel([&](int c) {
        const size_t ck = (size_t)c * K + k;
        const float r = res(j, c, k);
        const float wv = robust_weight(r / sigma_new, p.loss);
        if (wv == 0.0f) return;
        float J[6], lj[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          J[i] = __ldg(jac + ck * 6 + i);
          lj[i] = J[i] * wv;
        }
        int idx = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int q = i; q < 6; ++q) acc[idx++] += lj[i] * J[q];
#pragma unroll
        for (int i = 0; i < 6; ++i) acc[21 + i] += lj[i] * r;
        acc[27] += (r * wv) * r;
      });
    });
    cluster_reduce(acc, FloatSum{}, sh, parity, cl, n_ctas);

    // 4. tests, solve, update: thread 0 of every CTA, on the same inputs
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < kSys; ++i) acc[i] = from_word<float>(sh.total[i]);
      solve_and_update(st, p, sc, acc, sigma_new, dscale_new);
    }
    __syncthreads();
  }

  // the weights of the last linearization, from its residuals and sigma
  const bool any = st.it > 0;
  const float sigma_last = st.sigma;
  each_point([&](int j, int k) {
    const bool ok = any && point_ok(j, k);
    each_channel([&](int c) {
      w[(size_t)c * K + k] =
          ok ? robust_weight(res(j, c, k) / sigma_last, p.loss) : 0.0f;
    });
  });

  if (rank == 0 && tid == 0) {
    const bool use_best = !st.conv && st.f_best < st.f_prev;
    const float* Tf = use_best ? st.Tb : st.T;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) out_T[4 * i + j] = Tf[3 * i + j];
      out_T[4 * i + 3] = Tf[9 + i];
      out_T[12 + i] = 0.0f;
    }
    out_T[15] = 1.0f;
    stats[0] = (float)st.it;
    stats[1] = st.f_prev;
    stats[2] = st.g_norm;
    stats[3] = (float)st.status;
    stats[4] = st.sigma;
    stats[5] = st.dscale;
    stats[6] = st.conv ? 1.0f : 0.0f;
    stats[7] = st.sok ? 1.0f : 0.0f;
    int idx = 0;
    for (int i = 0; i < 6; ++i)
      for (int j = i; j < 6; ++j) out_H[6 * i + j] = out_H[6 * j + i] = st.sys[idx++];
    for (int i = 0; i < 6; ++i) out_g[i] = st.sys[21 + i];
  }
  // no CTA leaves while another may still read its slots
  if (n_ctas > 1) cl.sync();
}

// The cluster-size rule: one CTA up to kOneCtaPoints, else one per
// kPointsPerCta points, at most kMaxCtas.
int ctas_for(int K) {
  if (K <= kOneCtaPoints) return 1;
  const int n = (K + kPointsPerCta - 1) / kPointsPerCta;
  return n > kMaxCtas ? kMaxCtas : n;
}

// Sets the cluster attributes of a variant and checks, once per device,
// variant and cluster size, that such a cluster can be placed on the card.
template <bool kRegs>
cudaError_t prepare(const cudaLaunchConfig_t& cfg, int n_ctas) {
  constexpr int kMaxDevices = 16;
  static int8_t placeable[kMaxDevices][kMaxCtas + 1];  // 0 unknown, 1 yes
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && placeable[dev][n_ctas]) return cudaSuccess;
  if (n_ctas > 8) {
    e = cudaFuncSetAttribute(level_gn_kernel<kRegs>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, level_gn_kernel<kRegs>, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  if (dev < kMaxDevices) placeable[dev][n_ctas] = 1;
  return cudaSuccess;
}

template <bool kRegs, typename... Args>
cudaError_t launch(int n_ctas, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = prepare<kRegs>(cfg, n_ctas);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, level_gn_kernel<kRegs>, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// CTAs of the cluster that solves a level of K points.
extern "C" int bpvo_level_gn_ctas(int K) { return ctas_for(K); }

extern "C" int bpvo_level_gn(
    const float* points, const uint8_t* valid, const float* pixels,
    const float* jacobians, const float* channels, const float* T0,
    const float* sc, float* out_T, float* stats, float* out_H, float* out_g,
    float* w, float* r_scratch, uint8_t* ok_scratch, int C, int H, int W,
    int K, float fx, float fy, float cx, float cy, float sigma0, float dscale0,
    int loss, int cosine, int max_iterations, float function_tol,
    float parameter_tol, float gradient_tol, float scale_tol,
    float scale_tol_rel, void* stream) {
  const Params p{C, H, W, K, fx, fy, cx, cy, sigma0, dscale0,
                 loss, cosine, max_iterations, function_tol, parameter_tol,
                 gradient_tol, scale_tol, scale_tol_rel};
  const int n_ctas = ctas_for(K);
  if (n_ctas < 1 || n_ctas > kMaxCtas)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = (K + n_ctas - 1) / n_ctas;
  const bool regs = chunk <= kRegPoints * kThreads && C <= kRegChannels;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      regs ? launch<true>(n_ctas, s, p, points, valid, pixels, jacobians,
                          channels, T0, sc, out_T, stats, out_H, out_g, w,
                          r_scratch, ok_scratch)
           : launch<false>(n_ctas, s, p, points, valid, pixels, jacobians,
                           channels, T0, sc, out_T, stats, out_H, out_g, w,
                           r_scratch, ok_scratch);
  return static_cast<int>(e);
}

extern "C" const char* bpvo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
