// level_gn.cu - one pyramid level's whole IRLS Gauss-Newton solve in one
// launch, for NVIDIA Hopper (sm_90a).
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
// What bounds it: the finest bench level samples K = 16384 points for ~20
// iterations against a 376x1241 f32 image (1.87 MB, resident in the 50 MB
// L2).  An iteration moves well under 1 MB, so neither bandwidth nor FLOPs
// set the pace: latency does - the chain of dependent block-wide reductions
// (18 per iteration while sigma is re-estimated) and the serial scalar solve.
//
// Design: one thread block runs the whole loop, so the loop state, every
// reduction and the solve stay on one SM, with no second launch and no host
// round trip per iteration.  Threads stride over the points, sampling the
// image straight from global memory.  Residuals go to a (C, K) scratch that
// the bisection re-reads from L1/L2.  H (upper triangle), g and sum w r^2 are
// reduced by warp shuffles and then a fixed tree through shared memory: no
// atomics, so runs are bitwise repeatable.  Thread 0 does the solve, the
// SE(3) update and the tests, and publishes the new state through shared
// memory behind a barrier.  One block uses one of the 132 SMs; spreading the
// finest level over a cluster is later work.
//
// Projection, sampling, residuals and weights round every product and sum
// on its own (__fmul_rn / __fadd_rn are never contracted into FMAs), in the
// plain version's order of tensor ops, so a residual equals the plain
// version's bit for bit.  The median bisection needs that: on Bit-Planes
// channels (smoothed census bits) many residuals tie, and with contracted
// FMAs a 1-ulp difference moved a count across a bisection boundary and the
// first linearization's sigma by 1e-3 at C=8.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSys = 28;  // 21 upper-triangle H entries, 6 of g, sum w r^2
constexpr int kBisectionSteps = 16;
constexpr float kSqrtEps = 3.452669831e-4f;
constexpr float kTukeyT = 4.685f;
constexpr float kHuberK = 1.345f;
constexpr float kPi = 3.14159265358979f;

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

// Loop state: written by thread 0 only, read by all threads after a barrier.
struct State {
  float T[12];      // current pose: R row-major (9), t (3)
  float Tb[12];     // best evaluated pose
  float sys[kSys];  // last reduced system
  int it, conv, sok, status;
  float f_prev, dpn_last, dpn_prev2, g_tol, sigma, dscale, f_best, g_norm;
};

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

// Block-wide sum (or max) of N values per thread; every thread gets the
// result in v.  Warp shuffles, then warp 0 folds the per-warp partials in a
// fixed order.
template <int N, bool kMax>
__device__ void block_reduce(float (&v)[N], float (*red)[kSys], float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_down_sync(0xffffffffu, x, off);
      x = kMax ? fmaxf(x, y) : x + y;
    }
    if (lane == 0) red[warp][i] = x;
  }
  __syncthreads();
  if (warp == 0) {
    for (int i = 0; i < N; ++i) {
      float x = lane < kWarps ? red[lane][i] : (kMax ? -INFINITY : 0.0f);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float y = __shfl_down_sync(0xffffffffu, x, off);
        x = kMax ? fmaxf(x, y) : x + y;
      }
      if (lane == 0) out[i] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = out[i];
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

// Thread 0: convergence tests, jittered Cholesky solve, pose update and
// best-iterate bookkeeping for the system `acc` reduced at pose st.T.
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

__global__ void __launch_bounds__(kThreads)
level_gn_kernel(Params p, const float* __restrict__ pts,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ pix, const float* __restrict__ jac,
                const float* __restrict__ img, const float* __restrict__ T0,
                const float* __restrict__ sc, float* __restrict__ out_T,
                float* __restrict__ stats, float* __restrict__ out_H,
                float* __restrict__ out_g, float* __restrict__ w,
                float* __restrict__ rbuf, uint8_t* __restrict__ okbuf) {
  __shared__ State st;
  __shared__ float red[kWarps][kSys];
  __shared__ float out[kSys];
  const int tid = threadIdx.x;
  const int C = p.C, H = p.H, W = p.W, K = p.K;
  const size_t HW = (size_t)H * W;

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
    float n_loc = 0.0f, amax = 0.0f;
    for (int k = tid; k < K; k += kThreads) {
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
      okbuf[k] = ok;
      if (!ok) {
        for (int c = 0; c < C; ++c) rbuf[(size_t)c * K + k] = 0.0f;
        continue;
      }
      float xf = u - xi, yf = v - yi;
      if (p.cosine) {
        xf = (1.0f - cosf(xf * kPi)) * 0.5f;
        yf = (1.0f - cosf(yf * kPi)) * 0.5f;
      }
      const float ox = 1.0f - xf, oy = 1.0f - yf;
      const size_t base = (size_t)(int)yi * W + (int)xi;
      for (int c = 0; c < C; ++c) {
        const float* I = img + c * HW + base;
        const float i00 = __ldg(I), i01 = __ldg(I + 1);
        const float i10 = __ldg(I + W), i11 = __ldg(I + W + 1);
        const float top = __fadd_rn(__fmul_rn(ox, i00), __fmul_rn(xf, i01));
        const float bot = __fadd_rn(__fmul_rn(ox, i10), __fmul_rn(xf, i11));
        const float I1 = __fadd_rn(__fmul_rn(oy, top), __fmul_rn(yf, bot));
        const float r = I1 - pix[(size_t)c * K + k];
        rbuf[(size_t)c * K + k] = r;
        if (c == 0) amax = fmaxf(amax, fabsf(r));
      }
      n_loc += 1.0f;
    }

    // 2. robust sigma from channel 0, skipped once stable
    float sigma_new = sigma, dscale_new = dscale;
    if (dscale > fmaxf(p.scale_tol, p.scale_tol_rel * sigma)) {
      float nv[1] = {n_loc};
      block_reduce<1, false>(nv, red, out);
      float mv[1] = {amax};
      block_reduce<1, true>(mv, red, out);
      const float n = nv[0], target = floorf((n + 1.0f) * 0.5f);
      float lo = 0.0f, hi = mv[0];
      for (int step = 0; step < kBisectionSteps; ++step) {
        const float mid = (lo + hi) * 0.5f;
        float cnt[1] = {0.0f};
        for (int k = tid; k < K; k += kThreads)
          if (okbuf[k] && fabsf(rbuf[k]) <= mid) cnt[0] += 1.0f;
        block_reduce<1, false>(cnt, red, out);
        const bool pred = cnt[0] >= target;
        lo = pred ? lo : mid;
        hi = pred ? mid : hi;
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
    for (int k = tid; k < K; k += kThreads) {
      const bool ok = okbuf[k];
      for (int c = 0; c < C; ++c) {
        const size_t ck = (size_t)c * K + k;
        const float r = rbuf[ck];
        const float wv = ok ? robust_weight(r / sigma_new, p.loss) : 0.0f;
        w[ck] = wv;
        if (wv == 0.0f) continue;
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
          for (int j = i; j < 6; ++j) acc[idx++] += lj[i] * J[j];
#pragma unroll
        for (int i = 0; i < 6; ++i) acc[21 + i] += lj[i] * r;
        acc[27] += (r * wv) * r;
      }
    }
    block_reduce<kSys, false>(acc, red, out);

    // 4. tests, solve, update (thread 0), published behind the barrier
    if (tid == 0) solve_and_update(st, p, sc, acc, sigma_new, dscale_new);
    __syncthreads();
  }

  if (tid == 0) {
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
}

}  // namespace

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
  level_gn_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, points, valid, pixels, jacobians, channels, T0, sc, out_T, stats,
      out_H, out_g, w, r_scratch, ok_scratch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bpvo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
