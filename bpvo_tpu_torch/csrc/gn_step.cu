// gn_step.cu - the step of a gauss_newton.run iteration after its
// linearization, for NVIDIA Hopper (sm_90a): the gradient and step norms,
// the convergence tests, the jittered 6x6 Cholesky solve with its checks,
// the best evaluated pose, the pose update T <- T Tn^-1 exp(-dp) Tn, the
// status and iteration count, and the loop's exit test and sigma flag.
//
// Replaces: no Pallas kernel.  The JAX package leaves this tail of the body
// of gn.run's lax.while_loop (bpvo_tpu/solver/gauss_newton.py:457-487) to
// XLA, which fuses it.  In plain torch it was ~310 launches of 0-d and
// 6-element ops an iteration, each a node of the WHILE body.  Wrapper and
// plain PyTorch version: bpvo_tpu_torch/ops/gn_step.py.
//
// What bounds it: ~600 bytes in and out and a few hundred flops, so nothing
// but its launch and its chain of dependent operations (the Cholesky's
// divides and square roots).  Design: one thread (one CTA of one warp) loads
// every input at once, runs the serial solve and writes the new state over
// the state it was given.
//
// The jitter, the Cholesky, the substitutions, the norms' max and the tests
// round every product and sum on its own (__fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn / __fsqrt_rn are never contracted into FMAs), in the
// plain version's order of tensor ops, with torch's NaN rules for max and
// clamp, so dp, the tests and the status equal the plain version's bit for
// bit.  |dp| sums its squares in index order, where torch's reduce kernel
// takes an order of its own: it is within ops/gn_step.py's DP_NORM_RTOL
// of the plain version's.
// The residual check's H dp, exp's sums and the 4x4 products go through
// cuBLAS and the reduce kernel in the plain version: the new pose is within
// ops/gn_step.py's T_ATOL of the plain version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Status {
  kMaxIterations = 0,
  kParameterTol = 1,
  kFunctionTol = 2,
  kGradientTol = 3,
  kSolverError = 4
};

constexpr float kSqrtEps = 3.452669831e-4f;

struct Step {
  // the linearization's outputs and the level's normalization
  const float *H, *g, *f, *sigma, *dscale, *s, *c;
  // the loop state: read, then overwritten with the new state
  float *T, *T_best, *f_best, *dp, *f_norm, *dp_norm, *g_tol, *scale,
      *delta_scale, *H_out, *g_out;
  int32_t *status, *num_iters;
  uint8_t *conv, *ok, *pred, *flag;
  float* aux;  // g_norm, dp_new (6)
  int first, max_iterations;
  float function_tol, parameter_tol, gradient_tol, scale_tol, scale_tol_rel;
};

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// one step of torch.max: NaN wins
__device__ __forceinline__ float max_nan(float m, float x) {
  return (isnan(x) || x > m) ? x : m;
}

// out = a @ b for row-major 4x4 matrices
__device__ void mat4(const float a[16], const float b[16], float out[16]) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      float acc = 0.0f;
      for (int k = 0; k < 4; ++k) acc = fmaf(a[4 * i + k], b[4 * k + j], acc);
      out[4 * i + j] = acc;
    }
}

// Tn^-1 exp(p) Tn (warp.params_to_pose) for the twist p, with
// Tn = [sI | -sc; 0 1] and Tn^-1 = [I / s | -(1/s)(-s c); 0 1]; exp as
// se3.exp's closed form.
__device__ void params_to_pose(const float p[6], float s, const float c[3],
                               float P[16]) {
  const float w0 = p[0], w1 = p[1], w2 = p[2];
  const float t2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float theta = sqrtf(clamp_min(t2, 1e-12f));
  const float t2c = clamp_min(t2, 1e-12f);
  const bool small = t2 < 1e-8f;
  const float A = small ? 1.0f - t2 / 6.0f + t2 * t2 / 120.0f
                        : sinf(theta) / theta;
  const float B = small ? 0.5f - t2 / 24.0f + t2 * t2 / 720.0f
                        : (1.0f - cosf(theta)) / t2c;
  const float C = small ? 1.0f / 6.0f - t2 / 120.0f + t2 * t2 / 5040.0f
                        : (1.0f - A) / t2c;
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float E[16] = {0.0f};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float W2 = 0.0f;
      for (int k = 0; k < 3; ++k) W2 = fmaf(W[i][k], W[k][j], W2);
      const float I = i == j ? 1.0f : 0.0f;
      E[4 * i + j] = I + A * W[i][j] + B * W2;       // R
      // V's row i, column j, times v_j into t_i
      E[4 * i + 3] = fmaf(I + B * W[i][j] + C * W2, p[3 + j], E[4 * i + 3]);
    }
  E[15] = 1.0f;
  const float inv_s = 1.0f / s;
  float Tn[16] = {0.0f}, Tn_inv[16] = {0.0f}, M[16];
  for (int i = 0; i < 3; ++i) {
    Tn[5 * i] = s;
    Tn[4 * i + 3] = -s * c[i];
    Tn_inv[5 * i] = inv_s;
    Tn_inv[4 * i + 3] = -inv_s * (-s * c[i]);
  }
  Tn[15] = Tn_inv[15] = 1.0f;
  mat4(Tn_inv, E, M);
  mat4(M, Tn, P);
}

__global__ void gn_step_kernel(Step p) {
  // every input first: the outputs overwrite some of them
  float H[36], g[6], T[16], Tb[16], dp_old[6];
  for (int i = 0; i < 36; ++i) H[i] = p.H[i];
  for (int i = 0; i < 6; ++i) g[i] = p.g[i];
  for (int i = 0; i < 16; ++i) T[i] = p.T[i];
  for (int i = 0; i < 16; ++i) Tb[i] = p.T_best[i];
  for (int i = 0; i < 6; ++i) dp_old[i] = p.dp[i];
  const float f_new = *p.f, sigma = *p.sigma, dscale = *p.dscale;
  const float s = *p.s, c[3] = {p.c[0], p.c[1], p.c[2]};
  const float f_best = *p.f_best, f_prev = *p.f_norm;
  const float dpn_prev = *p.dp_norm, g_tol_prev = *p.g_tol;
  const int it = *p.num_iters;

  // g_norm = max |g|; dp_norm = |dp| of the state's last step, its squares
  // summed in index order
  float gn = fabsf(g[0]);
  for (int i = 1; i < 6; ++i) gn = max_nan(gn, fabsf(g[i]));
  float d2 = 0.0f;
  for (int i = 0; i < 6; ++i)
    d2 = __fadd_rn(d2, __fmul_rn(dp_old[i], dp_old[i]));
  const float dpn = __fsqrt_rn(d2);

  // convergence against the previous iteration (gradient alone at first)
  float g_tol;
  bool conv;
  int status;
  if (p.first) {
    g_tol = __fmul_rn(p.gradient_tol, clamp_min(gn, kSqrtEps));
    conv = gn < g_tol;
    status = conv ? kGradientTol : kMaxIterations;
  } else {
    g_tol = g_tol_prev;
    const float pt = p.parameter_tol, ft = p.function_tol;
    const bool p_tol =
        dpn < pt || dpn < __fmul_rn(pt, __fadd_rn(kSqrtEps, dpn_prev));
    const float df = fabsf(__fsub_rn(f_new, f_prev));
    const bool f_tol =
        f_new < ft || f_new < __fmul_rn(ft, __fadd_rn(kSqrtEps, f_prev)) ||
        df < ft || df < __fmul_rn(ft, clamp_min(f_prev, 1.0f));
    const bool g_ok = gn < g_tol;
    conv = p_tol || f_tol || g_ok;
    status = p_tol ? kParameterTol
                   : (f_tol ? kFunctionTol
                            : (g_ok ? kGradientTol : kMaxIterations));
  }

  // Cholesky of H + (1e-6 max(diag H) + 1e-12) I (its lower triangle)
  float maxdiag = H[0];
  for (int i = 1; i < 6; ++i) maxdiag = max_nan(maxdiag, H[7 * i]);
  const float jit = __fadd_rn(__fmul_rn(1e-6f, maxdiag), 1e-12f);
  float L[6][6];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j <= i; ++j) {
      float acc =
          __fadd_rn(H[6 * i + j], __fmul_rn(jit, i == j ? 1.0f : 0.0f));
      for (int k = 0; k < j; ++k)
        acc = __fsub_rn(acc, __fmul_rn(L[i][k], L[j][k]));
      L[i][j] = i == j ? __fsqrt_rn(clamp_min(acc, 1e-20f))
                       : __fdiv_rn(acc, L[j][j]);
    }
  float y[6], x[6];
  for (int i = 0; i < 6; ++i) {
    float acc = g[i];
    for (int k = 0; k < i; ++k) acc = __fsub_rn(acc, __fmul_rn(L[i][k], y[k]));
    y[i] = __fdiv_rn(acc, L[i][i]);
  }
  for (int i = 5; i >= 0; --i) {
    float acc = y[i];
    for (int k = i + 1; k < 6; ++k)
      acc = __fsub_rn(acc, __fmul_rn(L[k][i], x[k]));
    x[i] = __fdiv_rn(acc, L[i][i]);
  }
  bool finite = true;
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(x[i]);
  if (!finite)
    for (int i = 0; i < 6; ++i) x[i] = 0.0f;
  // |H dp - g|_inf <= 1e-3 (1 + |g|_inf); a NaN fails it
  float resid = 0.0f;
  for (int i = 0; i < 6; ++i) {
    float acc = 0.0f;
    for (int j = 0; j < 6; ++j) acc = fmaf(H[6 * i + j], x[j], acc);
    const float r = fabsf(__fsub_rn(acc, g[i]));
    resid = i == 0 ? r : max_nan(resid, r);
  }
  const bool ok = finite && resid <= __fmul_rn(1e-3f, __fadd_rn(1.0f, gn));

  const bool do_update = !conv && ok;
  const bool better = f_new < f_best;
  float T_new[16];
  for (int i = 0; i < 16; ++i) T_new[i] = T[i];
  if (do_update) {
    float nd[6], P[16];
    for (int i = 0; i < 6; ++i) nd[i] = -x[i];
    params_to_pose(nd, s, c, P);
    mat4(T, P, T_new);
  }
  const int n = it + 1;
  const int out_status = ok ? status : kSolverError;

  for (int i = 0; i < 16; ++i) {
    p.T_best[i] = better ? T[i] : Tb[i];
    p.T[i] = T_new[i];
  }
  *p.f_best = better ? f_new : f_best;
  for (int i = 0; i < 6; ++i) p.dp[i] = do_update ? x[i] : dp_old[i];
  *p.f_norm = f_new;
  *p.dp_norm = dpn;
  *p.g_tol = g_tol;
  *p.scale = sigma;
  *p.delta_scale = dscale;
  for (int i = 0; i < 36; ++i) p.H_out[i] = H[i];
  for (int i = 0; i < 6; ++i) p.g_out[i] = g[i];
  *p.status = out_status;
  *p.conv = conv;
  *p.ok = ok;
  *p.num_iters = n;
  *p.pred = !conv && ok && n < p.max_iterations;
  // sigma_unstable: dscale > max(rel sigma, abs), NaN as torch.clamp
  *p.flag = dscale > clamp_min(__fmul_rn(p.scale_tol_rel, sigma), p.scale_tol);
  p.aux[0] = gn;
  for (int i = 0; i < 6; ++i) p.aux[1 + i] = x[i];
}

}  // namespace

extern "C" int bpvo_gn_step(
    const float* H, const float* g, const float* f, const float* sigma,
    const float* dscale, const float* s, const float* c, float* T,
    float* T_best, float* f_best, float* dp, float* f_norm, float* dp_norm,
    float* g_tol, float* scale, float* delta_scale, float* H_out,
    float* g_out, int32_t* status, uint8_t* conv, uint8_t* ok,
    int32_t* num_iters, uint8_t* pred, uint8_t* flag, float* aux, int first,
    int max_iterations, float function_tol, float parameter_tol,
    float gradient_tol, float scale_tol, float scale_tol_rel, void* stream) {
  const Step p{H,        g,       f,          sigma,  dscale,      s,
               c,        T,       T_best,     f_best, dp,          f_norm,
               dp_norm,  g_tol,   scale,      delta_scale, H_out,  g_out,
               status,   num_iters, conv,     ok,     pred,        flag,
               aux,      first,   max_iterations, function_tol, parameter_tol,
               gradient_tol, scale_tol, scale_tol_rel};
  gn_step_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
