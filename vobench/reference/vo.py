"""The benchmark's plain reference of the VO step (PyTorch and NumPy only;
it imports nothing of the program).  It works out again, from the rendered
frames alone, what the program derives from them: the descriptor pyramid
(intensity or Bit-Planes), the keyframe template (pixel selection, depths,
Jacobians), the coarse-to-fine IRLS Gauss-Newton estimate, the good-point
fraction and the keyframe decision.

The semantics are those of halismai/bpvo's vo.cc / vo_pose_estimator.cc /
template_data.cc as the configuration files state them:

- pyramid: cv::pyrDown (5-tap [1 4 6 4 1]/16, reflect-101 borders,
  ceil(n/2) samples); descriptors computed on each level's image;
- Bit-Planes: optional 3x3 Gaussian blur (sigmaPriorToCensusTransform),
  8 census comparison planes (neighbour >= centre, one-pixel border 0),
  each smoothed by a 5x5 Gaussian (sigmaBitPlanes);
- selection: saliency (sum over channels of |I(x+1)-I(x-1)| + |I(y+1)-
  I(y-1)|) at least minSaliency, a strict 3x3 local maximum where the level
  has minNumPixelsForNonMaximaSuppression pixels or more, disparity in
  [minValidDisparity, maxValidDisparity], a border of max(radius, 3)
  pixels, the pointCapacity >> 2l most salient (at least pointCapacityMin);
- points Z = fx b / d, Hartley-normalized; Jacobians at the identity from
  CD3 or CD5 gradients (bpvo's CD5 divides by 18);
- per level IRLS GN: bilinear sampling, sigma = 1.4826 (1 + 5/(n-6))
  median |r| of channel 0 re-estimated until it settles, Tukey or Huber
  weights (Huber on the coarse levels), the tolerances of
  pose_estimator_params.cc (relaxed x coarseToleranceScale on the coarse
  levels), the best evaluated pose when a level ends unconverged;
- keyframe when |t| > minTranslationMagToKeyFrame, |euler| (degrees) >
  minRotationMagToKeyFrame or the good-point fraction <
  maxFractionOfGoodPointsToKeyFrame; the candidate (last non-keyframe)
  becomes the keyframe and the pose is re-estimated against it from
  keyframeReestimateStartLevel, warm-started by the measured motion behind
  the coarse-cost gate.

``dtype`` is the precision everything is computed in: float32 for the
reference, bfloat16 for the control (images, descriptors, points,
Jacobians, projections, residuals, weights, the normal equations' sums,
the matcher's costs).  The 6x6 solve and the pose updates run on the host
in float64 and, for a dtype below float32, are rounded to it after each
operation (``quantize``).  In float32 no matrix product or convolution
runs on the device, so TF32 never applies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from vobench.reference import sgm as ref_sgm

SQRT_EPS = 3.452669831e-4
TUKEY_T = 4.685
HUBER_K = 1.345
KF_NONE, KF_TRANSLATION, KF_ROTATION, KF_FRAC = 0, 1, 2, 3
# fewer valid points than this leave a level's pose untouched
MIN_POINTS_VISUAL_ODOMETRY = 8
CENSUS_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1),
                  (1, 0), (1, 1))


@dataclasses.dataclass(frozen=True)
class Params:
    """The configuration fields the reference reads (the program's
    ``AlgorithmParameters`` names)."""
    descriptor: str
    sigmaPriorToCensusTransform: float
    sigmaBitPlanes: float
    numPyramidLevels: int
    maxIterations: int
    parameterTolerance: float
    functionTolerance: float
    gradientTolerance: float
    relaxTolerancesForCoarseLevels: bool
    coarseMaxIterations: int
    coarseToleranceScale: float
    lossFunction: str
    gradientEstimation: str
    minTranslationMagToKeyFrame: float
    minRotationMagToKeyFrame: float
    maxFractionOfGoodPointsToKeyFrame: float
    goodPointThreshold: float
    rotationKeyframeInDegrees: bool
    minNumPixelsForNonMaximaSuppression: int
    nonMaxSuppRadius: int
    minNumPixelsToWork: int
    minSaliency: float
    minValidDisparity: float
    maxValidDisparity: float
    maxTestLevel: int
    withNormalization: bool
    pointCapacity: int
    pointCapacityMin: int
    keyframeReestimateStartLevel: int

    @classmethod
    def from_config(cls, params: Dict) -> "Params":
        """From a configuration file's ``params``; raises on a setting the
        reference does not implement."""
        want = {"interp": "LINEAR", "warpType": "RigidBody",
                "poseEstimator": "GaussNewton", "withMotionModel": False,
                "coarseInitOffsetPx": 0.0}
        for k, v in want.items():
            if params.get(k, v) != v:
                raise NotImplementedError(f"reference: {k}={params[k]!r}")
        if params["descriptor"] not in ("INTENSITY", "BITPLANES"):
            raise NotImplementedError(f"reference: {params['descriptor']}")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in params.items() if k in names})


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float

    def at_level(self, level: int) -> "Camera":
        s = 1.0 / (1 << level)
        return Camera(self.fx * s, self.fy * s, self.cx * s, self.cy * s,
                      self.baseline * (1 << level))


class LevelOptions(NamedTuple):
    max_iterations: int
    function_tolerance: float
    parameter_tolerance: float
    gradient_tolerance: float
    loss: str
    scale_tolerance_rel: float


def level_options(p: Params, level: int) -> LevelOptions:
    if level == p.maxTestLevel or not p.relaxTolerancesForCoarseLevels:
        return LevelOptions(p.maxIterations, p.functionTolerance,
                            p.parameterTolerance, p.gradientTolerance,
                            p.lossFunction, 0.01)
    s = p.coarseToleranceScale
    loss = "L2" if p.lossFunction == "L2" else "HUBER"
    return LevelOptions(min(p.maxIterations, p.coarseMaxIterations),
                        p.functionTolerance * s, p.parameterTolerance * s,
                        p.gradientTolerance * s, loss, 0.05)


# --------------------------------------------------------------------------
# images
# --------------------------------------------------------------------------

def quantize(x, dtype) -> np.ndarray:
    """``x`` as float64 after rounding to ``dtype`` (a no-op at float32 and
    above: the host's float64 arithmetic stands for float32's)."""
    x = np.asarray(x, np.float64)
    if dtype in (torch.float32, torch.float64):
        return x
    return torch.as_tensor(x).to(dtype).to(torch.float64).numpy()


def _reflect101(n: int, lo: int, hi: int, device):
    """Indices lo..hi-1 folded into [0, n) by cv2 BORDER_REFLECT_101."""
    i = torch.arange(lo, hi, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def gaussian_taps(ksize: int, sigma: float) -> List[float]:
    """cv2.getGaussianKernel(ksize, sigma) as float32 values."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return [float(v) for v in (k / k.sum()).astype(np.float32)]


def separable(I, taps: List[float]):
    """Correlation of (..., H, W) with ``taps`` along rows and columns,
    reflect-101 borders, by gathered shifts (no convolution routine)."""
    r = len(taps) // 2
    H, W = I.shape[-2:]
    iy = _reflect101(H, -r, H + r, I.device)
    ix = _reflect101(W, -r, W + r, I.device)
    P = I.index_select(-2, iy)
    rows = sum(P[..., j:j + H, :] * taps[j] for j in range(len(taps)))
    P = rows.index_select(-1, ix)
    return sum(P[..., :, j:j + W] * taps[j] for j in range(len(taps)))


_PYR_TAPS = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def pyr_down(I):
    """cv::pyrDown: the 5-tap filter at every second sample, reflect-101."""
    H, W = I.shape[-2:]
    h, w = -(-H // 2), -(-W // 2)
    out = 0
    for j, k in enumerate(_PYR_TAPS):
        out = out + I.index_select(-2, _reflect101(
            H, j - 2, j - 2 + 2 * h, I.device)[::2]) * k
    res = 0
    for j, k in enumerate(_PYR_TAPS):
        res = res + out.index_select(-1, _reflect101(
            W, j - 2, j - 2 + 2 * w, I.device)[::2]) * k
    return res


def census_planes(I):
    """(H, W) -> (8, H, W) {0, 1}: neighbour >= centre, border 0."""
    H, W = I.shape
    out = torch.zeros((8, H, W), dtype=I.dtype, device=I.device)
    c = I[1:-1, 1:-1]
    for b, (dy, dx) in enumerate(CENSUS_OFFSETS):
        out[b, 1:-1, 1:-1] = (I[1 + dy:H - 1 + dy, 1 + dx:W - 1 + dx]
                              >= c).to(I.dtype)
    return out


def descriptor(I, p: Params):
    if p.descriptor == "INTENSITY":
        return I[None]
    if p.sigmaPriorToCensusTransform > 0:
        I = separable(I, gaussian_taps(3, p.sigmaPriorToCensusTransform))
    planes = census_planes(I)
    if p.sigmaBitPlanes > 0:
        planes = separable(planes, gaussian_taps(5, p.sigmaBitPlanes))
    return planes


def channel_pyramid(image, p: Params, dtype) -> List[torch.Tensor]:
    """The frame's descriptor channels (C, H, W) at every level."""
    img = image.to(dtype)
    out = []
    for level in range(p.numPyramidLevels):
        out.append(descriptor(img, p))
        if level + 1 < p.numPyramidLevels:
            img = pyr_down(img)
    return out


def saliency(ch):
    C, H, W = ch.shape
    s = torch.zeros((H, W), dtype=ch.dtype, device=ch.device)
    s[1:-1, 1:-1] = torch.sum(
        torch.abs(ch[:, 1:-1, 2:] - ch[:, 1:-1, :-2])
        + torch.abs(ch[:, 2:, 1:-1] - ch[:, :-2, 1:-1]), dim=0)
    return s


def local_max(S):
    """Strict 3x3 local maximum; out-of-image neighbours never win."""
    H, W = S.shape
    P = torch.full((H + 2, W + 2), -math.inf, dtype=S.dtype, device=S.device)
    P[1:-1, 1:-1] = S
    ok = torch.ones_like(S, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                ok &= S > P[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
    return ok


# --------------------------------------------------------------------------
# template
# --------------------------------------------------------------------------

class Template(NamedTuple):
    points: torch.Tensor     # (N, 3) float32, valid points only
    pixels: torch.Tensor     # (C, N)
    J: torch.Tensor          # (C, N, 6)
    rows: torch.Tensor       # (N,) int64
    cols: torch.Tensor
    s: float                 # Hartley scale
    c: np.ndarray            # (3,) Hartley centre, float64

    @property
    def n(self) -> int:
        return int(self.points.shape[0])


def capacity(p: Params, rows: int, cols: int, level: int) -> int:
    return int(min(max(p.pointCapacity >> (2 * level), p.pointCapacityMin),
                   rows * cols))


def build_template(ch, disparity, cam: Camera, p: Params,
                   level: int) -> Template:
    """Select, back-project and linearize one level's keyframe points;
    ``disparity`` is the full-resolution map (float32)."""
    C, H, W = ch.shape
    s_ = 1 << level
    d = disparity[::s_, ::s_][:H, :W].to(torch.float32)
    S = saliency(ch)
    ok = S >= p.minSaliency
    if H * W >= p.minNumPixelsForNonMaximaSuppression \
            and p.nonMaxSuppRadius > 0:
        if p.nonMaxSuppRadius != 1:
            raise NotImplementedError("reference: nonMaxSuppRadius != 1")
        ok &= local_max(S)
    ok &= (d >= p.minValidDisparity) & (d <= p.maxValidDisparity)
    b = max(p.nonMaxSuppRadius, 3)
    border = torch.zeros_like(ok)
    border[b:H - b - 1, b:W - b - 1] = True
    ok &= border
    score = torch.where(ok, S.to(torch.float32), -math.inf).reshape(-1)
    vals, idx = torch.topk(score, capacity(p, H, W, level))
    idx = torch.sort(idx[vals > -math.inf]).values
    rows, cols = idx // W, idx % W
    dt = ch.dtype
    dsel = d.reshape(-1)[idx].to(dt)
    Z = (cam.fx * cam.baseline) / dsel
    X = (cols.to(dt) - cam.cx) * Z / cam.fx
    Y = (rows.to(dt) - cam.cy) * Z / cam.fy
    pts = torch.stack([X, Y, Z], -1)
    if p.withNormalization and pts.shape[0] > 0:
        c = pts.mean(0)
        m = torch.sqrt(torch.sum((pts - c) ** 2, dim=-1)).mean()
        s = float(quantize(math.sqrt(3.0) / max(float(m), 1e-6), dt))
        c = c.double().cpu().numpy()
    else:
        s, c = 1.0, np.zeros(3)
    flat = ch.reshape(C, H * W)

    def at(dy, dx):
        y = torch.clamp(rows + dy, 0, H - 1)
        x = torch.clamp(cols + dx, 0, W - 1)
        return flat[:, y * W + x]

    if p.gradientEstimation == "CD3":
        gx = 0.5 * (at(0, 1) - at(0, -1))
        gy = 0.5 * (at(1, 0) - at(-1, 0))
    elif p.gradientEstimation == "CD5":
        gx = (at(0, -2) - 8.0 * at(0, -1) + 8.0 * at(0, 1) - at(0, 2)) / 18.0
        gy = (at(-2, 0) - 8.0 * at(-1, 0) + 8.0 * at(1, 0) - at(2, 0)) / 18.0
    else:
        raise NotImplementedError(p.gradientEstimation)
    X, Y, Z = pts[:, 0], pts[:, 1], pts[:, 2]
    zi = 1.0 / Z
    a, bb = gx * cam.fx, gy * cam.fy
    q = (a * X + bb * Y) * zi * zi
    cx, cy, cz = (float(v) for v in c)
    Xc, Yc, Zc = X - cx, Y - cy, Z - cz
    J = torch.stack([-q * Yc - bb * Zc * zi, q * Xc + a * Zc * zi,
                     (bb * Xc - a * Yc) * zi, a * zi / s, bb * zi / s,
                     -q / s], -1)
    return Template(points=pts, pixels=at(0, 0), J=J, rows=rows, cols=cols,
                    s=s, c=c)


def build_templates(chans, disparity, cams, p: Params) -> List[Template]:
    return [build_template(ch, disparity, cams[l], p, l)
            for l, ch in enumerate(chans)]


# --------------------------------------------------------------------------
# the level solve
# --------------------------------------------------------------------------

def exp_np(xi) -> np.ndarray:
    w, v = np.asarray(xi[:3], np.float64), np.asarray(xi[3:], np.float64)
    th2 = float(w @ w)
    th = math.sqrt(th2)
    if th2 < 1e-10:
        A, B, C = 1 - th2 / 6, 0.5 - th2 / 24, 1 / 6 - th2 / 120
    else:
        A = math.sin(th) / th
        B = (1 - math.cos(th)) / th2
        C = (th - math.sin(th)) / (th2 * th)
    Wm = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + A * Wm + B * Wm @ Wm
    T[:3, 3] = (np.eye(3) + B * Wm + C * Wm @ Wm) @ v
    return T


def params_to_pose(dp, s: float, c: np.ndarray) -> np.ndarray:
    """Tn^-1 exp(dp) Tn, Tn = [s I | -s c]."""
    Tn = np.eye(4) * s
    Tn[3, 3] = 1.0
    Tn[:3, 3] = -s * c
    Tn_inv = np.eye(4) / s
    Tn_inv[3, 3] = 1.0
    Tn_inv[:3, 3] = c
    return Tn_inv @ exp_np(dp) @ Tn


def residuals(tm: Template, ch, cam: Camera, T: np.ndarray):
    """r (C, N) = I1(warp(x)) - I0(x) with out-of-view points zeroed, and
    the in-view mask."""
    C, H, W = ch.shape
    Tt = torch.as_tensor(T, dtype=tm.points.dtype, device=ch.device)
    Xw = tm.points @ Tt[:3, :3].T + Tt[:3, 3]
    Z = Xw[:, 2]
    u = cam.fx * Xw[:, 0] / Z + cam.cx
    v = cam.fy * Xw[:, 1] / Z + cam.cy
    xi, yi = torch.floor(u), torch.floor(v)
    ok = (Z > 1e-6) & (xi >= 0) & (xi < W - 1) & (yi >= 0) & (yi < H - 1)
    xs = torch.where(ok, xi, 0.0).long()
    ys = torch.where(ok, yi, 0.0).long()
    xf, yf = u - xs, v - ys
    flat = ch.reshape(C, H * W)
    base = ys * W + xs
    i00, i01 = flat[:, base], flat[:, base + 1]
    i10, i11 = flat[:, base + W], flat[:, base + W + 1]
    I1 = ((1 - yf) * ((1 - xf) * i00 + xf * i01)
          + yf * ((1 - xf) * i10 + xf * i11))
    return (I1 - tm.pixels) * ok.to(ch.dtype), ok


def robust_scale(r0, ok) -> float:
    """1.4826 (1 + 5 / max(n - 6, 1)) median |r| over ``ok`` (the lower
    median), 1 when that is below 1e-6."""
    a = torch.abs(r0[ok]).to(torch.float32)
    n = int(a.numel())
    if n == 0:
        return 1.0
    med = float(torch.kthvalue(a, (n + 1) // 2).values)
    s = 1.4826 * (1.0 + 5.0 / max(n - 6.0, 1.0)) * med
    return 1.0 if s < 1e-6 else s


def weights(loss: str, r, ok, sigma: float):
    u = r / sigma
    if loss == "TUKEY":
        t = 1.0 - (u / TUKEY_T) ** 2
        w = torch.where(torch.abs(u) < TUKEY_T, t * t, 0.0)
    elif loss == "HUBER":
        au = torch.abs(u)
        w = torch.where(au < HUBER_K, 1.0, HUBER_K / torch.clamp(au,
                                                                 min=1e-20))
    elif loss == "L2":
        w = torch.ones_like(u)
    else:
        raise NotImplementedError(loss)
    return (w * ok.to(r.dtype)).to(r.dtype)


def normal_equations(J, r, w):
    """H, g, sum w r^2 as float64 host arrays (sums of products, no
    matrix product on the device)."""
    Jw = J * w[..., None]
    H = torch.sum(Jw[..., :, None] * J[..., None, :], dim=(0, 1))
    g = torch.sum(Jw * r[..., None], dim=(0, 1))
    f2 = torch.sum(w * r * r)
    packed = torch.cat([H.reshape(-1), g, f2.reshape(1)]).double().cpu()
    packed = packed.numpy()
    return packed[:36].reshape(6, 6), packed[36:42], float(packed[42])


def solve6(H, g):
    A = H + (1e-6 * np.max(np.diag(H)) + 1e-12) * np.eye(6)
    try:
        L = np.linalg.cholesky(A)
        dp = np.linalg.solve(L.T, np.linalg.solve(L, g))
    except np.linalg.LinAlgError:
        return np.zeros(6), False
    if not np.all(np.isfinite(dp)):
        return np.zeros(6), False
    ok = np.max(np.abs(H @ dp - g)) <= 1e-3 * (1.0 + np.max(np.abs(g)))
    return dp, bool(ok)


class LevelResult(NamedTuple):
    T: np.ndarray
    iters: int
    w: torch.Tensor


def solve_level(tm: Template, ch, cam: Camera, T0: np.ndarray,
                o: LevelOptions) -> LevelResult:
    T = np.asarray(T0, np.float64)
    T_best, f_best = T, math.inf
    sigma, dscale = 1.0, 1e10
    f_prev = dpn_last = dpn_prev2 = g_tol = 0.0
    w = torch.zeros_like(tm.pixels)
    it, conv, sok = 0, False, True
    while not conv and sok and it < o.max_iterations:
        r, ok = residuals(tm, ch, cam, T)
        if dscale > max(o.scale_tolerance_rel * sigma, 1e-6):
            est = robust_scale(r[0], ok)
            dscale, sigma = abs(est - sigma), est
        w = weights(o.loss, r, ok[None, :], sigma)
        H, g, f2 = normal_equations(tm.J, r, w)
        f_new = math.sqrt(max(f2, 0.0))
        gn = float(np.max(np.abs(g)))
        if it == 0:
            g_tol = o.gradient_tolerance * max(gn, SQRT_EPS)
            conv_new = gn < g_tol
        else:
            pt, ft = o.parameter_tolerance, o.function_tolerance
            p_ok = dpn_last < pt or dpn_last < pt * (SQRT_EPS + dpn_prev2)
            df = abs(f_new - f_prev)
            f_ok = (f_new < ft or f_new < ft * (SQRT_EPS + f_prev)
                    or df < ft or df < ft * max(f_prev, 1.0))
            conv_new = p_ok or f_ok or gn < g_tol
        dp, ok_solve = solve6(H, g)
        dp = quantize(dp, w.dtype)
        if f_new < f_best:
            T_best, f_best = T, f_new
        dpn_prev2 = dpn_last
        if not conv_new and ok_solve:
            T = quantize(T @ quantize(params_to_pose(-dp, tm.s, tm.c),
                                      w.dtype), w.dtype)
            dpn_last = float(np.linalg.norm(dp))
        f_prev, conv, sok = f_new, conv_new, ok_solve
        it += 1
    if not conv and f_best < f_prev:
        T = T_best
    return LevelResult(T=T, iters=it, w=w)


def coarse_cost(tm: Template, ch, cam: Camera, T) -> float:
    r, ok = residuals(tm, ch, cam, T)
    n = max(int(ok.sum()), 1)
    return float(torch.sum(r * r)) / n


def gated(tms, chans, cams, T_warm, T_cold, level: int) -> np.ndarray:
    """The warm start where its photometric cost at ``level`` is not above
    the cold start's."""
    cw = coarse_cost(tms[level], chans[level], cams[level], T_warm)
    cc = coarse_cost(tms[level], chans[level], cams[level], T_cold)
    return np.asarray(T_warm if cw <= cc else T_cold, np.float64)


class Estimate(NamedTuple):
    T: np.ndarray
    frac: float
    iters: List[int]


def estimate(tms, chans, cams, T_init, p: Params, min_points: int,
             start_level: int = -1) -> Estimate:
    L = p.numPyramidLevels
    start = L - 1 if start_level < 0 else start_level
    T = np.asarray(T_init, np.float64)
    iters = [0] * L
    res = None
    for level in range(start, p.maxTestLevel - 1, -1):
        res = solve_level(tms[level], chans[level], cams[level], T,
                          level_options(p, level))
        if tms[level].n >= min_points:
            T, iters[level] = res.T, res.iters
    tm = tms[p.maxTestLevel]
    C = res.w.shape[0]
    n_good = int(torch.sum(res.w.to(torch.float32) > p.goodPointThreshold))
    return Estimate(T=T, frac=n_good / max(C * tm.n, 1), iters=iters)


def keyframe_quantities(T, frac: float, p: Params):
    """(|t|, |euler| in the configured unit, frac)."""
    T = np.asarray(T, np.float64)
    R = T[:3, :3]
    sy = math.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    e = np.array([math.atan2(R[2, 1], R[2, 2]),
                  math.atan2(-R[2, 0], max(sy, 1e-12)),
                  math.atan2(R[1, 0], R[0, 0])])
    if p.rotationKeyframeInDegrees:
        e = np.degrees(e)
    return (float(np.linalg.norm(T[:3, 3])), float(np.linalg.norm(e)),
            float(frac))


def keyframe_reason(T, frac: float, p: Params) -> int:
    t, r, f = keyframe_quantities(T, frac, p)
    if t > p.minTranslationMagToKeyFrame:
        return KF_TRANSLATION
    if r > p.minRotationMagToKeyFrame:
        return KF_ROTATION
    if f < p.maxFractionOfGoodPointsToKeyFrame:
        return KF_FRAC
    return KF_NONE


def decision_is_clear(T, frac: float, p: Params, bands) -> bool:
    """Whether the reference's keyframe decision stands farther from every
    threshold that could flip it than ``bands`` (|t| in m, |euler| in the
    configured unit, the fraction): the keyframe decisions compared."""
    t, r, f = keyframe_quantities(T, frac, p)
    gaps = (t - p.minTranslationMagToKeyFrame,
            r - p.minRotationMagToKeyFrame,
            p.maxFractionOfGoodPointsToKeyFrame - f)
    fired = [g > 0 for g in gaps]
    if any(fired):
        first = fired.index(True)
        # the first criterion that fires decides; none before it may be
        # near its threshold either
        return all(abs(gaps[i]) > bands[i] for i in range(first + 1))
    return all(abs(g) > b for g, b in zip(gaps, bands))


# --------------------------------------------------------------------------
# the step, followed from the program's state, and a whole sequence
# --------------------------------------------------------------------------

class StepResult(NamedTuple):
    pose: np.ndarray        # motion wrt the previous frame under the
                            # program's keyframe decision
    T_est: np.ndarray       # keyframe -> frame, the front estimate
    frac: float
    reason: int
    clear: bool             # the decision is outside the tie bands


class Frames:
    """Access to the rendered frames by index: ``image(i)`` (H, W) and
    ``aux(i)`` (the disparity, or the right image with a matcher)."""

    def __init__(self, images, auxs):
        self.images, self.auxs = images, auxs

    def image(self, i):
        return self.images[i]

    def aux(self, i):
        return self.auxs[i]


class Reference:
    """The reference VO over one camera's frames: per-frame pyramids and
    per-keyframe templates cached by frame index."""

    def __init__(self, p: Params, camera: Camera, frames: Frames,
                 matcher: Optional[Dict] = None, min_points: int = None,
                 dtype=torch.float32, cache_frames: int = 8):
        self.p = p
        self.cams = [camera.at_level(l) for l in range(p.numPyramidLevels)]
        self.frames = frames
        self.matcher = matcher
        self.min_points = (p.minNumPixelsToWork if min_points is None
                           else min_points)
        self.dtype = dtype
        self._chans: Dict[int, List[torch.Tensor]] = {}
        self._tms: Dict[int, List[Template]] = {}
        self._disp: Dict[int, torch.Tensor] = {}
        self._cache_frames = cache_frames

    def _remember(self, d, key, value):
        if len(d) >= self._cache_frames:
            d.pop(next(iter(d)))
        d[key] = value
        return value

    def disparity(self, i):
        """The frame's disparity: the given map, or the reference
        matcher's on its stereo pair."""
        if self.matcher is None:
            return self.frames.aux(i)
        if i not in self._disp:
            m = self.matcher
            self._remember(self._disp, i, ref_sgm.sgm(
                self.frames.image(i), self.frames.aux(i),
                m["num_disparities"], m["p1"], m["p2"], self.dtype))
        return self._disp[i]

    def channels(self, i):
        if i not in self._chans:
            self._remember(self._chans, i, channel_pyramid(
                self.frames.image(i), self.p, self.dtype))
        return self._chans[i]

    def templates(self, i):
        if i not in self._tms:
            self._remember(self._tms, i, build_templates(
                self.channels(i), self.disparity(i), self.cams, self.p))
        return self._tms[i]

    def _start2(self):
        p = self.p
        return min(max(p.keyframeReestimateStartLevel, p.maxTestLevel),
                   p.numPyramidLevels - 1)

    def front(self, frame: int, kf_src: int, T_kf) -> Estimate:
        """The frame's estimate against the keyframe ``kf_src`` from
        ``T_kf`` (keyframe -> last frame)."""
        return estimate(self.templates(kf_src), self.channels(frame),
                        self.cams, T_kf, self.p, self.min_points)

    def step(self, frame: int, kf_src: int, T_kf, has_prev: bool,
             prev: Optional[int], is_kf: bool, bands,
             est: Optional[Estimate] = None) -> StepResult:
        """One step from the program's state: the keyframe ``kf_src``,
        ``T_kf`` (keyframe -> last frame), whether the last frame
        ``prev`` is a candidate, and the program's keyframe decision
        ``is_kf`` for this frame, which sets what the step's pose is."""
        p = self.p
        if p.keyframeReestimateStartLevel < 0:
            raise NotImplementedError("reference: keyframeReestimate"
                                      "StartLevel < 0")
        est = est or self.front(frame, kf_src, T_kf)
        reason = keyframe_reason(est.T, est.frac, p)
        clear = decision_is_clear(est.T, est.frac, p, bands)
        pose_kf = quantize(est.T @ np.linalg.inv(np.asarray(T_kf, np.float64)),
                           self.dtype)
        pose = pose_kf
        if is_kf and has_prev:
            tms, chans = self.templates(prev), self.channels(frame)
            start2 = self._start2()
            T2 = estimate(tms, chans, self.cams,
                          gated(tms, chans, self.cams, pose_kf, np.eye(4),
                                start2), p, self.min_points, start2)
            pose = T2.T
        return StepResult(pose=pose, T_est=est.T, frac=est.frac,
                          reason=reason, clear=clear)


def advance(kf_src, T_kf, has_prev, prev, frame, pose, is_kf):
    """The VO state after a step with output ``pose`` and decision
    ``is_kf`` (vo.cc:125-197): (keyframe, keyframe -> frame, candidate
    exists, last frame)."""
    pose = np.asarray(pose, np.float64)
    if not is_kf:
        return kf_src, pose @ np.asarray(T_kf, np.float64), True, frame
    if has_prev:
        return prev, pose, False, frame
    return frame, np.eye(4), False, frame
