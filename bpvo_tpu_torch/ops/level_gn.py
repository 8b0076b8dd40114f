"""One pyramid level's whole IRLS Gauss-Newton solve: the hand-written CUDA
kernel ``csrc/level_gn.cu`` (one launch of a thread-block cluster of
``n_ctas(K)`` CTAs), its wrapper and its plain PyTorch version.

Counterpart of ``bpvo_tpu/ops/pallas/level_gn_kernel.py`` (``make_level_gn``,
body ``_kernel``), with the non-banded semantics: every point samples the
image directly, so ``band_overflow`` is always 0 (kept in the contract).

``level_gn`` takes the plain version for CPU tensors only.  For CUDA tensors
it launches the kernel or raises (a cluster the card cannot place raises
too); it never falls back.
"""
from __future__ import annotations

import ctypes
import math

import torch

from bpvo_tpu_torch.solver import linear_system, mestimator
from bpvo_tpu_torch.types import InterpolationType, LossFunctionType
from bpvo_tpu_torch.vo import warp as warp_mod

_SQRT_EPS = 3.452669831e-4

STATUS_MAX_ITERATIONS = 0
STATUS_PARAMETER_TOL = 1
STATUS_FUNCTION_TOL = 2
STATUS_GRADIENT_TOL = 3
STATUS_SOLVER_ERROR = 4

# the kernels' loss codes (enum Loss in csrc/level_gn.cu, csrc/gn_reduce.cuh)
LOSS_CODES = {LossFunctionType.TUKEY: 0, LossFunctionType.HUBER: 1,
               LossFunctionType.L2: 2}
_INTERP = (InterpolationType.LINEAR, InterpolationType.COSINE)

# the kernel's median search: the 16 bisection steps as MEDIAN_ROUNDS rounds
# of MEDIAN_DEPTHS steps, one cluster reduction per round
MEDIAN_DEPTHS = 4
MEDIAN_ROUNDS = mestimator.BISECTION_STEPS // MEDIAN_DEPTHS

# kernel launches made by ``level_gn`` in this process (the plain version is
# not counted)
launch_count = 0


def check_supported(opts) -> None:
    """Raise NotImplementedError for the option subset neither the kernel
    nor its plain version implements."""
    if opts.warp != "RigidBody":
        raise NotImplementedError(f"level_gn: the {opts.warp} warp is not "
                                  f"ported yet")
    if opts.interp not in _INTERP:
        raise NotImplementedError(f"level_gn: {opts.interp.value} "
                                  f"interpolation is not ported yet")
    if opts.loss not in LOSS_CODES:
        raise NotImplementedError(f"level_gn: loss {opts.loss}")
    if opts.verbose:
        raise NotImplementedError("level_gn: the verbose iteration table is "
                                  "not ported yet")


def median_rounds(a, valid):
    """Median of ``a`` (non-negative) over ``valid`` by count bisection, as
    the kernel runs it: MEDIAN_ROUNDS rounds, each of which counts the valid
    ``a`` at or below all 15 midpoints of the next MEDIAN_DEPTHS bisection
    steps at once (integer counts, one reduction in the kernel) and then
    takes those steps' decisions.  A midpoint is the sequential bisection's
    own ``(lo + hi) * 0.5`` of its own endpoints, so (median, n, lo, hi)
    equal ``mestimator.median_bisect`` and ``bisect_interval`` bit for bit.
    Returns (median, n, lo, hi), n the valid count as float32."""
    n = torch.sum(valid.to(torch.float32))
    target = torch.floor((n + 1.0) * 0.5)
    hi = torch.max(torch.where(valid, a, 0.0))
    lo = torch.zeros_like(hi)
    for _ in range(MEDIAN_ROUNDS):
        # the round's tree in heap order: node i spans (l, h] and splits at
        # its midpoint m; its children span (l, m] and (m, h]
        spans, mids = [(lo, hi)], []
        for i in range(2 ** MEDIAN_DEPTHS - 1):
            l, h = spans[i]
            mids.append((l + h) * 0.5)
            spans += [(l, mids[i]), (mids[i], h)]
        counts = torch.sum(valid & (a <= torch.stack(mids)[:, None]), 1)
        node = torch.zeros((), dtype=torch.long, device=a.device)
        for _ in range(MEDIAN_DEPTHS):
            mid = (lo + hi) * 0.5                    # == mids[node]
            pred = counts[node] >= target
            lo, hi = torch.where(pred, lo, mid), torch.where(pred, mid, hi)
            node = 2 * node + torch.where(pred, 1, 2)
    return torch.where(n > 0, hi, 0.0), n, lo, hi


def estimate_scale(residuals, valid):
    """The kernel's robust sigma of ``residuals`` over ``valid``: the
    ``median_rounds`` median through ``mestimator.scale_from_median``."""
    med, n, _, _ = median_rounds(torch.abs(residuals.reshape(-1)),
                                 valid.reshape(-1))
    return mestimator.scale_from_median(med, n)


def _linearize(cam, points, valid, pixels, channels, T, cosine: bool):
    """Project, bounds-test and sample at pose T (level_gn_kernel.py
    :197-324, non-banded).  Returns (ok (K,), r (C,K))."""
    C, H, W = channels.shape
    X, Y, Z = points[:, 0], points[:, 1], points[:, 2]
    Xc = T[0, 0] * X + T[0, 1] * Y + T[0, 2] * Z + T[0, 3]
    Yc = T[1, 0] * X + T[1, 1] * Y + T[1, 2] * Z + T[1, 3]
    Zc = T[2, 0] * X + T[2, 1] * Y + T[2, 2] * Z + T[2, 3]
    zi = 1.0 / torch.where(torch.abs(Zc) > 1e-12, Zc, 1e-12)
    u = cam.fx * Xc * zi + cam.cx
    v = cam.fy * Yc * zi + cam.cy
    xi = torch.floor(u)
    yi = torch.floor(v)
    ok = (valid & (Zc > 1e-6) & (xi >= 0) & (xi < W - 1)
          & (yi >= 0) & (yi < H - 1))
    # sample every point at its clamped cell; out-of-bounds ones are zeroed
    xii = torch.where(ok, xi, 0.0).clamp(0, W - 2)
    yii = torch.where(ok, yi, 0.0).clamp(0, H - 2)
    xf = u - xii
    yf = v - yii
    if cosine:
        xf = (1.0 - torch.cos(xf * math.pi)) * 0.5
        yf = (1.0 - torch.cos(yf * math.pi)) * 0.5
    flat = channels.reshape(C, H * W)
    base = yii.long() * W + xii.long()
    i00, i01 = flat[:, base], flat[:, base + 1]
    i10, i11 = flat[:, base + W], flat[:, base + W + 1]
    I1 = ((1.0 - yf) * ((1.0 - xf) * i00 + xf * i01)
          + yf * ((1.0 - xf) * i10 + xf * i11))
    return ok, (I1 - pixels) * ok.to(torch.float32)


def level_gn_reference(cam, points, valid, pixels, jacobians, channels, T0,
                       sigma0, dscale0, s, c, opts):
    """Plain PyTorch version of the kernel: the same IRLS loop, one torch op
    at a time, with the loop control on the host.  Same contract as
    ``level_gn``."""
    check_supported(opts)
    C, K = pixels.shape
    dev = channels.device
    f32 = torch.float32

    def scalar(x):
        return torch.as_tensor(x, dtype=f32, device=dev)

    cosine = opts.interp == InterpolationType.COSINE
    T = T0.to(f32)
    T_best = T
    sigma, dscale = scalar(sigma0), scalar(dscale0)
    f_prev = dpn_last = dpn_prev2 = g_tol = g_norm = scalar(0.0)
    f_best = scalar(math.inf)
    H = torch.zeros(6, 6, dtype=f32, device=dev)
    g = torch.zeros(6, dtype=f32, device=dev)
    w = torch.zeros(C, K, dtype=f32, device=dev)
    it, conv, sok, status = 0, False, True, STATUS_MAX_ITERATIONS
    while not conv and sok and it < opts.max_iterations:
        first = it == 0
        ok, r = _linearize(cam, points, valid, pixels, channels, T, cosine)
        # sigma from channel 0, skipped once stable (:426-432)
        if bool(dscale > torch.clamp(opts.scale_tolerance_rel * sigma,
                                     min=opts.scale_tolerance)):
            est = estimate_scale(r[0], ok)
            dscale = torch.abs(est - sigma)
            sigma = est
        w = mestimator.compute_weights(opts.loss, r, ok[None, :], sigma)
        H, g, f_sq = linear_system.build(jacobians, r, w)
        f_new = torch.sqrt(torch.clamp(f_sq, min=0.0))
        gn_ = torch.max(torch.abs(g))
        if first:
            g_tol = opts.gradient_tolerance * torch.clamp(gn_, min=_SQRT_EPS)
        g_ok = bool(gn_ < g_tol)
        if first:
            conv_new = g_ok
            status = STATUS_GRADIENT_TOL if g_ok else STATUS_MAX_ITERATIONS
        else:
            # the parameter test reads the CARRIED |dp| (:448-449)
            ptol, ftol = opts.parameter_tolerance, opts.function_tolerance
            p_tol = bool((dpn_last < ptol)
                         | (dpn_last < ptol * (_SQRT_EPS + dpn_prev2)))
            df = torch.abs(f_new - f_prev)
            f_tol = bool((f_new < ftol) | (f_new < ftol * (_SQRT_EPS + f_prev))
                         | (df < ftol)
                         | (df < ftol * torch.clamp(f_prev, min=1.0)))
            conv_new = p_tol or f_tol or g_ok
            status = (STATUS_PARAMETER_TOL if p_tol else
                      STATUS_FUNCTION_TOL if f_tol else
                      STATUS_GRADIENT_TOL if g_ok else STATUS_MAX_ITERATIONS)
        dp, ok_solve = linear_system.solve(H, g)
        ok_solve = bool(ok_solve)
        if bool(f_new < f_best):          # best evaluated (entering) pose
            T_best, f_best = T, f_new
        dpn_prev2 = dpn_last
        if not conv_new and ok_solve:
            T = T @ warp_mod.params_to_pose(-dp, s, c)
            dpn_last = torch.linalg.norm(dp)
        if not ok_solve:
            status = STATUS_SOLVER_ERROR
        f_prev, g_norm, conv, sok = f_new, gn_, conv_new, ok_solve
        it += 1
    if not conv and bool(f_best < f_prev):
        T = T_best
    stats = torch.stack([scalar(it), f_prev, g_norm, scalar(status), sigma,
                         dscale, scalar(conv), scalar(sok)])
    return (T, stats, H, g, w,
            torch.zeros((), dtype=torch.int32, device=dev))


def _check_cuda_inputs(points, valid, pixels, jacobians, channels, T0, s, c):
    C, H, W = channels.shape
    K = points.shape[0]
    want = {"points": (points, (K, 3), torch.float32),
            "valid": (valid, (K,), torch.bool),
            "pixels": (pixels, (C, K), torch.float32),
            "jacobians": (jacobians, (C, K, 6), torch.float32),
            "channels": (channels, (C, H, W), torch.float32),
            "T0": (T0, (4, 4), torch.float32),
            "norm_scale": (s, (), torch.float32),
            "norm_center": (c, (3,), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if t.device != channels.device:
            raise ValueError(f"level_gn: {name} is on {t.device}, channels "
                             f"on {channels.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"level_gn: {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"level_gn: {name} must be contiguous")
    if H < 2 or W < 2 or K < 1 or C < 1 or C * max(K, H * W) >= 2 ** 31:
        raise ValueError(f"level_gn: unsupported shape C={C} H={H} W={W} "
                         f"K={K}")


def n_ctas(K: int) -> int:
    """CTAs of the cluster the kernel solves a level of K points on
    (``bpvo_level_gn_ctas``: one up to 512 points, else one per 256
    points, at most 16).  Builds the kernels' library: CUDA machines
    only."""
    from bpvo_tpu_torch.ops import _build
    return int(_build.library().bpvo_level_gn_ctas(K))


def level_gn(cam, points, valid, pixels, jacobians, channels, T0, sigma0,
             dscale0, s, c, opts):
    """Run one level's IRLS GN from pose T0.

    ``points`` (K,3), ``valid`` (K,) bool, ``pixels`` (C,K), ``jacobians``
    (C,K,6), ``channels`` (C,H,W), ``T0`` (4,4); ``sigma0``/``dscale0``
    Python numbers; ``s``/``c`` the template's Hartley normalization.

    Returns (T (4,4), stats (8,) = [iters, f_norm, g_norm, status, sigma,
    delta_scale, converged, solver_ok], H (6,6), g (6,), w (C,K),
    band_overflow ()), with H/g/w those of the last linearization.
    """
    global launch_count
    if channels.device.type == "cpu":
        return level_gn_reference(cam, points, valid, pixels, jacobians,
                                  channels, T0, sigma0, dscale0, s, c, opts)
    if channels.device.type != "cuda":
        raise ValueError(f"level_gn: unsupported device {channels.device}")
    check_supported(opts)
    _check_cuda_inputs(points, valid, pixels, jacobians, channels, T0, s, c)
    from bpvo_tpu_torch.ops import _build
    lib = _build.library()
    C, H, W = channels.shape
    K = points.shape[0]
    dev = channels.device
    f32 = torch.float32
    sc = torch.cat([s.reshape(1), c])
    out_T = torch.empty(4, 4, dtype=f32, device=dev)
    stats = torch.empty(8, dtype=f32, device=dev)
    out_H = torch.empty(6, 6, dtype=f32, device=dev)
    out_g = torch.empty(6, dtype=f32, device=dev)
    w = torch.empty(C, K, dtype=f32, device=dev)
    # the residuals and flags of a thread's points when they exceed its
    # registers (more than 2 points a thread, or C > 8)
    r_scratch = torch.empty(C, K, dtype=f32, device=dev)
    ok_scratch = torch.empty(K, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = ctypes.c_void_p
    rc = lib.bpvo_level_gn(
        ptr(points.data_ptr()), ptr(valid.data_ptr()), ptr(pixels.data_ptr()),
        ptr(jacobians.data_ptr()), ptr(channels.data_ptr()),
        ptr(T0.data_ptr()), ptr(sc.data_ptr()),
        ptr(out_T.data_ptr()), ptr(stats.data_ptr()), ptr(out_H.data_ptr()),
        ptr(out_g.data_ptr()), ptr(w.data_ptr()), ptr(r_scratch.data_ptr()),
        ptr(ok_scratch.data_ptr()),
        C, H, W, K, cam.fx, cam.fy, cam.cx, cam.cy, float(sigma0),
        float(dscale0), LOSS_CODES[opts.loss],
        int(opts.interp == InterpolationType.COSINE), opts.max_iterations,
        opts.function_tolerance, opts.parameter_tolerance,
        opts.gradient_tolerance, opts.scale_tolerance,
        opts.scale_tolerance_rel, ptr(stream))
    if rc != 0:
        _build.launch(lib, f"level_gn (a cluster of "
                           f"{lib.bpvo_level_gn_ctas(K)} CTAs)", rc)
    with _build.count_lock:
        launch_count += 1
    return (out_T, stats, out_H, out_g, w,
            torch.zeros((), dtype=torch.int32, device=dev))
