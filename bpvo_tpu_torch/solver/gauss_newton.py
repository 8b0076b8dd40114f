"""Per-level IRLS Gauss-Newton (counterpart of
``bpvo_tpu/solver/gauss_newton.py``): options, state, the per-iteration
solver ``run``, the one-launch level solve ``run_level`` and the rule that
picks between them (``solve_level``).

Flow per iteration (inverse compositional, template Jacobians fixed):
  r, valid = photometric residuals at T
  sigma    = robust scale (histogram median, skipped once stable)
  w        = M-estimator weights
  H, g, f  = J^T W J, J^T W r, sqrt(sum w r^2)
  dp       = solve(H, g)
  T       <- T * Tn^-1 exp(-dp) Tn

``run_level`` runs a level's whole loop in the CUDA kernel ``ops.level_gn``
(16-step bisection median).  ``run`` runs the loop as
``utils.graphs.while_loop`` (JAX's ``lax.while_loop``), with the
linearization in the CUDA kernels ``ops.fused_linearize`` and ``ops.irls``
(CUBIC, CUBIC_HERMITE and DisparitySpace levels take the gather route:
plain sampling, ``irls_reduce_w`` at C > 1) and the sigma re-estimate
under ``utils.graphs.cond`` (JAX's ``lax.cond``); everything, sigma and the
exit test included, stays on the device.  Eagerly the loop reads its exit
test once per iteration (and the sigma test once); captured in a CUDA
graph it is a WHILE node and reads nothing: ``DeviceVO``'s step graph and
``VisualOdometry``'s estimate graph hold their ``run`` levels' loops so,
and ``GraphCache.jit`` makes one level solve alone one replay (the sharded
GN).  Verbose runs stay on the host loop (``utils.graphs.route``).
Levenberg-Marquardt is in ``solver/levenberg_marquardt.py``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from bpvo_tpu_torch.config import AlgorithmParameters
from bpvo_tpu_torch.ops import fused_linearize as fused_mod
from bpvo_tpu_torch.ops import interp as interp_mod
from bpvo_tpu_torch.ops import irls as irls_mod
from bpvo_tpu_torch.ops import level_gn as level_gn_mod
from bpvo_tpu_torch.ops.level_gn import (STATUS_FUNCTION_TOL,
                                         STATUS_GRADIENT_TOL,
                                         STATUS_MAX_ITERATIONS,
                                         STATUS_PARAMETER_TOL,
                                         STATUS_SOLVER_ERROR)
from bpvo_tpu_torch.solver import linear_system, mestimator
from bpvo_tpu_torch.types import (InterpolationType, LossFunctionType,
                                  PoseEstimationStatus, VerbosityType)
from bpvo_tpu_torch.utils import graphs as graphs_mod
from bpvo_tpu_torch.utils import profiling
from bpvo_tpu_torch.vo import template_data as td_mod
from bpvo_tpu_torch.vo import warp as warp_mod

_SQRT_EPS = 3.452669831e-4

STATUS_ENUMS = {
    STATUS_MAX_ITERATIONS: PoseEstimationStatus.MAX_ITERATIONS,
    STATUS_PARAMETER_TOL: PoseEstimationStatus.PARAMETER_TOL_REACHED,
    STATUS_FUNCTION_TOL: PoseEstimationStatus.FUNCTION_TOL_REACHED,
    STATUS_GRADIENT_TOL: PoseEstimationStatus.GRADIENT_TOL_REACHED,
    STATUS_SOLVER_ERROR: PoseEstimationStatus.SOLVER_ERROR,
}

# Levels with more points go to ``run``.  JAX's MAX_POINTS_BANDED
# (level_gn_kernel.py:549), there a TPU VMEM envelope; here ``level_gn``
# runs a level on one cluster of up to 16 CTAs (16 SMs), and ``run``
# spreads larger levels over the whole card, one kernel launch per
# linearization.
MAX_LEVEL_KERNEL_POINTS = 16384


@dataclasses.dataclass(frozen=True)
class GNOptions:
    """Per-level optimizer configuration."""
    max_iterations: int = 50
    function_tolerance: float = 1e-6
    parameter_tolerance: float = 1e-7
    gradient_tolerance: float = 1e-8
    loss: LossFunctionType = LossFunctionType.TUKEY
    interp: InterpolationType = InterpolationType.LINEAR
    scale_tolerance: float = 1e-6
    # relative sigma-stability tolerance: re-estimation stops once the last
    # sigma step was below scale_tolerance_rel * sigma (as well as the
    # absolute scale_tolerance); 0.01 at the finest level, 0.05 coarse
    scale_tolerance_rel: float = 0.01
    # ``run``'s median: the 1024-bin histogram (default) or the exact sort
    use_histogram_median: bool = True
    # ``run`` prints one line per iteration (reference kIteration verbosity)
    verbose: bool = False
    warp: str = "RigidBody"

    @classmethod
    def from_params(cls, p: AlgorithmParameters, coarse: bool) -> "GNOptions":
        """Coarse levels get relaxed tolerances, the smoother Huber loss and
        the 0.05 sigma-stability tolerance (reference
        pose_estimator_params.cc:36-47)."""
        verbose = p.verbosity in (VerbosityType.ITERATION, VerbosityType.DEBUG)
        if not coarse or not p.relaxTolerancesForCoarseLevels:
            return cls(max_iterations=p.maxIterations,
                       function_tolerance=p.functionTolerance,
                       parameter_tolerance=p.parameterTolerance,
                       gradient_tolerance=p.gradientTolerance,
                       loss=p.lossFunction, interp=p.interp, verbose=verbose,
                       warp=p.warpType, scale_tolerance_rel=0.01)
        s = p.coarseToleranceScale
        loss = (p.lossFunction if p.lossFunction == LossFunctionType.L2
                else LossFunctionType.HUBER)
        return cls(max_iterations=min(p.maxIterations, p.coarseMaxIterations),
                   function_tolerance=p.functionTolerance * s,
                   parameter_tolerance=p.parameterTolerance * s,
                   gradient_tolerance=p.gradientTolerance * s,
                   loss=loss, interp=p.interp, verbose=verbose,
                   warp=p.warpType, scale_tolerance_rel=0.05)


class GNState(NamedTuple):
    """A level solve's result (device tensors)."""
    T: torch.Tensor             # (4, 4) final pose
    f_norm: torch.Tensor        # weighted residual norm at the last linearize
    g: torch.Tensor             # (6,) gradient at the last linearize
    scale: torch.Tensor         # robust sigma
    weights: torch.Tensor       # (C, K) last IRLS weights
    H: torch.Tensor             # (6, 6) last Hessian
    num_iters: torch.Tensor     # int32
    status: torch.Tensor        # int32 STATUS_* code
    converged: torch.Tensor     # bool
    solver_ok: torch.Tensor     # bool
    band_overflow: torch.Tensor  # int32, always 0 (no row bands here)


def level_kernel_supported(opts: GNOptions, C: int, rows: int, cols: int,
                           K: int) -> bool:
    """Whether ``run_level``'s kernel takes this level (JAX's rule,
    gauss_newton.py:526-531 and level_gn_kernel.py:603-612, without the TPU's
    VMEM budgets)."""
    return (opts.loss in (LossFunctionType.TUKEY, LossFunctionType.HUBER,
                          LossFunctionType.L2)
            and opts.warp == "RigidBody" and not opts.verbose
            and opts.interp in (InterpolationType.LINEAR,
                                InterpolationType.COSINE)
            and K <= MAX_LEVEL_KERNEL_POINTS)


def run_level(tdata, channels, cam, T_init, opts: GNOptions) -> GNState:
    """One level's whole IRLS GN from T_init through ``ops.level_gn``."""
    T, stats, H, g, w, bo = level_gn_mod.level_gn(
        cam, tdata.points, tdata.valid, tdata.pixels, tdata.jacobians,
        channels, T_init.to(torch.float32).contiguous(), 1.0, 1e10,
        tdata.norm_scale, tdata.norm_center, opts)
    return GNState(T=T, f_norm=stats[1], g=g, scale=stats[4], weights=w, H=H,
                   num_iters=stats[0].to(torch.int32),
                   status=stats[3].to(torch.int32),
                   converged=stats[6] > 0.5, solver_ok=stats[7] > 0.5,
                   band_overflow=bo)


def solve_level(tdata, channels, cam, T_init, opts: GNOptions,
                timer=None) -> GNState:
    """A level solve by the route JAX takes on the TPU: ``run_level`` where
    ``level_kernel_supported``, ``run`` elsewhere (timed by the
    ``graphs.timer`` named ``timer``, if given)."""
    C, rows, cols = channels.shape
    if level_kernel_supported(opts, C, rows, cols, tdata.pixels.shape[1]):
        return run_level(tdata, channels, cam, T_init, opts)
    return run(tdata, channels, cam, T_init, opts,
               timer=None if timer is None else graphs_mod.timer(timer))


def _sigma_unstable(delta_scale, scale, opts: GNOptions):
    """Sigma is re-estimated while its last step exceeds the absolute
    (reference mestimator.cc:467-490) or the relative tolerance."""
    return delta_scale > torch.clamp(opts.scale_tolerance_rel * scale,
                                     min=opts.scale_tolerance)


def _no_reduce(H, g, f_sq):
    return H, g, f_sq


def _sigma_fn(opts: GNOptions):
    """``gauss_newton.run``'s sigma: ``estimate_scale`` of channel 0's
    residuals (the histogram or the sorted median)."""
    def sigma_fn(r0, valid):
        return mestimator.estimate_scale(r0, valid, opts.use_histogram_median)
    return sigma_fn


def _sigma_branch(do_est, estimate, keep, scale, delta_scale):
    """The sigma re-estimate as JAX's ``lax.cond``: ``estimate()`` (which
    returns ``(*keep, sigma, delta_scale)`` recomputed) when ``do_est``,
    else ``(*keep, scale, delta_scale)``.  A host bool (the first
    iteration's, which the options fix) picks on the host; a 0-d bool
    tensor goes through ``graphs.cond``, into ``keep`` (tensors the caller
    owns) and copies of ``scale`` and ``delta_scale``."""
    if isinstance(do_est, torch.Tensor):
        return graphs_mod.cond(do_est, estimate, (*keep, scale.clone(),
                                                  delta_scale.clone()))
    return estimate() if do_est else (*keep, scale, delta_scale)


def _linearize(tdata, channels, cam, T, scale, delta_scale, do_est,
               opts: GNOptions, sigma_fn=None, reduce=_no_reduce):
    """The gather route (JAX gauss_newton.py:374-428), taken by the levels
    the fused kernel does not take (CUBIC or CUBIC_HERMITE sampling, or the
    DisparitySpace warp): residuals by ``compute_residuals``, sigma from
    channel 0 (``sigma_fn(r0, valid)``, default ``_sigma_fn``) when
    ``do_est`` (``_sigma_branch``), weights and normal equations by
    ``reduce_w``, then ``reduce(H, g, f_sq)``.
    Returns (H, g, f, sigma, delta_scale, w)."""
    r, valid = td_mod.compute_residuals(tdata, channels, cam, T, opts.interp,
                                        warp=opts.warp)

    def estimate():
        sigma = (sigma_fn or _sigma_fn(opts))(r[0], valid)
        return sigma, torch.abs(sigma - scale)
    sigma, delta_scale = _sigma_branch(do_est, estimate, (), scale,
                                       delta_scale)
    H, g, f_sq, w = reduce_w(tdata.jacobians, r, valid, sigma, opts.loss)
    H, g, f_sq = reduce(H, g, f_sq)
    return H, g, torch.sqrt(f_sq), sigma, delta_scale, w


def _fused_linearize_fn(tdata, channels, cam, opts: GNOptions, sigma_fn=None,
                        reduce=_no_reduce):
    """The kernel route (JAX gauss_newton.py:278-373, at f32 for every C):

    - C = 1: one fused pass at the incoming sigma; while sigma is still
      moving, the new sigma is ``sigma_fn`` of that pass's residuals, and
      the weights and normal equations are rebuilt at it by
      ``irls_reduce_w`` from those residuals and J.
    - C > 1: while sigma is still moving, a fused pass over channel 0 alone
      gives the residuals for sigma; then one fused pass over all channels
      runs at the new sigma.

    The re-estimate is ``_sigma_branch`` on ``do_est``.  ``sigma_fn(r0,
    valid)`` defaults to ``_sigma_fn``; ``reduce(H, g, f_sq)`` is applied
    last (the distributed layer sums over the ranks).
    """
    C, rows, cols = channels.shape
    pixels, jacobians = tdata.pixels, tdata.jacobians
    loss, interp = opts.loss, opts.interp
    sigma_fn = sigma_fn or _sigma_fn(opts)

    def project(T):
        u, v, Z = warp_mod.project(cam, T, tdata.points)
        ok = tdata.valid & (Z > 1e-6) & interp_mod.valid_mask(
            u, v, rows, cols, interp)
        return u, v, ok

    if C == 1:
        J = jacobians.reshape(-1, 6)

        def linearize(T, scale, delta_scale, do_est):
            u, v, ok = project(T)
            H, g, f_sq, r0, w = fused_mod.fused_linearize(
                u, v, ok, channels, pixels, jacobians, scale, loss, interp)

            def estimate():
                sigma = sigma_fn(r0, ok)
                H, g, f_sq, w = irls_mod.irls_reduce_w(J, r0, ok, sigma, loss)
                return H, g, f_sq, w[None, :], sigma, torch.abs(sigma - scale)
            H, g, f_sq, w, sigma, delta_scale = _sigma_branch(
                do_est, estimate, (H, g, f_sq, w), scale, delta_scale)
            H, g, f_sq = reduce(H, g, f_sq)
            return H, g, torch.sqrt(f_sq), sigma, delta_scale, w
        return linearize

    ch0, px0, J0 = channels[:1], pixels[:1], jacobians[:1]

    def linearize(T, scale, delta_scale, do_est):
        u, v, ok = project(T)

        def estimate():
            r0 = fused_mod.fused_linearize(u, v, ok, ch0, px0, J0, scale,
                                           loss, interp)[3]
            sigma = sigma_fn(r0, ok)
            return sigma, torch.abs(sigma - scale)
        sigma, delta_scale = _sigma_branch(do_est, estimate, (), scale,
                                           delta_scale)
        H, g, f_sq, _, w = fused_mod.fused_linearize(
            u, v, ok, channels, pixels, jacobians, sigma, loss, interp)
        H, g, f_sq = reduce(H, g, f_sq)
        return H, g, torch.sqrt(f_sq), sigma, delta_scale, w
    return linearize


def _test_convergence(dp_norm, dp_norm_prev, g_norm, f_norm, f_norm_prev,
                      g_tol, opts: GNOptions):
    """The three convergence tests (reference pose_estimator_base.h:258-282),
    with JAX's added relative decrease test.  Returns (converged, status)."""
    p_tol = (dp_norm < opts.parameter_tolerance) | (
        dp_norm < opts.parameter_tolerance * (_SQRT_EPS + dp_norm_prev))
    df = torch.abs(f_norm - f_norm_prev)
    f_tol = ((f_norm < opts.function_tolerance)
             | (f_norm < opts.function_tolerance * (_SQRT_EPS + f_norm_prev))
             | (df < opts.function_tolerance)
             | (df < opts.function_tolerance
                * torch.clamp(f_norm_prev, min=1.0)))
    g_ok = g_norm < g_tol
    status = torch.where(
        p_tol, STATUS_PARAMETER_TOL,
        torch.where(f_tol, STATUS_FUNCTION_TOL,
                    torch.where(g_ok, STATUS_GRADIENT_TOL,
                                STATUS_MAX_ITERATIONS)))
    return p_tol | f_tol | g_ok, status.to(torch.int32)


class _LoopState(NamedTuple):
    """``run``'s loop carry (device tensors)."""
    T: torch.Tensor             # (4, 4) pose the next iteration linearizes at
    T_best: torch.Tensor        # (4, 4) lowest-cost pose evaluated so far
    f_best: torch.Tensor        # its cost
    dp: torch.Tensor            # (6,) last step taken
    f_norm: torch.Tensor        # cost at the last linearization
    dp_norm_prev: torch.Tensor  # |dp| before the last iteration
    g_tol: torch.Tensor         # gradient threshold, fixed at iteration 0
    scale: torch.Tensor         # robust sigma
    delta_scale: torch.Tensor   # its last change
    H: torch.Tensor             # (6, 6) last Hessian
    g: torch.Tensor             # (6,) last gradient
    w: torch.Tensor             # (C, K) last IRLS weights
    status: torch.Tensor        # int32 STATUS_* code
    conv: torch.Tensor          # bool, a convergence test fired
    ok: torch.Tensor            # bool, the last solve succeeded
    num_iters: torch.Tensor     # int32 iterations run


def _initial_state(T_init, C: int, K: int, dev) -> _LoopState:
    f32 = torch.float32

    def scalar(x, dtype=f32):   # filled on the device: no host copy
        return torch.full((), x, dtype=dtype, device=dev)

    T = T_init.to(device=dev, dtype=f32)
    return _LoopState(
        T=T, T_best=T, f_best=scalar(float("inf")),
        dp=torch.zeros(6, dtype=f32, device=dev), f_norm=scalar(0.0),
        dp_norm_prev=scalar(0.0), g_tol=scalar(0.0), scale=scalar(1.0),
        delta_scale=scalar(1e10), H=torch.eye(6, dtype=f32, device=dev),
        g=torch.zeros(6, dtype=f32, device=dev),
        w=torch.zeros(C, K, dtype=f32, device=dev),
        status=scalar(STATUS_MAX_ITERATIONS, torch.int32),
        conv=scalar(False, torch.bool), ok=scalar(True, torch.bool),
        num_iters=scalar(0, torch.int32))


def _iteration(st: _LoopState, linearize_fn, s, c, opts: GNOptions,
               first: bool, do_est):
    """One GN iteration from ``st`` (the body of ``gn.run``'s
    ``lax.while_loop``, gauss_newton.py:457-487): linearize at T, test
    convergence against the previous iteration's values (only the gradient
    test on the first iteration), solve and update.  ``first`` is
    host-static (``run`` peels iteration 0, the only one that takes it);
    ``do_est`` (sigma still moving) is a host bool or a 0-d bool tensor
    (``_sigma_branch``).  Returns (new state, dp_new, g_norm)."""
    H, g, f_new, sigma, delta_scale, w = linearize_fn(st.T, st.scale,
                                                      st.delta_scale, do_est)
    g_norm = torch.max(torch.abs(g))
    dp_norm = torch.linalg.norm(st.dp)
    if first:
        # first-order-optimality threshold fixed from the first gradient
        # (pose_estimator_base.h:341-343); only that test applies now
        g_tol = opts.gradient_tolerance * torch.clamp(g_norm, min=_SQRT_EPS)
        conv = g_norm < g_tol
        status = torch.where(conv, STATUS_GRADIENT_TOL,
                             STATUS_MAX_ITERATIONS).to(torch.int32)
    else:
        g_tol = st.g_tol
        conv, status = _test_convergence(dp_norm, st.dp_norm_prev, g_norm,
                                         f_new, st.f_norm, g_tol, opts)
    dp_new, ok = linear_system.solve(H, g)
    do_update = ~conv & ok
    better = f_new < st.f_best
    T_best = torch.where(better, st.T, st.T_best)
    f_best = torch.where(better, f_new, st.f_best)
    T = torch.where(do_update, st.T @ warp_mod.params_to_pose(-dp_new, s, c),
                    st.T)
    dp = torch.where(do_update, dp_new, st.dp)
    status = torch.where(ok, status, STATUS_SOLVER_ERROR).to(torch.int32)
    return _LoopState(
        T=T, T_best=T_best, f_best=f_best, dp=dp, f_norm=f_new,
        dp_norm_prev=dp_norm, g_tol=g_tol, scale=sigma,
        delta_scale=delta_scale, H=H, g=g, w=w, status=status, conv=conv,
        ok=ok, num_iters=st.num_iters + 1), dp_new, g_norm


def _result(st: _LoopState) -> GNState:
    """The level's GNState: the best evaluated pose when the loop ended
    unconverged at a higher cost (JAX gauss_newton.py:489-492)."""
    use_best = ~st.conv & (st.f_best < st.f_norm)
    return GNState(T=torch.where(use_best, st.T_best, st.T),
                   f_norm=st.f_norm, g=st.g, scale=st.scale, weights=st.w,
                   H=st.H, num_iters=st.num_iters, status=st.status,
                   converged=st.conv, solver_ok=st.ok,
                   band_overflow=torch.zeros((), dtype=torch.int32,
                                             device=st.T.device))


def reduce_w(jacobians, r, valid, sigma, loss):
    """Weights of the residuals ``r`` (C, K) at ``sigma`` and the normal
    equations, split as JAX's gather route splits them
    (gauss_newton.py:393-424): the plain weights and ``build`` at C = 1,
    ``ops.irls.irls_reduce_w`` at C > 1 (the CUDA kernel on the card, its
    plain version, bit for bit the C = 1 arithmetic, on the CPU).  Returns
    (H, g, f_sq, w (C, K))."""
    C, K = r.shape
    if C == 1:
        w = mestimator.compute_weights(loss, r, valid[None, :], sigma)
        return (*linear_system.build(jacobians, r, w), w)
    H, g, f_sq, w = irls_mod.irls_reduce_w(
        jacobians.reshape(C * K, 6), r.reshape(-1),
        valid.expand(C, K).reshape(-1), sigma, loss)
    return H, g, f_sq, w.view(C, K)


def _default_linearize_fn(tdata, channels, cam, opts: GNOptions,
                          sigma_fn=None, reduce=_no_reduce):
    """RigidBody levels with LINEAR or COSINE sampling take the fused CUDA
    kernels (their plain versions on the CPU), others ``_linearize``.
    ``sigma_fn`` and ``reduce`` as in ``_fused_linearize_fn``."""
    if opts.warp == "RigidBody" and opts.interp in (
            InterpolationType.LINEAR, InterpolationType.COSINE):
        return _fused_linearize_fn(tdata, channels.contiguous(), cam, opts,
                                   sigma_fn, reduce)

    def linearize_fn(T, scale, delta_scale, do_est):
        return _linearize(tdata, channels, cam, T, scale, delta_scale,
                          do_est, opts, sigma_fn, reduce)
    return linearize_fn


def run(tdata, channels, cam, T_init, opts: GNOptions,
        linearize_fn=None, timer=None) -> GNState:
    """GN from T_init until a convergence test fires, the solve fails or
    ``max_iterations`` are spent; falls back to the best evaluated pose
    when it ends unconverged at a higher cost.

    Iteration i linearizes at T_i, tests convergence against iteration
    i-1's values (only the gradient test on the first iteration), then
    solves and updates (``_iteration``).  Iteration 0 runs first on its
    own; the rest are ``utils.graphs.while_loop`` on the device exit test
    ``~converged & solver_ok & (num_iters < max_iterations)``, JAX's
    ``lax.while_loop`` (a host loop reads that test and the sigma test in
    one copy an iteration).  ``linearize_fn(T, scale, delta_scale, do_est) ->
    (H, g, f, sigma, delta_scale, w)`` may replace the linearization;
    ``do_est`` (sigma still moving) is a host bool on iteration 0 and a
    device bool after it.  By default RigidBody levels with LINEAR or
    COSINE sampling take the fused CUDA kernels, others the gather route
    (``irls_reduce_w`` at C > 1); on the CPU their plain versions.  The
    loop runs where it is called: a host loop, or a WHILE node of a graph
    being captured.  ``timer`` (a ``utils.graphs.Timer``) counts every
    iteration and, in a graph on CUDA, times it: iteration 0 between its
    own start and stop nodes, the loop's in the WHILE body.  The span
    ``gn.run`` covers the solve.
    """
    with profiling.annotate("gn.run"):
        return _run(tdata, channels, cam, T_init, opts, linearize_fn, timer)


def _run(tdata, channels, cam, T_init, opts: GNOptions, linearize_fn,
         timer) -> GNState:
    C, K = tdata.pixels.shape
    s, c = tdata.norm_scale, tdata.norm_center
    if linearize_fn is None:
        linearize_fn = _default_linearize_fn(tdata, channels, cam, opts)
    st = _initial_state(T_init, C, K, channels.device)
    if opts.max_iterations == 0:
        return _result(st)

    def iteration(st, first, do_est):
        st, dp_new, g_norm = _iteration(st, linearize_fn, s, c, opts, first,
                                        do_est)
        if opts.verbose:
            it, f_, g_, dp_, s_ = torch.stack([
                st.num_iters.to(torch.float32) - 1, st.f_norm, g_norm,
                torch.linalg.norm(dp_new), st.scale]).tolist()
            print(f"  it {int(it)}  |F|={f_:.6g}  |G|={g_:.4g}  "
                  f"|dp|={dp_:.4g}  sigma={s_:.4g}")
        return st

    # iteration 0: sigma is due unless the tolerances exceed the initial
    # delta_scale (1e10) at the initial scale (1)
    with graphs_mod.timed(timer, channels.device):
        st = iteration(st, True, 1e10 > max(opts.scale_tolerance,
                                            opts.scale_tolerance_rel))
    return _result(graphs_mod.while_loop(
        lambda st: ~st.conv & st.ok & (st.num_iters < opts.max_iterations),
        lambda st, do_est: iteration(st, False, do_est), st,
        flag_fn=lambda st: _sigma_unstable(st.delta_scale, st.scale, opts),
        timer=timer))


def fraction_of_good_points(weights, num_channels, num_valid, threshold,
                            count_reduce=None):
    """count(w > threshold) / (C * N) (reference vo_pose_estimator.cc:101-107);
    ``count_reduce`` sums the count over ranks (N is then the global
    count)."""
    n_good = torch.sum(weights > threshold)
    if count_reduce is not None:
        n_good = count_reduce(n_good)
    denom = torch.clamp(num_channels * num_valid, min=1)
    return n_good.to(torch.float32) / denom.to(torch.float32)
