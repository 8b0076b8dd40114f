"""Levenberg-Marquardt pose refinement on one pyramid level (counterpart of
``bpvo_tpu/solver/levenberg_marquardt.py``; reference
pose_estimator_lm.h:72-119).  Madsen-Nielsen schedule:

  solve (H + mu I) dp = g;  T' = T * Tn^-1 exp(-dp) Tn
  rho = (f^2 - f'^2) / (dp . (mu dp + g))
  accept (rho > 0): mu *= max(1/3, 1 - (2 rho - 1)^3), nu = 2
  reject:           mu *= nu, nu *= 2

The candidate cost f' is taken at the current sigma (the weights are fixed
within an accept/reject cycle); an accepted step carries sigma re-estimated
from the candidate's channel-0 residuals, with the weights, H, g and f
rebuilt at it, so the next rho compares costs under one weighting.  The
linearizations are ``gauss_newton``'s gather route (``reduce_w``:
``irls_reduce_w`` at C > 1), whose f_sq is the carried cost, as JAX carries
``linear_system.build``'s.  The loop is ``utils.graphs.while_loop`` (JAX's
``lax.while_loop``) and the sigma re-estimate ``utils.graphs.cond``: the
state and the exit test stay on the device.  Eagerly the loop reads its
exit test and its sigma test in one copy an iteration; captured in a CUDA
graph it is a WHILE node and reads nothing: ``DeviceVO``'s step graph and
``VisualOdometry``'s estimate graph hold their LM loops so.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bpvo_tpu_torch.ops import gn_step
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.solver import linear_system, mestimator
from bpvo_tpu_torch.utils import graphs as graphs_mod
from bpvo_tpu_torch.vo import template_data as td_mod
from bpvo_tpu_torch.vo import warp as warp_mod


class LMState(NamedTuple):
    T: torch.Tensor            # (4, 4) current pose
    f_norm: torch.Tensor       # cost at T under the carried weights
    g: torch.Tensor            # (6,) gradient at T
    H: torch.Tensor            # (6, 6) Hessian at T
    mu: torch.Tensor           # damping
    nu: torch.Tensor           # damping growth on rejection
    scale: torch.Tensor        # robust sigma
    delta_scale: torch.Tensor  # its last change
    weights: torch.Tensor      # (C, K) IRLS weights at T
    num_iters: torch.Tensor    # int32
    converged: torch.Tensor    # bool
    status: torch.Tensor       # int32 STATUS_* code


def run(tdata, channels, cam: warp_mod.CameraModel, T_init,
        opts: gn.GNOptions, tau: float = 1e-4) -> LMState:
    """LM from T_init until a convergence test fires on an accepted step or
    ``max_iterations`` are spent."""
    f32 = torch.float32
    dev = channels.device
    # the carry's own pose (the loop may write over it)
    T0 = T_init.to(device=dev, dtype=f32).clone()
    s, c = tdata.norm_scale, tdata.norm_center
    eye = torch.eye(6, dtype=f32, device=dev)

    def scalar(x, dtype=f32):
        return torch.full((), x, dtype=dtype, device=dev)

    def residuals(T):
        return td_mod.compute_residuals(tdata, channels, cam, T, opts.interp,
                                        warp=opts.warp)

    # the first linearization: sigma from channel 0 (re-estimation is due,
    # the carried change starts at 1e10)
    r, valid = residuals(T0)
    sigma = mestimator.estimate_scale(r[0], valid, opts.use_histogram_median)
    dscale = torch.abs(sigma - 1.0)
    H, g, f_sq, w = gn.reduce_w(tdata.jacobians, r, valid, sigma, opts.loss)
    g_max = torch.max(torch.abs(g))
    g_tol = opts.gradient_tolerance * torch.clamp(g_max,
                                                  min=gn_step.SQRT_EPS)
    init = LMState(T=T0, f_norm=torch.sqrt(f_sq), g=g, H=H,
                   mu=tau * torch.max(torch.diag(H)), nu=scalar(2.0),
                   scale=sigma, delta_scale=dscale, weights=w,
                   num_iters=scalar(0, torch.int32), converged=g_max < g_tol,
                   status=scalar(gn.STATUS_MAX_ITERATIONS, torch.int32))

    def body(st: LMState, do_est) -> LMState:
        dp = linear_system.cholesky_solve_6x6(st.H + st.mu * eye, st.g)
        dp = torch.where(torch.all(torch.isfinite(dp)), dp, 0.0)
        T_new = st.T @ warp_mod.params_to_pose(-dp, s, c)
        r_new, valid_new = residuals(T_new)
        # the candidate's cost under the current weighting
        w_new = mestimator.compute_weights(opts.loss, r_new,
                                           valid_new[None, :], st.scale)
        f_new = torch.sqrt(torch.sum(w_new * r_new * r_new))

        # sigma for the next cycle, carried only if this step is accepted
        def estimate():
            est = mestimator.estimate_scale(r_new[0], valid_new,
                                            opts.use_histogram_median)
            return est, torch.abs(est - st.scale)
        new_sigma, new_delta = gn._sigma_branch(do_est, estimate, (),
                                                st.scale, st.delta_scale)
        H_c, g_c, f_sq_c, w_c = gn.reduce_w(tdata.jacobians, r_new,
                                            valid_new, new_sigma, opts.loss)
        pred = torch.dot(dp, st.mu * dp + st.g)
        rho = (st.f_norm ** 2 - f_new ** 2) / torch.clamp(pred, min=1e-20)
        accept = rho > 0.0
        factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        g_max = torch.max(torch.abs(st.g))
        conv, status = gn_step.convergence(
            torch.linalg.norm(dp), scalar(0.0), g_max,
            torch.where(accept, f_new, st.f_norm), st.f_norm,
            opts.gradient_tolerance * torch.clamp(g_max,
                                                  min=gn_step.SQRT_EPS), opts)
        conv = conv & accept
        return LMState(
            T=torch.where(accept, T_new, st.T),
            f_norm=torch.where(accept, torch.sqrt(f_sq_c), st.f_norm),
            g=torch.where(accept, g_c, st.g),
            H=torch.where(accept, H_c, st.H),
            mu=torch.where(accept, st.mu * factor, st.mu * st.nu),
            nu=torch.where(accept, 2.0, st.nu * 2.0),
            scale=torch.where(accept, new_sigma, st.scale),
            delta_scale=torch.where(accept, new_delta, st.delta_scale),
            weights=torch.where(accept, w_c, st.weights),
            num_iters=st.num_iters + 1, converged=conv,
            status=torch.where(conv, status, st.status).to(torch.int32))

    return graphs_mod.while_loop(
        lambda st: ~st.converged & (st.num_iters < opts.max_iterations),
        body, init,
        flag_fn=lambda st: gn_step.sigma_unstable(st.delta_scale, st.scale,
                                                  opts))
