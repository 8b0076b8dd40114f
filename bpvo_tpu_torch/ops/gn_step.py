"""The step of a ``gauss_newton.run`` iteration after its linearization: the
hand-written CUDA kernel ``csrc/gn_step.cu``, its wrapper and its plain
PyTorch version.

From the linearization's H, g, f, sigma and sigma's last change and the
loop's state, one step computes the gradient and step norms, the
convergence tests (only the gradient test on the first iteration, whose
gradient fixes the threshold), the jittered 6x6 Cholesky solve with its
finiteness and residual checks, the best evaluated pose and its cost, the
update ``T <- T Tn^-1 exp(-dp) Tn``, the status and the iteration count,
and the loop's exit test and sigma flag for the next iteration.  The JAX
package has no Pallas kernel here: this is the tail of the body of
``gn.run``'s ``lax.while_loop`` (``bpvo_tpu/solver/gauss_newton.py``:457-487),
which XLA fuses.

``gn_step`` takes the plain version for CPU tensors only, which returns
fresh tensors.  For CUDA tensors it launches the kernel once or raises; it
never falls back.  The kernel writes the new state over the state it is
given (every field but the weights), so the loop's carry is its own
output and a WHILE body copies none of it.  The dense cell's L0 iteration
made ~310 launches of plain torch ops here.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from bpvo_tpu_torch.ops.level_gn import (STATUS_FUNCTION_TOL,
                                         STATUS_GRADIENT_TOL,
                                         STATUS_MAX_ITERATIONS,
                                         STATUS_PARAMETER_TOL,
                                         STATUS_SOLVER_ERROR)
from bpvo_tpu_torch.solver import linear_system
from bpvo_tpu_torch.vo import warp as warp_mod

SQRT_EPS = 3.452669831e-4

# the largest entry difference of the updated pose between the kernel and
# the plain version on the card, twice the largest measured (1.69e-6 over
# 300 random steps on an H100): their 4x4 products (cuBLAS in the plain
# version) and exp's sums round in other orders; every field but T and
# dp_norm_prev is equal bit for bit
T_ATOL = 4e-6
# dp_norm_prev, |dp|: the kernel sums the six squares in index order,
# torch's reduce kernel in an order of its own (with or without FMA); each
# sum is within 6u of the exact one and each square root adds u/2
# (u = 2^-24), so the two norms are within 7u of each other, relative
DP_NORM_RTOL = 7 * 2.0 ** -24

# kernel launches made by ``gn_step`` in this process, one an iteration
# (the plain version is not counted)
launch_count = 0


class LoopState(NamedTuple):
    """``gauss_newton.run``'s loop carry (device tensors)."""
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
    pred: torch.Tensor          # bool, the loop runs another iteration
    flag: torch.Tensor          # bool, sigma is still moving


def sigma_unstable(delta_scale, scale, opts):
    """Sigma is re-estimated while its last step exceeds the absolute
    (reference mestimator.cc:467-490) or the relative tolerance."""
    return delta_scale > torch.clamp(opts.scale_tolerance_rel * scale,
                                     min=opts.scale_tolerance)


def convergence(dp_norm, dp_norm_prev, g_norm, f_norm, f_norm_prev, g_tol,
                opts):
    """The three convergence tests (reference pose_estimator_base.h:258-282),
    with JAX's added relative decrease test.  Returns (converged, status)."""
    p_tol = (dp_norm < opts.parameter_tolerance) | (
        dp_norm < opts.parameter_tolerance * (SQRT_EPS + dp_norm_prev))
    df = torch.abs(f_norm - f_norm_prev)
    f_tol = ((f_norm < opts.function_tolerance)
             | (f_norm < opts.function_tolerance * (SQRT_EPS + f_norm_prev))
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


def gn_step_reference(st: LoopState, H, g, f_new, sigma, delta_scale, w, s,
                      c, opts, first: bool):
    """Plain PyTorch version, on any device; same contract as ``gn_step``,
    but every field of the new state is a fresh tensor."""
    g_norm = torch.max(torch.abs(g))
    dp_norm = torch.linalg.norm(st.dp)
    if first:
        # first-order-optimality threshold fixed from the first gradient
        # (pose_estimator_base.h:341-343); only that test applies now
        g_tol = opts.gradient_tolerance * torch.clamp(g_norm, min=SQRT_EPS)
        conv = g_norm < g_tol
        status = torch.where(conv, STATUS_GRADIENT_TOL,
                             STATUS_MAX_ITERATIONS).to(torch.int32)
    else:
        g_tol = st.g_tol
        conv, status = convergence(dp_norm, st.dp_norm_prev, g_norm, f_new,
                                   st.f_norm, g_tol, opts)
    dp_new, ok = linear_system.solve(H, g)
    do_update = ~conv & ok
    better = f_new < st.f_best
    T_best = torch.where(better, st.T, st.T_best)
    f_best = torch.where(better, f_new, st.f_best)
    T = torch.where(do_update, st.T @ warp_mod.params_to_pose(-dp_new, s, c),
                    st.T)
    dp = torch.where(do_update, dp_new, st.dp)
    status = torch.where(ok, status, STATUS_SOLVER_ERROR).to(torch.int32)
    num_iters = st.num_iters + 1
    return LoopState(
        T=T, T_best=T_best, f_best=f_best, dp=dp, f_norm=f_new,
        dp_norm_prev=dp_norm, g_tol=g_tol, scale=sigma,
        delta_scale=delta_scale, H=H, g=g, w=w, status=status, conv=conv,
        ok=ok, num_iters=num_iters,
        pred=~conv & ok & (num_iters < opts.max_iterations),
        flag=sigma_unstable(delta_scale, sigma, opts)), dp_new, g_norm


def gn_step(st: LoopState, H, g, f_new, sigma, delta_scale, w, s, c, opts,
            first: bool):
    """One iteration's step after its linearization at ``st.T``.

    ``H`` (6, 6), ``g`` (6,), ``f_new``, ``sigma`` and ``delta_scale``
    (one-element float32) the linearization's outputs and ``w`` its (C, K)
    weights; ``s`` and ``c`` (3,) the level's Hartley normalization;
    ``opts`` the level's ``GNOptions``; ``first`` (host-static) whether this
    is iteration 0.  Returns (new state, dp_new (6,), g_norm): the state's
    ``w`` is ``w``, its ``f_norm``, ``scale``, ``delta_scale``, ``H`` and
    ``g`` hold the inputs' values; ``dp_new`` is the solve's step and
    ``g_norm`` max |g| (for the verbose line).

    CPU tensors take ``gn_step_reference``.  CUDA tensors launch
    ``csrc/gn_step.cu`` once on the current stream, with no
    synchronisation: it overwrites every field of ``st`` but ``w`` with
    the new state and returns ``st`` itself with the new ``w``, so the
    caller must not read the old state afterwards, and ``st`` must own its
    tensors (none the caller of the solve holds).
    """
    global launch_count
    if H.device.type == "cpu":
        return gn_step_reference(st, H, g, f_new, sigma, delta_scale, w, s,
                                 c, opts, first)
    if H.device.type != "cuda":
        raise ValueError(f"gn_step: unsupported device {H.device}")
    from bpvo_tpu_torch.ops import _build
    dev = H.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    H, g = H.contiguous(), g.contiguous()
    one = ()
    _build.check_tensors("gn_step", dev, {
        "H": (H, (6, 6), f32), "g": (g, (6,), f32), "f": (f_new, one, f32),
        "sigma": (sigma, sigma.shape, f32),
        "delta_scale": (delta_scale, delta_scale.shape, f32),
        "s": (s, s.shape, f32), "c": (c, (3,), f32),
        "T": (st.T, (4, 4), f32), "T_best": (st.T_best, (4, 4), f32),
        "f_best": (st.f_best, one, f32), "dp": (st.dp, (6,), f32),
        "f_norm": (st.f_norm, one, f32),
        "dp_norm_prev": (st.dp_norm_prev, one, f32),
        "g_tol": (st.g_tol, one, f32), "scale": (st.scale, one, f32),
        "st.delta_scale": (st.delta_scale, one, f32),
        "st.H": (st.H, (6, 6), f32), "st.g": (st.g, (6,), f32),
        "status": (st.status, one, i32), "conv": (st.conv, one, b8),
        "ok": (st.ok, one, b8), "num_iters": (st.num_iters, one, i32),
        "pred": (st.pred, one, b8), "flag": (st.flag, one, b8)})
    if sigma.numel() != 1 or delta_scale.numel() != 1 or s.numel() != 1:
        raise ValueError("gn_step: sigma, delta_scale and s must hold one "
                         "value each")
    aux = torch.empty(7, dtype=f32, device=dev)     # g_norm, dp_new
    lib = _build.library()
    ptr = ctypes.c_void_p
    rc = lib.bpvo_gn_step(
        *(ptr(t.data_ptr()) for t in (
            H, g, f_new, sigma, delta_scale, s, c, st.T, st.T_best,
            st.f_best, st.dp, st.f_norm, st.dp_norm_prev, st.g_tol,
            st.scale, st.delta_scale, st.H, st.g, st.status, st.conv, st.ok,
            st.num_iters, st.pred, st.flag, aux)),
        int(first), opts.max_iterations, opts.function_tolerance,
        opts.parameter_tolerance, opts.gradient_tolerance,
        opts.scale_tolerance, opts.scale_tolerance_rel,
        ptr(torch.cuda.current_stream(dev).cuda_stream))
    _build.launch(lib, "gn_step", rc)
    with _build.count_lock:
        launch_count += 1
    return st._replace(w=w), aux[1:], aux[0]
