"""The port's Levenberg-Marquardt (``solver/levenberg_marquardt.py``)
against the JAX package's on the CPU, at 120x160: the first linearization
(H, g at rtol 1e-4), the converged pose (atol 5e-4) and iterations (within
1), the fixed-weight candidate cost and the carried re-weighting, the
damping schedule.  LM through ``VisualOdometry`` and ``DeviceVO`` is in
tests/test_torch_odometry.py and tests/test_torch_device_vo.py.

LM stops only on an accepted step.  Near its minimum a candidate is
accepted only when its cost is lower than the carried one, and the two
differ by less than the rounding of their float32 sums (JAX's by ~1e-5 of
the cost on the CPU, the port's by ~1e-7), so one package can accept such
a step (and stop on the parameter test) where the other rejects it and
runs on to maxIterations (ROADMAP C, accepted delta (i)).  Iterations are
held within 1 where both packages stop on a convergence test; on the
noise-floor cases the pose is held, and the port's cost at its end pose,
summed in float64, is no higher than JAX's at JAX's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpvo_tpu.solver import gauss_newton as jgn
from bpvo_tpu.solver import levenberg_marquardt as jlm
from bpvo_tpu.types import LossFunctionType as JLoss
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.solver import levenberg_marquardt as lm
from bpvo_tpu_torch.solver import mestimator
from bpvo_tpu_torch.utils.convert import (camera_from_numpy,
                                          gn_options_from_jax,
                                          template_from_numpy)
from bpvo_tpu_torch.vo import template_data as td_mod
from test_torch_zoo import _gather_problem, _np_template

# (interp, warp, C, loss): both packages stop on a convergence test
CONVERGED = [("Linear", "RigidBody", 1, "Huber"),
             ("Linear", "RigidBody", 3, "Tukey"),
             ("Linear", "RigidBody", 8, "Huber"),
             ("CubicHermite", "RigidBody", 1, "Tukey"),
             ("CubicHermite", "RigidBody", 8, "Tukey"),
             ("Linear", "DisparitySpace", 1, "Tukey")]
# JAX stops on an accepted step at the noise floor where the port runs on
# (delta (i))
NOISE_FLOOR = [("Linear", "RigidBody", 1, "Tukey"),
               ("Linear", "RigidBody", 8, "Tukey"),
               ("CubicHermite", "RigidBody", 1, "Huber")]


def _ids(cases):
    return ["-".join(map(str, c)) for c in cases]


def _lm_both(case, **change):
    td, ch, cam, opts = _gather_problem(case[:3])
    opts = dataclasses.replace(opts, **{
        "loss": JLoss(case[3]), "parameter_tolerance": 1e-6,
        "max_iterations": 50, **change})
    st_j = jax.jit(lambda: jlm.run(td, ch, cam, jnp.eye(4), opts))()
    st_t = lm.run(template_from_numpy(_np_template(td), "cpu"),
                  torch.as_tensor(np.array(ch)), camera_from_numpy(cam),
                  torch.eye(4), gn_options_from_jax(opts))
    return st_j, st_t, (td, ch, cam, opts)


@pytest.mark.parametrize("case", CONVERGED[:3] + CONVERGED[4:5],
                         ids=_ids(CONVERGED[:3] + CONVERGED[4:5]))
def test_lm_first_linearization_matches_jax(case):
    """With ``max_iterations=0`` LM returns its first linearization: JAX's
    ``gn._linearize`` at the start pose (H, g at rtol 1e-4 of their
    largest entry, sigma and f at rtol 1e-5), mu = 1e-4 max(diag H)."""
    st_j, st_t, (td, ch, cam, opts) = _lm_both(case, max_iterations=0)
    H, g, f, sigma, _, w, _ = jgn._linearize(
        td, ch, cam, jnp.eye(4), jnp.asarray(1.0), jnp.asarray(1e10), opts)
    assert int(st_t.num_iters) == 0 and not bool(st_t.converged)
    for got, want in ((st_t.H, H), (st_t.g, g), (st_t.H, st_j.H)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(float(st_t.scale), float(sigma), rtol=1e-5)
    np.testing.assert_allclose(float(st_t.f_norm), float(f), rtol=1e-5)
    np.testing.assert_allclose(float(st_t.mu), float(st_j.mu), rtol=1e-4)
    np.testing.assert_allclose(st_t.weights.numpy(), np.asarray(w),
                               atol=1e-6)


@pytest.mark.parametrize("case", CONVERGED, ids=_ids(CONVERGED))
def test_lm_converged_matches_jax(case):
    """Both stop on a convergence test: the pose at atol 5e-4, iterations
    within 1, the same status, the carried sigma and cost at rtol 1e-2
    (the histogram medians of residuals that differ by rounding can sit one
    bin, 1/1024 of max|r|, apart, and the cost is weighted at sigma)."""
    st_j, st_t, _ = _lm_both(case)
    assert bool(st_t.converged) and bool(st_j.converged)
    np.testing.assert_allclose(st_t.T.numpy(), np.asarray(st_j.T), atol=5e-4)
    assert abs(int(st_t.num_iters) - int(st_j.num_iters)) <= 1
    assert int(st_t.status) == int(st_j.status)
    np.testing.assert_allclose(float(st_t.scale), float(st_j.scale),
                               rtol=1e-2)
    np.testing.assert_allclose(float(st_t.f_norm), float(st_j.f_norm),
                               rtol=1e-2)


def _cost_f64(problem, T, sigma):
    """sqrt(sum w r^2) at pose T and ``sigma``, summed in float64 over the
    port's residuals of ``problem`` (``_lm_both``'s third item)."""
    td, ch, cam, opts = problem
    topts = gn_options_from_jax(opts)
    r, valid = td_mod.compute_residuals(
        template_from_numpy(_np_template(td), "cpu"),
        torch.as_tensor(np.array(ch)), camera_from_numpy(cam),
        torch.as_tensor(np.array(T)), topts.interp, warp=topts.warp)
    r = r.double()
    w = mestimator.compute_weights(topts.loss, r, valid[None, :],
                                   torch.tensor(sigma, dtype=torch.float64))
    return float(torch.sqrt(torch.sum(w * r * r)))


@pytest.mark.parametrize("case", NOISE_FLOOR, ids=_ids(NOISE_FLOOR))
def test_lm_noise_floor_exit_keeps_pose(case):
    """Delta (i): where the port runs on past JAX's exit at the noise
    floor, the poses agree at atol 5e-4 and the port ends no worse: its
    cost at its end pose, summed in float64 at JAX's sigma, is at most
    JAX's at JAX's end pose (so the steps it rejected were uphill)."""
    st_j, st_t, problem = _lm_both(case)
    np.testing.assert_allclose(st_t.T.numpy(), np.asarray(st_j.T), atol=5e-4)
    assert bool(st_j.converged)
    assert int(st_t.num_iters) > int(st_j.num_iters)
    sigma = float(st_j.scale)
    assert (_cost_f64(problem, st_t.T, sigma)
            <= _cost_f64(problem, st_j.T, sigma))


@pytest.mark.parametrize("C", [1, 8])
def test_lm_carries_the_linear_system_at_its_sigma(C):
    """After accepted steps LM carries the linearization of its pose at its
    re-estimated sigma, as JAX carries ``linear_system.build``'s: H, g,
    the weights and f (the square root of ``reduce_w``'s f_sq, a sum
    apart from the candidate cost's, as in JAX) equal bit for bit those of
    ``gauss_newton.reduce_w`` at the carried pose and sigma."""
    case = ("Linear", "RigidBody", C, "Huber")
    _, st, (td, ch, cam, opts) = _lm_both(case, max_iterations=3)
    assert int(st.num_iters) == 3
    ttd = template_from_numpy(_np_template(td), "cpu")
    topts = gn_options_from_jax(opts)
    r, valid = td_mod.compute_residuals(
        ttd, torch.as_tensor(np.array(ch)), camera_from_numpy(cam), st.T,
        topts.interp, warp=topts.warp)
    H, g, f_sq, w = gn.reduce_w(ttd.jacobians, r, valid, st.scale,
                                topts.loss)
    assert torch.equal(st.H, H) and torch.equal(st.g, g)
    assert torch.equal(st.weights, w)
    assert torch.equal(st.f_norm, torch.sqrt(f_sq))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_lm_damping_schedule_matches_jax(n):
    """After n iterations the damping mu and its growth nu (accept: mu *=
    max(1/3, 1 - (2 rho - 1)^3), nu = 2; reject: mu *= nu, nu *= 2) and
    the pose follow JAX's."""
    st_j, st_t, _ = _lm_both(("Linear", "RigidBody", 8, "Huber"),
                             max_iterations=n)
    assert int(st_t.num_iters) == int(st_j.num_iters) == n
    np.testing.assert_allclose(float(st_t.mu), float(st_j.mu), rtol=1e-3)
    np.testing.assert_allclose(float(st_t.nu), float(st_j.nu))
    np.testing.assert_allclose(st_t.T.numpy(), np.asarray(st_j.T), atol=1e-5)
