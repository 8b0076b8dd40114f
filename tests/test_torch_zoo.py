"""The single-device option zoo of the port against the JAX package on the
CPU, at 120x160: the gradients, all eight descriptors (atol 1e-4 on 0-255
data; LATCH's comparison bits on at least 99.9% of the pixels),
``pyramid.build``, CUBIC and CUBIC_HERMITE sampling (atol 1e-4, equal
masks), the DisparitySpace warp (rtol 1e-5 of each array's scale) and its
template, the rest of the loss zoo (rtol 1e-6), ``rotation_to_euler_deg``,
``gauss_newton.run``'s gather route (CUBIC, CUBIC_HERMITE, DisparitySpace;
``irls_reduce_w`` at C > 1), the multi-start probe (the same candidate),
``VisualOdometry`` with conf/tsukuba.cfg's settings (poses within 5e-4) and
``apps.eval_descriptors`` (all 8 descriptors, GN and LM: poses within 5e-4
at C = 1 and 2e-3 at C > 1).

Route: on the CPU the JAX package runs ``gauss_newton.run`` with the
histogram median at every level.  Where a test drives whole frames it
patches the port's ``MAX_LEVEL_KERNEL_POINTS`` to 0, so the port takes the
same route (``run``), not the level kernel's bisection median (ROADMAP C.1,
C.2)."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpvo_tpu import AlgorithmParameters as JParams
from bpvo_tpu import VisualOdometry as JVisualOdometry
from bpvo_tpu.apps import eval_descriptors as jed
from bpvo_tpu.config import ConfigFile as JConfigFile
from bpvo_tpu.core import se3 as jse3
from bpvo_tpu.ops import descriptors as jdesc
from bpvo_tpu.ops import imgproc as jimg
from bpvo_tpu.ops import interp as jinterp
from bpvo_tpu.ops import pyramid as jpyr
from bpvo_tpu.solver import gauss_newton as jgn
from bpvo_tpu.solver import mestimator as jmest
from bpvo_tpu.types import DescriptorType as JDesc
from bpvo_tpu.types import InterpolationType as JInterp
from bpvo_tpu.vo import pose_estimator as jpe
from bpvo_tpu.vo import template_data as jtd
from bpvo_tpu.vo import warp as jwarp
from bpvo_tpu_torch import AlgorithmParameters, VisualOdometry
from bpvo_tpu_torch.apps import eval_descriptors
from bpvo_tpu_torch.config import ConfigFile
from bpvo_tpu_torch.core import se3
from bpvo_tpu_torch.ops import descriptors, imgproc, interp, pyramid
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.solver import mestimator
from bpvo_tpu_torch.types import DescriptorType, InterpolationType
from bpvo_tpu_torch.utils.convert import (camera_from_numpy,
                                          gn_options_from_jax,
                                          params_from_jax,
                                          template_from_numpy)
from bpvo_tpu_torch.vo import pose_estimator as pe
from bpvo_tpu_torch.vo import template_data as td_mod
from bpvo_tpu_torch.vo import warp
from conftest import synthetic_image
from test_gn import H_IMG, W_IMG, build_template, make_cam, render_pair
from test_odometry import make_sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIST = [0.001, -0.002, 0.001, 0.01, -0.005, 0.015]
NAMES = [d.value for d in eval_descriptors.DESCRIPTORS]
# descriptors whose channels are Gaussian-smoothed 0-255 values: atol 1e-4
SMOOTH = [n for n in NAMES if n != "Latch"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Whole-frame runs of small ops: one torch thread keeps the suite's
    workers from waiting on each other's spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _np_template(td):
    return {k: np.asarray(v) for k, v in td._asdict().items()}


# ---------------------------------------------------------------------------
# front end: gradients, descriptors, pyramid
# ---------------------------------------------------------------------------

def test_gradients_match_jax():
    img = synthetic_image()
    stack = np.stack([img, img[::-1].copy()])
    for a in (img, stack):
        for jf, tf in ((jimg.xgradient, imgproc.xgradient),
                       (jimg.ygradient, imgproc.ygradient)):
            np.testing.assert_allclose(tf(_t(a)).numpy(),
                                       np.asarray(jf(jnp.asarray(a))),
                                       atol=1e-4)


@pytest.mark.parametrize("name", SMOOTH)
def test_descriptor_matches_jax(name):
    img = synthetic_image()
    jp, tp = JParams(descriptor=JDesc(name)), AlgorithmParameters(
        descriptor=DescriptorType(name))
    want = np.asarray(jdesc.compute(jnp.asarray(img), jp))
    got = descriptors.compute(_t(img), tp).numpy()
    assert got.shape == want.shape == (
        descriptors.num_channels(tp.descriptor, tp), H_IMG, W_IMG)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_descriptor_options_match_jax():
    """Non-default knobs: CentralDifference radius 2 without smoothing,
    IntensityAndGradient with a blur, DF1/DF2 sigmas, Laplacian ksize 3
    (a 3x3 stencil summed in another order than XLA's convolution: within
    one float32 ulp of its largest partial sum, 16 x 255)."""
    img = synthetic_image(seed=4)
    ji, ti = jnp.asarray(img), _t(img)
    pairs = [
        (jdesc.central_difference(ji, 2, 0.0, 0.0),
         descriptors.central_difference(ti, 2, 0.0, 0.0)),
        (jdesc.intensity_and_gradient(ji, 1.2),
         descriptors.intensity_and_gradient(ti, 1.2)),
        (jdesc.descriptor_fields_1(ji, 0.0, 1.0),
         descriptors.descriptor_fields_1(ti, 0.0, 1.0)),
        (jdesc.descriptor_fields_2(ji, 1.0, 0.0),
         descriptors.descriptor_fields_2(ti, 1.0, 0.0))]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    want = np.asarray(jdesc.laplacian(ji, 3))
    np.testing.assert_allclose(descriptors.laplacian(ti, 3).numpy(), want,
                               atol=np.spacing(np.float32(16 * 255)))


@pytest.mark.parametrize("num_bytes,half_ssd", [(1, 1), (2, 2), (4, 1)])
def test_latch_bits_match_jax(num_bytes, half_ssd):
    """LATCH bits are strict < comparisons of box-filtered SSDs: a rounding
    difference can flip a tie, so the bits (``sigma_post=0`` leaves them
    as 255 b - 128) must agree on at least 99.9% of the pixels, and the
    smoothed channels at atol 1e-4 wherever no bit within the smoothing
    aperture flipped."""
    img = synthetic_image(seed=num_bytes)
    ji, ti = jnp.asarray(img), _t(img)
    bits_j = np.asarray(jdesc.latch(ji, num_bytes, half_ssd, sigma_post=0.0))
    bits_t = descriptors.latch(ti, num_bytes, half_ssd, sigma_post=0.0)
    assert bits_t.shape == (8 * num_bytes, H_IMG, W_IMG)
    assert set(np.unique(bits_t.numpy())) <= {-128.0, 127.0}
    same = bits_t.numpy() == bits_j
    assert same.mean() >= 0.999, same.mean()
    want = np.asarray(jdesc.latch(ji, num_bytes, half_ssd))
    got = descriptors.latch(ti, num_bytes, half_ssd).numpy()
    # a flip reaches the pixels of its 13x13 smoothing aperture
    clean = torch.nn.functional.max_pool2d(
        torch.as_tensor(~same, dtype=torch.float32)[:, None], 13, 1,
        6)[:, 0].numpy() == 0
    np.testing.assert_allclose(got[clean], want[clean], atol=1e-4)
    p = AlgorithmParameters(descriptor=DescriptorType.LATCH,
                            latchNumBytes=num_bytes,
                            latchHalfSsdSize=half_ssd,
                            latchRotationInvariance=True)
    np.testing.assert_array_equal(descriptors.compute(ti, p).numpy(), got)


def test_num_channels_every_type():
    p = AlgorithmParameters(centralDifferenceRadius=2, latchNumBytes=3)
    jp = JParams(centralDifferenceRadius=2, latchNumBytes=3)
    for name in NAMES:
        assert descriptors.num_channels(DescriptorType(name), p) == \
            jdesc.num_channels(JDesc(name), jp)


def test_pyramid_build_matches_jax():
    img = synthetic_image(seed=2)
    got = pyramid.build(img, 3)
    want = jpyr.build(jnp.asarray(img), 3)
    assert [tuple(g.shape) for g in got] == pyramid.level_shapes(
        H_IMG, W_IMG, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


# ---------------------------------------------------------------------------
# CUBIC / CUBIC_HERMITE sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["Cubic", "CubicHermite"])
def test_cubic_sample_matches_jax(method):
    r = np.random.default_rng(7)
    ch = np.stack([synthetic_image(seed=s) for s in range(3)])
    n = 6000
    u = r.uniform(-4, W_IMG + 3, n).astype(np.float32)
    v = r.uniform(-4, H_IMG + 3, n).astype(np.float32)
    u[:50] = np.floor(u[:50])          # on the integer grid and its borders
    v[50:100] = np.floor(v[50:100])
    jm, tm = JInterp(method), InterpolationType(method)
    assert interp.border_bounds(tm) == jinterp.border_bounds(jm)
    vj = np.asarray(jinterp.valid_mask(jnp.asarray(u), jnp.asarray(v), H_IMG,
                                       W_IMG, jm))
    vt = interp.valid_mask(_t(u), _t(v), H_IMG, W_IMG, tm).numpy()
    np.testing.assert_array_equal(vt, vj)
    assert 0.5 < vj.mean() < 1.0
    want = np.asarray(jinterp.sample(jnp.asarray(ch), jnp.asarray(u),
                                     jnp.asarray(v), jnp.asarray(vj), jm))
    got = interp.sample(_t(ch), _t(u), _t(v), torch.as_tensor(vt), tm)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert not got.numpy()[:, ~vt].any()


# ---------------------------------------------------------------------------
# the DisparitySpace warp
# ---------------------------------------------------------------------------

def _close(got, want, rtol=1e-5):
    """rtol 1e-5 of each entry, or of the array's largest entry for the
    entries near zero (a 1-ulp different input moves them by more)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("level", [0, 1])
def test_disparity_space_warp_matches_jax(level):
    r = np.random.default_rng(level)
    K = np.array([[300.0, 0, 80.0], [0, 310.0, 60.0], [0, 0, 1]], np.float32)
    jc = jwarp.CameraModel.from_K(K, 0.12).at_level(level)
    tc = warp.CameraModel.from_K(K, 0.12).at_level(level)
    n = 4000
    x, y = (r.uniform(0, 160, n).astype(np.float32),
            r.uniform(0, 120, n).astype(np.float32))
    d = r.uniform(1, 60, n).astype(np.float32)
    _close(warp.disparity_space_G(tc), jwarp.disparity_space_G(jc))
    _close(warp.disparity_space_G_inv(tc), jwarp.disparity_space_G_inv(jc))
    pj = jwarp.disparity_space_make_points(jc, jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(d))
    pt = warp.disparity_space_make_points(tc, _t(x), _t(y), _t(d))
    _close(pt, pj)
    T = np.asarray(jse3.exp(jnp.asarray([0.01, -0.02, 0.005, 0.03, -0.01,
                                         0.05], jnp.float32)))
    for a, b in zip(warp.disparity_space_project(tc, _t(T), pt),
                    jwarp.disparity_space_project(jc, jnp.asarray(T), pj)):
        _close(a, b)
    gx, gy = (r.normal(size=(2, n)).astype(np.float32) for _ in range(2))
    _close(warp.disparity_space_jacobian(tc, pt, _t(gx), _t(gy)),
           jwarp.disparity_space_jacobian(jc, pj, jnp.asarray(gx),
                                          jnp.asarray(gy)))
    xyd = np.stack([x, y, d], 1)
    _close(warp.disparity_space_warp_points(tc, _t(T), _t(xyd)),
           jwarp.disparity_space_warp_points(jc, jnp.asarray(T),
                                             jnp.asarray(xyd)))


def test_disparity_space_jacobian_is_the_derivative():
    """The analytic Jacobian against autograd of the warp at the identity:
    d/dp of (gx, gy) . (u, v)(G exp(p) G^-1 q), in float64."""
    K = np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1]], np.float32)
    cam = warp.CameraModel.from_K(K, 0.12)
    r = np.random.default_rng(3)
    pts = torch.as_tensor(np.stack([r.uniform(-70, 70, 8), r.uniform(-50, 50, 8),
                                    r.uniform(2, 40, 8)], 1))
    gx, gy = (torch.as_tensor(r.normal(size=8)) for _ in range(2))
    G = warp.disparity_space_G(cam).double()
    Gi = torch.linalg.inv(G)

    def photometric(p):
        H = G @ se3.exp(p) @ Gi
        q = torch.cat([pts, torch.ones(8, 1, dtype=torch.float64)], 1)
        pw = q @ H.T
        return gx * pw[:, 0] / pw[:, 3] + gy * pw[:, 1] / pw[:, 3]

    J = torch.autograd.functional.jacobian(
        photometric, torch.zeros(6, dtype=torch.float64))
    want = warp.disparity_space_jacobian(cam, pts, gx, gy)
    np.testing.assert_allclose(want.numpy(), J.numpy(), rtol=1e-6,
                               atol=1e-9)


def test_disparity_space_template_matches_jax():
    """The DisparitySpace template (points (x-cx, y-cy, d), no
    normalization, its Jacobians) and ``compute_residuals`` at a pose."""
    I0, I1, D, cam, _ = render_pair(TWIST)
    jp = JParams(minSaliency=2.0, warpType="DisparitySpace")
    td_j, _ = build_template(I0, D, cam, p=jp)
    tp = params_from_jax(dataclasses.asdict(jp))
    td_t = td_mod.set_data(_t(I0)[None], _t(D), camera_from_numpy(cam), tp,
                           2048, 0)
    assert int(td_t.num_valid) == int(td_j.num_valid) > 200
    v = td_t.valid.numpy()
    np.testing.assert_array_equal(v, np.asarray(td_j.valid))
    assert float(td_t.norm_scale) == 1.0 and not td_t.norm_center.any()
    for name in ("points", "pixels", "jacobians"):
        _close(getattr(td_t, name).numpy(), np.asarray(getattr(td_j, name)))
    T = np.asarray(jse3.exp(jnp.asarray(TWIST, jnp.float32)))
    for method in ("Linear", "CubicHermite"):
        rj, okj = jtd.compute_residuals(td_j, jnp.asarray(I1)[None], cam,
                                        jnp.asarray(T), JInterp(method),
                                        warp="DisparitySpace")
        rt, okt = td_mod.compute_residuals(
            template_from_numpy(_np_template(td_j), "cpu"), _t(I1)[None],
            camera_from_numpy(cam), _t(T), InterpolationType(method),
            warp="DisparitySpace")
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-3)


# ---------------------------------------------------------------------------
# the loss zoo, Euler angles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["huber", "tukey", "l2", "cauchy", "fair",
                                  "andrews", "geman_mcclure", "welsch"])
def test_loss_zoo_matches_jax(name):
    u = np.linspace(-12.0, 12.0, 4001).astype(np.float32)
    fn = f"{name}_weight"
    want = np.asarray(getattr(jmest, fn)(jnp.asarray(u)))
    got = getattr(mestimator, fn)(_t(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)


def test_rotation_to_euler_deg_matches_jax():
    r = np.random.default_rng(0)
    tw = r.normal(size=(16, 6)).astype(np.float32) * 0.5
    T = np.asarray(jse3.exp(jnp.asarray(tw)))
    np.testing.assert_allclose(se3.rotation_to_euler_deg(_t(T)).numpy(),
                               np.asarray(jse3.rotation_to_euler_deg(T)),
                               rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# gauss_newton.run's gather route
# ---------------------------------------------------------------------------

def _gather_problem(case):
    """(JAX template, channels, camera, GNOptions) at 120x160: intensity
    (C=1), three scaled copies (C=3) or Bit-Planes (C=8), RigidBody or
    DisparitySpace."""
    interp_name, warp_name, C = case
    I0, I1, D, cam, _ = render_pair(TWIST)
    jp = JParams(minSaliency=2.0, warpType=warp_name,
                 descriptor=JDesc.BITPLANES if C == 8 else JDesc.INTENSITY)
    ch0 = jdesc.compute(jnp.asarray(I0), jp)
    ch1 = jdesc.compute(jnp.asarray(I1), jp)
    td = jtd.set_data(ch0, jnp.asarray(D), cam, jp, 2048, 0)
    if C == 3:
        s = (1.0, 0.5, 2.0)
        td = td._replace(
            pixels=jnp.concatenate([td.pixels * a for a in s]),
            jacobians=jnp.concatenate([td.jacobians * a for a in s]))
        ch1 = jnp.concatenate([ch1 * a for a in s])
    opts = jgn.GNOptions(function_tolerance=1e-4, parameter_tolerance=1e-6,
                         interp=JInterp(interp_name), warp=warp_name)
    return td, ch1, cam, opts


# CUBIC_HERMITE DisparitySpace at C = 1 and 3 stops on the solve's residual
# check in both packages, on the same iteration
GATHER_CASES = [("Cubic", "RigidBody", 1), ("CubicHermite", "RigidBody", 1),
                ("CubicHermite", "RigidBody", 8),
                ("Linear", "DisparitySpace", 1),
                ("Linear", "DisparitySpace", 3),
                ("CubicHermite", "DisparitySpace", 3)]


@pytest.mark.parametrize("case", GATHER_CASES, ids=["-".join(map(str, c))
                                                    for c in GATHER_CASES])
def test_gather_route_run_matches_jax(case, monkeypatch):
    """The port's gather route (plain sampling; ``irls_reduce_w``'s plain
    version at C > 1) against JAX's jnp route: pose at atol 1e-5, the same
    iterations, exit and status, sigma and f at rtol 1e-3 (atol 1e-4 and
    1e-3 where cubic sampling of the noise-free scene leaves residuals at
    the rounding floor, sigma ~7e-4; the weights there divide that noise
    by sigma and are compared above it)."""
    monkeypatch.setenv("BPVO_IRLS_KERNEL", "0")
    td, ch, cam, opts = _gather_problem(case)
    st_j = jgn.run(td, ch, cam, jnp.eye(4), opts)
    st_t = gn.run(template_from_numpy(_np_template(td), "cpu"),
                  torch.as_tensor(np.array(ch)), camera_from_numpy(cam),
                  torch.eye(4), gn_options_from_jax(opts))
    assert bool(st_t.converged) == bool(st_j.converged)
    assert bool(st_t.solver_ok) == bool(st_j.solver_ok)
    np.testing.assert_allclose(st_t.T.numpy(), np.asarray(st_j.T), atol=1e-5)
    assert int(st_t.num_iters) == int(st_j.num_iters) >= 2
    assert int(st_t.status) == int(st_j.status)
    np.testing.assert_allclose(float(st_t.scale), float(st_j.scale),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(st_t.f_norm), float(st_j.f_norm),
                               rtol=1e-3, atol=1e-3)
    if float(st_j.scale) > 1e-2:
        np.testing.assert_allclose(st_t.weights.numpy(),
                                   np.asarray(st_j.weights), atol=5e-3)


@pytest.mark.parametrize("case", [("CubicHermite", "RigidBody", 1),
                                  ("CubicHermite", "RigidBody", 8),
                                  ("Linear", "DisparitySpace", 3)],
                         ids=["CubicHermite-1", "CubicHermite-8",
                              "DisparitySpace-3"])
def test_gather_route_linearize_matches_jax(case, monkeypatch):
    """One linearization of the gather route (``gn._linearize``: sigma from
    channel 0, ``reduce_w``) against JAX's ``gn._linearize`` with its IRLS
    Pallas kernel at C > 1 (interpret mode, ``BPVO_IRLS_KERNEL=force``), at
    a pose off the start: H and g at rtol 1e-4 of their largest entry,
    sigma, its change and f at rtol 1e-4, the weights at atol 1e-4."""
    monkeypatch.setenv("BPVO_IRLS_KERNEL", "force")
    td, ch, cam, opts = _gather_problem(case)
    xi = np.array([0.0, 0.001, 0.0, 0.004, 0.0, 0.01], np.float32)
    T = se3.exp(torch.as_tensor(xi))
    want = jgn._linearize(td, ch, cam, jnp.asarray(T.numpy()),
                          jnp.asarray(1.0), jnp.asarray(1e10), opts)
    got = gn._linearize(template_from_numpy(_np_template(td), "cpu"),
                        torch.as_tensor(np.array(ch)), camera_from_numpy(cam),
                        T, torch.tensor(1.0), torch.tensor(1e10), True,
                        gn_options_from_jax(opts))
    for a, b in zip(got[:2], want[:2]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())
    for a, b in zip(got[2:5], want[2:5]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]),
                               atol=1e-4)


def test_gather_route_matches_jax_irls_kernel(monkeypatch):
    """JAX's gather route with its IRLS Pallas kernel (interpret mode,
    ``BPVO_IRLS_KERNEL=force``) at C = 8 under CUBIC_HERMITE: the route
    ``irls_reduce_w`` serves on the card."""
    monkeypatch.setenv("BPVO_IRLS_KERNEL", "force")
    td, ch, cam, opts = _gather_problem(("CubicHermite", "RigidBody", 8))
    st_j = jgn.run(td, ch, cam, jnp.eye(4), opts)
    st_t = gn.run(template_from_numpy(_np_template(td), "cpu"),
                  torch.as_tensor(np.array(ch)), camera_from_numpy(cam),
                  torch.eye(4), gn_options_from_jax(opts))
    np.testing.assert_allclose(st_t.T.numpy(), np.asarray(st_j.T), atol=1e-5)
    assert abs(int(st_t.num_iters) - int(st_j.num_iters)) <= 1


# ---------------------------------------------------------------------------
# the multi-start probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sx,sy,px,expect", [
    (0, 0, 2.0, 0), (1, 0, 2.0, 2), (-1, 0, 2.0, 1), (0, 1, 3.0, 4),
    (0, -1, 3.0, 3), (0.3, 0, 2.0, 0)])
def test_multistart_picks_jax_candidate(sx, sy, px, expect):
    """From a start moved by (sx, sy) probe steps off the true motion, both
    packages pick the same one of the five candidates (0 centred, 1/2
    +x/-x, 3/4 +y/-y), the one that undoes the move.  JAX's
    ``_estimate_all`` with ``max_iterations=0`` returns its choice
    unchanged."""
    frames = make_sequence([0, 0, 0, 0.006, 0, 0.004], 2)
    cam = make_cam()
    jp = JParams(minSaliency=2.0, numPyramidLevels=3, maxIterations=0)
    tp = params_from_jax(dataclasses.asdict(jp))
    jvo = JVisualOdometry(np.asarray(cam.K()), float(cam.baseline),
                          (H_IMG, W_IMG), jp)
    tvo = VisualOdometry(np.asarray(cam.K()), float(cam.baseline),
                         (H_IMG, W_IMG), tp, device="cpu")
    jvo.add_frame(*frames[0])
    jvo._cur.set_data(*frames[1], 3, jp)
    templates = tuple(template_from_numpy(_np_template(t), "cpu")
                      for t in jvo._ref.templates)
    channels = tuple(torch.as_tensor(np.array(c)) for c in jvo._cur.channels)
    # the probe level is 1, midway between levels 2 and 0
    step = px * float(mestimator.masked_median_sort(
        templates[1].points[:, 2], templates[1].valid)) / tvo._cams[0].fx
    T0 = np.array(se3.exp(torch.tensor([0, 0, 0, 0.006, 0, 0.004])))
    T0[0, 3] += sx * step
    T0[1, 3] += sy * step
    opts = jvo._pose_estimator._opts_for(3)
    want = np.asarray(jpe._estimate_all(
        tuple(jvo._ref.templates), tuple(jvo._cur.channels), tuple(jvo._cams),
        jnp.asarray(T0), opts, 0, jp.goodPointThreshold, 8, "GaussNewton", -1,
        None, px)[0])
    got, best = pe._multistart(templates, channels, tuple(tvo._cams),
                               _t(T0), tuple(gn_options_from_jax(o)
                                             for o in opts), 2, 0, px)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    dx, dy = (want - T0)[:2, 3]
    j_best = (0 if dx == dy == 0 else (1 if dx > 0 else 2) if dx
              else (3 if dy > 0 else 4))
    assert int(best) == j_best == expect


# ---------------------------------------------------------------------------
# whole frames: conf/tsukuba.cfg's settings, apps.eval_descriptors
# ---------------------------------------------------------------------------

def test_tsukuba_settings_vo_matches_jax(monkeypatch):
    """``VisualOdometry`` with conf/tsukuba.cfg's algorithm settings
    (Intensity, CD5 gradients, CUBIC_HERMITE sampling, NMS off) at 120x160:
    every level takes ``gauss_newton.run`` in both packages (the level
    kernel takes no cubic sampling).  Poses within 5e-4, the same
    keyframes."""
    cf = JConfigFile(os.path.join(ROOT, "conf", "tsukuba.cfg"))
    jp = JParams.from_config(cf)
    tp = AlgorithmParameters.from_config(
        ConfigFile(os.path.join(ROOT, "conf", "tsukuba.cfg")))
    assert tp.interp == InterpolationType.CUBIC_HERMITE
    assert params_from_jax(dataclasses.asdict(jp)) == tp
    frames = make_sequence([0.001, 0, 0, 0.01, 0, 0.02], 5)
    cam = make_cam()
    K, b = np.asarray(cam.K()), float(cam.baseline)
    jvo = JVisualOdometry(K, b, (H_IMG, W_IMG), jp)
    tvo = VisualOdometry(K, b, (H_IMG, W_IMG), tp, device="cpu")
    n_iters = 0
    for I, D in frames:
        rj, rt = jvo.add_frame(I, D), tvo.add_frame(I, D)
        assert rt.is_keyframe == rj.is_keyframe
        np.testing.assert_allclose(rt.pose, rj.pose, atol=5e-4)
        n_iters += sum(s.num_iterations for s in rt.optimizer_statistics)
    assert n_iters > 0


@pytest.fixture(scope="module")
def corridor_cfg(tmp_path_factory):
    """conf/eval_corridor.cfg's algorithm settings over 1+2 frames of the
    ``synthetic`` plane at 120x160.  The corridor itself aliases at this
    size (its finest texture is cut for 240x320): Gauss-Newton diverges in
    both packages on 5 of the 8 descriptors (ATE 0.9-20 m over 3 frames),
    and diverging runs are no parity target.  chip_smoke.py holds the card
    to the corridor at 240x320."""
    path = tmp_path_factory.mktemp("corridor") / "corridor.cfg"
    with open(os.path.join(ROOT, "conf", "eval_corridor.cfg")) as src:
        text = src.read().replace("synthetic_corridor", "synthetic").replace(
            "SyntheticNumFrames = 120", "SyntheticNumFrames = 3")
    path.write_text(text + "SyntheticRows = 120\nSyntheticCols = 160\n")
    return str(path)


@pytest.mark.parametrize("name", NAMES)
def test_eval_descriptors_matches_jax(name, corridor_cfg, tmp_path,
                                      monkeypatch):
    """``eval_descriptors.run`` for one descriptor with GN and LM in both
    packages over the same frames: the port's world poses within
    5e-4 of JAX's at C = 1 and 2e-3 at C > 1, its ATE within as much, the
    same output files.  The port runs ``gauss_newton.run`` at every GN
    level, as JAX does on the CPU."""
    monkeypatch.setattr(gn, "MAX_LEVEL_KERNEL_POINTS", 0)
    solvers = ("GaussNewton", "LevenbergMarquardt")
    rj = jed.run(corridor_cfg, str(tmp_path / "jax"), -1, [JDesc(name)],
                 solvers)
    traj = {}
    rt = eval_descriptors.run(corridor_cfg, str(tmp_path / "port"), -1,
                              [DescriptorType(name)], solvers, device="cpu",
                              trajectories=traj)
    assert rt.keys() == rj.keys() == {f"{name}+{s}" for s in solvers}
    C = descriptors.num_channels(DescriptorType(name), AlgorithmParameters())
    atol = 5e-4 if C == 1 else 2e-3
    for tag in rj:
        assert rt[tag]["frames"] == rj[tag]["frames"] == 3
        assert traj[tag].shape == (3, 4, 4)
        np.testing.assert_allclose(rt[tag]["ate_rmse_m"],
                                   rj[tag]["ate_rmse_m"], atol=atol)
        for suffix in ("_path.txt", "_time.txt", "_iterations.txt"):
            assert os.path.exists(tmp_path / "port" / (tag + suffix))
        np.testing.assert_allclose(
            np.loadtxt(tmp_path / "port" / f"{tag}_path.txt"),
            np.loadtxt(tmp_path / "jax" / f"{tag}_path.txt"), atol=atol)


def test_eval_descriptors_command_line(corridor_cfg, tmp_path, capsys,
                                       monkeypatch):
    """The command line: all 8 descriptors with GN alone by default, its
    cells and files named as the JAX package's command names them, JSON on
    stdout; ``--solvers GaussNewton,LevenbergMarquardt`` gives both
    solvers' cells; ``--device`` defaults to the card (which raises without
    one)."""
    monkeypatch.setattr(gn, "MAX_LEVEL_KERNEL_POINTS", 0)
    out = eval_descriptors.main(["--config", corridor_cfg, "--out",
                                 str(tmp_path / "both"), "--numframes", "2",
                                 "--solvers", ",".join(
                                     eval_descriptors.SOLVERS),
                                 "--device", "cpu"])
    assert set(out) == {f"{d}+{s}" for d in NAMES
                        for s in eval_descriptors.SOLVERS}
    assert all(c["frames"] == 2 for c in out.values())
    assert '"Latch+LevenbergMarquardt"' in capsys.readouterr().out
    out = eval_descriptors.main(["--config", corridor_cfg, "--out",
                                 str(tmp_path / "gn"), "--numframes", "1",
                                 "--device", "cpu"])
    assert set(out) == set(NAMES)
    assert '"Latch"' in capsys.readouterr().out
    for name in NAMES:
        for suffix in ("_path.txt", "_time.txt", "_iterations.txt"):
            assert os.path.exists(tmp_path / "gn" / (name + suffix))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            eval_descriptors.main(["--config", corridor_cfg])
