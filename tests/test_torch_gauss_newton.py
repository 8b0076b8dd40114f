"""The port's per-iteration Gauss-Newton route against the JAX package on the
CPU: the histogram median, the plain versions of the two kernels
(``fused_linearize``, ``irls_reduce``) against the Pallas kernels in
interpret mode, and ``gauss_newton.run`` against JAX's ``gn.run`` on its
three routes (jnp, ``linearize="fused"``, ``BPVO_IRLS_KERNEL=force``).
Both packages get the very same template, carried across with
``template_from_numpy``."""
import dataclasses
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from bpvo_tpu.config import AlgorithmParameters as JParams
from bpvo_tpu.ops import descriptors as jdesc
from bpvo_tpu.ops.pallas import gn_kernel, irls_kernel
from bpvo_tpu.solver import gauss_newton as jgn
from bpvo_tpu.solver import mestimator as jmest
from bpvo_tpu.types import DescriptorType as JDesc
from bpvo_tpu.types import InterpolationType as JInterp
from bpvo_tpu.types import LossFunctionType as JLoss
from bpvo_tpu.vo import template_data as jtd
from bpvo_tpu.vo import warp as jwarp
from bpvo_tpu_torch.ops import fused_linearize as fl
from bpvo_tpu_torch.ops import interp, irls
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.solver import mestimator
from bpvo_tpu_torch.types import InterpolationType, LossFunctionType
from bpvo_tpu_torch.utils.convert import (camera_from_numpy,
                                          gn_options_from_jax,
                                          template_from_numpy)
from bpvo_tpu_torch.vo import warp
from test_gn import build_template, render_pair

TWIST = [0.001, -0.002, 0.001, 0.01, -0.005, 0.015]
LOSSES = {"Tukey": LossFunctionType.TUKEY, "Huber": LossFunctionType.HUBER,
          "L2": LossFunctionType.L2}


def _np_template(td):
    return {k: np.asarray(v) for k, v in td._asdict().items()}


# ---------------------------------------------------------------------------
# the histogram median: counts, median and sigma bit for bit
# ---------------------------------------------------------------------------

def _hist_input(case):
    r = np.random.default_rng(5)
    n = 4097
    x = np.abs(r.standard_normal(n)).astype(np.float32) * 3.0
    valid = r.uniform(size=n) < 0.7
    if case == "ties":            # many values exactly on bin edges
        x = (np.round(x * 64) / 64).astype(np.float32)
    if case == "all_zero":        # the degenerate case: sigma -> 1
        x = np.zeros(n, np.float32)
    if case == "none_valid":
        valid[:] = False
    return x, valid


@pytest.mark.parametrize("case", ["normal", "ties", "all_zero",
                                  "none_valid"])
def test_histogram_median_bitwise(case):
    x, valid = _hist_input(case)
    xt, vt = torch.as_tensor(x), torch.as_tensor(valid)
    hi = np.float32(max(float(np.max(np.where(valid, x, 0.0))), 1e-12))
    np.testing.assert_array_equal(
        mestimator.histogram_counts(xt, vt, torch.as_tensor(hi)).numpy(),
        np.asarray(jmest.histogram_counts(jnp.asarray(x), jnp.asarray(valid),
                                          jnp.asarray(hi), 1024)))
    assert (mestimator.masked_median_histogram(xt, vt).numpy()
            == np.asarray(jmest.masked_median_histogram(jnp.asarray(x),
                                                        jnp.asarray(valid))))
    for hist in (True, False):
        want = np.asarray(jmest.estimate_scale(jnp.asarray(x),
                                               jnp.asarray(valid), hist))
        got = mestimator.estimate_scale(xt, vt, hist).numpy()
        assert got.dtype == want.dtype and got == want, (hist, got, want)


def test_bisection_estimator_kept_for_level_gn():
    """The level kernel's plain version keeps the 16-step bisection: its
    sigma is not the histogram one on the same residuals."""
    x, valid = _hist_input("normal")
    xt, vt = torch.as_tensor(x), torch.as_tensor(valid)
    bis = float(mestimator.estimate_scale_bisect(xt, vt))
    exact = float(mestimator.estimate_scale(xt, vt, use_histogram=False))
    assert bis != float(mestimator.estimate_scale(xt, vt))
    np.testing.assert_allclose(bis, exact, rtol=1e-3)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _linearize_problem(desc):
    """tests/test_pallas.py's fused-kernel problem: 120x160 bench scene,
    2048 points; "Intensity3" is the 3-channel stack of scaled copies."""
    rows, cols = 120, 160
    K, baseline, frames = bench.synthesize_sequence(2, rows, cols)
    p = JParams(minSaliency=1.0, numPyramidLevels=1,
                descriptor=(JDesc.BITPLANES if desc == "BitPlanes"
                            else JDesc.INTENSITY))
    cam = jwarp.CameraModel.from_K(K, baseline)
    ch0 = jdesc.compute(jnp.asarray(frames[0][0]), p)
    ch1 = jdesc.compute(jnp.asarray(frames[1][0]), p)
    td = jtd.set_data(ch0, jnp.asarray(frames[0][1]), cam, p, 2048, 0)
    if desc == "Intensity3":
        s = (1.0, 0.5, 2.0)
        td = td._replace(
            pixels=jnp.concatenate([td.pixels * a for a in s]),
            jacobians=jnp.concatenate([td.jacobians * a for a in s]))
        ch1 = jnp.concatenate([ch1 * a for a in s])
    return td, ch1, cam


@pytest.mark.parametrize("desc,interp_name,loss", [
    ("Intensity", "Linear", "Tukey"), ("Intensity", "Cosine", "Huber"),
    ("Intensity3", "Linear", "Tukey"), ("BitPlanes", "Linear", "Tukey")])
def test_fused_linearize_plain_matches_pallas(desc, interp_name, loss):
    """C=1 against ``make_fused_linearize``, C=3 and the C=8 Bit-Planes
    stack against ``make_fused_linearize_stacked``, with the tolerances of
    tests/test_pallas.py:144-150 and :257-266."""
    td, ch1, cam = _linearize_problem(desc)
    C = ch1.shape[0]
    T = jnp.eye(4, dtype=jnp.float32).at[0, 3].set(0.004)
    sigma = 1.7 if desc != "BitPlanes" else 0.2
    ji = JInterp(interp_name)
    Hj, gj, fj, r0j, wj, okj = gn_kernel.fused_linearize(
        td, ch1, cam, T, jnp.asarray(sigma, jnp.float32), loss=JLoss(loss),
        interp=ji, interpret=True, stacked=C > 1)

    ttd = template_from_numpy(_np_template(td), "cpu")
    tcam = camera_from_numpy(cam)
    ti = InterpolationType(interp_name)
    channels = torch.as_tensor(np.array(ch1))
    u, v, Z = warp.project(tcam, torch.as_tensor(np.array(T)), ttd.points)
    ok = ttd.valid & (Z > 1e-6) & interp.valid_mask(u, v, 120, 160, ti)
    before = fl.launch_count
    H, g, f_sq, r0, w = fl.fused_linearize(
        u, v, ok, channels, ttd.pixels, ttd.jacobians,
        torch.tensor(sigma, dtype=torch.float32), LOSSES[loss], ti)
    assert fl.launch_count == before          # CPU: the plain version ran
    # JAX's band did not drop a point here (ROADMAP C.3)
    np.testing.assert_array_equal(np.asarray(okj), ok.numpy())
    np.testing.assert_allclose(r0.numpy(), np.asarray(r0j), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=2e-4,
                               atol=1e-2)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=2e-4,
                               atol=5e-2)
    np.testing.assert_allclose(float(f_sq), float(fj), rtol=1e-3)
    assert r0.shape == (ttd.capacity,) and w.shape == (C, ttd.capacity)


@pytest.mark.parametrize("loss", ["Tukey", "Huber", "L2"])
def test_irls_reduce_plain_matches_pallas(loss):
    """tests/test_pallas.py:59-95's case, M=3000 (not a block multiple)."""
    _check_irls_reduce(loss, 3000)


@pytest.mark.parametrize("M", [1, 255, 257, 1001])
@pytest.mark.parametrize("loss", ["Tukey", "Huber"])
def test_irls_reduce_plain_matches_pallas_at_ragged_sizes(loss, M):
    """The sizes at which the GPU tests hold the kernel to its plain version
    (a ragged last block or tile), here the plain version against Pallas."""
    _check_irls_reduce(loss, M)


def _check_irls_reduce(loss, M):
    r_ = np.random.default_rng(2)
    J = r_.standard_normal((M, 6)).astype(np.float32)
    r = (5.0 * r_.standard_normal(M)).astype(np.float32)
    valid = r_.uniform(size=M) < 0.8
    sigma = jnp.asarray(2.5, jnp.float32)
    Hj, gj, fj, wj = irls_kernel.irls_reduce_w(
        jnp.asarray(J.T), jnp.asarray(r), jnp.asarray(valid), sigma,
        loss=loss, interpret=True)
    args = (torch.as_tensor(J), torch.as_tensor(r), torch.as_tensor(valid),
            torch.tensor(2.5), LOSSES[loss])
    before = irls.launch_count
    H, g, f_sq, w = irls.irls_reduce_w(*args)
    H2, g2, f2 = irls.irls_reduce(*args)
    assert irls.launch_count == before
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=2e-4,
                               atol=1e-2)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=2e-4,
                               atol=1e-2)
    np.testing.assert_allclose(float(f_sq), float(fj), rtol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-6)
    for a, b in ((H2, H), (g2, g), (f2, f_sq)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# gauss_newton.run against JAX's gn.run
# ---------------------------------------------------------------------------

def _gn_problem(C):
    I0, I1, D, cam, T_true = render_pair(TWIST)
    td, _ = build_template(I0, D, cam, capacity=2048)
    ch = jnp.asarray(I1)[None]
    if C == 3:
        s = (1.0, 0.5, 2.0)
        td = td._replace(
            pixels=jnp.concatenate([td.pixels * a for a in s]),
            jacobians=jnp.concatenate([td.jacobians * a for a in s]))
        ch = jnp.concatenate([ch * a for a in s])
    return td, ch, cam, T_true


def _run_both(route, C, loss, monkeypatch, verbose=False):
    td, ch, cam, T_true = _gn_problem(C)
    jopts = jgn.GNOptions(function_tolerance=1e-4, parameter_tolerance=1e-6,
                          loss=JLoss(loss), verbose=verbose)
    if route == "fused":
        jopts = dataclasses.replace(jopts, linearize="fused")
    monkeypatch.setenv("BPVO_IRLS_KERNEL", "force" if route == "irls" else "0")
    st_j = jgn.run(td, ch, cam, jnp.eye(4), jopts)
    st_j.T.block_until_ready()
    ttd = template_from_numpy(_np_template(td), "cpu")
    st_t = gn.run(ttd, torch.as_tensor(np.array(ch)),
                  camera_from_numpy(cam), torch.eye(4),
                  gn_options_from_jax(jopts))
    return st_j, st_t, T_true


@pytest.mark.parametrize("route,C,loss", [
    ("jnp", 1, "Tukey"), ("jnp", 1, "Huber"), ("jnp", 3, "Tukey"),
    ("fused", 1, "Tukey"), ("fused", 3, "Tukey"), ("irls", 3, "Tukey")])
def test_run_matches_jax(route, C, loss, monkeypatch):
    """Pose at atol 1e-5, sigma at rtol 1e-3 (the histogram median of
    residuals that differ by float32 rounding can land one bin apart, a
    1/1024 of max|r|), the same iterations and exit status, the state the
    callers read (f, weights, H) close.  The converged gradient is rounding
    noise in both and is not compared."""
    st_j, st_t, T_true = _run_both(route, C, loss, monkeypatch)
    if route == "fused":       # JAX's band dropped nothing (ROADMAP C.3)
        assert int(st_j.band_overflow) == 0
    np.testing.assert_allclose(st_t.T.numpy(), np.asarray(st_j.T), atol=1e-5)
    # JAX's fused route exits one iteration before its own jnp route on
    # this problem (5 vs 6): its one-hot MXU sampling rounds the residuals
    # otherwise, and the function test sits on that edge
    it_tol = 1 if route == "fused" else 0
    assert abs(int(st_t.num_iters) - int(st_j.num_iters)) <= it_tol
    same_iters = int(st_t.num_iters) == int(st_j.num_iters)
    if same_iters:
        assert int(st_t.status) == int(st_j.status)
    rtol = 1e-3 if same_iters else 1e-2    # else: at another iterate
    assert bool(st_t.converged) and bool(st_j.converged)
    assert int(st_t.num_iters) >= 3
    np.testing.assert_allclose(float(st_t.scale), float(st_j.scale),
                               rtol=rtol)
    np.testing.assert_allclose(float(st_t.f_norm), float(st_j.f_norm),
                               rtol=rtol)
    np.testing.assert_allclose(st_t.H.numpy(), np.asarray(st_j.H),
                               atol=1e-3 * np.abs(np.asarray(st_j.H)).max())
    np.testing.assert_allclose(st_t.weights.numpy(), np.asarray(st_j.weights),
                               atol=5e-3)
    err = np.abs(np.asarray(jnp.asarray(
        st_t.T.numpy() @ np.linalg.inv(T_true)) - np.eye(4))).max()
    assert err < 5e-3


def test_run_verbose_table_matches_jax(monkeypatch, capfd):
    """``verbose`` prints JAX's per-iteration line: the same lines, with
    |F| and sigma at rtol 1e-3; |G| and |dp| shrink to rounding noise as
    the loop converges, so they are held to 1e-2 of their first value."""
    pat = re.compile(r"  it (\d+)  \|F\|=(\S+)  \|G\|=(\S+)  \|dp\|=(\S+)  "
                     r"sigma=(\S+)$")
    capfd.readouterr()
    st_j, _, _ = _run_both("jnp", 1, "Tukey", monkeypatch, verbose=True)
    out = capfd.readouterr().out.splitlines()
    # JAX prints from a host callback: its lines come before the port's
    n = int(st_j.num_iters)
    lines_j, lines_t = out[:n], out[n:]
    assert len(lines_t) == n and n >= 3
    vals = []
    for lj, lt in zip(lines_j, lines_t):
        mj, mt = pat.match(lj), pat.match(lt)
        assert mj and mt, (lj, lt)
        assert mj.group(1) == mt.group(1)
        vals.append([[float(x) for x in m.groups()[1:]] for m in (mj, mt)])
    vj, vt = np.array(vals)[:, 0], np.array(vals)[:, 1]   # (n, 4) each
    for col, (rtol, atol) in enumerate([(1e-3, 0.0), (0.0, 1e-2 * vj[0, 1]),
                                        (0.0, 1e-2 * vj[0, 2]),
                                        (1e-3, 0.0)]):
        np.testing.assert_allclose(vt[:, col], vj[:, col], rtol=rtol,
                                   atol=atol)


def test_run_max_iterations_zero_returns_initial_state():
    td, ch, cam, _ = _gn_problem(1)
    ttd = template_from_numpy(_np_template(td), "cpu")
    opts = gn.GNOptions(max_iterations=0)
    st = gn.run(ttd, torch.as_tensor(np.array(ch)), camera_from_numpy(cam),
                torch.eye(4), opts)
    assert int(st.num_iters) == 0 and not bool(st.converged)
    assert torch.equal(st.T, torch.eye(4))
    assert float(st.scale) == 1.0 and st.weights.shape == (1, 2048)


def test_linearize_fn_override():
    """A custom linearization (the hook the sharded path uses) replaces the
    default one and sees the host flag ``do_est``."""
    td, ch, cam, _ = _gn_problem(1)
    ttd = template_from_numpy(_np_template(td), "cpu")
    channels = torch.as_tensor(np.array(ch))
    tcam = camera_from_numpy(cam)
    opts = gn.GNOptions(function_tolerance=1e-4, parameter_tolerance=1e-6)
    seen = []

    def lin(T, scale, delta_scale, do_est):
        seen.append(do_est)
        return gn._linearize(ttd, channels, tcam, T, scale, delta_scale,
                             do_est, opts)

    st = gn.run(ttd, channels, tcam, torch.eye(4), opts, linearize_fn=lin)
    st_ref = gn.run(ttd, channels, tcam, torch.eye(4), opts)
    assert seen[0] is True and len(seen) == int(st.num_iters)
    np.testing.assert_allclose(st.T.numpy(), st_ref.T.numpy(), atol=1e-5)


@pytest.mark.parametrize("change", [
    {"interp": InterpolationType.CUBIC}, {"warp": "DisparitySpace"}])
def test_run_unported_options_raise(change):
    """CUBIC sampling and the DisparitySpace warp, once refused, now take
    ``run``'s gather route: pose at atol 1e-5 of JAX's jnp route, the same
    iterations and exit status (the DisparitySpace case builds its template
    with that warp)."""
    I0, I1, D, cam, _ = render_pair(TWIST)
    jp = JParams(minSaliency=2.0, warpType=change.get("warp", "RigidBody"))
    td, _ = build_template(I0, D, cam, p=jp)
    jopts = dataclasses.replace(
        jgn.GNOptions(function_tolerance=1e-4, parameter_tolerance=1e-6),
        **{k: JInterp(v.value) if k == "interp" else v
           for k, v in change.items()})
    ch = jnp.asarray(I1)[None]
    st_j = jgn.run(td, ch, cam, jnp.eye(4), jopts)
    st_t = gn.run(template_from_numpy(_np_template(td), "cpu"),
                  torch.as_tensor(np.array(ch)), camera_from_numpy(cam),
                  torch.eye(4), gn_options_from_jax(jopts))
    np.testing.assert_allclose(st_t.T.numpy(), np.asarray(st_j.T), atol=1e-5)
    assert int(st_t.num_iters) == int(st_j.num_iters) >= 2
    assert int(st_t.status) == int(st_j.status)


@pytest.mark.parametrize("change,K,want", [
    ({}, 16384, True), ({}, 16385, False), ({"verbose": True}, 512, False),
    ({"interp": InterpolationType.CUBIC}, 512, False),
    ({"warp": "DisparitySpace"}, 512, False),
    ({"loss": LossFunctionType.L2}, 512, True)])
def test_level_kernel_supported(change, K, want):
    opts = dataclasses.replace(gn.GNOptions(), **change)
    assert gn.level_kernel_supported(opts, 1, 376, 1241, K) is want
