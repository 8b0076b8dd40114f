"""The port's level_gn (its plain PyTorch version, which the wrapper takes
for CPU tensors) against the JAX level kernel run as tests/test_pallas.py
runs it: ``make_level_gn(..., interpret=True)`` on the CPU.  Both get the very
same template, carried across with ``template_from_numpy``, so a difference
in selection order cannot mask a difference in the solve."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpvo_tpu.config import AlgorithmParameters as JParams
from bpvo_tpu.ops import descriptors as jdesc
from bpvo_tpu.ops.pallas import level_gn_kernel as lk
from bpvo_tpu.solver import gauss_newton as jgn
from bpvo_tpu.solver import mestimator as jmest
from bpvo_tpu.types import InterpolationType as JInterp
from bpvo_tpu.types import LossFunctionType as JLoss
from bpvo_tpu.vo import template_data as jtd
from bpvo_tpu_torch.ops import level_gn as lg
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.types import InterpolationType, LossFunctionType
from bpvo_tpu_torch.utils.convert import camera_from_numpy, template_from_numpy
from test_gn import H_IMG, W_IMG, build_template, render_pair

TWIST = [0.001, -0.002, 0.001, 0.01, -0.005, 0.015]


def _np_template(td):
    return {k: np.asarray(v) for k, v in td._asdict().items()}


def _stack3(td, I1):
    """Scaled 3-channel copies (as test_pallas.py's multichannel cases)."""
    ch = jnp.stack([jnp.asarray(I1), jnp.asarray(I1) * 0.5,
                    jnp.asarray(I1) * 2.0])
    return td._replace(
        pixels=jnp.concatenate([td.pixels, td.pixels * 0.5, td.pixels * 2.0]),
        jacobians=jnp.concatenate([td.jacobians, td.jacobians * 0.5,
                                   td.jacobians * 2.0])), ch


def _bitplanes(I0, I1, D, cam, K):
    """The Bit-Planes template of I0 and channels of I1 (sigma_ct 0.5,
    sigma_bp 0.5, as conf/kitti_bitplanes.cfg)."""
    ch0 = jdesc.bitplanes(jnp.asarray(I0), 0.5, 0.5)
    td = jtd.set_data(ch0, jnp.asarray(D), cam, JParams(minSaliency=0.05),
                      K, 0)
    return td, jdesc.bitplanes(jnp.asarray(I1), 0.5, 0.5)


@functools.lru_cache(maxsize=None)
def _run_both(K=1024, C=1, max_iterations=42, loss=LossFunctionType.TUKEY,
              interp=InterpolationType.LINEAR):
    """(JAX outputs, port outputs, (JAX template, channels, camera)) for one
    level solve from the identity pose; cached per configuration.  C=8 is
    the Bit-Planes descriptor."""
    I0, I1, D, cam, _ = render_pair(TWIST)
    td, _ = build_template(I0, D, cam, capacity=K)
    ch = jnp.asarray(I1)[None]
    if C == 3:
        td, ch = _stack3(td, I1)
    if C == 8:
        td, ch = _bitplanes(I0, I1, D, cam, K)
    jopts = jgn.GNOptions(function_tolerance=1e-4, parameter_tolerance=1e-6,
                          max_iterations=max_iterations,
                          loss=JLoss(loss.value), interp=JInterp(interp.value))
    run = lk.make_level_gn(I1.shape[0], I1.shape[1], C, K, jopts,
                           interpret=True)
    out_j = jax.jit(run)(cam, td.points, td.valid, td.pixels, td.jacobians, ch,
                         jnp.eye(4, dtype=jnp.float32),
                         jnp.asarray(1.0, jnp.float32),
                         jnp.asarray(1e10, jnp.float32), td.norm_scale,
                         td.norm_center)
    out_j = [np.asarray(a) for a in out_j]

    ttd = template_from_numpy(_np_template(td), "cpu")
    topts = gn.GNOptions(function_tolerance=1e-4, parameter_tolerance=1e-6,
                         max_iterations=max_iterations, loss=loss,
                         interp=interp,
                         scale_tolerance_rel=jopts.scale_tolerance_rel)
    before = lg.launch_count
    out_t = lg.level_gn(camera_from_numpy(cam), ttd.points, ttd.valid,
                        ttd.pixels, ttd.jacobians,
                        torch.as_tensor(np.array(ch)), torch.eye(4), 1.0,
                        1e10, ttd.norm_scale, ttd.norm_center, topts)
    assert lg.launch_count == before      # CPU tensors: no kernel launch
    return out_j, [a.numpy() for a in out_t], (td, ch, cam)


CASES = {
    "c1_tukey": {},
    "c3_tukey": {"C": 3},
    "c1_huber": {"loss": LossFunctionType.HUBER},
    "c1_cosine": {"interp": InterpolationType.COSINE},
    "c8_bitplanes_huber": {"C": 8, "loss": LossFunctionType.HUBER},
}


@pytest.mark.parametrize("case", CASES)
def test_first_linearization_matches_jax_kernel(case):
    """One iteration: the same residuals, sigma, weights and normal
    equations, and the same pose update."""
    (Tj, sj, Hj, gj, wj, _), (Tt, st, Ht, gt, wt, bo), _ = _run_both(
        max_iterations=1, **CASES[case])
    np.testing.assert_allclose(Tt, Tj, atol=1e-5)
    np.testing.assert_array_equal(st[[0, 3, 6, 7]], sj[[0, 3, 6, 7]])
    np.testing.assert_allclose(st[4], sj[4], rtol=1e-4)       # sigma
    # rtol 1e-4 per entry, floored at 1e-4 of the largest entry for the
    # off-diagonal terms that nearly cancel
    np.testing.assert_allclose(Ht, Hj, rtol=1e-4, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())
    # 3e-5: the C=3 stack's 2x-scaled channel doubles the f32 rounding of
    # its residuals (measured 1.5e-5; 1e-5 holds for C=1)
    np.testing.assert_allclose(wt, wj, atol=3e-5)
    assert int(bo) == 0 and st[0] == 1


@pytest.mark.parametrize("case", CASES)
def test_converged_solve_matches_jax_kernel(case):
    """The whole IRLS loop: same pose, iterations and exit status.

    Past the first iteration the two implementations differ by float32
    rounding (~1e-7 in the pose), and on this noise-free scene the converged
    median residual is ~0.07 grey levels, so the bisection median moves by
    up to ~0.5% between them.  Hence sigma/H/w are held at 1e-2 here (the
    first-linearization test holds them tightly), and the Huber case, whose
    function test sits on that knife edge, may exit one iteration apart."""
    (Tj, sj, Hj, gj, wj, _), (Tt, st, Ht, gt, wt, bo), _ = _run_both(
        **CASES[case])
    np.testing.assert_allclose(Tt, Tj, atol=1e-5)
    it_tol = 1 if case == "c1_huber" else 0
    assert abs(st[0] - sj[0]) <= it_tol, (st, sj)
    if st[0] == sj[0]:
        assert st[3] == sj[3], (st, sj)
    assert st[6] == sj[6] == 1.0 and st[7] == sj[7] == 1.0
    assert st[0] >= 3
    np.testing.assert_allclose(st[4], sj[4], rtol=1e-2)
    np.testing.assert_allclose(Ht, Hj, atol=1e-2 * np.abs(Hj).max())
    np.testing.assert_allclose(wt, wj, atol=1e-2)
    assert int(bo) == 0


def test_one_iteration_sigma_matches_mestimator():
    """With one iteration, the exported sigma is the estimate from the
    identity-pose residuals: it must match the exact (sorted) median scale
    (the check of test_pallas.py::test_sigma_matches_mestimator)."""
    out_j, out_t, (td, ch, cam) = _run_both(max_iterations=1)
    r, valid = jtd.compute_residuals(td, ch, cam, jnp.eye(4),
                                     JInterp.LINEAR)
    sigma_ref = float(jmest.estimate_scale(r[0], valid, use_histogram=False))
    assert sigma_ref > 5e-3 and abs(sigma_ref - 1.0) > 0.1, sigma_ref
    np.testing.assert_allclose(out_t[1][4], sigma_ref, rtol=2e-2)


def test_k4096_matches_jax_banded_kernel():
    """K=4096 runs JAX's banded variant; its band drops nothing here
    (asserted), so the port's unbanded solve must land on the same pose."""
    assert lk._variant(H_IMG, W_IMG, 1, 4096) == "banded"
    out_j, out_t, _ = _run_both(K=4096)
    assert int(out_j[5]) == 0
    np.testing.assert_allclose(out_t[0], out_j[0], atol=1e-4)


def test_run_level_state():
    """gauss_newton.run_level returns the kernel's result as a GNState."""
    I0, I1, D, cam, _ = render_pair(TWIST)
    td, _ = build_template(I0, D, cam, capacity=1024)
    ttd = template_from_numpy(_np_template(td), "cpu")
    opts = gn.GNOptions(function_tolerance=1e-4, parameter_tolerance=1e-6,
                        max_iterations=42)
    st = gn.run_level(ttd, torch.as_tensor(I1)[None], camera_from_numpy(cam),
                      torch.eye(4), opts)
    assert st.weights.shape == (1, 1024) and st.H.shape == (6, 6)
    assert bool(st.converged) and bool(st.solver_ok)
    assert int(st.num_iters) >= 2 and int(st.band_overflow) == 0
    frac = gn.fraction_of_good_points(st.weights, ttd.num_channels,
                                      ttd.num_valid, 0.85)
    assert 0.3 < float(frac) <= 1.0


@pytest.mark.parametrize("change", [
    {"interp": InterpolationType.CUBIC}, {"verbose": True},
    {"warp": "DisparitySpace"}])
def test_unported_options_raise(change):
    I0, I1, D, cam, _ = render_pair(TWIST)
    td, _ = build_template(I0, D, cam, capacity=1024)
    ttd = template_from_numpy(_np_template(td), "cpu")
    opts = dataclasses.replace(gn.GNOptions(), **change)
    with pytest.raises(NotImplementedError):
        gn.run_level(ttd, torch.as_tensor(I1)[None], camera_from_numpy(cam),
                     torch.eye(4), opts)


# ---------------------------------------------------------------------------
# the kernel's median search: 4 rounds of 4 bisection depths
# ---------------------------------------------------------------------------

def _median_inputs(case, n, seed=0):
    """(a, valid): n valid |residuals| of the kind ``case`` among ~n/3
    larger invalid ones (n=1: the single-valid mask)."""
    r = np.random.default_rng(seed + n)
    m = n + n // 3 + 1
    if case == "continuous":
        a = np.abs(r.standard_normal(m)) * 7.3
    elif case == "tied_bitplanes_25":   # smoothed census bits: k/25
        a = r.integers(0, 26, m) / 25.0
    elif case == "tied_bitplanes_9":    # k/9
        a = r.integers(0, 10, m) / 9.0
    else:                               # amax 0
        a = np.zeros(m)
    valid = np.zeros(m, bool)
    valid[r.permutation(m)[:n]] = True
    a = np.where(valid, a, 10.0 + np.abs(r.standard_normal(m)))
    return (torch.as_tensor(a.astype(np.float32)), torch.as_tensor(valid))


def _bits(x):
    return x.reshape(1).view(torch.int32)


@pytest.mark.parametrize("case", ["continuous", "tied_bitplanes_25",
                                  "tied_bitplanes_9", "amax_zero"])
@pytest.mark.parametrize("n", [1, 2, 3, 6, 7, 100, 1001, 4096, 12345, 20000])
def test_median_rounds_equal_sequential_bisection(case, n):
    """lo, hi, median and n of the 4-depths-per-round search equal the
    16-step sequential bisection's bit for bit."""
    from bpvo_tpu_torch.solver import mestimator
    a, valid = _median_inputs(case, n)
    med, cnt, lo, hi = lg.median_rounds(a, valid)
    lo_s, hi_s, cnt_s = mestimator.bisect_interval(a, valid)
    med_s, _ = mestimator.median_bisect(a, valid)
    for x, y in ((lo, lo_s), (hi, hi_s), (med, med_s), (cnt, cnt_s)):
        assert torch.equal(_bits(x), _bits(y)), (x, y)
    assert float(cnt) == n
    if case == "amax_zero":
        assert float(med) == 0.0


@pytest.mark.parametrize("mask", ["all_invalid", "single_valid_first",
                                  "single_valid_last"])
def test_median_rounds_degenerate_masks(mask):
    a = torch.as_tensor(np.random.default_rng(3).uniform(
        0, 5, 777).astype(np.float32))
    valid = torch.zeros(777, dtype=torch.bool)
    if mask != "all_invalid":
        valid[0 if mask.endswith("first") else -1] = True
    from bpvo_tpu_torch.solver import mestimator
    med, n, lo, hi = lg.median_rounds(a, valid)
    lo_s, hi_s, n_s = mestimator.bisect_interval(a, valid)
    assert torch.equal(_bits(lo), _bits(lo_s))
    assert torch.equal(_bits(hi), _bits(hi_s))
    assert torch.equal(_bits(med), _bits(mestimator.median_bisect(a,
                                                                  valid)[0]))
    assert float(n) == float(n_s) == int(valid.sum())
    if mask == "all_invalid":
        assert float(med) == 0.0
    else:   # the single value, to the bisection's resolution max(a)/2^16
        x = float(a[valid][0])
        assert x <= float(med) <= x * (1 + 2.0 ** -15)


@pytest.mark.parametrize("case", CASES)
def test_median_rounds_sigma_matches_jax_kernel(case):
    """The round-wise search on the port's first residuals gives the plain
    version's sigma (which runs it) and the JAX level kernel's sigma, bit
    for bit (the residuals agree to the last bit here, ties included)."""
    (_, sj, _, _, _, _), (_, st, _, _, _, _), (td, ch, cam) = _run_both(
        max_iterations=1, **CASES[case])
    cfg = CASES[case]
    ttd = template_from_numpy(_np_template(td), "cpu")
    ok, r = lg._linearize(
        camera_from_numpy(cam), ttd.points, ttd.valid, ttd.pixels,
        torch.as_tensor(np.array(ch)), torch.eye(4),
        cfg.get("interp") == InterpolationType.COSINE)
    sigma = float(lg.estimate_scale(r[0], ok))
    assert sigma == float(st[4]) == float(sj[4])
