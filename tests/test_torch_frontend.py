"""Port front end against bpvo_tpu at 120x160 over 3 pyramid levels:
pyrDown, saliency, strict local maxima (atol 1e-4), pixel selection (equal
(row, col) sets), template build (rtol 1e-5 after a raster sort) and warped
sampling for LINEAR and COSINE (atol 1e-4; residuals of points whose
projection rounds differently by 1 ulp at atol 1e-3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpvo_tpu.config import AlgorithmParameters as JParams
from bpvo_tpu.core import se3 as jse3
from bpvo_tpu.ops import descriptors as jdesc
from bpvo_tpu.ops import imgproc as jimg
from bpvo_tpu.ops import interp as jinterp
from bpvo_tpu.ops import selection as jsel
from bpvo_tpu.types import InterpolationType as JInterp
from bpvo_tpu.vo import template_data as jtd
from bpvo_tpu.vo import warp as jwarp
from bpvo_tpu_torch.config import AlgorithmParameters
from bpvo_tpu_torch.ops import descriptors, imgproc, interp, pyramid, selection
from bpvo_tpu_torch.types import DescriptorType, InterpolationType
from bpvo_tpu_torch.utils.convert import camera_from_numpy, template_from_numpy
from bpvo_tpu_torch.vo import template_data as td_mod
from bpvo_tpu_torch.vo import warp
from conftest import synthetic_image
from test_gn import build_template, render_pair

N_LEVELS = 3
TWIST = [0.001, -0.002, 0.001, 0.01, -0.005, 0.015]


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _pyramids(image):
    """The image pyramid through both packages, level by level from the
    same input."""
    j, t = [jnp.asarray(image)], [_t(image)]
    for _ in range(1, N_LEVELS):
        j.append(jimg.pyr_down(j[-1]))
        t.append(imgproc.pyr_down(_t(np.asarray(j[-2]))))
    return j, t


def test_pyr_down_and_level_shapes():
    j, t = _pyramids(synthetic_image())
    shapes = pyramid.level_shapes(120, 160, N_LEVELS)
    for a, b, shape in zip(j, t, shapes):
        assert tuple(b.shape) == shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    # odd sizes take the reflect-101 border at the far edge
    odd = synthetic_image(47, 79, seed=3)
    np.testing.assert_allclose(imgproc.pyr_down(_t(odd)).numpy(),
                               np.asarray(jimg.pyr_down(jnp.asarray(odd))),
                               atol=1e-4)


def test_saliency_and_local_max():
    j, _ = _pyramids(synthetic_image())
    for level in range(N_LEVELS):
        img = np.asarray(j[level])
        sal_j = np.asarray(jdesc.saliency(jdesc.intensity(jnp.asarray(img))))
        sal_t = descriptors.saliency(descriptors.intensity(_t(img))).numpy()
        np.testing.assert_allclose(sal_t, sal_j, atol=1e-4)
        for r in (0, 1, 2):
            np.testing.assert_array_equal(
                imgproc.is_local_max(_t(sal_j), r).numpy(),
                np.asarray(jimg.is_local_max(jnp.asarray(sal_j), r)))


def test_disparity_at_level():
    D = np.random.default_rng(0).uniform(1, 30, (120, 160)).astype(np.float32)
    for level in range(N_LEVELS):
        np.testing.assert_array_equal(
            imgproc.disparity_at_level(_t(D), level).numpy(),
            np.asarray(jimg.disparity_at_level(jnp.asarray(D), level)))


def test_descriptor_compute_intensity_only():
    """Intensity and Bit-Planes through the factory; LATCH, once refused,
    too: bitwise JAX's on this image (the comparison bits have no tie
    here; tests/test_torch_zoo.py holds the bits to 99.9% in general)."""
    img = _t(synthetic_image())
    p = AlgorithmParameters()
    assert descriptors.compute(img, p).shape == (1, 120, 160)
    bp = descriptors.compute(img, p.replace(
        descriptor=DescriptorType.BITPLANES))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(jdesc.bitplanes(
        jnp.asarray(img.numpy()), p.sigmaPriorToCensusTransform,
        p.sigmaBitPlanes)))
    latch = descriptors.compute(img, p.replace(
        descriptor=DescriptorType.LATCH))
    np.testing.assert_array_equal(latch.numpy(), np.asarray(jdesc.latch(
        jnp.asarray(img.numpy()), p.latchNumBytes, p.latchHalfSsdSize)))


def _raster(rows, cols, valid, W):
    key = np.asarray(rows)[valid] * W + np.asarray(cols)[valid]
    return np.sort(key), np.argsort(key)


@pytest.mark.parametrize("use_nms,capacity", [(False, 2048), (True, 1024),
                                              (False, 20000)])
def test_select_pixels_same_set(use_nms, capacity):
    I0, _, D, _, _ = render_pair(TWIST)
    if use_nms:
        # the analytic texture has few strict local maxima; the noisy image
        # has more than the capacity
        I0 = synthetic_image()
    sal = np.asarray(jdesc.saliency(jdesc.intensity(jnp.asarray(I0))))
    kw = dict(min_saliency=2.0, nms_radius=1, use_nms=use_nms,
              min_disparity=0.001, max_disparity=512.0, border=3)
    cap = min(capacity, sal.size)
    sj = jsel.select_pixels(jnp.asarray(sal), jnp.asarray(D), cap, **kw)
    st = selection.select_pixels(_t(sal), _t(D), cap, **kw)
    vj, vt = np.asarray(sj.valid), st.valid.numpy()
    assert vj.sum() == vt.sum() == int(st.num_valid) > 200
    kj, oj = _raster(sj.rows, sj.cols, vj, 160)
    kt, ot = _raster(st.rows.numpy(), st.cols.numpy(), vt, 160)
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(st.disparity.numpy()[vt][ot],
                                  np.asarray(sj.disparity)[vj][oj])
    # the port keeps valid points in front, in raster order
    n = int(st.num_valid)
    assert vt[:n].all() and not vt[n:].any()
    assert np.all(np.diff(st.rows.numpy()[:n] * 160 + st.cols.numpy()[:n]) > 0)


def test_capacity_for_level():
    p = AlgorithmParameters(pointCapacity=2048)
    for level, (r, c) in enumerate(pyramid.level_shapes(120, 160, 4)):
        assert selection.capacity_for_level(p, r, c, level) == \
            jsel.capacity_for_level(JParams(pointCapacity=2048), r, c, level)


@pytest.mark.parametrize("level", range(N_LEVELS))
def test_set_data_matches(level):
    I0, _, D, cam_j, _ = render_pair(TWIST)
    j_pyr, _ = _pyramids(I0)
    ch = np.asarray(j_pyr[level])[None]
    D_l = np.asarray(jimg.disparity_at_level(jnp.asarray(D), level))
    D_l = D_l[:ch.shape[1], :ch.shape[2]]
    jp = JParams(minSaliency=2.0)
    cap = jsel.capacity_for_level(jp, ch.shape[1], ch.shape[2], level) // 8
    tj = jtd.set_data(jnp.asarray(ch), jnp.asarray(D_l), cam_j.at_level(level),
                      jp, cap, level)
    tt = td_mod.set_data(_t(ch), _t(D_l),
                         camera_from_numpy(cam_j.at_level(level)),
                         AlgorithmParameters(minSaliency=2.0), cap, level)
    vj, vt = np.asarray(tj.valid), tt.valid.numpy()
    W = ch.shape[2]
    kj, oj = _raster(tj.rows, tj.cols, vj, W)
    kt, ot = _raster(tt.rows.numpy(), tt.cols.numpy(), vt, W)
    np.testing.assert_array_equal(kt, kj)
    for name in ("points", "pixels", "jacobians"):
        a = getattr(tt, name).numpy()
        b = np.asarray(getattr(tj, name))
        if name == "points":
            a, b = a[vt][ot], b[vj][oj]
        else:
            a, b = a[:, vt][:, ot], b[:, vj][:, oj]
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())
    np.testing.assert_allclose(float(tt.norm_scale), float(tj.norm_scale),
                               rtol=1e-5)
    np.testing.assert_allclose(tt.norm_center.numpy(),
                               np.asarray(tj.norm_center), rtol=1e-5,
                               atol=1e-6)
    # padding slots carry the finite dummy point (0, 0, 1)
    pad = tt.points.numpy()[~vt]
    assert np.all(pad == np.array([0, 0, 1], np.float32))


@pytest.mark.parametrize("method", [InterpolationType.LINEAR,
                                    InterpolationType.COSINE])
def test_sample_and_residuals(method):
    I0, I1, D, cam_j, _ = render_pair(TWIST)
    tj, _ = build_template(I0, D, cam_j, capacity=2048)
    tt = template_from_numpy({k: np.asarray(v)
                              for k, v in tj._asdict().items()}, "cpu")
    jm = JInterp(method.value)
    T = np.asarray(jse3.exp(jnp.asarray([0.001, -0.001, 0.0005, 0.01, 0.0,
                                         -0.02], jnp.float32)))
    ch = I1[None]
    rj, okj = jtd.compute_residuals(tj, jnp.asarray(ch), cam_j,
                                    jnp.asarray(T), jm)
    rt, okt = td_mod.compute_residuals(tt, _t(ch), camera_from_numpy(cam_j),
                                       _t(T), method)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.sum() > 500
    # residuals at atol 1e-4 where both packages project a point to the
    # bitwise same (u, v); the others differ by 1 ulp of u or v (the
    # (K,3)@(3,3) products round differently), which the scene's gradients
    # of up to ~60 grey levels/px turn into up to ~1e-3
    uj, vj, _ = jwarp.project(cam_j, jnp.asarray(T), tj.points)
    ut, vt, _ = warp.project(camera_from_numpy(cam_j), _t(T), tt.points)
    same = (ut.numpy() == np.asarray(uj)) & (vt.numpy() == np.asarray(vj))
    np.testing.assert_allclose(rt.numpy()[:, same], np.asarray(rj)[:, same],
                               atol=1e-4)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-3)
    # sampling off-grid points, including out-of-bounds ones
    r = np.random.default_rng(5)
    u = r.uniform(-3, 163, 500).astype(np.float32)
    v = r.uniform(-3, 123, 500).astype(np.float32)
    mj = jinterp.valid_mask(jnp.asarray(u), jnp.asarray(v), 120, 160, jm)
    mt = interp.valid_mask(_t(u), _t(v), 120, 160, method)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(
        interp.sample(_t(ch), _t(u), _t(v), mt, method).numpy(),
        np.asarray(jinterp.sample(jnp.asarray(ch), jnp.asarray(u),
                                  jnp.asarray(v), mj, jm)), atol=1e-4)
