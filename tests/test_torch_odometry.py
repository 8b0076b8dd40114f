"""The port's public ``VisualOdometry`` against the JAX package's on the CPU,
the level routing of ``DeviceVO`` and ``VisualOdometry``
(``gauss_newton.level_kernel_supported``), and the committed dense-VO
reference that chip_smoke.py holds the GPU run to."""
import os

import numpy as np
import pytest

from bpvo_tpu import AlgorithmParameters as JParams
from bpvo_tpu import VisualOdometry as JVisualOdometry
from bpvo_tpu.types import VerbosityType as JVerbosity
from bpvo_tpu.vo.device_vo import DeviceVO as JDeviceVO
from bpvo_tpu_torch import (AlgorithmParameters, DescriptorType,
                            VerbosityType, VisualOdometry)
from bpvo_tpu_torch.data import synthetic
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.vo.device_vo import DeviceVO
from bpvo_tpu_torch.vo.point_cloud import read_ply, write_ply
from test_gn import H_IMG, W_IMG, make_cam
from test_odometry import make_sequence

STEP = [0, 0, 0, 0.004, 0, 0.008]
# 0.009 m per frame against a 0.015 m threshold: every second frame is a
# keyframe, and each finds a candidate to re-estimate against
KW = dict(minSaliency=2.0, numPyramidLevels=3, functionTolerance=1e-4,
          parameterTolerance=1e-6, maxIterations=50, pointCapacity=2048,
          minTranslationMagToKeyFrame=0.015)
DENSE_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "torch_port_dense_ref.npz")


@pytest.fixture(scope="module")
def frames():
    return make_sequence(STEP, 6)


def _both(frames, jkw=None, tkw=None):
    cam = make_cam()
    K, b = np.asarray(cam.K()), float(cam.baseline)
    jvo = JVisualOdometry(K, b, (H_IMG, W_IMG), JParams(**KW, **(jkw or {})))
    tvo = VisualOdometry(K, b, (H_IMG, W_IMG),
                         AlgorithmParameters(**KW, **(tkw or {})),
                         device="cpu")
    return jvo, tvo, [(jvo.add_frame(I, D), tvo.add_frame(I, D))
                      for I, D in frames]


def _check_results(jvo, tvo, results, pose_atol, it_tol):
    n_kf = 0
    for rj, rt in results:
        assert rt.is_keyframe == rj.is_keyframe
        assert rt.keyframing_reason.value == rj.keyframing_reason.value
        np.testing.assert_allclose(rt.pose, rj.pose, atol=pose_atol)
        assert len(rt.optimizer_statistics) == len(rj.optimizer_statistics)
        for sj, st in zip(rj.optimizer_statistics, rt.optimizer_statistics):
            assert abs(st.num_iterations - sj.num_iterations) <= it_tol
            if st.num_iterations == sj.num_iterations:
                assert st.status.value == sj.status.value
            np.testing.assert_allclose(st.final_error, sj.final_error,
                                       rtol=1e-2)
        assert rt.covariance.shape == (6, 6)
        np.testing.assert_allclose(rt.covariance, rj.covariance,
                                   atol=2e-2 * np.abs(rj.covariance).max())
        assert (rt.point_cloud is None) == (rj.point_cloud is None)
        if rj.point_cloud is not None:
            n_kf += 1
            pj, pt = rj.point_cloud, rt.point_cloud
            # the same number of points and nearly the same set: the two
            # selections' top-K keep different pixels among equal saliencies
            # at the capacity boundary (ROADMAP C.4; 6 of 2048 at L0 here)
            assert len(pt) == len(pj)
            sj, st = (set(map(tuple, np.round(c.points, 4))) for c in (pj, pt))
            assert len(sj ^ st) <= 0.01 * len(pj), len(sj ^ st)
            assert abs(float(pt.colors[:, 0].mean())
                       - float(pj.colors[:, 0].mean())) < 1.0
            assert abs(float(pt.weights.mean()) - float(pj.weights.mean())) \
                < 0.01
            np.testing.assert_allclose(pt.pose, pj.pose, atol=pose_atol * 10)
    assert n_kf >= 2
    assert len(tvo.trajectory) == len(jvo.trajectory) == len(results)
    np.testing.assert_allclose(np.stack(tvo.trajectory.poses),
                               np.stack(jvo.trajectory.poses),
                               atol=pose_atol * 10)
    for level in range(3):
        assert tvo.num_points_at_level(level) == jvo.num_points_at_level(
            level)


def test_visual_odometry_whole_route_matches_jax(monkeypatch, frames):
    """Every level of the port on ``gauss_newton.run`` (the level-kernel
    bound patched to 0), as every level of JAX's CPU route: poses at atol
    1e-5 (measured 5e-6), the same keyframes and reasons.  The templates
    differ in a few L0 points (ROADMAP C.4), so a level's function test can
    fire one iteration apart (measured: 2 of 44 level solves)."""
    monkeypatch.setattr(gn, "MAX_LEVEL_KERNEL_POINTS", 0)
    jvo, tvo, results = _both(frames)
    _check_results(jvo, tvo, results, pose_atol=1e-5, it_tol=1)


def test_visual_odometry_level_kernel_route_matches_jax(monkeypatch, frames):
    """The port's own routing puts these levels (K <= 2048) on
    ``level_gn``; JAX takes the level kernel too under
    ``BPVO_LEVEL_KERNEL=force`` (interpret mode): poses at the PR 1 kind of
    cross-implementation tolerance, iterations within 1 (ROADMAP C(a))."""
    monkeypatch.setenv("BPVO_LEVEL_KERNEL", "force")
    jvo, tvo, results = _both(frames)
    _check_results(jvo, tvo, results, pose_atol=1e-4, it_tol=1)


def _count_routes(monkeypatch):
    calls = {"run": 0, "run_level": 0}
    for name in calls:
        fn = getattr(gn, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(gn, name, counted)
    return calls


def test_device_vo_routes_levels_beyond_the_bound_to_run(monkeypatch,
                                                          frames):
    """With the bound below L0's 2048 points, every L0 solve goes through
    ``gauss_newton.run`` and the coarse levels (512 points) still through
    ``run_level``; the poses stay with the unpatched run's."""
    cam = make_cam()
    K, b = np.asarray(cam.K()), float(cam.baseline)
    ref = DeviceVO(K, b, (H_IMG, W_IMG), AlgorithmParameters(**KW),
                   device="cpu")
    want = [ref.add_frame(I, D) for I, D in frames[:4]][1:]
    monkeypatch.setattr(gn, "MAX_LEVEL_KERNEL_POINTS", 1024)
    calls = _count_routes(monkeypatch)
    vo = DeviceVO(K, b, (H_IMG, W_IMG), AlgorithmParameters(**KW),
                  device="cpu")
    assert vo._capacities == (2048, 512, 512)
    outs = [vo.add_frame(I, D) for I, D in frames[:4]][1:]
    n_kf = sum(int(o.is_keyframe) for o in outs)
    # one L0 solve per step and per keyframe re-estimate; two coarse levels
    # per step and one (L1) per re-estimate from keyframeReestimateStartLevel
    assert calls["run"] == len(outs) + n_kf
    assert calls["run_level"] == 2 * len(outs) + n_kf
    for o, w in zip(outs, want):
        np.testing.assert_allclose(o.pose.numpy(), w.pose.numpy(), atol=1e-4)


def test_visual_odometry_routes_levels_beyond_the_bound_to_run(monkeypatch,
                                                               frames):
    monkeypatch.setattr(gn, "MAX_LEVEL_KERNEL_POINTS", 1024)
    calls = _count_routes(monkeypatch)
    cam = make_cam()
    vo = VisualOdometry(np.asarray(cam.K()), float(cam.baseline),
                        (H_IMG, W_IMG), AlgorithmParameters(**KW),
                        device="cpu")
    res = [vo.add_frame(I, D) for I, D in frames[:3]][1:]
    n_kf = sum(r.is_keyframe for r in res)
    assert calls["run"] == len(res) + n_kf
    assert calls["run_level"] == 2 * len(res) + n_kf


def test_device_vo_verbose_runs_and_matches_jax(frames, capfd):
    """``verbosity=Iteration`` used to raise in the level kernel's check;
    it now routes every level to ``gauss_newton.run``, which prints one line
    per iteration, and follows JAX's DeviceVO (whose CPU route is
    ``gn.run`` at every level): poses at atol 1e-5, per-level iterations
    within 1 as in the whole-route VisualOdometry test (ROADMAP C.4)."""
    cam = make_cam()
    K, b = np.asarray(cam.K()), float(cam.baseline)
    jvo = JDeviceVO(K, b, (H_IMG, W_IMG),
                    JParams(**KW, verbosity=JVerbosity.ITERATION))
    tvo = DeviceVO(K, b, (H_IMG, W_IMG),
                   AlgorithmParameters(**KW,
                                       verbosity=VerbosityType.ITERATION),
                   device="cpu")
    capfd.readouterr()
    outs_j = [jvo.add_frame(I, D) for I, D in frames[:4]]
    np.asarray(outs_j[-1].pose)
    n_j = capfd.readouterr().out.count("  it ")
    outs_t = [tvo.add_frame(I, D) for I, D in frames[:4]]
    n_t = capfd.readouterr().out.count("  it ")
    assert n_t > 0 and n_j > 0 and abs(n_t - n_j) <= 2, (n_t, n_j)
    assert outs_j[0] is None and outs_t[0] is None
    for oj, ot in zip(outs_j[1:], outs_t[1:]):
        np.testing.assert_allclose(ot.pose.numpy(), np.asarray(oj.pose),
                                   atol=1e-5)
        assert np.abs(ot.iters.numpy() - np.asarray(oj.iters)).max() <= 1
        assert bool(ot.is_keyframe) == bool(oj.is_keyframe)


def test_unported_paths_raise(frames):
    """A wrong image size raises.  The paths once refused now run:
    bundle adjustment enables with an empty window (held to JAX in
    tests/test_torch_ba.py), and LM and the multi-start probe
    (coarseInitOffsetPx) follow JAX's ``VisualOdometry``: the same
    keyframes, poses at atol 5e-4."""
    cam = make_cam()
    K, b = np.asarray(cam.K()), float(cam.baseline)
    vo = VisualOdometry(K, b, (H_IMG, W_IMG), AlgorithmParameters(**KW),
                        device="cpu")
    vo.enable_bundle_adjustment()
    assert vo.refined_keyframe_poses().shape == (0, 4, 4)
    with pytest.raises(ValueError):
        vo.add_frame(np.zeros((10, 10), np.float32),
                     np.zeros((10, 10), np.float32))
    for change in ({"poseEstimator": "LevenbergMarquardt"},
                   {"coarseInitOffsetPx": 2.0}):
        jvo, tvo, results = _both(frames[:4], change, change)
        for rj, rt in results:
            assert rt.is_keyframe == rj.is_keyframe
            np.testing.assert_allclose(rt.pose, rj.pose, atol=5e-4)


def test_point_cloud_ply_round_trip(frames, tmp_path):
    cam = make_cam()
    vo = VisualOdometry(np.asarray(cam.K()), float(cam.baseline),
                        (H_IMG, W_IMG), AlgorithmParameters(**KW),
                        device="cpu")
    cloud = next(r.point_cloud for r in (vo.add_frame(I, D) for I, D in frames)
                 if r.point_cloud is not None)
    assert len(cloud) == vo.num_points_at_level(0) or len(cloud) > 100
    for binary in (True, False):
        path = str(tmp_path / f"cloud_{binary}.ply")
        write_ply(path, cloud, binary=binary)
        back = read_ply(path)
        np.testing.assert_allclose(back.points, cloud.transformed(),
                                   atol=1e-4)
        np.testing.assert_array_equal(back.colors[:, :3], cloud.colors[:, :3])
    path = str(tmp_path / "traj.txt")
    vo.trajectory.write_kitti_format(path)
    kitti = np.loadtxt(path)
    assert kitti.shape == (len(vo.trajectory), 12)
    np.testing.assert_allclose(kitti[-1].reshape(3, 4),
                               vo.trajectory.back()[:3], atol=1e-8)


def test_point_cloud_is_built_after_the_template_is_queued(frames,
                                                          monkeypatch):
    """On a keyframe ``add_frame`` reads the old keyframe's cloud, queues
    the new template's build and only then builds the cloud on the host
    (so the two overlap on a card); the cloud still holds the old
    keyframe's points, with and without a candidate."""
    cam = make_cam()
    vo = VisualOdometry(np.asarray(cam.K()), float(cam.baseline),
                        (H_IMG, W_IMG), AlgorithmParameters(**KW),
                        device="cpu")
    calls = []
    set_template, build = vo._set_template, vo._cloud_from_host
    monkeypatch.setattr(vo, "_set_template", lambda f: (
        calls.append("template"), set_template(f))[1])
    monkeypatch.setattr(vo, "_cloud_from_host", lambda *a: (
        calls.append("cloud"), build(*a))[1])
    clouds = 0
    for I, D in frames:
        old = None
        if vo._ref.has_template:
            td = vo._ref.templates[0]
            old = td.points[td.valid != 0].numpy().copy()
        calls.clear()
        r = vo.add_frame(I, D)
        if r.point_cloud is None:
            assert "cloud" not in calls
            continue
        clouds += 1
        assert calls == ["template", "cloud"]
        np.testing.assert_array_equal(r.point_cloud.points, old)
    assert clouds >= 2


def test_dense_reference():
    """The committed dense-VO reference (scripts/make_torch_port_ref.py
    dense) is sane, and the port's VisualOdometry on the CPU follows its
    first intensity steps at the cross-route tolerance chip_smoke.py
    applies on the GPU (L0 and L1 on ``gauss_newton.run``, L2 and L3 on
    ``level_gn``)."""
    ref = np.load(DENSE_NPZ)
    for name in ("intensity", "bitplanes"):
        assert ref[f"{name}_poses"].shape == (30, 4, 4)
        assert ref[f"{name}_iters"].shape == (30, 4)
        assert np.all(np.isfinite(ref[f"{name}_poses"]))
        assert ref[f"{name}_is_keyframe"].any()
        assert ref[f"{name}_gt_err"].max() < 1e-2
    n = 2
    K, b, fr = synthetic.synthesize_sequence(1 + n)
    vo = VisualOdometry(K, b, (synthetic.ROWS, synthetic.COLS),
                        AlgorithmParameters(
                            minSaliency=2.0, numPyramidLevels=4,
                            descriptor=DescriptorType.INTENSITY,
                            functionTolerance=1e-4, parameterTolerance=1e-6,
                            maxIterations=50,
                            minNumPixelsForNonMaximaSuppression=20000000,
                            pointCapacity=131072),
                        device="cpu")
    res = [vo.add_frame(I, D) for I, D in fr][1:]
    assert [vo.num_points_at_level(l) for l in range(4)] == [
        131072, 32768, 8192, 2048]
    np.testing.assert_allclose(np.stack([r.pose for r in res]),
                               ref["intensity_poses"][:n], atol=5e-4)
    np.testing.assert_array_equal([r.is_keyframe for r in res],
                                  ref["intensity_is_keyframe"][:n])
