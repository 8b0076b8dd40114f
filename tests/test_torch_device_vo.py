"""The port's slice as a whole: ``DeviceVO`` against the JAX ``DeviceVO`` on
the level-kernel route (``BPVO_LEVEL_KERNEL=force``: the production TPU route,
in interpret mode on the CPU), the synthetic sequence against bench.py's, and
the full-size reference poses that chip_smoke.py holds the GPU run to."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from bpvo_tpu import AlgorithmParameters as JParams
from bpvo_tpu.core import se3 as jse3
from bpvo_tpu.vo.device_vo import DeviceVO as JDeviceVO
from bpvo_tpu_torch import AlgorithmParameters, DescriptorType
from bpvo_tpu_torch.core import se3
from bpvo_tpu_torch.data import synthetic
from bpvo_tpu_torch.ops import level_gn as lg
from bpvo_tpu_torch.utils.convert import state_from_numpy
from bpvo_tpu_torch.vo.device_vo import DeviceVO
from test_gn import H_IMG, W_IMG, make_cam
from test_odometry import make_sequence

STEP = [0, 0, 0, 0.004, 0, 0.008]
# 0.009 m per frame against a 0.015 m threshold: every second frame is a
# keyframe, and each finds a candidate to re-estimate against
KW = dict(minSaliency=2.0, numPyramidLevels=3, functionTolerance=1e-4,
          parameterTolerance=1e-6, maxIterations=50, pointCapacity=2048,
          minTranslationMagToKeyFrame=0.015)
REF_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_port_bench_ref.npz")


@pytest.fixture(scope="module")
def frames():
    return make_sequence(STEP, 6)


def _np(a):
    return np.asarray(a)


def _jax_state_to_numpy(st):
    return {"templates": [{k: _np(v) for k, v in td._asdict().items()}
                          for td in st.templates],
            "prev_channels": [_np(c) for c in st.prev_channels],
            "prev_disparity": _np(st.prev_disparity),
            "has_prev": _np(st.has_prev), "T_kf": _np(st.T_kf),
            "pose_world": _np(st.pose_world), "T_delta": _np(st.T_delta),
            "last_weights": _np(st.last_weights)}


def test_device_vo_matches_jax_level_kernel_route(monkeypatch, frames):
    monkeypatch.setenv("BPVO_LEVEL_KERNEL", "force")
    cam = make_cam()
    K, b = np.asarray(cam.K()), float(cam.baseline)
    jvo = JDeviceVO(K, b, (H_IMG, W_IMG), JParams(**KW))
    tvo = DeviceVO(K, b, (H_IMG, W_IMG), AlgorithmParameters(**KW),
                   device="cpu")
    n_kf_with_candidate = 0
    launches_before = lg.launch_count
    for I, D in frames:
        has_prev = tvo.state is not None and tvo.state.has_prev
        oj, ot = jvo.add_frame(I, D), tvo.add_frame(I, D)
        if oj is None:
            assert ot is None
            continue
        assert bool(ot.is_keyframe) == bool(oj.is_keyframe)
        assert int(ot.reason) == int(oj.reason)
        n_kf_with_candidate += int(bool(ot.is_keyframe) and has_prev)
        np.testing.assert_allclose(ot.pose.numpy(), _np(oj.pose), atol=1e-4)
        np.testing.assert_allclose(ot.pose_world.numpy(), _np(oj.pose_world),
                                   atol=1e-4)
        assert np.abs(ot.iters.numpy() - _np(oj.iters)).max() <= 1, (
            ot.iters, oj.iters)
        assert int(ot.band_overflow) == 0
    assert n_kf_with_candidate >= 1
    assert lg.launch_count == launches_before    # CPU: the plain version ran


def test_state_carried_from_jax(frames):
    """A JAX VOState carried across with state_from_numpy steps to the same
    pose in the port."""
    cam = make_cam()
    K, b = np.asarray(cam.K()), float(cam.baseline)
    jvo = JDeviceVO(K, b, (H_IMG, W_IMG), JParams(**KW))
    for I, D in frames[:3]:
        jvo.add_frame(I, D)
    tvo = DeviceVO(K, b, (H_IMG, W_IMG), AlgorithmParameters(**KW),
                   device="cpu")
    tvo.state = state_from_numpy(_jax_state_to_numpy(jvo.state), "cpu")
    assert tvo.state.has_prev == bool(jvo.state.has_prev)
    oj, ot = jvo.add_frame(*frames[3]), tvo.add_frame(*frames[3])
    np.testing.assert_allclose(ot.pose.numpy(), _np(oj.pose), atol=1e-4)
    assert bool(ot.is_keyframe) == bool(oj.is_keyframe)


def test_add_frames_recovers_motion(frames):
    cam = make_cam()
    vo = DeviceVO(np.asarray(cam.K()), float(cam.baseline), (H_IMG, W_IMG),
                  AlgorithmParameters(**KW), device="cpu")
    outs = vo.add_frames(np.stack([f[0] for f in frames]),
                         np.stack([f[1] for f in frames]))
    assert outs.pose.shape == (5, 4, 4) and outs.iters.shape == (5, 3)
    step_inv = se3.inverse(se3.exp(torch.tensor(STEP, dtype=torch.float32)))
    err = se3.log(outs.pose @ step_inv).abs().max()
    assert float(err) < 2e-3, err


def test_unported_solver_raises(frames):
    """Levenberg-Marquardt, once refused, runs the eager step (no CUDA
    graphs, no level kernel) and follows JAX's ``DeviceVO`` with LM: the
    same keyframes, poses at atol 5e-4."""
    cam = make_cam()
    kw = dict(KW, poseEstimator="LevenbergMarquardt")
    K, b = np.asarray(cam.K()), float(cam.baseline)
    jvo = JDeviceVO(K, b, (H_IMG, W_IMG), JParams(**kw))
    tvo = DeviceVO(K, b, (H_IMG, W_IMG), AlgorithmParameters(**kw),
                   device="cpu")
    assert tvo._graphs is None and tvo._run_graphs is None
    for I, D in frames:
        oj, ot = jvo.add_frame(I, D), tvo.add_frame(I, D)
        if oj is None:
            assert ot is None
            continue
        assert bool(ot.is_keyframe) == bool(oj.is_keyframe)
        np.testing.assert_allclose(ot.pose.numpy(), np.asarray(oj.pose),
                                   atol=5e-4)


def test_synthetic_sequence_matches_bench():
    K_t, b_t, f_t = synthetic.synthesize_sequence(3, rows=64, cols=96)
    K_j, b_j, f_j = bench.synthesize_sequence(3, rows=64, cols=96)
    np.testing.assert_allclose(K_t, K_j)
    assert b_t == b_j
    for (It, Dt), (Ij, Dj) in zip(f_t, f_j):
        np.testing.assert_allclose(It, Ij, atol=1e-3)
        np.testing.assert_allclose(Dt, Dj, atol=1e-3)
    np.testing.assert_allclose(
        synthetic.step_pose(),
        np.asarray(jse3.exp(jnp.asarray(synthetic.STEP_TWIST, jnp.float32))),
        atol=1e-7)


def test_bench_reference_poses():
    """The committed JAX reference (scripts/make_torch_port_ref.py) is
    sane, and the port on the CPU follows it over the first frames at the
    cross-route tolerance chip_smoke.py applies on the GPU."""
    ref = np.load(REF_NPZ)
    assert ref["poses"].shape == (30, 4, 4) and ref["gt_err"].shape == (30,)
    assert np.all(np.isfinite(ref["poses"])) and ref["gt_err"].max() < 1e-3
    assert ref["is_keyframe"].any()
    n = 3
    K, b, fr = synthetic.synthesize_sequence(1 + n)
    vo = DeviceVO(K, b, (synthetic.ROWS, synthetic.COLS), AlgorithmParameters(
        minSaliency=2.0, numPyramidLevels=4,
        descriptor=DescriptorType.INTENSITY, functionTolerance=1e-4,
        parameterTolerance=1e-6, maxIterations=50), device="cpu")
    outs = vo.add_frames(np.stack([f[0] for f in fr]),
                         np.stack([f[1] for f in fr]))
    np.testing.assert_allclose(outs.pose.numpy(), ref["poses"][:n], atol=5e-4)
    np.testing.assert_array_equal(outs.is_keyframe.numpy(),
                                  ref["is_keyframe"][:n])
